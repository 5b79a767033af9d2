"""Action samplers: scores -> sampled action + log-prob.

Port of ``reagent_tpu/gym/policies/samplers.py``: ``SoftmaxActionSampler``
and ``GreedyActionSampler`` (:23-60), ``EpsilonGreedyActionSampler``,
``GaussianSampler`` and ``TopKSampler`` (:63-120).  Randomness comes from an
explicit ``torch.Generator`` on the scores' device, or from the draws
themselves (``noise``); the softmax draw is a gumbel-max (``argmax(logits +
gumbel)``), which is how ``jax.random.categorical`` samples, so JAX's gumbel
draws give JAX's actions, and it needs no host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core import types as rlt

Tensor = torch.Tensor


def gumbel(shape, generator: torch.Generator, device) -> Tensor:
    """Standard gumbel noise, ``-log(-log(u))`` with ``u`` in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


class SoftmaxActionSampler:
    """Boltzmann exploration over logits (ref discrete_sampler.py:14-70)."""

    def __init__(self, temperature: float = 1.0):
        if temperature <= 0:
            raise ValueError(f"Invalid non-positive temperature {temperature}.")
        self.temperature = temperature

    def sample_action(
        self, scores: Tensor, generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
    ) -> rlt.ActorOutput:
        """``noise``: standard gumbel draws shaped like ``scores``; drawn
        from ``generator`` when not given."""
        logits = scores / self.temperature
        if noise is None:
            noise = gumbel(logits.shape, generator, logits.device)
        raw_action = torch.argmax(logits + noise, dim=-1)
        log_prob = torch.gather(F.log_softmax(logits, dim=-1), 1, raw_action[:, None])[:, 0]
        action = F.one_hot(raw_action, scores.shape[-1]).to(torch.float32)
        return rlt.ActorOutput(action=action, log_prob=log_prob)

    def log_prob(self, scores: Tensor, action: Tensor) -> Tensor:
        """Log-prob of a one-hot action under the softmax policy."""
        return torch.sum(F.log_softmax(scores / self.temperature, dim=-1) * action, dim=-1)

    def entropy(self, scores: Tensor) -> Tensor:
        log_probs = F.log_softmax(scores / self.temperature, dim=-1)
        return -torch.sum(torch.exp(log_probs) * log_probs, dim=-1)


class GreedyActionSampler:
    """Deterministic argmax, first index on ties (ref discrete_sampler.py:75)."""

    def sample_action(
        self, scores: Tensor, generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
    ) -> rlt.ActorOutput:
        """Draws nothing: ``generator`` and ``noise`` are ignored."""
        raw_action = torch.argmax(scores, dim=-1)
        action = F.one_hot(raw_action, scores.shape[-1]).to(torch.float32)
        return rlt.ActorOutput(
            action=action, log_prob=torch.zeros(scores.shape[0], device=scores.device))

    def log_prob(self, scores: Tensor, action: Tensor) -> Tensor:
        match = torch.argmax(action, dim=-1) == torch.argmax(scores, dim=-1)
        return torch.where(match, 0.0, -torch.inf)


class EpsilonGreedyActionSampler:
    """eps-uniform mixture with greedy (ref discrete_sampler.py:108)."""

    def __init__(self, epsilon: float, epsilon_decay: float = 1.0, minimum_epsilon: float = 0.0):
        self.epsilon = float(epsilon)
        self.epsilon_decay = epsilon_decay
        self.minimum_epsilon = minimum_epsilon

    def sample_action(
        self, scores: Tensor, generator: Optional[torch.Generator] = None,
        epsilon: Optional[Tensor] = None, noise: Optional[Tuple[Tensor, Tensor]] = None,
    ) -> rlt.ActorOutput:
        """``noise``: (uniforms [B] in [0, 1), random actions [B]), the
        explore draw and the uniform action (JAX's ``uniform`` and
        ``randint``); drawn from ``generator`` where not given."""
        eps = self.epsilon if epsilon is None else epsilon
        B, num_actions = scores.shape
        if noise is None:
            u = torch.rand((B,), generator=generator, device=scores.device)
            random_action = torch.randint(0, num_actions, (B,), generator=generator,
                                          device=scores.device)
        else:
            u, random_action = noise
        greedy = torch.argmax(scores, dim=-1)
        raw_action = torch.where(u < eps, random_action.to(greedy.dtype), greedy)
        action = F.one_hot(raw_action, num_actions).to(torch.float32)
        p = eps / num_actions + (1.0 - eps) * (raw_action == greedy).to(torch.float32)
        return rlt.ActorOutput(action=action, log_prob=torch.log(torch.as_tensor(p)))

    def log_prob(self, scores: Tensor, action: Tensor) -> Tensor:
        num_actions = scores.shape[-1]
        greedy = F.one_hot(torch.argmax(scores, dim=-1), num_actions).to(torch.float32)
        p = self.epsilon / num_actions + (1.0 - self.epsilon) * torch.sum(greedy * action, dim=-1)
        return torch.log(p)


class GaussianSampler:
    """For continuous actors that emit sampled actions already: a
    pass-through that keeps the policy API (reference
    gym/policies/samplers/continuous_sampler.py; the actors here take their
    standard-normal draw themselves)."""

    def sample_action(self, actor_output: rlt.ActorOutput,
                      generator: Optional[torch.Generator] = None) -> rlt.ActorOutput:
        return actor_output

    def log_prob(self, actor_output: rlt.ActorOutput, action: Tensor) -> Tensor:
        return actor_output.log_prob


class TopKSampler:
    """The k highest-scoring items (reference top_k_sampler.py:12-23), the
    lower index first on ties, as ``jax.lax.top_k`` (a stable descending
    sort: ``torch.topk`` on the card does not promise the order)."""

    def __init__(self, k: int) -> None:
        self.k = k

    def sample_action(self, scores: Tensor,
                      generator: Optional[torch.Generator] = None) -> rlt.ActorOutput:
        item_idxs = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :self.k]
        return rlt.ActorOutput(action=item_idxs, log_prob=torch.zeros(
            (item_idxs.shape[0], 1), dtype=torch.float32, device=scores.device))
