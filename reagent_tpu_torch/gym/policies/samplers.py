"""Action samplers: scores -> sampled action + log-prob.

Port of ``SoftmaxActionSampler`` and ``GreedyActionSampler`` from
``reagent_tpu/gym/policies/samplers.py`` (:23-60).  Randomness comes from an
explicit ``torch.Generator`` on the scores' device, or from the draws
themselves (``noise``); the softmax draw is a gumbel-max (``argmax(logits +
gumbel)``), which is how ``jax.random.categorical`` samples, so JAX's gumbel
draws give JAX's actions, and it needs no host sync.
"""

from __future__ import annotations

from typing import Optional

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
