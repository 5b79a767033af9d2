"""Random policies for collecting data.

Port of ``reagent_tpu/gym/policies/random_policies.py`` (reference:
reagent/gym/policies/random_policies.py:18-170): discrete, continuous
(uniform in the training action range) and multi-discrete random actors,
and ``make_random_policy_for_env``.  ``act`` draws from a
``torch.Generator`` on the observation's device, or takes its draws
(``noise``: uniforms in [0, 1) of the action's shape; gumbel draws for the
discrete policy's ``[B, A]`` categorical, which samples as
``jax.random.categorical`` does, by gumbel-max).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import CONTINUOUS_TRAINING_ACTION_RANGE
from reagent_tpu_torch.gym.policies.samplers import gumbel
from reagent_tpu_torch.gym.policies.scorers import apply_possible_actions_mask

Tensor = torch.Tensor


def make_random_policy_for_env(env):
    """Dispatch on the (functional or gymnasium) env's action space (ref
    :18-28)."""
    if getattr(env, "discrete", None) is not None:
        if env.discrete:
            return DiscreteRandomPolicy(num_actions=env.action_dim)
        return ContinuousRandomPolicy(action_dim=env.action_dim)
    import gymnasium

    space = env.action_space
    if isinstance(space, gymnasium.spaces.Discrete):
        return DiscreteRandomPolicy(num_actions=int(space.n))
    if isinstance(space, gymnasium.spaces.Box):
        return ContinuousRandomPolicy(action_dim=int(space.shape[0]),
                                      low=float(space.low.min()), high=float(space.high.max()))
    if isinstance(space, gymnasium.spaces.MultiDiscrete):
        return MultiDiscreteRandomPolicy(nvec=[int(n) for n in space.nvec])
    raise NotImplementedError(f"{space} not supported")


def _rows(obs: Tensor) -> int:
    return obs.shape[0] if obs.ndim >= 2 else 1


class DiscreteRandomPolicy:
    def __init__(self, num_actions: int) -> None:
        self.num_actions = num_actions

    def act(self, obs: Tensor, generator: Optional[torch.Generator] = None,
            possible_actions_mask: Optional[Tensor] = None,
            noise: Optional[Tensor] = None) -> rlt.ActorOutput:
        """Uniform over the possible actions (all where none is given; an
        all-masked row falls back to uniform)."""
        B = _rows(obs)
        scores = torch.ones((B, self.num_actions), dtype=torch.float32, device=obs.device)
        scores = apply_possible_actions_mask(scores, possible_actions_mask, invalid_score=0.0)
        total = torch.sum(scores, dim=1, keepdim=True)
        probs = torch.where(total > 0, scores / torch.clamp(total, min=1.0),
                            1.0 / self.num_actions)
        if noise is None:
            noise = gumbel(probs.shape, generator, obs.device)
        idx = torch.argmax(torch.log(torch.clamp(probs, min=1e-20)) + noise, dim=1)
        action = F.one_hot(idx, self.num_actions).to(torch.float32)
        log_prob = torch.log(torch.gather(probs, 1, idx[:, None]))
        return rlt.ActorOutput(action=action, log_prob=log_prob)


class ContinuousRandomPolicy:
    def __init__(
        self,
        action_dim: int,
        low: float = CONTINUOUS_TRAINING_ACTION_RANGE[0],
        high: float = CONTINUOUS_TRAINING_ACTION_RANGE[1],
    ) -> None:
        self.action_dim = action_dim
        self.low = low
        self.high = high

    def act(self, obs: Tensor, generator: Optional[torch.Generator] = None,
            noise: Optional[Tensor] = None) -> rlt.ActorOutput:
        """``noise``: ``[B, action_dim]`` uniforms in [0, 1), mapped onto
        [low, high) as ``jax.random.uniform(minval, maxval)`` maps its own."""
        B = _rows(obs)
        if noise is None:
            noise = torch.rand((B, self.action_dim), generator=generator, device=obs.device)
        action = noise * (self.high - self.low) + self.low
        log_prob = torch.full((B, 1), -self.action_dim * math.log(self.high - self.low),
                              dtype=torch.float32, device=obs.device)
        return rlt.ActorOutput(action=action, log_prob=log_prob)


class MultiDiscreteRandomPolicy:
    def __init__(self, nvec: List[int]) -> None:
        self.nvec = nvec

    def act(self, obs: Tensor, generator: Optional[torch.Generator] = None,
            noise: Optional[Tensor] = None) -> rlt.ActorOutput:
        """``noise``: ``[B, len(nvec)]`` uniforms in [0, 1); component i is
        ``floor(u * n_i)``."""
        B = _rows(obs)
        if noise is None:
            noise = torch.rand((B, len(self.nvec)), generator=generator, device=obs.device)
        n = torch.tensor(self.nvec, dtype=torch.float32, device=obs.device)
        action = torch.clamp(torch.floor(noise * n), max=n - 1).to(torch.int32)
        log_prob = torch.full((B, 1), -sum(math.log(float(k)) for k in self.nvec),
                              dtype=torch.float32, device=obs.device)
        return rlt.ActorOutput(action=action, log_prob=log_prob)
