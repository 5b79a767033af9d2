"""Policies = scorer . sampler (the online DQN slice's part of them)."""

from reagent_tpu_torch.gym.policies.samplers import (
    GreedyActionSampler,
    SoftmaxActionSampler,
)
from reagent_tpu_torch.gym.policies.scorers import (
    apply_possible_actions_mask,
    discrete_dqn_scorer,
)

__all__ = [
    "GreedyActionSampler",
    "SoftmaxActionSampler",
    "apply_possible_actions_mask",
    "discrete_dqn_scorer",
]
