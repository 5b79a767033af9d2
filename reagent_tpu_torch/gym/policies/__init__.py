"""Policies = scorer . sampler (the online DQN and policy-gradient slices'
part of them), and the policy over an exported artifact."""

from reagent_tpu_torch.gym.policies.policy import Policy, actor_scorer, discrete_q_scorer
from reagent_tpu_torch.gym.policies.predictor_policies import (
    DiscreteDqnPredictorPolicy,
    create_predictor_policy_from_model,
)
from reagent_tpu_torch.gym.policies.samplers import (
    GreedyActionSampler,
    SoftmaxActionSampler,
)
from reagent_tpu_torch.gym.policies.scorers import (
    apply_possible_actions_mask,
    discrete_dqn_scorer,
    parametric_dqn_scorer,
)

__all__ = [
    "Policy",
    "actor_scorer",
    "discrete_q_scorer",
    "DiscreteDqnPredictorPolicy",
    "create_predictor_policy_from_model",
    "GreedyActionSampler",
    "SoftmaxActionSampler",
    "apply_possible_actions_mask",
    "discrete_dqn_scorer",
    "parametric_dqn_scorer",
]
