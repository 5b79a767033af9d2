"""Policies = scorer . sampler, the random policies, and the policy over an
exported artifact."""

from reagent_tpu_torch.gym.policies.policy import Policy, actor_scorer, discrete_q_scorer
from reagent_tpu_torch.gym.policies.predictor_policies import (
    DiscreteDqnPredictorPolicy,
    create_predictor_policy_from_model,
)
from reagent_tpu_torch.gym.policies.random_policies import (
    ContinuousRandomPolicy,
    DiscreteRandomPolicy,
    MultiDiscreteRandomPolicy,
    make_random_policy_for_env,
)
from reagent_tpu_torch.gym.policies.samplers import (
    EpsilonGreedyActionSampler,
    GaussianSampler,
    GreedyActionSampler,
    SoftmaxActionSampler,
    TopKSampler,
)
from reagent_tpu_torch.gym.policies.scorers import (
    apply_possible_actions_mask,
    discrete_dqn_scorer,
    parametric_dqn_scorer,
    sac_scorer,
    slate_q_scorer,
)

__all__ = [
    "Policy",
    "actor_scorer",
    "discrete_q_scorer",
    "DiscreteDqnPredictorPolicy",
    "create_predictor_policy_from_model",
    "ContinuousRandomPolicy",
    "DiscreteRandomPolicy",
    "EpsilonGreedyActionSampler",
    "GaussianSampler",
    "GreedyActionSampler",
    "MultiDiscreteRandomPolicy",
    "SoftmaxActionSampler",
    "TopKSampler",
    "apply_possible_actions_mask",
    "discrete_dqn_scorer",
    "make_random_policy_for_env",
    "parametric_dqn_scorer",
    "sac_scorer",
    "slate_q_scorer",
]
