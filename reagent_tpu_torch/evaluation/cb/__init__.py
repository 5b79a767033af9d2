"""Contextual-bandit offline evaluation (port of
``reagent_tpu/evaluation/cb/__init__.py``)."""

from reagent_tpu_torch.evaluation.cb.base_evaluator import BaseOfflineEval, OfflineEvalState
from reagent_tpu_torch.evaluation.cb.policy_evaluator import PolicyEvaluator
from reagent_tpu_torch.evaluation.cb.synthetic_contextual_bandit_data import (
    DynamicBanditAgent,
    DynamicBanditEnv,
)
from reagent_tpu_torch.evaluation.cb.utils import add_importance_weights

__all__ = [
    "BaseOfflineEval",
    "OfflineEvalState",
    "PolicyEvaluator",
    "add_importance_weights",
    "DynamicBanditAgent",
    "DynamicBanditEnv",
]
