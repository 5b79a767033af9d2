"""Counterfactual policy evaluation (CPE).

Port of ``reagent_tpu/evaluation/__init__.py`` (reference: reagent/evaluation/
— EvaluationDataPage, DM/IPS/DR, sequential DR, MAGIC, Evaluator), with the
padded sequential estimators of ``torch_sequential_estimators``.
"""

from reagent_tpu_torch.evaluation.cpe import (
    CpeDetails,
    CpeEstimate,
    CpeEstimateSet,
    bootstrapped_std_error_of_mean,
)
from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage
from reagent_tpu_torch.evaluation.doubly_robust_estimator import DoublyRobustEstimator
from reagent_tpu_torch.evaluation.sequential_doubly_robust_estimator import (
    SequentialDoublyRobustEstimator,
)
from reagent_tpu_torch.evaluation.weighted_sequential_doubly_robust_estimator import (
    WeightedSequentialDoublyRobustEstimator,
)
from reagent_tpu_torch.evaluation.evaluator import Evaluator

__all__ = [
    "CpeDetails",
    "CpeEstimate",
    "CpeEstimateSet",
    "bootstrapped_std_error_of_mean",
    "EvaluationDataPage",
    "DoublyRobustEstimator",
    "SequentialDoublyRobustEstimator",
    "WeightedSequentialDoublyRobustEstimator",
    "Evaluator",
]
