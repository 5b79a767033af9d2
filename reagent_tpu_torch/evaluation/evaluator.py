"""Evaluator: run the full CPE suite over an EvaluationDataPage.

Port of ``reagent_tpu/evaluation/evaluator.py`` (reference:
reagent/evaluation/evaluator.py:57-143).  The JAX package's switch
``use_jax_sequential_estimators`` is ``use_padded_sequential_estimators``
here, ``device`` places the padded estimators' arrays, and it takes no
``trainer`` (the JAX package's ``Evaluator`` does not use its own).
"""

from __future__ import annotations

import logging

from reagent_tpu_torch.core.tracker import ObservableMixin
from reagent_tpu_torch.evaluation.cpe import CpeDetails, CpeEstimateSet
from reagent_tpu_torch.evaluation.doubly_robust_estimator import DoublyRobustEstimator
from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage
from reagent_tpu_torch.evaluation.sequential_doubly_robust_estimator import (
    SequentialDoublyRobustEstimator,
)
from reagent_tpu_torch.evaluation.torch_sequential_estimators import (
    TorchSequentialDoublyRobustEstimator,
    TorchWeightedSequentialDoublyRobustEstimator,
    pad_edp_trajectories,
)
from reagent_tpu_torch.evaluation.weighted_sequential_doubly_robust_estimator import (
    WeightedSequentialDoublyRobustEstimator,
)
from reagent_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class Evaluator(ObservableMixin):
    """``device`` defaults to ``"cuda"`` and raises if no card is present;
    the numpy oracles (``use_padded_sequential_estimators=False``) run on
    the host whatever it says."""

    NUM_J_STEPS_FOR_MAGIC_ESTIMATOR = 25

    def __init__(
        self, action_names, gamma, metrics_to_score=None,
        use_padded_sequential_estimators: bool = True, device="cuda",
    ) -> None:
        super().__init__()
        self.action_names = action_names
        self.metrics_to_score = metrics_to_score or []
        self.device = resolve_device(device)
        self.doubly_robust_estimator = DoublyRobustEstimator()
        self.padded = use_padded_sequential_estimators
        if use_padded_sequential_estimators:
            self.sequential_doubly_robust_estimator = TorchSequentialDoublyRobustEstimator(
                gamma, self.device)
            self.weighted_sequential_doubly_robust_estimator = (
                TorchWeightedSequentialDoublyRobustEstimator(gamma, self.device))
        else:
            self.sequential_doubly_robust_estimator = SequentialDoublyRobustEstimator(gamma)
            self.weighted_sequential_doubly_robust_estimator = (
                WeightedSequentialDoublyRobustEstimator(gamma)
            )

    def evaluate_post_training(self, edp: EvaluationDataPage) -> CpeDetails:
        cpe_details = CpeDetails()
        cpe_details.reward_estimates = self.score_cpe("Reward", edp)

        if (
            self.metrics_to_score is not None
            and edp.logged_metrics is not None
            and self.action_names is not None
        ):
            for i, metric in enumerate(self.metrics_to_score):
                logger.info("Scoring metric: %s", metric)
                metric_reward_edp = edp.set_metric_as_reward(i, len(self.action_names))
                cpe_details.metric_estimates[metric] = self.score_cpe(
                    metric, metric_reward_edp
                )

        if self.action_names is not None:
            if edp.optimal_q_values is not None:
                value_means = edp.optimal_q_values.mean(axis=0)
                cpe_details.q_value_means = {
                    action: float(value_means[i])
                    for i, action in enumerate(self.action_names)
                }
                value_stds = edp.optimal_q_values.std(axis=0, ddof=1)
                cpe_details.q_value_stds = {
                    action: float(value_stds[i])
                    for i, action in enumerate(self.action_names)
                }
            if edp.eval_action_idxs is not None:
                cpe_details.action_distribution = {
                    action: float((edp.eval_action_idxs == i).sum())
                    / edp.eval_action_idxs.shape[0]
                    for i, action in enumerate(self.action_names)
                }
        self.notify_observers(cpe_details=cpe_details)
        return cpe_details

    def score_cpe(self, metric_name: str, edp: EvaluationDataPage) -> CpeEstimateSet:
        direct_method, inverse_propensity, doubly_robust = (
            self.doubly_robust_estimator.estimate(edp)
        )
        wdr_estimator = self.weighted_sequential_doubly_robust_estimator
        if self.padded:
            # pad once and share it across the three sequential estimates
            padded = pad_edp_trajectories(edp, self.device)
            sequential_doubly_robust = (
                self.sequential_doubly_robust_estimator.estimate_padded(padded))
            estimate, data = wdr_estimator.estimate_padded, padded
        else:
            sequential_doubly_robust = self.sequential_doubly_robust_estimator.estimate(edp)
            estimate, data = wdr_estimator.estimate, edp
        weighted_doubly_robust = estimate(
            data, num_j_steps=1, whether_self_normalize_importance_weights=True)
        magic = estimate(
            data, num_j_steps=Evaluator.NUM_J_STEPS_FOR_MAGIC_ESTIMATOR,
            whether_self_normalize_importance_weights=True)
        return CpeEstimateSet(
            direct_method=direct_method,
            inverse_propensity=inverse_propensity,
            doubly_robust=doubly_robust,
            sequential_doubly_robust=sequential_doubly_robust,
            weighted_doubly_robust=weighted_doubly_robust,
            magic=magic,
        )
