"""Single-step DM / IPS / DR estimators.

Reference: reagent/evaluation/doubly_robust_estimator.py:101-340 (the standard
DoublyRobustEstimator path; arXiv:1612.01205).

The port's own copy of ``reagent_tpu/evaluation/doubly_robust_estimator.py``,
line for line (numpy on the host), so that the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import logging
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from reagent_tpu_torch.evaluation.cpe import CpeEstimate, bootstrapped_std_error_of_mean
from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage

logger = logging.getLogger(__name__)

DEFAULT_FRAC_TRAIN = 0.4
DEFAULT_FRAC_VALID = 0.1
DEFAULT_BOOTSTRAP_SAMPLE_PERCENT = 0.25
DEFAULT_BOOTSTRAP_NUM_SAMPLES = 1000


class DoublyRobustHP(NamedTuple):
    """Estimator hyper-parameters (reference doubly_robust_estimator.py:24-31)."""

    frac_train: float = DEFAULT_FRAC_TRAIN
    frac_valid: float = DEFAULT_FRAC_VALID
    bootstrap_num_samples: int = DEFAULT_BOOTSTRAP_NUM_SAMPLES
    bootstrap_sample_percent: float = DEFAULT_BOOTSTRAP_SAMPLE_PERCENT


class TrainValidEvalData(NamedTuple):
    """Per-split views of an EDP (reference :34-44). Used by estimators that
    fit an auxiliary model (e.g. estimated propensities) on held-out data."""

    contexts_dict: Dict[str, Optional[np.ndarray]]
    model_propensities_dict: Dict[str, np.ndarray]
    actions_logged_dict: Dict[str, np.ndarray]
    action_mask_dict: Dict[str, np.ndarray]
    logged_rewards_dict: Dict[str, np.ndarray]
    model_rewards_dict: Dict[str, np.ndarray]
    model_rewards_for_logged_action_dict: Dict[str, np.ndarray]
    logged_propensities_dict: Dict[str, np.ndarray]
    num_examples_dict: Dict[str, int]


class ImportanceSamplingData(NamedTuple):
    """Eval-split arrays the three estimates are computed from (reference :93-98)."""

    importance_weight: np.ndarray
    logged_rewards: np.ndarray
    model_rewards: Optional[np.ndarray]
    model_rewards_for_logged_action: np.ndarray
    model_propensities: np.ndarray


def split_data(
    edp: EvaluationDataPage,
    frac_train: float = DEFAULT_FRAC_TRAIN,
    frac_valid: float = DEFAULT_FRAC_VALID,
    seed: Optional[int] = None,
) -> TrainValidEvalData:
    """Random train/valid/eval split of an EDP (reference _split_data :106-193).

    Training and validation splits are for fitting auxiliary models (e.g. an
    estimated behavior-propensity model); only the eval split feeds the policy
    estimate itself.
    """
    n = edp.model_propensities.shape[0]
    idx = np.random.default_rng(seed).permutation(n)
    k_tr, k_va = int(frac_train * n), int((frac_train + frac_valid) * n)
    parts = {"train": idx[:k_tr], "valid": idx[k_tr:k_va], "eval": idx[k_va:]}

    def by_split(arr):
        return {k: (None if arr is None else np.asarray(arr)[v]) for k, v in parts.items()}

    actions_logged = np.argmax(edp.action_mask, axis=1, keepdims=True).astype(np.float32)
    return TrainValidEvalData(
        contexts_dict=by_split(edp.contexts),
        model_propensities_dict=by_split(edp.model_propensities),
        actions_logged_dict=by_split(actions_logged),
        action_mask_dict=by_split(edp.action_mask),
        logged_rewards_dict=by_split(edp.logged_rewards),
        model_rewards_dict=by_split(edp.model_rewards),
        model_rewards_for_logged_action_dict=by_split(edp.model_rewards_for_logged_action),
        logged_propensities_dict=by_split(edp.logged_propensities),
        num_examples_dict={k: len(v) for k, v in parts.items()},
    )


class DoublyRobustEstimator:
    def __init__(
        self,
        bootstrap_sample_percent: float = DEFAULT_BOOTSTRAP_SAMPLE_PERCENT,
        bootstrap_num_samples: int = DEFAULT_BOOTSTRAP_NUM_SAMPLES,
    ):
        self.bootstrap_sample_percent = bootstrap_sample_percent
        self.bootstrap_num_samples = bootstrap_num_samples

    def _get_importance_sampling_inputs(
        self, edp: EvaluationDataPage
    ) -> ImportanceSamplingData:
        """Reference _get_importance_sampling_inputs :219-239."""
        target_prop = np.sum(
            edp.model_propensities * edp.action_mask, axis=1, keepdims=True
        )
        importance_weights = target_prop / edp.logged_propensities
        logger.info(f"Mean IPS weight on the eval dataset: {importance_weights.mean()}")
        return ImportanceSamplingData(
            importance_weight=importance_weights,
            logged_rewards=edp.logged_rewards,
            model_rewards=edp.model_rewards,
            model_rewards_for_logged_action=edp.model_rewards_for_logged_action,
            model_propensities=edp.model_propensities,
        )

    def estimate(
        self, edp: EvaluationDataPage, hp: Optional[DoublyRobustHP] = None
    ) -> Tuple[CpeEstimate, CpeEstimate, CpeEstimate]:
        """Returns (direct_method, inverse_propensity, doubly_robust)."""
        # Effective bootstrap settings are per-call: an hp override must not
        # leak into later hp-less calls on the same estimator instance.
        sample_percent = (
            hp.bootstrap_sample_percent if hp is not None
            else self.bootstrap_sample_percent
        )
        num_samples = (
            hp.bootstrap_num_samples if hp is not None
            else self.bootstrap_num_samples
        )
        isd = self._get_importance_sampling_inputs(edp)
        importance_weights = isd.importance_weight

        logged_policy_score = float(np.mean(edp.logged_rewards))
        if logged_policy_score < 1e-6:
            logger.warning(
                "Can't normalize DR-CPE because of small or negative logged_policy_score"
            )
            normalizer = 0.0
        else:
            normalizer = 1.0 / logged_policy_score

        if edp.model_rewards is None:
            direct_method_values = np.zeros(
                (edp.model_propensities.shape[0], 1), dtype=np.float32
            )
        else:
            direct_method_values = np.sum(
                edp.model_propensities * edp.model_rewards, axis=1, keepdims=True
            )

        direct_method_score = float(np.mean(direct_method_values))
        dm_std = bootstrapped_std_error_of_mean(
            direct_method_values.reshape(-1),
            sample_percent=sample_percent,
            num_samples=num_samples,
        )
        direct_method = CpeEstimate(
            raw=direct_method_score,
            normalized=direct_method_score * normalizer,
            raw_std_error=dm_std,
            normalized_std_error=dm_std * normalizer,
        )

        ips = importance_weights * edp.logged_rewards
        dr = (
            importance_weights
            * (edp.logged_rewards - edp.model_rewards_for_logged_action)
        ) + direct_method_values

        ips_score = float(np.mean(ips))
        ips_std = bootstrapped_std_error_of_mean(
            ips.reshape(-1),
            sample_percent=sample_percent,
            num_samples=num_samples,
        )
        inverse_propensity = CpeEstimate(
            raw=ips_score,
            normalized=ips_score * normalizer,
            raw_std_error=ips_std,
            normalized_std_error=ips_std * normalizer,
        )

        dr_score = float(np.mean(dr))
        dr_std = bootstrapped_std_error_of_mean(
            dr.reshape(-1),
            sample_percent=sample_percent,
            num_samples=num_samples,
        )
        doubly_robust = CpeEstimate(
            raw=dr_score,
            normalized=dr_score * normalizer,
            raw_std_error=dr_std,
            normalized_std_error=dr_std * normalizer,
        )
        return direct_method, inverse_propensity, doubly_robust
