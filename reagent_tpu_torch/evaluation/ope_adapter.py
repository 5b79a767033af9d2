"""Adapters bridging EvaluationDataPage to the standalone OPE estimators.

Port of ``reagent_tpu/evaluation/ope_adapter.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/evaluation/ope_adapter.py:50 (OPEstimatorAdapter — EDP to
bandit log), :131 (SequentialOPEstimatorAdapter — EDP to RLEstimatorInput).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from reagent_tpu_torch.evaluation.cpe import CpeEstimate
from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage
from reagent_tpu_torch.ope.estimators.contextual_bandits_estimators import (
    BanditsEstimatorInput,
)
from reagent_tpu_torch.ope.estimators.estimator import Estimator
from reagent_tpu_torch.ope.estimators.sequential_estimators import RLEstimatorInput


class OPEstimatorAdapter:
    """Run a bandit OPE estimator on an EDP (reference ope_adapter.py:50-128)."""

    def __init__(self, ope_estimator: Estimator):
        self._estimator = ope_estimator

    @staticmethod
    def edp_to_contextual_bandit_log(edp: EvaluationDataPage) -> BanditsEstimatorInput:
        """An all-zero action_mask row means the logged action is outside the
        evaluated policy's support (the seq2slate greedy case, reference
        ope_adapter.py:62-68): encode it as log_action=-1 with zero logged
        propensity so IPS terms vanish but the sample still counts."""
        action_mask = np.asarray(edp.action_mask)
        n, a = action_mask.shape
        taken = np.argmax(action_mask, axis=1)
        has_match = action_mask[np.arange(n), taken] > 0
        probs = np.zeros((n, a))
        probs[np.arange(n), taken] = np.where(
            has_match, edp.logged_propensities.reshape(-1), 0.0
        )
        return BanditsEstimatorInput(
            log_action=np.where(has_match, taken, -1),
            log_reward=edp.logged_rewards.reshape(-1),
            log_propensities=probs,
            tgt_propensities=np.asarray(edp.model_propensities),
            dm_rewards=np.asarray(edp.model_rewards),
            dm_rewards_for_logged_action=(
                None
                if edp.model_rewards_for_logged_action is None
                else np.asarray(edp.model_rewards_for_logged_action).reshape(-1)
            ),
        )

    def estimate(self, edp: EvaluationDataPage, **kwargs) -> CpeEstimate:
        result = self._estimator.evaluate(
            self.edp_to_contextual_bandit_log(edp), **kwargs
        )
        logged = max(float(np.mean(edp.logged_rewards)), 1e-6)
        normalized = result.estimated_reward_normalized
        if normalized is None:
            normalized = result.estimated_reward / logged
        normalized_std_error = result.estimated_reward_normalized_std_error
        if normalized_std_error is None:
            normalized_std_error = (result.estimated_reward_std_error or 0.0) / logged
        return CpeEstimate(
            raw=result.estimated_reward,
            normalized=normalized,
            raw_std_error=result.estimated_reward_std_error or 0.0,
            normalized_std_error=normalized_std_error,
        )


class SequentialOPEstimatorAdapter:
    """EDP -> RLEstimatorInput (reference ope_adapter.py:131-290)."""

    def __init__(self, ope_estimator: Estimator, gamma: float):
        self._estimator = ope_estimator
        self.gamma = gamma

    @staticmethod
    def edp_to_rl_input(edp: EvaluationDataPage, gamma: float) -> RLEstimatorInput:
        assert edp.mdp_id is not None and edp.model_values is not None
        mdp = np.asarray(edp.mdp_id).reshape(-1)
        _, starts = np.unique(mdp, return_index=True)
        starts = np.sort(starts)
        ends = np.append(starts[1:], len(mdp))
        N = len(starts)
        T = int(np.max(ends - starts))
        A = edp.action_mask.shape[1]
        actions = np.zeros((N, T), np.int64)
        rewards = np.zeros((N, T))
        log_prop = np.ones((N, T))
        tgt_prop = np.full((N, T, A), 1.0 / A)
        mask = np.zeros((N, T))
        q_values = np.zeros((N, T, A))
        for i, (s, e) in enumerate(zip(starts, ends)):
            L = e - s
            actions[i, :L] = np.argmax(edp.action_mask[s:e], axis=1)
            rewards[i, :L] = edp.logged_rewards[s:e].reshape(-1)
            log_prop[i, :L] = edp.logged_propensities[s:e].reshape(-1)
            tgt_prop[i, :L] = edp.model_propensities[s:e]
            q_values[i, :L] = edp.model_values[s:e]
            mask[i, :L] = 1.0
        return RLEstimatorInput(
            gamma=gamma,
            actions=actions,
            rewards=rewards,
            log_propensities=log_prop,
            tgt_propensities=tgt_prop,
            mask=mask,
            q_values=q_values,
        )

    def estimate(self, edp: EvaluationDataPage) -> CpeEstimate:
        rl_input = self.edp_to_rl_input(edp, self.gamma)
        result = self._estimator.evaluate(rl_input)
        logged = max(rl_input.log_value(), 1e-6)
        return CpeEstimate(
            raw=result.estimated_reward,
            normalized=result.estimated_reward / logged,
            raw_std_error=result.estimated_reward_std_error or 0.0,
            normalized_std_error=(result.estimated_reward_std_error or 0.0) / logged,
        )
