"""Sequential (per-episode recursive) doubly-robust estimator.

Reference: reagent/evaluation/sequential_doubly_robust_estimator.py:18
(arXiv:1511.03722): DR_t = V(s_t) + w_t * (r_t + gamma * DR_{t+1} - Q(s_t, a_t)).

The port's own copy of ``reagent_tpu/evaluation/sequential_doubly_robust_estimator.py``,
line for line (numpy on the host), so that the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from reagent_tpu_torch.evaluation.cpe import CpeEstimate, bootstrapped_std_error_of_mean
from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage

logger = logging.getLogger(__name__)


class SequentialDoublyRobustEstimator:
    def __init__(self, gamma: float):
        self.gamma = gamma

    def estimate(self, edp: EvaluationDataPage) -> CpeEstimate:
        logged_rewards = edp.logged_rewards.reshape(-1)
        logged_propensities = edp.logged_propensities.reshape(-1)
        num_examples = logged_rewards.shape[0]

        assert edp.model_values is not None
        estimated_state_values = np.sum(edp.model_propensities * edp.model_values, axis=1)
        estimated_q_logged = np.sum(edp.model_values * edp.action_mask, axis=1)
        target_prop_logged = np.sum(edp.model_propensities * edp.action_mask, axis=1)
        importance_weight = target_prop_logged / logged_propensities

        assert edp.mdp_id is not None
        mdp = np.asarray(edp.mdp_id).reshape(-1)

        doubly_robusts: List[float] = []
        episode_values: List[float] = []
        i = 0
        last_episode_end = -1
        while i < num_examples:
            if i == num_examples - 1 or mdp[i] != mdp[i + 1]:
                episode_end = i
                episode_value = 0.0
                doubly_robust = 0.0
                for j in range(episode_end, last_episode_end, -1):
                    doubly_robust = estimated_state_values[j] + importance_weight[j] * (
                        logged_rewards[j]
                        + self.gamma * doubly_robust
                        - estimated_q_logged[j]
                    )
                    episode_value *= self.gamma
                    episode_value += logged_rewards[j]
                doubly_robusts.append(float(doubly_robust))
                episode_values.append(float(episode_value))
                last_episode_end = episode_end
            i += 1

        assert doubly_robusts, "No episodes found (wrong mdp ids?)"
        doubly_robusts_arr = np.array(doubly_robusts)
        dr_score = float(np.mean(doubly_robusts_arr))
        dr_std = bootstrapped_std_error_of_mean(doubly_robusts_arr)

        episode_values_arr = np.array(episode_values)
        logged_policy_score = float(np.mean(episode_values_arr))
        if logged_policy_score < 1e-6:
            logger.warning(
                "Can't normalize SDR-CPE because of small or negative logged_policy_score"
            )
            return CpeEstimate(
                raw=dr_score, normalized=0.0, raw_std_error=dr_std,
                normalized_std_error=0.0,
            )
        return CpeEstimate(
            raw=dr_score,
            normalized=dr_score / logged_policy_score,
            raw_std_error=dr_std,
            normalized_std_error=dr_std / logged_policy_score,
        )
