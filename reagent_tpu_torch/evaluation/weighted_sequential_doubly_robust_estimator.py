"""Weighted sequential DR / MAGIC estimator.

Reference: reagent/evaluation/weighted_sequential_doubly_robust_estimator.py:18
(arXiv:1604.00923 sections 5, 7, 8): j-step returns blended by an MSE-minimizing
convex combination over (bias, covariance) estimates.

The port's own copy of ``reagent_tpu/evaluation/weighted_sequential_doubly_robust_estimator.py``,
line for line (numpy on the host), so that the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import itertools
import logging
from typing import List, Tuple

import numpy as np
import scipy.optimize
import scipy.stats

from reagent_tpu_torch.evaluation.cpe import CpeEstimate
from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage

logger = logging.getLogger(__name__)


def mse_loss(x, error):
    return np.dot(np.dot(x, error), x.T)


class WeightedSequentialDoublyRobustEstimator:
    NUM_SUBSETS_FOR_CB_ESTIMATES = 25
    CONFIDENCE_INTERVAL = 0.9
    NUM_BOOTSTRAP_SAMPLES = 50
    BOOTSTRAP_SAMPLE_PCT = 0.5

    def __init__(self, gamma: float):
        self.gamma = gamma

    def estimate(
        self,
        edp: EvaluationDataPage,
        num_j_steps: int,
        whether_self_normalize_importance_weights: bool,
    ) -> CpeEstimate:
        assert edp.model_values is not None
        (
            actions,
            rewards,
            logged_propensities,
            target_propensities,
            estimated_q_values,
        ) = self.transform_to_equal_length_trajectories(
            edp.mdp_id,
            edp.action_mask,
            edp.logged_rewards.reshape(-1),
            edp.logged_propensities.reshape(-1),
            edp.model_propensities,
            edp.model_values,
        )

        num_trajectories, trajectory_length = actions.shape[0], actions.shape[1]

        j_steps: List[float] = [float("inf")]
        if num_j_steps > 1:
            j_steps.append(-1)
        if num_j_steps > 2:
            interval = trajectory_length // (num_j_steps - 1)
            j_steps.extend([i * interval for i in range(1, num_j_steps - 1)])

        target_prop_logged = np.sum(target_propensities * actions, axis=2)
        est_q_logged = np.sum(estimated_q_values * actions, axis=2)
        est_state_values = np.sum(target_propensities * estimated_q_values, axis=2)

        importance_weights = target_prop_logged / logged_propensities
        importance_weights = np.cumprod(importance_weights, axis=1)
        importance_weights = self.normalize_importance_weights(
            importance_weights, whether_self_normalize_importance_weights
        )
        iw_one_earlier = np.hstack(
            [
                np.ones([num_trajectories, 1]) / num_trajectories,
                importance_weights[:, :-1],
            ]
        )

        discounts = np.logspace(
            start=0, stop=trajectory_length - 1, num=trajectory_length, base=self.gamma
        )

        j_step_return_trajectories = np.array(
            [
                self.calculate_step_return(
                    rewards, discounts, importance_weights, iw_one_earlier,
                    est_state_values, est_q_logged, j_step,
                )
                for j_step in j_steps
            ]
        )
        j_step_returns = np.sum(j_step_return_trajectories, axis=1)

        if len(j_step_returns) == 1:
            weighted_doubly_robust = float(j_step_returns[0])
            weighted_doubly_robust_std_error = 0.0
        else:
            # subset infinite-step returns for confidence bounds (ref :113-150)
            infinite_step_returns = []
            num_subsets = int(
                min(num_trajectories / 2, self.NUM_SUBSETS_FOR_CB_ESTIMATES)
            )
            interval = num_trajectories / num_subsets
            for i in range(num_subsets):
                subset = np.arange(int(i * interval), int((i + 1) * interval))
                iw = target_prop_logged[subset] / logged_propensities[subset]
                iw = np.cumprod(iw, axis=1)
                iw = self.normalize_importance_weights(
                    iw, whether_self_normalize_importance_weights
                )
                iw_oe = np.hstack(
                    [np.ones([len(subset), 1]) / len(subset), iw[:, :-1]]
                )
                infinite_step_returns.append(
                    float(
                        np.sum(
                            self.calculate_step_return(
                                rewards[subset], discounts, iw, iw_oe,
                                est_state_values[subset], est_q_logged[subset],
                                float("inf"),
                            )
                        )
                    )
                )

            weighted_doubly_robust = self.compute_weighted_doubly_robust_point_estimate(
                j_steps, num_j_steps, j_step_returns, infinite_step_returns,
                j_step_return_trajectories,
            )

            # bootstrap over j-step subsets for a std error (ref :152-168)
            bootstrapped_means = []
            # clamp to the number of j-steps: the reference samples j-step
            # indices without replacement and errors when num_subsets/2 >
            # num_j_steps (ref :155-158 with small num_j_steps)
            sample_size = min(int(self.BOOTSTRAP_SAMPLE_PCT * num_subsets), num_j_steps)
            for _ in range(self.NUM_BOOTSTRAP_SAMPLES):
                random_idxs = np.random.choice(num_j_steps, sample_size, replace=False)
                random_idxs.sort()
                bootstrapped_means.append(
                    self.compute_weighted_doubly_robust_point_estimate(
                        j_steps=[j_steps[i] for i in random_idxs],
                        num_j_steps=sample_size,
                        j_step_returns=j_step_returns[random_idxs],
                        infinite_step_returns=infinite_step_returns,
                        j_step_return_trajectories=j_step_return_trajectories[random_idxs],
                    )
                )
            weighted_doubly_robust_std_error = float(np.std(bootstrapped_means))

        episode_values = np.sum(rewards * discounts, axis=1)
        logged_policy_score = float(np.nanmean(episode_values))
        if logged_policy_score < 1e-6:
            logger.warning(
                "Can't normalize WSDR-CPE because of small or negative logged_policy_score"
            )
            return CpeEstimate(
                raw=weighted_doubly_robust, normalized=0.0,
                raw_std_error=weighted_doubly_robust_std_error,
                normalized_std_error=0.0,
            )
        return CpeEstimate(
            raw=weighted_doubly_robust,
            normalized=weighted_doubly_robust / logged_policy_score,
            raw_std_error=weighted_doubly_robust_std_error,
            normalized_std_error=weighted_doubly_robust_std_error / logged_policy_score,
        )

    def compute_weighted_doubly_robust_point_estimate(
        self, j_steps, num_j_steps, j_step_returns, infinite_step_returns,
        j_step_return_trajectories,
    ) -> float:
        low_bound, high_bound = self.confidence_bounds(
            infinite_step_returns, self.CONFIDENCE_INTERVAL
        )
        # decompose error into bias + variance (ref :218-226)
        j_step_bias = np.zeros([num_j_steps])
        where_lower = np.where(j_step_returns < low_bound)[0]
        j_step_bias[where_lower] = low_bound - j_step_returns[where_lower]
        where_higher = np.where(j_step_returns > high_bound)[0]
        j_step_bias[where_higher] = j_step_returns[where_higher] - high_bound

        covariance = np.cov(j_step_return_trajectories)
        error = covariance + j_step_bias.T * j_step_bias

        constraint = {"type": "eq", "fun": lambda x: np.sum(x) - 1.0}
        x = np.zeros([len(j_steps)])
        res = scipy.optimize.minimize(
            mse_loss, x, args=error, constraints=constraint,
            bounds=[(0, 1) for _ in range(x.shape[0])],
        )
        return float(np.dot(np.array(res.x), j_step_returns))

    @staticmethod
    def transform_to_equal_length_trajectories(
        mdp_ids, actions, rewards, logged_propensities, target_propensities,
        estimated_q_values,
    ) -> Tuple[np.ndarray, ...]:
        """Segment by episode, zero/one-pad to equal length (ref :242-310)."""
        num_actions = len(target_propensities[0])
        mdp = np.asarray(mdp_ids).reshape(-1)

        terminals = np.zeros(mdp.shape[0])
        for x in range(mdp.shape[0]):
            if x + 1 == mdp.shape[0] or mdp[x] != mdp[x + 1]:
                terminals[x] = 1

        trajectories = []
        episode_start = 0
        episode_ends = np.nonzero(terminals)[0]
        if len(terminals) - 1 not in episode_ends:
            episode_ends = np.append(episode_ends, len(terminals) - 1)
        for episode_end in episode_ends:
            trajectories.append(np.arange(episode_start, int(episode_end) + 1))
            episode_start = int(episode_end) + 1

        def to_equal_length(x, fill_value):
            return np.array(
                list(itertools.zip_longest(*x, fillvalue=fill_value))
            ).swapaxes(0, 1)

        action_trajs = to_equal_length(
            [actions[t] for t in trajectories], np.zeros([num_actions])
        )
        reward_trajs = to_equal_length([rewards[t] for t in trajectories], 0)
        logged_prop_trajs = to_equal_length(
            [logged_propensities[t] for t in trajectories], 1
        )
        target_prop_trajs = to_equal_length(
            [target_propensities[t] for t in trajectories], np.zeros([num_actions])
        )
        q_value_trajs = to_equal_length(
            [estimated_q_values[t] for t in trajectories], np.zeros([num_actions])
        )
        return action_trajs, reward_trajs, logged_prop_trajs, target_prop_trajs, q_value_trajs

    @staticmethod
    def normalize_importance_weights(
        importance_weights: np.ndarray, whether_self_normalize: bool
    ) -> np.ndarray:
        if whether_self_normalize:
            sums = np.sum(importance_weights, axis=0)
            where_zeros = np.where(sums == 0.0)[0]
            sums[where_zeros] = len(importance_weights)
            importance_weights[:, where_zeros] = 1.0
            importance_weights /= sums
            return importance_weights
        importance_weights /= importance_weights.shape[0]
        return importance_weights

    @staticmethod
    def calculate_step_return(
        rewards, discounts, importance_weights, importance_weights_one_earlier,
        estimated_state_values, estimated_q_values, j_step,
    ) -> np.ndarray:
        """Reference :330-376."""
        trajectory_length = len(rewards[0])
        num_trajectories = len(rewards)
        j_step = int(min(j_step, trajectory_length - 1))

        weighted_discounts = discounts * importance_weights
        weighted_discounts_one_earlier = discounts * importance_weights_one_earlier

        importance_sampled_cumulative_reward = np.sum(
            weighted_discounts[:, : j_step + 1] * rewards[:, : j_step + 1], axis=1
        )
        if j_step < trajectory_length - 1:
            direct_method_value = (
                weighted_discounts_one_earlier[:, j_step + 1]
                * estimated_state_values[:, j_step + 1]
            )
        else:
            direct_method_value = np.zeros([num_trajectories])

        control_variate = np.sum(
            weighted_discounts[:, : j_step + 1] * estimated_q_values[:, : j_step + 1]
            - weighted_discounts_one_earlier[:, : j_step + 1]
            * estimated_state_values[:, : j_step + 1],
            axis=1,
        )
        return importance_sampled_cumulative_reward + direct_method_value - control_variate

    @staticmethod
    def confidence_bounds(x, confidence) -> Tuple[float, float]:
        n = len(x)
        m, se = np.mean(x), scipy.stats.sem(x)
        h = se * scipy.stats.t._ppf((1 + confidence) / 2.0, n - 1)
        return m - h, m + h
