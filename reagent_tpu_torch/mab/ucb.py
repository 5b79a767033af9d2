"""UCB bandit algorithms.

Port of ``reagent_tpu/mab/ucb.py`` (reference reagent/mab/ucb.py:15-141):
``UCB1``, ``MetricUCB``, ``UCBTuned``; an unseen arm scores +inf.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from reagent_tpu_torch.mab.mab_algorithm import MABAlgo, MABState

Tensor = torch.Tensor


class BaseUCB(MABAlgo):
    def __init__(self, n_arms: Optional[int] = None, arm_ids: Optional[Sequence[str]] = None,
                 alpha: float = 1.0, min_num_obs_per_arm: int = 1,
                 estimate_variance: bool = True):
        super().__init__(n_arms=n_arms, arm_ids=arm_ids)
        self.alpha = alpha
        self.min_num_obs_per_arm = min_num_obs_per_arm
        self.estimate_variance = estimate_variance

    def var(self, state: MABState) -> Tensor:
        """Per-arm reward variance estimate (reference ucb.py:48-56)."""
        if not self.estimate_variance:
            return torch.ones(self.n_arms, device=state.total_n_obs_per_arm.device)
        avg = self.get_avg_reward_values(state)
        n = torch.clamp(state.total_n_obs_per_arm, min=1e-12)
        return state.total_sum_reward_squared_per_arm / n - avg ** 2

    def _log_t_over_n(self, state: MABState) -> Tensor:
        return torch.log(state.total_n_obs_all_arms + 1) / torch.clamp(
            state.total_n_obs_per_arm, min=1e-12)

    def _seen(self, state: MABState, scores: Tensor) -> Tensor:
        return torch.where(state.total_n_obs_per_arm > 0, scores,
                           torch.full_like(scores, float("inf")))


class UCB1(BaseUCB):
    """UCB_i = avg_i + alpha * sqrt(2 ln(T+1) / n_i * var) (reference ucb.py:60-80)."""

    def get_scores(self, state, draws=None, generator=None):
        avg = self.get_avg_reward_values(state)
        return self._seen(state, avg + self.alpha * torch.sqrt(
            2 * self._log_t_over_n(state) * self.var(state)))


class MetricUCB(BaseUCB):
    """UCB_i = avg + alpha * (sqrt(avg * ln(T+1)/n) + ln(T+1)/n) (ref ucb.py:83-105,
    arXiv:0809.4882)."""

    def get_scores(self, state, draws=None, generator=None):
        avg = self.get_avg_reward_values(state)
        log_t_over_ni = self._log_t_over_n(state)
        return self._seen(state, avg + self.alpha * (
            torch.sqrt(avg * log_t_over_ni) + log_t_over_ni))


class UCBTuned(BaseUCB):
    """UCB-Tuned (Auer et al. 2002, section 4): variance-aware radius."""

    def get_scores(self, state, draws=None, generator=None):
        avg = self.get_avg_reward_values(state)
        log_t_over_ni = self._log_t_over_n(state)
        per_arm_var_est = self.var(state) + torch.sqrt(2 * log_t_over_ni)
        return self._seen(state, avg + self.alpha * torch.sqrt(
            log_t_over_ni * torch.clamp(per_arm_var_est, max=0.25)))
