"""Sequential CPE estimators over padded ``[N, T]`` trajectories on a device.

Port of ``reagent_tpu/evaluation/jax_sequential_estimators.py``.  The
O(N * T * A) work of seq-DR, WDR and MAGIC (importance-weight cumulative
products, self-normalisation, every j-step return, the per-subset
infinite-step returns and the per-episode DR recursion) runs in float32 on
the device the caller names, as JAX's runs in float32 under ``jit``.  The
host keeps what is small: the j-step list and subsets, the J-dimensional
MAGIC blend (scipy's SLSQP, through the numpy oracle's methods) and the
bootstraps over ``np.random``.

Padding contract: rewards, actions, target propensities and Q pad with 0,
logged propensities with 1, the fill values of the oracle's
``transform_to_equal_length_trajectories``, so padded steps add nothing to
any estimate.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from reagent_tpu_torch.evaluation.cpe import CpeEstimate, bootstrapped_std_error_of_mean
from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage
from reagent_tpu_torch.evaluation.weighted_sequential_doubly_robust_estimator import (
    WeightedSequentialDoublyRobustEstimator,
)
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class PaddedTrajectories(NamedTuple):
    """Equal-length episode views of a flat (sorted by mdp, seq) page."""

    actions: Tensor  # [N, T, A] one-hot logged action, 0-padded
    rewards: Tensor  # [N, T], 0-padded
    logged_propensities: Tensor  # [N, T], 1-padded
    target_propensities: Tensor  # [N, T, A], 0-padded
    q_values: Tensor  # [N, T, A], 0-padded


def pad_edp_trajectories(edp: EvaluationDataPage, device="cuda") -> PaddedTrajectories:
    """Vectorised host-side padding (no per-episode loop), then one copy of
    each array to ``device``."""
    device = resolve_device(device)
    assert edp.mdp_id is not None and edp.model_values is not None
    mdp = np.asarray(edp.mdp_id).reshape(-1)
    n = mdp.shape[0]
    change = mdp[1:] != mdp[:-1]
    ends = np.nonzero(np.append(change, True))[0]
    starts = np.concatenate([[0], ends[:-1] + 1])
    lengths = ends - starts + 1
    N, T = len(starts), int(lengths.max())
    A = edp.action_mask.shape[1]
    row = np.repeat(np.arange(N), lengths)
    col = np.arange(n) - np.repeat(starts, lengths)

    actions = np.zeros((N, T, A), np.float32)
    actions[row, col] = np.asarray(edp.action_mask)
    rewards = np.zeros((N, T), np.float32)
    rewards[row, col] = np.asarray(edp.logged_rewards).reshape(-1)
    logged_prop = np.ones((N, T), np.float32)
    logged_prop[row, col] = np.asarray(edp.logged_propensities).reshape(-1)
    target_prop = np.zeros((N, T, A), np.float32)
    target_prop[row, col] = np.asarray(edp.model_propensities)
    q_values = np.zeros((N, T, A), np.float32)
    q_values[row, col] = np.asarray(edp.model_values)
    return PaddedTrajectories(*(
        torch.from_numpy(a).to(device)
        for a in (actions, rewards, logged_prop, target_prop, q_values)))


# ---------------------------------------------------------------- WDR / MAGIC


def _normalize_iw(iw: Tensor, self_normalize: bool) -> Tensor:
    """The oracle's normalize_importance_weights (reference :312-328):
    per-time-column self-normalisation, an all-zero column made uniform."""
    if not self_normalize:
        return iw / iw.shape[0]
    sums = iw.sum(dim=0)  # [T]
    zero = sums == 0.0
    iw = torch.where(zero[None, :], torch.ones_like(iw), iw)
    sums = torch.where(zero, torch.full_like(sums, float(iw.shape[0])), sums)
    return iw / sums


def _segment_sum(x: Tensor, seg_ids: Tensor, num_segments: int) -> Tensor:
    return torch.zeros((num_segments, *x.shape[1:]), dtype=x.dtype,
                       device=x.device).index_add_(0, seg_ids, x)


def _segment_normalize_iw(
    iw: Tensor, seg_ids: Tensor, seg_sizes: Tensor, num_segments: int,
    self_normalize: bool,
) -> Tensor:
    """normalize_importance_weights applied to each subset on its own."""
    if not self_normalize:
        return iw / seg_sizes[seg_ids][:, None]
    sums = _segment_sum(iw, seg_ids, num_segments)  # [S, T]
    zero = sums == 0.0
    iw = torch.where(zero[seg_ids], torch.ones_like(iw), iw)
    sums = torch.where(zero, seg_sizes[:, None].to(iw.dtype).expand_as(sums), sums)
    return iw / sums[seg_ids]


def _step_returns(gammas, iw, iw_oe, rewards, state_values, q_logged) -> Tensor:
    """[rows, T] weighted inputs -> each row's return at every j (cols 0..T)."""
    wd = gammas[None, :] * iw
    wd_oe = gammas[None, :] * iw_oe
    zero_col = torch.zeros((iw.shape[0], 1), dtype=iw.dtype, device=iw.device)
    # col j+1: the importance-sampled return through step j
    isr = torch.cat([zero_col, torch.cumsum(wd * rewards, dim=1)], dim=1)
    cv = torch.cat(
        [zero_col, torch.cumsum(wd * q_logged - wd_oe * state_values, dim=1)], dim=1)
    # col j+1: the DM bootstrap value at step j+1 (0 past the horizon)
    dm = torch.cat([wd_oe * state_values, zero_col], dim=1)
    return isr + dm - cv  # [rows, T+1]


def _wdr_core(
    padded: PaddedTrajectories,
    j_index: Tensor,  # [J] int64, already clipped to [-1, T-1]
    gammas: Tensor,  # [T] discount powers
    seg_ids: Tensor,  # [N] contiguous subset ids for the confidence bounds
    seg_sizes: Tensor,  # [S]
    num_segments: int,
    self_normalize: bool,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (j_step_return_trajectories [J, N], j_step_returns [J],
    infinite_step_returns [S], episode_values [N])."""
    actions, rewards, logged_prop, target_prop, q_values = padded
    N, T = rewards.shape

    target_prop_logged = (target_prop * actions).sum(dim=2)  # [N, T]
    q_logged = (q_values * actions).sum(dim=2)
    state_values = (target_prop * q_values).sum(dim=2)
    cum_ratios = torch.cumprod(target_prop_logged / logged_prop, dim=1)

    # all trajectories, all j-steps at once
    iw = _normalize_iw(cum_ratios, self_normalize)
    iw_oe = torch.cat([torch.full((N, 1), 1.0 / N, device=iw.device), iw[:, :-1]], dim=1)
    all_returns = _step_returns(gammas, iw, iw_oe, rewards, state_values, q_logged)
    j_step_return_trajectories = all_returns[:, j_index + 1].T  # [J, N]
    j_step_returns = j_step_return_trajectories.sum(dim=1)

    # per-subset infinite-step returns (the confidence bounds' inputs)
    iw_s = _segment_normalize_iw(cum_ratios, seg_ids, seg_sizes, num_segments, self_normalize)
    first_col = (1.0 / seg_sizes[seg_ids].to(rewards.dtype))[:, None]
    iw_s_oe = torch.cat([first_col, iw_s[:, :-1]], dim=1)
    inf_per_row = _step_returns(gammas, iw_s, iw_s_oe, rewards, state_values, q_logged)[:, T]
    infinite_step_returns = _segment_sum(inf_per_row, seg_ids, num_segments)

    episode_values = (rewards * gammas[None, :]).sum(dim=1)
    return j_step_return_trajectories, j_step_returns, infinite_step_returns, episode_values


class TorchWeightedSequentialDoublyRobustEstimator:
    """WDR and MAGIC with the array work on ``device``.

    The MAGIC blend (confidence bounds, the J-dimensional SLSQP and the
    50-sample bootstrap over j-step subsets) reuses the numpy oracle's host
    methods on the device's returns, so given the same ``np.random`` stream
    it follows ``WeightedSequentialDoublyRobustEstimator``.
    """

    def __init__(self, gamma: float, device="cuda"):
        self.gamma = gamma
        self.device = resolve_device(device)
        self._oracle = WeightedSequentialDoublyRobustEstimator(gamma)

    def estimate(
        self,
        edp: EvaluationDataPage,
        num_j_steps: int,
        whether_self_normalize_importance_weights: bool,
    ) -> CpeEstimate:
        return self.estimate_padded(
            pad_edp_trajectories(edp, self.device), num_j_steps,
            whether_self_normalize_importance_weights)

    def estimate_padded(
        self,
        padded: PaddedTrajectories,
        num_j_steps: int,
        whether_self_normalize_importance_weights: bool,
    ) -> CpeEstimate:
        N, T = padded.rewards.shape
        dev = padded.rewards.device

        # MAGIC's confidence bounds need two trajectories to form subsets
        # (the reference divides by a subset count floored to zero there,
        # weighted_sequential_doubly_robust_estimator.py:99): fall back to
        # the plain WDR estimate, as the JAX package does
        if N < 2:
            num_j_steps = 1

        j_steps = [float("inf")]
        if num_j_steps > 1:
            j_steps.append(-1)
        if num_j_steps > 2:
            interval = T // (num_j_steps - 1)
            j_steps.extend([i * interval for i in range(1, num_j_steps - 1)])
        j_index = torch.tensor([int(min(j, T - 1)) for j in j_steps], device=dev)

        # subsets feed only the multi-j confidence bounds; at least one, so
        # a one-trajectory page cannot divide by zero on the single-j path
        if len(j_steps) > 1:
            num_subsets = max(1, int(min(
                N / 2, WeightedSequentialDoublyRobustEstimator.NUM_SUBSETS_FOR_CB_ESTIMATES)))
        else:
            num_subsets = 1
        interval = N / num_subsets
        seg_ids = np.zeros(N, np.int64)
        seg_sizes = np.zeros(num_subsets, np.int64)
        for s in range(num_subsets):
            lo, hi = int(s * interval), int((s + 1) * interval)
            seg_ids[lo:hi] = s
            seg_sizes[s] = hi - lo

        gammas = torch.tensor(
            np.logspace(start=0, stop=T - 1, num=T, base=self.gamma), dtype=torch.float32,
            device=dev)
        traj, j_step_returns, inf_returns, episode_values = _wdr_core(
            padded, j_index, gammas, torch.from_numpy(seg_ids).to(dev),
            torch.from_numpy(seg_sizes).to(dev), num_subsets,
            whether_self_normalize_importance_weights,
        )
        j_step_return_trajectories = traj.cpu().numpy().astype(np.float64)
        j_step_returns = j_step_returns.cpu().numpy().astype(np.float64)
        infinite_step_returns = [float(x) for x in inf_returns.cpu().numpy()]

        if len(j_step_returns) == 1:
            wdr = float(j_step_returns[0])
            wdr_std_error = 0.0
        else:
            wdr = self._oracle.compute_weighted_doubly_robust_point_estimate(
                j_steps, num_j_steps, j_step_returns, infinite_step_returns,
                j_step_return_trajectories,
            )
            bootstrapped_means = []
            sample_size = min(
                int(self._oracle.BOOTSTRAP_SAMPLE_PCT * num_subsets), num_j_steps)
            for _ in range(self._oracle.NUM_BOOTSTRAP_SAMPLES):
                random_idxs = np.random.choice(num_j_steps, sample_size, replace=False)
                random_idxs.sort()
                bootstrapped_means.append(
                    self._oracle.compute_weighted_doubly_robust_point_estimate(
                        j_steps=[j_steps[i] for i in random_idxs],
                        num_j_steps=sample_size,
                        j_step_returns=j_step_returns[random_idxs],
                        infinite_step_returns=infinite_step_returns,
                        j_step_return_trajectories=j_step_return_trajectories[random_idxs],
                    )
                )
            wdr_std_error = float(np.std(bootstrapped_means))

        logged_policy_score = float(np.nanmean(episode_values.cpu().numpy()))
        if logged_policy_score < 1e-6:
            return CpeEstimate(
                raw=wdr, normalized=0.0, raw_std_error=wdr_std_error,
                normalized_std_error=0.0,
            )
        return CpeEstimate(
            raw=wdr,
            normalized=wdr / logged_policy_score,
            raw_std_error=wdr_std_error,
            normalized_std_error=wdr_std_error / logged_policy_score,
        )


# ------------------------------------------------------------------- seq-DR


def _seq_dr_core(padded: PaddedTrajectories, gamma: float) -> Tuple[Tensor, Tensor]:
    """Each episode's recursive DR and discounted value, all episodes at once.

    DR_t = V(s_t) + w_t * (r_t + gamma * DR_{t+1} - Q(s_t, a_t)), right to
    left over T on [N] vectors (reference
    sequential_doubly_robust_estimator.py:42-58).  The reference walks only
    real steps, so a padded step (its one-hot action all zero) leaves
    (dr, ev) unchanged.
    """
    actions, rewards, logged_prop, target_prop, q_values = padded
    state_values = (target_prop * q_values).sum(dim=2)
    q_logged = (q_values * actions).sum(dim=2)
    iw = (target_prop * actions).sum(dim=2) / logged_prop
    valid = actions.sum(dim=2) > 0
    N, T = rewards.shape
    dr = torch.zeros(N, dtype=rewards.dtype, device=rewards.device)
    ev = torch.zeros_like(dr)
    for t in range(T - 1, -1, -1):
        m = valid[:, t]
        dr = torch.where(
            m, state_values[:, t] + iw[:, t] * (rewards[:, t] + gamma * dr - q_logged[:, t]), dr)
        ev = torch.where(m, ev * gamma + rewards[:, t], ev)
    return dr, ev


class TorchSequentialDoublyRobustEstimator:
    """SequentialDoublyRobustEstimator with the recursion on ``device``."""

    def __init__(self, gamma: float, device="cuda"):
        self.gamma = gamma
        self.device = resolve_device(device)

    def estimate(self, edp: EvaluationDataPage) -> CpeEstimate:
        return self.estimate_padded(pad_edp_trajectories(edp, self.device))

    def estimate_padded(self, padded: PaddedTrajectories) -> CpeEstimate:
        drs, evs = _seq_dr_core(padded, self.gamma)
        drs = drs.cpu().numpy().astype(np.float64)
        evs = evs.cpu().numpy().astype(np.float64)
        dr_score = float(np.mean(drs))
        dr_std = bootstrapped_std_error_of_mean(drs)
        logged_policy_score = float(np.mean(evs))
        if logged_policy_score < 1e-6:
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
