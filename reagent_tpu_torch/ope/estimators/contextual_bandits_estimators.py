"""Contextual-bandit OPE estimators: DM, IPS, DR, Switch, SwitchDR.

Port of ``reagent_tpu/ope/estimators/contextual_bandits_estimators.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/estimators/contextual_bandits_estimators.py
(DM :84, IPS :304, DR :374, Switch :453, SwitchDR :651; DR from
arXiv:1103.4601 / arXiv:1612.01205, Switch from arXiv:1612.01205 §4-5).

Vectorized re-design: the reference walks per-sample ``LogSample`` objects in
Python; here the input carries dense ``[N]`` / ``[N, A]`` arrays so every
estimate is a handful of numpy reductions.  ``log_action == -1`` encodes the
reference's ``Action(None)`` — no logged action (used by the seq2slate greedy
EDP path, reference evaluation_data_page.py:123-133, where the logged slate
may not match the model's greedy slate): such samples contribute zero to IPS
terms but still count in the sample mean, and fall back to pure DM in DR.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from reagent_tpu_torch.evaluation.cpe import bootstrapped_std_error_of_mean
from reagent_tpu_torch.ope.estimators.estimator import Estimator, EstimatorResult

PROPENSITY_THRESHOLD = 1e-6
# reference estimator.py:21 — below this the normalizer is 0
SCORE_THRESHOLD = 1e-6


@dataclasses.dataclass
class BanditsEstimatorInput:
    """Arrays over N logged samples with A actions.

    log_action: [N] int, -1 meaning "no logged action" (Action(None));
    log_reward: [N]; log_propensities: [N, A] behavior policy;
    tgt_propensities: [N, A] target policy; dm_rewards: [N, A] reward-model
    predictions (optional); dm_rewards_for_logged_action: [N] reward-model
    prediction for the logged action, when it is not a row of ``dm_rewards``
    (the slate case: reference ModelOutputs.tgt_reward_from_log_action);
    ground_truth_reward: scalar optional.
    """

    log_action: np.ndarray
    log_reward: np.ndarray
    log_propensities: np.ndarray
    tgt_propensities: np.ndarray
    dm_rewards: Optional[np.ndarray] = None
    dm_rewards_for_logged_action: Optional[np.ndarray] = None
    ground_truth_reward: Optional[float] = None

    @property
    def n(self) -> int:
        return self.log_action.shape[0]

    @property
    def num_actions(self) -> int:
        return self.log_propensities.shape[1]

    def has_action(self) -> np.ndarray:
        return np.asarray(self.log_action) >= 0

    def _safe_action(self) -> np.ndarray:
        return np.maximum(np.asarray(self.log_action), 0)

    def logged_propensity_of_action(self) -> np.ndarray:
        p = self.log_propensities[np.arange(self.n), self._safe_action()]
        return np.where(self.has_action(), p, 0.0)

    def target_propensity_of_action(self) -> np.ndarray:
        p = self.tgt_propensities[np.arange(self.n), self._safe_action()]
        return np.where(self.has_action(), p, 0.0)

    def importance_weights(self, clamp_max: Optional[float] = None) -> np.ndarray:
        """w_i = tgt(a_i)/log(a_i); 0 when no action or propensity ~ 0
        (reference :516-523, :330-340)."""
        logp = self.logged_propensity_of_action()
        w = np.where(
            logp < PROPENSITY_THRESHOLD,
            0.0,
            self.target_propensity_of_action() / np.maximum(logp, PROPENSITY_THRESHOLD),
        )
        if clamp_max is not None:
            w = np.minimum(w, clamp_max)
        return w

    def dm_reward_per_sample(self) -> np.ndarray:
        """dot(model rewards, target propensities) per sample (reference :228)."""
        assert self.dm_rewards is not None, "estimator needs a reward model"
        return np.sum(self.tgt_propensities * self.dm_rewards, axis=1)

    def dm_reward_of_logged_action(self) -> np.ndarray:
        if self.dm_rewards_for_logged_action is not None:
            return np.asarray(self.dm_rewards_for_logged_action).reshape(-1)
        assert self.dm_rewards is not None
        r = self.dm_rewards[np.arange(self.n), self._safe_action()]
        return np.where(self.has_action(), r, 0.0)


def _result(
    input: BanditsEstimatorInput, estimate: np.ndarray, rng=None
) -> EstimatorResult:
    """Mirror reference Estimator._compute_metric_data (estimator.py:168-188).

    ``rng``: optional np.random.Generator for the bootstrap std error;
    defaults to a FIXED seed so estimator outputs are reproducible across
    identical runs (thread ``rng=`` through ``evaluate`` to randomize).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    estimate = np.asarray(estimate, dtype=np.float64).reshape(-1)
    log_avg = float(np.mean(input.log_reward))
    normalizer = 0.0 if log_avg < SCORE_THRESHOLD else 1.0 / log_avg
    if len(estimate) >= 4:
        std_err = bootstrapped_std_error_of_mean(estimate, rng=rng)
    else:
        # the reference's bootstrap resamples int(0.25*N) points and returns
        # NaN below N=4; fall back to the analytic standard error there
        std_err = float(np.std(estimate) / np.sqrt(max(len(estimate), 1)))
    est_mean = float(np.mean(estimate))
    return EstimatorResult(
        log_reward=log_avg,
        estimated_reward=est_mean,
        ground_truth_reward=input.ground_truth_reward,
        estimated_weight=float(len(estimate)),
        estimated_reward_normalized=est_mean * normalizer,
        estimated_reward_std_error=std_err,
        estimated_reward_normalized_std_error=std_err * normalizer,
    )


class DMEstimator(Estimator):
    """Direct method: E_pi[reward model] (reference :84-300)."""

    def evaluate(self, input: BanditsEstimatorInput, **kwargs) -> EstimatorResult:
        return _result(input, input.dm_reward_per_sample(), rng=kwargs.get("rng"))


class IPSEstimator(Estimator):
    """Inverse propensity scoring (reference :304-370)."""

    def __init__(self, clamp_max: Optional[float] = None, weighted: bool = False):
        self.clamp_max = clamp_max
        self.weighted = weighted

    def evaluate(self, input: BanditsEstimatorInput, **kwargs) -> EstimatorResult:
        w = input.importance_weights(self.clamp_max)
        est = w * input.log_reward
        result = _result(input, est, rng=kwargs.get("rng"))
        if self.weighted:
            # reference :368: tgt_avg.average / acc_weight.total (kept verbatim
            # for parity; note it divides the MEAN by the TOTAL weight).
            # All-zero weights (target fully off the logged support) -> 0.
            total_w = float(np.sum(w))
            result.estimated_reward = (
                float(np.mean(est)) / total_w if total_w > 0 else 0.0
            )
            log_avg = result.log_reward
            normalizer = 0.0 if log_avg < SCORE_THRESHOLD else 1.0 / log_avg
            result.estimated_reward_normalized = result.estimated_reward * normalizer
        return result


class DoublyRobustEstimator(Estimator):
    """DR = DM + w * (r - r_hat(logged action)) (reference :374-450)."""

    def __init__(self, clamp_max: Optional[float] = None):
        self.clamp_max = clamp_max

    def evaluate(self, input: BanditsEstimatorInput, **kwargs) -> EstimatorResult:
        w = input.importance_weights(self.clamp_max)
        dm = input.dm_reward_per_sample()
        r_hat_logged = input.dm_reward_of_logged_action()
        # no logged action -> pure DM (reference :428-434)
        est = np.where(
            input.has_action(),
            (input.log_reward - r_hat_logged) * w + dm,
            dm,
        )
        return _result(input, est, rng=kwargs.get("rng"))


class SwitchEstimator(Estimator):
    """SWITCH: IPS where the logged-action weight is small, DM where it
    explodes; threshold tau picked by grid search minimizing the estimated
    MSE = var + bias-bound² (reference :453-650, arXiv:1612.01205 §4-5).

    kwargs on evaluate(): ``exp_base`` (default 1.5) and ``candidates``
    (default 21) control the tau grid, exactly as the reference —
    ``exp_base=1`` degenerates to pure IPS (every candidate = max weight),
    ``candidates=0`` to pure DM (tau below the smallest weight).
    """

    CANDIDATES = 21
    EXP_BASE = 1.5
    EPSILON = 1e-6

    def __init__(self, rmax: Optional[float] = None, clamp_max: Optional[float] = None):
        self._rmax = rmax
        self._clamp_max = clamp_max

    def _per_action_weights(self, input: BanditsEstimatorInput) -> np.ndarray:
        """[N, A] per-action weights (reference :516-523)."""
        ws = np.where(
            input.log_propensities < PROPENSITY_THRESHOLD,
            0.0,
            input.tgt_propensities
            / np.maximum(input.log_propensities, PROPENSITY_THRESHOLD),
        )
        if self._clamp_max is not None:
            ws = np.minimum(ws, self._clamp_max)
        return ws

    def _calc_estimated_values(
        self,
        rs: np.ndarray,  # [N] logged rewards
        ws: np.ndarray,  # [N, A] per-action weights
        actions: np.ndarray,  # [N, A] one-hot logged action (zero row = None)
        threshold: float,
        r_est: np.ndarray,  # [N, A] model rewards
        r_est_logged: np.ndarray,  # [N] model reward of logged action
        tgt_props: np.ndarray,  # [N, A]
    ) -> np.ndarray:
        """Reference :548-561."""
        ips_scores = np.sum(ws * actions, axis=1)
        return rs * ips_scores * (ips_scores <= threshold) + np.sum(
            r_est * tgt_props * (ws > threshold), axis=1
        )

    def evaluate(self, input: BanditsEstimatorInput, **kwargs) -> EstimatorResult:
        assert input.dm_rewards is not None
        exp_base = kwargs.get("exp_base", SwitchEstimator.EXP_BASE)
        num_candidates = kwargs.get("candidates", SwitchEstimator.CANDIDATES)

        n, A = input.n, input.num_actions
        ws = self._per_action_weights(input)
        actions_onehot = np.where(
            input.has_action()[:, None],
            np.eye(A)[input._safe_action()],
            0.0,
        )
        rs = np.asarray(input.log_reward, dtype=np.float64)
        r_est = np.asarray(input.dm_rewards, dtype=np.float64)
        r_est_logged = input.dm_reward_of_logged_action()
        tgt_props = np.asarray(input.tgt_propensities, dtype=np.float64)

        rmax = self._rmax
        if rmax is None:  # reference :476-482
            rmax = max(float(np.max(rs)), float(np.max(r_est)))
        expected_rmax = tgt_props * rmax

        min_w, max_w = float(ws.min()), float(ws.max())
        diff = max_w - min_w
        # tau grid (reference :598-603)
        candidates = [
            min_w + ((exp_base**x) / (exp_base ** (num_candidates - 1))) * diff
            for x in range(num_candidates)
        ]
        tau = min_w - SwitchEstimator.EPSILON
        loss = float("inf")
        for candidate in candidates:
            vals = self._calc_estimated_values(
                rs, ws, actions_onehot, candidate, r_est, r_est_logged, tgt_props
            )
            var = float(np.sum((vals - vals.mean()) ** 2)) / (n**2)
            bias = float(np.mean(np.sum(expected_rmax * (ws > candidate), axis=1)))
            cand_loss = var + bias * bias
            if cand_loss < loss:
                tau, loss = candidate, cand_loss

        est = self._calc_estimated_values(
            rs, ws, actions_onehot, tau, r_est, r_est_logged, tgt_props
        )
        return _result(input, est, rng=kwargs.get("rng"))


class SwitchDREstimator(SwitchEstimator):
    """Switch with a DR core below the threshold (reference :651-697)."""

    def _calc_estimated_values(
        self, rs, ws, actions, threshold, r_est, r_est_logged, tgt_props
    ) -> np.ndarray:
        ips_scores = np.sum(ws * actions, axis=1)
        dr = ips_scores * (rs - r_est_logged) + np.sum(tgt_props * r_est, axis=1)
        return dr * (ips_scores <= threshold) + np.sum(
            r_est * tgt_props * (ws > threshold), axis=1
        )
