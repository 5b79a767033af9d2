"""Slate OPE estimators: PBM and pseudo-inverse / IPS variants.

Port of ``reagent_tpu/ope/estimators/slate_estimators.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/estimators/slate_estimators.py (1,551 LoC) — the core
estimators re-designed vectorized:

* DMEstimator        — position-weighted model scores
* IPSEstimator       — whole-slate importance sampling
* PBMEstimator       — position-based click model (per-position IS)
* PseudoInverseEstimator — slot-decomposed IS (Swaminathan et al. 2017)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from reagent_tpu_torch.ope.estimators.estimator import Estimator, EstimatorResult


@dataclasses.dataclass
class SlateEstimatorInput:
    """N logged slates of K positions over M items.

    log_slate: [N, K] item ids; log_slate_prob: [N] whole-slate propensity;
    log_item_probs: [N, K, M] per-position behavior distribution;
    tgt_item_probs: [N, K, M] per-position target distribution;
    log_reward: [N] observed slate reward;
    position_weights: [K] (e.g. examination probabilities for PBM);
    item_rewards: [N, K, M] optional model of per-slot item reward.
    """

    log_slate: np.ndarray
    log_reward: np.ndarray
    log_item_probs: np.ndarray
    tgt_item_probs: np.ndarray
    log_slate_prob: Optional[np.ndarray] = None
    tgt_slate_prob: Optional[np.ndarray] = None
    position_weights: Optional[np.ndarray] = None
    item_rewards: Optional[np.ndarray] = None
    ground_truth_reward: Optional[float] = None

    @property
    def n(self):
        return self.log_slate.shape[0]

    @property
    def slots(self):
        return self.log_slate.shape[1]

    def slot_probs(self, probs: np.ndarray) -> np.ndarray:
        """probs of the logged item at each slot: [N, K]."""
        n, k = self.log_slate.shape
        return probs[np.arange(n)[:, None], np.arange(k)[None, :], self.log_slate]

    def slate_prob_chain(self, probs: np.ndarray) -> np.ndarray:
        """[N] probability of each logged slate under sequential
        without-replacement sampling: prod_k p_k(i_k) / (1 - sum_{j<k}
        p_k(i_j)), renormalizing by the CURRENT slot's mass of the items
        already placed — exactly the reference's
        SlateSlotItemProbabilities.slate_probability
        (slate_estimators.py:560-588); ~0 remaining mass -> probability 0."""
        n, k = self.log_slate.shape
        p = _normalize_rows(probs)
        sp = self.slot_probs(p)  # [N, K] p_k(i_k)
        out = np.ones(n)
        used_mass = np.zeros(n)
        dead = np.zeros(n, dtype=bool)
        for j in range(k):
            w = 1.0 - used_mass
            dead |= np.abs(w) < 1.0e-10
            out = np.where(dead, 0.0, out * sp[:, j] / np.where(dead, 1.0, w))
            if j + 1 < k:
                # mass of items placed so far, under slot j+1's distribution
                placed = self.log_slate[:, : j + 1]
                nxt = p[np.arange(n)[:, None], j + 1, placed]
                used_mass = nxt.sum(axis=1)
        return out

    def slot_item_expectations(self, probs: np.ndarray) -> np.ndarray:
        """[N, K, M] without-replacement marginal P(item m lands in slot k),
        by the reference's exact DP (slate_estimators.py:336-370
        _calculate_slot_expectation), mirrored bug-for-bug: stage k extends
        prior placements using slot k's OWN distribution."""
        return np.stack([_slot_expectation_dp(_normalize_rows(p)) for p in probs])


def _normalize_rows(probs: np.ndarray) -> np.ndarray:
    """clamp(min=0)/sum per distribution row (reference types.py:333-348)."""
    p = np.clip(np.asarray(probs, np.float64), 0.0, None)
    return p / p.sum(axis=-1, keepdims=True)


def _slot_expectation_dp(p: np.ndarray) -> np.ndarray:
    """[K, M] normalized per-slot distributions -> [K, M] marginal slot-item
    expectations under sequential without-replacement sampling (reference
    _calculate_slot_expectation, slate_estimators.py:336-370)."""
    K, M = p.shape
    # the buffer enumerates ordered placements: after stage k it holds up to
    # M*(M-1)*...*(M-k+1) states PER SAMPLE — tractable only for small
    # slates.  Guard explicitly rather than letting memory/time blow up
    # (M=20, K=6 is ~1.86M states = 20*19*18*17*16; K=5 is 116,280 and
    # passes); the default independent-slot fast path
    # (use_expectations=False) handles production slate sizes.
    states = 1
    for k in range(1, K):
        states *= max(M - k + 1, 1)
    if states > 500_000:
        raise ValueError(
            f"_slot_expectation_dp: exact without-replacement DP needs up to "
            f"{states:,} enumeration states for M={M}, K={K}; this exact "
            "reference mode is only tractable for small slates — use the "
            "default independent-slot marginals (use_expectations=False) "
            "instead"
        )
    dm = np.zeros((K, M))
    dm[0] = p[0]
    # (placed-items set, cumulative prob, placed mass, cached prob/(1-mass))
    buffer = [(frozenset(), 1.0, 0.0, 1.0)]
    for k in range(1, K):
        row = p[k]
        next_buffer = []
        for b0, b1, b2, _ in buffer:
            for i in range(M):
                if i in b0:
                    continue
                nb2 = b2 + row[i]
                if nb2 < 1.0:
                    nb1 = b1 * row[i] / (1.0 - b2)
                    next_buffer.append((b0 | {i}, nb1, nb2, nb1 / (1.0 - nb2)))
        for i in range(M):
            dm[k, i] = row[i] * sum(
                b3 for b0, _, _, b3 in next_buffer if i not in b0
            )
        buffer = next_buffer
    return dm


def _weighted_result(
    input: SlateEstimatorInput,
    weights: np.ndarray,
    valid: np.ndarray,
    weighted: bool,
) -> EstimatorResult:
    """Reference slate-estimator accumulation (slate_estimators.py:1238-1280):
    invalid samples are skipped entirely; ``weighted`` -> SNIPS
    (sum(r*w)/sum(w)), else the plain mean of r*w over valid samples."""
    r = np.asarray(input.log_reward, np.float64)[valid]
    w = np.asarray(weights, np.float64)[valid]
    if len(r) == 0:
        return EstimatorResult(log_reward=0.0, estimated_reward=0.0)
    est = r * w
    estimated = (
        float(np.sum(est) / np.sum(w)) if weighted else float(np.mean(est))
    )
    return EstimatorResult(
        log_reward=float(np.mean(r)),
        estimated_reward=estimated,
        ground_truth_reward=input.ground_truth_reward,
        estimated_weight=float(np.mean(w)) if weighted else float(len(r)),
        estimated_reward_std_error=float(np.std(est) / np.sqrt(len(est))),
    )


def _res(input: SlateEstimatorInput, est: np.ndarray) -> EstimatorResult:
    return EstimatorResult(
        log_reward=float(np.mean(input.log_reward)),
        estimated_reward=float(np.mean(est)),
        ground_truth_reward=input.ground_truth_reward,
        estimated_reward_std_error=float(np.std(est) / np.sqrt(max(len(est), 1))),
    )


class DMEstimator(Estimator):
    def evaluate(self, input: SlateEstimatorInput, **kwargs) -> EstimatorResult:
        assert input.item_rewards is not None
        w = (
            input.position_weights
            if input.position_weights is not None
            else np.ones(input.slots)
        )
        est = np.sum(
            np.sum(input.tgt_item_probs * input.item_rewards, axis=2) * w, axis=1
        )
        return _res(input, est)


class IPSEstimator(Estimator):
    """Whole-slate IS: prod_k tgt/log of logged items (reference slate IPS)."""

    def __init__(
        self,
        clamp_max: Optional[float] = None,
        self_normalize: bool = False,
        chain_prob: bool = False,
        weighted: bool = False,
    ):
        """``chain_prob`` + ``weighted`` reproduce the reference IPSEstimator
        (slate_estimators.py:1186-1250): without-replacement slate
        probabilities, log-prob<=0 samples skipped, SNIPS normalization.
        The defaults keep the fast independent-slot product."""
        self.clamp_max = clamp_max
        self.self_normalize = self_normalize
        self.chain_prob = chain_prob
        self.weighted = weighted

    def evaluate(self, input: SlateEstimatorInput, **kwargs) -> EstimatorResult:
        if self.chain_prob:
            if input.log_slate_prob is not None and input.tgt_slate_prob is not None:
                log_p = np.asarray(input.log_slate_prob, np.float64)
                tgt_p = np.asarray(input.tgt_slate_prob, np.float64)
            else:
                log_p = input.slate_prob_chain(input.log_item_probs)
                tgt_p = input.slate_prob_chain(input.tgt_item_probs)
            w = np.where(
                tgt_p == log_p,
                1.0,
                np.where(tgt_p <= 0.0, 0.0, tgt_p / np.where(log_p <= 0, 1.0, log_p)),
            )
            if self.clamp_max is not None:
                w = np.minimum(w, self.clamp_max)
            valid = (tgt_p == log_p) | (tgt_p <= 0.0) | (log_p > 0.0)
            return _weighted_result(input, w, valid, self.weighted)
        if input.log_slate_prob is not None and input.tgt_slate_prob is not None:
            w = input.tgt_slate_prob / np.maximum(input.log_slate_prob, 1e-12)
        else:
            ratio = input.slot_probs(input.tgt_item_probs) / np.maximum(
                input.slot_probs(input.log_item_probs), 1e-12
            )
            w = np.prod(ratio, axis=1)
        if self.clamp_max is not None:
            w = np.minimum(w, self.clamp_max)
        if self.self_normalize:
            w = w / max(np.mean(w), 1e-12)
        return _res(input, w * input.log_reward)


class PBMEstimator(Estimator):
    """Position-based model: reward decomposes per position; IS per slot.

    estimate = mean over slates of sum_k w_k * (tgt_k/log_k) * r/K-share
    (reference PBMEstimator; uses examination weights).
    """

    def __init__(
        self,
        clamp_max: Optional[float] = None,
        use_expectations: bool = False,
        weighted: bool = False,
    ):
        """``use_expectations`` + ``weighted`` reproduce the reference
        PBMEstimator (slate_estimators.py:1452-1530): a single per-slate
        weight (sum_k w_k h_k)/(sum_k w_k p_k) over without-replacement
        slot-item expectations, SNIPS-normalized.  The defaults keep the fast
        per-slot independent ratio."""
        self.clamp_max = clamp_max
        self.use_expectations = use_expectations
        self.weighted = weighted

    def evaluate(self, input: SlateEstimatorInput, **kwargs) -> EstimatorResult:
        k = input.slots
        pos_w = (
            input.position_weights
            if input.position_weights is not None
            else np.ones(k)
        )
        if self.use_expectations:
            h = input.slot_probs(input.slot_item_expectations(input.tgt_item_probs))
            p = input.slot_probs(input.slot_item_expectations(input.log_item_probs))
            nu = h @ pos_w
            de = p @ pos_w
            w = np.where(
                nu == de, 1.0, np.where(nu == 0, 0.0, nu / np.where(de == 0, 1.0, de))
            )
            if self.clamp_max is not None:
                w = np.minimum(w, self.clamp_max)
            valid = (nu == de) | (nu == 0) | (de != 0)
            return _weighted_result(input, w, valid, self.weighted)
        ratio = input.slot_probs(input.tgt_item_probs) / np.maximum(
            input.slot_probs(input.log_item_probs), 1e-12
        )
        if self.clamp_max is not None:
            ratio = np.minimum(ratio, self.clamp_max)
        # reward share per slot weighted by examination probability
        share = pos_w / np.sum(pos_w)
        est = np.sum(ratio * share[None, :], axis=1) * input.log_reward
        return _res(input, est)


class PseudoInverseEstimator(Estimator):
    """Slot-decomposed IS (pseudo-inverse, Swaminathan et al. 2017): the
    per-slot ratio sum replaces the exploding product."""

    def __init__(
        self,
        clamp_max: Optional[float] = None,
        reference_pinv: bool = False,
        weighted: bool = False,
    ):
        """``reference_pinv`` + ``weighted`` reproduce the reference
        PseudoInverseEstimator (slate_estimators.py:1356-1446): weight =
        tgt_expectᵀ · pinv(log_expect log_expectᵀ) · onehot(logged slate)
        over without-replacement slot-item expectations (a rank-1 pinv),
        SNIPS-normalized.  The default is the closed-form
        sum-of-ratios − (K−1) estimator."""
        self.clamp_max = clamp_max
        self.reference_pinv = reference_pinv
        self.weighted = weighted

    def evaluate(self, input: SlateEstimatorInput, **kwargs) -> EstimatorResult:
        k = input.slots
        if self.reference_pinv:
            n = input.n
            log_e = input.slot_item_expectations(input.log_item_probs)
            tgt_e = input.slot_item_expectations(input.tgt_item_probs)
            # reference :1374-1398 computes pinv(q q^T) per sample; for the
            # rank-1 outer product pinv(q q^T) = q q^T / ||q||^4 exactly, so
            # the weight collapses to (t.q)(q[logged slate].sum)/||q||^4 —
            # vectorized, no O((KM)^3) pinv per sample
            q = log_e.reshape(n, -1)
            t = tgt_e.reshape(n, -1)
            q_logged = np.sum(
                log_e[
                    np.arange(n)[:, None], np.arange(k)[None, :], input.log_slate
                ],
                axis=1,
            )
            qq = np.sum(q * q, axis=1)
            w = np.where(
                qq > 0, np.sum(t * q, axis=1) * q_logged / np.where(qq > 0, qq, 1.0) ** 2, 0.0
            )
            if self.clamp_max is not None:
                w = np.minimum(w, self.clamp_max)
            return _weighted_result(input, w, np.ones(n, dtype=bool), self.weighted)
        ratio = input.slot_probs(input.tgt_item_probs) / np.maximum(
            input.slot_probs(input.log_item_probs), 1e-12
        )
        w = np.sum(ratio, axis=1) - (k - 1)
        if self.clamp_max is not None:
            w = np.minimum(w, self.clamp_max)
        return _res(input, w * input.log_reward)


# --------------------------------------------------------------------------
# Slate metrics (reference slate_estimators.py:798-909) — what "reward of a
# slate" means for a benchmark.  Vectorized over a batch of slates: input is
# per-slot item relevances [N, K], output per-slate reward [N].
# --------------------------------------------------------------------------


class SlateMetric:
    """Base: sum of slot rewards (reference :798-832)."""

    def slot_weights(self, slate_size: int) -> np.ndarray:
        return np.ones(slate_size)

    def slot_values(self, rewards: np.ndarray) -> np.ndarray:
        return rewards

    def calculate_reward(self, rewards: np.ndarray) -> np.ndarray:
        rewards = np.atleast_2d(np.asarray(rewards, np.float64))
        w = self.slot_weights(rewards.shape[1])
        return self.slot_values(rewards) @ w

    def __call__(self, rewards: np.ndarray) -> np.ndarray:
        return self.calculate_reward(rewards)


class DCGSlateMetric(SlateMetric):
    """(2^rel - 1) / log2(pos + 1) (reference :834-860)."""

    def slot_weights(self, slate_size: int) -> np.ndarray:
        return 1.0 / np.log2(np.arange(2, slate_size + 2, dtype=np.float64))

    def slot_values(self, rewards: np.ndarray) -> np.ndarray:
        return np.power(2.0, rewards) - 1.0


class NDCGSlateMetric(DCGSlateMetric):
    """DCG normalized by the ideal DCG over the full item-relevance vector
    (reference :863-888)."""

    def __init__(self, item_rewards: np.ndarray):
        self._sorted_rewards = np.sort(np.asarray(item_rewards, np.float64))[::-1]

    def calculate_reward(self, rewards: np.ndarray) -> np.ndarray:
        rewards = np.atleast_2d(np.asarray(rewards, np.float64))
        K = rewards.shape[1]
        assert len(self._sorted_rewards) >= K
        w = self.slot_weights(K)
        idcg = float((np.power(2.0, self._sorted_rewards[:K]) - 1.0) @ w)
        if idcg == 0:
            return np.zeros(rewards.shape[0])
        return (self.slot_values(rewards) @ w) / idcg


class ERRSlateMetric(SlateMetric):
    """Expected reciprocal rank (reference :891-909)."""

    def __init__(self, max_reward: float):
        self._max_reward = max_reward

    def slot_weights(self, slate_size: int) -> np.ndarray:
        return 1.0 / (np.arange(slate_size, dtype=np.float64) + 1.0)

    def calculate_reward(self, rewards: np.ndarray) -> np.ndarray:
        rewards = np.atleast_2d(np.asarray(rewards, np.float64))
        d = 2.0 ** self._max_reward
        r = (np.power(2.0, np.clip(rewards, 0.0, self._max_reward)) - 1.0) / d
        # err[i] = prod_{j<i}(1-r_j) * r_i — cumulative product along slots
        stop = np.cumprod(1.0 - r, axis=1)
        prior = np.concatenate([np.ones((r.shape[0], 1)), stop[:, :-1]], axis=1)
        err = prior * r
        return err @ self.slot_weights(r.shape[1])


# --------------------------------------------------------------------------
# Ranking distributions (reference :129-210): P(slate | item values)
# --------------------------------------------------------------------------


class RankingDistribution:
    """Base for distributions over rankings given item values."""

    def __init__(self, deterministic: bool = False):
        self._deterministic = deterministic

    def sample_ranking(self, values: np.ndarray, rng=None) -> np.ndarray:
        raise NotImplementedError


class PassThruDistribution(RankingDistribution):
    """Rank by raw item value (reference :168-186)."""

    def sample_ranking(self, values: np.ndarray, rng=None) -> np.ndarray:
        values = np.asarray(values, np.float64)
        if self._deterministic:
            return np.argsort(-values)
        rng = rng or np.random.default_rng()
        p = values - values.min()
        p = p / p.sum() if p.sum() > 0 else np.full(len(values), 1.0 / len(values))
        return rng.choice(len(values), size=len(values), replace=False, p=p)


class FrechetDistribution(RankingDistribution):
    """Frechet-sort: perturb values with Gumbel^(1/shape) noise then sort
    (reference :189-210); equivalent to samplers/frechet.py FrechetSort."""

    def __init__(self, shape: float, deterministic: bool = False):
        super().__init__(deterministic)
        self._shape = shape

    def sample_ranking(self, values: np.ndarray, rng=None) -> np.ndarray:
        values = np.asarray(values, np.float64)
        if self._deterministic:
            return np.argsort(-values)
        rng = rng or np.random.default_rng()
        gumbel = -np.log(-np.log(rng.uniform(size=values.shape)))
        return np.argsort(-(self._shape * np.log(np.maximum(values, 1e-12)) + gumbel))
