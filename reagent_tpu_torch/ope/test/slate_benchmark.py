"""Slate-ranking OPE benchmark: learning-to-rank logs → IPS/PBM/PI estimates.

Port of ``reagent_tpu/ope/test/slate_benchmark.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/test/mslr_slate.py and yandex_web_search.py — build
slate logs from ranked query results (MSLR-WEB30K / Yandex datasets), log with
one ranker, estimate another ranker's DCG/reward with the slate estimators.

The reference downloads those datasets; this harness generates a synthetic
query-document corpus with the same structure (per-query docs with relevance
labels, position-discounted click reward), which runs with zero egress.  The
estimator path is identical; plug real per-query features into
``QueryCorpus.from_arrays`` to reproduce the MSLR setup.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from reagent_tpu_torch.ope.estimators.estimator import EstimatorResult
from reagent_tpu_torch.ope.estimators.slate_estimators import (
    IPSEstimator,
    PBMEstimator,
    PseudoInverseEstimator,
    SlateEstimatorInput,
)


@dataclasses.dataclass
class QueryCorpus:
    """Per-query candidate docs with graded relevance (MSLR row structure)."""

    relevances: np.ndarray  # [Q, M] graded 0..4
    features: Optional[np.ndarray] = None  # [Q, M, D]

    @classmethod
    def synthetic(
        cls, num_queries: int = 200, num_docs: int = 20, seed: int = 0
    ) -> "QueryCorpus":
        rng = np.random.default_rng(seed)
        features = rng.normal(size=(num_queries, num_docs, 8))
        w = rng.normal(size=8)
        scores = features @ w
        # graded relevance from score quantiles, like MSLR's 0..4 labels
        rel = np.zeros_like(scores)
        for q in range(num_queries):
            rel[q] = np.digitize(
                scores[q], np.quantile(scores[q], [0.5, 0.75, 0.9, 0.97])
            )
        return cls(relevances=rel, features=features)

    @classmethod
    def from_arrays(cls, relevances, features=None) -> "QueryCorpus":
        return cls(np.asarray(relevances), features)

    @classmethod
    def from_mslr(
        cls, path: str, num_docs: Optional[int] = None
    ) -> "QueryCorpus":
        """Parse an MSLR-WEB10K/30K-format file into a QueryCorpus.

        Line format (reference mslr_slate.py:106-150):
            <relevance> qid:<qid> 1:<v1> 2:<v2> ... <D>:<vD>
        with graded relevance 0..4 and consecutive lines grouped by qid.
        Queries are truncated/padded to a common document count (``num_docs``
        or the minimum query length); padding docs carry relevance 0 and zero
        features so they never help a ranker.
        """
        by_qid: Dict[int, list] = {}
        order: list = []
        with open(path) as f:
            for line in f:
                tokens = line.strip().split()
                if not tokens:
                    continue
                rel = float(tokens[0])
                qid = int(tokens[1].split(":")[1])
                feats = np.zeros(len(tokens) - 2)
                for i, tok in enumerate(tokens[2:]):
                    idx, val = tok.split(":")
                    feats[int(idx) - 1] = float(val)
                if qid not in by_qid:
                    by_qid[qid] = []
                    order.append(qid)
                by_qid[qid].append((rel, feats))
        if not order:
            raise ValueError(f"no MSLR rows in {path}")
        dim = len(by_qid[order[0]][0][1])
        if num_docs is None:
            num_docs = min(len(v) for v in by_qid.values())
        Q = len(order)
        relevances = np.zeros((Q, num_docs))
        features = np.zeros((Q, num_docs, dim))
        for i, qid in enumerate(order):
            docs = by_qid[qid][:num_docs]
            for j, (rel, feats) in enumerate(docs):
                relevances[i, j] = rel
                features[i, j] = feats
        return cls(relevances=relevances, features=features)

    @property
    def num_queries(self):
        return self.relevances.shape[0]

    @property
    def num_docs(self):
        return self.relevances.shape[1]


def train_ranker_scores(
    trainer,
    corpus: QueryCorpus,
    train_frac: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """Train a reward-model ranker on item features → relevance; return its
    per-doc scores for every query.

    Mirrors the reference MSLR harness, where LassoTrainer/DecisionTreeTrainer
    are the log/target rankers (reagent/ope/test/mslr_slate.py:369,620-621):
    fit on a training split of (feature, relevance) rows, then score all docs.
    """
    from reagent_tpu_torch.ope.trainers.linear_trainers import TrainingData

    assert corpus.features is not None, "corpus has no features to train on"
    Q, M, D = corpus.features.shape
    rng = np.random.default_rng(seed)
    train_q = rng.permutation(Q)[: max(1, int(Q * train_frac))]
    tx = corpus.features[train_q].reshape(-1, D)
    ty = corpus.relevances[train_q].reshape(-1)
    vx, vy = corpus.features.reshape(-1, D), corpus.relevances.reshape(-1)
    trainer.train(TrainingData(tx, ty, None, vx, vy))
    return np.asarray(trainer.predict(vx)).reshape(Q, M)


def _ranker_item_probs(
    scores: np.ndarray, slate_size: int, temperature: float
) -> np.ndarray:
    """Plackett-Luce per-slot marginals approximated slot-independently
    (top-k softmax without replacement collapsed to softmax per slot; the
    estimators consume per-slot distributions)."""
    Q, M = scores.shape
    logits = scores / temperature
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    return np.repeat(probs[:, None, :], slate_size, axis=1)  # [Q, K, M]


def dcg_weights(slate_size: int) -> np.ndarray:
    return 1.0 / np.log2(np.arange(slate_size) + 2)


def evaluate_slate_benchmark(
    corpus: QueryCorpus,
    slate_size: int = 5,
    log_temperature: float = 2.0,
    tgt_temperature: float = 0.3,
    noise: float = 0.5,
    num_samples_per_query: int = 10,
    seed: int = 0,
    log_trainer=None,
    tgt_trainer=None,
) -> Dict[str, EstimatorResult]:
    """Log slates with a noisy ranker; estimate a sharper ranker's DCG reward.

    Reward = sum_k w_k * relevance(item at slot k) with position weights w
    (the position-biased examination model used by PBM).

    When ``log_trainer``/``tgt_trainer`` are given (e.g. LassoTrainer,
    DecisionTreeTrainer), the corresponding ranker's scores come from a
    reward model trained on the corpus features, exactly like the reference
    MSLR harness pairs (log_trainer, tgt_trainer) =
    (DecisionTree, Lasso) / (Lasso, DecisionTree)
    (reagent/ope/test/mslr_slate.py:619-623).
    """
    rng = np.random.default_rng(seed)
    Q, M = corpus.relevances.shape
    K = slate_size
    weights = dcg_weights(K)

    # ranker score models: trained reward models when trainers are supplied,
    # otherwise noisy relevance proxies
    if log_trainer is not None:
        log_scores = train_ranker_scores(log_trainer, corpus, seed=seed)
    else:
        log_scores = corpus.relevances + rng.normal(scale=noise, size=(Q, M))
    if tgt_trainer is not None:
        tgt_scores = train_ranker_scores(tgt_trainer, corpus, seed=seed + 1)
    else:
        tgt_scores = corpus.relevances + rng.normal(scale=noise / 2, size=(Q, M))
    log_probs = _ranker_item_probs(log_scores, K, log_temperature)
    tgt_probs = _ranker_item_probs(tgt_scores, K, tgt_temperature)

    # sample logged slates: each slot independently from its declared
    # marginal, so the logged propensities are exactly log_probs (duplicates
    # possible -- the additive position-weighted reward stays well-defined)
    N = Q * num_samples_per_query
    log_slate = np.zeros((N, K), np.int64)
    rewards = np.zeros(N)
    qidx = np.repeat(np.arange(Q), num_samples_per_query)
    for i, q in enumerate(qidx):
        chosen = [rng.choice(M, p=log_probs[q, k]) for k in range(K)]
        log_slate[i] = chosen
        rewards[i] = np.sum(weights * corpus.relevances[q, chosen])

    # ground truth: closed-form expectation of the target policy's additive
    # reward: sum_k w_k * E_{i~tgt_k}[rel_i], averaged over queries
    gt = float(
        np.mean(
            np.sum(
                np.sum(tgt_probs * corpus.relevances[:, None, :], axis=2)
                * weights[None, :],
                axis=1,
            )
        )
    )

    einput = SlateEstimatorInput(
        log_slate=log_slate,
        log_reward=rewards,
        log_item_probs=log_probs[qidx],
        tgt_item_probs=tgt_probs[qidx],
        position_weights=weights,
        ground_truth_reward=gt,
    )
    return {
        "ips": IPSEstimator().evaluate(einput),
        "pbm": PBMEstimator().evaluate(einput),
        "pseudo_inverse": PseudoInverseEstimator().evaluate(einput),
    }
