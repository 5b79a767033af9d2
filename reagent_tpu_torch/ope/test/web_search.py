"""Web-search click-log slate-OPE benchmark (Yandex-personalized-search style).

Port of ``reagent_tpu/ope/test/web_search.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/test/yandex_web_search.py:61-711 — that harness parses
the Yandex personalized-web-search click logs (sessions of queries, 10-url
slates, clicks with dwell times), converts dwell time to graded relevance,
aggregates per-query url/position relevance distributions, and runs the slate
estimators against a ground truth computed from the aggregated relevances.

This module reproduces the same pipeline with zero egress: a synthetic
click-log generator driven by a position-biased examination model stands in
for the Yandex dump, and `load_logged_queries` accepts any iterable of raw
session rows so real logs can be plugged in unchanged.  Dwell-time → relevance
thresholds match the reference (`yandex_web_search.py:55-75`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from reagent_tpu_torch.ope.estimators.estimator import EstimatorResult
from reagent_tpu_torch.ope.estimators.slate_estimators import (
    IPSEstimator,
    PBMEstimator,
    PseudoInverseEstimator,
    SlateEstimatorInput,
)

# dwell-time grading thresholds (reference yandex_web_search.py:55-56)
RELEVANT_THRESHOLD = 49
HIGHLY_RELEVANT_THRESHOLD = 399
MAX_SLATE_SIZE = 10
MIN_QUERY_COUNT = 10


def click_to_relevances(
    clicks: Iterable[Tuple[int, int]], urls: Sequence[int]
) -> Tuple[List[float], Dict[int, float]]:
    """(slot, dwell_time) clicks → per-position and per-url graded relevance.

    Grading mirrors reference yandex_web_search.py:61-75: dwell > 399 → 2.0,
    dwell > 49 → 1.0, else 0.0 (a click with short dwell is noise).
    """
    position_relevances = [0.0] * max(len(urls), MAX_SLATE_SIZE)
    url_relevances: Dict[int, float] = {url: 0.0 for url in urls}
    for slot, dwell in clicks:
        r = 0.0
        if dwell > HIGHLY_RELEVANT_THRESHOLD:
            r = 2.0
        elif dwell > RELEVANT_THRESHOLD:
            r = 1.0
        position_relevances[slot] = r
        url_relevances[urls[slot]] = r
    return position_relevances, url_relevances


class LoggedQuery:
    """One logged (user, query, slate, clicks) event.

    Reference: yandex_web_search.py:77-145 `LoggedQuery`.
    """

    def __init__(
        self,
        user_id: int,
        query_id: int,
        query_terms: Tuple[int, ...],
        url_list: Sequence[int],
    ):
        self._user_id = user_id
        self._query_id = query_id
        self._query_terms = query_terms
        self._list = list(url_list)
        self._clicks: List[Tuple[int, int]] = []
        self._position_relevances: Optional[List[float]] = None
        self._url_relevances: Optional[Dict[int, float]] = None

    def click(self, url_id: int, dwell_time: int = 100) -> None:
        if url_id in self._list:
            self._clicks.append((self._list.index(url_id), dwell_time))
            self._position_relevances = None
            self._url_relevances = None

    def click_slot(self, slot: int, dwell_time: int = 100) -> None:
        self._clicks.append((slot, dwell_time))
        self._position_relevances = None
        self._url_relevances = None

    @property
    def user_id(self) -> int:
        return self._user_id

    @property
    def query_id(self) -> int:
        return self._query_id

    @property
    def query_terms(self) -> Tuple[int, ...]:
        return self._query_terms

    @property
    def url_list(self) -> List[int]:
        return self._list

    @property
    def clicks(self) -> List[Tuple[int, int]]:
        return self._clicks

    @property
    def position_relevances(self) -> List[float]:
        if self._position_relevances is None:
            self._position_relevances, self._url_relevances = click_to_relevances(
                self._clicks, self._list
            )
        return self._position_relevances

    @property
    def url_relevances(self) -> Dict[int, float]:
        if self._url_relevances is None:
            self._position_relevances, self._url_relevances = click_to_relevances(
                self._clicks, self._list
            )
        return self._url_relevances


class TrainingQuery:
    """Aggregated relevance statistics for one query id across its logs.

    Reference: yandex_web_search.py:148-211 `TrainingQuery` (add/merge/
    finalize accumulate running means of url and position relevances).
    """

    def __init__(self, query_id: int, query_terms: Tuple[int, ...]):
        self._query_id = query_id
        self._query_terms = query_terms
        self._count = 0
        self._url_relevances: Dict[int, float] = {}
        self._position_relevances = [0.0] * MAX_SLATE_SIZE

    def add(self, query: LoggedQuery) -> None:
        self._count += 1
        for url, rel in query.url_relevances.items():
            old = self._url_relevances.get(url, 0.0)
            self._url_relevances[url] = old + (rel - old) / self._count
        for i, rel in enumerate(query.position_relevances[:MAX_SLATE_SIZE]):
            old = self._position_relevances[i]
            self._position_relevances[i] = old + (rel - old) / self._count

    def merge(self, other: "TrainingQuery") -> None:
        total = self._count + other._count
        if total == 0:
            return
        w = other._count / total
        urls = set(self._url_relevances) | set(other._url_relevances)
        self._url_relevances = {
            u: (1 - w) * self._url_relevances.get(u, 0.0)
            + w * other._url_relevances.get(u, 0.0)
            for u in urls
        }
        self._position_relevances = [
            (1 - w) * a + w * b
            for a, b in zip(self._position_relevances, other._position_relevances)
        ]
        self._count = total

    @property
    def count(self) -> int:
        return self._count

    @property
    def query_id(self) -> int:
        return self._query_id

    @property
    def query_terms(self) -> Tuple[int, ...]:
        return self._query_terms

    @property
    def url_relevances(self) -> Dict[int, float]:
        return self._url_relevances

    @property
    def position_relevances(self) -> List[float]:
        return self._position_relevances


def generate_client_logs(
    num_queries: int = 50,
    num_users: int = 200,
    sessions_per_user: int = 10,
    num_urls_per_query: int = 12,
    slate_size: int = MAX_SLATE_SIZE,
    seed: int = 0,
) -> List[LoggedQuery]:
    """Synthetic click log with PBM user behavior.

    Each query has a latent graded relevance per candidate url; the logged
    ranker orders urls by a noisy score; the simulated user examines slot k
    with probability 1/(k+1) and clicks with probability proportional to
    relevance, dwelling longer on more relevant results — the structural
    assumptions the Yandex dataset exhibits and PBM exploits.
    """
    rng = np.random.default_rng(seed)
    true_rel = rng.choice([0.0, 1.0, 2.0], size=(num_queries, num_urls_per_query),
                          p=[0.6, 0.25, 0.15])
    logs: List[LoggedQuery] = []
    for user in range(num_users):
        for _ in range(sessions_per_user):
            q = int(rng.integers(num_queries))
            noisy = true_rel[q] + rng.normal(scale=1.0, size=num_urls_per_query)
            order = np.argsort(-noisy)[:slate_size]
            lq = LoggedQuery(user, q, (q,), [q * num_urls_per_query + u for u in order])
            for k, u in enumerate(order):
                examine = rng.random() < 1.0 / (k + 1.0)
                if examine and rng.random() < 0.45 * true_rel[q, u]:
                    dwell = int(rng.gamma(shape=1 + 2 * true_rel[q, u], scale=150))
                    lq.click_slot(k, dwell)
            logs.append(lq)
    return logs


def parse_yandex_log(path: str) -> List[LoggedQuery]:
    """Parse a Yandex personalized-web-search click log into LoggedQuery rows.

    Line formats (reference yandex_web_search.py:230-292):
      session metadata:  ``SessionID M Day UserID``
      query action:      ``SessionID TimePassed Q SERPID QueryID
                           Term1,Term2,... URL,Domain URL,Domain ...``
      click action:      ``SessionID TimePassed C SERPID URLID``
    A click's dwell time is the gap to the session's next action; the last
    click of a session gets dwell 10000 (long enough to grade as highly
    relevant), exactly as the reference does.
    """
    queries: List[LoggedQuery] = []
    curr_serps: Dict[int, LoggedQuery] = {}
    curr_session = None
    curr_user = -1
    last_click = None  # (serp_id, url_id, time)

    def resolve_click(t: Optional[int]) -> None:
        nonlocal last_click
        if last_click is None:
            return
        serp_id, url_id, click_time = last_click
        q = curr_serps.get(serp_id)
        if q is not None:
            q.click(url_id, 10000 if t is None else t - click_time)
        last_click = None

    with open(path) as f:
        for line in f:
            tokens = line.strip().split()
            if len(tokens) == 4 and tokens[1] == "M":
                resolve_click(None)
                queries.extend(curr_serps.values())
                curr_serps = {}
                curr_session = int(tokens[0])
                curr_user = int(tokens[3])
            elif len(tokens) > 4 and curr_session == int(tokens[0]):
                t = int(tokens[1])
                resolve_click(t)
                if tokens[2] == "Q":
                    serp_id = int(tokens[3])
                    query_id = int(tokens[4])
                    terms = tuple(int(s) for s in tokens[5].split(","))
                    urls = [int(r.split(",")[0]) for r in tokens[6:]]
                    curr_serps[serp_id] = LoggedQuery(
                        curr_user, query_id, terms, urls
                    )
                elif tokens[2] == "C":
                    last_click = (int(tokens[3]), int(tokens[4]), t)
    resolve_click(None)
    queries.extend(curr_serps.values())
    return queries


def load_logged_queries(
    logs: Iterable[LoggedQuery], min_query_count: int = MIN_QUERY_COUNT
) -> List[TrainingQuery]:
    """Aggregate raw logged queries by query id (reference :302-360)."""
    by_query: Dict[int, TrainingQuery] = {}
    for lq in logs:
        tq = by_query.get(lq.query_id)
        if tq is None:
            tq = TrainingQuery(lq.query_id, lq.query_terms)
            by_query[lq.query_id] = tq
        tq.add(lq)
    return [tq for tq in by_query.values() if tq.count >= min_query_count]


@dataclasses.dataclass
class WebSearchDataset:
    """Per-query relevance tables in dense array form (reference
    `TrainingDataset`, yandex_web_search.py:362-541)."""

    url_relevances: np.ndarray  # [Q, M] mean graded relevance per candidate
    position_relevances: np.ndarray  # [Q, K]
    query_ids: np.ndarray  # [Q]

    @classmethod
    def from_training_queries(
        cls, queries: Sequence[TrainingQuery], num_urls_per_query: int
    ) -> "WebSearchDataset":
        Q = len(queries)
        url_rel = np.zeros((Q, num_urls_per_query))
        pos_rel = np.zeros((Q, MAX_SLATE_SIZE))
        qids = np.zeros(Q, np.int64)
        for i, tq in enumerate(queries):
            qids[i] = tq.query_id
            for url, rel in tq.url_relevances.items():
                url_rel[i, url % num_urls_per_query] = rel
            pos_rel[i] = tq.position_relevances
        return cls(url_rel, pos_rel, qids)

    @classmethod
    def from_real_queries(
        cls, queries: Sequence[TrainingQuery], num_urls_per_query: int
    ) -> "WebSearchDataset":
        """Like from_training_queries but for logs with arbitrary url ids
        (a parsed Yandex dump): each query gets its own url vocabulary in
        first-seen order, truncated/padded to ``num_urls_per_query``."""
        Q = len(queries)
        url_rel = np.zeros((Q, num_urls_per_query))
        pos_rel = np.zeros((Q, MAX_SLATE_SIZE))
        qids = np.zeros(Q, np.int64)
        for i, tq in enumerate(queries):
            qids[i] = tq.query_id
            for j, (url, rel) in enumerate(tq.url_relevances.items()):
                if j >= num_urls_per_query:
                    break
                url_rel[i, j] = rel
            pos_rel[i] = tq.position_relevances
        return cls(url_rel, pos_rel, qids)

    def item_relevances(self, query_index: int) -> np.ndarray:
        return self.url_relevances[query_index]

    def slot_relevances(self, query_index: int, slots: int) -> np.ndarray:
        return self.position_relevances[query_index, :slots]


class WebSearchSlateModel:
    """Item-reward model backed by the aggregated relevance table
    (reference `YandexSlateModel`, yandex_web_search.py:544-555)."""

    def __init__(self, dataset: WebSearchDataset):
        self._dataset = dataset

    def item_rewards(self, query_index: int) -> np.ndarray:
        return self._dataset.item_relevances(query_index)


def _softmax_slot_probs(scores: np.ndarray, slate_size: int, temperature: float):
    logits = scores / temperature
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    return np.repeat(p[:, None, :], slate_size, axis=1)


def evaluate_web_search(
    dataset: WebSearchDataset,
    slate_size: int = 4,
    log_temperature: float = 1.0,
    tgt_temperature: float = 0.4,
    samples_per_query: int = 80,
    seed: int = 0,
) -> Dict[str, EstimatorResult]:
    """Log slates with a blunt ranker over the aggregated relevances, then
    estimate a sharp ranker's position-weighted reward (reference
    `evaluate`, yandex_web_search.py:557+)."""
    rng = np.random.default_rng(seed)
    rel = dataset.url_relevances
    Q, M = rel.shape
    K = slate_size
    weights = 1.0 / np.log2(np.arange(K) + 2)

    log_probs = _softmax_slot_probs(rel + rng.normal(scale=0.3, size=rel.shape),
                                    K, log_temperature)
    tgt_probs = _softmax_slot_probs(rel, K, tgt_temperature)

    N = Q * samples_per_query
    qidx = np.repeat(np.arange(Q), samples_per_query)
    log_slate = np.zeros((N, K), np.int64)
    rewards = np.zeros(N)
    for i, q in enumerate(qidx):
        chosen = [rng.choice(M, p=log_probs[q, k]) for k in range(K)]
        log_slate[i] = chosen
        rewards[i] = np.sum(weights * rel[q, chosen])

    gt = float(
        np.mean(
            np.sum(np.sum(tgt_probs * rel[:, None, :], axis=2) * weights[None, :], axis=1)
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
