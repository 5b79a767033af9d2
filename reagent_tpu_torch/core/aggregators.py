"""Metric aggregators over batched training observations.

Port of ``reagent_tpu/core/aggregators.py`` (reference:
reagent/core/aggregators.py:19-242) — TensorAggregator subclasses that
concatenate per-step values and aggregate them: TB histograms, per-action
function summaries, action counts, recent-values rings.  The inputs are
numpy arrays or tensors (brought to the host once, on arrival); TB writes go
through the ambient SummaryWriterContext (core/tracker.py).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from reagent_tpu_torch.core.tracker import Aggregator, SummaryWriterContext, to_numpy

logger = logging.getLogger(__name__)


class TensorAggregator(Aggregator):
    """Concatenate the batch dimension before aggregating (ref :19-24)."""

    def __call__(self, key: str, values) -> None:
        stacked = np.concatenate([np.atleast_1d(to_numpy(v)) for v in values], axis=0)
        self.aggregate(stacked)

    def update(self, key: str, value) -> None:  # Observer protocol
        self.__call__(key, [value])

    def aggregate(self, values: np.ndarray) -> None:
        raise NotImplementedError

    def flush(self) -> Optional[float]:
        return None


def _log_histogram_and_mean(log_key: str, val: np.ndarray) -> None:
    SummaryWriterContext.add_histogram(log_key, val)
    SummaryWriterContext.add_scalar(f"{log_key}/mean", float(np.mean(val)))


class TensorBoardHistogramAndMeanAggregator(TensorAggregator):
    def __init__(self, key: str, log_key: str):
        super().__init__(key)
        self.log_key = log_key

    def aggregate(self, values: np.ndarray) -> None:
        assert values.ndim == 1 or (values.ndim == 2 and values.shape[1] == 1), (
            f"Unexpected shape for {self.key}: {values.shape}"
        )
        _log_histogram_and_mean(self.log_key, values)


class TensorBoardActionHistogramAndMeanAggregator(TensorAggregator):
    def __init__(
        self,
        key: str,
        category: str,
        title: str,
        actions: List[str],
        log_key_prefix: Optional[str] = None,
    ):
        super().__init__(key)
        self.log_key_prefix = log_key_prefix or f"{category}/{title}"
        self.actions = actions

    def aggregate(self, values: np.ndarray) -> None:
        if not (values.ndim == 2 and values.shape[1] == len(self.actions)):
            raise ValueError(
                f"Unexpected shape for {self.key}: {values.shape};"
                f" actions: {self.actions}"
            )
        for i, action in enumerate(self.actions):
            _log_histogram_and_mean(f"{self.log_key_prefix}/{action}", values[:, i])


class TensorBoardActionCountAggregator(TensorAggregator):
    def __init__(self, key: str, title: str, actions: List[str]):
        super().__init__(key)
        self.log_key = f"actions/{title}"
        self.actions = actions

    def aggregate(self, values: np.ndarray) -> None:
        for i, action in enumerate(self.actions):
            SummaryWriterContext.add_scalar(
                f"{self.log_key}/{action}", int(np.sum(values == i))
            )


class ListAggregator(TensorAggregator):
    """Accumulate flattened values per epoch (ref :119-132)."""

    def __init__(self, key: str):
        super().__init__(key)
        self.values: List[float] = []
        self.epoch_values: List[float] = []

    def aggregate(self, values: np.ndarray) -> None:
        self.values.extend(np.ravel(values).tolist())

    def flush(self) -> None:
        if self.values:
            self.epoch_values = self.values
            self.values = []


class FunctionsByActionAggregator(TensorAggregator):
    """Per-action summaries via a dict of fns over [N, A] inputs (ref :135-193)."""

    def __init__(self, key: str, actions: List[str], fns: Dict[str, Callable]):
        super().__init__(key)
        self.actions = actions
        self.values: Dict[str, Dict[str, List[float]]] = {
            fn: {action: [] for action in actions} for fn in fns
        }
        self.fns = fns

    def aggregate(self, values: np.ndarray) -> None:
        for name, func in self.fns.items():
            aggregated = func(values, axis=0)
            for action, value in zip(self.actions, aggregated):
                self.values[name][action].append(float(value))
            latest = {a: v[-1] for a, v in self.values[name].items()}
            logger.debug("%s %s %s", name, self.key, latest)


class ActionCountAggregator(TensorAggregator):
    """Count action-index frequencies (ref :196-227)."""

    def __init__(self, key: str, actions: List[str]):
        super().__init__(key)
        self.actions = actions
        self.values: Dict[str, List[int]] = {action: [] for action in actions}

    def aggregate(self, values: np.ndarray) -> None:
        for i, action in enumerate(self.actions):
            self.values[action].append(int(np.sum(values == i)))

    def get_distributions(self) -> Dict[str, List[float]]:
        totals = np.array([sum(c) for c in zip(*self.values.values())], np.float64)
        return {
            action: (np.array(counts) / totals).tolist()
            for action, counts in self.values.items()
        }

    def get_cumulative_distributions(self) -> Dict[str, float]:
        total = sum(sum(c) for c in self.values.values())
        return {a: sum(c) / total for a, c in self.values.items()}


_RECENT_DEFAULT_SIZE = int(1e6)


class RecentValuesAggregator(TensorAggregator):
    """Ring buffer of the most recent scalar values (ref :233-242)."""

    def __init__(self, key: str, size: int = _RECENT_DEFAULT_SIZE):
        super().__init__(key)
        self.values: Deque[float] = deque(maxlen=size)

    def aggregate(self, values: np.ndarray) -> None:
        self.values.extend(np.ravel(values).tolist())
