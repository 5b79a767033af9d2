"""Observers: composite dispatch, epoch-end hooks, interval aggregation.

Port of ``reagent_tpu/core/observers.py`` (reference:
reagent/core/observers.py:16-117).  ValueListObserver lives in
core/tracker.py (re-exported here for the reference's import layout).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, List, Optional

from reagent_tpu_torch.core.tracker import (
    Aggregator,
    Observer,
    SummaryWriterContext,
    ValueListObserver,
)

logger = logging.getLogger(__name__)

__all__ = [
    "CompositeObserver",
    "EpochEndObserver",
    "ValueListObserver",
    "TensorBoardScalarObserver",
    "IntervalAggregatingObserver",
]


class CompositeObserver(Observer):
    """Dispatch each key to the child observers watching it (ref :16-31)."""

    def __init__(self, observers: Iterable[Observer]):
        self.observers: Dict[str, List[Observer]] = {}
        for observer in observers:
            for key in observer.observing_keys:
                self.observers.setdefault(key, []).append(observer)
        super().__init__(list(self.observers))

    def update(self, key: str, value: Any) -> None:
        for observer in self.observers.get(key, []):
            observer.update(key, value)


class EpochEndObserver(Observer):
    """Invoke a callback with the epoch number at epoch end (ref :34-44)."""

    def __init__(self, callback, key: str = "epoch_end"):
        super().__init__(observing_keys=[key])
        self.callback = callback

    def update(self, key: str, value: Any) -> None:
        self.callback(value)


class TensorBoardScalarObserver(Observer):
    """Forward a key straight to TB (ref :64-71)."""

    def __init__(self, key: str, logging_key: Optional[str] = None):
        super().__init__(observing_keys=[key])
        self.key = key
        self.logging_key = logging_key or key

    def update(self, key: str, value: Any) -> None:
        SummaryWriterContext.add_scalar(self.logging_key, value)


class IntervalAggregatingObserver(Observer):
    """Buffer values, aggregate every ``interval`` updates + at epoch end
    (ref :74-117)."""

    def __init__(
        self,
        interval: Optional[int],
        aggregator: Aggregator,
        observe_epoch_end: bool = True,
    ):
        self.key = aggregator.key
        obs_keys = ["epoch_end"] if observe_epoch_end else []
        obs_keys.append(self.key)
        super().__init__(observing_keys=obs_keys)
        self.iteration = 0
        self.interval = interval
        self.intermediate_values: List[Any] = []
        self.aggregator = aggregator

    def update(self, key: str, value: Any) -> None:
        if key == "epoch_end":
            self.flush()
            return
        self.intermediate_values.append(value)
        self.iteration += 1
        if self.interval and self.iteration % self.interval == 0:
            self.aggregator(self.key, self.intermediate_values)
            self.intermediate_values = []

    def flush(self) -> None:
        self.iteration = 0
        if self.intermediate_values:
            self.aggregator(self.key, self.intermediate_values)
        self.intermediate_values = []
        self.aggregator.flush()
