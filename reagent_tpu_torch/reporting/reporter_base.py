"""Reporter base: an observer bundle with interval/epoch aggregators.

Port of ``reagent_tpu/reporting/reporter_base.py`` (reference:
reagent/reporting/reporter_base.py:25-62 and compound_reporter.py):
reporters subscribe value/aggregating observers to trainer metrics and flush
aggregates per epoch to the ambient SummaryWriterContext.  ``log`` brings a
step's tensors to the host in one copy (``values_to_host``) before any
observer sees them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from reagent_tpu_torch.core.tracker import (
    Aggregator,
    SummaryWriterContext,
    ValueListObserver,
    values_to_host,
)


class ReporterBase:
    def __init__(
        self,
        value_list_observers: Optional[Dict[str, ValueListObserver]] = None,
        aggregating_observers: Optional[Dict[str, Aggregator]] = None,
    ):
        self._value_list_observers = value_list_observers or {}
        self._aggregating_observers = aggregating_observers or {}
        self._num_data_points_per_epoch: Optional[int] = None
        self.last_flush: Dict[str, float] = {}

    def log(self, **kwargs: Any) -> None:
        """Trainers call reporter.log(**metrics) each step (ref reporter_base.py:40)."""
        self._log_host(values_to_host(kwargs))

    def _log_host(self, values: Mapping[str, Any]) -> None:
        for key, value in values.items():
            if value is None:
                continue
            obs = self._value_list_observers.get(key)
            if obs is not None:
                obs.update(key, np.asarray(value))
            agg = self._aggregating_observers.get(key)
            if agg is not None:
                agg.update(key, np.asarray(value))

    def flush(self, epoch: int) -> Dict[str, float]:
        """Flush aggregates to TB + return them (ref reporter_base.py:48-57)."""
        out: Dict[str, float] = {}
        for key, agg in self._aggregating_observers.items():
            v = agg.flush()
            if v is not None:
                out[key] = v
                SummaryWriterContext.add_scalar(f"{key}/epoch", v)
        self.last_flush = out
        return out

    def values_of(self, key: str) -> List[Any]:
        obs = self._value_list_observers.get(key)
        return obs.values if obs else []

    def generate_training_report(self) -> Dict[str, float]:
        return dict(self.last_flush)


class CompoundReporter(ReporterBase):
    """Route metrics to several reporters (reference compound_reporter.py)."""

    def __init__(self, reporters: Sequence[ReporterBase]):
        super().__init__()
        self._reporters = list(reporters)

    def log(self, **kwargs: Any) -> None:
        values = values_to_host(kwargs)
        for r in self._reporters:
            r._log_host(values)

    def flush(self, epoch: int) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self._reporters:
            out.update(r.flush(epoch))
        self.last_flush = out
        return out
