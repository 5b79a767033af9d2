"""Observers of published values and the ambient summary writer.

Port of ``ObservableMixin`` (:88-110) and ``SummaryWriterContext`` (:113-172)
of ``reagent_tpu/core/tracker.py`` (reference: reagent/core/tracker.py,
reagent/core/tensorboardX.py:64-126), which the ``Evaluator`` and
``CpeEstimateSet.log_to_tensorboard`` use.  An observer is any object with
``observing_keys`` and ``update(key, value)``; the observers and aggregators
themselves wait for ``ROADMAP.md`` §1 item 2.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class ObservableMixin:
    """Anything that can notify observers of published values."""

    def __init__(self) -> None:
        self._observers: Dict[str, List[Any]] = defaultdict(list)

    def add_observer(self, observer) -> "ObservableMixin":
        for key in observer.observing_keys:
            if observer not in self._observers[key]:
                self._observers[key].append(observer)
        return self

    def add_observers(self, observers: Sequence[Any]) -> "ObservableMixin":
        for o in observers:
            self.add_observer(o)
        return self

    def notify_observers(self, **kwargs: Any) -> None:
        for key, value in kwargs.items():
            if value is None:
                continue
            for observer in self._observers.get(key, []):
                observer.update(key, value)


class SummaryWriterContext:
    """Ambient TensorBoard writer stack with a global step.

    Any code can call ``SummaryWriterContext.add_scalar(...)`` without
    plumbing a writer through; it does nothing when no writer is pushed.
    """

    _writer_stacks: List[Any] = []
    _global_step: int = 0

    @classmethod
    def _current_writer(cls):
        return cls._writer_stacks[-1] if cls._writer_stacks else None

    @classmethod
    def increase_global_step(cls) -> None:
        cls._global_step += 1

    @classmethod
    def add_scalar(cls, key: str, value: Any, walltime: Optional[float] = None) -> None:
        writer = cls._current_writer()
        if writer is None:
            return
        writer.add_scalar(key, np.asarray(value).item(), global_step=cls._global_step)

    @classmethod
    def add_histogram(cls, key: str, value: Any) -> None:
        writer = cls._current_writer()
        if writer is None:
            return
        writer.add_histogram(key, np.asarray(value), global_step=cls._global_step)

    @classmethod
    def push(cls, writer) -> None:
        cls._writer_stacks.append(writer)

    @classmethod
    def pop(cls):
        return cls._writer_stacks.pop()

    @classmethod
    def reset(cls) -> None:
        cls._writer_stacks = []
        cls._global_step = 0


class summary_writer_context:
    """``with summary_writer_context(writer): ...`` (reference tensorboardX.py:126)."""

    def __init__(self, writer):
        self._writer = writer

    def __enter__(self):
        SummaryWriterContext.push(self._writer)
        return self._writer

    def __exit__(self, *args):
        SummaryWriterContext.pop()
        return False
