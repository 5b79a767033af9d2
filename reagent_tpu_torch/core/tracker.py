"""Metrics bus: observers, aggregators and the ambient summary writer.

Port of ``reagent_tpu/core/tracker.py`` (reference: reagent/core/tracker.py,
reagent/core/aggregators.py, reagent/core/tensorboardX.py:64-126).  A train
step returns a ``{name: tensor}`` metrics dict whose tensors may live on the
card; ``values_to_host`` brings every tensor of one such dict to the host in
a single copy, and an ``Aggregator`` brings a value it is given to the host
once, in ``update``, so that its ``flush`` only reads numpy arrays.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch


def to_numpy(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def values_to_host(values: Mapping[str, Any]) -> Dict[str, Any]:
    """``values`` with every tensor replaced by a numpy array of its shape
    and dtype (bfloat16 as float32), and other values (``None``, floats,
    objects) left as they are.  The tensors of one device go over as one
    byte buffer: each is viewed as bytes, the views are concatenated on the
    device and copied once, and the host splits the copy again; so a step's
    metrics cost one device-to-host copy however many there are."""
    out = dict(values)
    by_device: Dict[torch.device, List[tuple]] = defaultdict(list)
    for key, value in values.items():
        if isinstance(value, torch.Tensor):
            value = value.detach()
            by_device[value.device].append(
                (key, value.float() if value.dtype == torch.bfloat16 else value))
    for pairs in by_device.values():
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for _, t in pairs]).cpu().numpy()
        offset = 0
        for key, t in pairs:
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            out[key] = np.frombuffer(flat, dtype, t.numel(), offset).reshape(tuple(t.shape))
            offset += t.numel() * t.element_size()
    return out


class Observer:
    """Receives values published under a set of keys (reference tracker.py:16)."""

    def __init__(self, observing_keys: Sequence[str]):
        self.observing_keys = list(observing_keys)

    def update(self, key: str, value: Any) -> None:
        raise NotImplementedError


class ValueListObserver(Observer):
    """Stores every observed value as it came (reference: core/observers.py:117)."""

    def __init__(self, observing_key: str):
        super().__init__([observing_key])
        self.values: List[Any] = []

    def update(self, key: str, value: Any) -> None:
        self.values.append(value)

    def reset(self) -> None:
        self.values = []


class Aggregator:
    """Accumulates values for one key, flushes an aggregate (reference
    aggregators.py:19); each value is on the host from ``update`` on."""

    def __init__(self, key: str):
        self.key = key
        self.values: List[Any] = []

    def update(self, key: str, value: Any) -> None:
        self.values.append(to_numpy(value))

    def __call__(self, key: str, values: List[Any]) -> None:
        """Fold a buffered list of values (reference aggregators.py:19-24)."""
        assert key == self.key, f"{key} != {self.key}"
        for v in values:
            self.values.append(to_numpy(v))

    def flush(self) -> Optional[float]:
        if not self.values:
            return None
        out = self.aggregate(self.values)
        self.values = []
        return out

    def aggregate(self, values: List[np.ndarray]) -> float:
        raise NotImplementedError


class MeanAggregator(Aggregator):
    def aggregate(self, values: List[np.ndarray]) -> float:
        return float(np.mean([np.mean(v) for v in values]))


class LastValueAggregator(Aggregator):
    def aggregate(self, values: List[np.ndarray]) -> float:
        return float(np.mean(values[-1]))


class EpochMeanAggregator(MeanAggregator):
    pass


class ObservableMixin:
    """Anything that can notify observers of published values."""

    def __init__(self) -> None:
        self._observers: Dict[str, List[Observer]] = defaultdict(list)

    def add_observer(self, observer: Observer) -> "ObservableMixin":
        for key in observer.observing_keys:
            if observer not in self._observers[key]:
                self._observers[key].append(observer)
        return self

    def add_observers(self, observers: Sequence[Observer]) -> "ObservableMixin":
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
        writer.add_scalar(key, to_numpy(value).item(), global_step=cls._global_step)

    @classmethod
    def add_histogram(cls, key: str, value: Any) -> None:
        writer = cls._current_writer()
        if writer is None:
            return
        writer.add_histogram(key, to_numpy(value), global_step=cls._global_step)

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
