"""OPE utility types.

Port of ``reagent_tpu/ope/utils.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/utils.py — ``convert_to_one_hots``, ``LRUCache``,
``RunningAverage`` (incremental mean skipping nan/inf), ``Clamper``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence, Union

import numpy as np

DEFAULT_MIN = float("-inf")
DEFAULT_MAX = float("inf")


def convert_to_one_hots(a, num_classes: int, dtype=np.int32) -> np.ndarray:
    """Row indices -> one-hot matrix (reference ope/utils.py:18-33)."""
    a = np.asarray(a).reshape(-1).astype(np.int64)
    out = np.zeros((len(a), num_classes), dtype=dtype)
    out[np.arange(len(a)), a] = 1
    return out


class LRUCache(OrderedDict):
    """Bounded LRU dict (reference :36-49)."""

    def __init__(self, maxsize: int = 2**10, *args, **kwds):
        self.maxsize = maxsize
        super().__init__(*args, **kwds)

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.move_to_end(key)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if len(self) > self.maxsize:
            del self[next(iter(self))]


class RunningAverage:
    """Incremental mean that ignores nan/inf samples (reference :52-78)."""

    def __init__(self, init_val: float = float("nan")):
        self._average = init_val
        self._count = 0 if math.isnan(init_val) else 1

    def add(self, value) -> "RunningAverage":
        v = float(value)
        if not math.isnan(v) and not math.isinf(v):
            if self._count == 0:
                self._average = 0.0
            self._count += 1
            self._average = self._average + (v - self._average) / self._count
        return self

    @property
    def average(self) -> float:
        return self._average

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._average * self._count

    def __float__(self) -> float:
        return self._average


class Clamper:
    """Range clamp over scalars / sequences / arrays and tensors (reference
    :81-105): a numpy array or a torch tensor is clipped as itself, on its
    own device."""

    def __init__(self, min_v: float = DEFAULT_MIN, max_v: float = DEFAULT_MAX):
        if min_v >= max_v:
            raise ValueError(f"min[{min_v}] greater than max[{max_v}]")
        self._min, self._max = min_v, max_v

    def __call__(self, v: Union[float, Sequence[float], np.ndarray]):
        if hasattr(v, "clip"):  # a numpy array or a torch tensor
            return v.clip(self._min, self._max)
        if isinstance(v, Sequence):
            return [max(self._min, min(self._max, float(i))) for i in v]
        return max(self._min, min(self._max, float(v)))

    def __repr__(self):
        return f"Clamper({self._min},{self._max})"
