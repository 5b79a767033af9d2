"""Streaming statistics (Welford) + recent-window report helpers.

Port of ``reagent_tpu/core/running_stats.py`` (reference:
reagent/core/running_stats.py:9-66 and core/report_utils.py:16-35): host
code on Python floats and numpy, the same as the JAX package's.
"""

from __future__ import annotations

import math
from math import ceil
from typing import Dict, List

import numpy as np


class RunningStats:
    """Welford running mean/std over a stream (ref running_stats.py:9-66)."""

    def __init__(self, lst=None) -> None:
        self.k = 0
        self.running_mean = 0.0
        self.sum_squares = 0.0
        self(lst)

    def update(self, x) -> None:
        if x is None:
            return
        self.k += 1
        new_m = self.running_mean + (x - self.running_mean) / self.k
        self.sum_squares += (x - self.running_mean) * (x - new_m)
        self.running_mean = new_m

    def consume(self, lst) -> None:
        for x in lst:
            self.update(x)

    def __call__(self, x) -> None:
        if x is None:
            return
        if hasattr(x, "__iter__"):
            self.consume(x)
        else:
            self.update(x)

    @property
    def mean(self) -> float:
        return self.running_mean

    @property
    def std(self) -> float:
        if self.k <= 1:
            return 0.0
        return math.sqrt(self.sum_squares / (self.k - 1))

    @property
    def meanfull(self):
        return self.mean, self.std / math.sqrt(max(self.k, 1))

    def __repr__(self) -> str:
        return f"<Welford: {self.mean} +- {self.std}>"


def get_mean_of_recent_values(
    values: Dict[str, List[float]], min_window_size: int = 10
) -> Dict[str, float]:
    """Mean of the trailing max(10%, min_window) values (ref report_utils.py:16)."""
    return {
        key: float(np.mean(vals[-max(min_window_size, int(ceil(0.1 * len(vals)))):]))
        for key, vals in values.items()
    }


def calculate_recent_window_average(arr, window_size: int, num_entries: int):
    """Reference report_utils.py:26-35."""
    if len(arr) > 0:
        begin = max(0, len(arr) - window_size)
        return np.mean(np.array(arr[begin:]), axis=0)
    return float("nan") if num_entries == 1 else [float("nan")] * num_entries
