"""Sequential trainer composition by epoch ranges.

Port of ``reagent_tpu/training/multi_stage_trainer.py`` (reference
reagent/training/multi_stage_trainer.py:18-120): stage i trains for the
epochs of its range, and ``train_step`` delegates to the active stage.  Plain
Python, as JAX's; it raises ``ValueError`` where JAX asserts.
"""

from __future__ import annotations

import bisect
import itertools
from typing import Any, List, Sequence, Tuple


class MultiStageTrainer:
    def __init__(self, trainers: Sequence[Any], epochs: Sequence[int]):
        """``epochs[i]`` = the number of epochs stage i runs (reference :30-55)."""
        if len(trainers) != len(epochs):
            raise ValueError(f"{len(trainers)} trainers for {len(epochs)} epoch counts")
        self.trainers = list(trainers)
        self.epochs = list(epochs)
        # cumulative epoch boundaries: stage i is active for epoch in [start_i, end_i)
        self._boundaries = list(itertools.accumulate(epochs))

    def stage_for_epoch(self, epoch: int) -> int:
        idx = bisect.bisect_right(self._boundaries, epoch)
        return min(idx, len(self.trainers) - 1)

    def init_all(self, *args, **kwargs) -> List[Any]:
        return [t.init(*args, **kwargs) for t in self.trainers]

    def train_step(self, states: List[Any], batch: Any, epoch: int) -> Tuple[List[Any], dict]:
        stage = self.stage_for_epoch(epoch)
        new_state, metrics = self.trainers[stage].train_step(states[stage], batch)
        states = list(states)
        states[stage] = new_state
        metrics = dict(metrics)
        metrics["active_stage"] = stage
        return states, metrics

    @property
    def total_epochs(self) -> int:
        return self._boundaries[-1]
