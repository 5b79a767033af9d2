"""Faults planted under the timed path, to show that the comparison catches
them.  Used by ``calibrate.py`` and the tests; a run of ``run.py`` never
plants one.

In the train step (the trainer's ``train_step`` replaced while the context
lasts):

- ``state_unchanged``: the step computes its metrics but returns the state it
  was given;
- ``half_batch``: the step sees only the first half of its minibatch, so the
  means are taken over the rest.

In the loop (the kind's ``loop``, the window's entry, wrapped):

- ``call_returns_input``: a call runs its steps but returns the state it was
  given;
- ``steps_not_chained``: every step of a call starts from the state the call
  was given, not from the step before it.
"""

from __future__ import annotations

import copy
import importlib
from contextlib import contextmanager
from typing import Iterator

from portbench import harness

TRAINERS = {
    "fused_dqn": ("reagent_tpu_torch.training.fused_dqn_trainer", "FusedDQNTrainer"),
    "qrdqn": ("reagent_tpu_torch.training.qrdqn_trainer", "QRDQNTrainer"),
}


def state_unchanged(train_step, _call):
    def step(self, state, batch):
        _, metrics = train_step(self, copy.deepcopy(state), batch)
        return state, metrics
    return step


def half_batch(train_step, _call):
    from reagent_tpu_torch.training.scan_loop import tree_map

    def step(self, state, batch):
        half = batch.state.float_features.shape[0] // 2
        sized = getattr(self, "minibatch_size", None)  # the fused trainer checks it
        if sized is not None:
            self.minibatch_size = half
        try:
            return train_step(self, state, tree_map(lambda x: x[:half], batch))
        finally:
            if sized is not None:
                self.minibatch_size = sized
    return step


def steps_not_chained(train_step, call):
    def step(self, state, batch):
        return train_step(self, copy.deepcopy(call["given"]), batch)
    return step


def call_returns_input(loop, _call):
    def make(program, num_steps):
        entry = loop(program, num_steps)

        def broken(state, generator):
            _, metrics = entry(copy.deepcopy(state), generator)
            return state, metrics
        return broken
    return make


def remembers_input(loop, call):
    """The loop as it is, noting each call's given state for the step."""
    def make(program, num_steps):
        entry = loop(program, num_steps)

        def noted(state, generator):
            call["given"] = copy.deepcopy(state)
            return entry(state, generator)
        return noted
    return make


STEP_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
               "steps_not_chained": steps_not_chained}
LOOP_FAULTS = {"call_returns_input": call_returns_input, "steps_not_chained": remembers_input}
FAULTS = sorted(set(STEP_FAULTS) | set(LOOP_FAULTS))


@contextmanager
def planted(cfg: dict, fault: str) -> Iterator[None]:
    """``fault`` under the timed path of the configuration ``cfg``: in the
    train step of the trainer that its ``adapter`` drives, in the loop of its
    ``kind``, or both.  Entries built inside the context take it."""
    call: dict = {}
    undo = []
    if fault in STEP_FAULTS:
        module, name = TRAINERS[cfg["adapter"]]
        cls = getattr(importlib.import_module(module), name)
        undo.append((cls, "train_step", cls.train_step))
        cls.train_step = STEP_FAULTS[fault](cls.train_step, call)
    if fault in LOOP_FAULTS:
        kind = harness.loader(harness.ROOT)("kinds", cfg["kind"])
        undo.append((kind, "loop", kind.loop))
        kind.loop = LOOP_FAULTS[fault](kind.loop, call)
    try:
        yield
    finally:
        for owner, name, original in reversed(undo):
            setattr(owner, name, original)
