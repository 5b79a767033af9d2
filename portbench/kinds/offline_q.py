"""The kind ``offline_q``: a DQN-family trainer refreshed offline from a
table of logged transitions held on the device.

A configuration of this kind names its ``adapter`` (``adapters/<name>.py``,
the program's trainer) and its ``reference`` (``reference/<name>.py``).  A
traffic mix gives the table (``rows``, ``terminal_share``,
``impossible_action_share``; ``inputs.py``), the ``minibatch``, the
``steps_per_call`` and the ``profiled_calls`` of a traced run.

The window's entry is the program's loop for calls of ``steps_per_call``
steps, built once.  Its first call (``checked``) starts from the table and
weights made from the seed, each step's minibatch drawn by the program's
sampler from the seeded generator; the window's calls go on from the state
it returns, on the same generator.  The reference makes the table and
weights again from the seed, draws the same indices and follows that
call's steps.  The numbers compared:

- ``loss1``: the first step's loss, |program - reference| / |reference|;
- ``loss_call``: the mean of the call's per-step losses, likewise.  Not
  each step's: after the first step Adam turns the last bits of a gradient
  into steps of about lr, and a row whose double-Q choice is a near-tie
  then picks another next action on one side, which moves that one step's
  loss by about 1/B;
- ``moment``: Adam's first moment after the call;
- ``change``: the online weights' change over the call;
- ``target_change``: the target weights' change over the call.

The last three compare norms leaf by leaf: the gap between the program's
norm of a leaf and the reference's, over the larger of the reference's norm
of that leaf and of the median leaf, the worst leaf taken.  Leaves whose
reference gradient at the first step is under a thousandth of the median
leaf's move under Adam by round-off alone and are left out
(``check.moving_leaves``).
"""

from __future__ import annotations

import gc
from typing import Dict, Optional, Tuple

import torch

from portbench import check, inputs
from portbench.reference.common import leaves

Tensor = torch.Tensor
NUMBERS = ("loss1", "loss_call", "moment", "change", "target_change")


def loop(program, num_steps: int):
    """The program's own loop entry for calls of ``num_steps`` steps
    (``faults.py`` wraps this to break the loop underneath)."""
    return program.run_fn(num_steps)


class Run:
    def __init__(self, cell, seed: int, device, precision: str, load) -> None:
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = seed, device
        self.minibatch = int(self.traffic["minibatch"])
        self.steps_per_call = int(self.traffic["steps_per_call"])
        self.reference = load("reference", self.cfg["reference"])
        adapter = load("adapters", self.cfg["adapter"])
        self.program = adapter.Program(
            self.cfg, self.traffic, inputs.make_table(self.cfg, self.traffic, seed, device),
            inputs.make_weights(self.cfg, seed, device), device, precision)
        self.state = self.program.state
        self.generator = torch.Generator(device=device).manual_seed(
            inputs.sub_seed(seed, "sampler"))
        self.entry = loop(self.program, self.steps_per_call)
        self.record: Optional[dict] = None

    def call(self) -> Dict[str, Tensor]:
        self.state, metrics = self.entry(self.state, self.generator)
        return metrics

    def finish(self, metrics: Dict[str, Tensor]) -> Tuple[int, int, Dict[str, float]]:
        td = metrics["td_loss"].cpu()
        attempted = td.numel()
        failed = int((~torch.isfinite(td)).sum())
        done = attempted - failed
        return attempted, failed, {"steps": done, "samples": done * self.minibatch}

    def checked(self) -> Tuple[int, int, Dict[str, float]]:
        metrics = self.call()
        online, target = self.program.online_target(self.state)
        self.record = {"losses": [float(x) for x in metrics["td_loss"].cpu()],
                       "moment": self.program.first_moments(self.state),
                       "online": online, "target": target}
        return self.finish(metrics)

    def close(self) -> None:
        del self.program, self.state, self.entry, self.generator
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, details: Optional[dict] = None) -> Dict[str, float]:
        """The compared numbers of the checked call against the reference's,
        which makes its own table and weights again from the seed
        (``details``: see ``numbers``)."""
        cfg, traffic, seed, device = self.cfg, self.traffic, self.seed, self.device
        followed = self.reference.follow(
            cfg, inputs.make_table(cfg, traffic, seed, device),
            inputs.make_weights(cfg, seed, device), inputs.sub_seed(seed, "sampler"),
            self.minibatch, self.steps_per_call, device)
        initial = leaves(inputs.make_weights(cfg, seed, device))
        return numbers(self.record, followed, initial, details)


def numbers(program: dict, reference: dict, initial: Dict[str, Tensor],
            details: Optional[dict] = None) -> Dict[str, float]:
    """``program``: ``losses`` (a float a step), ``moment``, ``online`` and
    ``target`` (leaves after the call); ``reference``: the same, and
    ``grads1`` (the first step's gradient); ``initial``: the leaves both
    started from.  ``details``, where given, receives each step's loss gap,
    each leaf's gaps and the leaves left out."""
    moving = check.moving_leaves(reference["grads1"])

    def change(after: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return {k: after[k] - initial[k] for k in moving}

    by_leaf = {
        "moment": check.leaf_gaps(program["moment"], reference["moment"], moving),
        "change": check.leaf_gaps(change(program["online"]), change(reference["online"]),
                                  moving),
        "target_change": check.leaf_gaps(change(program["target"]),
                                         change(reference["target"]), moving),
    }
    p, r = program["losses"], reference["losses"]
    if details is not None:
        details.update(loss_by_step=[check.relative(a, b) for a, b in zip(p, r)],
                       still_leaves=sorted(set(reference["grads1"]) - set(moving)),
                       **{f"{k}_by_leaf": v for k, v in by_leaf.items()})
    return {"loss1": check.relative(p[0], r[0]),
            "loss_call": check.relative(sum(p) / len(p), sum(r) / len(r)),
            **{k: check.worst(v.values()) for k, v in by_leaf.items()}}
