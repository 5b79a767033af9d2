#!/usr/bin/env python3
"""Run the reference CI's three online Pendulum jobs at full width and full
depth on one NVIDIA card and read each reward bar
(tests/test_gym_all_algos.py:150-258):

- SAC: gaussian actor 64, 64 relu, twin critics, Adam 3e-3, tau 0.005,
  alpha 0.2 (tuned), prefill 1,000, 12,000 steps, bar -500;
- TD3: the same widths, exploration variance 0.2, 12,000 steps, bar -750;
- continuous CRR: SAC with CRRWeightFn(1.0, 20.0), a value net and one
  critic, leaky_relu, alpha 0.3, prefill 10,000, 8,000 steps, bar -500.

Each job runs through ``run_online_training`` with
``make_policy_network_batch`` and the act step whose dense trunk is one K3
launch (minibatch 256, 10 greedy episodes), once on the ``ReplayBuffer`` as
the reference does and once on the ``PrioritizedReplayBuffer`` at uniform
priorities.

    python3 tools/continuous_control_jobs.py              # all three, both buffers
    python3 tools/continuous_control_jobs.py TD3          # some of them, by name
    python3 tools/continuous_control_jobs.py --deterministic   # raise at any op
                                                  # without a deterministic CUDA path

Each run is ``chip_smoke.continuous_online_phase`` at the reference's depth
from the port's own seed-0 init.  It prints the
card's name and power limit, each run's env steps/s, the device's idle
share of a step, the µs of K3 and K4 in a step, the mean reward against the
bar, and one JSON line of the numbers with each bar met or missed.  It holds
no bar (a bar depends on the init and the draws); it exits non-zero if a run
fails.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("continuous_control_jobs: needs an NVIDIA card", file=sys.stderr)
        return 2
    if "--deterministic" in argv:
        # cuBLAS needs a fixed workspace for repeatable sums; torch then
        # raises at the first op that has no deterministic CUDA path
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    argv = [a for a in argv if not a.startswith("--")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reagent_tpu_torch.ops import _build

    _build.build_all()
    cs.log(cs.card_line())
    names = [n for n in cs.CONTINUOUS_JOBS if not argv or any(a in n for a in argv)]
    results = {}
    for name in names:
        cfg = cs.CONTINUOUS_JOBS[name]
        for prioritized in (False, True):
            label = f"{name}{' (prioritized replay)' if prioritized else ''}"
            cs.phase(f"{label} at full depth")
            t0 = time.perf_counter()
            r = cs.continuous_online_phase(torch, name, cfg["full_steps"], cfg["full_prefill"],
                                           prioritized=prioritized)
            r["launches"] = {k: v for k, v in r["launches"].items() if v}
            r["eval_launches"] = {k: v for k, v in r["eval_launches"].items() if v}
            r["bar_met"] = r["mean_reward"] >= r["bar"]
            r["seconds"] = time.perf_counter() - t0
            results[label] = r
    cs.log(json.dumps({"runs": results, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
