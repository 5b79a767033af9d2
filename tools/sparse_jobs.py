#!/usr/bin/env python3
"""Run the sparse changing-arms DQN job at the JAX test's full width and depth
on one NVIDIA card and read its bar (tests/test_sparse_models.py:157;
reference gym/tests/configs/sparse/discrete_dqn_changing_arms_online.yaml):
ChangingArms(5 arms, 200 steps), the observation as dense [mus, changes] and
the ID list of the legal arms into a SparseDQN (("legal", 6, 8), overarch
[64] leaky_relu), gamma 0.5, target update rate 0.2, double-Q, Adam 0.003, a
ReplayBuffer of 50,000, minibatch 256, 2,000 masked-random prefill steps,
15,000 steps of masked softmax acting at temperature 2, 10 greedy masked
episodes, bar 400.

    python3 tools/sparse_jobs.py          # on the card
    python3 tools/sparse_jobs.py --cpu    # also on the CPU

The run is ``chip_smoke.sparse_arms_phase`` at the full depth: each act step
runs the bag concat in torch and the overarch as one K3 launch, each replay
sample one K4 launch.  ``--cpu`` also runs the job on the CPU (the plain
versions) from the same seeds.  It prints the
card's name and power limit, each run's env steps/s, launches, CUDA kernels
a step and idle share, and one JSON line of the numbers with the bar met or
missed.  It holds no bar (a bar depends on the seeds and the draws); it exits
non-zero if a run fails.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def summary(result, seconds):
    keys = ("steps", "steps_per_s", "kernels_per_step", "device_us", "idle", "k3_us", "k4_us",
            "mean_reward", "bar", "prefill_s", "first_td", "last_td")
    out = {k: result[k] for k in keys if k in result}
    out.update(seconds=seconds, bar_met=result["mean_reward"] >= result["bar"],
               k3_launches=result["launches"]["fused_mlp_forward"],
               k4_launches=result["launches"]["nstep_rewards"],
               k3_eval_launches=result["eval_launches"]["fused_mlp_forward"])
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sparse_jobs: torch.cuda.is_available() is False; this script needs an NVIDIA "
              "card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reagent_tpu_torch.ops import _build

    card = cs.card_line()
    cs.log(card)
    _build.build_all()
    cfg = cs.SPARSE_ARMS_JOB
    results = {}
    for device in [cs.DEVICE] + (["cpu"] if "--cpu" in argv else []):
        where = "card" if device != "cpu" else "CPU"
        cs.phase(f"sparse changing-arms DQN on the {where}")
        t0 = time.perf_counter()
        result = cs.sparse_arms_phase(torch, cfg["full_prefill"], cfg["full_steps"],
                                      cfg["full_eval_episodes"], device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        results[f"changing-arms ({where})"] = summary(result, time.perf_counter() - t0)
    cs.log(card)
    print(json.dumps({"card": card, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
