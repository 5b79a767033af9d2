#!/usr/bin/env python3
"""Run the world-model pipeline and the two jobs that share its envs at the
JAX tests' full width and depth on one NVIDIA card, and read each bar:

- the world-model string pipeline (tests/test_world_model_string_e2e.py;
  reference gym/tests/test_world_model.py): 512 random StringGame episodes
  of 6, 300 MDN-RNN steps, StateEmbedEnv, prefill 2,000, 6,000 DQN steps
  (minibatch 256) with up to two extensions of 3,000 while the greedy mean
  is under the bar, 20 greedy episodes, bar 10.0;
- OpenGridworld DQN (tests/test_gym_envs_extra.py:99): prefill 3,000,
  10,000 steps, 20 greedy episodes, bar 0.9;
- the possible-actions-mask DQN (tests/test_functionality_mask.py:23): 600
  steps of random legal actions, an update a step after the first 65, 10
  greedy masked episodes, bar 200.

    python3 tools/world_model_jobs.py                    # all three, on the card
    python3 tools/world_model_jobs.py gridworld mask     # some of them, by name
    python3 tools/world_model_jobs.py --cpu              # each also on the CPU

Each run is a phase of ``chip_smoke.py`` (``world_model_phase``,
``gridworld_phase``, ``mask_phase``) at the JAX tests' depth, from the
port's own seeds; each act step runs K3 and each replay sample K4 on the
card.  ``--cpu`` also runs each job on the CPU (the plain versions of K3
and K4) with the same seeds, so that a bar missed on the card can be read
beside the CPU's score.  It prints the card's name and power limit, each
run's rates, launches, kernels a step and idle share, and one JSON line of
the numbers with each bar met or missed.  It holds no bar (a bar depends on
the seeds and the draws); it exits non-zero if a run fails.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

JOBS = ("world-model", "gridworld", "mask")


def run(torch, name, device):
    wm, grid, mask = cs.WORLD_MODEL, cs.GRIDWORLD_JOB, cs.MASK_JOB
    if name == "world-model":
        return cs.world_model_phase(torch, wm["full_wm_steps"], wm["full_prefill"],
                                    wm["full_steps"], wm["full_eval_episodes"],
                                    extensions=wm["extensions"], device=device)
    if name == "gridworld":
        return cs.gridworld_phase(torch, grid["full_prefill"], grid["full_steps"],
                                  grid["full_eval_episodes"], device=device)
    return cs.mask_phase(torch, mask["full_steps"], mask["full_eval_episodes"], device=device)


def summary(result, seconds):
    keys = ("steps", "steps_per_s", "kernels_per_step", "device_us", "idle", "k3_us", "k4_us",
            "mean_reward", "bar", "extensions", "wm_steps", "wm_loss", "wm_s", "prefill_s",
            "first_td", "last_td")
    out = {k: result[k] for k in keys if k in result}
    out.update(seconds=seconds, bar_met=result["mean_reward"] >= result["bar"],
               k3_launches=result["launches"]["fused_mlp_forward"],
               k4_launches=result["launches"]["nstep_rewards"],
               k3_eval_launches=result["eval_launches"]["fused_mlp_forward"])
    return out


def main(argv) -> int:
    import torch

    cpu = "--cpu" in argv
    names = [a for a in argv if not a.startswith("--")] or list(JOBS)
    unknown = set(names) - set(JOBS)
    if unknown:
        print(f"unknown jobs {sorted(unknown)}; the jobs are {list(JOBS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("world_model_jobs: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reagent_tpu_torch.ops import _build

    card = cs.card_line()
    cs.log(card)
    _build.build_all()
    results = {}
    for name in names:
        for device in ([cs.DEVICE, "cpu"] if cpu else [cs.DEVICE]):
            cs.phase(f"{name} on {device}")
            t0 = time.perf_counter()
            result = run(torch, name, device)
            if device != "cpu":
                torch.cuda.synchronize()
            results[f"{name} ({'card' if device != 'cpu' else 'CPU'})"] = summary(
                result, time.perf_counter() - t0)
    cs.log(card)
    print(json.dumps({"card": card, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
