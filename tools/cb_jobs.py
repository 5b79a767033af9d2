#!/usr/bin/env python3
"""Run the bandit slice's jobs at full depth on one NVIDIA card (the job
functions are ``chip_smoke.py``'s):

- ``dynamic-linucb``: ``run_dynamic_bandit_env`` at ``DynamicBanditEnv``'s
  defaults (100 unique batches, batch 4, 10 arms an episode, 500 features;
  the reference's sizes) for 300 steps from seed 937162211; the bar of
  tests/test_cb_evaluation.py:93-103, second-half per-step regret under half
  the first; steps/s, and a step's time split into score, update and the
  coefficients' pinv;
- ``replay-eval``: that env's LinUCB agent trained 300 steps, then judged by
  the ``PolicyEvaluator`` on 300 batches logged under a uniform policy
  (log_prob log(1/10)), beside its on-policy mean reward on 100 fresh
  batches; no bar;
- ``deep-represent``: the JAX test's job (tests/test_cb_evaluation.py:106-150:
  D 6, K 4, B 32, trunk [16, 4] relu, lr 3e-3, 300 steps) on seeds 0-9, the
  greedy scores through K3; its bars, the last loss under half the first and
  greedy picks over 1.15x the mean reward, per seed;
- ``mab``: the JAX tests' bandits (tests/test_cb_mab.py:108-121: UCB1 on [0.2,
  0.8, 0.5] for 400 steps; MetricUCB, UCBTuned and BernoulliBetaThompson on
  [0.1, 0.9] for 300) with their bars, then ``compare_bandit_algos`` over the
  seven algorithms, 5 trials.

    python3 tools/cb_jobs.py                       # all four, on the card
    python3 tools/cb_jobs.py mab deep-represent    # some of them, by name
    python3 tools/cb_jobs.py --cpu                 # each also on the CPU
    python3 tools/cb_jobs.py --phases              # chip_smoke.py's phases 53-55 first

Every job draws its inputs on the CPU from its seed and moves them to the
device, so ``--cpu`` runs the same inputs (the Thompson posterior's draws
come from the device's generator).  It prints the card's name and power
limit, each run's numbers and one JSON line of them with each bar met or
missed.  It holds no bar; it exits non-zero if a run fails or if K3 did not
launch once a greedy score on the card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

JOBS = ("dynamic-linucb", "replay-eval", "deep-represent", "mab")
DEEP_SEEDS = range(10)


def run(torch, name, device):
    if name == "dynamic-linucb":
        out = cs.dynamic_linucb_job(torch, device, cs.CB_DYNAMIC["steps"])
        out["step_ms"] = cs.linucb_step_ms(torch, device)
        return out
    if name == "replay-eval":
        return cs.replay_eval_job(torch, device, cs.CB_DYNAMIC["steps"],
                                  cs.CB_REPLAY["log_batches"], cs.CB_REPLAY["fresh_batches"])
    if name == "deep-represent":
        runs = [cs.deep_represent_job(torch, device, cs.CB_DEEP["steps"], seed)
                for seed in DEEP_SEEDS]
        return dict(seed_0=runs[0], bars_met_on_seeds=[r["seed"] for r in runs if r["bars_met"]],
                    loss_ratios=[r["loss_ratio"] for r in runs],
                    greedy_ratios=[r["greedy_ratio"] for r in runs])
    return cs.mab_job(torch, device)


def main(argv) -> int:
    import torch

    cpu = "--cpu" in argv
    names = [a for a in argv if not a.startswith("--")] or list(JOBS)
    unknown = set(names) - set(JOBS)
    if unknown:
        print(f"unknown jobs {sorted(unknown)}; the jobs are {list(JOBS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("cb_jobs: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reagent_tpu_torch.ops import _build

    card = cs.card_line()
    cs.log(card)
    _build.build_all()
    results = {}
    if "--phases" in argv:
        cs.phase("chip_smoke.py phase 53")
        results["phase 53"] = cs.bandit_card_cpu_phase(torch)
        cs.phase("chip_smoke.py phase 54")
        launch_floor_ms = cs.time_ms(torch, lambda: torch.cuda._sleep(0))
        results["phase 54"] = cs.bandit_timed_phase(torch, torch.cuda.get_device_name(0),
                                                    launch_floor_ms)
        cs.phase("chip_smoke.py phase 55")
        results["phase 55"] = cs.bandit_jobs_phase(torch)
    for name in names:
        for device in [cs.DEVICE, "cpu"] if cpu else [cs.DEVICE]:
            cs.phase(f"{name} on {device}")
            cs.reset_counts()
            t0 = time.perf_counter()
            out = run(torch, name, device)
            if device != "cpu":
                torch.cuda.synchronize()
            out["seconds"] = time.perf_counter() - t0
            launches, plain = cs.read_counts()
            want = len(DEEP_SEEDS) if name == "deep-represent" and device != "cpu" else 0
            others = {k: v for k, v in launches.items() if k != "fused_mlp_forward" and v}
            if launches["fused_mlp_forward"] != want or others or (plain and device != "cpu"):
                raise AssertionError(f"{name} on {device}: launches {launches}, plain {plain}")
            out["k3_launches"] = want
            cs.log(f"  {json.dumps(out)}")
            results[f"{name} ({'card' if device != 'cpu' else 'CPU'})"] = out
    cs.log(card)
    print(json.dumps({"card": card, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
