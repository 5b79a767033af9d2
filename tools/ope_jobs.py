#!/usr/bin/env python3
"""Run the off-policy-estimation slice's jobs at full depth on one NVIDIA
card (the job functions are ``chip_smoke.py``'s):

- ``cartpole``: the CartPole harness (reagent_tpu/ope/test/cartpole.py) on
  the flagship sample config's net (4 -> 128 -> 64 -> 2 leaky_relu, the
  port's seed-0 init) at 200 episodes of 100 steps and the JAX test's
  temperatures (1.5, 0.5), rollout draws from seeds 0-4; IPS, DR and MAGIC
  beside the target policy's simulated value, and the JAX test's bar, IPS
  within half of it (tests/test_ope_benchmarks.py:63-83);
- ``dualdice``: NeuralDualDICE on the JAX test's gridworld logs (3 x 3, 300
  episodes of at most 12 steps) for its default 2,000 steps and the JAX
  test's 800 (B 256, hidden 64), init and indices from seeds 0-4; the bar
  |estimate - gt| <= max(1, 0.8 |gt|) (tests/test_ope.py:99-111) and the
  seeds that meet it at each depth;
- ``slate``: the slate benchmark with NNTrainer (500 x 2, 100 iterations, B
  1,024) as the target ranker on QueryCorpus.synthetic() (200 queries of 20
  docs) and on tests/data/mslr_sample.txt; IPS, PBM and the pseudo-inverse
  beside the closed-form ground truth; no bar.

    python3 tools/ope_jobs.py                   # all three, on the card
    python3 tools/ope_jobs.py dualdice          # some of them, by name
    python3 tools/ope_jobs.py --cpu             # each also on the CPU
    python3 tools/ope_jobs.py --phases          # chip_smoke.py's phases 56-58 first

Every job draws its inputs on the CPU from its seed and moves them to the
device, so ``--cpu`` runs the same inputs.  The sklearn trainers and the
multiclass harness are not among the jobs: the machine with the card has
neither sklearn nor pandas, and both run on the CPU only (tests/
test_torch_ope.py).  The script prints the card's name and power limit,
each run's numbers and one JSON line of them with each bar met or missed.
It holds no bar; it exits non-zero if a run fails or if K3 did not launch
as often as each job's forwards on the card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

JOBS = ("cartpole", "dualdice", "slate")
CARTPOLE_SEEDS = range(5)
DICE_SEEDS = range(5)


def run(torch, name, device):
    """(the job's numbers, the K3 launches it makes on the card)."""
    if name == "cartpole":
        runs = [cs.cartpole_ope_job(torch, device, seed=seed) for seed in CARTPOLE_SEEDS]
        return (dict(seed_0=runs[0], ips_bar_met_on_seeds=[
            s for s, r in zip(CARTPOLE_SEEDS, runs) if r["ips_bar_met"]],
            ips_over_gt=[r["ips"] / r["gt"] for r in runs]),
            len(runs) * (2 * cs.OPE_CARTPOLE["horizon"] + 1))
    if name == "dualdice":
        out = {}
        for steps in (cs.OPE_DICE["steps"], cs.OPE_DICE["test_steps"]):
            runs = [cs.dualdice_job(torch, device, steps, seed) for seed in DICE_SEEDS]
            out[f"{steps} steps"] = dict(
                estimates=[r["estimate"] for r in runs], gt=runs[0]["gt"],
                bar_met_on_seeds=[s for s, r in zip(DICE_SEEDS, runs) if r["bar_met"]],
                steps_per_s=[r["steps_per_s"] for r in runs])
        return out, 2 * len(DICE_SEEDS)
    return {corpus: cs.slate_job(torch, device, corpus) for corpus in ("synthetic", "mslr")}, 2


def main(argv) -> int:
    import torch

    cpu = "--cpu" in argv
    names = [a for a in argv if not a.startswith("--")] or list(JOBS)
    unknown = set(names) - set(JOBS)
    if unknown:
        print(f"unknown jobs {sorted(unknown)}; the jobs are {list(JOBS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ope_jobs: torch.cuda.is_available() is False; this script needs an NVIDIA card",
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
        cs.phase("chip_smoke.py phase 56")
        results["phase 56"] = cs.ope_card_cpu_phase(torch)
        cs.phase("chip_smoke.py phase 57")
        launch_floor_ms = cs.time_ms(torch, lambda: torch.cuda._sleep(0))
        results["phase 57"] = cs.ope_timed_phase(torch, torch.cuda.get_device_name(0),
                                                 launch_floor_ms)
        cs.phase("chip_smoke.py phase 58")
        results["phase 58"] = cs.ope_jobs_phase(torch)
    for name in names:
        for device in [cs.DEVICE, "cpu"] if cpu else [cs.DEVICE]:
            cs.phase(f"{name} on {device}")
            cs.reset_counts()
            t0 = time.perf_counter()
            out, want = run(torch, name, device)
            if device != "cpu":
                torch.cuda.synchronize()
            out["seconds"] = time.perf_counter() - t0
            launches, plain = cs.read_counts()
            want = want if device != "cpu" else 0
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
