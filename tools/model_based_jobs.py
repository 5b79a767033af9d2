#!/usr/bin/env python3
"""Run the model-based slice's jobs at full depth on one NVIDIA card
(``reagent_tpu_torch/gym/model_based.py``):

- CEM on LinDyna with one and with two world models
  (tests/test_world_models.py:225-287; reference
  cem_single_world_model_linear_dynamics_offline.yaml and
  cem_many_world_models_linear_dynamics_offline.yaml): 512 random rollouts,
  an MDN-RNN of 100 hidden units in 2 layers with 1 gaussian, Adam 1e-3, 400
  steps a member; 10 iterations of population 100, 15 elites, horizon 4; 5
  episodes, bar -2.5;
- CEM on CartPole (tests/test_world_models.py:290-404; reference
  cem_cartpole_offline.yaml): 200,000 random one-step transitions,
  ``predict_delta``, 1,000 MDN-RNN steps at B 1,024, not-terminal weight
  200; horizon 10, population 100, the expected next state and survival; 3
  episodes of up to 200 steps, bar 100;
- Seq2Reward and its compress model at the ``Seq2RewardModel`` manager's
  width (64 hidden x 2, step classifier 64, multi_steps 6, B 1,024) on
  windows of that CartPole corpus, 1,000 and 500 steps, then 10 greedy
  episodes of the compress model through K3 and of the planner; no bar.

    python3 tools/model_based_jobs.py                     # all four, on the card
    python3 tools/model_based_jobs.py cartpole seq2reward # some of them, by name
    python3 tools/model_based_jobs.py --cpu               # the CEM jobs also on the CPU
    python3 tools/model_based_jobs.py --phases            # chip_smoke.py's phases 50-52 first

``--cpu`` runs each CEM job on the CPU too, with the same seeds, so that a
bar missed on the card can be read beside the CPU's score (the Seq2Reward
job's compress steps take about 0.7 s each on a CPU, so it runs on the card
only).  It prints the card's name and power limit, each run's numbers and
one JSON line of them with each bar met or missed.  It holds no bar (a bar
depends on the seeds and the draws); it exits non-zero if a run fails or if
K3 did not launch once a greedy step of the compress model on the card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

JOBS = ("lindyna-1", "lindyna-2", "cartpole", "seq2reward")


def run(name, device, corpora):
    from reagent_tpu_torch.gym import model_based as mb

    if name.startswith("lindyna"):
        return mb.cem_lindyna(int(name[-1]), device)
    if name == "cartpole":
        r = mb.cem_cartpole(device, corpus=corpora.get(device))
        corpora[device] = r["corpus"]
        return r
    return mb.seq2reward_cartpole(device, corpus=corpora.get(device))


def summary(result, seconds):
    return dict({k: v for k, v in result.items() if isinstance(v, (int, float, list, tuple))},
                seconds=seconds)


def main(argv) -> int:
    import torch

    cpu = "--cpu" in argv
    names = [a for a in argv if not a.startswith("--")] or list(JOBS)
    unknown = set(names) - set(JOBS)
    if unknown:
        print(f"unknown jobs {sorted(unknown)}; the jobs are {list(JOBS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("model_based_jobs: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reagent_tpu_torch.ops import _build

    card = cs.card_line()
    cs.log(card)
    _build.build_all()
    results = {}
    if "--phases" in argv:
        cs.phase("chip_smoke.py phase 50")
        results["phase 50"] = cs.model_based_card_cpu_phase(torch)
        cs.phase("chip_smoke.py phase 51")
        launch_floor_ms = cs.time_ms(torch, lambda: torch.cuda._sleep(0))
        timed = cs.model_based_timed_phase(torch, torch.cuda.get_device_name(0), launch_floor_ms)
        cs.phase("chip_smoke.py phase 52")
        results["phase 52"] = cs.model_based_jobs_phase(torch, timed.pop("corpus"))
        results["phase 51"] = timed
    corpora = {}
    for name in names:
        for device in ([cs.DEVICE, "cpu"] if cpu and name != "seq2reward" else [cs.DEVICE]):
            cs.phase(f"{name} on {device}")
            cs.reset_counts()
            t0 = time.perf_counter()
            r = run(name, device, corpora)
            if device != "cpu":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches, plain = cs.read_counts()
            out = summary(r, seconds)
            if name == "seq2reward":
                want = 201  # 200 greedy steps of the compress model, the step model once
                if launches["fused_mlp_forward"] != want or plain:
                    raise AssertionError(f"seq2reward: launches {launches}, plain {plain}")
                out["k3_launches"] = want
                cs.log(f"  {out}")
            else:
                out["bar_met"] = r["mean_return"] >= r["bar"]
                cs.log(f"  mean return {r['mean_return']:.4f} (bar {r['bar']}: "
                       f"{'met' if out['bar_met'] else 'missed'}), returns {r['returns']}, "
                       f"{seconds:.1f} s, MDN-RNN losses {r['wm_losses']}, "
                       f"{r['wm_steps_per_s']:.1f} MDN-RNN steps/s, {r['plan_ms']:.2f} ms a plan")
            results[f"{name} ({'card' if device != 'cpu' else 'CPU'})"] = out
    cs.log(card)
    print(json.dumps({"card": card, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
