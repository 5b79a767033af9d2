#!/usr/bin/env python3
"""Run the ranking slice's jobs at full depth on one NVIDIA card.

slate-Q on RecSim (tests/test_slateq_recsim.py:173-228; reference
gym/tests/configs/recsim/slate_q_recsim_online*.yaml, bar 154): 10
candidates, slate 3, a [64, 64] leaky_relu critic, Adam 1e-3; 4 rounds at
epsilon 1.0, 0.5, 0.2 and 0.1, each collecting 150 episodes and then taking
600 steps at minibatch 512; 20 greedy episodes; the five variants of
``reagent_tpu_torch/gym/slate_q_recsim.py::VARIANTS`` from the seed-0 init.
Each act step scores the candidates through ``slate_q_scorer``: one K3
launch.  A variant below the bar is run again at seeds 1-5.

Seq2Slate at bench.py's _S2S width (bench.py:499-535, :611-650): the IPS
step (on_policy False, IPSClamp(UNIVERSAL, 10), Adam 1e-4) at B 256 for 40
steps, the _S2S_LARGE bfloat16 step at B 1,024, greedy KV-cached ranking at
B 512 for 20 ranks: steps/s, slates/s, CUDA kernels a call, the idle share
and the peak memory (chip_smoke.seq2slate_timed_phase at the bench's depth).

    python3 tools/ranking_jobs.py                  # on the card
    python3 tools/ranking_jobs.py --cpu            # slate-Q also on the CPU
    python3 tools/ranking_jobs.py base maxq_topk   # these variants only
    python3 tools/ranking_jobs.py --no-seq2slate   # slate-Q only

It prints the card's name and power limit, each run's score beside the bar,
its seconds, act steps and K3 launches, and one JSON line of the numbers.  It
holds no bar (a bar depends on the seeds and the draws); it exits non-zero
if a run fails or K3 did not launch once an act step on the card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

RETRY_SEEDS = (1, 2, 3, 4, 5)


def slate_q_run(torch, sq, variant, device, seed):
    """One variant at full depth -> its summary; on the card, K3 must have
    launched exactly once an act step."""
    cs.reset_counts()
    t0 = time.perf_counter()
    r = sq.train_and_eval(*variant, device, seed=seed)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, _ = cs.read_counts()
    acts = r["train_act_steps"] + r["eval_act_steps"]
    if device != "cpu" and launches["fused_mlp_forward"] != acts:
        raise AssertionError(f"{variant[0]}: {acts} act steps, K3 launched "
                             f"{launches['fused_mlp_forward']}")
    out = {k: r[k] for k in ("mean_return", "bar", "train_act_steps", "eval_act_steps",
                             "transitions", "first_td", "last_td")}
    out.update(seed=seed, seconds=seconds, bar_met=r["mean_return"] >= r["bar"],
               k3_launches=launches["fused_mlp_forward"])
    cs.log(f"  {variant[0]} on the {'CPU' if device == 'cpu' else 'card'}, seed {seed}: mean "
           f"return {r['mean_return']:.2f} (bar {r['bar']:.0f}), {seconds:.1f} s, {acts} act "
           f"steps, K3 launches {launches['fused_mlp_forward']}")
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ranking_jobs: torch.cuda.is_available() is False; this script needs an NVIDIA "
              "card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reagent_tpu_torch.gym import slate_q_recsim as sq
    from reagent_tpu_torch.ops import _build

    card = cs.card_line()
    cs.log(card)
    _build.build_all()
    names = [a for a in argv if not a.startswith("--")]
    variants = [v for v in sq.VARIANTS if not names or v[0] in names]
    results = {"slate_q": {}, "seq2slate": None}
    for variant in variants:
        cs.phase(f"slate-Q {variant[0]}")
        runs = {"card": slate_q_run(torch, sq, variant, cs.DEVICE, 0)}
        if not runs["card"]["bar_met"]:
            runs["card, other seeds"] = [slate_q_run(torch, sq, variant, cs.DEVICE, s)
                                         for s in RETRY_SEEDS]
        if "--cpu" in argv:
            runs["CPU"] = slate_q_run(torch, sq, variant, "cpu", 0)
        results["slate_q"][variant[0]] = runs
    if "--no-seq2slate" not in argv:
        cs.phase("Seq2Slate at bench.py's _S2S width")
        cs.S2S_RUN.update(steps=40, ranks=20, profiled=5)
        results["seq2slate"] = cs.seq2slate_timed_phase(torch, torch.cuda.get_device_name(0))
    cs.log(card)
    print(json.dumps({"card": card, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
