#!/usr/bin/env python3
"""Run the four discrete-actor configurations of the reference's CI at full
depth on one NVIDIA card and read each reward bar:

- CRR offline (tests/test_offline_managers.py::test_crr_offline_e2e): 20
  epochs on 10,000 random CartPole transitions, 20 greedy episodes of the
  actor artifact through load_predictor, bar 100;
- CRR online (tests/test_gym_all_algos.py::test_discrete_crr_cartpole):
  15,000 steps of the generic loop, 20 greedy episodes of the actor, bar 100;
- REINFORCE (tests/test_policy_gradient_trainers.py::
  test_reinforce_cartpole_e2e): 300 episodes, 20 greedy episodes, bar 180;
- PPO (test_ppo_cartpole_e2e): 700 episodes, 20 greedy episodes, bar 180.

    python3 tools/discrete_actor_jobs.py            # all four
    python3 tools/discrete_actor_jobs.py PPO        # some of them, by name
    python3 tools/discrete_actor_jobs.py --reinforce-draws

``--reinforce-draws`` runs REINFORCE's 300 episodes from the port's seed-0
init under other draws instead: on the CPU and on the card from one tape
(the CPU generator's draws of ``tests/test_torch_policy_gradient.py::
test_policy_gradient_cartpole_bar``, seed 1, moved to the card), then on the
card from its own generator at seeds 1-5.  Each run prints its returns and
its greedy mean over 20 episodes on the CPU (the test's evaluation:
generator seed 2), and the tape runs the first episode where the card's
returns part from the CPU's.

Each run is a phase of ``chip_smoke.py`` (``crr_offline_job_phase``,
``crr_online_phase``, ``pg_run_phase``) at the reference's depth, from the
port's own seed-0 init.  It prints the card's name and power limit, each
run's rates, launches and idle share, and one JSON line of the numbers
with each bar met or missed.  It holds no bar (a bar depends on the init
seed); it exits non-zero if a run fails.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

RUNS = ("CRR offline", "CRR online", "REINFORCE", "PPO")
CARD_SEEDS = (1, 2, 3, 4, 5)


def reinforce_run(torch, device, gen_seed, tape):
    """REINFORCE's full run on ``device`` from the port's seed-0 init, its
    draws from a generator seeded ``gen_seed``: on the CPU and moved to
    ``device`` where ``tape``, else on ``device``.  Returns (training
    returns, greedy mean over 20 episodes on the CPU, seconds)."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.episodic import draw_episode_noise, make_episodic_trainer_step
    from reagent_tpu_torch.gym.online_loop import evaluate_policy
    from reagent_tpu_torch.gym.policies import discrete_q_scorer

    trainer = cs.pg_trainer(torch, "REINFORCE", device)
    state = trainer.init(torch.Generator().manual_seed(0))
    env, cpu_env = (CartPole(max_steps=cs.PG_MAX_STEPS, device=d) for d in (device, "cpu"))
    scorer = discrete_q_scorer(trainer.scorer)
    step = make_episodic_trainer_step(env, scorer, trainer.sampler, trainer, cs.PG_MAX_STEPS)
    gen = torch.Generator(device="cpu" if tape else device).manual_seed(gen_seed)
    t0 = time.perf_counter()
    returns = []
    for _ in range(cs.PG_CONFIGS["REINFORCE"]["full_episodes"]):
        if tape:
            noise = tuple(t.to(device) for t in draw_episode_noise(cpu_env, cs.PG_MAX_STEPS, gen))
            state, ret, _ = step(state, noise=noise)
        else:
            state, ret, _ = step(state, gen)
        returns.append(ret)
    returns = torch.stack(returns).cpu()
    seconds = time.perf_counter() - t0
    cpu_state = cs.copy_state(state, "cpu")

    def greedy(ts, obs, g):
        return torch.argmax(scorer(ts.policy_params, obs), dim=1).to(torch.int32)

    evals = evaluate_policy(cpu_env, greedy, cpu_state, torch.Generator().manual_seed(2), 20)
    return returns, float(evals.mean()), seconds


def reinforce_draws(torch) -> dict:
    """The runs of ``--reinforce-draws``."""
    runs = {}
    for label, device, seed, tape in (
            [("CPU, CPU tape", "cpu", 1, True), ("card, CPU tape", cs.DEVICE, 1, True)]
            + [(f"card, card generator seed {s}", cs.DEVICE, s, False) for s in CARD_SEEDS]):
        returns, mean, seconds = reinforce_run(torch, device, seed, tape)
        runs[label] = dict(mean_reward=mean, bar_met=mean >= cs.PG_CONFIGS["REINFORCE"]["bar"],
                           first_returns=returns[:20].tolist(),
                           last_returns=returns[-20:].tolist(), seconds=seconds,
                           returns=returns.tolist())
        cs.log(f"  REINFORCE, {label}: greedy mean {mean:.2f} (bar 180), training returns "
               f"first {returns[:10].tolist()} last {returns[-10:].tolist()}, {seconds:.1f} s")
    cpu, card = (runs[k]["returns"] for k in ("CPU, CPU tape", "card, CPU tape"))
    parted = next((i for i, (a, b) in enumerate(zip(cpu, card)) if a != b), None)
    runs["card, CPU tape"]["parts_from_cpu_at_episode"] = parted
    cs.log(f"  the card's run on the CPU tape parts from the CPU's at episode {parted} "
           f"(0-based; None: never)")
    for r in runs.values():
        del r["returns"]
    return runs


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("discrete_actor_jobs: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reagent_tpu_torch.ops import _build

    _build.build_all()
    cs.log(cs.card_line())
    if argv == ["--reinforce-draws"]:
        cs.phase("REINFORCE at full depth under other draws")
        cs.log(json.dumps({"reinforce_draws": reinforce_draws(torch), "card": cs.card_line()}))
        return 0
    names = [n for n in RUNS if not argv or any(a in n for a in argv)]
    results = {}
    for name in names:
        t0 = time.perf_counter()
        cs.phase(f"{name} at full depth")
        if name == "CRR offline":
            with tempfile.TemporaryDirectory() as tmp:
                r = cs.crr_offline_job_phase(torch, tmp, cs.CRR_OFFLINE["full_epochs"])
        elif name == "CRR online":
            r = cs.crr_online_phase(torch, cs.CRR_ONLINE["full_steps"])
            r["launches"] = {k: v for k, v in r["launches"].items() if v}
            r["eval_launches"] = {k: v for k, v in r["eval_launches"].items() if v}
        else:
            r = cs.pg_run_phase(torch, name, cs.PG_CONFIGS[name]["full_episodes"])
            r["launches"] = {k: v for k, v in r["launches"].items() if v}
            r["eval_launches"] = {k: v for k, v in r["eval_launches"].items() if v}
        r["bar_met"] = r["mean_reward"] >= r["bar"]
        r["seconds"] = time.perf_counter() - t0
        results[name] = r
    cs.log(json.dumps({"runs": results, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
