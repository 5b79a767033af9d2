#!/usr/bin/env python3
"""Run the C51 and parametric DQN/SARSA configurations of the reference's CI
at full depth on one NVIDIA card and read each reward bar:

- C51 online (tests/test_gym_all_algos.py::test_c51_cartpole): prefill 3,000,
  15,000 steps of the generic loop, 20 greedy episodes, bar 100;
- parametric DQN online (test_parametric_dqn_cartpole): prefill 10,000,
  20,000 steps, bar 100;
- parametric SARSA online (test_parametric_sarsa_cartpole): the same with
  SARSA targets, bar 100;
- C51 offline (tests/test_model_managers_all.py::test_c51_manager_offline_e2e)
  and parametric DQN offline (tests/test_offline_managers.py::
  test_parametric_dqn_offline_trains): 2 and 10 epochs, a finite td_loss.

    python3 tools/dqn_family_jobs.py                 # all five
    python3 tools/dqn_family_jobs.py SARSA           # some of them, by name
    python3 tools/dqn_family_jobs.py --cpu SARSA     # an online job on the CPU too

Each run is a phase of ``chip_smoke.py`` (``dqn_family_online_phase``,
``dqn_family_offline_phase``) at the reference's depth, from the port's own
seed-0 init.  ``--cpu`` also runs each online job named on the CPU from the
same init and generator seed (the plain versions of K3 and K4), so that a
bar missed on the card can be read beside the CPU's result.  It prints the
card's name and power limit, each run's rates, launches and idle share, and
one JSON line of the numbers with each bar met or missed.  It holds no bar
(a bar depends on the init seed and the draws); it exits non-zero if a run
fails.
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

RUNS = ("C51 online", "parametric DQN online", "parametric SARSA online", "C51 offline",
        "parametric DQN offline")


def cpu_online_run(torch, name):
    """The online job on the CPU from the card run's init and generator seed:
    (greedy mean over 20 episodes, seconds)."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import (
        make_discrete_dqn_batch,
        make_parametric_dqn_batch,
    )
    from reagent_tpu_torch.replay import ReplayBuffer

    cfg = cs.DQN_FAMILY_ONLINE[name]
    env = CartPole(max_steps=200, device="cpu")
    trainer, q_values = cs.dqn_family_trainer(torch, name, "cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=cs.DQN_FAMILY_CAPACITY, update_horizon=1,
                      gamma=cfg["gamma"], device="cpu")
    gen = torch.Generator().manual_seed(5)
    t0 = time.perf_counter()
    rb_state = prefill_replay_buffer(env, rb, rb.init(**cs.example_transition(torch)), gen,
                                     cfg["full_prefill"])
    sampler = SoftmaxActionSampler(temperature=1.0)
    make_batch = make_discrete_dqn_batch if name == "C51" else make_parametric_dqn_batch

    def policy_act(ts, obs, g):
        idx = torch.argmax(sampler.sample_action(q_values(ts, obs[None]), g).action[0])
        return idx.to(torch.int32), idx.to(torch.int32)

    state, _, _ = run_online_training(
        env, trainer, state, rb, rb_state, policy_act, lambda d: make_batch(d, 2), gen,
        OnlineLoopConfig(num_steps=cfg["full_steps"], minibatch_size=cfg["B"]))
    returns = evaluate_policy(
        env, lambda ts, obs, g: torch.argmax(q_values(ts, obs), dim=1).to(torch.int32),
        state, gen, num_episodes=cs.EVAL_EPISODES)
    return float(returns.mean()), time.perf_counter() - t0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("dqn_family_jobs: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reagent_tpu_torch.ops import _build

    _build.build_all()
    cs.log(cs.card_line())
    on_cpu = "--cpu" in argv
    argv = [a for a in argv if a != "--cpu"]
    names = [n for n in RUNS if not argv or any(a in n for a in argv)]
    results = {}
    for run in names:
        t0 = time.perf_counter()
        cs.phase(f"{run} at full depth")
        name = run.rsplit(" ", 1)[0]
        if run.endswith("online"):
            cfg = cs.DQN_FAMILY_ONLINE[name]
            r = cs.dqn_family_online_phase(torch, name, cfg["full_steps"], cfg["full_prefill"])
            r["launches"] = {k: v for k, v in r["launches"].items() if v}
            r["eval_launches"] = {k: v for k, v in r["eval_launches"].items() if v}
            r["bar_met"] = r["mean_reward"] >= r["bar"]
            if on_cpu:
                r["cpu_mean_reward"], r["cpu_seconds"] = cpu_online_run(torch, name)
                cs.log(f"  the same job on the CPU: greedy mean {r['cpu_mean_reward']:.2f} in "
                       f"{r['cpu_seconds']:.1f} s")
        else:
            with tempfile.TemporaryDirectory() as tmp:
                r = cs.dqn_family_offline_phase(
                    torch, tmp, name, cs.DQN_FAMILY_OFFLINE[name]["full_epochs"])
        r["seconds"] = time.perf_counter() - t0
        results[run] = r
    cs.log(json.dumps({"runs": results, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
