"""The port's online loops on CartPole.

The fused noise-tape loop runs in lockstep with ``reagent_tpu``'s
``run_fused_online_dqn``: the JAX-prefilled buffer and the initial trainer
state are carried across, and the port replays the tape and initial physics
that JAX's ``_invoke`` draws (``reagent_tpu/gym/fused_dqn_loop.py:199-204``).
The generic loop and ``evaluate_policy`` cannot follow JAX's threefry
stream, so their behaviour is tested instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.gym.envs import CartPole as JaxCartPole
from reagent_tpu.gym.envs.functional import FunctionalEnvState as JaxEnvState
from reagent_tpu.gym.fused_dqn_loop import FusedLoopConfig as JaxFusedLoopConfig
from reagent_tpu.gym.fused_dqn_loop import run_fused_online_dqn as jax_run_fused_online_dqn
from reagent_tpu.gym.online_loop import prefill_replay_buffer as jax_prefill_replay_buffer
from reagent_tpu.models import FullyConnectedDQN as JaxFullyConnectedDQN
from reagent_tpu.replay import PackedReplayBuffer as JaxPackedReplayBuffer
from reagent_tpu.training.fused_dqn_trainer import FusedDQNTrainer as JaxFusedDQNTrainer
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.gym.envs import CartPole, FunctionalEnvState
from reagent_tpu_torch.gym.fused_dqn_loop import FusedLoopConfig, run_fused_loop_from_tape
from reagent_tpu_torch.gym.online_loop import (
    OnlineLoopConfig,
    evaluate_policy,
    prefill_replay_buffer,
    run_online_training,
)
from reagent_tpu_torch.gym.policies import (
    GreedyActionSampler,
    SoftmaxActionSampler,
    discrete_dqn_scorer,
)
from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.ops import fused_dqn, fused_mlp, nstep_replay
from reagent_tpu_torch.replay import PackedReplayBuffer, ReplayBuffer
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.utils.interop import (
    fused_state_from_arrays,
    packed_replay_state_from_arrays,
)

SIZES, ACTS = [32, 16], ["leaky_relu", "leaky_relu"]
RL = dict(gamma=0.99, target_update_rate=0.2)
OPT = {"Adam": {"lr": 0.01}}
FIELDS = ("W", "b", "Wt", "bt", "mW", "mb", "vW", "vb")


def _example():
    return dict(observation=np.zeros(4, np.float32), action=np.int32(0),
                reward=np.float32(0), terminal=np.bool_(False))


def _port_trainer(B):
    net = FullyConnectedDQN(state_dim=4, action_dim=2, sizes=SIZES, activations=ACTS)
    return FusedDQNTrainer(q_network=net, rl=RLParameters(**RL), optimizer=OPT,
                           minibatch_size=B, device="cpu")


def test_fused_loop_lockstep_with_jax():
    """64 steps, 4->32->16->2, B=64.  Tolerances: the per-step update is K2's
    plain version against the Pallas kernel (float32 sums in another order,
    td_loss rtol 1e-4, atol 1e-5); after 64 Adam steps the params carry
    the Adam tolerance of tests/test_torch_fused_dqn.py (rtol 5e-4, atol
    5e-5: Adam's m/sqrt(v) turns a tiny gradient difference into a visible
    step where |g| is small);
    observations to atol 1e-5 (sin/cos may differ by an ulp between XLA and
    PyTorch and the env integrates them); actions, terminals, episode counts
    and returns exactly (any drift there would change the transitions)."""
    N, B, cap = 64, 64, 2048
    jenv = JaxCartPole(max_steps=100)
    jnet = JaxFullyConnectedDQN(state_dim=4, action_dim=2, sizes=SIZES, activations=ACTS)
    jtr = JaxFusedDQNTrainer(q_network=jnet, rl=JaxRLParameters(**RL), optimizer=OPT,
                             minibatch_size=B, interpret=True)
    jrb = JaxPackedReplayBuffer(replay_capacity=cap, gamma=0.99)
    r_init, r_fill = jax.random.split(jax.random.PRNGKey(0))
    jts = jtr.init(r_init, jnp.zeros((1, 4)))
    jrs = jrb.init(**{k: jnp.asarray(v) for k, v in _example().items()})
    jrs = jax_prefill_replay_buffer(jenv, jrb, jrs, r_fill, num_steps=200)

    # carry the starting state across before JAX runs
    tr = _port_trainer(B)
    ps = fused_state_from_arrays(
        *[tuple(np.asarray(x) for x in getattr(jts, f)) for f in FIELDS], np.asarray(jts.step))
    rb = PackedReplayBuffer(replay_capacity=cap, device="cpu")
    rb.init(**_example())
    prs = packed_replay_state_from_arrays(
        np.asarray(jrs.rows), np.asarray(jrs.add_count), np.asarray(jrs.episode_len))
    start_rows = np.asarray(jrs.rows).copy()

    # _invoke's draws, reproduced
    rng = jax.random.PRNGKey(1)
    r0, r_gumbel, r_reset, r_sample = jax.random.split(rng, 4)
    jenv_state, _ = jenv.reset(r0)
    tape = (
        jax.random.gumbel(r_gumbel, (N, 2), jnp.float32),
        jax.random.uniform(r_reset, (N, jenv.reset_noise_dim), jnp.float32),
        jax.random.uniform(r_sample, (N, B), jnp.float32),
    )
    jts_out, jrs_out, jaux = jax_run_fused_online_dqn(
        jenv, jtr, jts, jrb, jrs, rng, JaxFusedLoopConfig(num_steps=N, minibatch_size=B))

    physics = torch.tensor(np.asarray(jenv_state.physics))
    env = CartPole(max_steps=100, device="cpu")
    calls = (fused_dqn.fused_dqn_update_packed_reference.calls,
             fused_mlp.fused_mlp_forward_reference.calls)
    ts, rs, aux = run_fused_loop_from_tape(
        env, tr, ps, rb, prs,
        FunctionalEnvState(physics=physics, t=torch.zeros((), dtype=torch.int32)), physics,
        tuple(torch.tensor(np.asarray(x)) for x in tape),
        FusedLoopConfig(num_steps=N, minibatch_size=B))
    # every step: one act (K3) and one packed update (K2), plain on the CPU
    assert (fused_dqn.fused_dqn_update_packed_reference.calls - calls[0],
            fused_mlp.fused_mlp_forward_reference.calls - calls[1]) == (N, N)

    rows, jrows = rs.rows.numpy(), np.asarray(jrs_out.rows)
    act_col, term_col = rb.column("action"), rb.column("terminal")
    obs_col, rew_col = rb.column("observation"), rb.column("reward")
    assert not np.array_equal(jrows, start_rows)
    np.testing.assert_array_equal(rows[:, act_col], jrows[:, act_col])
    np.testing.assert_array_equal(rows[:, term_col], jrows[:, term_col])
    np.testing.assert_array_equal(rows[:, rew_col], jrows[:, rew_col])
    np.testing.assert_allclose(rows[:, obs_col:obs_col + 4], jrows[:, obs_col:obs_col + 4],
                               atol=1e-5, rtol=0)
    assert int(rs.add_count) == int(jrs_out.add_count) == 200 + N
    assert int(rs.episode_len) == int(jrs_out.episode_len)

    np.testing.assert_allclose(aux["td_losses"].numpy(), np.asarray(jaux["td_losses"]),
                               rtol=1e-4, atol=1e-5)
    assert aux["td_losses"].shape == (N,)
    for f in FIELDS:
        for p, j in zip(getattr(ts, f), getattr(jts_out, f)):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=5e-4, atol=5e-5, err_msg=f)
    assert int(ts.step) == int(jts_out.step) == N
    assert int(aux["episodes_completed"]) == int(jaux["episodes_completed"]) >= 1
    np.testing.assert_array_equal(aux["recent_episode_returns"].numpy(),
                                  np.asarray(jaux["recent_episode_returns"]))


def _softmax_policy(trainer, scorer):
    sampler = SoftmaxActionSampler(temperature=1.0)

    def policy_act(tstate, obs, generator):
        out = sampler.sample_action(scorer(trainer.mlp_weights(tstate), obs[None]), generator)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    return policy_act


def test_generic_loop_trains_and_keeps_books():
    B, prefill, N, after, every, K = 32, 100, 60, 10, 2, 8
    env = CartPole(max_steps=50, device="cpu")
    tr = _port_trainer(B)
    ts = tr.init(torch.Generator().manual_seed(0))
    W0 = [w.clone() for w in ts.W]
    rb = ReplayBuffer(replay_capacity=512, update_horizon=1, gamma=0.99, device="cpu")
    rs = rb.init(**{k: torch.tensor(v) for k, v in _example().items()})
    gen = torch.Generator().manual_seed(1)
    rs = prefill_replay_buffer(env, rb, rs, gen, num_steps=prefill)
    assert int(rs.add_count) == prefill and int(rs.size) >= prefill - 1

    scorer = discrete_dqn_scorer(tr.q_network)
    calls = (nstep_replay.nstep_rewards_reference.calls, fused_mlp.fused_mlp_forward_reference.calls,
             fused_dqn.fused_dqn_update_reference.calls)
    ts, rs, aux = run_online_training(
        env, tr, ts, rb, rs, _softmax_policy(tr, scorer),
        lambda d: make_discrete_dqn_batch(d, 2), gen,
        OnlineLoopConfig(num_steps=N, train_every=every, train_after=after,
                         minibatch_size=B, episode_return_buffer=K))
    rounds = (N - after) // every
    # one K4 per sample, one K3 per env step, one tensor K2 per update
    assert (nstep_replay.nstep_rewards_reference.calls - calls[0],
            fused_mlp.fused_mlp_forward_reference.calls - calls[1],
            fused_dqn.fused_dqn_update_reference.calls - calls[2]) == (rounds, N, rounds)
    assert int(rs.add_count) == prefill + N and int(ts.step) == rounds
    losses = aux["td_losses"]
    assert losses.shape == (rounds,) and torch.isfinite(losses).all()
    assert any(not torch.equal(a, b) for a, b in zip(W0, ts.W))
    # every finished episode of the run is in the ring (or was pushed out of it)
    eps = int(aux["episodes_completed"])
    returns = aux["recent_episode_returns"]
    assert eps >= 1 and int((~torch.isnan(returns)).sum()) == min(eps, K)
    finished = returns[~torch.isnan(returns)]
    assert (finished >= 1).all() and (finished <= 50).all() and (finished == finished.round()).all()


def test_evaluate_policy_greedy_from_fixed_resets():
    """All episodes as one batch: each return equals a one-env greedy
    rollout of the JAX CartPole from the same initial physics (the policy's
    q from the same weights), counted up to the first done."""
    E, T = 6, 60
    tr = _port_trainer(16)
    ts = tr.init(torch.Generator().manual_seed(4))
    scorer = discrete_dqn_scorer(tr.q_network)
    greedy = GreedyActionSampler()
    env = CartPole(max_steps=T, device="cpu")

    def greedy_act(tstate, obs, generator):
        return torch.argmax(greedy.sample_action(scorer(tr.mlp_weights(tstate), obs)).action, dim=-1)

    gen = torch.Generator().manual_seed(5)
    _, start = env.reset(torch.Generator().set_state(gen.get_state()), batch_size=E)
    returns = evaluate_policy(env, greedy_act, ts, gen, num_episodes=E)
    assert returns.shape == (E,)

    weights = [(w.T.numpy(), b.reshape(-1).numpy()) for w, b in zip(ts.W, ts.b)]

    def q(x):
        for (w, b), a in zip(weights, ACTS + ["linear"]):
            x = x @ w + b
            x = np.where(x > 0, x, 0.01 * x) if a == "leaky_relu" else x
        return x

    jenv = JaxCartPole(max_steps=T)
    for e in range(E):
        state = JaxEnvState(physics=jnp.asarray(start[e].numpy()), t=jnp.int32(0))
        total = 0.0
        for _ in range(T):
            action = int(np.argmax(q(np.asarray(state.physics))))
            state, _, reward, done = jenv.step(state, jnp.int32(action), None)
            total += float(reward)
            if bool(done):
                break
        assert float(returns[e]) == total


def test_samplers_scorer_and_batch_maker_match_jax():
    """Log-probs, entropy, greedy picks, the possible-actions mask and the
    discrete-DQN batch against the JAX functions on the same numpy inputs
    (float32 softmax arithmetic in another order: rtol 1e-6, atol 1e-6);
    softmax draws follow softmax(q / T) (20,000 draws, atol 0.02)."""
    from reagent_tpu.gym.policies.samplers import GreedyActionSampler as JaxGreedy
    from reagent_tpu.gym.policies.samplers import SoftmaxActionSampler as JaxSoftmax
    from reagent_tpu.gym.policies.scorers import (
        apply_possible_actions_mask as jax_apply_possible_actions_mask,
    )
    from reagent_tpu.gym.preprocessors import make_discrete_dqn_batch as jax_make_batch
    from reagent_tpu_torch.gym.policies import apply_possible_actions_mask

    rng = np.random.default_rng(0)
    scores = rng.normal(size=(16, 3)).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    mask = rng.random((16, 3)) > 0.3
    soft, jsoft = SoftmaxActionSampler(temperature=0.7), JaxSoftmax(temperature=0.7)
    ts, js, ta = torch.tensor(scores), jnp.asarray(scores), torch.tensor(onehot)
    for got, want in (
        (soft.log_prob(ts, ta), jsoft.log_prob(js, jnp.asarray(onehot))),
        (soft.entropy(ts), jsoft.entropy(js)),
        (GreedyActionSampler().sample_action(ts).action, JaxGreedy().sample_action(js).action),
        (GreedyActionSampler().log_prob(ts, ta), JaxGreedy().log_prob(js, jnp.asarray(onehot))),
        (apply_possible_actions_mask(ts, torch.tensor(mask)),
         jax_apply_possible_actions_mask(js, jnp.asarray(mask))),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    q = torch.tensor([[1.0, 0.2, -0.5]]).expand(20000, 3)
    out = soft.sample_action(q, torch.Generator().manual_seed(0))
    freq = out.action.mean(dim=0).numpy()
    np.testing.assert_allclose(freq, torch.softmax(q[0] / 0.7, dim=0).numpy(), atol=0.02)
    np.testing.assert_allclose(
        out.log_prob.numpy(), soft.log_prob(q, out.action).numpy(), rtol=1e-6, atol=1e-6)

    sample = dict(
        state=rng.normal(size=(8, 4)).astype(np.float32),
        next_state=rng.normal(size=(8, 4)).astype(np.float32),
        action=rng.integers(0, 2, (8, 1)).astype(np.int32),
        next_action=rng.integers(0, 2, (8, 1)).astype(np.int32),
        reward=rng.normal(size=(8, 1)).astype(np.float32),
        terminal=rng.random((8, 1)) < 0.3,
        step=np.ones((8, 1), np.int32),
    )
    got = make_discrete_dqn_batch({k: torch.tensor(v) for k, v in sample.items()}, 2)
    want = jax_make_batch({k: jnp.asarray(v) for k, v in sample.items()}, 2)
    for field in ("action", "next_action", "reward", "time_diff", "step", "not_terminal",
                  "possible_actions_mask", "possible_next_actions_mask"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(got.state.float_features.numpy(), sample["state"])
