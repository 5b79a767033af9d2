"""The port's functional CartPole and replay buffers against the JAX package:
the same numpy inputs (physics, actions, transitions, sample indices) go
through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.gym.envs import CartPole as JaxCartPole
from reagent_tpu.gym.envs.functional import FunctionalEnvState as JaxEnvState
from reagent_tpu.replay import PackedReplayBuffer as JaxPackedReplayBuffer
from reagent_tpu.replay import ReplayBuffer as JaxReplayBuffer
from reagent_tpu_torch.gym.envs import CartPole, FunctionalEnvState
from reagent_tpu_torch.replay import PackedReplayBuffer, ReplayBuffer

# ------------------------------------------------------------ CartPole


def _physics(rng, n):
    return (rng.normal(size=(n, 4)) * [0.8, 1.0, 0.15, 1.0]).astype(np.float32)


def test_cartpole_step_matches_jax():
    """Float32 physics: sin/cos may differ by an ulp between XLA and PyTorch
    on the CPU, so the state is compared to atol 1e-6; done and t exactly."""
    rng = np.random.default_rng(0)
    n = 64
    physics = _physics(rng, n)
    t = rng.integers(0, 10, n).astype(np.int32)
    t[:4] = 9  # truncation at max_steps
    actions = rng.integers(0, 2, n).astype(np.int32)
    jenv, env = JaxCartPole(max_steps=10), CartPole(max_steps=10, device="cpu")
    state = FunctionalEnvState(physics=torch.tensor(physics), t=torch.tensor(t))
    new, obs, reward, done = env.step(state, torch.tensor(actions))
    for i in range(n):
        js, jobs, jr, jd = jenv.step(
            JaxEnvState(physics=jnp.asarray(physics[i]), t=jnp.int32(t[i])),
            jnp.int32(actions[i]), None)
        np.testing.assert_allclose(obs[i].numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
        assert bool(done[i]) == bool(jd) and int(new.t[i]) == int(js.t)
        assert float(reward[i]) == float(jr) == 1.0
    assert done.dtype == torch.bool and new.t.dtype == torch.int32
    assert done[:4].all() and 0 < int(done.sum()) < n
    assert env.THETA_THRESHOLD == float(jenv.THETA_THRESHOLD)


def test_cartpole_reset_matches_jax_and_batches():
    rng = np.random.default_rng(1)
    u = rng.random((5, 4)).astype(np.float32)
    env = CartPole(device="cpu")
    state, obs = env.reset_from_uniform(torch.tensor(u))
    for i in range(5):
        js, jobs = JaxCartPole().reset_from_uniform(jnp.asarray(u[i]))
        np.testing.assert_array_equal(obs[i].numpy(), np.asarray(jobs))
    assert state.t.shape == (5,) and not state.t.any()
    one, obs1 = env.reset(torch.Generator().manual_seed(3))
    many, obs5 = env.reset(torch.Generator().manual_seed(3), batch_size=5)
    assert obs1.shape == (4,) and obs5.shape == (5, 4) and one.t.shape == ()
    torch.testing.assert_close(obs5[0], obs1, rtol=0, atol=0)
    assert (obs5.abs() <= 0.05).all()


# --------------------------------------------------------------- buffers


def _transitions(rng, n, extra=False):
    out = []
    for i in range(n):
        tr = dict(
            observation=rng.normal(size=4).astype(np.float32),
            action=np.int32(rng.integers(0, 2)),
            reward=np.float32(rng.normal()),
            terminal=np.bool_(rng.random() < 0.25),
        )
        if extra:
            tr["mask"] = (rng.random(2) > 0.5).astype(np.float32)
        out.append(tr)
    return out


def _example(extra=False):
    ex = dict(observation=np.zeros(4, np.float32), action=np.int32(0),
              reward=np.float32(0), terminal=np.bool_(False))
    if extra:
        ex["mask"] = np.zeros(2, np.float32)
    return ex


def _assert_same_batch(port, jax_batch, exact_reward=True):
    assert sorted(port) == sorted(jax_batch)
    for k, v in jax_batch.items():
        want = np.asarray(v)
        got = port[k].numpy()
        assert got.shape == want.shape, (k, got.shape, want.shape)
        if k == "reward" and not exact_reward:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("extra", [False, True])
def test_packed_buffer_matches_jax(extra):
    """Rows, counters and samples are equal, across the capacity wrap."""
    rng = np.random.default_rng(2)
    cap = 16
    jrb = JaxPackedReplayBuffer(replay_capacity=cap)
    rb = PackedReplayBuffer(replay_capacity=cap, device="cpu")
    js, ps = jrb.init(**_example(extra)), rb.init(**_example(extra))
    assert rb.row_width == jrb._row_width and rb._layout.keys() == jrb._layout.keys()
    for tr in _transitions(rng, 23, extra):
        js = jrb.add(js, **{k: jnp.asarray(v) for k, v in tr.items()})
        ps = rb.add(ps, **{k: torch.tensor(v) for k, v in tr.items()})
        assert int(ps.add_count) == int(js.add_count)
        assert int(ps.episode_len) == int(js.episode_len)
    np.testing.assert_array_equal(ps.rows.numpy(), np.asarray(js.rows))
    idx = np.array([0, 3, cap - 1, 7, 7], np.int32)
    _assert_same_batch(
        rb.sample(ps, indices=torch.tensor(idx)),
        jrb.sample(js, jax.random.PRNGKey(0), 5, indices=jnp.asarray(idx)))


def test_packed_buffer_samples_only_valid_indices():
    rng = np.random.default_rng(3)
    rb = PackedReplayBuffer(replay_capacity=32, device="cpu")
    ps = rb.init(**_example())
    trs = _transitions(rng, 20)
    trs[-1]["terminal"] = np.bool_(False)  # the last episode is unfinished
    for tr in trs:
        ps = rb.add(ps, **{k: torch.tensor(v) for k, v in tr.items()})
    idx = rb.sample_index_batch(ps, torch.Generator().manual_seed(0), 500)
    # written 0..19; the unfinished episode's last transition has no next state
    assert set(idx.tolist()) == set(range(19))


CIRCULAR = [(1, 1), (1, 3), (3, 2)]  # (stack_size, update_horizon)


def _filled_circular(stack, horizon, cap, n, seed, timeline=False):
    rng = np.random.default_rng(seed)
    kw = dict(stack_size=stack, replay_capacity=cap, update_horizon=horizon,
              gamma=0.9, return_as_timeline_format=timeline)
    jrb, rb = JaxReplayBuffer(**kw), ReplayBuffer(**kw, device="cpu")
    js, ps = jrb.init(**_example(True)), rb.init(**_example(True))
    for tr in _transitions(rng, n, extra=True):
        js = jrb.add(js, **{k: jnp.asarray(v) for k, v in tr.items()})
        ps = rb.add(ps, **{k: torch.tensor(v) for k, v in tr.items()})
    return jrb, rb, js, ps


@pytest.mark.parametrize("stack,horizon", CIRCULAR, ids=[f"s{s}h{h}" for s, h in CIRCULAR])
def test_circular_buffer_matches_jax(stack, horizon):
    """Store, validity and counters equal after adds that wrap the capacity
    (with stack padding at episode starts); sampling given indices returns
    the same dict (the n-step reward through K4's plain version: rtol 1e-6,
    atol 1e-6, as in tests/test_torch_online_ops.py)."""
    jrb, rb, js, ps = _filled_circular(stack, horizon, 24, 37, seed=stack + horizon)
    for k in js.store:
        np.testing.assert_array_equal(ps.store[k].numpy(), np.asarray(js.store[k]), err_msg=k)
    np.testing.assert_array_equal(ps.is_valid.numpy(), np.asarray(js.is_valid))
    assert int(ps.add_count) == int(js.add_count)
    assert int(ps.episode_len) == int(js.episode_len)
    idx = np.nonzero(np.asarray(js.is_valid))[0].astype(np.int32)
    assert len(idx) > 5
    _assert_same_batch(
        rb.sample(ps, indices=torch.tensor(idx)),
        jrb.sample(js, jax.random.PRNGKey(0), len(idx), indices=jnp.asarray(idx)),
        exact_reward=False)
    drawn = rb.sample_index_batch(ps, torch.Generator().manual_seed(1), 400)
    assert ps.is_valid[drawn].all()


def test_circular_buffer_timeline_format_matches_jax():
    jrb, rb, js, ps = _filled_circular(1, 3, 24, 30, seed=9, timeline=True)
    idx = np.nonzero(np.asarray(js.is_valid))[0].astype(np.int32)
    _assert_same_batch(
        rb.sample(ps, indices=torch.tensor(idx)),
        jrb.sample(js, jax.random.PRNGKey(0), len(idx), indices=jnp.asarray(idx)))
