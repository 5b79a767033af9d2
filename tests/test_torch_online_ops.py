"""The online slice's kernels, plain versions (what a CPU tensor runs) held to
the JAX package's Pallas kernels in interpret mode: K2's packed interface,
K3 ``fused_mlp_forward`` and K4 ``nstep_rewards``.  Inputs come from numpy
seeds and go to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.ops.fused_dqn import make_fused_dqn_train_kernel
from reagent_tpu.ops.fused_mlp import fused_mlp_forward as jax_fused_mlp_forward
from reagent_tpu.ops.nstep_replay import nstep_rewards as jax_nstep_rewards
from reagent_tpu.ops.nstep_replay import nstep_rewards_xla
from reagent_tpu_torch.ops.fused_dqn import (
    fused_dqn_update_packed,
    fused_dqn_update_packed_reference,
)
from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward, fused_mlp_forward_reference
from reagent_tpu_torch.ops.nstep_replay import nstep_rewards, nstep_rewards_reference

# ------------------------------------------------------------ K2 packed

# the packed row layout of a PackedReplayBuffer holding CartPole transitions:
# action 0, observation 1-4, reward 5, terminal 6, padding 7
COLS = (1, 0, 5, 6)


def _packed_inputs(rng, B, D, A, widths):
    dims = list(zip([D, *widths], [*widths, A]))
    W = [(rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32) for i, o in dims]
    b = [rng.normal(size=(1, o)).astype(np.float32) * 0.1 for _, o in dims]
    Wt = [w + rng.normal(size=w.shape).astype(np.float32) * 0.05 for w in W]
    bt = [x + rng.normal(size=x.shape).astype(np.float32) * 0.05 for x in b]
    zeros = [np.zeros_like(p) for p in W + b]
    params8 = W + b + Wt + bt + zeros + zeros

    def rows():
        r = np.zeros((B, 8), np.float32)
        r[:, 0] = rng.integers(0, A, B)
        r[:, 1:1 + D] = rng.normal(size=(B, D))
        r[:, 5] = rng.normal(size=B)
        r[:, 6] = rng.random(B) < 0.1
        return r

    return dims, params8, rows


@pytest.mark.parametrize("double_q", [True, False])
def test_k2_packed_plain_version_matches_pallas_kernel(double_q):
    """5 lockstep updates from one state.  Tolerances as the tensor K2's
    parity (tests/test_torch_fused_dqn.py):
    float32 sums in another order (rtol 1e-4, atol 1e-5 per step's
    metrics; Adam turns tiny gradient differences into parameter
    differences, so the final params get rtol 5e-4, atol 5e-5)."""
    rng = np.random.default_rng(21)
    B, D, A = 64, 4, 2
    dims, params8, make_rows = _packed_inputs(rng, B, D, A, [32, 16])
    acts = ["leaky_relu", "leaky_relu", "linear"]
    run = make_fused_dqn_train_kernel(
        dims, acts, B, 0.99, 0.2, double_q, packed=COLS, interpret=True)
    jparams = [jnp.asarray(p) for p in params8]
    port8 = [torch.tensor(p) for p in params8]
    calls = fused_dqn_update_packed_reference.calls
    for step in range(5):
        rows, next_rows = make_rows(), make_rows()
        t = step + 1.0
        lr_t = np.float32(0.01 * np.sqrt(1 - 0.999**t) / (1 - 0.9**t))
        eps_t = np.float32(1e-8 * np.sqrt(1 - 0.999**t))
        outs = run(jnp.float32(lr_t), jnp.float32(eps_t), jnp.asarray(rows),
                   jnp.asarray(next_rows), jparams)
        jparams = list(outs[:-1])
        metrics = fused_dqn_update_packed(
            torch.tensor(lr_t), torch.tensor(eps_t), torch.tensor(rows),
            torch.tensor(next_rows), port8, cols=COLS, activations=acts,
            gamma=0.99, tau=0.2, double_q_learning=double_q)
        np.testing.assert_allclose(metrics.numpy(), np.asarray(outs[-1]), rtol=1e-4, atol=1e-5)
    assert fused_dqn_update_packed_reference.calls == calls + 5  # CPU takes the plain version
    for k, (j, p) in enumerate(zip(jparams, port8)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=5e-4, atol=5e-5,
                                   err_msg=f"params8[{k}]")


# ------------------------------------------------------------------- K3


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "linear"])
def test_k3_plain_version_matches_pallas_kernel(act):
    """A ragged batch (300 rows, block_b 128) through a 3-layer MLP.  Float32
    matmuls summed in another order: rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(3)
    sizes = [6, 40, 24, 3]
    weights = [
        ((rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
         (rng.normal(size=o) * 0.1).astype(np.float32))
        for i, o in zip(sizes[:-1], sizes[1:])
    ]
    x = rng.normal(size=(300, 6)).astype(np.float32)
    acts = [act, act, "linear"]
    want = jax_fused_mlp_forward(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights], acts,
        block_b=128, interpret=True)
    calls = fused_mlp_forward_reference.calls
    got = fused_mlp_forward(
        torch.tensor(x), [(torch.tensor(w), torch.tensor(b)) for w, b in weights], acts,
        block_b=128)
    assert fused_mlp_forward_reference.calls == calls + 1
    assert got.shape == (300, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_k3_takes_transposed_weight_views():
    """[out, in] weights passed as W.T views score like contiguous [in, out]."""
    rng = np.random.default_rng(4)
    w_out_in = torch.tensor(rng.normal(size=(5, 7)).astype(np.float32))
    b = torch.tensor(rng.normal(size=5).astype(np.float32))
    x = torch.tensor(rng.normal(size=(9, 7)).astype(np.float32))
    a = fused_mlp_forward(x, [(w_out_in.T, b)], ["tanh"])
    c = fused_mlp_forward(x, [(w_out_in.T.contiguous(), b)], ["tanh"])
    torch.testing.assert_close(a, c, rtol=0, atol=0)


# ------------------------------------------------------------------- K4


def _nstep_case(capacity, seed):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=capacity).astype(np.float32)
    terminals = rng.random(capacity) < 0.2
    terminals[capacity - 2] = True  # inside a wrapped window
    idx = np.concatenate([
        rng.integers(0, capacity, 40),
        [capacity - 1, capacity - 2, capacity - 3, 0, 3],  # wraparound, terminal at start
    ]).astype(np.int32)
    return rewards, terminals, idx


@pytest.mark.parametrize("horizon", [1, 3])
def test_k4_plain_version_matches_pallas_kernel_and_xla(horizon):
    """Windows with terminals inside, at the horizon cap and across the
    capacity wrap.  Steps and terminal flags exactly; rewards to rtol 1e-6,
    atol 1e-6: the three round gamma^k and the products in different places
    (the xla version takes gamma^k in float32 arithmetic), which moves each
    term of size up to ~3 by an ulp or two, and a sum that cancels keeps
    that absolute error."""
    capacity, gamma = 64, 0.9
    rewards, terminals, idx = _nstep_case(capacity, seed=horizon)
    # a terminal exactly at the cap of one window
    terminals[10:10 + horizon] = False
    terminals[10 + horizon - 1] = True
    idx = np.concatenate([idx, [10]]).astype(np.int32)
    calls = nstep_rewards_reference.calls
    r, s, t = nstep_rewards(
        torch.tensor(rewards), torch.tensor(terminals), torch.tensor(idx), horizon, gamma)
    assert nstep_rewards_reference.calls == calls + 1
    assert r.dtype == torch.float32 and s.dtype == torch.int32 and t.dtype == torch.bool
    for jr, js, jt in (
        jax_nstep_rewards(jnp.asarray(rewards), jnp.asarray(terminals), jnp.asarray(idx),
                          horizon, gamma, interpret=True),
        nstep_rewards_xla(jnp.asarray(rewards), jnp.asarray(terminals), jnp.asarray(idx),
                          horizon, gamma),
    ):
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    assert s[-1] == horizon and bool(t[-1])


def test_k4_reward_columns_sum_like_scalar_rewards():
    """Rewards [capacity, 2, 3] reduce column by column like six scalar stores."""
    rng = np.random.default_rng(8)
    rewards = torch.tensor(rng.normal(size=(32, 2, 3)).astype(np.float32))
    terminals = torch.tensor(rng.random(32) < 0.3)
    idx = torch.tensor(rng.integers(0, 32, 20))
    r, s, t = nstep_rewards(rewards, terminals, idx, 3, 0.95)
    assert r.shape == (20, 2, 3)
    flat = rewards.reshape(32, 6)
    for j in range(6):
        rj, sj, tj = nstep_rewards(flat[:, j].contiguous(), terminals, idx, 3, 0.95)
        torch.testing.assert_close(r.reshape(20, 6)[:, j], rj, rtol=0, atol=0)
        assert torch.equal(s, sj) and torch.equal(t, tj)
