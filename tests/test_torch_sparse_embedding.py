"""The touched-rows sparse embedding step against the JAX package's
(``reagent_tpu/ops/sparse_embedding.py``), through JAX's ``logical_table``
(the port keeps no lane packing): several steps from JAX's state with
duplicate ids and padded slots, the plain dense-autodiff step without
duplicates, padded slots leaving their rows alone, the per-occurrence
row-wise Adagrad on duplicate ids against a numpy oracle, and a falling
loss.  Inputs come from numpy seeds and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.ops import sparse_embedding as jse
from reagent_tpu_torch.ops import sparse_embedding as se
from reagent_tpu_torch.optim import make_optimizer
from reagent_tpu_torch.utils.interop import (
    opt_state_from_optax,
    sparse_embedding_state_from_arrays,
)

# float32 sums of the same terms in another order (the head's matmuls)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
TABLE_TOL = dict(rtol=1e-5, atol=1e-7)
ACCUM_TOL = dict(rtol=1e-4, atol=1e-12)
HEAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_setup(table_size, dim, seed=0, head_hidden=16):
    return jse.init_sparse_embedding_state(jax.random.PRNGKey(seed), table_size, dim,
                                           head_hidden=head_hidden)


def _carry(jstate, table_size, dim):
    """The port's state from JAX's, the table through ``logical_table``."""
    return sparse_embedding_state_from_arrays(
        np.asarray(jse.logical_table(jstate, table_size, dim)), np.asarray(jstate.accum),
        jax.tree_util.tree_map(np.asarray, jstate.head_params),
        opt_state_from_optax(jstate.head_opt_state))


def _port_step(table_size, dim):
    state, head_apply, opt = se.init_sparse_embedding_state(
        torch.Generator().manual_seed(0), table_size, dim, head_hidden=16, device="cpu")
    return se.make_sparse_embedding_train_step(head_apply, opt)


def _batch(rng, table_size, B, L, duplicates=True, padded=True):
    if duplicates:  # a small id range: many ids repeat within the batch
        ids = rng.integers(0, max(table_size // 4, 2), (B, L)).astype(np.int32)
        ids[0, :3] = ids[1, 0]  # and the same id in two rows
    else:
        ids = rng.choice(table_size, B * L, replace=False).reshape(B, L).astype(np.int32)
    mask = np.ones((B, L), bool)
    if padded:
        lengths = rng.integers(0, L + 1, B)
        lengths[1] = L
        mask = np.arange(L)[None, :] < lengths[:, None]
    target = rng.normal(size=(B, 1)).astype(np.float32)
    return ids, mask, target


def _assert_state_close(state, jstate, table_size, dim, msg):
    np.testing.assert_allclose(
        se.logical_table(state, table_size, dim).numpy(),
        np.asarray(jse.logical_table(jstate, table_size, dim)), **TABLE_TOL, err_msg=msg)
    np.testing.assert_allclose(state.accum.numpy(), np.asarray(jstate.accum), **ACCUM_TOL,
                               err_msg=msg)
    for k, v in jstate.head_params.items():
        np.testing.assert_allclose(state.head_params[k].numpy(), np.asarray(v), **HEAD_TOL,
                                   err_msg=f"{msg} {k}")


@pytest.mark.parametrize("table_size,dim", [(64, 8), (200, 16), (48, 96), (40, 128)])
def test_step_against_jax_through_logical_table(table_size, dim):
    """5 steps from JAX's state on batches with duplicate ids and padded
    slots; dims 8 and 16 are lane-packed in JAX (16 and 8 rows a 128-lane
    row), 96 and 128 are not."""
    jstate, jhead, jopt = _jax_setup(table_size, dim)
    jstep = jse.make_sparse_embedding_train_step(jhead, jopt, donate=False)
    state = _carry(jstate, table_size, dim)
    step = _port_step(table_size, dim)
    rng = np.random.default_rng(table_size + dim)
    for i in range(5):
        ids, mask, target = _batch(rng, table_size, B=12, L=5)
        jstate, jloss = jstep(jstate, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(target))
        state, loss = step(state, torch.from_numpy(ids), torch.from_numpy(mask),
                           torch.from_numpy(target))
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL, err_msg=f"step {i}")
        _assert_state_close(state, jstate, table_size, dim, f"step {i}")
    assert int(state.head_opt_state.count) == 5


def test_step_writes_the_table_in_place():
    state, head_apply, opt = se.init_sparse_embedding_state(
        torch.Generator().manual_seed(1), 32, 8, head_hidden=16, device="cpu")
    step = se.make_sparse_embedding_train_step(head_apply, opt)
    table, accum = state.table, state.accum
    rng = np.random.default_rng(1)
    ids, mask, target = _batch(rng, 32, B=4, L=3)
    new, _ = step(state, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(target))
    assert new.table is table and new.accum is accum
    assert float(accum.sum()) > 0
    with pytest.raises(ValueError, match="is not"):
        se.logical_table(new, 33, 8)


@pytest.mark.parametrize("dim", [8, 128])
def test_against_jax_dense_reference_without_duplicates(dim):
    """Without duplicate ids the touched-rows step equals JAX's plain
    dense-autodiff step, and the port's plain step equals JAX's too."""
    table_size = 64
    jstate, jhead, jopt = _jax_setup(table_size, dim, seed=2)
    jdense = jse.dense_reference_step(jhead, jopt)
    state, head_apply, opt = se.init_sparse_embedding_state(
        torch.Generator().manual_seed(0), table_size, dim, head_hidden=16, device="cpu")
    sparse = se.make_sparse_embedding_train_step(head_apply, opt)
    dense = se.dense_reference_step(head_apply, opt)
    rng = np.random.default_rng(3)
    ids, mask, target = _batch(rng, table_size, B=16, L=4, duplicates=False, padded=False)
    jnew, jloss = jdense(jstate, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(target))
    args = (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(target))
    d_state, d_loss = dense(_carry(jstate, table_size, dim), *args)
    s_state, s_loss = sparse(_carry(jstate, table_size, dim), *args)
    for label, (st, loss) in {"dense": (d_state, d_loss), "sparse": (s_state, s_loss)}.items():
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL, err_msg=label)
        _assert_state_close(st, jnew, table_size, dim, label)


def test_padded_slots_leave_rows_untouched():
    table_size, dim = 64, 8
    jstate, _, _ = _jax_setup(table_size, dim)
    state = _carry(jstate, table_size, dim)
    before = state.table.clone()
    step = _port_step(table_size, dim)
    rng = np.random.default_rng(1)
    B, L = 8, 6
    ids = rng.choice(table_size, B * L, replace=False).reshape(B, L).astype(np.int32)
    mask = np.concatenate([np.ones((B, 3)), np.zeros((B, 3))], 1).astype(bool)
    target = rng.normal(size=(B, 1)).astype(np.float32)
    state, _ = step(state, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(target))
    padded = ids[:, 3:].reshape(-1)
    active = ids[:, :3].reshape(-1)
    untouched = sorted(set(range(table_size)) - set(active.tolist()))
    assert set(padded) <= set(untouched)
    np.testing.assert_array_equal(state.table[untouched].numpy(), before[untouched].numpy())
    np.testing.assert_array_equal(state.accum[untouched].numpy(), 0.0)
    assert (state.table[active] != before[active]).any(dim=1).all()


def test_duplicate_ids_take_per_occurrence_adagrad():
    """Each occurrence of an id adds the mean square of its own gradient to
    the row's accumulator, and every occurrence's update (scaled by the
    accumulator after all adds) is added to the row: a numpy oracle from
    the rows' gradients (autograd of the same loss), and JAX's step."""
    table_size, dim, lr, eps = 16, 8, 0.05, 1e-8
    jstate, jhead, jopt = _jax_setup(table_size, dim, seed=5)
    state = _carry(jstate, table_size, dim)
    ids = np.array([[3, 3, 7], [3, 9, 9]], np.int32)  # 3 three times, 9 twice
    mask = np.array([[1, 1, 1], [1, 1, 0]], bool)  # the second 9 is padding
    target = np.array([[1.0], [-2.0]], np.float32)
    table0 = state.table.clone()
    rows = table0[torch.from_numpy(ids).long()].requires_grad_(True)
    m = torch.from_numpy(mask).float()[..., None]
    pooled = (rows * m).sum(1) / m.sum(1).clamp(min=1)
    loss = ((se.head_apply(state.head_params, pooled) - torch.from_numpy(target)) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [rows])
    g = (g.reshape(-1, dim) * m.reshape(-1, 1)).numpy().astype(np.float64)
    flat = ids.reshape(-1)
    accum = np.zeros(table_size)
    for i, row in enumerate(flat):
        accum[row] += np.mean(g[i] ** 2)
    table = table0.numpy().astype(np.float64)
    for i, row in enumerate(flat):
        table[row] += -lr * g[i] / np.sqrt(accum[row] + eps)
    step = se.make_sparse_embedding_train_step(se.head_apply,
                                               make_optimizer({"Adam": {"lr": 1e-3}}))
    state, _ = step(state, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(target))
    np.testing.assert_allclose(state.accum.numpy(), accum, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(state.table.numpy(), table, rtol=1e-5, atol=1e-7)
    # three occurrences of 3: the sum of three squares, not the square of a sum
    summed = g[[0, 1, 3]].sum(0)
    assert not np.isclose(accum[3], np.mean(summed ** 2))
    jstep = jse.make_sparse_embedding_train_step(jhead, jopt, donate=False)
    jnew, _ = jstep(jstate, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(target))
    np.testing.assert_allclose(np.asarray(jnew.accum), accum, rtol=1e-5, atol=1e-12)


def test_training_reduces_loss():
    """JAX's learnability check on the port: the target is the mean of fixed
    per-id values, 60 steps."""
    state, head_apply, opt = se.init_sparse_embedding_state(
        torch.Generator().manual_seed(0), 256, 16, head_hidden=16, device="cpu")
    step = se.make_sparse_embedding_train_step(head_apply, opt)
    rng = np.random.default_rng(2)
    B, L = 64, 8
    id_values = rng.normal(size=256).astype(np.float32)
    losses = []
    for _ in range(60):
        ids = rng.integers(0, 256, (B, L)).astype(np.int32)
        target = id_values[ids].mean(axis=1, keepdims=True)
        state, loss = step(state, torch.from_numpy(ids), torch.ones((B, L), dtype=torch.bool),
                           torch.from_numpy(target))
        losses.append(float(loss))
    assert np.mean(losses[-10:]) < 0.3 * np.mean(losses[:10]), losses[::10]


def test_init_state_shapes():
    state, _, opt = se.init_sparse_embedding_state(
        torch.Generator().manual_seed(0), 100, 8, head_hidden=32, out_dim=2, device="cpu",
        head_optimizer={"SGD": {"lr": 0.1}})
    assert state.table.shape == (100, 8) and state.accum.shape == (100,)
    assert {k: tuple(v.shape) for k, v in state.head_params.items()} == {
        "w1": (8, 32), "b1": (32,), "w2": (32, 2), "b2": (2,)}
    assert float(state.table.std()) == pytest.approx(0.01, rel=0.1)
    assert not state.accum.any()
