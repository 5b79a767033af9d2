"""K1's ``matmul_dtype`` / ``save_dtype`` options in the port against the JAX
package: the plain PyTorch version (what a CPU tensor runs, and what the CUDA
kernel is held to on the card) against the Pallas kernel in interpret mode for
all four dtype combinations, ``FusedDQNTrainer(matmul_dtype=bfloat16)`` in
lockstep with JAX's, and ``from_dqn_state``.  Inputs come from numpy seeds
and go to both packages.

Tolerances.  Both sides multiply exactly (a product of two bfloat16 values is
exact in float32) and differ in the order of the float32 sums.  A last-bit
difference in a pre-activation can flip the bfloat16 rounding of one saved
activation (2^-8 relative in that element), which moves one term of a
weight-gradient sum.  So the metrics row and the first moments (from zero
moments ``m = (1 - b1) * g``: linear in the gradient) are compared tightly,
and the parameters, which Adam's first steps move by about ``lr * sign(g)``
whatever ``|g|`` is, with an ``atol`` in units of ``lr``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.models import FullyConnectedDQN as JaxFullyConnectedDQN
from reagent_tpu.ops.fused_dqn_offline import make_fused_dqn_offline_kernel
from reagent_tpu.training.dqn_trainer import DQNTrainer as JaxDQNTrainer
from reagent_tpu.training.fused_dqn_trainer import FusedDQNTrainer as JaxFusedDQNTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.ops.fused_dqn_offline import (
    fused_dqn_offline_update,
    fused_dqn_offline_update_reference,
)
from reagent_tpu_torch.training.dqn_trainer import DQNTrainer
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.utils.interop import (
    dqn_state_from_arrays,
    fused_state_from_arrays,
    opt_state_from_arrays,
    q_network_state_from_flax,
)

LR, B1, B2, EPS = 5e-3, 0.9, 0.999, 1e-8
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]
STATE_FIELDS = ("W", "b", "Wt", "bt", "mW", "mb", "vW", "vb")


def _name(dtype):
    return "none" if dtype is None else str(dtype).split(".")[-1]


def _inputs(rng, B, D, A, widths):
    """Batch and params8 with ZERO Adam moments, numpy: ~30% of the next
    actions impossible (row 0: all but the last), ~10% terminal rows."""
    dims = list(zip([D, *widths], [*widths, A]))
    W = [(rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32) for i, o in dims]
    b = [rng.normal(size=(1, o)).astype(np.float32) * 0.1 for _, o in dims]
    Wt = [w + rng.normal(size=w.shape).astype(np.float32) * 0.05 for w in W]
    bt = [x + rng.normal(size=x.shape).astype(np.float32) * 0.05 for x in b]
    zeros = [np.zeros_like(p) for p in W + b]
    params8 = W + b + Wt + bt + zeros + zeros
    mask = (rng.random((B, A)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[0] = 0.0
    mask[0, A - 1] = 1.0
    not_terminal = (rng.random((B, 1)) > 0.1).astype(np.float32)
    not_terminal[1] = 0.0
    batch = [
        rng.normal(size=(B, D)).astype(np.float32),
        rng.normal(size=(B, D)).astype(np.float32),
        np.eye(A, dtype=np.float32)[rng.integers(0, A, B)],
        rng.normal(size=(B, 1)).astype(np.float32),
        not_terminal,
        mask,
    ]
    lr_t = np.float32(LR * np.sqrt(1 - B2) / (1 - B1))  # step 1
    eps_t = np.float32(EPS * np.sqrt(1 - B2))
    return dims, batch, params8, lr_t, eps_t


def _run_both(acts, double_q, matmul_dtype, save_dtype, seed=21):
    rng = np.random.default_rng(seed)
    dims, batch, params8, lr_t, eps_t = _inputs(rng, B=256, D=8, A=4, widths=[32, 16])
    run = make_fused_dqn_offline_kernel(
        dims, acts, 256, 0.99, 0.1, double_q, block_size=64,
        matmul_dtype=JNP[matmul_dtype],
        save_dtype=None if save_dtype is None else JNP[save_dtype], interpret=True)
    outs = run(jnp.float32(lr_t), jnp.float32(eps_t),
               *[jnp.asarray(x) for x in batch], [jnp.asarray(p) for p in params8])
    port8 = [torch.tensor(p) for p in params8]
    calls = fused_dqn_offline_update_reference.calls
    metrics = fused_dqn_offline_update(
        torch.tensor(lr_t), torch.tensor(eps_t), *[torch.tensor(x) for x in batch],
        port8, activations=acts, gamma=0.99, tau=0.1, double_q_learning=double_q,
        block_size=64, matmul_dtype=matmul_dtype, save_dtype=save_dtype)
    assert fused_dqn_offline_update_reference.calls == calls + 1  # CPU: the plain version
    return [np.asarray(o) for o in outs], [p.numpy() for p in port8], metrics.numpy(), len(dims)


@pytest.mark.parametrize("act", ["leaky_relu", "tanh"])
@pytest.mark.parametrize("double_q", [True, False], ids=["double_q", "single_q"])
@pytest.mark.parametrize("save_dtype", [None, *DTYPES], ids=_name)
@pytest.mark.parametrize("matmul_dtype", DTYPES, ids=_name)
def test_k1_plain_version_matches_pallas_kernel(matmul_dtype, save_dtype, double_q, act):
    """One update from zero moments.  Metrics rtol 1e-5, atol 1e-6 (q is
    float32 and never rounded); first moments rtol 1e-4, atol 2e-6 (one
    flipped bfloat16 rounding of a saved activation moves one term of one
    sum by 2^-8 of itself; ``(1 - b1) * 2/B * |err * h| * 2^-8`` is below
    1e-6 here); second moments follow; parameters and targets atol 2 * lr_t
    where ``|g|`` is too small to fix Adam's first step, else rtol 1e-4."""
    outs, port8, metrics, L = _run_both([act, act, "linear"], double_q, matmul_dtype, save_dtype)
    np.testing.assert_allclose(metrics, outs[8 * L], rtol=1e-5, atol=1e-6)
    lr_t = LR * np.sqrt(1 - B2) / (1 - B1)
    for k in range(8 * L):
        group, name = k // L, f"{STATE_FIELDS[k // L]}[{k % L}]"
        if group in (4, 5):  # first moments
            np.testing.assert_allclose(port8[k], outs[k], rtol=1e-4, atol=2e-6, err_msg=name)
        elif group in (6, 7):  # second moments: (1 - b2) * g^2
            np.testing.assert_allclose(port8[k], outs[k], rtol=2e-4, atol=1e-9, err_msg=name)
        else:
            g = np.abs(outs[4 * L + k % L] if group % 2 == 0 else outs[5 * L + k % L]) / (1 - B1)
            settled = g > 1e-4  # Adam's first step is lr_t * g / (|g| + eps_t)
            np.testing.assert_allclose(
                port8[k][settled], outs[k][settled], rtol=1e-4, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(port8[k], outs[k], rtol=0, atol=2 * lr_t, err_msg=name)


def test_dtype_options_change_the_result_where_jax_changes_it():
    """The four combinations are four different results, not one: each
    rounding point moves the first moments by far more than the tolerance
    above, and moves the port's and JAX's alike.  The tanh layer takes its
    gradient ``1 - h^2`` from the SAVED h: with float32 products, saving in
    bfloat16 changes only what the backward reads."""
    acts = ["tanh", "tanh", "linear"]
    results = {(m, s): _run_both(acts, True, m, s) for m in DTYPES for s in DTYPES}
    L = results[(torch.float32, torch.float32)][3]
    f32 = results[(torch.float32, torch.float32)]
    for key, (outs, port8, metrics, _) in results.items():
        if key == (torch.float32, torch.float32):
            continue
        moved_port = max(np.abs(port8[k] - f32[1][k]).max() for k in range(4 * L, 5 * L))
        moved_jax = max(np.abs(outs[k] - f32[0][k]).max() for k in range(4 * L, 5 * L))
        assert moved_port > 2e-5 and moved_jax > 2e-5, key
        if key[0] == torch.float32:  # forward untouched: the same q, the same td_loss
            np.testing.assert_allclose(metrics, f32[2], rtol=1e-6, atol=1e-7)
    # the bias gradient is the sum of the UNROUNDED dz: with float32 saves the
    # last layer's dz is err * act / B exactly as in float32 products, up to
    # q's own rounding through the bfloat16 forward
    outs, port8, _, _ = results[(torch.bfloat16, torch.bfloat16)]
    np.testing.assert_allclose(port8[5 * L + L - 1], outs[5 * L + L - 1], rtol=2e-5, atol=1e-8)


def test_other_dtypes_raise():
    rng = np.random.default_rng(0)
    _, batch, params8, lr_t, eps_t = _inputs(rng, B=64, D=8, A=4, widths=[16])
    args = (torch.tensor(lr_t), torch.tensor(eps_t), *[torch.tensor(x) for x in batch],
            [torch.tensor(p) for p in params8])
    kw = dict(activations=["relu", "linear"], gamma=0.9, tau=0.1, double_q_learning=True,
              block_size=32)
    with pytest.raises(TypeError, match="matmul_dtype must be torch.float32 or torch.bfloat16"):
        fused_dqn_offline_update(*args, matmul_dtype=torch.float16, **kw)
    with pytest.raises(TypeError, match="save_dtype must be"):
        fused_dqn_offline_update(*args, matmul_dtype=torch.bfloat16, save_dtype=torch.float64, **kw)
    net = FullyConnectedDQN(state_dim=8, action_dim=4, sizes=[16], activations=["relu"])
    with pytest.raises(TypeError, match="matmul_dtype must be"):
        FusedDQNTrainer(q_network=net, minibatch_size=64, block_size=32,
                        matmul_dtype=torch.float16, device="cpu")
    # K2 has no such option: the JAX trainer drops it silently, the port says so
    with pytest.raises(ValueError, match="needs block_size"):
        FusedDQNTrainer(q_network=net, minibatch_size=64, matmul_dtype=torch.bfloat16,
                        device="cpu")
    assert FusedDQNTrainer(q_network=net, minibatch_size=64,
                           device="cpu").matmul_dtype == torch.float32


# ------------------------------------------------------------------ trainer


def _batches(rng, n, B, D, A):
    for _ in range(n):
        mask = (rng.random((B, A)) > 0.2).astype(np.float32)
        mask[:, 0] = 1.0
        yield dict(
            s=rng.normal(size=(B, D)).astype(np.float32),
            ns=rng.normal(size=(B, D)).astype(np.float32),
            a=np.eye(A, dtype=np.float32)[rng.integers(0, A, B)],
            r=rng.normal(size=(B, 1)).astype(np.float32),
            nt=(rng.random((B, 1)) > 0.1).astype(np.float32),
            mask=mask,
        )


def _batch(mod, conv, d):
    return mod.DiscreteDqnInput(
        state=mod.FeatureData(float_features=conv(d["s"])),
        next_state=mod.FeatureData(float_features=conv(d["ns"])),
        action=conv(d["a"]), next_action=conv(d["a"]), reward=conv(d["r"]),
        time_diff=None, step=None, not_terminal=conv(d["nt"]),
        possible_actions_mask=conv(np.ones_like(d["mask"])),
        possible_next_actions_mask=conv(d["mask"]),
    )


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


D, A, SIZES, ACTS = 8, 4, [32, 16], ["leaky_relu", "leaky_relu"]
RL_KW = dict(gamma=0.99, target_update_rate=0.1)
OPT = {"Adam": {"lr": LR}}


def _fused_pair(B, block_size, matmul_dtype):
    jnet = JaxFullyConnectedDQN(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS)
    jtr = JaxFusedDQNTrainer(
        q_network=jnet, rl=JaxRLParameters(**RL_KW), optimizer=OPT, minibatch_size=B,
        block_size=block_size, matmul_dtype=JNP[matmul_dtype], interpret=True)
    js = jtr.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))
    net = FullyConnectedDQN(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS)
    net.load_state_dict(q_network_state_from_flax(
        _np_tree(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, D))))))
    tr = FusedDQNTrainer(
        q_network=net, rl=RLParameters(**RL_KW), optimizer=OPT, minibatch_size=B,
        block_size=block_size, matmul_dtype=matmul_dtype, device="cpu")
    return jnet, jtr, js, net, tr


def test_bf16_trainer_lockstep_with_jax():
    """5 steps of ``FusedDQNTrainer(block_size=64, matmul_dtype=bfloat16)``
    from JAX's init on the same batches.  td_loss per step rtol 2e-4, atol
    2e-5 (the float32 K1 lockstep's tolerance: the loss is a mean over 256
    rows, and a flipped rounding moves it far less than a parameter);
    q_values of the trained nets rtol 0, atol 5 * lr * 0.1: five Adam steps
    can part an unsettled weight by up to 2 * lr each."""
    B = 256
    _, jtr, js, _, tr = _fused_pair(B, 64, torch.bfloat16)
    ps = fused_state_from_arrays(
        *[tuple(np.asarray(x) for x in getattr(js, f)) for f in STATE_FIELDS],
        np.asarray(js.step))
    rng = np.random.default_rng(5)
    losses = []
    for d in _batches(rng, 5, B, D, A):
        js, mj = jtr.train_step(js, _batch(jrlt, jnp.asarray, d))
        ps, mp = tr.train_step(ps, _batch(rlt, torch.tensor, d))
        np.testing.assert_allclose(float(mp["td_loss"]), float(mj["td_loss"]), rtol=2e-4, atol=2e-5)
        losses.append(float(mp["td_loss"]))
    assert int(ps.step) == int(js.step) == 5
    obs = rng.normal(size=(16, D)).astype(np.float32)
    np.testing.assert_allclose(
        tr.q_values(ps, torch.tensor(obs)).numpy(),
        np.asarray(jtr.q_values(js, jnp.asarray(obs))), rtol=0, atol=5 * LR * 0.1)

    # and it is not the float32 trainer: the same batches give another loss
    _, _, _, _, tr32 = _fused_pair(B, 64, torch.float32)
    ps32 = tr32.state_from_q_network()
    d = next(_batches(np.random.default_rng(5), 1, B, D, A))
    _, m32 = tr32.train_step(ps32, _batch(rlt, torch.tensor, d))
    assert abs(float(m32["td_loss"]) - losses[0]) > 1e-5 * losses[0]


@pytest.mark.parametrize("matmul_dtype", DTYPES, ids=_name)
def test_from_dqn_state_matches_jax(matmul_dtype):
    """3 ``DQNTrainer`` steps in JAX, the state carried into the port, then
    ``from_dqn_state`` on both sides: a relayout, so the leaves agree exactly
    and the step is Adam's count.  One fused step from there agrees as a
    lockstep step does (td_loss rtol 2e-4, atol 2e-5)."""
    B = 128
    jnet, jtr, _, net, tr = _fused_pair(B, 64, matmul_dtype)
    jdqn = JaxDQNTrainer(q_network=jnet, rl=JaxRLParameters(**RL_KW), optimizer=OPT)
    jstate = jdqn.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))
    rng = np.random.default_rng(8)
    for d in _batches(rng, 3, B, D, A):
        jstate, _ = jdqn.train_step(jstate, _batch(jrlt, jnp.asarray, d))
    adam = jstate.opt_state[0]
    state = dqn_state_from_arrays(
        _np_tree(jstate.q_params), _np_tree(jstate.q_target_params),
        opt_state_from_arrays(count=np.asarray(adam.count), mu=_np_tree(adam.mu),
                              nu=_np_tree(adam.nu)),
        np.asarray(jstate.step))
    js = jtr.from_dqn_state(jstate)
    ps = tr.from_dqn_state(state)
    assert int(ps.step) == int(js.step) == 3 and ps.step.dtype == torch.int32
    for f in STATE_FIELDS:
        for ours, theirs in zip(getattr(ps, f), getattr(js, f)):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs), err_msg=f)
    # copies: the fused update writes in place, the DQN state stays as it was
    before = {k: v.clone() for k, v in state.q_params.items()}
    d = next(_batches(rng, 1, B, D, A))
    js, mj = jtr.train_step(js, _batch(jrlt, jnp.asarray, d))
    ps, mp = tr.train_step(ps, _batch(rlt, torch.tensor, d))
    np.testing.assert_allclose(float(mp["td_loss"]), float(mj["td_loss"]), rtol=2e-4, atol=2e-5)
    assert int(ps.step) == 4
    for k, v in state.q_params.items():
        assert torch.equal(v, before[k])

    # an amsgrad state is not plain Adam's
    dqn = DQNTrainer(net, optimizer={"Adam": {"lr": LR, "amsgrad": True}}, device="cpu")
    with pytest.raises(ValueError, match="plain Adam"):
        tr.from_dqn_state(dqn.state_from_q_network())
