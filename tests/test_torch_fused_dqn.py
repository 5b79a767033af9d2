"""Parity of the port's fused DQN update (K1, K2) with the JAX package.

The plain PyTorch versions (what a CPU tensor runs) are held to the Pallas
kernels in interpret mode, and the port's FusedDQNTrainer to reagent_tpu's in
lockstep from the same init.  Inputs come from numpy seeds and go to both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.models import FullyConnectedDQN as JaxFullyConnectedDQN
from reagent_tpu.ops.fused_dqn import make_fused_dqn_train_kernel
from reagent_tpu.ops.fused_dqn_offline import make_fused_dqn_offline_kernel
from reagent_tpu.training.fused_dqn_trainer import FusedDQNTrainer as JaxFusedDQNTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.ops.fused_dqn import fused_dqn_update, fused_dqn_update_reference
from reagent_tpu_torch.ops.fused_dqn_offline import (
    fused_dqn_offline_update,
    fused_dqn_offline_update_reference,
)
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.utils.interop import fused_state_from_arrays, q_network_state_from_flax


def _inputs(rng, B, D, A, widths):
    """Batch, params8 (nonzero Adam moments) and step scalars, all numpy."""
    dims = list(zip([D, *widths], [*widths, A]))
    W = [(rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32) for i, o in dims]
    b = [rng.normal(size=(1, o)).astype(np.float32) * 0.1 for _, o in dims]
    Wt = [w + rng.normal(size=w.shape).astype(np.float32) * 0.05 for w in W]
    bt = [x + rng.normal(size=x.shape).astype(np.float32) * 0.05 for x in b]
    mW = [rng.normal(size=w.shape).astype(np.float32) * 1e-3 for w in W]
    mb = [rng.normal(size=x.shape).astype(np.float32) * 1e-3 for x in b]
    vW = [rng.random(size=w.shape).astype(np.float32) * 1e-5 for w in W]
    vb = [rng.random(size=x.shape).astype(np.float32) * 1e-5 for x in b]
    params8 = W + b + Wt + bt + mW + mb + vW + vb
    act = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
    mask = (rng.random((B, A)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    batch = [
        rng.normal(size=(B, D)).astype(np.float32),
        rng.normal(size=(B, D)).astype(np.float32),
        act,
        rng.normal(size=(B, 1)).astype(np.float32),
        (rng.random((B, 1)) > 0.1).astype(np.float32),
        mask,
    ]
    t = 3.0
    lr, b1, b2, eps = 5e-3, 0.9, 0.999, 1e-8
    lr_t = np.float32(lr * np.sqrt(1 - b2**t) / (1 - b1**t))
    eps_t = np.float32(eps * np.sqrt(1 - b2**t))
    return dims, batch, params8, lr_t, eps_t


def _compare(jax_outs, port_params8, port_metrics, L):
    for k, (j, p) in enumerate(zip(jax_outs[: 8 * L], port_params8)):
        np.testing.assert_allclose(
            p.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5, err_msg=f"params8[{k}]")
    np.testing.assert_allclose(
        port_metrics.numpy(), np.asarray(jax_outs[8 * L]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("double_q", [True, False])
def test_k2_plain_version_matches_pallas_kernel(double_q):
    rng = np.random.default_rng(11)
    dims, batch, params8, lr_t, eps_t = _inputs(rng, B=64, D=8, A=4, widths=[32, 16])
    acts = ["leaky_relu", "leaky_relu", "linear"]
    run = make_fused_dqn_train_kernel(
        dims, acts, 64, 0.99, 0.1, double_q, interpret=True)
    outs = run(jnp.float32(lr_t), jnp.float32(eps_t),
               *[jnp.asarray(x) for x in batch], [jnp.asarray(p) for p in params8])

    port8 = [torch.tensor(p) for p in params8]
    calls = fused_dqn_update_reference.calls
    metrics = fused_dqn_update(
        torch.tensor(lr_t), torch.tensor(eps_t), *[torch.tensor(x) for x in batch],
        port8, activations=acts, gamma=0.99, tau=0.1, double_q_learning=double_q)
    assert fused_dqn_update_reference.calls == calls + 1  # CPU takes the plain version
    _compare(outs, port8, metrics, len(dims))


@pytest.mark.parametrize("double_q", [True, False])
def test_k1_plain_version_matches_pallas_kernel(double_q):
    rng = np.random.default_rng(12)
    dims, batch, params8, lr_t, eps_t = _inputs(rng, B=256, D=8, A=4, widths=[32, 16])
    acts = ["relu", "tanh", "linear"]
    run = make_fused_dqn_offline_kernel(
        dims, acts, 256, 0.99, 0.1, double_q, block_size=64, interpret=True)
    outs = run(jnp.float32(lr_t), jnp.float32(eps_t),
               *[jnp.asarray(x) for x in batch], [jnp.asarray(p) for p in params8])

    port8 = [torch.tensor(p) for p in params8]
    calls = fused_dqn_offline_update_reference.calls
    metrics = fused_dqn_offline_update(
        torch.tensor(lr_t), torch.tensor(eps_t), *[torch.tensor(x) for x in batch],
        port8, activations=acts, gamma=0.99, tau=0.1, double_q_learning=double_q,
        block_size=64)
    assert fused_dqn_offline_update_reference.calls == calls + 1
    _compare(outs, port8, metrics, len(dims))


def _batches(rng, n, B, D, A):
    for _ in range(n):
        a = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
        mask = (rng.random((B, A)) > 0.2).astype(np.float32)
        mask[:, 0] = 1.0
        yield dict(
            s=rng.normal(size=(B, D)).astype(np.float32),
            ns=rng.normal(size=(B, D)).astype(np.float32),
            a=a,
            r=rng.normal(size=(B, 1)).astype(np.float32),
            nt=(rng.random((B, 1)) > 0.1).astype(np.float32),
            mask=mask,
        )


def _jax_batch(d):
    return jrlt.DiscreteDqnInput(
        state=jrlt.FeatureData(float_features=jnp.asarray(d["s"])),
        next_state=jrlt.FeatureData(float_features=jnp.asarray(d["ns"])),
        action=jnp.asarray(d["a"]), next_action=jnp.asarray(d["a"]),
        reward=jnp.asarray(d["r"]), time_diff=jnp.ones_like(jnp.asarray(d["r"])),
        step=None, not_terminal=jnp.asarray(d["nt"]),
        possible_actions_mask=jnp.ones_like(jnp.asarray(d["mask"])),
        possible_next_actions_mask=jnp.asarray(d["mask"]),
    )


def _port_batch(d):
    t = {k: torch.tensor(v) for k, v in d.items()}
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(float_features=t["s"]),
        next_state=rlt.FeatureData(float_features=t["ns"]),
        action=t["a"], next_action=t["a"], reward=t["r"],
        time_diff=torch.ones_like(t["r"]), step=None, not_terminal=t["nt"],
        possible_actions_mask=torch.ones_like(t["mask"]),
        possible_next_actions_mask=t["mask"],
    )


@pytest.mark.parametrize("B,block_size", [(64, None), (256, 64)], ids=["K2", "K1"])
def test_trainer_lockstep_with_jax(B, block_size):
    D, A, sizes, acts = 8, 4, [32, 16], ["leaky_relu", "leaky_relu"]
    rl_kw = dict(gamma=0.99, target_update_rate=0.1)
    opt = {"Adam": {"lr": 0.005}}
    jnet = JaxFullyConnectedDQN(state_dim=D, action_dim=A, sizes=sizes, activations=acts)
    jtr = JaxFusedDQNTrainer(
        q_network=jnet, rl=JaxRLParameters(**rl_kw), optimizer=opt,
        minibatch_size=B, block_size=block_size, interpret=True)
    js = jtr.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))

    net = FullyConnectedDQN(state_dim=D, action_dim=A, sizes=sizes, activations=acts)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, D))))
    net.load_state_dict(q_network_state_from_flax(params))
    tr = FusedDQNTrainer(
        q_network=net, rl=RLParameters(**rl_kw), optimizer=opt,
        minibatch_size=B, block_size=block_size, device="cpu")
    ps = fused_state_from_arrays(
        *[tuple(np.asarray(x) for x in getattr(js, f))
          for f in ("W", "b", "Wt", "bt", "mW", "mb", "vW", "vb")],
        np.asarray(js.step))

    rng = np.random.default_rng(5)
    for d in _batches(rng, 5, B, D, A):
        js, mj = jtr.train_step(js, _jax_batch(d))
        ps, mp = tr.train_step(ps, _port_batch(d))
        np.testing.assert_allclose(
            float(mp["td_loss"]), float(mj["td_loss"]), rtol=2e-4, atol=2e-5)
    assert int(ps.step) == int(js.step) == 5
    obs = rng.normal(size=(16, D)).astype(np.float32)
    np.testing.assert_allclose(
        tr.q_values(ps, torch.tensor(obs)).numpy(),
        np.asarray(jtr.q_values(js, jnp.asarray(obs))),
        rtol=5e-4, atol=5e-5)
    # the export copy scores like the trainer
    with torch.no_grad():
        np.testing.assert_allclose(
            tr.export_q_network(ps)(torch.tensor(obs)).numpy(),
            tr.q_values(ps, torch.tensor(obs)).numpy(), rtol=1e-6, atol=1e-6)


def test_mismatched_block_size_raises():
    net = FullyConnectedDQN(state_dim=4, action_dim=2, sizes=[8], activations=["relu"])
    with pytest.raises(ValueError, match="minibatch_size=100.*block_size=64"):
        FusedDQNTrainer(q_network=net, minibatch_size=100, block_size=64, device="cpu")
    rng = np.random.default_rng(0)
    dims, batch, params8, lr_t, eps_t = _inputs(rng, B=96, D=4, A=2, widths=[8])
    with pytest.raises(ValueError, match="block_size=64"):
        fused_dqn_offline_update(
            torch.tensor(lr_t), torch.tensor(eps_t), *[torch.tensor(x) for x in batch],
            [torch.tensor(p) for p in params8], activations=["relu", "linear"],
            gamma=0.9, tau=0.1, double_q_learning=True, block_size=64)
    # a batch of another size than the trainer was built for
    tr = FusedDQNTrainer(q_network=net, minibatch_size=64, block_size=32, device="cpu")
    state = tr.init(torch.Generator().manual_seed(0))
    d = next(_batches(rng, 1, 32, 4, 2))
    with pytest.raises(ValueError, match="minibatch_size=64"):
        tr.train_step(state, _port_batch(d))


def test_sampled_drivers_agree():
    """The packed single-gather driver trains like the per-field gather
    driver given the same generator; both advance the step count."""
    net = FullyConnectedDQN(state_dim=8, action_dim=4, sizes=[16], activations=["leaky_relu"])
    rng = np.random.default_rng(7)
    d = next(_batches(rng, 1, 256, 8, 4))
    dataset = _port_batch(d)

    def run(make):
        tr = FusedDQNTrainer(q_network=net, rl=RLParameters(gamma=0.99, target_update_rate=0.1),
                             optimizer={"Adam": {"lr": 0.01}}, minibatch_size=64,
                             block_size=32, device="cpu")
        state = tr.init(torch.Generator().manual_seed(0))
        return getattr(tr, make)(dataset, num_steps=4)(state, torch.Generator().manual_seed(9))

    s1, m1 = run("make_sampled_train_fn")
    s2, m2 = run("make_packed_sampled_train_fn")
    assert m1["td_loss"].shape == (4,) and int(s1.step) == int(s2.step) == 4
    torch.testing.assert_close(m1["td_loss"], m2["td_loss"], rtol=1e-6, atol=0)
    for w1, w2 in zip(s1.W, s2.W):
        torch.testing.assert_close(w1, w2, rtol=1e-6, atol=0)

    tr = FusedDQNTrainer(q_network=net, minibatch_size=64, device="cpu")
    bad = dataclasses.replace(dataset, reward=dataset.reward[:100])
    with pytest.raises(ValueError, match="num_rows=256"):
        tr.make_sampled_train_fn(bad, num_steps=1)
