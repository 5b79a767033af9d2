"""The port's device-resident training loops (``training/scan_loop.py``) and
the q-network's ``compute_dtype``: the four cases of ``tests/test_scan_loop.py``
on the port, K scanned steps of ``DQNTrainer`` and ``QRDQNTrainer`` against
JAX's ``make_scanned_train_fn`` on the same stacked batches, and
``FullyConnectedDQN(compute_dtype=bfloat16)`` against flax's.  Inputs come
from numpy seeds and go to both packages.
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
from reagent_tpu.net_builder import quantile_dqn as jax_qr_builders
from reagent_tpu.training import DQNTrainer as JaxDQNTrainer
from reagent_tpu.training import QRDQNTrainer as JaxQRDQNTrainer
from reagent_tpu.training import make_scanned_train_fn as jax_make_scanned_train_fn
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.net_builder import quantile_dqn as qr_builders
from reagent_tpu_torch.training import (
    DQNTrainer,
    QRDQNTrainer,
    make_sampled_train_fn,
    make_scanned_train_fn,
)
from reagent_tpu_torch.training import scan_loop
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.utils.interop import (
    dqn_state_from_arrays,
    opt_state_from_arrays,
    q_network_state_from_flax,
    qrdqn_state_from_arrays,
)

S, A = 4, 2


def _arrays(seed, B=32, s=S, a=A):
    g = np.random.default_rng(seed)
    mask = (g.random((B, a)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return dict(
        s=g.normal(size=(B, s)).astype(np.float32),
        ns=g.normal(size=(B, s)).astype(np.float32),
        a=np.eye(a, dtype=np.float32)[g.integers(0, a, B)],
        na=np.eye(a, dtype=np.float32)[g.integers(0, a, B)],
        r=g.normal(size=(B, 1)).astype(np.float32),
        nt=(g.random((B, 1)) > 0.1).astype(np.float32),
        mask=mask,
    )


def _batch(mod, conv, d):
    return mod.DiscreteDqnInput(
        state=mod.FeatureData(float_features=conv(d["s"])),
        next_state=mod.FeatureData(float_features=conv(d["ns"])),
        action=conv(d["a"]), next_action=conv(d["na"]), reward=conv(d["r"]),
        time_diff=conv(np.ones_like(d["r"])),
        step=conv(np.ones(d["r"].shape, np.int32)),
        not_terminal=conv(d["nt"]),
        possible_actions_mask=conv(np.ones_like(d["mask"])),
        possible_next_actions_mask=conv(d["mask"]),
    )


def _port_batch(seed, B=32):
    return _batch(rlt, torch.tensor, _arrays(seed, B))


def _trainer():
    q = FullyConnectedDQN(state_dim=S, action_dim=A, sizes=[16], activations=["relu"])
    return DQNTrainer(
        q_network=q, rl=RLParameters(gamma=0.9, target_update_rate=0.1),
        optimizer={"Adam": {"lr": 1e-3}}, device="cpu")


def _init(trainer):
    return trainer.init(torch.Generator().manual_seed(0))


def _stack(values):
    """K batches as one batch whose tensors carry a leading [K] axis."""
    v = values[0]
    if isinstance(v, torch.Tensor):
        return torch.stack(values)
    if dataclasses.is_dataclass(v):
        return dataclasses.replace(v, **{
            f.name: _stack([getattr(x, f.name) for x in values])
            for f in dataclasses.fields(v)})
    return v


def test_scanned_matches_sequential():
    """Exactly K sequential train steps: the same calls on the same slices,
    so the losses and the parameters agree bit for bit."""
    trainer = _trainer()
    K = 5
    batches = [_port_batch(i) for i in range(K)]
    ts_seq = _init(trainer)
    seq_losses = []
    for b in batches:
        ts_seq, m = trainer.train_step(ts_seq, b)
        seq_losses.append(m["td_loss"])
    ts_scan, metrics = make_scanned_train_fn(trainer)(_init(trainer), _stack(batches))
    assert metrics["td_loss"].shape == (K,) and int(ts_scan.step) == K
    assert torch.equal(metrics["td_loss"], torch.stack(seq_losses))
    for k, v in ts_seq.q_params.items():
        assert torch.equal(v, ts_scan.q_params[k])


def test_sampled_matches_manual_gather():
    trainer = _trainer()
    dataset = _port_batch(42, B=256)
    K, MB = 4, 64
    run = make_sampled_train_fn(trainer, dataset, minibatch_size=MB, num_steps=K)
    ts2, metrics = run(_init(trainer), torch.Generator().manual_seed(7))
    assert metrics["td_loss"].shape == (K,)
    assert set(metrics) == {"td_loss", "q_values_mean", "q_taken_mean", "reward_mean"}

    # replay the same index stream manually
    ts_manual = _init(trainer)
    g = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(K):
        idx = torch.randint(0, 256, (MB,), generator=g)
        ts_manual, m = trainer.train_step(
            ts_manual, scan_loop.tree_map(lambda x: x[idx], dataset))
        losses.append(m["td_loss"])
    assert torch.equal(metrics["td_loss"], torch.stack(losses))
    for k, v in ts_manual.q_params.items():
        assert torch.equal(v, ts2.q_params[k])


def test_sampled_rejects_mismatched_leaf():
    """A dataset leaf whose leading dim is not num_rows fails fast with JAX's
    error, not by training on the wrong rows."""
    trainer = _trainer()
    dataset = _port_batch(0, B=32)
    broken = dataclasses.replace(dataset, reward=dataset.reward[:16])
    with pytest.raises(ValueError, match="leading dim num_rows"):
        make_sampled_train_fn(trainer, broken, minibatch_size=4, num_steps=2)


def test_scan_rejects_nonstandard_train_step_signature():
    class OddTrainer:
        def train_step(self, state, batch, rng):
            return state, {}

    with pytest.raises(TypeError, match="standard"):
        make_scanned_train_fn(OddTrainer())
    with pytest.raises(TypeError, match="standard"):
        make_sampled_train_fn(OddTrainer(), _port_batch(0), minibatch_size=4, num_steps=1)


def test_static_leaves_num_rows_and_scalars():
    """``allow_static_leaves`` carries a fixed per-dataset tensor through
    whole, ``num_rows`` names the row count, and a 0-d tensor is never
    gathered."""
    seen = []

    class Recorder:
        def train_step(self, state, batch):
            seen.append(batch)
            return state + 1, {"rows": batch["rows"].max()}

    dataset = {"rows": torch.arange(100), "scale": torch.ones(7), "gamma": torch.tensor(0.9)}
    with pytest.raises(ValueError, match="allow_static_leaves=True"):
        make_sampled_train_fn(Recorder(), dataset, minibatch_size=8, num_steps=1)
    run = make_sampled_train_fn(Recorder(), dataset, minibatch_size=8, num_steps=6,
                                num_rows=10, allow_static_leaves=True)
    # with num_rows=10 the [100] leaf is static too: nothing has 10 rows
    state, metrics = run(torch.zeros(()), torch.Generator().manual_seed(0))
    assert int(state) == 6 and metrics["rows"].shape == (6,)
    assert all(b["scale"].shape == (7,) and b["gamma"].ndim == 0 for b in seen)
    seen.clear()
    run = make_sampled_train_fn(Recorder(), dataset, minibatch_size=8, num_steps=6,
                                allow_static_leaves=True)
    run(torch.zeros(()), torch.Generator().manual_seed(0))
    assert all(b["rows"].shape == (8,) and b["scale"].shape == (7,) for b in seen)
    # num_rows names the row count where the first leaf is not per-row
    seen.clear()
    first_static = {"scale": torch.ones(7), "rows": torch.arange(100)}
    run = make_sampled_train_fn(Recorder(), first_static, minibatch_size=50, num_steps=4,
                                num_rows=100, allow_static_leaves=True)
    _, metrics = run(torch.zeros(()), torch.Generator().manual_seed(1))
    assert all(b["rows"].shape == (50,) and b["scale"].shape == (7,) for b in seen)
    assert 50 < int(metrics["rows"].max()) < 100
    with pytest.raises(ValueError, match="num_rows=10;"):
        make_sampled_train_fn(Recorder(), {"rows": torch.arange(100)}, minibatch_size=5,
                              num_steps=1, num_rows=10)


def _zero_step_loop(entry):
    """Build and run ``entry`` with zero steps."""
    if entry == "make_scanned_train_fn":
        trainer = _trainer()
        empty = scan_loop.tree_map(lambda x: x[None][:0], _port_batch(0))
        return make_scanned_train_fn(trainer)(_init(trainer), empty)
    if entry == "run_sampled_steps":
        return scan_loop.run_sampled_steps(
            lambda s, b: (s, {}), 0, lambda idx: idx, 0, 4, 10, torch.Generator())
    dataset = _port_batch(3, B=64)
    if entry == "make_sampled_train_fn":
        trainer = _trainer()
        run = make_sampled_train_fn(trainer, dataset, minibatch_size=8, num_steps=0)
        return run(_init(trainer), torch.Generator())
    net = FullyConnectedDQN(state_dim=S, action_dim=A, sizes=[16], activations=["relu"])
    tr = FusedDQNTrainer(q_network=net, rl=RLParameters(gamma=0.9, target_update_rate=0.1),
                         optimizer={"Adam": {"lr": 0.01}}, minibatch_size=8, device="cpu")
    run = getattr(tr, entry.split(".")[1])(dataset, num_steps=0)
    return run(tr.state_from_q_network(), torch.Generator())


@pytest.mark.parametrize("entry", [
    "make_scanned_train_fn", "make_sampled_train_fn", "run_sampled_steps",
    "FusedDQNTrainer.make_sampled_train_fn", "FusedDQNTrainer.make_packed_sampled_train_fn"])
def test_zero_steps_raise_value_error(entry):
    """A loop of no steps: JAX's length-0 ``lax.scan`` returns the state and
    ``(0,)`` metrics, but the port learns a step's metric keys only by running
    one, so every entry refuses with a ValueError (not an IndexError from
    stacking no metrics)."""
    with pytest.raises(ValueError, match="at least one step"):
        _zero_step_loop(entry)


def test_fused_trainer_shares_the_loop():
    """``FusedDQNTrainer`` has the standard signature: the generic sampled
    loop drives it like its own ``make_sampled_train_fn``, draw for draw."""
    net = FullyConnectedDQN(state_dim=S, action_dim=A, sizes=[16], activations=["leaky_relu"])
    dataset = _port_batch(3, B=256)

    def trainer():
        return FusedDQNTrainer(
            q_network=net, rl=RLParameters(gamma=0.9, target_update_rate=0.1),
            optimizer={"Adam": {"lr": 0.01}}, minibatch_size=64, block_size=32,
            matmul_dtype=torch.bfloat16, device="cpu")

    tr = trainer()
    own = tr.make_sampled_train_fn(dataset, num_steps=3)
    s1, m1 = own(tr.state_from_q_network(), torch.Generator().manual_seed(4))
    tr = trainer()
    generic = make_sampled_train_fn(tr, dataset, minibatch_size=64, num_steps=3)
    s2, m2 = generic(tr.state_from_q_network(), torch.Generator().manual_seed(4))
    assert torch.equal(m1["td_loss"], m2["td_loss"]) and int(s2.step) == 3
    for a, b in zip(s1.params8(), s2.params8()):
        assert torch.equal(a, b)


# ------------------------------------------------------------ against JAX


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam(opt_state):
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return dict(count=np.asarray(leaf.count), mu=_np_tree(leaf.mu), nu=_np_tree(leaf.nu))
    raise AssertionError("no Adam state in the optax chain")


def _pair(kind):
    """(jax trainer, jax state, port trainer, port state carried from JAX's)."""
    D, NA, N = 6, 3, 7
    rl_kw = dict(gamma=0.9, target_update_rate=0.05)
    opt = {"Adam": {"lr": 0.003}}
    if kind == "DQNTrainer":
        jnet = JaxFullyConnectedDQN(state_dim=D, action_dim=NA, sizes=[16, 8],
                                    activations=["leaky_relu", "relu"])
        net = FullyConnectedDQN(state_dim=D, action_dim=NA, sizes=[16, 8],
                                activations=["leaky_relu", "relu"])
        jtr = JaxDQNTrainer(jnet, rl=JaxRLParameters(**rl_kw), optimizer=opt)
        tr = DQNTrainer(net, rl=RLParameters(**rl_kw), optimizer=opt, device="cpu")
        carry = dqn_state_from_arrays
    else:
        cfg = dict(sizes=[16, 8], activations=["leaky_relu", "relu"], num_atoms=N)
        jnet = jax_qr_builders.QuantileFullyConnected(**cfg).build_q_network(None, NA, state_dim=D)
        net = qr_builders.QuantileFullyConnected(**cfg).build_q_network(None, NA, state_dim=D)
        jtr = JaxQRDQNTrainer(jnet, N, rl=JaxRLParameters(**rl_kw), optimizer=opt)
        tr = QRDQNTrainer(net, N, rl=RLParameters(**rl_kw), optimizer=opt, device="cpu")
        carry = qrdqn_state_from_arrays
    js = jtr.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))
    ps = carry(_np_tree(js.q_params), _np_tree(js.q_target_params),
               opt_state_from_arrays(**_adam(js.opt_state)), np.asarray(js.step))
    return jtr, js, tr, ps, D, NA


@pytest.mark.parametrize("kind", ["DQNTrainer", "QRDQNTrainer"])
def test_scanned_steps_follow_jax(kind):
    """K = 4 scanned steps on the same stacked batches from JAX's init.  The
    tolerances of the 5-step lockstep in ``tests/test_torch_qrdqn.py``:
    td_loss and q_values_mean per step rtol 1e-5, atol 1e-6; parameters and
    target parameters rtol 1e-4, atol 1e-5 (float32 sums in another order,
    fed back through Adam)."""
    jtr, js, tr, ps, D, NA = _pair(kind)
    arrays = [_arrays(10 + k, B=32, s=D, a=NA) for k in range(4)]
    jstacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[_batch(jrlt, jnp.asarray, d) for d in arrays])
    js, jm = jax_make_scanned_train_fn(jtr)(js, jstacked)
    ps, pm = make_scanned_train_fn(tr)(ps, _stack([_batch(rlt, torch.tensor, d) for d in arrays]))
    assert int(ps.step) == int(js.step) == 4
    for key in ("td_loss", "q_values_mean"):
        assert pm[key].shape == (4,)
        np.testing.assert_allclose(pm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    for ours, theirs in ((ps.q_params, js.q_params), (ps.q_target_params, js.q_target_params)):
        want = q_network_state_from_flax(_np_tree(theirs))
        for k in want:
            np.testing.assert_allclose(ours[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_sampled_loop_drives_qrdqn():
    """The sampled loop on a ``QRDQNTrainer`` (its loss goes through the
    quantile-Huber wrapper): K finite losses, K steps, and the same run again
    from the same generator seed."""
    _, _, tr, ps, D, NA = _pair("QRDQNTrainer")
    dataset = _batch(rlt, torch.tensor, _arrays(5, B=128, s=D, a=NA))
    run = make_sampled_train_fn(tr, dataset, minibatch_size=32, num_steps=3)
    s1, m1 = run(ps, torch.Generator().manual_seed(2))
    s2, m2 = run(ps, torch.Generator().manual_seed(2))  # the trainer leaves ps untouched
    assert int(s1.step) == 3 and torch.isfinite(m1["td_loss"]).all()
    assert torch.equal(m1["td_loss"], m2["td_loss"])


# ------------------------------------------------------------ compute_dtype


def test_compute_dtype_bf16_forward_and_step_follow_jax():
    """``FullyConnectedDQN(compute_dtype=bfloat16)``: float32 parameters, each
    layer's input, weight and bias cast to bfloat16, a bfloat16 output.  Both
    libraries round the product and the bias sum to bfloat16 but accumulate in
    their own order, and a flipped rounding is one bfloat16 step: the forward
    agrees to rtol 2^-7 (two steps), atol 2^-7.  One ``DQNTrainer`` step:
    td_loss rtol 2e-3 (a mean over rows of bfloat16-rounded q); the gradient
    reaches the float32 parameters through the cast (the first moment
    ``0.1 * g`` to atol 1e-2 of its largest entry: the gradients themselves
    are bfloat16 values), and one Adam step parts no parameter by more than
    2 * lr."""
    D, NA, B, lr = 8, 4, 64, 0.003
    kw = dict(state_dim=D, action_dim=NA, sizes=[32, 16], activations=["leaky_relu", "tanh"])
    jnet = JaxFullyConnectedDQN(compute_dtype=jnp.bfloat16, **kw)
    net = FullyConnectedDQN(compute_dtype=torch.bfloat16, **kw)
    jparams = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, D)))
    net.load_state_dict(q_network_state_from_flax(_np_tree(jparams)))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    x = np.random.default_rng(0).normal(size=(B, D)).astype(np.float32)
    want = jnet.apply(jparams, jnp.asarray(x))
    got = net(torch.tensor(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)
    # float32 stays the default, and differs
    net32 = FullyConnectedDQN(**kw)
    net32.load_state_dict(net.state_dict())
    assert net32(torch.tensor(x)).dtype == torch.float32
    assert not torch.equal(net32(torch.tensor(x)), got.float())

    rl_kw = dict(gamma=0.9, target_update_rate=0.1)
    opt = {"Adam": {"lr": lr}}
    jtr = JaxDQNTrainer(jnet, rl=JaxRLParameters(**rl_kw), optimizer=opt)
    tr = DQNTrainer(net, rl=RLParameters(**rl_kw), optimizer=opt, device="cpu")
    js = jtr.init(jax.random.PRNGKey(2), jnp.zeros((1, D)))
    ps = dqn_state_from_arrays(
        _np_tree(js.q_params), _np_tree(js.q_target_params),
        opt_state_from_arrays(**_adam(js.opt_state)), np.asarray(js.step))
    d = _arrays(3, B=B, s=D, a=NA)
    js, jm = jtr.train_step(js, _batch(jrlt, jnp.asarray, d))
    ps, pm = tr.train_step(ps, _batch(rlt, torch.tensor, d))
    np.testing.assert_allclose(float(pm["td_loss"]), float(jm["td_loss"]), rtol=2e-3)
    want_mu = q_network_state_from_flax(_adam(js.opt_state)["mu"])
    want_p = q_network_state_from_flax(_np_tree(js.q_params))
    for k, v in ps.opt_state.mu.items():
        assert v.dtype == torch.float32 and ps.q_params[k].dtype == torch.float32
        scale = float(want_mu[k].abs().max())
        assert scale > 0
        np.testing.assert_allclose(v.numpy(), want_mu[k].numpy(), rtol=0, atol=1e-2 * scale,
                                   err_msg=k)
        np.testing.assert_allclose(ps.q_params[k].numpy(), want_p[k].numpy(), rtol=0,
                                   atol=2 * lr, err_msg=k)
    # acting on a reduced-precision net runs the module's own forward
    q = tr.q_values(ps, torch.tensor(x[:4]))
    assert q.shape == (4, NA) and q.dtype == torch.bfloat16


def test_training_package_exports():
    import reagent_tpu_torch.training as training

    assert set(training.__all__) == {
        "make_sampled_train_fn", "make_scanned_train_fn", "DQNTrainer", "DQNTrainerState",
        "QRDQNTrainer", "QRDQNTrainerState", "DiscreteCRRTrainer", "CRRTrainerState",
        "ReinforceTrainer", "ReinforceTrainerState", "PPOTrainer", "PPOTrainerState"}
    assert training.make_sampled_train_fn is scan_loop.make_sampled_train_fn
