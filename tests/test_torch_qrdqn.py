"""The unfused trainer stack against the JAX package: ``DuelingQNetwork`` and
the quantile builders, ``QRDQNTrainer`` and ``DQNTrainer`` in 5-step lockstep
from carried weights and optimizer state, and ``rl_trainer_base`` function by
function.  Inputs come from numpy seeds and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.net_builder import discrete_dqn as jax_dqn_builders
from reagent_tpu.net_builder import quantile_dqn as jax_qr_builders
from reagent_tpu.training import rl_trainer_base as jax_base
from reagent_tpu.training.dqn_trainer import DQNTrainer as JaxDQNTrainer
from reagent_tpu.training.qrdqn_trainer import QRDQNTrainer as JaxQRDQNTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.core.registry import DISCRETE_DQN_NET_BUILDERS, QR_DQN_NET_BUILDERS
from reagent_tpu_torch.gym.policies import discrete_dqn_scorer
from reagent_tpu_torch.net_builder import discrete_dqn as dqn_builders
from reagent_tpu_torch.net_builder import quantile_dqn as qr_builders
from reagent_tpu_torch.training import rl_trainer_base as base
from reagent_tpu_torch.training.dqn_trainer import DQNTrainer
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer
from reagent_tpu_torch.utils.interop import (
    dqn_state_from_arrays,
    flax_from_q_network_state,
    opt_state_from_arrays,
    q_network_state_from_flax,
    qrdqn_state_from_arrays,
    state_to_arrays,
)

D, A, N, B = 6, 3, 7, 32
SIZES, ACTS = [16, 8], ["leaky_relu", "relu"]
ACTIONS = ("a0", "a1", "a2")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(seed, n, with_step=False):
    """Batches with terminal rows (all target atoms equal the reward), some
    next actions impossible and, in row 0, only action 2 possible."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        mask = (rng.random((B, A)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        mask[0] = [0.0, 0.0, 1.0]
        not_terminal = (rng.random((B, 1)) > 0.2).astype(np.float32)
        not_terminal[1] = 0.0
        yield dict(
            s=rng.normal(size=(B, D)).astype(np.float32),
            ns=rng.normal(size=(B, D)).astype(np.float32),
            a=np.eye(A, dtype=np.float32)[rng.integers(0, A, B)],
            na=np.eye(A, dtype=np.float32)[rng.integers(0, A, B)],
            r=rng.normal(size=(B, 1)).astype(np.float32),
            nt=not_terminal,
            mask=mask,
            step=rng.integers(1, 4, (B, 1)).astype(np.int32) if with_step else None,
        )


def _batch(mod, conv, b):
    return mod.DiscreteDqnInput(
        state=mod.FeatureData(float_features=conv(b["s"])),
        next_state=mod.FeatureData(float_features=conv(b["ns"])),
        action=conv(b["a"]), next_action=conv(b["na"]), reward=conv(b["r"]),
        time_diff=None, step=None if b["step"] is None else conv(b["step"]),
        not_terminal=conv(b["nt"]),
        possible_actions_mask=conv(np.ones_like(b["mask"])),
        possible_next_actions_mask=conv(b["mask"]),
    )


def _adam_fields(opt_state):
    """(count, mu, nu, nu_max) of the Adam/amsgrad state in an optax chain."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return dict(count=np.asarray(leaf.count), mu=_np_tree(leaf.mu), nu=_np_tree(leaf.nu),
                        nu_max=_np_tree(leaf.nu_max) if hasattr(leaf, "nu_max") else None)
    raise AssertionError("no Adam state in the optax chain")


def _assert_params_close(ours, theirs, rtol, atol):
    want = q_network_state_from_flax(_np_tree(theirs))
    assert set(ours) == set(want)
    for k in want:
        np.testing.assert_allclose(
            ours[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------------ networks


@pytest.mark.parametrize("family,name,kwargs,out_shape", [
    ("qr", "QuantileFullyConnected", {"num_atoms": N}, (5, A * N)),
    ("qr", "DuelingQuantile", {"num_atoms": N}, (5, A, N)),
    ("dqn", "Dueling", {}, (5, A)),
    ("dqn", "FullyConnected", {}, (5, A)),
])
def test_builders_forward_with_carried_weights(family, name, kwargs, out_shape):
    """Same weights, same input: float32 matmuls of two libraries, rtol 1e-5
    atol 1e-6."""
    jax_mod, port_mod, registry = {
        "qr": (jax_qr_builders, qr_builders, QR_DQN_NET_BUILDERS),
        "dqn": (jax_dqn_builders, dqn_builders, DISCRETE_DQN_NET_BUILDERS),
    }[family]
    cfg = dict(sizes=SIZES, activations=ACTS, **kwargs)
    jnet = getattr(jax_mod, name)(**cfg).build_q_network(None, A, state_dim=D)
    net = registry.build({name: cfg}).build_q_network(None, A, state_dim=D)
    assert type(net).__name__ == type(jnet).__name__
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, D)))
    carried = q_network_state_from_flax(_np_tree(params))
    net.load_state_dict(carried)
    x = np.random.default_rng(0).normal(size=(5, D)).astype(np.float32)
    got = net(torch.tensor(x)).detach().numpy()
    assert got.shape == out_shape
    np.testing.assert_allclose(got, np.asarray(jnet.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    # and back: the flax tree is rebuilt leaf for leaf
    back = flax_from_q_network_state(net.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(params)), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert (jax.tree_util.tree_structure(_np_tree(params))
            == jax.tree_util.tree_structure(back))


def test_fresh_init_follows_the_jax_scheme():
    """Zero biases and gaussian weights of the fan-in scale, drawn from the
    generator (the streams differ, so only the scheme is compared)."""
    net = qr_builders.DuelingQuantile(sizes=[64, 64], activations=["relu", "relu"],
                                      num_atoms=N).build_q_network(None, A, state_dim=D)
    net.reset_parameters(torch.Generator().manual_seed(5))
    first = net.shared.layers[1].weight.clone()
    net.reset_parameters(torch.Generator().manual_seed(5))
    assert torch.equal(first, net.shared.layers[1].weight)
    assert not net.value.layers[0].bias.any()
    assert 0.5 < float(first.detach().std()) / (np.sqrt(2.0) * np.sqrt(2.0 / 64)) < 1.5
    assert net.advantage.layers[1].weight.shape == (A * N, 32)
    assert net.value.layers[1].weight.shape == (N, 32)


# -------------------------------------------------------------- QRDQNTrainer

QR_CASES = {
    "double_q": dict(),
    "single_q": dict(double_q_learning=False),
    "sarsa": dict(rl=dict(maxq_learning=False)),
    "reward_boost": dict(rl=dict(reward_boost={"a0": 0.5, "a2": -1.0})),
    "multi_steps": dict(rl=dict(multi_steps=3), with_step=True),
    "adamw_amsgrad": dict(optimizer={"AdamW": {"lr": 0.003, "amsgrad": True}}),
}


@pytest.mark.parametrize("builder", ["QuantileFullyConnected", "DuelingQuantile"])
@pytest.mark.parametrize("case", sorted(QR_CASES))
def test_qrdqn_trainer_lockstep_with_jax(builder, case):
    """5 train steps from JAX's init.  Parameters, target parameters and the
    Adam moments to rtol 1e-4, atol 1e-5 (float32 sums in another order, fed
    back through 5 amsgrad steps); td_loss and q_values_mean to rtol 1e-5,
    atol 1e-6 per step."""
    spec = dict(QR_CASES[case])
    with_step = spec.pop("with_step", False)
    rl_kw = dict(gamma=0.9, target_update_rate=0.05, **spec.pop("rl", {}))
    optimizer = spec.pop("optimizer", {"Adam": {"lr": 0.003, "amsgrad": True}})
    cfg = dict(sizes=SIZES, activations=ACTS, num_atoms=N)
    jnet = getattr(jax_qr_builders, builder)(**cfg).build_q_network(None, A, state_dim=D)
    jtrainer = JaxQRDQNTrainer(jnet, N, rl=JaxRLParameters(**rl_kw), optimizer=optimizer,
                               action_names=ACTIONS, **spec)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))

    net = getattr(qr_builders, builder)(**cfg).build_q_network(None, A, state_dim=D)
    trainer = QRDQNTrainer(net, N, rl=RLParameters(**rl_kw), optimizer=optimizer,
                           action_names=ACTIONS, device="cpu", **spec)
    state = qrdqn_state_from_arrays(
        _np_tree(jstate.q_params), _np_tree(jstate.q_target_params),
        opt_state_from_arrays(**_adam_fields(jstate.opt_state)), np.asarray(jstate.step))

    for b in _batches(1, 5, with_step):
        jstate, jm = jtrainer.train_step(jstate, _batch(jrlt, jnp.asarray, b))
        before = state
        state, m = trainer.train_step(state, _batch(rlt, torch.tensor, b))
        assert before.q_params is not state.q_params  # a new state, the old one kept
        for key in ("td_loss", "q_values_mean"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    assert int(state.step) == int(jstate.step) == 5
    _assert_params_close(state.q_params, jstate.q_params, 1e-4, 1e-5)
    _assert_params_close(state.q_target_params, jstate.q_target_params, 1e-4, 1e-5)
    theirs = _adam_fields(jstate.opt_state)
    assert int(state.opt_state.count) == int(theirs["count"]) == 5
    for field in ("mu", "nu", "nu_max"):
        want = q_network_state_from_flax(theirs[field])
        for k, v in getattr(state.opt_state, field).items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-7)

    obs = np.random.default_rng(9).normal(size=(4, D)).astype(np.float32)
    q = trainer.q_values(state, torch.tensor(obs))
    assert q.shape == (4, A)
    np.testing.assert_allclose(q.numpy(), np.asarray(jtrainer.q_values(jstate, jnp.asarray(obs))),
                               rtol=1e-4, atol=1e-5)
    # the scorer on the state's parameters gives the same mean over atoms
    scored = discrete_dqn_scorer(net)(state.q_params, torch.tensor(obs))
    if builder == "DuelingQuantile":
        np.testing.assert_allclose(scored.numpy(), q.numpy(), rtol=1e-6, atol=1e-6)
    else:
        assert scored.shape == (4, A * N)  # a flat head has no atom axis to average


def test_qrdqn_fresh_init_trains_and_exports():
    net = qr_builders.QuantileFullyConnected(
        sizes=SIZES, activations=ACTS, num_atoms=N).build_q_network(None, A, state_dim=D)
    trainer = QRDQNTrainer(net, N, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    for k, v in state.q_params.items():
        assert torch.equal(v, state.q_target_params[k]) and v is not state.q_target_params[k]
    losses = []
    for b in _batches(2, 3):
        state, m = trainer.train_step(state, _batch(rlt, torch.tensor, b))
        losses.append(float(m["td_loss"]))
    assert np.isfinite(losses).all()
    exported = trainer.export_q_network(state)
    for k, v in exported.state_dict().items():
        assert torch.equal(v, state.q_params[k])
    arrays = state_to_arrays(state)
    assert arrays["opt_state"]["nu_max"] is None and arrays["opt_state"]["mu"].keys() == state.q_params.keys()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        QRDQNTrainer(net, N, device="cuda")


# ---------------------------------------------------------------- DQNTrainer


@pytest.mark.parametrize("builder", ["FullyConnected", "Dueling"])
@pytest.mark.parametrize("loss", ["mse", "huber"])
def test_dqn_trainer_lockstep_with_jax(loss, builder):
    """5 train steps from JAX's init; tolerances as for the QR-DQN lockstep,
    the reporter arrays exactly (indices) or to rtol 1e-5."""
    rl_kw = dict(gamma=0.9, target_update_rate=0.1, q_network_loss=loss,
                 reward_boost={"a1": 0.25})
    optimizer = {"Adam": {"lr": 0.003}}
    cfg = dict(sizes=SIZES, activations=ACTS)
    jnet = getattr(jax_dqn_builders, builder)(**cfg).build_q_network(None, A, state_dim=D)
    jtrainer = JaxDQNTrainer(jnet, rl=JaxRLParameters(**rl_kw), optimizer=optimizer,
                             action_names=ACTIONS, emit_reporter_arrays=True)
    jstate = jtrainer.init(jax.random.PRNGKey(1), jnp.zeros((1, D)))
    net = getattr(dqn_builders, builder)(**cfg).build_q_network(None, A, state_dim=D)
    trainer = DQNTrainer(net, rl=RLParameters(**rl_kw), optimizer=optimizer,
                         action_names=ACTIONS, emit_reporter_arrays=True, device="cpu")
    state = dqn_state_from_arrays(
        _np_tree(jstate.q_params), _np_tree(jstate.q_target_params),
        opt_state_from_arrays(**_adam_fields(jstate.opt_state)), np.asarray(jstate.step))
    for b in _batches(4, 5):
        jstate, jm = jtrainer.train_step(jstate, _batch(jrlt, jnp.asarray, b))
        state, m = trainer.train_step(state, _batch(rlt, torch.tensor, b))
        assert set(m) == set(jm)
        for key in ("td_loss", "q_values_mean", "q_taken_mean", "reward_mean",
                    "logged_rewards", "model_values"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
        np.testing.assert_array_equal(m["logged_actions"].numpy(), np.asarray(jm["logged_actions"]))
        # the greedy action, wherever rounding cannot decide it (dead relu
        # units leave some rows of a dueling head equal up to the last bit)
        top2 = np.sort(np.asarray(jm["model_values"]), axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-5
        assert clear.sum() > B // 2
        np.testing.assert_array_equal(
            m["model_action_idxs"].numpy()[clear], np.asarray(jm["model_action_idxs"])[clear])
    _assert_params_close(state.q_params, jstate.q_params, 1e-4, 1e-5)
    _assert_params_close(state.q_target_params, jstate.q_target_params, 1e-4, 1e-5)
    obs = np.random.default_rng(9).normal(size=(4, D)).astype(np.float32)
    np.testing.assert_allclose(
        trainer.q_values(state, torch.tensor(obs)).numpy(),
        np.asarray(jtrainer.q_values(jstate, jnp.asarray(obs))), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_trainer_step_matches_the_fused_trainer(double_q):
    """One update from the same weights on the same batch: the autograd
    trainer and the fused update (its plain version on the CPU) agree to
    rtol 1e-4, atol 1e-5."""
    rl = RLParameters(gamma=0.95, target_update_rate=0.1)
    optimizer = {"Adam": {"lr": 0.003}}
    net = dqn_builders.FullyConnected(sizes=SIZES, activations=ACTS).build_q_network(
        None, A, state_dim=D)
    net.reset_parameters(torch.Generator().manual_seed(3))
    unfused = DQNTrainer(net, rl=rl, double_q_learning=double_q, optimizer=optimizer,
                         device="cpu")
    fused = FusedDQNTrainer(net, rl=rl, double_q_learning=double_q, optimizer=optimizer,
                            minibatch_size=B, device="cpu")
    u_state, f_state = unfused.state_from_q_network(), fused.state_from_q_network()
    batch = _batch(rlt, torch.tensor, next(_batches(6, 1)))
    u_state, um = unfused.train_step(u_state, batch)
    f_state, fm = fused.train_step(f_state, batch)
    for key in ("td_loss", "q_values_mean", "q_taken_mean", "reward_mean"):
        np.testing.assert_allclose(float(um[key]), float(fm[key]), rtol=1e-4, atol=1e-5)
    exported = fused.export_q_network(f_state).state_dict()
    for k, v in u_state.q_params.items():
        np.testing.assert_allclose(v.numpy(), exported[k].numpy(), rtol=1e-4, atol=1e-5)


def test_dqn_trainer_unported_options_raise():
    """BCQ and the CPE heads are ported (tests/test_torch_cpe.py); what
    still raises is an incomplete set of them: a BCQ threshold without an
    imitator, one CPE head without the other."""
    net = dqn_builders.FullyConnected(sizes=SIZES, activations=ACTS).build_q_network(
        None, A, state_dim=D)
    with pytest.raises(ValueError, match="bcq_imitator"):
        DQNTrainer(net, bcq_drop_threshold=0.1, device="cpu")
    for kwargs in (dict(reward_network=net), dict(q_network_cpe=net)):
        with pytest.raises(ValueError, match="reward_network and q_network_cpe"):
            DQNTrainer(net, device="cpu", **kwargs)
    DQNTrainer(net, bcq_drop_threshold=0.1, bcq_imitator=net, reward_network=net,
               q_network_cpe=net, device="cpu")


# ----------------------------------------------------------- rl_trainer_base


@pytest.mark.parametrize("double_q", [True, False])
def test_max_q_with_ties_takes_the_first_index(double_q):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    qt = rng.normal(size=(8, 4)).astype(np.float32)
    q[0] = 0.0          # an untrained net: all equal
    qt[0] = 0.0
    q[1, [1, 3]] = 5.0  # two equal maxima
    qt[2, [0, 2]] = 7.0
    mask = (rng.random((8, 4)) > 0.3).astype(np.float32)
    mask[:, 1] = 1.0
    mask[3] = 0.0       # nothing possible: every entry gets the same penalty
    want_q, want_i = jax_base.get_max_q_values_with_target(
        jnp.asarray(q), jnp.asarray(qt), jnp.asarray(mask), double_q)
    got_q, got_i = base.get_max_q_values_with_target(
        torch.tensor(q), torch.tensor(qt), torch.tensor(mask), double_q)
    assert got_q.shape == (8, 1) and got_i.shape == (8, 1)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    got_q2, got_i2 = base.get_max_q_values(torch.tensor(qt), torch.tensor(mask))
    want_q2, want_i2 = jax_base.get_max_q_values(jnp.asarray(qt), jnp.asarray(mask))
    np.testing.assert_array_equal(got_i2.numpy(), np.asarray(want_i2))
    np.testing.assert_array_equal(got_q2.numpy(), np.asarray(want_q2))


def test_boost_discount_loss_and_boost_array():
    rng = np.random.default_rng(1)
    b = next(_batches(7, 1, with_step=True))
    b["td"] = rng.integers(1, 5, (B, 1)).astype(np.float32)
    jb = _batch(jrlt, jnp.asarray, b).replace(time_diff=jnp.asarray(b["td"]))
    tb = _batch(rlt, torch.tensor, b)
    tb.time_diff = torch.tensor(b["td"])

    boosts = base.reward_boost_array({"a0": 1.5, "a2": -0.5}, ACTIONS)
    jboosts = jax_base.reward_boost_array({"a0": 1.5, "a2": -0.5}, ACTIONS)
    np.testing.assert_array_equal(boosts.numpy(), np.asarray(jboosts))
    assert base.reward_boost_array(None, ACTIONS) is None
    assert base.reward_boost_array({"a0": 1.0}, None) is None
    np.testing.assert_allclose(
        base.boost_rewards(tb.reward, tb.action, boosts).numpy(),
        np.asarray(jax_base.boost_rewards(jb.reward, jb.action, jboosts)), rtol=1e-6)
    assert base.boost_rewards(tb.reward, tb.action, None) is tb.reward

    for kwargs in (dict(), dict(use_seq_num_diff_as_time_diff=True), dict(multi_steps=3),
                   dict(use_seq_num_diff_as_time_diff=True, multi_steps=3)):
        got = base.compute_discount_tensor(tb, 0.9, **kwargs)
        want = jax_base.compute_discount_tensor(jb, 0.9, **kwargs)
        assert got.shape == (B, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, err_msg=str(kwargs))

    pred = rng.normal(size=(B, 1)).astype(np.float32) * 2
    target = rng.normal(size=(B, 1)).astype(np.float32) * 2
    pred[0], target[0] = 1.0, 0.0  # |err| == 1: the linear branch
    for name in ("mse", "huber", "smooth_l1"):
        np.testing.assert_allclose(
            float(base.q_network_loss_fn(name)(torch.tensor(pred), torch.tensor(target))),
            float(jax_base.q_network_loss_fn(name)(jnp.asarray(pred), jnp.asarray(target))),
            rtol=1e-6)
    with pytest.raises(ValueError, match="unknown q_network_loss"):
        base.q_network_loss_fn("l1")
    assert base.ACTION_NOT_POSSIBLE_VAL == jax_base.ACTION_NOT_POSSIBLE_VAL
