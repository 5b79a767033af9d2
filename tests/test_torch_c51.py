"""C51 against the JAX package: the support bit for bit, ``categorical_projection``
on the same targets, ``CategoricalDQN`` and the ``Categorical`` builder,
``C51Trainer`` over five cases with each step held from JAX's state, the
scorers, the ``DiscreteC51DQN`` manager through both packages'
``identify_and_train_network`` and its artifact, and online C51 through the
generic loop.

Inputs come from numpy seeds and go to both packages; weights and optimizer
states are JAX's, carried through ``reagent_tpu_torch.utils.interop``.
Tolerances, float32 on two libraries:
- the support: atol 0 (the same float32 operations in the same order);
- the projected mass: atol 1e-6 (both compute ``b`` with the same float32
  product and sum each atom's mass as two one-hot products, but where one
  atom receives several masses the two libraries add them in another
  order);
- a forward: rtol 1e-5, atol 1e-6;
- a train step from JAX's state: metrics rtol 1e-5 atol 1e-6, every
  parameter, target and Adam moment rtol 1e-5 atol 1e-6 (first moments
  atol 1e-7).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reagent_tpu.model_managers  # noqa: F401 — registers the JAX managers
import reagent_tpu_torch.model_managers  # noqa: F401 — registers managers and builders
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.models.categorical_dqn import CategoricalDQN as JaxCategoricalDQN
from reagent_tpu.net_builder import categorical_dqn as jax_c51_builders
from reagent_tpu.training.c51_trainer import C51Trainer as JaxC51Trainer
from reagent_tpu.training.c51_trainer import (
    categorical_projection as jax_categorical_projection,
)
from reagent_tpu.workflow.training import (
    identify_and_train_network as jax_identify_and_train_network,
)
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.core.registry import CATEGORICAL_DQN_NET_BUILDERS, MODEL_MANAGERS
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.gym.policies import discrete_dqn_scorer
from reagent_tpu_torch.model_managers.discrete import DiscreteC51DQN
from reagent_tpu_torch.models.categorical_dqn import CategoricalDQN, linspace_f32
from reagent_tpu_torch.ops import fused_mlp, nstep_replay
from reagent_tpu_torch.prediction.predictor_wrapper import (
    CategoricalDqnPredictorWrapper,
    load_predictor,
)
from reagent_tpu_torch.training.c51_trainer import C51Trainer, categorical_projection
from reagent_tpu_torch.utils.interop import (
    c51_state_from_arrays,
    opt_state_from_arrays,
    q_network_state_from_flax,
)
from reagent_tpu_torch.workflow.training import identify_and_train_network
from test_torch_gym_batch_rl import _collect
from test_torch_qrdqn import _adam_fields, _np_tree

D, A, N, B = 5, 3, 11, 32
SIZES, ACTS = [16, 8], ["leaky_relu", "relu"]
ACTIONS = ("a0", "a1", "a2")
FWD_TOL = STEP_TOL = dict(rtol=1e-5, atol=1e-6)

# (qmin, qmax, num_atoms): the builder's default, the online and offline
# reference configs, and grids whose interior points round otherwise
SUPPORTS = [(-100.0, 200.0, 51), (0, 200, 51), (0.0, 200.0, 21), (-10.0, 10.0, 51),
            (-3.7, 11.3, 101), (0.1, 0.7, 7), (5.0, -5.0, 11), (0.0, 1.0, 2)]


def _jax_net(qmin=-10.0, qmax=10.0, num_atoms=N):
    return JaxCategoricalDQN(state_dim=D, action_dim=A, num_atoms=num_atoms, qmin=qmin,
                             qmax=qmax, sizes=SIZES, activations=ACTS)


def _net(qmin=-10.0, qmax=10.0, num_atoms=N):
    return CategoricalDQN(state_dim=D, action_dim=A, num_atoms=num_atoms, qmin=qmin,
                          qmax=qmax, sizes=SIZES, activations=ACTS)


def _obs(seed, n=B):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


# ------------------------------------------------------------------ support

@pytest.mark.parametrize("qmin,qmax,num_atoms", SUPPORTS)
def test_support_equals_jax_bit_for_bit(qmin, qmax, num_atoms):
    """The port's support against JAX's as its compiled train step computes
    it (``jnp.linspace`` on constants), with atol 0; and against the eager
    ``jnp.linspace`` where XLA's two evaluations agree (they part on some
    grids: the eager one contracts a product and a sum into an fma)."""
    jnet = _jax_net(qmin, qmax, num_atoms)
    ours = _net(qmin, qmax, num_atoms).support.numpy()
    compiled = np.asarray(jax.jit(lambda: jnet.support)())
    assert ours.dtype == compiled.dtype == np.float32
    np.testing.assert_array_equal(ours, compiled)
    np.testing.assert_array_equal(linspace_f32(qmin, qmax, num_atoms).numpy(), compiled)
    if (qmin, qmax, num_atoms) in SUPPORTS[:3]:
        np.testing.assert_array_equal(ours, np.asarray(jnet.support))


def test_support_is_no_state_dict_entry():
    net = _net()
    assert "support" not in net.state_dict()
    assert set(net.state_dict()) == {f"net.layers.{i}.{p}" for i in range(3)
                                     for p in ("weight", "bias")}


# --------------------------------------------------------------- projection

def _projection_inputs(case, qmin, qmax, num_atoms, seed=0):
    """(next_dist [R, N], target_q [R, N]) of one case, built in numpy."""
    rng = np.random.default_rng(seed)
    support = np.asarray(jax.jit(lambda: _jax_net(qmin, qmax, num_atoms).support)())
    scale = np.float32((qmax - qmin) / (num_atoms - 1))
    R = 24
    logits = rng.normal(size=(R, num_atoms)).astype(np.float32)
    next_dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    if case == "bellman":
        r = rng.normal(0, 3, (R, 1)).astype(np.float32)
        target = r + np.float32(0.99) * support[None, :]
    elif case == "integral_b":
        # r a multiple of the atom spacing and gamma 1: every b is integral,
        # the corner adjustment's case (the top atom's b hits num_atoms - 1)
        k = rng.integers(-3, 4, (R, 1)).astype(np.float32)
        target = k * scale + support[None, :]
    elif case == "terminal":
        # not_terminal 0: every atom collapses onto the reward, on and off the grid
        r = np.concatenate([rng.integers(0, num_atoms, (R // 2, 1)) * scale + qmin,
                            rng.uniform(qmin, qmax, (R - R // 2, 1))]).astype(np.float32)
        target = np.repeat(r, num_atoms, axis=1)
    else:  # clipped: targets beyond both ends of the grid
        target = rng.uniform(qmin - 3 * (qmax - qmin), qmax + 3 * (qmax - qmin),
                             (R, num_atoms)).astype(np.float32)
    return next_dist.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("qmin,qmax,num_atoms", SUPPORTS[:3])
@pytest.mark.parametrize("case", ["bellman", "integral_b", "terminal", "clipped"])
def test_categorical_projection_matches_jax(case, qmin, qmax, num_atoms):
    """The same distributions and targets through both projections, JAX's
    compiled as its train step compiles it: the mass within 1e-6, every
    row's mass still 1."""
    next_dist, target = _projection_inputs(case, qmin, qmax, num_atoms)
    want = np.asarray(jax.jit(jax_categorical_projection, static_argnums=(2, 3, 4))(
        jnp.asarray(next_dist), jnp.asarray(target), qmin, qmax, num_atoms))
    got = categorical_projection(torch.tensor(next_dist), torch.tensor(target), qmin, qmax,
                                 num_atoms).numpy()
    assert got.shape == want.shape == next_dist.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    if case == "terminal":
        # a reward on the grid puts all of its row's mass on that atom
        on_grid = got[: len(got) // 2]
        np.testing.assert_allclose(on_grid.max(1), 1.0, atol=1e-6)


# ----------------------------------------------------------- the network

def test_builder_defaults_and_forward_match_jax():
    """The ``Categorical`` builder's defaults (256, 128, relu, 51 atoms, -100
    to 200) and, from the same weights, ``log_dist`` and E[Z]."""
    jb, b = jax_c51_builders.Categorical(), CATEGORICAL_DQN_NET_BUILDERS.build({"Categorical": {}})
    assert (b.sizes, b.activations, b.num_atoms, b.qmin, b.qmax) == (
        jb.sizes, jb.activations, jb.num_atoms, jb.qmin, jb.qmax) == (
        [256, 128], ["relu", "relu"], 51, -100.0, 200.0)
    cfg = dict(sizes=SIZES, activations=ACTS, num_atoms=N, qmin=-10.0, qmax=10.0)
    jnet = jax_c51_builders.Categorical(**cfg).build_q_network(None, A, state_dim=D)
    net = CATEGORICAL_DQN_NET_BUILDERS.build({"Categorical": cfg}).build_q_network(
        None, A, state_dim=D)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, D)), method="log_dist")
    net.load_state_dict(q_network_state_from_flax(_np_tree(params)))
    x = _obs(1, 7)
    log_dist = net.log_dist(torch.tensor(x)).detach().numpy()
    assert log_dist.shape == (7, A, N)
    np.testing.assert_allclose(
        log_dist, np.asarray(jnet.apply(params, jnp.asarray(x), method="log_dist")), **FWD_TOL)
    q = net(torch.tensor(x)).detach().numpy()
    assert q.shape == (7, A)
    np.testing.assert_allclose(q, np.asarray(jnet.apply(params, jnp.asarray(x))), **FWD_TOL)
    assert net.activations == ["leaky_relu", "relu", "linear"]


# -------------------------------------------------------------- C51Trainer

C51_CASES = {
    "double_q": dict(),
    "single_q": dict(double_q_learning=False),
    "sarsa": dict(rl=dict(maxq_learning=False)),
    "reward_boost_multi_steps": dict(rl=dict(reward_boost={"a0": 0.5, "a2": -1.0},
                                             multi_steps=3), with_step=True),
    "amsgrad_online_grid": dict(optimizer={"Adam": {"lr": 0.003, "amsgrad": True}},
                                qmin=0, qmax=200, num_atoms=51),
}


def _batches(seed, n, with_step=False, reward_scale=1.0):
    """Batches with terminal rows, some next actions impossible and, in row
    0, only action 2 possible."""
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
            r=(rng.normal(size=(B, 1)) * reward_scale).astype(np.float32),
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


def carry_c51_state(jstate, device="cpu"):
    """The port's ``C51TrainerState`` from a JAX one."""
    return c51_state_from_arrays(
        _np_tree(jstate.q_params), _np_tree(jstate.q_target_params),
        opt_state_from_arrays(**_adam_fields(jstate.opt_state), device=device),
        np.asarray(jstate.step), device)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


def assert_c51_state_close(state, jstate, tol=STEP_TOL):
    for name in ("q_params", "q_target_params"):
        want = q_network_state_from_flax(_np_tree(getattr(jstate, name)))
        got = getattr(state, name)
        assert set(got) == set(want), name
        for k in want:
            _close(got[k], want[k], tol, f"{name} {k}")
    theirs = _adam_fields(jstate.opt_state)
    assert int(state.opt_state.count) == int(theirs["count"])
    for field in ("mu", "nu", "nu_max"):
        if theirs[field] is None:
            assert getattr(state.opt_state, field) is None, field
            continue
        want = q_network_state_from_flax(theirs[field])
        for k, v in getattr(state.opt_state, field).items():
            _close(v, want[k], dict(rtol=tol["rtol"], atol=1e-7), f"{field} {k}")
    assert int(state.step) == int(jstate.step)


def c51_trainers(case, device="cpu"):
    """(JAX trainer, its init state, the port's trainer) of one case."""
    spec = dict(C51_CASES[case])
    spec.pop("with_step", None)
    rl_kw = dict(gamma=0.9, target_update_rate=0.2, **spec.pop("rl", {}))
    optimizer = spec.pop("optimizer", {"Adam": {"lr": 0.003}})
    grid = {k: spec.pop(k) for k in ("qmin", "qmax", "num_atoms") if k in spec}
    jtrainer = JaxC51Trainer(_jax_net(**grid), rl=JaxRLParameters(**rl_kw), optimizer=optimizer,
                             action_names=ACTIONS, **spec)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))
    trainer = C51Trainer(_net(**grid), rl=RLParameters(**rl_kw), optimizer=optimizer,
                         action_names=ACTIONS, device=device, **spec)
    return jtrainer, jstate, trainer


@pytest.mark.parametrize("case", list(C51_CASES))
def test_c51_trainer_each_step_from_jax_state(case):
    """5 train steps, each started on the port from JAX's state of that step
    (a free run would let one ulp move a double-Q argmax or an atom's mass
    and the two trajectories part); every metric and the whole new state
    against JAX's step."""
    jtrainer, jstate, trainer = c51_trainers(case)
    reward_scale = 30.0 if "num_atoms" in C51_CASES[case] else 1.0
    for i, b in enumerate(_batches(1, 5, C51_CASES[case].get("with_step", False),
                                   reward_scale)):
        state = carry_c51_state(jstate)
        before = {k: v.clone() for k, v in state.q_params.items()}
        jstate, jm = jtrainer.train_step(jstate, _batch(jrlt, jnp.asarray, b))
        new_state, m = trainer.train_step(state, _batch(rlt, torch.tensor, b))
        assert m.keys() == jm.keys() == {"td_loss", "q_values_mean", "reward_mean"}
        for key in jm:
            _close(m[key], jm[key], STEP_TOL, f"step {i} {key}")
        assert_c51_state_close(new_state, jstate)
        # a new state; the one given is untouched
        assert all(torch.equal(before[k], v) for k, v in state.q_params.items())
    assert int(new_state.step) == 5


def test_c51_free_run_trains_and_q_values_go_through_k3():
    """A fresh init fits one batch for 5 steps with falling loss; ``q_values``
    and the DQN scorer (on the state's parameter dict) score E[Z] through
    K3's plain version on the CPU, one call each, equal to the module's own
    forward."""
    _, _, trainer = c51_trainers("double_q")
    state = trainer.init(torch.Generator().manual_seed(0))
    losses = []
    batch = _batch(rlt, torch.tensor, next(_batches(2, 1)))
    for _ in range(5):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["td_loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    obs = torch.tensor(_obs(9, 6))
    calls = fused_mlp.fused_mlp_forward_reference.calls
    q = trainer.q_values(state, obs)
    scored = discrete_dqn_scorer(trainer.q_network)(state.q_params, obs)
    assert fused_mlp.fused_mlp_forward_reference.calls - calls == 2
    own = trainer.export_q_network(state)(obs).detach()
    assert q.shape == (6, A)
    torch.testing.assert_close(q, own, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(scored, q, rtol=0, atol=0)


# ------------------------------------------------------------- the manager

MODEL = {
    "DiscreteC51DQN": {
        "trainer_param": {
            "actions": ["0", "1"],
            "rl": {"gamma": 0.99, "target_update_rate": 0.1},
            "optimizer": {"Adam": {"lr": 0.002}},
            "minibatch_size": 128,
        },
        "net_builder": {"Categorical": {"sizes": [16, 8], "activations": ["relu", "relu"],
                                        "num_atoms": 21, "qmin": 0.0, "qmax": 200.0}},
    }
}


def _carry_jax_c51_init(self, trainer, generator, state_dim):
    """The manager hook: JAX's workflow init (``trainer.init(PRNGKey(0),
    zeros)``) of the manager's net, in the port's module."""
    spec = dict(self.net_builder["Categorical"])
    jnet = jax_c51_builders.Categorical(**spec).build_q_network(
        None, len(self.action_names), state_dim=state_dim)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, state_dim)), method="log_dist")
    trainer.q_network.load_state_dict(q_network_state_from_flax(_np_tree(params)))
    return trainer.state_from_q_network()


def test_c51_manager_builds_the_jax_managers_trainer():
    manager = MODEL_MANAGERS.build(copy.deepcopy(MODEL))
    assert isinstance(manager, DiscreteC51DQN)
    assert isinstance(MODEL_MANAGERS.build({"DiscreteC51DQN": {}}).net_builder, dict)
    assert MODEL_MANAGERS.build({"DiscreteC51DQN": {}}).net_builder == {"Categorical": {}}
    from reagent_tpu_torch.core.parameters import (
        NormalizationData,
        NormalizationKey,
        NormalizationParameters,
    )
    norm = {NormalizationKey.STATE: NormalizationData(dense_normalization_parameters={
        i: NormalizationParameters(feature_type="CONTINUOUS", mean=0.0, stddev=1.0)
        for i in range(4)})}
    trainer = manager.build_trainer(norm, device="cpu")
    assert isinstance(trainer, C51Trainer)
    net = trainer.q_network
    assert (net.state_dim, net.action_dim, net.num_atoms, net.qmin, net.qmax) == (4, 2, 21, 0.0,
                                                                                  200.0)
    assert (trainer.gamma, trainer.tau, trainer.double_q_learning) == (0.99, 0.1, True)


def test_c51_workflow_matches_jax_and_its_artifact_round_trips(tmp_path, monkeypatch):
    """Both packages' ``identify_and_train_network`` with the
    ``DiscreteC51DQN`` block on 1,200 random CartPole transitions (2 epochs)
    from JAX's init: the last ``td_loss`` within rtol 1e-4 (the workflow
    tolerance of ``tests/test_torch_discrete_crr.py``); the artifact keeps
    JAX's manifest keys, and its ``model.pt`` scores raw rows as the
    in-process serving module does; ``load_predictor`` refuses it, as JAX's
    cannot load it either."""
    _, table = _collect(str(tmp_path), "torch", 1200, seed=3)
    monkeypatch.setattr(DiscreteC51DQN, "init_trainer_state", _carry_jax_c51_init,
                        raising=False)
    captured = {}
    build = DiscreteC51DQN.build_serving_module

    def capture(self, trainer, trainer_state, norm):
        captured["serving"] = build(self, trainer, trainer_state, norm)
        return captured["serving"]

    monkeypatch.setattr(DiscreteC51DQN, "build_serving_module", capture)
    split = dict(table_sample=95.0, eval_table_sample=5.0)
    ours = identify_and_train_network(
        TableSpec(path=table, **split), copy.deepcopy(MODEL), num_epochs=2,
        output_dir=str(tmp_path / "torch_out"), device="cpu")
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table, **split), copy.deepcopy(MODEL), num_epochs=2,
        output_dir=str(tmp_path / "jax_out"))
    assert ours.logger_data["train_steps"] > 0
    assert ours.training_report.cpe_details is None is theirs.training_report.cpe_details
    np.testing.assert_allclose(ours.training_report.td_loss, theirs.training_report.td_loss,
                               rtol=1e-4, atol=1e-5)

    path = ours.output_paths["default_model"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(theirs.output_paths["default_model"], "manifest.json")) as f:
        assert manifest == json.load(f) == {"model_type": "categorical_dqn",
                                            "action_names": ["0", "1"]}
    forward = CategoricalDqnPredictorWrapper.load(path)
    rng = np.random.default_rng(0)
    values = rng.normal(size=(64, 4)).astype(np.float32)
    presence = np.ones((64, 4), bool)
    names, q = forward(values, presence)
    _, live = captured["serving"](torch.tensor(values), torch.tensor(presence))
    assert names == ["0", "1"] and q.shape == (64, 2)
    np.testing.assert_allclose(q, live.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="categorical_dqn"):
        load_predictor(path)


# ------------------------------------------------------- online, generic loop

def test_online_c51_runs_through_the_generic_loop():
    """``tests/test_gym_all_algos.py``'s online C51 flow at a small size: the
    softmax acts on E[Z] through the K3 scorer (one call a step), each
    sample takes its n-step rewards from K4, and the loop records td_loss."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.replay import ReplayBuffer

    env = CartPole(max_steps=50, device="cpu")
    net = CategoricalDQN(state_dim=4, action_dim=2, num_atoms=51, qmin=0, qmax=200,
                         sizes=[16, 8], activations=["leaky_relu", "leaky_relu"])
    trainer = C51Trainer(net, rl=RLParameters(gamma=0.99, target_update_rate=0.2),
                         optimizer={"Adam": {"lr": 0.003}}, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=512, update_horizon=1, gamma=0.99, device="cpu")
    rs = rb.init(observation=torch.zeros(4), action=torch.tensor(0, dtype=torch.int32),
                 reward=torch.tensor(0.0), terminal=torch.tensor(False))
    gen = torch.Generator().manual_seed(1)
    rs = prefill_replay_buffer(env, rb, rs, gen, num_steps=200)
    sampler = SoftmaxActionSampler()

    def policy_act(ts, obs, generator):
        out = sampler.sample_action(trainer.q_values(ts, obs[None]), generator)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    calls = (fused_mlp.fused_mlp_forward_reference.calls,
             nstep_replay.nstep_rewards_reference.calls)
    state, rs, aux = run_online_training(
        env, trainer, state, rb, rs, policy_act, lambda d: make_discrete_dqn_batch(d, 2), gen,
        OnlineLoopConfig(num_steps=30, minibatch_size=32))
    assert (fused_mlp.fused_mlp_forward_reference.calls - calls[0],
            nstep_replay.nstep_rewards_reference.calls - calls[1]) == (30, 30)
    assert aux["td_losses"].shape == (30,) and bool(torch.isfinite(aux["td_losses"]).all())
    assert int(state.step) == 30

    def greedy(ts, obs, generator):
        return torch.argmax(trainer.q_values(ts, obs), dim=1).to(torch.int32)

    returns = evaluate_policy(env, greedy, state, gen, num_episodes=4)
    assert returns.shape == (4,) and bool((returns >= 1).all())


def test_chip_smoke_dqn_family_configs_are_the_references():
    """``chip_smoke.py``'s C51 and parametric phases run the reference tests'
    configurations at their widths; only depth is cut."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test",
        os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    on = chip_smoke.DQN_FAMILY_ONLINE
    # tests/test_gym_all_algos.py:76-94
    c51 = on["C51"]
    assert (c51["widths"], c51["act"], c51["atoms"], c51["qmin"], c51["qmax"], c51["B"],
            c51["gamma"], c51["tau"], c51["optimizer"], c51["maxq"], c51["full_prefill"],
            c51["full_steps"]) == ([128, 64], "leaky_relu", 51, 0, 200, 256, 0.99, 0.2,
                                   {"Adam": {"lr": 0.003}}, True, 3000, 15_000)
    # :120-147 and :261-288
    for name, maxq in (("parametric DQN", True), ("parametric SARSA", False)):
        p = on[name]
        assert (p["widths"], p["act"], p["B"], p["gamma"], p["tau"], p["optimizer"], p["maxq"],
                p["full_prefill"], p["full_steps"]) == (
            [128, 64], "leaky_relu", 512, 0.99, 0.1, {"Adam": {"lr": 0.001, "amsgrad": True}},
            maxq, 10_000, 20_000)
    for cfg in on.values():
        assert cfg["prefill"] <= min(1000, cfg["full_prefill"])
        assert cfg["steps"] <= cfg["full_steps"]
    assert (chip_smoke.DQN_FAMILY_CAPACITY, chip_smoke.DQN_FAMILY_BAR) == (50_000, 100.0)
    off = chip_smoke.DQN_FAMILY_OFFLINE
    # tests/test_model_managers_all.py:75-96
    assert (off["C51"]["transitions"], off["C51"]["seed"], off["C51"]["full_epochs"]) == (
        3000, 11, 2)
    assert off["C51"]["model"] == {"DiscreteC51DQN": {
        "trainer_param": {"actions": ["0", "1"],
                          "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                          "optimizer": {"Adam": {"lr": 0.002}}, "minibatch_size": 512},
        "net_builder": {"Categorical": {"sizes": [64, 64], "activations": ["relu", "relu"],
                                        "num_atoms": 21, "qmin": 0.0, "qmax": 200.0}}}}
    # tests/test_offline_managers.py:16-29, :59-75
    p = off["parametric DQN"]
    assert (p["transitions"], p["seed"], p["full_epochs"]) == (10_000, 3, 10)
    assert p["model"] == {"ParametricDQN": {
        "trainer_param": {"actions": ["0", "1"],
                          "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                          "optimizer": {"Adam": {"lr": 0.003}}},
        "net_builder": {"FullyConnected": {"sizes": [64, 64],
                                           "activations": ["relu", "relu"]}}}}
    for cfg in off.values():
        assert cfg["epochs"] <= cfg["full_epochs"]
