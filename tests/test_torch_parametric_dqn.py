"""Parametric DQN against the JAX package: ``ParametricDqnInput`` and
``get_tiled_batch``, ``ParametricDuelingQNetwork``, ``ParametricDQNTrainer``
(max-Q double and single, SARSA, with and without the reward network) with
each step held from JAX's state, ``make_parametric_dqn_batch`` and
``parametric_dqn_scorer`` element by element, the parametric evaluation page
as ``tests/test_cpe.py::test_parametric_dqn_edp`` holds JAX's, the
``ParametricDQN`` manager through both packages' ``identify_and_train_network``
and online parametric DQN and SARSA through the generic loop.

Inputs come from numpy seeds and go to both packages; weights and optimizer
states are JAX's, carried through ``reagent_tpu_torch.utils.interop``.
Tolerances, float32 on two libraries: a forward rtol 1e-5 atol 1e-6; a
train step from JAX's state, every metric and every parameter, target,
reward-network parameter and Adam moment rtol 1e-5 atol 1e-6 (first
moments atol 1e-7); the page's arrays rtol 1e-5 atol 1e-6 (propensities
rtol 1e-5 atol 1e-6 after a softmax at temperature 0.5); the batch makers'
and the scorer's tiling exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import reagent_tpu.model_managers  # noqa: F401 — registers the JAX managers
import reagent_tpu_torch.model_managers  # noqa: F401 — registers managers and builders
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.evaluation.evaluation_data_page import (
    EvaluationDataPage as JaxEvaluationDataPage,
)
from reagent_tpu.gym.policies.scorers import parametric_dqn_scorer as jax_parametric_scorer
from reagent_tpu.gym.preprocessors import make_parametric_dqn_batch as jax_make_batch
from reagent_tpu.model_managers.parametric_dqn import (
    _ParametricFromDiscreteBatchPreprocessor as JaxParametricBatchPreprocessor,
)
from reagent_tpu.models.critic import FullyConnectedCritic as JaxCritic
from reagent_tpu.models.dueling_q_network import (
    ParametricDuelingQNetwork as JaxParametricDuelingQNetwork,
)
from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
from reagent_tpu.training.parametric_dqn_trainer import (
    ParametricDQNTrainer as JaxParametricDQNTrainer,
)
from reagent_tpu.workflow.training import (
    identify_and_train_network as jax_identify_and_train_network,
)
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import (
    NormalizationData,
    NormalizationKey,
    NormalizationParameters,
    RLParameters,
)
from reagent_tpu_torch.core.registry import MODEL_MANAGERS
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.evaluation import EvaluationDataPage
from reagent_tpu_torch.evaluation.doubly_robust_estimator import DoublyRobustEstimator
from reagent_tpu_torch.gym.policies import parametric_dqn_scorer
from reagent_tpu_torch.gym.preprocessors import make_parametric_dqn_batch
from reagent_tpu_torch.model_managers.parametric_dqn import (
    ParametricDQN,
    _ParametricFromDiscreteBatchPreprocessor,
)
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.models.dueling_q_network import ParametricDuelingQNetwork
from reagent_tpu_torch.ops import fused_mlp, nstep_replay
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training.parametric_dqn_trainer import ParametricDQNTrainer
from reagent_tpu_torch.utils.interop import (
    PARAMETRIC_DUELING_SCOPES,
    opt_state_from_arrays,
    parametric_dqn_state_from_arrays,
    q_network_state_from_flax,
)
from reagent_tpu_torch.workflow.training import identify_and_train_network
from test_torch_gym_batch_rl import _collect
from test_torch_qrdqn import _adam_fields, _np_tree

D, A, B = 5, 3, 32
SIZES, ACTS = [16, 8], ["leaky_relu", "relu"]
FWD_TOL = STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, tol=FWD_TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


# -------------------------------------------------------------- types, model

def test_get_tiled_batch_repeats_each_row_as_jax():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = rlt.FeatureData(torch.tensor(x)).get_tiled_batch(3).float_features.numpy()
    want = np.asarray(jrlt.FeatureData(float_features=jnp.asarray(x)).get_tiled_batch(3)
                      .float_features)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:3], np.repeat(x[:1], 3, axis=0))  # [s0, s0, s0, s1, ...]


def test_parametric_dueling_forward_matches_jax():
    """``ParametricDuelingQNetwork`` from JAX's weights (its scopes
    ``FullyConnectedNetwork_0/1/2`` are the state embedding, the value head
    and the advantage head), beside ``tests/test_models.py::test_parametric_dueling``."""
    jnet = JaxParametricDuelingQNetwork(state_dim=D, action_dim=A, layers=[16, 8],
                                        activations=["relu", "relu"])
    params = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, D)), jnp.zeros((1, A)))
    net = ParametricDuelingQNetwork(state_dim=D, action_dim=A, layers=[16, 8],
                                    activations=["relu", "relu"])
    net.load_state_dict(q_network_state_from_flax(_np_tree(params),
                                                  scopes=PARAMETRIC_DUELING_SCOPES))
    assert net.advantage.layers[0].weight.shape == (4, 8 + A)
    assert net.value.layers[1].weight.shape == (1, 4)
    rng = np.random.default_rng(0)
    s = rng.normal(size=(6, D)).astype(np.float32)
    a = np.eye(A, dtype=np.float32)[rng.integers(0, A, 6)]
    q = net(torch.tensor(s), torch.tensor(a))
    assert q.shape == (6, 1)
    _close(q, jnet.apply(params, jnp.asarray(s), jnp.asarray(a)))


# ---------------------------------------------------- ParametricDQNTrainer

PDQN_CASES = {
    "double_q": dict(),
    "single_q": dict(double_q_learning=False),
    "sarsa": dict(rl=dict(maxq_learning=False)),
    "double_q_reward_net": dict(reward=True),
    "sarsa_reward_net_huber": dict(rl=dict(maxq_learning=False, q_network_loss="huber"),
                                   reward=True),
    "amsgrad_online": dict(optimizer={"Adam": {"lr": 0.001, "amsgrad": True}}),
}


def _critic(cls):
    return cls(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS)


def _batches(seed, n):
    """Batches with one-hot actions, every action offered as a possible next
    action (``tile(eye(A), (B, 1))``) but some masked, only action 2 in row
    0, terminal rows and logged next actions."""
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
            nt=not_terminal, mask=mask,
            pa=np.tile(np.eye(A, dtype=np.float32), (B, 1)))


def _batch(mod, conv, b):
    return mod.ParametricDqnInput(
        state=mod.FeatureData(float_features=conv(b["s"])),
        next_state=mod.FeatureData(float_features=conv(b["ns"])),
        action=mod.FeatureData(float_features=conv(b["a"])),
        next_action=mod.FeatureData(float_features=conv(b["na"])),
        possible_actions=mod.FeatureData(float_features=conv(b["pa"])),
        possible_actions_mask=conv(np.ones_like(b["mask"])),
        possible_next_actions=mod.FeatureData(float_features=conv(b["pa"])),
        possible_next_actions_mask=conv(b["mask"]),
        reward=conv(b["r"]), time_diff=conv(np.ones_like(b["r"])), step=None,
        not_terminal=conv(b["nt"]))


def _opt(jopt, device="cpu"):
    return opt_state_from_arrays(**_adam_fields(jopt), device=device)


def carry_parametric_state(jstate, device="cpu"):
    """The port's ``ParametricDQNTrainerState`` from a JAX one."""
    reward = jstate.reward_params is not None
    return parametric_dqn_state_from_arrays(
        _np_tree(jstate.q_params), _np_tree(jstate.q_target_params), _opt(jstate.opt_state, device),
        np.asarray(jstate.step), device,
        reward_params=_np_tree(jstate.reward_params) if reward else None,
        reward_opt_state=_opt(jstate.reward_opt_state, device) if reward else None)


def assert_parametric_state_close(state, jstate, tol=STEP_TOL):
    for name in ("q_params", "q_target_params", "reward_params"):
        jtree = getattr(jstate, name)
        if jtree is None:
            assert getattr(state, name) is None, name
            continue
        want, got = q_network_state_from_flax(_np_tree(jtree)), getattr(state, name)
        assert set(got) == set(want), name
        for k in want:
            _close(got[k], want[k], tol, f"{name} {k}")
    for name in ("opt_state", "reward_opt_state"):
        jopt = getattr(jstate, name)
        if jopt is None:
            assert getattr(state, name) is None, name
            continue
        theirs, ours = _adam_fields(jopt), getattr(state, name)
        assert int(ours.count) == int(theirs["count"]), name
        for field in ("mu", "nu", "nu_max"):
            if theirs[field] is None:
                assert getattr(ours, field) is None, field
                continue
            want = q_network_state_from_flax(theirs[field])
            for k, v in getattr(ours, field).items():
                _close(v, want[k], dict(rtol=tol["rtol"], atol=1e-7), f"{name} {field} {k}")
    assert int(state.step) == int(jstate.step)


def parametric_trainers(case, device="cpu"):
    """(JAX trainer, its init state, the port's trainer) of one case."""
    spec = dict(PDQN_CASES[case])
    reward = spec.pop("reward", False)
    rl_kw = dict(gamma=0.9, target_update_rate=0.1, **spec.pop("rl", {}))
    optimizer = spec.pop("optimizer", {"Adam": {"lr": 0.003}})
    jtrainer = JaxParametricDQNTrainer(
        _critic(JaxCritic), rl=JaxRLParameters(**rl_kw), optimizer=optimizer,
        reward_network=_critic(JaxCritic) if reward else None, **spec)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), jnp.zeros((1, A)))
    trainer = ParametricDQNTrainer(
        _critic(FullyConnectedCritic), rl=RLParameters(**rl_kw), optimizer=optimizer,
        reward_network=_critic(FullyConnectedCritic) if reward else None, device=device, **spec)
    return jtrainer, jstate, trainer


@pytest.mark.parametrize("case", list(PDQN_CASES))
def test_parametric_trainer_each_step_from_jax_state(case):
    """5 train steps, each started on the port from JAX's state of that step
    (a 2-ulp tie in the max over the tiled next actions would otherwise part
    the trajectories); every metric and the whole new state against JAX's."""
    jtrainer, jstate, trainer = parametric_trainers(case)
    keys = {"td_loss", "q_mean"} | ({"reward_loss"} if PDQN_CASES[case].get("reward") else set())
    for i, b in enumerate(_batches(1, 5)):
        state = carry_parametric_state(jstate)
        before = {k: v.clone() for k, v in state.q_params.items()}
        jstate, jm = jtrainer.train_step(jstate, _batch(jrlt, jnp.asarray, b))
        new_state, m = trainer.train_step(state, _batch(rlt, torch.tensor, b))
        assert m.keys() == jm.keys() == keys
        for key in jm:
            _close(m[key], jm[key], STEP_TOL, f"step {i} {key}")
        assert_parametric_state_close(new_state, jstate)
        assert all(torch.equal(before[k], v) for k, v in state.q_params.items())
    assert int(new_state.step) == 5


def test_parametric_free_run_trains_with_its_reward_network():
    """A fresh init (q-network, then the reward network, from one generator)
    fits one batch for 5 steps: both losses fall."""
    *_, trainer = parametric_trainers("double_q_reward_net")
    state = trainer.init(torch.Generator().manual_seed(0))
    assert not torch.equal(state.q_params["net.layers.0.weight"],
                           state.reward_params["net.layers.0.weight"])
    batch = _batch(rlt, torch.tensor, next(_batches(2, 1)))
    losses = []
    for _ in range(5):
        state, m = trainer.train_step(state, batch)
        losses.append((float(m["td_loss"]), float(m["reward_loss"])))
    assert np.isfinite(losses).all()
    assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1]


# ------------------------------------------------- batch makers and scorer

def test_make_parametric_dqn_batch_equals_jax():
    """The same replay sample through both batch makers: every field equal,
    element by element (the possible actions ``[e0, e1, e2, e0, ...]``)."""
    rng = np.random.default_rng(0)
    sample = dict(state=rng.normal(size=(B, 4)).astype(np.float32),
                  next_state=rng.normal(size=(B, 4)).astype(np.float32),
                  action=rng.integers(0, A, (B,)).astype(np.int32),
                  next_action=rng.integers(0, A, (B,)).astype(np.int32),
                  reward=rng.normal(size=(B,)).astype(np.float32),
                  terminal=rng.random(B) > 0.8, step=np.ones((B,), np.int32))
    ours = make_parametric_dqn_batch({k: torch.tensor(v) for k, v in sample.items()}, A)
    theirs = jax_make_batch({k: jnp.asarray(v) for k, v in sample.items()}, A)
    for name in ("state", "next_state", "action", "next_action", "possible_actions",
                 "possible_next_actions"):
        got, want = getattr(ours, name).float_features, getattr(theirs, name).float_features
        assert got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    for name in ("possible_actions_mask", "possible_next_actions_mask", "reward", "time_diff",
                 "step", "not_terminal"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)), err_msg=name)
    np.testing.assert_array_equal(ours.possible_actions.float_features[:2 * A].numpy(),
                                  np.tile(np.eye(A), (2, 1)))


class _Recorder(nn.Module):
    """A (state, action) module that records its inputs and returns a
    distinct value per row: the scorer's tiling laid bare."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))
        self.seen = []

    def forward(self, state, action):
        self.seen.append((state.clone(), action.clone()))
        return (state.sum(1, keepdim=True) * 10 + action.argmax(1, keepdim=True)) * self.w


def test_parametric_scorer_tiles_and_scores_as_jax():
    """The scorer's (state, action) rows equal JAX's tiling element by
    element; on a critic, the scores equal JAX's within the forward tolerance
    through K3's plain version (one call for all the rows)."""
    obs = np.random.default_rng(1).normal(size=(6, D)).astype(np.float32)
    rec = _Recorder()
    scores = parametric_dqn_scorer(A, rec)({"w": torch.ones(())}, torch.tensor(obs))
    (state, action), = rec.seen
    np.testing.assert_array_equal(state.numpy(), np.asarray(jnp.repeat(jnp.asarray(obs), A, 0)))
    np.testing.assert_array_equal(action.numpy(), np.tile(np.eye(A, dtype=np.float32), (6, 1)))
    # column j of row i is tiled row i * A + j: state i against action j
    want_rows = state.sum(1) * 10 + action.argmax(1)
    np.testing.assert_array_equal(scores.numpy(), want_rows.reshape(6, A).numpy())
    np.testing.assert_array_equal(action.argmax(1).reshape(6, A).numpy(),
                                  np.tile(np.arange(A), (6, 1)))

    jnet = _critic(JaxCritic)
    params = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, D)), jnp.zeros((1, A)))
    net = _critic(FullyConnectedCritic)
    carried = q_network_state_from_flax(_np_tree(params))
    calls = fused_mlp.fused_mlp_forward_reference.calls
    got = parametric_dqn_scorer(A, net)(carried, torch.tensor(obs))
    assert fused_mlp.fused_mlp_forward_reference.calls - calls == 1
    want = jax_parametric_scorer(A, jnet)(params, jnp.asarray(obs))
    assert got.shape == (6, A)
    _close(got, want)


# ------------------------------------------------------- the evaluation page

def _edp_inputs(mod, conv, seed=0, M=A, logged=None):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(16, D)).astype(np.float32)
    logged_idx = rng.integers(0, M, 16) if logged is None else logged
    return dict(
        mdp_ids=np.arange(16).reshape(-1, 1), sequence_numbers=np.zeros((16, 1)),
        states=conv(states), actions=conv(np.eye(M, dtype=np.float32)[logged_idx]),
        propensities=conv(np.full((16, 1), 1.0 / M, np.float32)),
        rewards=conv(rng.uniform(size=(16, 1)).astype(np.float32)),
        possible_actions_mask=conv(np.ones((16, M), np.float32)),
        possible_actions=conv(np.tile(np.eye(M, dtype=np.float32), (16, 1))),
        max_num_actions=M), logged_idx


def test_parametric_dqn_edp_matches_jax():
    """``tests/test_cpe.py::test_parametric_dqn_edp`` on both packages from
    JAX's init (q-network and reward network 16 relu, temperature 0.5): the
    same checks on the port's page, then every array against JAX's page."""
    rl = dict(gamma=0.9, target_update_rate=0.1, temperature=0.5)
    net_kw = dict(state_dim=D, action_dim=A, sizes=[16], activations=["relu"])
    jtrainer = JaxParametricDQNTrainer(q_network=JaxCritic(**net_kw),
                                       rl=JaxRLParameters(**rl),
                                       reward_network=JaxCritic(**net_kw))
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), jnp.zeros((1, A)))
    trainer = ParametricDQNTrainer(FullyConnectedCritic(**net_kw), rl=RLParameters(**rl),
                                   reward_network=FullyConnectedCritic(**net_kw), device="cpu")
    state = carry_parametric_state(jstate)
    kw, logged_idx = _edp_inputs(rlt, torch.tensor)
    calls = fused_mlp.fused_mlp_forward_reference.calls
    edp = EvaluationDataPage.create_from_tensors_parametric_dqn(trainer, state, **kw)
    assert fused_mlp.fused_mlp_forward_reference.calls - calls == 3  # Q, rewards, logged
    edp.validate()
    assert edp.model_values.shape == edp.model_propensities.shape == (16, A)
    np.testing.assert_allclose(edp.model_propensities.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(np.argmax(edp.action_mask, axis=1), logged_idx)
    np.testing.assert_allclose(edp.model_rewards[np.arange(16), logged_idx],
                               edp.model_rewards_for_logged_action.reshape(-1), atol=1e-5)
    _, _, dr = DoublyRobustEstimator().estimate(edp)
    assert np.isfinite(dr.raw)

    jkw, _ = _edp_inputs(jrlt, jnp.asarray)
    jedp = JaxEvaluationDataPage.create_from_tensors_parametric_dqn(jtrainer, jstate, **jkw)
    for name in ("mdp_id", "sequence_number", "logged_propensities", "logged_rewards",
                 "action_mask", "model_rewards", "model_rewards_for_logged_action",
                 "model_values", "model_propensities", "possible_actions_mask",
                 "optimal_q_values"):
        _close(getattr(edp, name), getattr(jedp, name), FWD_TOL, name)
    for name in ("eval_action_idxs", "model_metrics", "model_metrics_values", "logged_metrics"):
        assert getattr(edp, name) is None is getattr(jedp, name), name

    # the typed-batch dispatch reaches the same page
    b = next(_batches(3, 1))
    tdb = _batch(rlt, torch.tensor, b)
    tdb.extras = rlt.ExtraData(mdp_id=torch.arange(B).reshape(-1, 1),
                               sequence_number=torch.zeros((B, 1)),
                               action_probability=torch.full((B, 1), 0.5))
    page = EvaluationDataPage.create_from_training_batch(tdb, trainer, state)
    np.testing.assert_array_equal(page.action_mask, b["a"])


def test_parametric_edp_refusals():
    """No reward network, a logged action that matches no allowed possible
    action, or one that matches two: ``ValueError``, as JAX asserts."""
    *_, trainer = parametric_trainers("double_q")
    state = trainer.init(torch.Generator().manual_seed(0))
    kw, _ = _edp_inputs(rlt, torch.tensor)
    with pytest.raises(ValueError, match="reward network"):
        EvaluationDataPage.create_from_tensors_parametric_dqn(trainer, state, **kw)
    *_, trainer = parametric_trainers("double_q_reward_net")
    state = trainer.init(torch.Generator().manual_seed(0))
    masked = dict(kw, possible_actions_mask=kw["possible_actions_mask"].clone())
    masked["possible_actions_mask"][3] = 1.0 - kw["actions"][3]  # the logged one masked
    with pytest.raises(ValueError, match="exactly one"):
        EvaluationDataPage.create_from_tensors_parametric_dqn(trainer, state, **masked)
    doubled = dict(kw, possible_actions=kw["possible_actions"].clone())
    doubled["possible_actions"][5 * A: 6 * A] = kw["actions"][5]  # every row the logged one
    with pytest.raises(ValueError, match="exactly one"):
        EvaluationDataPage.create_from_tensors_parametric_dqn(trainer, state, **doubled)
    near = dict(kw, actions=kw["actions"] + 1e-3)  # not within atol 1e-6 of any
    with pytest.raises(ValueError, match="exactly one"):
        EvaluationDataPage.create_from_tensors_parametric_dqn(trainer, state, **near)


# ------------------------------------------------------------- the manager

MODEL = {
    "ParametricDQN": {
        "trainer_param": {
            "actions": ["0", "1"],
            "rl": {"gamma": 0.99, "target_update_rate": 0.1},
            "optimizer": {"Adam": {"lr": 0.003}},
            "minibatch_size": 128,
        },
        "net_builder": {"FullyConnected": {"sizes": [16, 8], "activations": ["relu", "relu"]}},
    }
}


def _carry_jax_parametric_init(self, trainer, generator, state_dim):
    """The manager hook: JAX's ``init_trainer_state`` (``trainer.init(
    PRNGKey(0), zeros, zeros)``) of the manager's critic, in the port's."""
    spec = self.net_builder["FullyConnected"]
    jtrainer = JaxParametricDQNTrainer(JaxCritic(state_dim=state_dim, action_dim=2, **spec))
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, state_dim)), jnp.zeros((1, 2)))
    trainer.q_network.load_state_dict(q_network_state_from_flax(_np_tree(jstate.q_params)))
    return trainer.state_from_networks()


def _norm(n=4):
    return {NormalizationKey.STATE: NormalizationData(dense_normalization_parameters={
        i: NormalizationParameters(feature_type="CONTINUOUS", mean=0.0, stddev=1.0)
        for i in range(n)})}


def test_parametric_manager_builds_the_jax_managers_trainer():
    """The critic over (state, one-hot action), from the parametric builder
    or, where the config names a DQN builder, ``FullyConnected`` with its
    arguments; the in-process serving module scores raw rows."""
    manager = MODEL_MANAGERS.build(copy.deepcopy(MODEL))
    assert isinstance(manager, ParametricDQN)
    trainer = manager.build_trainer(_norm(), device="cpu")
    assert isinstance(trainer, ParametricDQNTrainer) and trainer.reward_network is None
    assert (trainer.q_network.state_dim, trainer.q_network.action_dim) == (4, 2)
    assert [l.out_features for l in trainer.q_network.net.layers] == [16, 8, 1]
    other = MODEL_MANAGERS.build({"ParametricDQN": dict(
        MODEL["ParametricDQN"], net_builder={"Dueling": {"sizes": [8], "activations": ["tanh"]}})})
    assert [l.out_features for l in other.build_trainer(_norm(), device="cpu")
            .q_network.net.layers] == [8, 1]
    # no init_trainer_state hook: the workflow's trainer.init(generator) builds
    # the state, where JAX's hook passes (state, action) prototypes to flax
    assert not hasattr(manager, "init_trainer_state")
    state = trainer.init(torch.Generator().manual_seed(0))
    serving = manager.build_serving_module(trainer, state, _norm())
    assert not hasattr(serving, "save")
    sv = torch.tensor(np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32))
    av = torch.eye(2)[[0, 1, 1, 0, 1]]
    names, q = serving(sv, torch.ones(5, 4), av, torch.ones(5, 2))
    assert names == ["Q"] and q.shape == (5, 1)
    _close(q, trainer.q_network(sv, av).detach(), dict(rtol=0, atol=0))


def test_parametric_batch_preprocessor_equals_jax(tmp_path):
    """The timeline rows of a CartPole table through both packages'
    ``_ParametricFromDiscreteBatchPreprocessor``: every field equal."""
    import pandas as pd

    _, table = _collect(str(tmp_path), "torch", 300, seed=2)
    df = pd.read_pickle(table).iloc[:40]
    manager = MODEL_MANAGERS.build(copy.deepcopy(MODEL))
    norm = manager.run_feature_identification(df)
    ours = manager.build_batch_preprocessor(norm, device="cpu")
    assert isinstance(ours, _ParametricFromDiscreteBatchPreprocessor)
    from reagent_tpu.core.parameters import NormalizationParameters as JaxNP
    jnorm = {k: JaxNP(**vars(v)) for k, v in
             norm[NormalizationKey.STATE].dense_normalization_parameters.items()}
    theirs = JaxParametricBatchPreprocessor(num_actions=2,
                                            state_preprocessor=JaxPreprocessor(jnorm),
                                            action_names=["0", "1"])
    got, want = ours(df), theirs(df)
    for name in ("state", "next_state", "action", "next_action", "possible_actions",
                 "possible_next_actions"):
        _close(getattr(got, name).float_features, getattr(want, name).float_features,
               dict(rtol=1e-6, atol=1e-6), name)
    for name in ("possible_actions_mask", "possible_next_actions_mask", "reward",
                 "not_terminal", "time_diff"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.possible_actions.float_features.numpy(),
                                  np.tile(np.eye(2), (40, 1)))


def test_parametric_workflow_matches_jax_and_writes_no_artifact(tmp_path, monkeypatch):
    """Both packages' ``identify_and_train_network`` with the ``ParametricDQN``
    block on 1,200 random CartPole transitions (95/5 split, 2 epochs) from
    JAX's init: the last ``td_loss`` within rtol 1e-4 (the workflow
    tolerance of ``tests/test_torch_discrete_crr.py``), no CPE, and
    ``default_model`` ``""`` in both (JAX's parametric wrapper has no
    ``save``)."""
    _, table = _collect(str(tmp_path), "torch", 1200, seed=3)
    monkeypatch.setattr(ParametricDQN, "init_trainer_state", _carry_jax_parametric_init,
                        raising=False)
    split = dict(table_sample=95.0, eval_table_sample=5.0)
    ours = identify_and_train_network(
        TableSpec(path=table, **split), copy.deepcopy(MODEL), num_epochs=2,
        output_dir=str(tmp_path / "torch_out"), device="cpu")
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table, **split), copy.deepcopy(MODEL), num_epochs=2,
        output_dir=str(tmp_path / "jax_out"))
    assert ours.logger_data["train_steps"] > 0 and ours.logger_data["eval_seconds"] == 0.0
    assert ours.training_report.cpe_details is None is theirs.training_report.cpe_details
    np.testing.assert_allclose(ours.training_report.td_loss, theirs.training_report.td_loss,
                               rtol=1e-4, atol=1e-5)
    assert ours.output_paths["default_model"] == "" == theirs.output_paths["default_model"]


# ------------------------------------------------------- online, generic loop

@pytest.mark.parametrize("maxq", [True, False], ids=["dqn", "sarsa"])
def test_online_parametric_runs_through_the_generic_loop(maxq):
    """``tests/test_gym_all_algos.py``'s online parametric DQN and SARSA flows
    at a small size: the softmax acts on the scorer's tiled [2, 6] rows (one
    K3 call a step), each sample takes its n-step rewards from K4."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.replay import ReplayBuffer

    env = CartPole(max_steps=50, device="cpu")
    net = FullyConnectedCritic(state_dim=4, action_dim=2, sizes=[16, 8],
                               activations=["leaky_relu", "leaky_relu"])
    trainer = ParametricDQNTrainer(
        net, rl=RLParameters(gamma=0.99, target_update_rate=0.1, maxq_learning=maxq),
        optimizer={"Adam": {"lr": 0.001, "amsgrad": True}}, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=512, update_horizon=1, gamma=0.99, device="cpu")
    rs = rb.init(observation=torch.zeros(4), action=torch.tensor(0, dtype=torch.int32),
                 reward=torch.tensor(0.0), terminal=torch.tensor(False))
    gen = torch.Generator().manual_seed(1)
    rs = prefill_replay_buffer(env, rb, rs, gen, num_steps=200)
    sampler, scorer = SoftmaxActionSampler(), parametric_dqn_scorer(2, trainer.q_network)

    def policy_act(ts, obs, generator):
        out = sampler.sample_action(scorer(ts.q_params, obs[None]), generator)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    calls = (fused_mlp.fused_mlp_forward_reference.calls,
             nstep_replay.nstep_rewards_reference.calls)
    state, rs, aux = run_online_training(
        env, trainer, state, rb, rs, policy_act, lambda d: make_parametric_dqn_batch(d, 2), gen,
        OnlineLoopConfig(num_steps=30, minibatch_size=32))
    assert (fused_mlp.fused_mlp_forward_reference.calls - calls[0],
            nstep_replay.nstep_rewards_reference.calls - calls[1]) == (30, 30)
    assert aux["td_losses"].shape == (30,) and bool(torch.isfinite(aux["td_losses"]).all())

    def greedy(ts, obs, generator):
        return torch.argmax(scorer(ts.q_params, obs), dim=1).to(torch.int32)

    returns = evaluate_policy(env, greedy, state, gen, num_episodes=4)
    assert returns.shape == (4,) and bool((returns >= 1).all())
