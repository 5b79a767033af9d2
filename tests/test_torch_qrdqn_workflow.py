"""The QR-DQN slice as a whole: both packages' offline workflow on one table
from the same carried initial weights, the quantile artifact, the unfused
``DiscreteDQN`` path, and the online loop with a ``QRDQNTrainer``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reagent_tpu.model_managers  # noqa: F401 — registers the JAX managers
from reagent_tpu.core.registry import DISCRETE_DQN_NET_BUILDERS as JAX_DQN_BUILDERS
from reagent_tpu.core.registry import QR_DQN_NET_BUILDERS as JAX_QR_BUILDERS
from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.prediction.predictor_wrapper import (
    CategoricalDqnPredictorWrapper as JaxCategoricalWrapper,
)
from reagent_tpu.prediction.predictor_wrapper import (
    make_quantile_dqn_predictor_wrapper as jax_make_quantile_wrapper,
)
from reagent_tpu.preprocessing.normalization import deserialize as jax_deserialize
from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
from reagent_tpu.workflow.training import (
    identify_and_train_network as jax_identify_and_train_network,
)
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.core.registry import MODEL_MANAGERS
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.gym.envs import CartPole
from reagent_tpu_torch.gym.online_loop import (
    OnlineLoopConfig,
    evaluate_policy,
    prefill_replay_buffer,
    run_online_training,
)
from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
from reagent_tpu_torch.model_managers.discrete import DiscreteQRDQN
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.models.dueling_q_network import DuelingQNetwork
from reagent_tpu_torch.ops.quantile_huber import quantile_huber_loss_reference
from reagent_tpu_torch.prediction.predictor_wrapper import (
    CategoricalDqnPredictorWrapper,
    DiscreteDqnPredictorWrapper,
)
from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
from reagent_tpu_torch.replay import ReplayBuffer
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer
from reagent_tpu_torch.utils.interop import flax_from_q_network_state, q_network_state_from_flax
from reagent_tpu_torch.workflow.training import identify_and_train_network
from test_torch_workflow import ACTIONS, _make_table, _read_artifact

N_ATOMS = 5
SIZES, ACTS = [16, 8], ["leaky_relu", "leaky_relu"]


def _trainer_param(optimizer):
    return {
        "actions": ACTIONS,
        "rl": {"gamma": 0.9, "target_update_rate": 0.05},
        "double_q_learning": True,
        "minibatch_size": 64,
        "optimizer": optimizer,
    }


def _carry_jax_init(monkeypatch, manager_cls, jax_builders, net_builder):
    """Start the port's trainer from JAX's seed-0 init of the same net (what
    ``reagent_tpu``'s workflow draws), through the workflow's
    ``init_trainer_state`` hook, set here only."""

    def jax_init(self, trainer, generator, state_dim):
        jnet = jax_builders.build(net_builder).build_q_network(
            None, len(ACTIONS), state_dim=state_dim)
        params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, state_dim)))
        trainer.q_network.load_state_dict(
            q_network_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
        return trainer.state_from_q_network()

    monkeypatch.setattr(manager_cls, "init_trainer_state", jax_init, raising=False)


@pytest.mark.parametrize("builder", ["QuantileFullyConnected", "DuelingQuantile"])
def test_qrdqn_workflow_matches_jax(tmp_path, monkeypatch, builder):
    """2 epochs of 5 minibatches in both packages.  td_loss to rtol 1e-4,
    atol 1e-5 and the artifacts' scores to rtol 1e-3, atol 1e-4: float32 sums
    in another order, fed back through 10 amsgrad steps."""
    table = str(tmp_path / "table.pkl")
    df = _make_table(table)
    net_builder = {builder: {"sizes": SIZES, "activations": ACTS, "num_atoms": N_ATOMS}}
    model = {"DiscreteQRDQN": {
        "trainer_param": _trainer_param({"AdamW": {"lr": 0.003, "amsgrad": True}}),
        "net_builder": net_builder,
        "eval_parameters": {"calc_cpe_in_training": False},
    }}
    _carry_jax_init(monkeypatch, DiscreteQRDQN, JAX_QR_BUILDERS, net_builder)
    calls = quantile_huber_loss_reference.calls
    ours = identify_and_train_network(
        TableSpec(path=table), model, num_epochs=2,
        output_dir=str(tmp_path / "torch"), device="cpu")
    steps = ours.logger_data["train_steps"]
    assert steps == 2 * (len(df) // 64)
    assert quantile_huber_loss_reference.calls == calls + steps  # the CPU takes the plain K5
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table), model, num_epochs=2, output_dir=str(tmp_path / "jax"))
    np.testing.assert_allclose(
        ours.training_report.td_loss, theirs.training_report.td_loss, rtol=1e-4, atol=1e-5)

    path = ours.output_paths["default_model"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(theirs.output_paths["default_model"], "manifest.json")) as f:
        assert manifest == json.load(f)
    assert manifest == {"model_type": "categorical_dqn", "action_names": ACTIONS}
    payload = torch.load(os.path.join(path, "model.pt"), weights_only=True)
    sorted_features = sorted(int(k) for k in payload["normalization"])
    values, presence = sparse_to_dense(df["state_features"].tolist()[:40], sorted_features)
    names, q_ours = CategoricalDqnPredictorWrapper.load(path)(values, presence)
    assert names == ACTIONS and q_ours.shape == (40, len(ACTIONS)) and np.isfinite(q_ours).all()
    _, q_theirs = JaxCategoricalWrapper.load(theirs.output_paths["default_model"])(values, presence)
    np.testing.assert_allclose(q_ours, q_theirs, rtol=1e-3, atol=1e-4)

    # JAX's wrapper on the port's trained weights, carried back: the same
    # forward to float32 rounding (rtol 1e-5, atol 1e-5)
    jnet = JAX_QR_BUILDERS.build(net_builder).build_q_network(
        None, len(ACTIONS), state_dim=len(sorted_features))
    jwrapper = jax_make_quantile_wrapper(
        jnet, jax.tree_util.tree_map(jnp.asarray, flax_from_q_network_state(payload["state_dict"])),
        JaxPreprocessor(jax_deserialize(payload["normalization"])), ACTIONS, N_ATOMS)
    _, q_carried = jwrapper(jnp.asarray(values), jnp.asarray(presence))
    np.testing.assert_allclose(q_ours, np.asarray(q_carried), rtol=1e-5, atol=1e-5)


def test_quantile_artifact_scores_as_the_in_process_module(tmp_path):
    table = str(tmp_path / "table.pkl")
    df = _make_table(table, n=128)
    manager = MODEL_MANAGERS.build({"DiscreteQRDQN": {
        "trainer_param": _trainer_param({"Adam": {"lr": 0.001, "amsgrad": True}}),
        "net_builder": {"DuelingQuantile": {
            "sizes": SIZES, "activations": ACTS, "num_atoms": N_ATOMS}},
    }})
    norm = manager.run_feature_identification(df)
    trainer = manager.build_trainer(norm, device="cpu")
    assert isinstance(trainer.q_network, DuelingQNetwork) and trainer.num_atoms == N_ATOMS
    state = trainer.init(torch.Generator().manual_seed(4))
    serving = manager.build_serving_module(trainer, state, norm)
    serving.save(str(tmp_path / "artifact"))
    assert sorted(os.listdir(tmp_path / "artifact")) == ["manifest.json", "model.pt"]
    sf = serving.preprocessor.sorted_features
    values, presence = sparse_to_dense(df["state_features"].tolist()[:32], sf)
    names, live = serving(torch.tensor(values), torch.tensor(presence))
    _, loaded = CategoricalDqnPredictorWrapper.load(str(tmp_path / "artifact"))(values, presence)
    assert names == ACTIONS and live.shape == (32, len(ACTIONS))
    np.testing.assert_allclose(loaded, live.numpy(), rtol=0, atol=1e-6)
    # and as the trainer scores the same preprocessed rows
    obs = serving.preprocessor(torch.tensor(values), torch.tensor(presence))
    np.testing.assert_allclose(trainer.q_values(state, obs).numpy(), live.numpy(), atol=1e-6)


@pytest.mark.parametrize("loss", ["mse", "huber"])
def test_unfused_dqn_workflow_matches_jax(tmp_path, monkeypatch, loss):
    """``use_fused_kernel: false`` trains through ``DQNTrainer`` in both
    packages; td_loss and the exported weights to rtol 5e-4, atol 5e-5, the
    fused workflow test's bound."""
    table = str(tmp_path / "table.pkl")
    _make_table(table)
    net_builder = {"FullyConnected": {"sizes": SIZES, "activations": ["relu", "relu"]}}
    tp = _trainer_param({"Adam": {"lr": 0.003}})
    tp["rl"]["q_network_loss"] = loss
    tp["use_fused_kernel"] = False
    model = {"DiscreteDQN": {
        "trainer_param": tp, "net_builder": net_builder,
        "eval_parameters": {"calc_cpe_in_training": False},
    }}
    _carry_jax_init(monkeypatch, DiscreteDQN, JAX_DQN_BUILDERS, net_builder)
    ours = identify_and_train_network(
        TableSpec(path=table), model, num_epochs=2,
        output_dir=str(tmp_path / "torch"), device="cpu")
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table), model, num_epochs=2, output_dir=str(tmp_path / "jax"))
    np.testing.assert_allclose(
        ours.training_report.td_loss, theirs.training_report.td_loss, rtol=5e-4, atol=5e-5)
    m_ours, w_ours = _read_artifact(ours.output_paths["default_model"])
    m_theirs, w_theirs = _read_artifact(theirs.output_paths["default_model"])
    assert m_ours == m_theirs
    np.testing.assert_allclose(w_ours, w_theirs, rtol=5e-4, atol=5e-5)
    names, q = DiscreteDqnPredictorWrapper.load(ours.output_paths["default_model"])(
        np.zeros((2, 6), np.float32), np.ones((2, 6), np.float32))
    assert names == ACTIONS and q.shape == (2, 3) and np.isfinite(q).all()


def test_dueling_dqn_has_no_flat_artifact(tmp_path):
    table = str(tmp_path / "table.pkl")
    _make_table(table, n=128)
    tp = _trainer_param({"Adam": {"lr": 0.003}})
    with pytest.raises(ValueError, match="flat MLP"):
        identify_and_train_network(
            TableSpec(path=table),
            {"DiscreteDQN": {"trainer_param": tp,
                             "net_builder": {"Dueling": {"sizes": SIZES, "activations": ACTS}},
                             "eval_parameters": {"calc_cpe_in_training": False}}},
            num_epochs=1, output_dir=str(tmp_path / "out"), device="cpu")


def test_online_loop_and_evaluate_policy_with_qrdqn():
    """By behaviour: a few steps of the generic loop and a short evaluation
    with the reference QR-DQN CartPole trainer at a small size."""
    env = CartPole(max_steps=50, device="cpu")
    net = DuelingQNetwork(state_dim=4, action_dim=2, layers=[16, 16],
                          activations=["leaky_relu", "leaky_relu"], num_atoms=N_ATOMS)
    trainer = QRDQNTrainer(
        net, N_ATOMS, rl=RLParameters(gamma=0.9, target_update_rate=0.05),
        optimizer={"Adam": {"lr": 0.001, "amsgrad": True}}, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tstate = trainer.init(gen)
    rb = ReplayBuffer(replay_capacity=500, update_horizon=1, gamma=0.9, device="cpu")
    rb_state = rb.init(observation=torch.zeros(4), action=torch.tensor(0, dtype=torch.int32),
                       reward=torch.tensor(0.0), terminal=torch.tensor(False))
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, 64)
    sampler = SoftmaxActionSampler(temperature=1.0)

    def policy_act(ts, obs, g):
        out = sampler.sample_action(trainer.q_values(ts, obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    calls = quantile_huber_loss_reference.calls
    first = tstate
    tstate, rb_state, aux = run_online_training(
        env, trainer, tstate, rb, rb_state, policy_act,
        lambda d: make_discrete_dqn_batch(d, 2), gen,
        OnlineLoopConfig(num_steps=12, minibatch_size=32))
    assert quantile_huber_loss_reference.calls == calls + 12
    assert int(rb_state.add_count) == 64 + 12 and int(tstate.step) == 12
    assert aux["td_losses"].shape == (12,) and torch.isfinite(aux["td_losses"]).all()
    assert any(not torch.equal(v, first.q_params[k]) for k, v in tstate.q_params.items())

    def greedy(ts, obs, g):
        return torch.argmax(trainer.q_values(ts, obs), dim=1).to(torch.int32)

    returns = evaluate_policy(env, greedy, tstate, gen, num_episodes=5)
    assert returns.shape == (5,) and ((returns >= 1) & (returns <= 50)).all()
