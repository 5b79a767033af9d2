"""The batch-RL pipeline of the reference's ``dqn_cartpole_e2e`` job against
the JAX package, at a small size.

Both packages collect random CartPole rows and run the timeline operator
from one seed (equal pickles: the same rows, draws and pandas code), then
train the sample config's model block at narrow widths with CPE on (1,200
transitions, one epoch; at 600 the eval split's MAGIC fails in both
packages alike, which is held too) from JAX's init, carried through the manager's
``init_trainer_state`` hook (set here only), with ``np.random`` seeded alike
for the bootstraps.  The CPE details are held as
``tests/test_torch_cpe_workflow.py`` holds them; both ``load_predictor``s
score both artifacts within 1e-6 (the same float32 numpy forward, the
preprocessing in two libraries); ``evaluate_gym`` of both packages gives the
same mean reward on one artifact (the same greedy actions).  Then the custom
reward expression flow of ``tests/test_offline_e2e.py``, the 120 bar of the
full job (slow), and the artifact policy.
"""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.gym.policies.predictor_policies import (
    DiscreteDqnPredictorPolicy as JaxDiscreteDqnPredictorPolicy,
)
from reagent_tpu.prediction.predictor_wrapper import load_predictor as jax_load_predictor
from reagent_tpu.workflow import gym_batch_rl as jax_gym_batch_rl
from reagent_tpu.workflow.training import (
    identify_and_train_network as jax_identify_and_train_network,
)
from reagent_tpu_torch.core.registry import ENVS
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.gym.envs import Gym
from reagent_tpu_torch.gym.policies import create_predictor_policy_from_model
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
from reagent_tpu_torch.workflow import gym_batch_rl
from reagent_tpu_torch.workflow.training import identify_and_train_network
from test_torch_cpe_workflow import (
    EST_TOL,
    LOSS_TOL,
    WEIGHT_TOL,
    _assert_estimates,
    _carry_jax_init,
    _config,
    _read_weights,
)

PREDICT_TOL = dict(rtol=1e-6, atol=1e-6)


def _collect(tmp, side, n, seed, max_steps=100):
    mod = gym_batch_rl if side == "torch" else jax_gym_batch_rl
    pkl, table = os.path.join(tmp, f"{side}_pre.pkl"), os.path.join(tmp, f"{side}_table.pkl")
    mod.offline_gym_random(env_name="CartPole-v1", pkl_path=pkl, num_train_transitions=n,
                           max_steps=max_steps, seed=seed)
    mod.timeline_operator(pkl, (TableSpec if side == "torch" else JaxTableSpec)(path=table))
    return pkl, table


def _narrow_model():
    model = copy.deepcopy(_config()["model"])
    model["DiscreteDQN"]["net_builder"]["FullyConnected"]["sizes"] = [16, 8]
    model["DiscreteDQN"]["cpe_net_builder"] = {"FullyConnected": {"sizes": [16, 8]}}
    model["DiscreteDQN"]["trainer_param"]["minibatch_size"] = 128
    return model


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Both packages' collection, timeline and CPE training on 1,200 rows."""
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    paths = {side: _collect(tmp, side, 1200, seed=1) for side in ("torch", "jax")}
    table = paths["torch"][1]
    split = dict(table_sample=90.0, eval_table_sample=10.0)
    mp = pytest.MonkeyPatch()
    mp.setattr(DiscreteDQN, "init_trainer_state", _carry_jax_init, raising=False)
    try:
        np.random.seed(11)
        ours = identify_and_train_network(
            TableSpec(path=table, **split), _narrow_model(), num_epochs=1,
            output_dir=os.path.join(tmp, "torch_out"), device="cpu")
    finally:
        mp.undo()
    np.random.seed(11)
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table, **split), _narrow_model(), num_epochs=1,
        output_dir=os.path.join(tmp, "jax_out"))
    return dict(paths=paths, ours=ours, theirs=theirs)


def test_collection_and_timeline_write_equal_pickles(pipeline):
    (pkl, table), (jpkl, jtable) = pipeline["paths"]["torch"], pipeline["paths"]["jax"]
    pre = pd.read_pickle(pkl)
    pd.testing.assert_frame_equal(pre, pd.read_pickle(jpkl))
    assert len(pre) == 1200 and pre.mdp_id.nunique() > 5
    assert list(pre.columns) == ["ds", "mdp_id", "sequence_number", "state_features", "action",
                                 "reward", "action_probability", "metrics", "possible_actions"]
    pd.testing.assert_frame_equal(pd.read_pickle(table), pd.read_pickle(jtable))


def test_small_e2e_with_cpe_matches_jax(pipeline):
    ours, theirs = pipeline["ours"], pipeline["theirs"]
    assert ours.logger_data["train_steps"] > 0 and ours.logger_data["report_seconds"] > 0
    np.testing.assert_allclose(
        ours.training_report.td_loss, theirs.training_report.td_loss, **LOSS_TOL)
    m_ours, w_ours = _read_weights(ours)
    m_theirs, w_theirs = _read_weights(theirs)
    for key in ("model_type", "action_names", "normalization", "sorted_features", "layers"):
        assert m_ours[key] == m_theirs[key], key
    np.testing.assert_allclose(w_ours, w_theirs, **WEIGHT_TOL)
    got, want = ours.training_report.cpe_details, theirs.training_report.cpe_details
    _assert_estimates(got.reward_estimates, want.reward_estimates)
    for name in ("q_value_means", "q_value_stds", "action_distribution"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.keys() == w.keys() == {"0", "1"}, name
        for k in w:
            assert g[k] == pytest.approx(w[k], **EST_TOL), (name, k)


def test_small_eval_split_fails_magic_in_both_packages(tmp_path, monkeypatch):
    """At 600 transitions the 10% eval split leaves MAGIC's SLSQP no j-steps
    to blend: both packages raise the same ``ValueError`` (a reference
    behaviour the port keeps)."""
    _, table = _collect(str(tmp_path), "torch", 600, seed=1)
    split = dict(table_sample=90.0, eval_table_sample=10.0)
    monkeypatch.setattr(DiscreteDQN, "init_trainer_state", _carry_jax_init, raising=False)
    errors = []
    for train, spec, kw in ((identify_and_train_network, TableSpec, dict(device="cpu")),
                            (jax_identify_and_train_network, JaxTableSpec, {})):
        np.random.seed(11)
        with pytest.raises(ValueError) as err:
            train(spec(path=table, **split), _narrow_model(), num_epochs=1,
                  output_dir=str(tmp_path / "out"), **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "not enough values to unpack (expected 2, got 0)"


@pytest.mark.parametrize("artifact", ["torch", "jax"])
def test_load_predictor_matches_jax(pipeline, artifact):
    path = pipeline["ours" if artifact == "torch" else "theirs"].output_paths["default_model"]
    ours, theirs = load_predictor(path), jax_load_predictor(path)
    assert ours.model_type == theirs.model_type == "discrete_dqn"
    rng = np.random.default_rng(4)
    for _ in range(16):
        features = {i: float(v) for i, v in enumerate(rng.normal(size=4) * [1, 2, 0.2, 2])}
        if rng.random() < 0.3:  # a missing feature takes the preprocessor's default
            features.pop(int(rng.integers(0, 4)))
        names, q = ours.predict(features)
        jnames, jq = theirs.predict(features)
        assert names == jnames == ["0", "1"] and q.shape == (1, 2)
        np.testing.assert_allclose(q, jq, **PREDICT_TOL)


def test_evaluate_gym_matches_jax_on_one_artifact(pipeline):
    path = pipeline["theirs"].output_paths["default_model"]
    kw = dict(env_name="CartPole-v1", model_path=path, num_eval_episodes=3, max_steps=50,
              seed=7)
    mean = gym_batch_rl.evaluate_gym(**kw)
    assert mean == jax_gym_batch_rl.evaluate_gym(**kw) > 0
    with pytest.raises(AssertionError, match="eval failed"):
        gym_batch_rl.evaluate_gym(**kw, passing_score_bar=mean + 1)


def test_predictor_policy_matches_jax(pipeline):
    path = pipeline["ours"].output_paths["default_model"]
    obs = np.random.default_rng(2).normal(size=(8, 4)).astype(np.float32)
    greedy = create_predictor_policy_from_model(path).act(None, obs)
    jgreedy = JaxDiscreteDqnPredictorPolicy(path).act(None, jnp.asarray(obs))
    np.testing.assert_array_equal(greedy.action.numpy(), np.asarray(jgreedy.action))
    soft = create_predictor_policy_from_model(path, temperature=0.5).act(
        None, obs[0], torch.Generator().manual_seed(0))
    assert soft.action.shape == (1, 2) and float(soft.action.sum()) == 1.0


def test_gym_env_and_artifact_types(tmp_path):
    assert ENVS.get("Gym") is Gym
    env = Gym("CartPole-v1", set_max_steps=5)
    obs = env.reset(seed=0)
    assert obs.dtype == np.float32 and obs.shape == (4,)
    done, steps = False, 0
    while not done:
        _, reward, done = env.step(steps % 2)
        steps += 1
    assert steps <= 5 and reward == 1.0
    env.close()
    actor = tmp_path / "actor"
    actor.mkdir()
    (actor / "manifest.json").write_text(json.dumps({"model_type": "actor"}))
    with pytest.raises(FileNotFoundError, match="actor.pt"):
        load_predictor(str(actor))
    (actor / "manifest.json").write_text(json.dumps({"model_type": "categorical_dqn"}))
    with pytest.raises(ValueError, match="categorical_dqn"):
        load_predictor(str(actor))


def test_workflow_with_custom_reward_expression_matches_jax(tmp_path, monkeypatch):
    """``tests/test_offline_e2e.py::test_workflow_with_custom_reward_expression``
    on both packages: the same table, reward halved by the expression."""
    _, table = _collect(str(tmp_path), "torch", 600, seed=2)
    model = {"DiscreteDQN": {
        "trainer_param": {"actions": ["0", "1"], "rl": {"gamma": 0.99, "target_update_rate": 0.2},
                          "minibatch_size": 128, "optimizer": {"Adam": {"lr": 0.01}}},
        "net_builder": {"FullyConnected": {"sizes": [16], "activations": ["relu"]}}}}
    split = dict(table_sample=100.0, eval_table_sample=0.0)
    opts = {"custom_reward_expression": "reward * 0.5"}
    monkeypatch.setattr(DiscreteDQN, "init_trainer_state", _carry_jax_init, raising=False)
    ours = identify_and_train_network(
        TableSpec(path=table, **split), model, num_epochs=1,
        output_dir=str(tmp_path / "out"), reward_options=opts, device="cpu")
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table, **split), model, num_epochs=1,
        output_dir=str(tmp_path / "jax_out"), reward_options=opts)
    plain = identify_and_train_network(
        TableSpec(path=table, **split), model, num_epochs=1,
        output_dir=str(tmp_path / "plain"), device="cpu")
    np.testing.assert_allclose(ours.training_report.td_loss, theirs.training_report.td_loss,
                               **LOSS_TOL)
    assert ours.training_report.td_loss != plain.training_report.td_loss


@pytest.mark.slow
def test_dqn_cartpole_offline_e2e_from_jax_init(tmp_path, monkeypatch):
    """``tests/test_offline_e2e.py::test_dqn_cartpole_offline_e2e`` on the
    port, from JAX's init of the three nets: the same job (12,000 random
    transitions, 25 epochs, CPE on) held to the same 120 bar."""
    _, table = _collect(str(tmp_path), "torch", 12000, seed=1, max_steps=200)
    model = copy.deepcopy(_config()["model"])
    monkeypatch.setattr(DiscreteDQN, "init_trainer_state", _carry_jax_init, raising=False)
    result = identify_and_train_network(
        TableSpec(table_name="cartpole", path=table, table_sample=90.0, eval_table_sample=10.0),
        model, num_epochs=25, output_dir=str(tmp_path / "model_out"), device="cpu")
    assert np.isfinite(result.training_report.cpe_details.reward_estimates.direct_method.raw)
    mean_reward = gym_batch_rl.evaluate_gym(
        env_name="CartPole-v1", model_path=result.output_paths["default_model"],
        num_eval_episodes=20, passing_score_bar=120.0, max_steps=200)
    print(f"offline e2e mean eval reward (port, JAX's init): {mean_reward}")
