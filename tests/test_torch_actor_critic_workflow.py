"""The actor-critic slice as a whole: the reference's ``sac_pendulum_e2e``
pipeline on both packages at a small size, the actor artifact, and JAX's
``tests/test_offline_actor_critic.py`` on the port (``slow``, as JAX marks
it).

Both packages collect random Pendulum rows and run the timeline from one
seed (equal pickles).  The sample config's model block
(``sac_pendulum_offline.yaml``: SAC, twin Q, autotuned temperature, actor
and critics 64, 64 leaky_relu, minibatch 1024, Adam 1e-3, gamma 0.9, tau
0.5) then trains through both packages' ``identify_and_train_network`` on
that table from JAX's init (carried through the manager's
``init_trainer_state`` hook, set here only) and with JAX's noise (the
trainer's ``train_step`` is given JAX's draws, as
``tests/test_torch_actor_critic.py`` does).  Tolerances, float32 on two
libraries over 6 updates: ``q1_loss`` within rtol 1e-5, the artifacts'
actions within rtol 1e-5, atol 1e-6.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import reagent_tpu.model_managers  # noqa: F401 — registers the JAX managers
from reagent_tpu.core.registry import MODEL_MANAGERS as JAX_MODEL_MANAGERS
from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.prediction.predictor_wrapper import load_predictor as jax_load_predictor
from reagent_tpu.workflow import gym_batch_rl as jax_gym_batch_rl
from reagent_tpu.workflow.training import (
    identify_and_train_network as jax_identify_and_train_network,
)
from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationParameters
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.model_managers.actor_critic import SAC, TD3
from reagent_tpu_torch.models.actor import FullyConnectedActor, GaussianFullyConnectedActor
from reagent_tpu_torch.prediction.predictor_wrapper import (
    ActorPredictorWrapper,
    ActorWithPreprocessor,
    load_predictor,
)
from reagent_tpu_torch.preprocessing.postprocessor import Postprocessor
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.workflow import gym_batch_rl
from reagent_tpu_torch.workflow.training import identify_and_train_network
from test_torch_actor_critic import carry_sac_state, sac_noise
from test_torch_cli import _sample_config

import yaml

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PREDICT_TOL = dict(rtol=1e-5, atol=1e-6)
SPLIT = dict(table_sample=95.0, eval_table_sample=5.0)


def _sample_model():
    with open(_sample_config("reagent_tpu_torch", "sac_pendulum_offline.yaml")) as f:
        return yaml.safe_load(f)["model"]


def _collect(tmp, side, n, seed, max_steps=200):
    mod = gym_batch_rl if side == "torch" else jax_gym_batch_rl
    pkl, table = os.path.join(tmp, f"{side}_pre.pkl"), os.path.join(tmp, f"{side}_table.pkl")
    mod.offline_gym_random(env_name="Pendulum-v1", pkl_path=pkl, num_train_transitions=n,
                           max_steps=max_steps, seed=seed)
    mod.timeline_operator(pkl, (TableSpec if side == "torch" else JaxTableSpec)(path=table))
    return pkl, table


def jax_init_hook(model, df):
    """A manager ``init_trainer_state`` that builds the state from JAX's
    workflow init (seed 0) of the same model on ``df``'s normalization, and
    gives the port's trainer JAX's noise each step."""
    jmanager = JAX_MODEL_MANAGERS.build(model)
    jndm = jmanager.run_feature_identification(df)

    def hook(self, trainer, generator, state_dim):
        jtrainer = jmanager.build_trainer(jndm)
        jstate = jmanager.init_trainer_state(jtrainer, jax.random.PRNGKey(0), state_dim)
        key = [jstate.rng]
        train_step = trainer.train_step

        def with_jax_noise(state, batch, noise=None):
            key[0], noise = sac_noise(key[0], *batch.action.float_features.shape)
            return train_step(state, batch, noise)

        trainer.train_step = with_jax_noise
        return carry_sac_state(jstate, trainer.device)

    return hook


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Both packages' collection, timeline and the sample config's SAC
    training (3 epochs of 2 updates) on 2,400 Pendulum transitions."""
    tmp = str(tmp_path_factory.mktemp("sac_pipeline"))
    paths = {side: _collect(tmp, side, 2400, seed=5) for side in ("torch", "jax")}
    table = paths["torch"][1]
    model = _sample_model()
    mp = pytest.MonkeyPatch()
    mp.setattr(SAC, "init_trainer_state", jax_init_hook(model, pd.read_pickle(table)),
               raising=False)
    try:
        ours = identify_and_train_network(
            TableSpec(path=table, **SPLIT), model, num_epochs=3,
            output_dir=os.path.join(tmp, "torch_out"), device="cpu")
    finally:
        mp.undo()
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table, **SPLIT), model, num_epochs=3,
        output_dir=os.path.join(tmp, "jax_out"))
    return dict(paths=paths, ours=ours, theirs=theirs)


def test_collection_and_timeline_write_equal_pickles(pipeline):
    (pkl, table), (jpkl, jtable) = pipeline["paths"]["torch"], pipeline["paths"]["jax"]
    pre = pd.read_pickle(pkl)
    pd.testing.assert_frame_equal(pre, pd.read_pickle(jpkl))
    assert len(pre) == 2400 and pre.mdp_id.nunique() == 12
    assert "possible_actions" not in pre.columns
    assert all(-2.0 <= a[0] <= 2.0 and set(a) == {0} for a in pre["action"])
    pd.testing.assert_frame_equal(pd.read_pickle(table), pd.read_pickle(jtable))


def test_sample_config_sac_workflow_matches_jax(pipeline):
    ours, theirs = pipeline["ours"], pipeline["theirs"]
    assert ours.logger_data["train_steps"] == 6 and ours.logger_data["eval_seconds"] == 0.0
    assert ours.logger_data["report_seconds"] > 0  # the ActorCriticReporter ran
    np.testing.assert_allclose(
        ours.training_report.td_loss, theirs.training_report.td_loss, **LOSS_TOL)
    path, jpath = (r.output_paths["default_model"] for r in (ours, theirs))
    with open(os.path.join(path, "manifest.json")) as f, \
            open(os.path.join(jpath, "manifest.json")) as g:
        assert json.load(f) == json.load(g) == {"model_type": "actor"}
    assert sorted(os.listdir(path)) == ["actor.pt", "manifest.json"]
    predictor, jpredictor = load_predictor(path), jax_load_predictor(jpath)
    assert predictor.model_type == jpredictor.model_type == "actor"
    rng = np.random.default_rng(4)
    for _ in range(16):
        th = rng.uniform(-np.pi, np.pi)
        features = {0: float(np.cos(th)), 1: float(np.sin(th)), 2: float(rng.uniform(-8, 8))}
        if rng.random() < 0.3:  # a missing feature takes the preprocessor's default
            features.pop(int(rng.integers(0, 3)))
        act = predictor.predict(features)
        assert act.shape == (1, 1) and -1.0 <= float(act[0, 0]) <= 1.0
        np.testing.assert_allclose(act, np.asarray(jpredictor.predict(features)), **PREDICT_TOL)


def test_evaluate_gym_matches_jax_on_the_actor_artifacts(pipeline):
    """Three episodes of 200 steps: the port's ``evaluate_gym`` on its
    artifact against JAX's on JAX's, within rtol 1e-6 (the artifacts'
    actions differ in the last bits; measured 1.6e-8)."""
    kw = dict(env_name="Pendulum-v1", num_eval_episodes=3, max_steps=200, seed=7)
    mean = gym_batch_rl.evaluate_gym(
        model_path=pipeline["ours"].output_paths["default_model"], **kw)
    jmean = jax_gym_batch_rl.evaluate_gym(
        model_path=pipeline["theirs"].output_paths["default_model"], **kw)
    np.testing.assert_allclose(mean, jmean, rtol=1e-6)


def test_evaluate_gym_plays_the_actor_artifact(pipeline):
    """``evaluate_gym`` acts with the actor's action; its return equals the
    one of the same episodes played by hand through ``load_predictor``."""
    path = pipeline["ours"].output_paths["default_model"]
    kw = dict(env_name="Pendulum-v1", model_path=path, num_eval_episodes=2, max_steps=30,
              seed=7)
    mean = gym_batch_rl.evaluate_gym(**kw)
    env = gym_batch_rl.Gym("Pendulum-v1", set_max_steps=30)
    by_hand = []
    predictor = load_predictor(path)
    for ep in range(2):
        obs, total, done = env.reset(seed=7 + ep), 0.0, False
        while not done:
            action = predictor.predict({i: float(v) for i, v in enumerate(obs)}).reshape(-1)
            obs, reward, done = env.step(action)
            total += reward
        by_hand.append(total)
    env.close()
    assert mean == np.mean(by_hand) < 0
    with pytest.raises(AssertionError, match="eval failed"):
        gym_batch_rl.evaluate_gym(**kw, passing_score_bar=mean + 1)


def _norm(feature_type, n, **kw):
    return {i: NormalizationParameters(feature_type=feature_type, **kw) for i in range(n)}


@pytest.mark.parametrize("make_actor", [
    lambda: GaussianFullyConnectedActor(3, 2, [8, 8], ["relu", "tanh"]),
    lambda: FullyConnectedActor(3, 2, [8], ["leaky_relu"], exploration_variance=0.4),
], ids=["gaussian", "deterministic"])
def test_actor_artifact_round_trip(tmp_path, make_actor):
    """``save`` then ``load_predictor``: the same actions as the in-process
    module, in serving units through a CONTINUOUS_ACTION postprocessor
    (here [-2, 2] and [0, 5]); ``actor.pt`` reads back with
    ``weights_only=True``; a manifest without ``actor.pt`` raises
    ``FileNotFoundError``."""
    actor = make_actor()
    with torch.no_grad():
        for p in actor.parameters():
            p.normal_(generator=torch.Generator().manual_seed(1))
    pre = Preprocessor(_norm("CONTINUOUS", 3, mean=0.5, stddev=2.0))
    post = Postprocessor({0: NormalizationParameters("CONTINUOUS_ACTION", min_value=-2.0,
                                                     max_value=2.0),
                          1: NormalizationParameters("CONTINUOUS_ACTION", min_value=0.0,
                                                     max_value=5.0)})
    serving = ActorPredictorWrapper(ActorWithPreprocessor(actor, pre, post))
    path = str(tmp_path / "actor")
    serving.save(path)
    payload = torch.load(os.path.join(path, "actor.pt"), weights_only=True)
    assert payload["module"]["class"] == type(actor).__name__
    predictor = load_predictor(path)
    rng = np.random.default_rng(0)
    values = rng.normal(size=(8, 3)).astype(np.float32)
    live = serving(torch.tensor(values), torch.ones(8, 3)).numpy()
    assert (live[:, 0] >= -2).all() and (live[:, 0] <= 2).all() and (live[:, 1] >= 0).all()
    for row, want in zip(values, live):
        got = predictor.predict({i: float(v) for i, v in enumerate(row)})
        np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)
    os.remove(os.path.join(path, "actor.pt"))
    with pytest.raises(FileNotFoundError):
        load_predictor(path)


def test_serving_module_holds_the_trained_actor():
    """``build_serving_module`` exports the state's actor weights, not the
    module's, with the action postprocessor of the action normalization."""
    one_layer = {"FullyConnected": {"sizes": [8], "activations": ["relu"]}}
    manager = TD3(actor_net_builder=one_layer, critic_net_builder=one_layer,
                  preprocess_actions=True)
    ndm = {"state": NormalizationData(_norm("CONTINUOUS", 3, mean=0.0, stddev=1.0)),
           "action": NormalizationData({0: NormalizationParameters(
               "CONTINUOUS_ACTION", min_value=-2.0, max_value=2.0)})}
    trainer = manager.build_trainer(ndm, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    state = dataclasses.replace(state, actor_params={
        k: v + 0.5 for k, v in state.actor_params.items()})
    serving = manager.build_serving_module(trainer, state, ndm)
    exported = serving.model.actor_network
    assert all(torch.equal(exported.state_dict()[k], v) for k, v in state.actor_params.items())
    assert not torch.equal(trainer.actor_network.net.layers[0].bias,
                           state.actor_params["net.layers.0.bias"])
    assert serving.model.action_postprocessor.feature_type == "CONTINUOUS_ACTION"


# ------------------------------------ JAX's tests/test_offline_actor_critic.py

@pytest.fixture(scope="module")
def pendulum_table(tmp_path_factory):
    d = tmp_path_factory.mktemp("sac_data")
    pkl, table = str(d / "pre.pkl"), str(d / "table.pkl")
    gym_batch_rl.offline_gym_random(env_name="Pendulum-v1", pkl_path=pkl,
                                    num_train_transitions=2000, max_steps=200, seed=5)
    spec = TableSpec(table_name="pd", path=table, **SPLIT)
    gym_batch_rl.timeline_operator(pkl, spec)
    return spec


def _offline_model(name, actor_builder):
    return {name: {
        "trainer_param": {
            "rl": {"gamma": 0.99, "target_update_rate": 0.05},
            "q_network_optimizer": {"Adam": {"lr": 0.001}},
            "actor_network_optimizer": {"Adam": {"lr": 0.001}},
            "minibatch_size": 256,
        },
        "actor_net_builder": {actor_builder: {"sizes": [64, 64], "activations": ["relu", "relu"]}},
        "critic_net_builder": {"FullyConnected": {"sizes": [64, 64],
                                                  "activations": ["relu", "relu"]}},
    }}


@pytest.mark.slow
def test_sac_offline_trains(pendulum_table, tmp_path):
    result = identify_and_train_network(
        input_table_spec=pendulum_table, model=_offline_model("SAC", "GaussianFullyConnected"),
        num_epochs=2, output_dir=str(tmp_path / "sac_out"), device="cpu")
    assert result.training_report.td_loss is not None
    assert np.isfinite(result.training_report.td_loss)
    model_path = result.output_paths["default_model"]
    assert model_path
    act = np.asarray(load_predictor(model_path).predict({i: 0.1 for i in range(3)})).reshape(-1)
    assert act.shape[-1] == 1 and np.isfinite(act).all()


@pytest.mark.slow
def test_td3_offline_trains(pendulum_table, tmp_path):
    result = identify_and_train_network(
        input_table_spec=pendulum_table, model=_offline_model("TD3", "FullyConnected"),
        num_epochs=2, output_dir=str(tmp_path / "td3_out"), device="cpu")
    assert result.training_report.td_loss is not None
    assert np.isfinite(result.training_report.td_loss)


@pytest.mark.slow
def test_sac_pendulum_offline_cli_pipeline(tmp_path):
    """The reference's sac_pendulum_e2e CI job: the 4 commands of the port's
    ``reagent run`` with the sample config (.circleci/config.yml:79-128)."""
    from click.testing import CliRunner

    from reagent_tpu_torch.workflow.cli import reagent

    cfg = _sample_config("reagent_tpu_torch", "sac_pendulum_offline.yaml")
    overrides = {
        "pkl_path": str(tmp_path / "pre.pkl"),
        "input_table_spec": {"table_name": "pendulum_offline", "path": str(tmp_path / "t.pkl"),
                             **SPLIT},
        "num_train_transitions": 3000, "max_steps": 200, "num_epochs": 2,
        "num_eval_episodes": 2, "passing_score_bar": -100000.0,
        "output_dir": str(tmp_path / "model"),
        "model_path": str(tmp_path / "model" / "serving_model"), "device": "cpu",
    }
    runner = CliRunner()
    for entry in ("offline_gym_random", "timeline_operator", "identify_and_train_network",
                  "evaluate_gym"):
        module = "training" if entry == "identify_and_train_network" else "gym_batch_rl"
        result = runner.invoke(
            reagent, ["run", f"reagent_tpu_torch.workflow.{module}.{entry}", cfg,
                      "--extra-options", json.dumps(overrides)],
            catch_exceptions=False)
        assert result.exit_code == 0, (entry, result.output)
    predictor = load_predictor(overrides["model_path"])
    assert predictor.model_type == "actor"
    act = np.asarray(predictor.predict({0: 0.5, 1: -0.5, 2: 0.1})).reshape(-1)
    assert act.shape == (1,) and np.isfinite(act).all()
    assert -2.0 <= float(act[0]) <= 2.0



def test_chip_smoke_sac_job_is_the_sample_config_cut_in_depth():
    """The card's sac_pendulum_e2e job (``chip_smoke.py``) runs ``reagent
    run`` on the sample config itself; its overrides cut only the four
    depths and place the files and the device."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test",
        os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    path = _sample_config("reagent_tpu_torch", "sac_pendulum_offline.yaml")
    assert os.path.samefile(chip_smoke.SAC_YAML, path)
    with open(path) as f:
        config = yaml.safe_load(f)
    assert chip_smoke.sac_sample_config() == config
    depths = {"num_epochs", "num_train_transitions", "num_eval_episodes", "max_steps"}
    placed = {"pkl_path", "input_table_spec", "output_dir", "model_path", "device"}
    for cut in (True, False):
        overrides = chip_smoke.sac_job_overrides("/job", cut)
        assert set(overrides) == (depths | placed if cut else placed)
        spec = overrides["input_table_spec"]
        assert {k: v for k, v in spec.items() if k != "path"} == {
            k: v for k, v in config["input_table_spec"].items() if k != "path"}
        assert overrides["device"] == "cuda" and spec["path"].startswith("/job")
    cut = chip_smoke.SAC_JOB_CUT
    assert all(cut[k] <= config[k] for k in depths)
