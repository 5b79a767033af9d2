"""The port's ``reagent`` CLI, its sample configs, validators, publishers and
workflow helpers against the JAX package.

The reference's 4-command ``dqn_cartpole_e2e`` and ``sac_pendulum_e2e``
pipelines run through the port's ``reagent run`` (``CliRunner``) on the
port's copies of the two sample configs with small overrides (1,200
transitions, one epoch, two eval episodes, ``device: cpu``).  ``print-schema`` of each entry point equals
JAX's apart from the port's ``device`` field; the sample configs equal
JAX's YAML files; ``chip_smoke.py``'s card job calls the entry points with
the arguments ``reagent run`` builds; the validators and publishers give
equal results on one training output (exact: the same Python on the same
values); so do the training report, the workflow ids and the feature
identification flow; ``train_eval`` over both packages' trainers from one
init gives the same epoch metrics within 1e-5 (float32 on two libraries).
"""

import dataclasses
import importlib.util
import json
import os

import pytest
import yaml
from click.testing import CliRunner

from reagent_tpu.workflow.cli import reagent as jax_reagent
from reagent_tpu.workflow.training import run_publisher as jax_run_publisher
from reagent_tpu.workflow.training import run_validator as jax_run_validator
from reagent_tpu.workflow.types import RLTrainingOutput as JaxRLTrainingOutput
from reagent_tpu.workflow.types import RLTrainingReport as JaxRLTrainingReport
from reagent_tpu_torch.core.configuration import kwargs_from_config
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
from reagent_tpu_torch.workflow import gym_batch_rl, training
from reagent_tpu_torch.workflow.cli import reagent
from reagent_tpu_torch.workflow.training import run_publisher, run_validator
from reagent_tpu_torch.workflow.types import RLTrainingOutput, RLTrainingReport

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = ("discrete_dqn_cartpole_offline.yaml", "sac_pendulum_offline.yaml")
ENTRIES = ("workflow.gym_batch_rl.offline_gym_random", "workflow.gym_batch_rl.timeline_operator",
           "workflow.training.identify_and_train_network", "workflow.gym_batch_rl.evaluate_gym")


def _sample_config(package, name):
    return os.path.join(REPO, package, "workflow", "sample_configs", name)


@pytest.mark.parametrize("name", CONFIGS)
def test_sample_configs_equal_jax(name):
    with open(_sample_config("reagent_tpu_torch", name)) as f, \
            open(_sample_config("reagent_tpu", name)) as g:
        assert f.read() == g.read()


# each sample config's job at a small depth: its env, table and split
PIPELINES = {
    "discrete_dqn_cartpole_offline.yaml": dict(
        env_name="CartPole-v1", table_name="cartpole_offline", split=(90.0, 10.0)),
    # 100-step episodes of a one-update actor cannot meet the config's -1000 bar
    "sac_pendulum_offline.yaml": dict(
        env_name="Pendulum-v1", table_name="pendulum_offline", split=(95.0, 5.0),
        passing_score_bar=-100000.0),
}


@pytest.mark.parametrize("config", CONFIGS)
def test_reagent_run_pipeline(tmp_path, config):
    job = dict(PIPELINES[config])
    table_sample, eval_table_sample = job.pop("split")
    overrides = {
        "env_name": job.pop("env_name"),
        "pkl_path": str(tmp_path / "pre.pkl"),
        "input_table_spec": {"table_name": job.pop("table_name"),
                             "path": str(tmp_path / "t.pkl"), "table_sample": table_sample,
                             "eval_table_sample": eval_table_sample},
        "num_train_transitions": 1200, "max_steps": 100, "num_epochs": 1,
        "num_eval_episodes": 2, "output_dir": str(tmp_path / "model"),
        "model_path": str(tmp_path / "model" / "serving_model"), "device": "cpu", **job,
    }
    runner = CliRunner()
    outputs = []
    for entry in ENTRIES:
        result = runner.invoke(
            reagent, ["run", f"reagent_tpu_torch.{entry}",
                      _sample_config("reagent_tpu_torch", config),
                      "--extra-options", json.dumps(overrides)],
            catch_exceptions=False)
        assert result.exit_code == 0, (entry, result.output)
        outputs.append(result.output)
    assert "RLTrainingOutput" in outputs[2]
    predictor = load_predictor(overrides["model_path"])
    if config.startswith("sac"):
        assert predictor.model_type == "actor" and "train_steps': 1" in outputs[2]
        assert float(outputs[3]) < 0  # evaluate_gym's mean reward: costs
        act = predictor.predict({0: 1.0, 1: 0.0, 2: -0.5})
        assert act.shape == (1, 1) and -1.0 <= float(act[0, 0]) <= 1.0
        return
    assert "cpe_details=CpeDetails" in outputs[2]
    assert float(outputs[3]) > 0  # evaluate_gym's mean reward
    names, q = predictor.predict({0: 0.0, 1: 0.1, 2: -0.02, 3: 0.0})
    assert names == ["0", "1"] and q.shape == (1, 2)


@pytest.mark.parametrize("entry", ENTRIES)
def test_print_schema_equals_jax_apart_from_device(entry):
    runner = CliRunner()
    ours = json.loads(runner.invoke(reagent, ["print-schema", f"reagent_tpu_torch.{entry}"],
                                    catch_exceptions=False).output)
    theirs = json.loads(runner.invoke(jax_reagent, ["print-schema", f"reagent_tpu.{entry}"],
                                      catch_exceptions=False).output)
    device = ours["properties"].pop("device", None)
    assert device == ({"default": "cuda"} if entry.endswith("network") else None)
    assert ours == theirs


def test_kwargs_from_config_coerces_table_spec():
    config = {"input_table_spec": {"path": "t.pkl", "table_sample": 50.0}, "model": {},
              "num_epochs": 2, "unused": 1}
    kwargs = kwargs_from_config(training.identify_and_train_network, config)
    assert set(kwargs) == {"input_table_spec", "model", "num_epochs"}
    assert kwargs["input_table_spec"] == TableSpec(path="t.pkl", table_sample=50.0)


def test_chip_smoke_job_is_reagent_run():
    """The card's e2e job (``chip_smoke.py``, which cannot read YAML there)
    calls each entry point with the keyword arguments ``reagent run`` builds
    from the sample config and the job's overrides."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with open(_sample_config("reagent_tpu_torch", CONFIGS[0])) as f:
        config = yaml.safe_load(f)
    overrides = chip_smoke.e2e_overrides("/job")
    config.update(overrides)
    assert chip_smoke.e2e_config("/job") == config
    funcs = dict(zip(ENTRIES, (gym_batch_rl.offline_gym_random, gym_batch_rl.timeline_operator,
                               training.identify_and_train_network, gym_batch_rl.evaluate_gym)))
    for entry, kwargs in zip(ENTRIES, chip_smoke.e2e_kwargs("/job")):
        assert kwargs == kwargs_from_config(funcs[entry], config), entry
    assert overrides["passing_score_bar"] == 120.0 and overrides["device"] == "cuda"


def _outputs(td_loss, mean_reward, path):
    return (RLTrainingOutput(output_paths={"default_model": path},
                             training_report=RLTrainingReport(td_loss=td_loss,
                                                              mean_reward=mean_reward)),
            JaxRLTrainingOutput(output_paths={"default_model": path},
                                training_report=JaxRLTrainingReport(td_loss=td_loss,
                                                                    mean_reward=mean_reward)))


@pytest.mark.parametrize("config", [
    {"NoValidation": {}},
    {"RewardThresholdValidator": {"max_td_loss": 1.0}},
    {"RewardThresholdValidator": {"max_td_loss": 0.1}},
    {"RewardThresholdValidator": {"min_mean_reward": 150.0}},
])
def test_validators_match_jax(config):
    ours, theirs = _outputs(0.5, 120.0, "m")
    got, want = run_validator(config, ours), jax_run_validator(config, theirs)
    assert dataclasses.asdict(got.validation_result) == dataclasses.asdict(want.validation_result)
    assert got.output_paths == want.output_paths and got.training_report is ours.training_report


def test_publishers_match_jax(tmp_path):
    ours, theirs = _outputs(0.5, None, str(tmp_path / "model"))
    model_config = {"DiscreteDQN": {"trainer_param": {"actions": ["0", "1"]}}}
    assert (run_publisher({"NoPublishing": {}}, model_config, ours).publishing_result
            .success is True)
    files = {}
    for side, publish, out in (("torch", run_publisher, ours), ("jax", jax_run_publisher, theirs)):
        files[side] = str(tmp_path / f"{side}.json")
        result = publish({"FileSystemPublisher": {"publishing_file": files[side]}},
                         model_config, out).publishing_result
        assert (result.success, result.path) == (True, str(tmp_path / "model"))
    with open(files["torch"]) as f, open(files["jax"]) as g:
        ours_db, theirs_db = json.load(f), json.load(g)
    assert {k: v["path"] for k, v in ours_db.items()} == {k: v["path"] for k, v in theirs_db.items()}
    from reagent_tpu_torch.publishers import FileSystemPublisher

    assert FileSystemPublisher(files["torch"]).get_latest_published_model(model_config) == str(
        tmp_path / "model")


def test_training_report_from_cpe_details_matches_jax():
    from reagent_tpu.evaluation import cpe as jax_cpe
    from reagent_tpu.workflow.training_reports import TRAINING_REPORTS as JAX_REPORTS
    from reagent_tpu_torch.evaluation import cpe
    from reagent_tpu_torch.workflow.training_reports import TRAINING_REPORTS

    def details(mod):
        est = lambda x: mod.CpeEstimate(x, x / 2, x / 10, x / 20)
        return mod.CpeDetails(reward_estimates=mod.CpeEstimateSet(
            direct_method=est(1.0), inverse_propensity=est(2.0), doubly_robust=est(3.0),
            sequential_doubly_robust=est(4.0), weighted_doubly_robust=est(5.0), magic=est(6.0)))

    for name in JAX_REPORTS.members():
        assert TRAINING_REPORTS.get(name).__name__ == JAX_REPORTS.get(name).__name__
    ours = TRAINING_REPORTS.get("dqn_report").from_cpe_details(0.5, details(cpe))
    theirs = JAX_REPORTS.get("dqn_report").from_cpe_details(0.5, details(jax_cpe))
    plain = lambda report: {k: tuple(v) if isinstance(v, tuple) else v
                            for k, v in dataclasses.asdict(report).items()}
    assert plain(ours) == plain(theirs)
    assert ours.value_magic_dr.raw == 6.0
    assert TRAINING_REPORTS.get("dqn_report").from_cpe_details(1.0, None).reward_dm is None


def test_workflow_env_ids_match_jax():
    from reagent_tpu.workflow import env as jax_env
    from reagent_tpu_torch.workflow import env

    names = ["default_model", "reward", "cpe"]
    assert env.get_workflow_id() == jax_env.get_workflow_id()
    assert env.get_new_named_entity_ids(names) == jax_env.get_new_named_entity_ids(names)


def test_identify_normalization_parameters_matches_jax(tmp_path):
    import numpy as np
    import pandas as pd

    from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
    from reagent_tpu.preprocessing.normalization import serialize as jax_serialize
    from reagent_tpu.workflow.identify_types_flow import (
        identify_normalization_parameters as jax_identify,
    )
    from reagent_tpu_torch.preprocessing.normalization import serialize
    from reagent_tpu_torch.workflow.identify_types_flow import identify_normalization_parameters

    rng = np.random.default_rng(0)
    rows = [{0: float(rng.normal()), 1: float(rng.integers(0, 2)), 2: float(rng.integers(0, 4)),
             3: float(rng.exponential())} for _ in range(300)]
    path = str(tmp_path / "t.pkl")
    pd.DataFrame({"state_features": rows}).to_pickle(path)
    opts = {"num_samples": 200, "allowedlist_features": [0, 1, 2]}
    ours = identify_normalization_parameters(TableSpec(path=path), "state_features", opts, seed=3)
    theirs = jax_identify(JaxTableSpec(path=path), "state_features", opts, seed=3)
    assert set(ours.dense_normalization_parameters) == {0, 1, 2}
    assert serialize(ours.dense_normalization_parameters) == jax_serialize(
        theirs.dense_normalization_parameters)


def test_train_eval_and_get_rank_match_jax():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from reagent_tpu.core import types as jrlt
    from reagent_tpu.workflow import utils as jax_utils
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.reporting.reporters import DiscreteDQNReporter
    from reagent_tpu_torch.workflow import utils
    from test_torch_cpe import _batch, _batches, _trainers

    assert utils.get_rank() == 0
    jtrainer, jstate, trainer, state = _trainers(dict(gamma=0.9, target_update_rate=0.1))
    raw = list(_batches(12, 3))
    epochs = []
    state, metrics = utils.train_eval(
        trainer, state, [_batch(rlt, torch.tensor, b) for b in raw], num_epochs=2,
        reporter=DiscreteDQNReporter(), on_epoch_end=lambda s, e: epochs.append(e))
    _, jmetrics = jax_utils.train_eval(
        jtrainer, jstate, [_batch(jrlt, jnp.asarray, b) for b in raw], num_epochs=2)
    assert epochs == [0, 1] and int(state.step) == 6
    assert metrics.keys() == jmetrics.keys() >= {"td_loss", "reward_loss", "cpe_td_loss"}
    for key in jmetrics:
        np.testing.assert_allclose(metrics[key], jmetrics[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_get_rank_reads_the_process_group():
    import torch.distributed as dist

    from reagent_tpu_torch.workflow.utils import get_rank

    dist.init_process_group("gloo", init_method="tcp://localhost:0", world_size=1, rank=0)
    try:
        assert get_rank() == 0 == dist.get_rank()
    finally:
        dist.destroy_process_group()
    assert get_rank() == 0
