"""The serving DSL against the JAX package's, byte for byte, and the C++
decision service scoring an artifact the port trained.

The example plans (``examples/decision_plans/example.py`` and
``examples/ecommerce/customer_simulator.py::make_plans``) are re-authored with
the port's DSL: the same modules with their ``reagent_tpu.serving`` import
pointed at ``reagent_tpu_torch.serving``.  The service is built by
``build_decision_service`` into the test's temporary directory (never
``serving/build/``) and scores every action of 64 raw logged rows through a
plan whose root is ``ActionValueScoring``: within rtol and atol 1e-5 of
``DiscreteDqnPredictorWrapper.load``'s forward (the service computes in
float64, the port in float32).
"""

import filecmp
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import reagent_tpu.serving as jserving
import reagent_tpu_torch.serving as pserving
from reagent_tpu_torch.serving import native

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "decision_plans" / "example.py"
SIMULATOR = REPO / "examples" / "ecommerce" / "customer_simulator.py"
Q_TOL = dict(rtol=1e-5, atol=1e-5)


def load_module(path: Path, name: str, port: bool):
    """``path`` as a module; with ``port``, authored with the port's DSL."""
    src = path.read_text()
    if port:
        assert "from reagent_tpu.serving import" in src
        src = src.replace("from reagent_tpu.serving import",
                          "from reagent_tpu_torch.serving import")
    mod = type(sys)(name)
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def example_plan_names():
    return list(load_module(EXAMPLE, "example_plans_jax", port=False).PLANS)


@pytest.mark.parametrize("plan", example_plan_names())
def test_example_plan_exports_byte_equal_to_jax(tmp_path, plan):
    theirs = load_module(EXAMPLE, "example_plans_jax", port=False)
    ours = load_module(EXAMPLE, "example_plans_port", port=True)
    jserving.export_plan(theirs.PLANS[plan](), str(tmp_path / "jax.json"))
    pserving.export_plan(ours.PLANS[plan](), str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_ecommerce_plans_export_byte_equal_to_jax(tmp_path):
    load_module(SIMULATOR, "simulator_jax", port=False).make_plans(str(tmp_path / "jax"))
    load_module(SIMULATOR, "simulator_port", port=True).make_plans(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", names,
                                               shallow=False)
    assert match == names, (mismatch, errors)


def test_shared_nodes_and_builder_options_equal_jax(tmp_path):
    """A DAG with a node used twice, constants, every builder option, and a
    built dict passed to ``export_plan``."""

    def plan(s):
        values = s.Expression(equation="a * x + b", a=2.0, x=s.InputFromRequest(), b=0.5)
        root = s.SoftmaxRanker(values=s.Expression(equation="u + v", u=values, v=values),
                               temperature=0.3)
        return (s.DecisionPlanBuilder().set_root(root).set_num_actions_to_choose(2)
                .set_reward_function("click").set_reward_aggregator("sum"))

    for name, s in (("jax", jserving), ("port", pserving)):
        s.export_plan(plan(s), str(tmp_path / f"{name}.json"))
        s.export_plan(plan(s).build(), str(tmp_path / f"{name}_built.json"))
    for suffix in ("", "_built"):
        assert ((tmp_path / f"port{suffix}.json").read_bytes()
                == (tmp_path / f"jax{suffix}.json").read_bytes())
    with pytest.raises(AssertionError, match="root"):
        pserving.DecisionPlanBuilder().build()


def test_build_refuses_the_cmake_tree():
    with pytest.raises(ValueError, match="serving/build"):
        native.build_decision_service(REPO / "serving" / "build")


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not installed")
def test_native_service_scores_the_ports_dqn_artifact(tmp_path):
    pytest.importorskip("gymnasium")
    from reagent_tpu_torch.data.data_module import TableSpec
    from reagent_tpu_torch.prediction.predictor_wrapper import DiscreteDqnPredictorWrapper
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
    from reagent_tpu_torch.workflow.gym_batch_rl import offline_gym_random, timeline_operator
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    pkl, table = str(tmp_path / "pre.pkl"), str(tmp_path / "table.pkl")
    offline_gym_random(env_name="CartPole-v1", pkl_path=pkl, num_train_transitions=800,
                       max_steps=100, seed=7)
    spec = TableSpec(table_name="cp", path=table, table_sample=100.0, eval_table_sample=0.0)
    timeline_operator(pkl, spec)
    # tests/test_serving_integration.py's config for JAX's artifact
    result = identify_and_train_network(
        input_table_spec=spec,
        model={"DiscreteDQN": {
            "trainer_param": {"actions": ["0", "1"],
                              "rl": {"gamma": 0.99, "target_update_rate": 0.2},
                              "minibatch_size": 128, "optimizer": {"Adam": {"lr": 0.01}}},
            "net_builder": {"FullyConnected": {"sizes": [32],
                                               "activations": ["leaky_relu"]}}}},
        num_epochs=1, output_dir=str(tmp_path / "out"), device="cpu")
    model_path = result.output_paths["default_model"]

    plans = tmp_path / "plans"
    plans.mkdir()
    pserving.export_plan(
        pserving.DecisionPlanBuilder()
        .set_root(pserving.ActionValueScoring(model_path=model_path))
        .set_num_actions_to_choose(2), str(plans / "dqn_q.json"))
    binary = native.build_decision_service(tmp_path / "bin")
    assert binary.parent == tmp_path / "bin"
    assert native.build_decision_service(tmp_path / "bin") == binary  # not rebuilt

    rows = pd.read_pickle(table)["state_features"].tolist()[:64]
    forward = DiscreteDqnPredictorWrapper.load(model_path)
    with open(os.path.join(model_path, "manifest.json")) as f:
        manifest = json.load(f)
    values, presence = sparse_to_dense(rows, manifest["sorted_features"])
    names, want = forward(values, presence)
    with native.decision_service(str(plans), binary=binary) as client:
        got = native.action_values(client, "dqn_q", names, rows)
    assert got.shape == (64, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, np.float64), **Q_TOL)
    # the service's process is gone once the block ends
    assert not client.healthy()


def test_serving_modules_are_copies_of_jaxs():
    """The DSL's operators: the same names, op names and inputs."""
    for name in jserving.__all__:
        assert hasattr(pserving, name), name
    for name in ("Ucb", "Softmax", "SoftmaxRanker", "EpsilonGreedyRanker", "Frechet",
                 "Expression", "PropensityFit", "ActionValueScoring", "InputFromRequest"):
        assert getattr(pserving, name).op_name == getattr(jserving, name).op_name
