"""The slice as a whole: both packages' offline DQN workflow on one table.

The port's trainer starts from JAX's seed-0 init (carried across through the
manager's ``init_trainer_state`` hook, set here only), both train through the
fused update (K1 with ``block_size``, K2 without), and the exported artifacts
are compared file by file and by their forward on the same raw rows.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.models import FullyConnectedDQN as JaxFullyConnectedDQN
from reagent_tpu.prediction.predictor_wrapper import (
    DiscreteDqnPredictorWrapper as JaxPredictorWrapper,
)
from reagent_tpu.preprocessing.normalization import deserialize as jax_deserialize
from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
from reagent_tpu.workflow.training import (
    identify_and_train_network as jax_identify_and_train_network,
)
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.prediction.predictor_wrapper import DiscreteDqnPredictorWrapper
from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
from reagent_tpu_torch.utils.interop import q_network_state_from_flax
from reagent_tpu_torch.workflow.training import identify_and_train_network

ACTIONS = ["0", "1", "2"]


def _make_table(path, n=320, seed=0):
    """6 features (4 continuous, 1 binary, 1 enum; feature 3 sometimes
    missing), 3 actions, episodes of 8 steps."""
    rng = np.random.default_rng(seed)

    def feats():
        d = {i: float(rng.normal(i, 1.0 + i)) for i in range(4)}
        d[4] = float(rng.integers(0, 2))
        d[5] = float(rng.integers(0, 3))
        if rng.random() < 0.2:
            del d[3]
        return d

    states = [feats() for _ in range(n + 1)]
    seq = np.arange(n) % 8
    a = rng.integers(0, 3, n + 1)
    df = pd.DataFrame({
        "mdp_id": [f"ep{i // 8}" for i in range(n)],
        "sequence_number": seq,
        "state_features": states[:n],
        "next_state_features": states[1:],
        "action": [ACTIONS[x] for x in a[:n]],
        "next_action": [ACTIONS[x] for x in a[1:]],
        "reward": rng.normal(size=n),
        "not_terminal": (seq != 7).astype(int),
        "time_diff": np.ones(n),
        "action_probability": np.full(n, 1 / 3),
        "possible_next_actions": [
            [] if s == 7 else [x for x in ACTIONS if rng.random() > 0.3 or x == "0"]
            for s in seq],
    })
    df.to_pickle(path)
    return df


def _model(acts, block_size):
    tp = {
        "actions": ACTIONS,
        "rl": {"gamma": 0.95, "target_update_rate": 0.1},
        "double_q_learning": True,
        "minibatch_size": 64,
        "optimizer": {"Adam": {"lr": 0.003}},
        "use_fused_kernel": True,
    }
    if block_size:
        tp["block_size"] = block_size
    return {"DiscreteDQN": {
        "trainer_param": tp,
        "net_builder": {"FullyConnected": {"sizes": [16, 8], "activations": acts}},
        "eval_parameters": {"calc_cpe_in_training": False},
    }}


def _read_artifact(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, np.fromfile(os.path.join(path, "weights.bin"), "<f4")


@pytest.mark.parametrize(
    "acts,block_size", [(["relu", "relu"], 32), (["leaky_relu", "leaky_relu"], None)],
    ids=["K1_relu", "K2_leaky_relu"])
def test_workflow_matches_jax(tmp_path, monkeypatch, acts, block_size):
    table = str(tmp_path / "table.pkl")
    df = _make_table(table)
    model = _model(acts, block_size)

    def jax_init(self, trainer, generator, state_dim):
        jnet = JaxFullyConnectedDQN(state_dim=state_dim, action_dim=len(ACTIONS),
                                    sizes=[16, 8], activations=acts)
        params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, state_dim)))
        trainer.q_network.load_state_dict(
            q_network_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
        return trainer.state_from_q_network()

    monkeypatch.setattr(DiscreteDQN, "init_trainer_state", jax_init, raising=False)
    ours = identify_and_train_network(
        TableSpec(path=table), model, num_epochs=2,
        output_dir=str(tmp_path / "torch"), device="cpu")
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table), model, num_epochs=2, output_dir=str(tmp_path / "jax"))

    assert ours.logger_data["train_steps"] == 2 * (len(df) // 64)
    np.testing.assert_allclose(
        ours.training_report.td_loss, theirs.training_report.td_loss, rtol=5e-4, atol=5e-5)
    m_ours, w_ours = _read_artifact(ours.output_paths["default_model"])
    m_theirs, w_theirs = _read_artifact(theirs.output_paths["default_model"])
    for key in ("model_type", "action_names", "normalization", "sorted_features", "layers"):
        assert m_ours[key] == m_theirs[key], key
    assert w_ours.shape == w_theirs.shape
    np.testing.assert_allclose(w_ours, w_theirs, rtol=5e-4, atol=5e-5)

    # forward of the artifacts on the same raw rows
    values, presence = sparse_to_dense(df["state_features"].tolist()[:40], m_ours["sorted_features"])
    _, q_ours = DiscreteDqnPredictorWrapper.load(ours.output_paths["default_model"])(values, presence)
    assert m_ours["activations"] == [*acts, "linear"]
    if acts[0] == "relu":
        _, q_theirs = JaxPredictorWrapper.load(theirs.output_paths["default_model"])(values, presence)
    else:
        # JAX's manifest says relu for every hidden layer (ROADMAP.md §3): hold
        # the port to JAX's in-process forward on JAX's exported weights instead
        assert m_theirs["activations"] == ["relu", "relu", "linear"]
        layers, off = {}, 0
        for i, spec in enumerate(m_theirs["layers"]):
            n = spec["in"] * spec["out"]
            kernel = w_theirs[off: off + n].reshape(spec["in"], spec["out"])
            off += n
            layers[f"Dense_{i}"] = {"kernel": kernel, "bias": w_theirs[off: off + spec["out"]]}
            off += spec["out"]
        jnet = JaxFullyConnectedDQN(state_dim=m_theirs["layers"][0]["in"],
                                    action_dim=len(ACTIONS), sizes=[16, 8], activations=acts)
        pre = JaxPreprocessor(jax_deserialize(m_theirs["normalization"]))
        q_theirs = np.asarray(jnet.apply(
            {"params": {"FullyConnectedNetwork_0": layers}},
            pre(jnp.asarray(values), jnp.asarray(presence))))
    np.testing.assert_allclose(q_ours, q_theirs, rtol=5e-4, atol=5e-5)


def test_cuda_device_without_a_card_raises(tmp_path):
    table = str(tmp_path / "table.pkl")
    _make_table(table, n=64)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        identify_and_train_network(
            TableSpec(path=table), _model(["relu", "relu"], None), num_epochs=1,
            output_dir=str(tmp_path / "out"), device="cuda")


def test_unported_paths_raise(tmp_path):
    table = str(tmp_path / "table.pkl")
    _make_table(table, n=64)
    # the CPE heads are ported on the unfused trainer
    # (tests/test_torch_cpe_workflow.py); the fused trainer has none.  Warm
    # start and reward options are ported (tests/test_torch_checkpointing.py,
    # tests/test_torch_timeline_rewards.py)
    fused_cpe = _model(["relu", "relu"], None)
    fused_cpe["DiscreteDQN"]["eval_parameters"] = {"calc_cpe_in_training": True}
    with pytest.raises(ValueError, match="use_fused_kernel does not support CPE heads"):
        identify_and_train_network(
            TableSpec(path=table, table_sample=80.0, eval_table_sample=20.0), fused_cpe,
            num_epochs=1, output_dir=str(tmp_path / "out"), device="cpu")
