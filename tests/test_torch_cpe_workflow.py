"""The slice as a whole: the flagship offline sample config, CPE on, through
both packages' ``identify_and_train_network`` on one seeded table.

The model block is read unchanged from
``reagent_tpu/workflow/sample_configs/discrete_dqn_cartpole_offline.yaml``
(in the fast case only its widths are narrowed).  Both sides start from
JAX's seed-0 init of the q-network and the two CPE heads (carried into the
port through the manager's ``init_trainer_state`` hook, set here only),
train the unfused ``DQNTrainer``, evaluate the eval split and export the
artifact; ``np.random`` is seeded alike before each side, so the
bootstraps draw the same indices.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import yaml

from reagent_tpu.core.registry import DISCRETE_DQN_NET_BUILDERS as JAX_NET_BUILDERS
from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.training.dqn_trainer import DQNTrainer as JaxDQNTrainer
from reagent_tpu.workflow.training import (
    identify_and_train_network as jax_identify_and_train_network,
)
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.utils.interop import q_network_state_from_flax
from reagent_tpu_torch.workflow.training import identify_and_train_network

CONFIG = os.path.join(os.path.dirname(__file__), "..", "reagent_tpu", "workflow",
                      "sample_configs", "discrete_dqn_cartpole_offline.yaml")
# Against JAX after the whole run (float32 training on two libraries, each
# update summed in another order and fed back through Adam); on this table
# the flagship case differs by 3e-7 in td_loss, 6.4e-5 (relative) in the
# artifact's weights, at most 2.7e-6 in an estimate, 6e-6 in MAGIC's std
# error.  MAGIC is held twice as loosely as WDR: its SLSQP may take another
# path on inputs that differ in the last bits.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
WEIGHT_TOL = dict(rtol=5e-4, atol=5e-5)
EST_TOL = dict(rel=1e-4, abs=1e-6)
MAGIC_TOL = dict(rel=2e-4, abs=1e-6)
STD_TOL = dict(rel=1e-3, abs=1e-6)


def _config():
    with open(CONFIG) as f:
        return yaml.safe_load(f)


def _make_table(path, n_episodes=120, ep_len=10, seed=0):
    """CartPole-like rows: 4 float features, 2 actions logged by a policy
    with propensities in (0.2, 0.8), rewards uniform(0, 1)."""
    rng = np.random.default_rng(seed)
    n = n_episodes * ep_len
    states = rng.normal(size=(n + 1, 4)).astype(np.float32)
    seq = np.arange(n) % ep_len
    p0 = rng.uniform(0.2, 0.8, n + 1)
    actions = (rng.random(n + 1) > p0).astype(int)
    prop = np.where(actions == 0, p0, 1 - p0)[:n]
    df = pd.DataFrame({
        "mdp_id": [f"ep{i // ep_len}" for i in range(n)],
        "sequence_number": seq,
        "state_features": [{i: float(v) for i, v in enumerate(s)} for s in states[:n]],
        "next_state_features": [{i: float(v) for i, v in enumerate(s)} for s in states[1:]],
        "action": [str(a) for a in actions[:n]],
        "next_action": [str(a) for a in actions[1:]],
        "reward": rng.uniform(0, 1, n),
        "not_terminal": (seq != ep_len - 1).astype(int),
        "time_diff": np.ones(n),
        "action_probability": prop,
        "possible_next_actions": [[] if s == ep_len - 1 else ["0", "1"] for s in seq],
    })
    df.to_pickle(path)
    return df


def _carry_jax_init(self, trainer, generator, state_dim):
    """The manager hook: JAX's workflow init (``trainer.init(PRNGKey(0),
    zeros)``) of the manager's three nets, loaded into the port's modules."""
    def build(spec):
        return JAX_NET_BUILDERS.build(spec).build_q_network(
            None, len(self.action_names), state_dim=state_dim)

    jtrainer = JaxDQNTrainer(
        build(self.net_builder), reward_network=build(self.cpe_net_builder),
        q_network_cpe=build(self.cpe_net_builder))
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, state_dim)))
    for net, params in ((trainer.q_network, jstate.q_params),
                        (trainer.reward_network, jstate.reward_params),
                        (trainer.q_network_cpe, jstate.cpe_params)):
        net.load_state_dict(q_network_state_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
    return trainer.state_from_q_network()


def _read_weights(out):
    path = out.output_paths["default_model"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, np.fromfile(os.path.join(path, "weights.bin"), "<f4")


def _assert_estimates(ours, theirs):
    for name in theirs._fields:
        g, w = getattr(ours, name), getattr(theirs, name)
        tol = MAGIC_TOL if name == "magic" else EST_TOL
        for field in ("raw", "normalized"):
            assert getattr(g, field) == pytest.approx(getattr(w, field), **tol), (name, field)
        for field in ("raw_std_error", "normalized_std_error"):
            assert getattr(g, field) == pytest.approx(getattr(w, field), **STD_TOL), (name, field)
        assert w.normalized != 0.0, name  # rewards in (0, 1): the normalised branch


@pytest.mark.parametrize("case", ["flagship", "fast"])
def test_flagship_cpe_workflow_matches_jax(tmp_path, monkeypatch, case):
    config = _config()
    model = copy.deepcopy(config["model"])
    spec = config["input_table_spec"]
    epochs = config["num_epochs"]
    assert model["DiscreteDQN"]["eval_parameters"]["calc_cpe_in_training"] is True
    if case == "fast":
        model["DiscreteDQN"]["net_builder"]["FullyConnected"]["sizes"] = [16, 8]
        model["DiscreteDQN"]["cpe_net_builder"] = {"FullyConnected": {"sizes": [16, 8]}}
        epochs = 4
    table = str(tmp_path / "table.pkl")
    _make_table(table)
    split = dict(table_sample=spec["table_sample"], eval_table_sample=spec["eval_table_sample"])

    monkeypatch.setattr(DiscreteDQN, "init_trainer_state", _carry_jax_init, raising=False)
    np.random.seed(11)
    ours = identify_and_train_network(
        TableSpec(path=table, **split), model, num_epochs=epochs,
        output_dir=str(tmp_path / "torch"), device="cpu")
    np.random.seed(11)
    theirs = jax_identify_and_train_network(
        JaxTableSpec(path=table, **split), model, num_epochs=epochs,
        output_dir=str(tmp_path / "jax"))

    assert ours.logger_data["train_steps"] == 2 * epochs
    assert ours.logger_data["eval_seconds"] > 0
    np.testing.assert_allclose(
        ours.training_report.td_loss, theirs.training_report.td_loss, **LOSS_TOL)
    m_ours, w_ours = _read_weights(ours)
    m_theirs, w_theirs = _read_weights(theirs)
    for key in ("model_type", "action_names", "normalization", "sorted_features", "layers"):
        assert m_ours[key] == m_theirs[key], key
    np.testing.assert_allclose(w_ours, w_theirs, **WEIGHT_TOL)

    got, want = ours.training_report.cpe_details, theirs.training_report.cpe_details
    _assert_estimates(got.reward_estimates, want.reward_estimates)
    assert got.metric_estimates == want.metric_estimates == {}
    for name in ("q_value_means", "q_value_stds", "action_distribution"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.keys() == w.keys() == {"0", "1"}, name
        for k in w:
            assert g[k] == pytest.approx(w[k], **EST_TOL), (name, k)


def test_chip_smoke_sample_config_is_the_yaml():
    """chip_smoke.py carries the sample config as a dict (the machine with
    the card has no PyYAML): the same table split, model block and epochs."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    config = _config()
    assert chip_smoke.SAMPLE_CONFIG == {
        "table_sample": config["input_table_spec"]["table_sample"],
        "eval_table_sample": config["input_table_spec"]["eval_table_sample"],
        "model": config["model"],
        "num_epochs": config["num_epochs"],
    }
