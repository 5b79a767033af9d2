"""Checkpoints of the port's trainer states, and warm start against JAX.

Round trips (bit for bit, ``torch.equal``) of the unfused ``DQNTrainerState``
with its five CPE fields, of ``QRDQNTrainer``'s state and of
``FusedDQNTrainer``'s state for K1 (``block_size``) and K2; a restore held
to its template (a missing or extra field, another shape or dtype raise);
``CheckpointManager``'s retention.  Then the warm-start flow of
``tests/test_offline_e2e.py::test_warm_start_incremental_training`` through
both packages from JAX's init (carried through the manager's
``init_trainer_state`` hook, set here only), the unfused trainer with its
CPE heads (on by default, as in that test) and the fused one: the same
saved step counters, td_loss within ``test_torch_cpe_workflow.LOSS_TOL``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from reagent_tpu.core.registry import DISCRETE_DQN_NET_BUILDERS as JAX_NET_BUILDERS
from reagent_tpu.core.registry import MODEL_MANAGERS as JAX_MODEL_MANAGERS
from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.utils.checkpointing import restore_checkpoint as jax_restore_checkpoint
from reagent_tpu.workflow.gym_batch_rl import offline_gym_random as jax_offline_gym_random
from reagent_tpu.workflow.gym_batch_rl import timeline_operator as jax_timeline_operator
from reagent_tpu.workflow.training import (
    identify_and_train_network as jax_identify_and_train_network,
)
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.core.registry import MODEL_MANAGERS
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.net_builder.quantile_dqn import QuantileFullyConnected
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer
from reagent_tpu_torch.utils.checkpointing import (
    CheckpointManager,
    flatten_state,
    restore_checkpoint,
    save_checkpoint,
)
from reagent_tpu_torch.utils.interop import q_network_state_from_flax
from reagent_tpu_torch.workflow.gym_batch_rl import offline_gym_random, timeline_operator
from reagent_tpu_torch.workflow.training import identify_and_train_network
from test_torch_cpe import _batch, _batches, _trainers
from test_torch_cpe_workflow import LOSS_TOL, _carry_jax_init


def _trained_unfused_state(steps=3):
    _, _, trainer, state = _trainers(dict(gamma=0.9, target_update_rate=0.1))
    for b in _batches(5, steps):
        state, _ = trainer.train_step(state, _batch(rlt, torch.tensor, b))
    return trainer, state


def _qrdqn_state(steps=2):
    net = QuantileFullyConnected(sizes=[8], activations=["relu"], num_atoms=5)
    trainer = QRDQNTrainer(net.build_q_network(None, 3, state_dim=5), num_atoms=5,
                           rl=RLParameters(gamma=0.9), optimizer={"Adam": {"lr": 0.01}},
                           device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    for b in _batches(6, steps):
        state, _ = trainer.train_step(state, _batch(rlt, torch.tensor, b))
    return trainer, state


def _fused_state(block_size):
    trainer = FusedDQNTrainer(
        FullyConnectedDQN(state_dim=5, action_dim=3, sizes=[8, 4], activations=["relu"] * 2),
        rl=RLParameters(gamma=0.9), optimizer={"Adam": {"lr": 0.01}}, minibatch_size=32,
        block_size=block_size, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    for b in _batches(7, 2):
        state, _ = trainer.train_step(state, _batch(rlt, torch.tensor, b))
    return trainer, state


def _assert_bitwise_equal(got, want):
    flat_got, flat_want = flatten_state(got), flatten_state(want)
    assert flat_got.keys() == flat_want.keys()
    for key, w in flat_want.items():
        g = flat_got[key]
        assert g.dtype == w.dtype and g.device == w.device, key
        assert torch.equal(g, w), key
    assert type(got) is type(want)


@pytest.mark.parametrize("kind", ["unfused_cpe", "qrdqn", "fused_K1", "fused_K2"])
def test_round_trip_is_bitwise(tmp_path, kind):
    trainer, state = {
        "unfused_cpe": _trained_unfused_state, "qrdqn": _qrdqn_state,
        "fused_K1": lambda: _fused_state(16), "fused_K2": lambda: _fused_state(None),
    }[kind]()
    if kind == "unfused_cpe":
        assert all(getattr(state, f) is not None for f in (
            "reward_params", "reward_opt_state", "cpe_params", "cpe_target_params",
            "cpe_opt_state"))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    template = trainer.init(torch.Generator().manual_seed(1))
    restored = restore_checkpoint(path, template)
    _assert_bitwise_equal(restored, state)
    assert restored.step.dtype == torch.int32 and int(restored.step) == int(state.step) > 0
    # training continues from the restored state exactly as from the saved one
    b = next(_batches(9, 1))
    s1, m1 = trainer.train_step(state, _batch(rlt, torch.tensor, b))
    s2, m2 = trainer.train_step(restored, _batch(rlt, torch.tensor, b))
    _assert_bitwise_equal(s2, s1)
    assert torch.equal(m1["td_loss"], m2["td_loss"])
    # a save overwrites in place
    save_checkpoint(path, s1)
    _assert_bitwise_equal(restore_checkpoint(path, template), s1)
    assert os.listdir(tmp_path) == ["ckpt"]


def test_restore_is_held_to_its_template(tmp_path):
    trainer, state = _trained_unfused_state(1)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    without_cpe = dataclasses.replace(
        state, reward_params=None, reward_opt_state=None, cpe_params=None,
        cpe_target_params=None, cpe_opt_state=None)
    with pytest.raises(ValueError, match="unexpected"):
        restore_checkpoint(path, without_cpe)
    save_checkpoint(path, without_cpe)
    with pytest.raises(ValueError, match="missing"):
        restore_checkpoint(path, state)
    save_checkpoint(path, state)
    wide = dict(state.q_params)
    key = next(iter(wide))
    wide[key] = torch.zeros(wide[key].shape[0] + 1, *wide[key].shape[1:])
    with pytest.raises(ValueError, match=key):
        restore_checkpoint(path, dataclasses.replace(state, q_params=wide))
    with pytest.raises(ValueError, match="step"):
        restore_checkpoint(path, dataclasses.replace(state, step=state.step.long()))
    with pytest.raises(TypeError, match="str"):
        save_checkpoint(path, {"name": "not a tensor"})


def test_checkpoint_manager_keeps_the_last_k(tmp_path):
    _, state = _trained_unfused_state(1)
    mgr = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for step in (1, 5, 10):
        mgr.save(step, dataclasses.replace(state, step=torch.tensor(step, dtype=torch.int32)))
    assert mgr.all_steps() == [5, 10] and mgr.latest_step() == 10
    assert int(mgr.restore(state).step) == 10 and int(mgr.restore(state, step=5).step) == 5
    mgr.close()


# ------------------------------------------- the warm-start flow against JAX


def _warm_model(fused):
    tp = {"actions": ["0", "1"], "rl": {"gamma": 0.99, "target_update_rate": 0.2},
          "minibatch_size": 256, "optimizer": {"Adam": {"lr": 0.003}}}
    model = {"DiscreteDQN": {
        "trainer_param": tp,
        "net_builder": {"FullyConnected": {"sizes": [32], "activations": ["relu"]}}}}
    if fused:  # the fused trainer has no CPE heads, which are on by default
        tp["use_fused_kernel"] = True
        model["DiscreteDQN"]["eval_parameters"] = {"calc_cpe_in_training": False}
    return model


def _carry_jax_q_init(self, trainer, generator, state_dim):
    """The manager hook without CPE heads: JAX's workflow init
    (``PRNGKey(0)``) of the q-network, loaded into the port's trainer."""
    jnet = JAX_NET_BUILDERS.build(self.net_builder).build_q_network(
        None, len(self.action_names), state_dim=state_dim)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, state_dim)))
    trainer.q_network.load_state_dict(
        q_network_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return trainer.state_from_q_network()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_K2"])
def test_warm_start_incremental_training_matches_jax(tmp_path, monkeypatch, fused):
    for side, collect, timeline in (("torch", offline_gym_random, timeline_operator),
                                    ("jax", jax_offline_gym_random, jax_timeline_operator)):
        collect(env_name="CartPole-v1", pkl_path=str(tmp_path / f"{side}_pre.pkl"),
                num_train_transitions=1200, max_steps=100, seed=3)
        timeline(str(tmp_path / f"{side}_pre.pkl"),
                 TableSpec(path=str(tmp_path / f"{side}_table.pkl")))
    table = str(tmp_path / "torch_table.pkl")
    pd.testing.assert_frame_equal(pd.read_pickle(table),
                                  pd.read_pickle(str(tmp_path / "jax_table.pkl")))
    split = dict(table_sample=100.0, eval_table_sample=0.0)
    model = _warm_model(fused)
    monkeypatch.setattr(DiscreteDQN, "init_trainer_state",
                        _carry_jax_q_init if fused else _carry_jax_init, raising=False)

    warm, jwarm = str(tmp_path / "warm_start"), str(tmp_path / "jax_warm_start")
    manager = JAX_MODEL_MANAGERS.build(model)
    ndm = manager.run_feature_identification(pd.read_pickle(table))
    jtrainer = manager.build_trainer(ndm)
    proto = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, manager.state_dim(ndm))))
    ours_mgr = MODEL_MANAGERS.build(model)
    trainer = ours_mgr.build_trainer(ours_mgr.run_feature_identification(pd.read_pickle(table)),
                                     device="cpu")
    template = trainer.init(torch.Generator().manual_seed(0))
    steps = []
    for run in (1, 2):
        ours = identify_and_train_network(
            TableSpec(path=table, **split), model, num_epochs=2,
            output_dir=str(tmp_path / f"out{run}"), warm_start_path=warm, device="cpu")
        theirs = jax_identify_and_train_network(
            JaxTableSpec(path=table, **split), model, num_epochs=2,
            output_dir=str(tmp_path / f"jax_out{run}"), warm_start_path=jwarm)
        assert os.path.exists(warm)
        step, jstep = int(restore_checkpoint(warm, template).step), int(
            jax_restore_checkpoint(jwarm, proto).step)
        assert step == jstep > 0
        steps.append(step)
        np.testing.assert_allclose(ours.training_report.td_loss,
                                   theirs.training_report.td_loss, **LOSS_TOL)
    assert steps[1] == 2 * steps[0], steps
