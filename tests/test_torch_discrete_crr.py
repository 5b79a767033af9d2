"""Discrete CRR against the JAX package: ``DiscreteCRRTrainer`` in 10-step
lockstep over five cases, its reporter arrays and ``DiscreteCRRReporter``
fed by both packages' trainers, and the ``DiscreteCRR`` manager through
both packages' ``identify_and_train_network`` on a small CartPole table from
JAX's init, with the actor artifact held to JAX's ``weights.bin``.

Inputs come from numpy seeds and go to both packages; weights and optimizer
states are JAX's init, carried through ``reagent_tpu_torch.utils.interop``.
Tolerances, float32 on two libraries: over 10 steps every metric, parameter,
target and Adam moment within rtol 1e-5, atol 1e-6 (each step sums in its
own order and Adam feeds that back; measured: at most 3.6e-7 relative in a
metric, 2.4e-7 absolute in a state tensor); the reporter's flushed values within 1e-5 as
``tests/test_torch_reporting.py`` holds the DQN reporter's; the artifact's
weights after a workflow within the workflow tolerance of
``tests/test_torch_cpe_workflow.py`` (rtol 5e-4, atol 5e-5).
"""

import copy
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
from reagent_tpu.core.registry import DISCRETE_DQN_NET_BUILDERS as JAX_NET_BUILDERS
from reagent_tpu.core.registry import MODEL_MANAGERS as JAX_MODEL_MANAGERS
from reagent_tpu.core.tracker import summary_writer_context as jax_summary_writer_context
from reagent_tpu.data.data_module import TableSpec as JaxTableSpec
from reagent_tpu.models import FullyConnectedDQN as JaxFullyConnectedDQN
from reagent_tpu.prediction.predictor_wrapper import load_predictor as jax_load_predictor
from reagent_tpu.reporting.reporters import DiscreteCRRReporter as JaxDiscreteCRRReporter
from reagent_tpu.training.discrete_crr_trainer import DiscreteCRRTrainer as JaxCRRTrainer
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
from reagent_tpu_torch.core.registry import DISCRETE_ACTOR_NET_BUILDERS, MODEL_MANAGERS
from reagent_tpu_torch.core.tracker import summary_writer_context
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.model_managers.discrete_crr import DiscreteCRR
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
from reagent_tpu_torch.reporting.reporters import DiscreteCRRReporter
from reagent_tpu_torch.training.discrete_crr_trainer import DiscreteCRRTrainer
from reagent_tpu_torch.utils.interop import crr_state_from_arrays, q_network_state_from_flax
from reagent_tpu_torch.workflow.training import identify_and_train_network
from test_torch_actor_critic import _adam, _np_tree
from test_torch_cpe_workflow import WEIGHT_TOL, _read_weights
from test_torch_gym_batch_rl import _collect
from test_torch_reporting import RecordingWriter

D, A, B = 4, 3, 32
SIZES, ACTS = [16, 8], ["leaky_relu", "leaky_relu"]
METRIC_TOL = STATE_TOL = dict(rtol=1e-5, atol=1e-6)
REPORT_TOL = dict(rtol=1e-5, atol=1e-5)
TREES = ("actor_params", "actor_target_params", "q1_params", "q1_target_params",
         "q2_params", "q2_target_params")

CASES = {
    "q1_only": dict(twin=False, kw={}),
    "twin_q": dict(twin=True, kw={}),
    "twin_q_target_actor": dict(twin=True, kw=dict(use_target_actor=True)),
    "delayed_2": dict(twin=True, kw=dict(use_target_actor=True, delayed_policy_update=2)),
    "entropy_clip": dict(twin=False, kw=dict(entropy_coeff=0.1, clip_limit=2.0,
                                             max_weight=1.5, beta=0.5)),
}


def _nets(cls, twin):
    def net():
        return cls(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS)
    return dict(actor_network=net(), q1_network=net(), q2_network=net() if twin else None)


def carry_crr_state(jstate, device="cpu"):
    """The port's ``CRRTrainerState`` from a JAX one."""
    def tree(name):
        x = getattr(jstate, name)
        return None if x is None else _np_tree(x)

    def opt(name):
        x = getattr(jstate, name)
        return None if x is None else _adam(x)

    return crr_state_from_arrays(
        tree("actor_params"), tree("actor_target_params"), tree("q1_params"),
        tree("q1_target_params"), opt("actor_opt_state"), opt("q1_opt_state"),
        np.asarray(jstate.step), device, q2_params=tree("q2_params"),
        q2_target_params=tree("q2_target_params"), q2_opt_state=opt("q2_opt_state"))


def crr_trainers(case, device="cpu", emit=False):
    """(JAX trainer, its init state, the port's trainer, the carried state)."""
    spec = CASES[case]
    rl = dict(gamma=0.9, target_update_rate=0.1)
    kw = dict(q_network_optimizer={"Adam": {"lr": 3e-3}},
              actor_network_optimizer={"Adam": {"lr": 1e-3}},
              emit_reporter_arrays=emit, **spec["kw"])
    jtrainer = JaxCRRTrainer(**_nets(JaxFullyConnectedDQN, spec["twin"]),
                             rl=JaxRLParameters(**rl), **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))
    trainer = DiscreteCRRTrainer(**_nets(FullyConnectedDQN, spec["twin"]),
                                 rl=RLParameters(**rl), device=device, **kw)
    return jtrainer, jstate, trainer, carry_crr_state(jstate, device)


def crr_batches(seed, n, batch_size=B, state_dim=D, num_actions=A):
    """numpy batches: normal states, logged actions with propensities in
    (0.2, 0.9), normal rewards, a tenth of them terminal (row 0 always)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        not_terminal = (rng.random((batch_size, 1)) > 0.1).astype(np.float32)
        not_terminal[0] = 0.0
        yield dict(s=rng.normal(size=(batch_size, state_dim)).astype(np.float32),
                   ns=rng.normal(size=(batch_size, state_dim)).astype(np.float32),
                   a=np.eye(num_actions, dtype=np.float32)[
                       rng.integers(0, num_actions, batch_size)],
                   r=rng.normal(size=(batch_size, 1)).astype(np.float32), nt=not_terminal,
                   p=rng.uniform(0.2, 0.9, (batch_size, 1)).astype(np.float32))


def crr_batch(mod, conv, b):
    ones = conv(np.ones_like(b["a"]))
    return mod.DiscreteDqnInput(
        state=mod.FeatureData(float_features=conv(b["s"])),
        next_state=mod.FeatureData(float_features=conv(b["ns"])),
        reward=conv(b["r"]), time_diff=conv(np.ones_like(b["r"])), step=None,
        not_terminal=conv(b["nt"]), action=conv(b["a"]), next_action=conv(b["a"]),
        possible_actions_mask=ones, possible_next_actions_mask=ones,
        extras=mod.ExtraData(action_probability=conv(b["p"])))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


def assert_crr_state_close(state, jstate, tol=STATE_TOL):
    for name in TREES:
        want = getattr(jstate, name)
        if want is None:
            assert getattr(state, name) is None, name
            continue
        want = q_network_state_from_flax(_np_tree(want))
        got = getattr(state, name)
        assert set(got) == set(want), name
        for k in want:
            _close(got[k], want[k], tol, f"{name} {k}")
    for name in ("actor_opt_state", "q1_opt_state", "q2_opt_state"):
        jopt = getattr(jstate, name)
        if jopt is None:
            assert getattr(state, name) is None, name
            continue
        got, want = getattr(state, name), _adam(jopt)
        assert int(got.count) == int(want.count), name
        for field in ("mu", "nu"):
            for k, v in getattr(want, field).items():
                _close(getattr(got, field)[k], v, tol, f"{name} {field} {k}")
    assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("case", list(CASES))
def test_crr_lockstep_with_jax(case):
    jtrainer, jstate, trainer, state = crr_trainers(case)
    before = {k: v.clone() for k, v in state.actor_params.items()}
    for i, b in enumerate(crr_batches(10, 10)):
        jstate, jm = jtrainer.train_step(jstate, crr_batch(jrlt, jnp.asarray, b))
        state, m = trainer.train_step(state, crr_batch(rlt, torch.tensor, b))
        assert m.keys() == jm.keys() == {"q1_loss", "q2_loss", "actor_loss"}
        for name in jm:
            _close(m[name], jm[name], METRIC_TOL, f"step {i} {name}")
        if case == "delayed_2":
            # the actor moves on even steps only, and reports 0 on the others
            assert (float(m["actor_loss"]) == 0.0) == (i % 2 == 1)
    assert_crr_state_close(state, jstate)
    assert not torch.equal(state.actor_params["net.layers.0.weight"],
                           before["net.layers.0.weight"])
    if not CASES[case]["twin"]:
        assert float(m["q2_loss"]) == 0.0 and state.q2_params is None


def test_crr_train_step_leaves_its_state_and_reads_no_host_value():
    """The step returns a new state (the one given is untouched), as the JAX
    step's functional update does."""
    *_, trainer, state = crr_trainers("delayed_2")
    saved = {k: v.clone() for k, v in state.q1_params.items()}
    new_state, _ = trainer.train_step(
        state, crr_batch(rlt, torch.tensor, next(crr_batches(1, 1))))
    assert all(torch.equal(saved[k], v) for k, v in state.q1_params.items())
    assert int(new_state.step) == 1 and int(state.step) == 0


def test_crr_reporter_arrays_and_reporter_match_jax():
    """The per-sample arrays ``emit_reporter_arrays`` adds, then both
    packages' ``DiscreteCRRReporter`` fed by their trainers: flushed means,
    action distributions and every value written to the summary writer."""
    actions = ["a0", "a1", "a2"]
    jtrainer, jstate, trainer, state = crr_trainers("twin_q", emit=True)
    ours, theirs = DiscreteCRRReporter(actions), JaxDiscreteCRRReporter(actions)
    w_ours, w_theirs = RecordingWriter(), RecordingWriter()
    with summary_writer_context(w_ours), jax_summary_writer_context(w_theirs):
        for b in crr_batches(3, 5):
            jstate, jm = jtrainer.train_step(jstate, crr_batch(jrlt, jnp.asarray, b))
            state, m = trainer.train_step(state, crr_batch(rlt, torch.tensor, b))
            assert set(m) == set(jm) == {"q1_loss", "q2_loss", "actor_loss", "logged_actions",
                                         "logged_rewards", "model_values", "model_action_idxs"}
            for name in ("logged_actions", "model_action_idxs"):
                np.testing.assert_array_equal(m[name].numpy(), np.asarray(jm[name]))
            _close(m["logged_rewards"], jm["logged_rewards"], METRIC_TOL)
            _close(m["model_values"], jm["model_values"], METRIC_TOL)
            theirs.log(**jm)
            ours.log(**m)
        f_ours, f_theirs = ours.flush(0), theirs.flush(0)
    assert set(f_ours) == set(f_theirs) >= {"q1_loss", "q2_loss", "actor_loss"}
    for key in f_theirs:
        _close(f_ours[key], f_theirs[key], REPORT_TOL, key)
    for name in ("logged_actions", "model_action_idxs"):
        assert ours.observer(name).values == theirs.observer(name).values, name
    for kind in ("scalars", "histograms"):
        got, want = getattr(w_ours, kind), getattr(w_theirs, kind)
        assert set(got) == set(want) and want, kind
        for tag in want:
            assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
            for (_, g), (_, w) in zip(got[tag], want[tag]):
                _close(g, w, REPORT_TOL, tag)


# ------------------------------------------------------------- the manager

MODEL = {
    "DiscreteCRR": {
        "trainer_param": {
            "actions": ["0", "1"],
            "rl": {"gamma": 0.99, "target_update_rate": 0.1},
            "optimizer": {"Adam": {"lr": 0.003}},
            "beta": 1.0,
            "minibatch_size": 128,
        },
        "net_builder": {"FullyConnected": {"sizes": [16, 8], "activations": ["relu", "relu"]}},
        "actor_net_builder": {"FullyConnected": {"sizes": [16, 8],
                                                 "activations": ["leaky_relu", "relu"]}},
    }
}


def _carry_jax_crr_init(self, trainer, generator, state_dim):
    """The manager hook: JAX's workflow init (``trainer.init(PRNGKey(0),
    zeros)``) of the manager's actor and twin critics, in the port's modules."""
    def build(spec):
        return JAX_NET_BUILDERS.build(spec).build_q_network(
            None, len(self.action_names), state_dim=state_dim)

    jtrainer = JaxCRRTrainer(actor_network=build(self.actor_net_builder),
                             q1_network=build(self.net_builder),
                             q2_network=build(self.net_builder))
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, state_dim)))
    for net, params in ((trainer.actor_network, jstate.actor_params),
                        (trainer.q1_network, jstate.q1_params),
                        (trainer.q2_network, jstate.q2_params)):
        net.load_state_dict(q_network_state_from_flax(_np_tree(params)))
    return trainer.state_from_networks()


def test_crr_manager_builds_the_jax_managers_nets():
    manager, jmanager = (reg.build(copy.deepcopy(MODEL))
                         for reg in (MODEL_MANAGERS, JAX_MODEL_MANAGERS))
    assert isinstance(manager, DiscreteCRR)
    norm = {NormalizationKey.STATE: NormalizationData(dense_normalization_parameters={
        i: NormalizationParameters(feature_type="CONTINUOUS", mean=0.0, stddev=1.0)
        for i in range(4)})}
    trainer = manager.build_trainer(norm, device="cpu")
    assert trainer.q2_network is not None and trainer.emit_reporter_arrays
    assert (trainer.beta, trainer.max_weight, trainer.gamma, trainer.tau) == (1.0, 20.0, 0.99, 0.1)
    assert trainer.actor_network.activations == ["leaky_relu", "relu", "linear"]
    assert isinstance(manager.get_reporter(), DiscreteCRRReporter)
    assert type(jmanager).__name__ == "DiscreteCRR"
    actor = DISCRETE_ACTOR_NET_BUILDERS.build(
        {"FullyConnected": {"sizes": [8], "activations": ["tanh"]}}).build_actor(
        None, 2, state_dim=4)
    assert [l.weight.shape for l in actor.net.layers] == [(8, 4), (2, 8)]


def test_crr_workflow_matches_jax(tmp_path, monkeypatch):
    """Both packages' ``identify_and_train_network`` with the ``DiscreteCRR``
    block on 1,200 random CartPole transitions (95/5 split, 2 epochs) from
    JAX's init; the port's actor artifact (true activations) against JAX's
    ``weights.bin`` and against the in-process actor through
    ``load_predictor``; no CPE evaluation, as in JAX."""
    _, table = _collect(str(tmp_path), "torch", 1200, seed=3)
    split = dict(table_sample=95.0, eval_table_sample=5.0)
    monkeypatch.setattr(DiscreteCRR, "init_trainer_state", _carry_jax_crr_init, raising=False)
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
    m_ours, w_ours = _read_weights(ours)
    m_theirs, w_theirs = _read_weights(theirs)
    for key in ("model_type", "action_names", "normalization", "sorted_features", "layers"):
        assert m_ours[key] == m_theirs[key], key
    assert m_ours["model_type"] == "discrete_dqn"
    assert m_ours["activations"] == ["leaky_relu", "relu", "linear"]
    assert m_theirs["activations"] == ["relu", "relu", "linear"]  # ROADMAP.md §3
    np.testing.assert_allclose(w_ours, w_theirs, **WEIGHT_TOL)

    # both packages' load_predictor score the port's artifact alike
    path = ours.output_paths["default_model"]
    predictor, jpredictor = load_predictor(path), jax_load_predictor(path)
    rng = np.random.default_rng(0)
    for _ in range(16):
        features = {i: float(v) for i, v in enumerate(rng.normal(size=4))}
        names, logits = predictor.predict(features)
        jnames, jlogits = jpredictor.predict(features)
        assert names == jnames == ["0", "1"] and logits.shape == (1, 2)
        np.testing.assert_allclose(logits, jlogits, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- online, generic loop

def test_online_crr_runs_through_the_generic_loop():
    """``tests/test_gym_all_algos.py``'s online CRR flow at a small size: the
    actor's softmax acts through the K3 scorer, each sample takes its n-step
    rewards from K4, the loop records q1's loss (JAX's
    ``metrics.get("td_loss", metrics.get("q1_loss"))``)."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.ops import fused_mlp, nstep_replay
    from reagent_tpu_torch.replay import ReplayBuffer

    env = CartPole(max_steps=50, device="cpu")
    nets = {k: FullyConnectedDQN(4, 2, [16, 8], ACTS) for k in ("actor_network", "q1_network")}
    trainer = DiscreteCRRTrainer(**nets, rl=RLParameters(gamma=0.99, target_update_rate=0.2),
                                 q_network_optimizer={"Adam": {"lr": 3e-3}},
                                 actor_network_optimizer={"Adam": {"lr": 3e-3}}, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=512, update_horizon=1, gamma=0.99, device="cpu")
    rs = rb.init(observation=torch.zeros(4), action=torch.tensor(0, dtype=torch.int32),
                 reward=torch.tensor(0.0), terminal=torch.tensor(False))
    gen = torch.Generator().manual_seed(1)
    rs = prefill_replay_buffer(env, rb, rs, gen, num_steps=200)
    sampler = SoftmaxActionSampler()

    def policy_act(ts, obs, generator):
        out = sampler.sample_action(trainer.actor_logits(ts, obs[None]), generator)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    calls = (fused_mlp.fused_mlp_forward_reference.calls,
             nstep_replay.nstep_rewards_reference.calls)
    q1_before = state.q1_params["net.layers.0.weight"].clone()
    state, rs, aux = run_online_training(
        env, trainer, state, rb, rs, policy_act, lambda d: make_discrete_dqn_batch(d, 2), gen,
        OnlineLoopConfig(num_steps=40, minibatch_size=32))
    assert (fused_mlp.fused_mlp_forward_reference.calls - calls[0],
            nstep_replay.nstep_rewards_reference.calls - calls[1]) == (40, 40)
    assert aux["td_losses"].shape == (40,) and bool(torch.isfinite(aux["td_losses"]).all())
    assert int(state.step) == 40 and int(rs.add_count) == 240
    assert not torch.equal(state.q1_params["net.layers.0.weight"], q1_before)


def test_chip_smoke_discrete_actor_configs_are_the_references():
    """``chip_smoke.py``'s discrete-actor phases run the reference tests'
    configurations at their widths; only depth is cut."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test",
        os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    # tests/test_offline_managers.py:34-45
    assert chip_smoke.CRR_OFFLINE_MODEL == {"DiscreteCRR": {
        "trainer_param": {"actions": ["0", "1"],
                          "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                          "optimizer": {"Adam": {"lr": 0.003}}, "beta": 1.0},
        "net_builder": {"FullyConnected": {"sizes": [64, 64],
                                           "activations": ["relu", "relu"]}},
        "actor_net_builder": {"FullyConnected": {"sizes": [64, 64],
                                                 "activations": ["relu", "relu"]}}}}
    off, on = chip_smoke.CRR_OFFLINE, chip_smoke.CRR_ONLINE
    assert (off["transitions"], off["max_steps"], off["seed"], off["split"]) == (
        10_000, 200, 3, (95.0, 5.0))
    assert off["epochs"] <= off["full_epochs"] == 20 and off["bar"] == 100.0
    # tests/test_gym_all_algos.py:292-323
    assert (on["widths"], on["act"], on["B"], on["gamma"], on["tau"], on["lr"], on["beta"],
            on["prefill"], on["capacity"]) == ([128, 64], "leaky_relu", 256, 0.99, 0.2, 3e-3,
                                               1.0, 3000, 50_000)
    assert on["steps"] <= on["full_steps"] == 15_000 and on["bar"] == 100.0
    # tests/test_policy_gradient_trainers.py:151-213
    pg = chip_smoke.PG_CONFIGS
    assert pg["REINFORCE"]["widths"] == [64, 64] and pg["PPO"]["widths"] == [32, 32]
    assert pg["REINFORCE"]["optimizer"] == {"Adam": {"lr": 5e-3}}
    assert pg["PPO"]["optimizer"] == {"Adam": {"lr": 1e-3, "weight_decay": 1e-3}}
    assert pg["PPO"]["kw"] == dict(gamma=0.99, ppo_epsilon=0.2, update_epochs=1,
                                   normalize=True, subtract_mean=True)
    assert pg["REINFORCE"]["kw"] == dict(gamma=0.99, normalize=True, subtract_mean=True)
    assert [(c["full_episodes"], c["bar"]) for c in pg.values()] == [(300, 180.0), (700, 180.0)]
    assert chip_smoke.PG_MAX_STEPS == 200
