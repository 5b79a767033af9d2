"""The actor-critic slice against the JAX package, module by module: the
functional Pendulum, the three actors, the critic, the value net, the
``Postprocessor``, ``PolicyNetworkBatchPreprocessor``, ``SACTrainer`` in
5-step lockstep (four cases) and ``TD3Trainer`` in 4-step lockstep, and the
SAC and TD3 managers' feature identification and ``build_trainer``.

Inputs come from numpy seeds and go to both packages; weights and optimizer
state are JAX's init, carried through ``reagent_tpu_torch.utils.interop``.
The JAX modules draw their noise from a key; the port's take the draw
itself, so each side is given JAX's draws (``jax.random.split``, then
``jax.random.normal``, as numpy).  Tolerances, float32 on two libraries:
a forward within rtol 1e-5, atol 1e-6; the lockstep metrics, parameters,
targets, Adam moments and log-alpha within rtol 1e-5, atol 1e-6 over 5
steps (measured: at most 8.5e-7 relative in a metric, 6e-8 absolute in a
parameter, because each step sums in its own order and Adam feeds that
back at about lr a step).  The Dirichlet actor's samples cannot follow
``jax.random.dirichlet``'s stream: its mean and log-prob are held as a
forward is, its samples by their first moments.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import reagent_tpu.model_managers  # noqa: F401 — registers the JAX managers
import reagent_tpu_torch.model_managers  # noqa: F401 — registers managers and builders
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import NormalizationParameters as JaxNormalizationParameters
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.core.registry import MODEL_MANAGERS as JAX_MODEL_MANAGERS
from reagent_tpu.gym.envs.functional import Pendulum as JaxPendulum
from reagent_tpu.models import actor as jax_actor
from reagent_tpu.models.critic import FullyConnectedCritic as JaxCritic
from reagent_tpu.models.value import ValueNetwork as JaxValueNetwork
from reagent_tpu.preprocessing.normalization import serialize as jax_serialize
from reagent_tpu.preprocessing.postprocessor import Postprocessor as JaxPostprocessor
from reagent_tpu.training.sac_trainer import CRRWeightFn as JaxCRRWeightFn
from reagent_tpu.training.sac_trainer import SACTrainer as JaxSACTrainer
from reagent_tpu.training.td3_trainer import TD3Trainer as JaxTD3Trainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import NormalizationParameters, RLParameters
from reagent_tpu_torch.core.registry import (
    CONTINUOUS_ACTOR_NET_BUILDERS,
    MODEL_MANAGERS,
    PARAMETRIC_DQN_NET_BUILDERS,
    VALUE_NET_BUILDERS,
)
from reagent_tpu_torch.gym.envs import Pendulum
from reagent_tpu_torch.models import actor
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.models.value import ValueNetwork
from reagent_tpu_torch.preprocessing.normalization import serialize
from reagent_tpu_torch.preprocessing.postprocessor import Postprocessor
from reagent_tpu_torch.training.sac_trainer import CRRWeightFn, SACTrainer
from reagent_tpu_torch.training.td3_trainer import TD3Trainer
from reagent_tpu_torch.utils.checkpointing import restore_checkpoint, save_checkpoint
from reagent_tpu_torch.utils.interop import (
    opt_state_from_arrays,
    q_network_state_from_flax,
    sac_state_from_arrays,
    td3_state_from_arrays,
)

D, A, B = 3, 1, 64
SIZES, ACTS = [16, 16], ["leaky_relu", "leaky_relu"]
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
DIRICHLET_LP_TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(module, jparams):
    """``module`` holding JAX's parameters."""
    module.load_state_dict(q_network_state_from_flax(_np_tree(jparams)))
    return module


def _obs(seed, n=B, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _close(got, want, tol=FWD_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), err_msg=msg, **tol)


# --------------------------------------------------------------- Pendulum

def test_pendulum_matches_jax_for_200_steps():
    """``reset_from_uniform`` then 200 steps of out-of-range torques on a
    batch of 4 envs, against JAX's env stepping each one.  The float32
    operations are JAX's in its order, but sin and cos of two libraries part
    by an ulp, and the swing amplifies that (two free-running trajectories
    differ by 1.8e-3 at step 150), so every step starts from JAX's states
    and is held within rtol 1e-6, atol 1e-6."""
    rng = np.random.default_rng(0)
    u = rng.random((4, 2)).astype(np.float32)
    torques = rng.uniform(-2.5, 2.5, (200, 4)).astype(np.float32)
    env, jenv = Pendulum(max_steps=200, device="cpu"), JaxPendulum(max_steps=200)
    tol = dict(rtol=1e-6, atol=1e-6)
    state, obs = env.reset_from_uniform(torch.tensor(u))
    _close(state.physics[:, 0], -math.pi + 2 * math.pi * u[:, 0])
    jstates = [jenv.reset_from_uniform(jnp.asarray(u[e])) for e in range(4)]
    _close(obs, np.stack([np.asarray(o) for _, o in jstates]), tol)
    jstates = [s for s, _ in jstates]
    for k in range(200):
        state = type(state)(
            physics=torch.tensor(np.stack([np.asarray(s.physics) for s in jstates])),
            t=torch.tensor(np.stack([np.asarray(s.t) for s in jstates])))
        state, obs, reward, done = env.step(state, torch.tensor(torques[k])[:, None])
        for e in range(4):
            jstates[e], jobs, jreward, jdone = jenv.step(jstates[e], jnp.asarray(torques[k, e]),
                                                         None)
            _close(obs[e], jobs, tol, f"env {e} step {k}")
            _close(state.physics[e], jstates[e].physics, tol)
            _close(reward[e], jreward, tol)
            assert bool(done[e]) == bool(jdone) == (k == 199)
    assert state.t.dtype == torch.int32 and obs.shape == (4, 3) and reward.shape == (4,)
    # one env, unbatched, and a [1]-shaped torque
    single, _ = env.reset_from_uniform(torch.tensor(u[0]))
    single, sobs, sreward, _ = env.step(single, torch.tensor([torques[0, 0]]))
    jstate, jobs, jreward, _ = jenv.step(jenv.reset_from_uniform(jnp.asarray(u[0]))[0],
                                         jnp.asarray(torques[0, 0]), None)
    _close(sobs, jobs, tol)
    _close(sreward, jreward, tol)
    assert Pendulum.observation_dim == 3 and not Pendulum.discrete


# ----------------------------------------------------------------- actors

def _gaussian_pair(seed=0):
    jnet = jax_actor.GaussianFullyConnectedActor(
        state_dim=D, action_dim=2, sizes=SIZES, activations=ACTS)
    jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, D)))
    net = actor.GaussianFullyConnectedActor(D, 2, SIZES, ACTS)
    return jnet, jparams, _carry(net, jparams)


def _assert_squashed_log_prob_close(got, want, squashed):
    """The squash correction log(1 - a^2 + 1e-6) turns an error d in a into
    2|a|d / (1 - a^2 + 1e-6): near a = +-1 one ulp of tanh (the two
    libraries' differ by up to 6 ulps of 2^-24 there, 3.7e-7) becomes a
    large one in the log-prob.  Each row is held to rtol 1e-5, atol 1e-6
    plus that conditioning at d = 8 ulps, summed over the action's dims."""
    a = np.asarray(squashed, np.float64)
    cond = np.sum(2 * 8 * 2.0**-24 / (1 - a**2 + 1e-6), axis=1, keepdims=True)
    got = got.detach().numpy()
    want = np.asarray(want)
    assert (np.abs(got - want) <= 1e-6 + 1e-5 * np.abs(want) + cond).all(), np.abs(got - want).max()


@torch.no_grad()
def test_gaussian_actor_forward_and_log_prob_match_jax():
    jnet, jparams, net = _gaussian_pair()
    obs = _obs(1)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (B, 2)))
    for got, want in ((net(torch.tensor(obs), torch.tensor(noise)),
                       jnet.apply(jparams, jnp.asarray(obs), key)),
                      (net(torch.tensor(obs)), jnet.apply(jparams, jnp.asarray(obs)))):
        _close(got.action, want.action, msg="action")
        _assert_squashed_log_prob_close(got.log_prob, want.log_prob, want.action)
        _close(got.squashed_mean, want.squashed_mean, msg="squashed_mean")
        assert got.log_prob.shape == (B, 1)
    # get_log_prob of logged actions, some past the squash's clip
    logged = np.random.default_rng(2).uniform(-1.2, 1.2, (B, 2)).astype(np.float32)
    _assert_squashed_log_prob_close(
        net.get_log_prob(torch.tensor(obs), torch.tensor(logged)),
        jnet.apply(jparams, jnp.asarray(obs), jnp.asarray(logged), method="get_log_prob"),
        np.clip(logged, -1 + 1e-6, 1 - 1e-6))
    # the layer norms after the trunk (JAX's loc_ln and scale_ln), which
    # once raised: on one action dim each returns its bias, as in JAX
    jln = jax_actor.GaussianFullyConnectedActor(state_dim=D, action_dim=1, sizes=SIZES,
                                                activations=ACTS, use_layer_norm=True)
    ln_params = jln.init(jax.random.PRNGKey(3), jnp.asarray(obs))
    ln_net = _carry(actor.GaussianFullyConnectedActor(D, 1, SIZES, ACTS, use_layer_norm=True),
                    ln_params)
    got, want = ln_net(torch.tensor(obs)), jln.apply(ln_params, jnp.asarray(obs))
    _close(got.action, want.action, msg="layer-norm action")
    _assert_squashed_log_prob_close(got.log_prob, want.log_prob, want.action)


@pytest.mark.parametrize("exploration_variance", [None, 0.3])
@torch.no_grad()
def test_fully_connected_actor_matches_jax(exploration_variance):
    kw = dict(state_dim=D, action_dim=2, sizes=SIZES, activations=ACTS,
              exploration_variance=exploration_variance)
    jnet = jax_actor.FullyConnectedActor(**kw)
    jparams = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, D)))
    net = _carry(actor.FullyConnectedActor(**kw), jparams)
    obs, key = _obs(4), jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (B, 2)))
    got = net(torch.tensor(obs), torch.tensor(noise))
    want = jnet.apply(jparams, jnp.asarray(obs), key)
    _close(got.action, want.action)
    _close(got.log_prob, want.log_prob)
    plain = net(torch.tensor(obs))
    _close(plain.action, jnet.apply(jparams, jnp.asarray(obs)).action)
    assert float(plain.log_prob.abs().sum()) == 0.0
    if exploration_variance is not None:
        assert not torch.equal(got.action, plain.action)


@torch.no_grad()
def test_dirichlet_actor_mean_log_prob_and_sample_moments():
    kw = dict(state_dim=D, action_dim=3, sizes=SIZES, activations=ACTS)
    jnet = jax_actor.DirichletFullyConnectedActor(**kw)
    jparams = jnet.init(jax.random.PRNGKey(6), jnp.zeros((1, D)))
    net = _carry(actor.DirichletFullyConnectedActor(**kw), jparams)
    obs = _obs(8)
    got, want = net(torch.tensor(obs)), jnet.apply(jparams, jnp.asarray(obs))
    _close(got.action, want.action)
    # the log-prob sums terms of up to ~10 that cancel: held at atol 1e-5
    _close(got.log_prob, want.log_prob, DIRICHLET_LP_TOL)
    # 20,000 draws for one state: each side's sample mean is the
    # concentration's mean within 4 standard errors (at most 0.5/sqrt(n))
    many = np.repeat(obs[:1], 20000, axis=0)
    mean = want.action[0]
    sampled = net(torch.tensor(many), torch.Generator().manual_seed(0))
    jsampled = jnet.apply(jparams, jnp.asarray(many), jax.random.PRNGKey(0))
    bound = 4 * 0.5 / math.sqrt(len(many))
    for draws in (sampled.action.numpy(), np.asarray(jsampled.action)):
        assert np.allclose(draws.sum(axis=1), 1.0, atol=1e-5)
        assert np.abs(draws.mean(axis=0) - np.asarray(mean)).max() < bound
    # the log-prob of the port's draws, as JAX computes it
    x = sampled.action[:64]
    conc = torch.logaddexp(net.net(torch.tensor(many[:64])), torch.zeros(64, 3)) + 1.0
    _close(sampled.log_prob[:64, 0], jax_actor._dirichlet_log_prob(
        jnp.asarray(conc.numpy()), jnp.asarray(x.numpy())), DIRICHLET_LP_TOL)


# ------------------------------------------------------ critic, value, post

@torch.no_grad()
def test_critic_and_value_match_jax():
    jcritic = JaxCritic(state_dim=D, action_dim=2, sizes=SIZES, activations=ACTS)
    jc_params = jcritic.init(jax.random.PRNGKey(1), jnp.zeros((1, D)), jnp.zeros((1, 2)))
    critic = _carry(FullyConnectedCritic(D, 2, SIZES, ACTS), jc_params)
    jvalue = JaxValueNetwork(state_dim=D, sizes=SIZES, activations=ACTS)
    jv_params = jvalue.init(jax.random.PRNGKey(2), jnp.zeros((1, D)))
    value = _carry(ValueNetwork(D, SIZES, ACTS), jv_params)
    obs, act = _obs(3), _obs(4, d=2)
    _close(critic(torch.tensor(obs), torch.tensor(act)),
           jcritic.apply(jc_params, jnp.asarray(obs), jnp.asarray(act)))
    _close(value(torch.tensor(obs)), jvalue.apply(jv_params, jnp.asarray(obs)))
    # batch norm and layer norm, which once raised, as JAX's
    for i, kw in enumerate((dict(use_batch_norm=True), dict(use_layer_norm=True))):
        jc = JaxCritic(state_dim=D, action_dim=2, sizes=SIZES, activations=ACTS, **kw)
        params = jc.init(jax.random.PRNGKey(5 + i), jnp.zeros((1, D)), jnp.zeros((1, 2)))
        c = _carry(FullyConnectedCritic(D, 2, SIZES, ACTS, **kw), params)
        _close(c(torch.tensor(obs), torch.tensor(act)),
               jc.apply(params, jnp.asarray(obs), jnp.asarray(act)), msg=str(kw))


@pytest.mark.parametrize("feature_type", ["CONTINUOUS_ACTION", "DO_NOT_PREPROCESS"])
def test_postprocessor_matches_jax(feature_type):
    spec = {10: dict(feature_type=feature_type, min_value=-2.0, max_value=2.0),
            11: dict(feature_type=feature_type, min_value=0.5, max_value=3.0)}
    post = Postprocessor({k: NormalizationParameters(**v) for k, v in spec.items()})
    jpost = JaxPostprocessor({k: JaxNormalizationParameters(**v) for k, v in spec.items()})
    x = np.random.default_rng(0).uniform(-1.3, 1.3, (32, 2)).astype(np.float32)
    got = post(torch.tensor(x))
    _close(got, jpost(jnp.asarray(x)))
    if feature_type == "CONTINUOUS_ACTION":
        assert float(got[:, 0].min()) >= -2.0 and float(got[:, 0].max()) <= 2.0
    else:
        assert torch.equal(got, torch.tensor(x))
    with pytest.raises(ValueError, match="not an action type"):
        Postprocessor({0: NormalizationParameters(feature_type="CONTINUOUS", mean=0.0,
                                                  stddev=1.0)})


# ------------------------------------------------- batches and the managers

def pendulum_rows(n_episodes=6, ep_len=40, seed=0):
    """Timeline-shaped Pendulum rows: 3 state features, one action in
    [-2, 2], the last row of each episode terminal (no next action)."""
    rng = np.random.default_rng(seed)
    rows = []
    for ep in range(n_episodes):
        states = rng.normal(size=(ep_len + 1, 3))
        actions = rng.uniform(-2, 2, ep_len + 1)
        for t in range(ep_len):
            last = t == ep_len - 1
            rows.append({
                "mdp_id": str(ep), "sequence_number": t,
                "state_features": {i: float(v) for i, v in enumerate(states[t])},
                "next_state_features": {i: float(v) for i, v in enumerate(states[t + 1])},
                "action": {0: float(actions[t])},
                "next_action": {} if last else {0: float(actions[t + 1])},
                "reward": float(-abs(states[t, 0])), "not_terminal": int(not last),
                "time_diff": 1, "action_probability": 1.0,
            })
    return pd.DataFrame(rows)


SAC_MODEL = {"SAC": {
    "trainer_param": {
        "rl": {"gamma": 0.9, "target_update_rate": 0.5}, "entropy_temperature": 0.01,
        "minibatch_size": 64, "q_network_optimizer": {"Adam": {"lr": 0.001}},
        "actor_network_optimizer": {"Adam": {"lr": 0.001}}},
    "actor_net_builder": {"GaussianFullyConnected": {"sizes": SIZES, "activations": ACTS}},
    "critic_net_builder": {"FullyConnected": {"sizes": SIZES, "activations": ACTS}},
}}
TD3_MODEL = {"TD3": {
    "trainer_param": {
        "rl": {"gamma": 0.99, "target_update_rate": 0.05}, "minibatch_size": 64,
        "noise_variance": 0.3, "delayed_policy_update": 3},
    "actor_net_builder": {"FullyConnected": {"sizes": SIZES, "activations": ACTS}},
    "critic_net_builder": {"FullyConnected": {"sizes": [8], "activations": ["relu"]}},
    "use_2_q_functions": False,
}}


@pytest.mark.parametrize("model", [SAC_MODEL, TD3_MODEL], ids=["SAC", "TD3"])
def test_manager_identification_and_build_trainer_match_jax(model):
    df = pendulum_rows()
    manager, jmanager = MODEL_MANAGERS.build(model), JAX_MODEL_MANAGERS.build(model)
    ndm, jndm = manager.run_feature_identification(df), jmanager.run_feature_identification(df)
    assert ndm.keys() == jndm.keys() == {"state", "action"}
    for key in ndm:
        assert serialize(ndm[key].dense_normalization_parameters) == jax_serialize(
            jndm[key].dense_normalization_parameters), key
    assert {p.feature_type for p in ndm["action"].dense_normalization_parameters.values()} == {
        "DO_NOT_PREPROCESS"}
    assert (manager.state_dim(ndm), manager.action_dim(ndm)) == (3, 1)
    assert manager._param.minibatch_size == 64
    trainer, jtrainer = manager.build_trainer(ndm, device="cpu"), jmanager.build_trainer(jndm)
    for name in ("gamma", "tau", "entropy_temperature", "target_entropy", "autotune_alpha",
                 "noise_variance", "noise_clip", "delayed_policy_update"):
        assert getattr(trainer, name, None) == getattr(jtrainer, name, None), name
    assert (trainer.q2_network is None) == (jtrainer.q2_network is None)
    state = trainer.init(torch.Generator().manual_seed(0))
    jstate = jmanager.init_trainer_state(jtrainer, jax.random.PRNGKey(0), 3)
    for name in ("actor_params", "q1_params", "q2_params"):
        want = getattr(jstate, name)
        if want is None:
            assert getattr(state, name) is None
            continue
        want = q_network_state_from_flax(_np_tree(want))
        got = getattr(state, name)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}, name
    assert type(manager.get_reporter()).__name__ == (
        "ActorCriticReporter" if "SAC" in model else "TD3Reporter")


def test_policy_network_batch_preprocessor_matches_jax():
    df = pendulum_rows(seed=3)
    manager, jmanager = MODEL_MANAGERS.build(SAC_MODEL), JAX_MODEL_MANAGERS.build(SAC_MODEL)
    batch = manager.build_batch_preprocessor(manager.run_feature_identification(df),
                                             device="cpu")(df)
    jbatch = jmanager.build_batch_preprocessor(jmanager.run_feature_identification(df))(df)
    for name in ("state", "next_state", "action", "next_action"):
        _close(getattr(batch, name).float_features, getattr(jbatch, name).float_features,
               msg=name)
    for name in ("reward", "time_diff", "step", "not_terminal"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    assert batch.state.float_features.shape == (len(df), 3)
    assert batch.action.float_features.shape == (len(df), 1)
    terminal = df["not_terminal"].to_numpy() == 0
    assert float(batch.next_action.float_features[terminal].abs().sum()) == 0.0


# ------------------------------------------------------- trainer lockstep

def _adam(opt_state, scalar=False):
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            mu, nu = _np_tree(leaf.mu), _np_tree(leaf.nu)
            if scalar:
                mu, nu = {"log_alpha": mu}, {"log_alpha": nu}
            return opt_state_from_arrays(count=np.asarray(leaf.count), mu=mu, nu=nu)
    raise AssertionError("no Adam state in the optax chain")


def _policy_batches(seed, n, action_low=-1.0, action_high=1.0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        not_terminal = (rng.random((B, 1)) > 0.1).astype(np.float32)
        not_terminal[0] = 0.0
        yield dict(s=rng.normal(size=(B, D)).astype(np.float32),
                   ns=rng.normal(size=(B, D)).astype(np.float32),
                   a=rng.uniform(action_low, action_high, (B, A)).astype(np.float32),
                   r=rng.normal(size=(B, 1)).astype(np.float32), nt=not_terminal)


def _policy_batch(mod, conv, b):
    return mod.PolicyNetworkInput(
        state=mod.FeatureData(float_features=conv(b["s"])),
        next_state=mod.FeatureData(float_features=conv(b["ns"])),
        action=mod.FeatureData(float_features=conv(b["a"])),
        next_action=mod.FeatureData(float_features=conv(b["a"])),
        reward=conv(b["r"]), time_diff=None, step=None, not_terminal=conv(b["nt"]))


def sac_noise(key, batch_size, action_dim):
    """(the key after the step, the port's ``noise`` [2, B, A]) as JAX's
    ``SACTrainer.train_step`` draws it from ``key``."""
    key, r_next, r_actor = jax.random.split(key, 3)
    return key, torch.tensor(np.stack([
        np.asarray(jax.random.normal(r, (batch_size, action_dim))) for r in (r_next, r_actor)]))


def td3_noise(key, batch_size, action_dim):
    key, r_noise = jax.random.split(key)
    return key, torch.tensor(np.asarray(jax.random.normal(r_noise, (batch_size, action_dim))))


def carry_sac_state(jstate, device="cpu"):
    """The port's ``SACTrainerState`` from a JAX one."""
    def tree(name):
        x = getattr(jstate, name)
        return None if x is None else _np_tree(x)

    def opt(name, scalar=False):
        x = getattr(jstate, name)
        return None if x is None else _adam(x, scalar)

    return sac_state_from_arrays(
        tree("actor_params"), tree("q1_params"), tree("q1_target_params"),
        opt("actor_opt_state"), opt("q1_opt_state"), np.asarray(jstate.step), device,
        q2_params=tree("q2_params"), q2_target_params=tree("q2_target_params"),
        q2_opt_state=opt("q2_opt_state"), log_alpha=tree("log_alpha"),
        alpha_opt_state=opt("alpha_opt_state", scalar=True),
        value_params=tree("value_params"), value_target_params=tree("value_target_params"),
        value_opt_state=opt("value_opt_state"))


def _assert_state_close(state, jstate, trees, tol=STEP_TOL):
    for name in trees:
        want = getattr(jstate, name)
        if want is None:
            assert getattr(state, name) is None, name
            continue
        want = q_network_state_from_flax(_np_tree(want))
        got = getattr(state, name)
        assert set(got) == set(want), name
        for k in want:
            _close(got[k], want[k].numpy(), tol, f"{name} {k}")
    assert int(state.step) == int(jstate.step)


def _assert_adam_close(got, jopt, scalar=False, tol=STEP_TOL):
    want = _adam(jopt, scalar)
    assert int(got.count) == int(want.count)
    for field in ("mu", "nu"):
        for k, v in getattr(want, field).items():
            _close(getattr(got, field)[k], v.numpy(), tol, f"{field} {k}")


SAC_TREES = ("actor_params", "q1_params", "q1_target_params", "q2_params", "q2_target_params",
             "value_params", "value_target_params")
SAC_CASES = {
    # the sample config's trainer: twin Q, autotuned temperature
    "twin_q_autotune": dict(twin=True, value=False, kw={}),
    "one_q_fixed_alpha": dict(twin=False, value=False, kw=dict(alpha_optimizer=None)),
    "value_net": dict(twin=True, value=True,
                      kw=dict(value_network_optimizer={"Adam": {"lr": 0.003}})),
    "crr": dict(twin=True, value=True, kw=dict(
        crr_config={"exponent_beta": 1.0, "exponent_clamp": 20.0},
        backprop_through_log_prob=False)),
}


def sac_trainers(case, device="cpu"):
    """(JAX trainer, its init state, the port's trainer, the carried state)."""
    spec = SAC_CASES[case]

    def nets(Actor, Critic, Value):
        return dict(
            actor_network=Actor(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS),
            q1_network=Critic(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS),
            q2_network=(Critic(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS)
                        if spec["twin"] else None),
            value_network=(Value(state_dim=D, sizes=SIZES, activations=ACTS)
                           if spec["value"] else None))

    rl = dict(gamma=0.9, target_update_rate=0.5)
    kw = dict(q_network_optimizer={"Adam": {"lr": 0.001}},
              actor_network_optimizer={"Adam": {"lr": 0.001}}, entropy_temperature=0.01,
              **spec["kw"])
    jtrainer = JaxSACTrainer(
        **nets(jax_actor.GaussianFullyConnectedActor, JaxCritic, JaxValueNetwork),
        rl=JaxRLParameters(**rl), **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), jnp.zeros((1, A)))
    trainer = SACTrainer(
        **nets(actor.GaussianFullyConnectedActor, FullyConnectedCritic, ValueNetwork),
        rl=RLParameters(**rl), device=device, **kw)
    return jtrainer, jstate, trainer, carry_sac_state(jstate, device)


@pytest.mark.parametrize("case", list(SAC_CASES))
def test_sac_lockstep_with_jax(case):
    jtrainer, jstate, trainer, state = sac_trainers(case)
    key = jstate.rng
    for b in _policy_batches(10, 5):
        key, noise = sac_noise(key, B, A)
        jstate, jmetrics = jtrainer.train_step(jstate, _policy_batch(jrlt, jnp.asarray, b))
        state, metrics = trainer.train_step(state, _policy_batch(rlt, torch.tensor, b), noise)
        assert metrics.keys() == jmetrics.keys()
        for name in jmetrics:
            _close(metrics[name], jmetrics[name], STEP_TOL, name)
    assert np.array_equal(np.asarray(key), np.asarray(jstate.rng))
    _assert_state_close(state, jstate, SAC_TREES)
    for name in ("q1_opt_state", "q2_opt_state", "actor_opt_state", "value_opt_state"):
        if getattr(jstate, name) is not None:
            _assert_adam_close(getattr(state, name), getattr(jstate, name))
    if case == "one_q_fixed_alpha":
        assert state.log_alpha is None and float(metrics["alpha_loss"]) == 0.0
        assert float(metrics["entropy_temperature"]) == pytest.approx(0.01)
    else:
        _close(state.log_alpha, jstate.log_alpha, STEP_TOL, "log_alpha")
        _assert_adam_close(state.alpha_opt_state, jstate.alpha_opt_state, scalar=True)
    if SAC_CASES[case]["value"]:
        assert float(metrics["value_loss"]) > 0.0


def test_sac_train_step_draws_from_its_generator_and_leaves_the_state():
    *_, trainer, state = sac_trainers("twin_q_autotune")
    batch = _policy_batch(rlt, torch.tensor, next(_policy_batches(1, 1)))
    before = {k: v.clone() for k, v in state.actor_params.items()}
    trainer.init(torch.Generator().manual_seed(3))
    seeded = trainer.generator.get_state()
    _, m1 = trainer.train_step(state, batch)
    _, m2 = trainer.train_step(state, batch)
    trainer.generator.set_state(seeded)
    _, m3 = trainer.train_step(state, batch)
    assert float(m1["actor_loss"]) != float(m2["actor_loss"])
    assert float(m1["actor_loss"]) == float(m3["actor_loss"])
    assert all(torch.equal(before[k], v) for k, v in state.actor_params.items())
    with pytest.raises(ValueError, match="value network"):
        SACTrainer(actor.GaussianFullyConnectedActor(D, A, SIZES, ACTS),
                   FullyConnectedCritic(D, A, SIZES, ACTS), crr_config={"exponent_beta": 1.0},
                   device="cpu")


def test_crr_weight_fn_matches_jax():
    adv = np.linspace(-3, 3, 13).astype(np.float32)
    for kw in (dict(exponent_beta=0.5), dict(exponent_beta=0.5, exponent_clamp=2.0),
               dict(indicator_fn_threshold=0.0), dict(indicator_fn_threshold=1.0)):
        _close(CRRWeightFn(**kw).get_weight_from_advantage(torch.tensor(adv)),
               JaxCRRWeightFn(**kw).get_weight_from_advantage(jnp.asarray(adv)))
    for kw in ({}, dict(exponent_beta=1.0, indicator_fn_threshold=0.0)):
        with pytest.raises(ValueError, match="exactly one"):
            CRRWeightFn(**kw)


def td3_trainers(device="cpu", twin=True, delay=2):
    def nets(Actor, Critic):
        return dict(
            actor_network=Actor(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS),
            q1_network=Critic(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS),
            q2_network=(Critic(state_dim=D, action_dim=A, sizes=SIZES, activations=ACTS)
                        if twin else None))

    kw = dict(q_network_optimizer={"Adam": {"lr": 0.001}},
              actor_network_optimizer={"Adam": {"lr": 0.003}}, noise_variance=0.2,
              noise_clip=0.5, delayed_policy_update=delay)
    rl = dict(gamma=0.9, target_update_rate=0.3)
    jtrainer = JaxTD3Trainer(**nets(jax_actor.FullyConnectedActor, JaxCritic),
                             rl=JaxRLParameters(**rl), **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(2), jnp.zeros((1, D)), jnp.zeros((1, A)))
    trainer = TD3Trainer(**nets(actor.FullyConnectedActor, FullyConnectedCritic),
                         rl=RLParameters(**rl), device=device, **kw)

    def tree(name):
        x = getattr(jstate, name)
        return None if x is None else _np_tree(x)

    state = td3_state_from_arrays(
        tree("actor_params"), tree("actor_target_params"), tree("q1_params"),
        tree("q1_target_params"), _adam(jstate.actor_opt_state), _adam(jstate.q1_opt_state),
        np.asarray(jstate.step), device, q2_params=tree("q2_params"),
        q2_target_params=tree("q2_target_params"),
        q2_opt_state=None if jstate.q2_opt_state is None else _adam(jstate.q2_opt_state))
    return jtrainer, jstate, trainer, state


TD3_TREES = ("actor_params", "actor_target_params", "q1_params", "q1_target_params",
             "q2_params", "q2_target_params")


def test_td3_lockstep_with_jax():
    """Four steps: the actor and the targets move on steps 0 and 2 only."""
    jtrainer, jstate, trainer, state = td3_trainers()
    key = jstate.rng
    actor_losses = []
    for b in _policy_batches(20, 4):
        key, noise = td3_noise(key, B, A)
        jstate, jmetrics = jtrainer.train_step(jstate, _policy_batch(jrlt, jnp.asarray, b))
        before = state
        state, metrics = trainer.train_step(state, _policy_batch(rlt, torch.tensor, b), noise)
        assert metrics.keys() == jmetrics.keys()
        for name in jmetrics:
            _close(metrics[name], jmetrics[name], STEP_TOL, name)
        moved = not torch.equal(state.actor_params["net.layers.0.weight"],
                                before.actor_params["net.layers.0.weight"])
        actor_losses.append((moved, float(metrics["actor_loss"])))
        _assert_state_close(state, jstate, TD3_TREES)
        _assert_adam_close(state.actor_opt_state, jstate.actor_opt_state)
        assert state.actor_opt_state.count.dtype == torch.int32
    assert [m for m, _ in actor_losses] == [True, False, True, False]
    assert [loss == 0.0 for _, loss in actor_losses] == [False, True, False, True]
    _assert_adam_close(state.q1_opt_state, jstate.q1_opt_state)
    _assert_adam_close(state.q2_opt_state, jstate.q2_opt_state)


@pytest.mark.parametrize("make", [lambda: sac_trainers("value_net"), td3_trainers],
                         ids=["SAC", "TD3"])
def test_actor_critic_states_checkpoint_bit_for_bit(tmp_path, make):
    """A trained state restores bit for bit, and the restored state takes
    the next step as the original does."""
    *_, trainer, state = make()
    batches = [_policy_batch(rlt, torch.tensor, b) for b in _policy_batches(30, 3)]
    noise = torch.zeros((2, B, A)) if isinstance(trainer, SACTrainer) else torch.zeros((B, A))
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch, noise)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state)
    fresh = trainer.state_from_networks()
    restored = restore_checkpoint(path, fresh)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(restored, f.name)
        assert (a is None) == (b is None), f.name
    _, m1 = trainer.train_step(state, batches[2], noise)
    _, m2 = trainer.train_step(restored, batches[2], noise)
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    assert int(restored.step) == 2


def test_builders_are_registered():
    assert CONTINUOUS_ACTOR_NET_BUILDERS.build({"DirichletFullyConnected": {}}).build_actor(
        None, None, state_dim=3, action_dim=2).action_dim == 2
    assert PARAMETRIC_DQN_NET_BUILDERS.build({"FullyConnected": {}}).build_q_network(
        None, None, state_dim=3, action_dim=2).net.layers[0].in_features == 5
    assert VALUE_NET_BUILDERS.build(
        {"FullyConnected": {"sizes": [4], "activations": ["tanh"]}}).build_value_network(
        None, state_dim=3).net.layers[-1].out_features == 1
