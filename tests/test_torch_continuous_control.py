"""Online continuous control and the options of the unfused stack, against
the JAX package: ``DQNTrainer`` with a batch-norm net, RAdam and a cosine
schedule; SAC, TD3 and continuous CRR at the reference CI's online Pendulum
configs (64, 64, minibatch 256) with JAX's noise; the online loop's step
(act, env step, add, sample, update) one update at a time from JAX's state,
on the circular and the prioritized buffer; the sum tree and the
prioritized buffer on JAX's uniforms; ``make_policy_network_batch``,
``make_trainer_preprocessor``, the samplers with fed draws, the random
policies, ``build_env`` and ``running_stats``; checkpoints of the new state.

Weights and optimizer states are JAX's, carried through
``reagent_tpu_torch.utils.interop``; every draw is JAX's (split from its
keys as the JAX code splits them) and fed to the port.  Tolerances: a
train step's metrics rtol 1e-4, atol 1e-5; trainer states rtol 1e-3, atol
1e-4 (float32 sums in another order, which Adam turns into steps of about
lr wherever a gradient is near 0); forwards, batches and env steps rtol
1e-5, atol 1e-6; indices and integer leaves exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import running_stats as jax_running_stats
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.gym.envs import Pendulum as JaxPendulum
from reagent_tpu.gym.policies import random_policies as jax_random_policies
from reagent_tpu.gym.policies import samplers as jax_samplers
from reagent_tpu.gym.policies.scorers import sac_scorer as jax_sac_scorer
from reagent_tpu.gym.preprocessors import make_policy_network_batch as jax_make_policy_batch
from reagent_tpu.models import actor as jax_actor
from reagent_tpu.models.critic import FullyConnectedCritic as JaxCritic
from reagent_tpu.models.dqn import FullyConnectedDQN as JaxDQN
from reagent_tpu.models.value import ValueNetwork as JaxValueNetwork
from reagent_tpu.replay import PrioritizedReplayBuffer as JaxPrioritizedReplayBuffer
from reagent_tpu.replay import ReplayBuffer as JaxReplayBuffer
from reagent_tpu.replay.sum_tree import SumTree as JaxSumTree
from reagent_tpu.training.dqn_trainer import DQNTrainer as JaxDQNTrainer
from reagent_tpu.training.sac_trainer import CRRWeightFn as JaxCRRWeightFn
from reagent_tpu.training.sac_trainer import SACTrainer as JaxSACTrainer
from reagent_tpu.training.td3_trainer import TD3Trainer as JaxTD3Trainer
from reagent_tpu_torch.core import running_stats
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.gym.envs import CartPole, FunctionalEnvState, Gym, Pendulum
from reagent_tpu_torch.gym.envs import build_env
from reagent_tpu_torch.gym.policies import (
    ContinuousRandomPolicy,
    DiscreteRandomPolicy,
    EpsilonGreedyActionSampler,
    GaussianSampler,
    MultiDiscreteRandomPolicy,
    TopKSampler,
    make_random_policy_for_env,
    sac_scorer,
)
from reagent_tpu_torch.gym.preprocessors import (
    make_discrete_dqn_batch,
    make_policy_network_batch,
    make_trainer_preprocessor,
)
from reagent_tpu_torch.models import actor
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.value import ValueNetwork
from reagent_tpu_torch.ops import fused_mlp, nstep_replay
from reagent_tpu_torch.replay import PrioritizedReplayBuffer, PrioritizedReplayBufferState
from reagent_tpu_torch.replay import ReplayBuffer, SumTree
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.dqn_trainer import DQNTrainer
from reagent_tpu_torch.training.sac_trainer import CRRWeightFn, SACTrainer
from reagent_tpu_torch.training.td3_trainer import TD3Trainer
from reagent_tpu_torch.utils.checkpointing import flatten_state, restore_checkpoint, save_checkpoint
from test_torch_actor_critic import _assert_squashed_log_prob_close
from reagent_tpu_torch.utils.interop import (
    dqn_state_from_arrays,
    opt_state_from_arrays,
    opt_state_from_optax,
    q_network_state_from_flax,
    replay_state_from_arrays,
    sac_state_from_arrays,
    td3_state_from_arrays,
)

STEP_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-3, atol=1e-4)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
B, S, A = 256, 3, 1  # the online jobs' minibatch, Pendulum's state and action
WIDTHS = [64, 64]
ACTION_SCALE = 2.0


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol, err_msg=msg)


def _assert_trees_close(state, jstate, names, tol=STATE_TOL):
    for name in names:
        want = getattr(jstate, name)
        if want is None:
            assert getattr(state, name) is None, name
            continue
        want = q_network_state_from_flax(_np_tree(want))
        got = getattr(state, name)
        assert set(got) == set(want), name
        for k in want:
            _close(got[k], want[k].numpy(), tol, f"{name} {k}")


# ------------------------------------------- DQNTrainer with the options

def _dqn_batches(seed, n, Bq=32, D=5, Aq=3):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        nt = (rng.random((Bq, 1)) > 0.2).astype(np.float32)
        yield dict(s=rng.normal(size=(Bq, D)).astype(np.float32),
                   ns=rng.normal(size=(Bq, D)).astype(np.float32),
                   a=np.eye(Aq, dtype=np.float32)[rng.integers(0, Aq, Bq)],
                   na=np.eye(Aq, dtype=np.float32)[rng.integers(0, Aq, Bq)],
                   r=rng.normal(size=(Bq, 1)).astype(np.float32), nt=nt,
                   mask=np.ones((Bq, Aq), np.float32))


def _dqn_batch(mod, conv, b):
    return mod.DiscreteDqnInput(
        state=mod.FeatureData(float_features=conv(b["s"])),
        next_state=mod.FeatureData(float_features=conv(b["ns"])),
        action=conv(b["a"]), next_action=conv(b["na"]), reward=conv(b["r"]),
        time_diff=None, step=None, not_terminal=conv(b["nt"]),
        possible_actions_mask=conv(b["mask"]), possible_next_actions_mask=conv(b["mask"]))


DQN_OPTIONS = {
    "batch_norm_radam_cosine": (
        dict(use_batch_norm=True),
        {"RAdam": {"lr": 0.01, "lr_scheduler": {"CosineAnnealingLR": {"T_max": 4}}}}),
    "layer_norm_skip_adafactor": (
        dict(use_layer_norm=True, use_skip_connections=True, dropout_ratio=0.2),
        {"Adafactor": {"lr": 0.01}}),
    "all_norms_lamb_onecycle": (
        dict(use_batch_norm=True, use_layer_norm=True),
        {"Lamb": {"lr": 0.01, "lr_scheduler": {"OneCycleLR": {"total_steps": 4}}}}),
}


@pytest.mark.parametrize("case", sorted(DQN_OPTIONS))
def test_dqn_trainer_with_options_lockstep_with_jax(case):
    """5 steps of ``DQNTrainer`` from JAX's init; the batch norm's mean and
    var are trained parameters on both sides (the optimizer, the gradient
    and the soft update run over them), and the schedule's count is
    carried."""
    opts, optimizer = DQN_OPTIONS[case]
    kw = dict(state_dim=5, action_dim=3, sizes=[8, 8], activations=["relu", "leaky_relu"], **opts)
    rl = dict(gamma=0.9, target_update_rate=0.3)
    jtrainer = JaxDQNTrainer(JaxDQN(**kw), rl=JaxRLParameters(**rl), optimizer=optimizer)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, 5)))
    trainer = DQNTrainer(FullyConnectedDQN(**kw), rl=RLParameters(**rl), optimizer=optimizer,
                         device="cpu")
    state = dqn_state_from_arrays(
        _np_tree(jstate.q_params), _np_tree(jstate.q_target_params),
        opt_state_from_optax(jstate.opt_state), np.asarray(jstate.step))
    assert set(state.q_params) == set(functional.params_of(trainer.q_network))
    for b in _dqn_batches(1, 5):
        jstate, jm = jtrainer.train_step(jstate, _dqn_batch(jrlt, jnp.asarray, b))
        state, m = trainer.train_step(state, _dqn_batch(rlt, torch.tensor, b))
        for key in ("td_loss", "q_values_mean"):
            _close(m[key], jm[key], STEP_TOL, key)
    _assert_trees_close(state, jstate, ("q_params", "q_target_params"))
    theirs = opt_state_from_optax(jstate.opt_state)
    assert int(state.opt_state.count) == 5
    if "lr_scheduler" in next(iter(optimizer.values())):
        assert int(state.opt_state.schedule_count) == int(theirs.schedule_count) == 5
    if opts.get("use_batch_norm"):
        var = state.q_params["net.batch_norms.0.var"]
        assert not torch.equal(var, torch.ones_like(var))  # the statistics trained


# ------------------------------------------ the online jobs' trainers

def _jobs(name, pkg):
    """(trainer kwargs, actor, critics, value net) of an online job's config
    in one package: ``pkg`` is "jax" or "torch"."""
    act = "leaky_relu" if name == "continuous CRR" else "relu"
    acts = [act, act]
    if pkg == "jax":
        Gauss, Det, Critic, Value = (jax_actor.GaussianFullyConnectedActor,
                                     jax_actor.FullyConnectedActor, JaxCritic, JaxValueNetwork)
        rl = JaxRLParameters(gamma=0.99, target_update_rate=0.005)
        crr = JaxCRRWeightFn(exponent_beta=1.0, exponent_clamp=20.0)
    else:
        Gauss, Det, Critic, Value = (actor.GaussianFullyConnectedActor, actor.FullyConnectedActor,
                                     FullyConnectedCritic, ValueNetwork)
        rl = RLParameters(gamma=0.99, target_update_rate=0.005)
        crr = CRRWeightFn(exponent_beta=1.0, exponent_clamp=20.0)
    net = dict(state_dim=S, action_dim=A, sizes=WIDTHS, activations=acts)
    kw = dict(rl=rl, q_network_optimizer={"Adam": {"lr": 3e-3}},
              actor_network_optimizer={"Adam": {"lr": 3e-3}})
    if name == "TD3":
        return kw, Det(**net, exploration_variance=0.2), (Critic(**net), Critic(**net)), None
    q = (Critic(**net), Critic(**net) if name == "SAC" else None)
    if name == "SAC":
        kw.update(entropy_temperature=0.2, target_entropy=-1.0)
        return kw, Gauss(**net), q, None
    kw.update(entropy_temperature=0.3, crr_config=crr,
              value_network_optimizer={"Adam": {"lr": 3e-3}})
    return kw, Gauss(**net), q, Value(state_dim=S, sizes=WIDTHS, activations=acts)


JOBS = ("SAC", "TD3", "continuous CRR")
SAC_TREES = ("actor_params", "q1_params", "q1_target_params", "q2_params", "q2_target_params",
             "value_params", "value_target_params")
TD3_TREES = ("actor_params", "actor_target_params", "q1_params", "q1_target_params",
             "q2_params", "q2_target_params")


def job_trainers(name):
    """(JAX trainer, its init state, the port's trainer) of an online job."""
    jkw, ja, (jq1, jq2), jv = _jobs(name, "jax")
    kw, a, (q1, q2), v = _jobs(name, "torch")
    if name == "TD3":
        jtrainer = JaxTD3Trainer(ja, jq1, jq2, **jkw)
        trainer = TD3Trainer(a, q1, q2, device="cpu", **kw)
    else:
        jtrainer = JaxSACTrainer(ja, jq1, jq2, value_network=jv, **jkw)
        trainer = SACTrainer(a, q1, q2, value_network=v, device="cpu", **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(4), jnp.zeros((1, S)), jnp.zeros((1, A)))
    return jtrainer, jstate, trainer


def _adam(opt_state, scalar=False):
    """The port's optimizer state from an optax one; SAC's temperature moments
    are scalars, carried under ``log_alpha``."""
    if not scalar:
        return opt_state_from_optax(opt_state)
    adam = _find(opt_state, "mu")
    return opt_state_from_arrays(
        count=np.asarray(adam.count),
        **{f: {"log_alpha": np.asarray(getattr(adam, f))} for f in ("mu", "nu")})


def _find(opt_state, field):
    """The first state of an optax chain that has ``field``."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, field)):
        if hasattr(leaf, field):
            return leaf
    raise AssertionError(field)


def carry_state(name, jstate):
    """The port's trainer state from a JAX one (JAX's key stays behind:
    the port's step takes JAX's draws)."""
    def tree(field):
        x = getattr(jstate, field, None)
        return None if x is None else _np_tree(x)

    def opt(field, scalar=False):
        x = getattr(jstate, field, None)
        return None if x is None else _adam(x, scalar)

    if name == "TD3":
        return td3_state_from_arrays(
            tree("actor_params"), tree("actor_target_params"), tree("q1_params"),
            tree("q1_target_params"), opt("actor_opt_state"), opt("q1_opt_state"),
            np.asarray(jstate.step), q2_params=tree("q2_params"),
            q2_target_params=tree("q2_target_params"), q2_opt_state=opt("q2_opt_state"))
    return sac_state_from_arrays(
        tree("actor_params"), tree("q1_params"), tree("q1_target_params"),
        opt("actor_opt_state"), opt("q1_opt_state"), np.asarray(jstate.step),
        q2_params=tree("q2_params"), q2_target_params=tree("q2_target_params"),
        q2_opt_state=opt("q2_opt_state"), log_alpha=tree("log_alpha"),
        alpha_opt_state=opt("alpha_opt_state", scalar=True), value_params=tree("value_params"),
        value_target_params=tree("value_target_params"), value_opt_state=opt("value_opt_state"))


def trainer_noise(name, key):
    """(the key after the step, the port's noise) as JAX's train_step splits
    its state's key: SAC's two standard normals, TD3's smoothing draw."""
    if name == "TD3":
        key, r = jax.random.split(key)
        return key, torch.tensor(np.asarray(jax.random.normal(r, (B, A))))
    key, r_next, r_actor = jax.random.split(key, 3)
    return key, torch.tensor(np.stack([np.asarray(jax.random.normal(r, (B, A)))
                                       for r in (r_next, r_actor)]))


def metric_tol(name, jtrainer, jstate, state_batch, key):
    """Each metric's tolerance before a step from ``jstate`` whose key is
    ``key``.  The temperature's loss is a mean of the actor's log-probs, and
    the squash correction log(1 - a^2 + 1e-6) turns an ulp of tanh near
    a = +-1 into a large error there (``_assert_squashed_log_prob_close``):
    its atol adds |log alpha| times that conditioning at 8 ulps, averaged
    over the batch, at JAX's actions on the batch's states."""
    tol = {}
    if name != "TD3":
        _, _, r_actor = jax.random.split(key, 3)
        a = np.asarray(jtrainer.actor_network.apply(
            jstate.actor_params, jnp.asarray(state_batch), r_actor).action, np.float64)
        cond = np.mean(np.sum(2 * 8 * 2.0**-24 / (1 - a**2 + 1e-6), axis=1))
        log_alpha = 0.0 if jstate.log_alpha is None else abs(float(jstate.log_alpha))
        tol["alpha_loss"] = dict(rtol=STEP_TOL["rtol"],
                                 atol=STEP_TOL["atol"] + max(1.0, log_alpha) * cond)
    return tol


def _pendulum_batches(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        th = rng.uniform(-np.pi, np.pi, B)
        s = np.stack([np.cos(th), np.sin(th), rng.uniform(-8, 8, B)], 1).astype(np.float32)
        yield dict(s=s, ns=(s + rng.normal(0, 0.05, s.shape)).astype(np.float32),
                   a=rng.uniform(-1, 1, (B, A)).astype(np.float32),
                   r=-rng.uniform(0, 16, (B, 1)).astype(np.float32),
                   nt=np.ones((B, 1), np.float32), step=np.ones((B, 1), np.int32))


def _policy_batch(mod, conv, b):
    return mod.PolicyNetworkInput(
        state=mod.FeatureData(float_features=conv(b["s"])),
        next_state=mod.FeatureData(float_features=conv(b["ns"])),
        action=mod.FeatureData(float_features=conv(b["a"])),
        next_action=mod.FeatureData(float_features=conv(b["a"])),
        reward=conv(b["r"]), time_diff=None, step=None, not_terminal=conv(b["nt"]))


@pytest.mark.parametrize("name", JOBS)
def test_online_job_trainers_lockstep_with_jax(name):
    """5 updates of the online jobs' trainers from JAX's init with JAX's
    noise, on Pendulum-like batches."""
    jtrainer, jstate, trainer = job_trainers(name)
    state = carry_state(name, jstate)
    key = jstate.rng
    for b in _pendulum_batches(7, 5):
        tol = metric_tol(name, jtrainer, jstate, b["s"], key)
        key, noise = trainer_noise(name, key)
        jstate, jm = jtrainer.train_step(jstate, _policy_batch(jrlt, jnp.asarray, b))
        state, m = trainer.train_step(state, _policy_batch(rlt, torch.tensor, b), noise)
        assert m.keys() == jm.keys()
        for k in jm:
            _close(m[k], jm[k], tol.get(k, STEP_TOL), k)
    assert np.array_equal(np.asarray(key), np.asarray(jstate.rng))
    _assert_trees_close(state, jstate, TD3_TREES if name == "TD3" else SAC_TREES)
    assert int(state.step) == int(jstate.step) == 5


# ------------------------------------ the online loop, one update at a time

def _jax_rb(prioritized):
    cls = JaxPrioritizedReplayBuffer if prioritized else JaxReplayBuffer
    rb = cls(replay_capacity=2000, update_horizon=1, gamma=0.99)
    return rb, rb.init(observation=jnp.zeros(S), action=jnp.zeros(A), reward=jnp.float32(0),
                       terminal=jnp.bool_(False))


def _carry_rb(rb_state, prioritized):
    base = rb_state.buffer if prioritized else rb_state
    port = replay_state_from_arrays(
        {k: np.asarray(v) for k, v in base.store.items()}, np.asarray(base.add_count),
        np.asarray(base.is_valid), np.asarray(base.episode_len))
    if not prioritized:
        return port
    return PrioritizedReplayBufferState(
        buffer=port, priorities=torch.tensor(np.asarray(rb_state.priorities)),
        max_priority=torch.tensor(np.asarray(rb_state.max_priority)))


@pytest.mark.parametrize("name,prioritized", [
    ("SAC", False), ("TD3", False), ("continuous CRR", False), ("TD3", True)])
def test_online_loop_step_by_step_from_jax(name, prioritized):
    """The generic loop's round (``reagent_tpu/gym/online_loop.py:135-181``:
    act, env step, add, sample, update) taken by JAX eagerly with its keys
    split as the loop splits them, and by the port's pieces from JAX's state
    of each step with JAX's draws: the act step through
    ``functional.actor_act`` (K3's plain version for the dense trunk), the
    functional Pendulum, the buffer's ``add``, ``sample`` at JAX's indices
    (the prioritized buffer: its stratified draw on JAX's uniforms; every
    priority is the max, so the prefix sums are exact in float32 and the
    indices equal), ``make_policy_network_batch`` and one update."""
    jtrainer, jstate, trainer = job_trainers(name)
    jenv, env = JaxPendulum(), Pendulum(device="cpu")
    jrb, jrbs = _jax_rb(prioritized)
    rb = (PrioritizedReplayBuffer if prioritized else ReplayBuffer)(
        replay_capacity=2000, update_horizon=1, gamma=0.99, device="cpu")
    rng = jax.random.PRNGKey(11)
    rng, r_pre, r0 = jax.random.split(rng, 3)
    from reagent_tpu.gym.online_loop import prefill_replay_buffer as jax_prefill

    jrbs = jax_prefill(jenv, jrb, jrbs, r_pre, num_steps=300)
    env_state, obs = jenv.reset(r0)
    k3_before = fused_mlp.fused_mlp_forward_reference.calls
    k4_before = nstep_replay.nstep_rewards_reference.calls
    for step in range(4):
        state = carry_state(name, jstate)
        rb_state = _carry_rb(jrbs, prioritized)
        port_env = FunctionalEnvState(physics=torch.tensor(np.asarray(env_state.physics)),
                                      t=torch.tensor(np.asarray(env_state.t)))
        # JAX: the env body, then the round's sample and update
        rng, r_act, r_step, r_reset = jax.random.split(rng, 4)
        jout = jtrainer.actor_network.apply(jstate.actor_params, obs[None], r_act)
        env_state, next_obs, reward, done = jenv.step(env_state, jout.action[0] * ACTION_SCALE,
                                                      r_step)
        jrbs = jrb.add(jrbs, observation=obs, action=jout.action[0], reward=reward,
                       terminal=done)
        assert not bool(done)
        rng, r_sample = jax.random.split(rng)
        jbatch = jrb.sample(jrbs, r_sample, B)
        tol = metric_tol(name, jtrainer, jstate, jbatch["state"], jstate.rng)
        key, noise = trainer_noise(name, jstate.rng)
        jstate, jm = jtrainer.train_step(jstate, jax_make_policy_batch(jbatch))
        # the port from JAX's state of this step, on JAX's draws
        draw = torch.tensor(np.asarray(jax.random.normal(r_act, (1, A))))
        out = functional.actor_act(trainer.actor_network, state.actor_params,
                                   torch.tensor(np.asarray(obs))[None], draw)
        _close(out.action, jout.action, FWD_TOL, "action")
        port_env, pobs, preward, pdone = env.step(port_env, out.action[0] * ACTION_SCALE)
        _close(pobs, next_obs, FWD_TOL, "obs")
        _close(preward, reward, FWD_TOL, "reward")
        rb_state = rb.add(rb_state, observation=torch.tensor(np.asarray(obs)),
                          action=out.action[0], reward=preward, terminal=pdone)
        if prioritized:
            u = torch.tensor(np.asarray(jax.random.uniform(r_sample, (B,))))
            batch = rb.sample(rb_state, batch_size=B, u=u)
        else:
            batch = rb.sample(rb_state, batch_size=B,
                              indices=torch.tensor(np.asarray(jbatch["indices"])[:, 0]))
        np.testing.assert_array_equal(batch["indices"].numpy(), np.asarray(jbatch["indices"]))
        for k in ("state", "action", "reward", "next_state", "terminal"):
            _close(batch[k], jbatch[k], FWD_TOL, k)
        if prioritized:
            _close(batch["sampling_probabilities"], jbatch["sampling_probabilities"], FWD_TOL)
        state, m = trainer.train_step(state, make_policy_network_batch(batch), noise)
        for k in jm:
            _close(m[k], jm[k], tol.get(k, STEP_TOL), f"step {step} {k}")
        _assert_trees_close(state, jstate, TD3_TREES if name == "TD3" else SAC_TREES)
        obs = next_obs
    assert fused_mlp.fused_mlp_forward_reference.calls - k3_before == 4  # the dense trunk
    assert nstep_replay.nstep_rewards_reference.calls - k4_before == 4


def test_sac_scorer_and_the_act_step_match_jax():
    """``sac_scorer``'s (loc, log-scale) and ``actor_act``'s draws against
    JAX's, with and without the layer norms: the dense trunk is one K3 call
    (its plain version here), the layer norms and the clip in torch."""
    for ln in (False, True):
        ja = jax_actor.GaussianFullyConnectedActor(state_dim=S, action_dim=2, sizes=WIDTHS,
                                                   activations=["relu", "relu"],
                                                   use_layer_norm=ln)
        obs = np.random.default_rng(3).normal(size=(5, S)).astype(np.float32)
        params = ja.init(jax.random.PRNGKey(2), jnp.asarray(obs))
        gauss = actor.GaussianFullyConnectedActor(S, 2, WIDTHS, ["relu", "relu"],
                                                  use_layer_norm=ln)
        tparams = {k: v for k, v in q_network_state_from_flax(_np_tree(params)).items()}
        before = fused_mlp.fused_mlp_forward_reference.calls
        got = sac_scorer(gauss)(tparams, torch.tensor(obs))
        want = jax_sac_scorer(ja)(params, jnp.asarray(obs))
        assert fused_mlp.fused_mlp_forward_reference.calls == before + 1
        # with the layer norms over 2 features: (x - mean) / sqrt(var + 1e-6)
        # of two near-tied outputs moves by 1e-5 for an ulp of either, so
        # there the outputs are held to JAX's and to the module's own forward
        # (the trunk's products through nn.Linear) at rtol 1e-4
        tol = dict(rtol=1e-4, atol=1e-6) if ln else FWD_TOL
        _close(got.loc, want.loc, tol)
        _close(got.scale_log, want.scale_log, tol)
        key = jax.random.PRNGKey(9)
        jout = ja.apply(params, jnp.asarray(obs), key)
        out = functional.actor_act(gauss, tparams, torch.tensor(obs),
                                   torch.tensor(np.asarray(jax.random.normal(key, (5, 2)))))
        gauss.load_state_dict(tparams)
        draw = torch.tensor(np.asarray(jax.random.normal(key, (5, 2))))
        with torch.no_grad():
            _close(out.action, gauss(torch.tensor(obs), draw).action, tol)
        _close(out.action, jout.action, tol)
        if not ln:
            _assert_squashed_log_prob_close(out.log_prob, jout.log_prob, jout.action)
    # a trunk with a norm runs the module's own forward: no K3
    det = actor.FullyConnectedActor(S, 1, WIDTHS, ["relu", "relu"], use_batch_norm=True)
    before = fused_mlp.fused_mlp_forward_reference.calls
    functional.actor_act(det, functional.params_of(det), torch.tensor(obs))
    assert fused_mlp.fused_mlp_forward_reference.calls == before


# --------------------------------------------------- replay memory

def test_sum_tree_matches_jax_on_the_same_uniforms():
    rng = np.random.default_rng(0)
    jtree, tree = JaxSumTree(100), SumTree(100, device="cpu")
    idx = rng.choice(100, 60, replace=False)
    vals = rng.integers(1, 9, 60).astype(np.float32)  # exact prefix sums
    js = jtree.set(jtree.init(), jnp.asarray(idx), jnp.asarray(vals))
    ts = tree.set(tree.init(), torch.tensor(idx), torch.tensor(vals))
    for jl, tl in zip(js.levels, ts.levels):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    key = jax.random.PRNGKey(5)
    want = jtree.stratified_sample(js, key, 32)
    got = tree.stratified_sample(ts, batch_size=32,
                                 u=torch.tensor(np.asarray(jax.random.uniform(key, (32,)))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jtree.sample(js, key, (16,))
    got = tree.sample(ts, u=torch.tensor(np.asarray(jax.random.uniform(key, (16,)))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tree.get(ts, torch.tensor([3, 5])).numpy(),
                                  np.asarray(jtree.get(js, jnp.asarray([3, 5]))))
    # a repeated index: the last write wins, on any device
    ts = tree.set(ts, torch.tensor([7, 7, 7]), torch.tensor([1.0, 2.0, 3.0]))
    assert float(tree.get(ts, 7)) == 3.0 and float(ts.total) == float(ts.leaves.sum())


def test_prioritized_buffer_matches_jax():
    """add (the max priority, at the post-padding cursor, stack 2),
    set_priority, get_priority, the stratified draw on JAX's uniforms (small
    integer priorities: exact prefix sums, equal indices), the sampled rows
    (K4's plain version) and the sampling probabilities."""
    jrb = JaxPrioritizedReplayBuffer(stack_size=2, replay_capacity=64, update_horizon=2,
                                     gamma=0.9)
    rb = PrioritizedReplayBuffer(stack_size=2, replay_capacity=64, update_horizon=2, gamma=0.9,
                                 device="cpu")
    ex = dict(observation=np.zeros(S, np.float32), action=np.zeros(A, np.float32),
              reward=np.float32(0), terminal=False)
    js = jrb.init(**{k: jnp.asarray(v) for k, v in ex.items()})
    ts = rb.init(**{k: torch.tensor(v) for k, v in ex.items()})
    rng = np.random.default_rng(1)
    for t in range(90):
        tr = dict(observation=rng.normal(size=S).astype(np.float32),
                  action=rng.uniform(-1, 1, A).astype(np.float32),
                  reward=np.float32(rng.normal()), terminal=bool(t % 17 == 16))
        prio = None if t % 3 else np.float32(rng.integers(1, 5))
        js = jrb.add(js, priority=None if prio is None else jnp.asarray(prio),
                     **{k: jnp.asarray(v) for k, v in tr.items()})
        ts = rb.add(ts, priority=None if prio is None else torch.tensor(prio),
                    **{k: torch.tensor(v) for k, v in tr.items()})
    np.testing.assert_array_equal(ts.priorities.numpy(), np.asarray(js.priorities))
    assert float(ts.max_priority) == float(js.max_priority)
    np.testing.assert_array_equal(ts.buffer.is_valid.numpy(), np.asarray(js.buffer.is_valid))
    idx = np.array([1, 5, 9, 5])
    js = jrb.set_priority(js, jnp.asarray(idx), jnp.asarray([2.0, 3.0, 6.0, 7.0]))
    ts = rb.set_priority(ts, torch.tensor(idx), torch.tensor([2.0, 3.0, 6.0, 7.0]))
    np.testing.assert_array_equal(rb.get_priority(ts, torch.tensor(idx)).numpy(),
                                  np.asarray(jrb.get_priority(js, jnp.asarray(idx))))
    key = jax.random.PRNGKey(2)
    jbatch = jrb.sample(js, key, 16)
    batch = rb.sample(ts, batch_size=16,
                      u=torch.tensor(np.asarray(jax.random.uniform(key, (16,)))))
    np.testing.assert_array_equal(batch["indices"].numpy(), np.asarray(jbatch["indices"]))
    assert batch.keys() == jbatch.keys()
    for k in jbatch:
        _close(batch[k], jbatch[k], FWD_TOL, k)
    prios, valid = np.asarray(js.priorities), np.asarray(js.buffer.is_valid)
    _close(rb.sampling_probabilities(ts, torch.tensor(idx)),
           prios[idx] / np.sum(prios * valid), FWD_TOL)


def test_prioritized_draw_follows_the_priorities():
    """On arbitrary float priorities the draw is held by its distribution:
    100 batches of 512 stratified draws against priority / total."""
    rb = PrioritizedReplayBuffer(replay_capacity=32, device="cpu")
    ts = rb.init(observation=torch.zeros(2), action=torch.tensor(0, dtype=torch.int32),
                 reward=torch.tensor(0.0), terminal=torch.tensor(False))
    for t in range(32):
        ts = rb.add(ts, observation=torch.zeros(2), action=torch.tensor(0, dtype=torch.int32),
                    reward=torch.tensor(0.0), terminal=torch.tensor(t == 31))
    rng = np.random.default_rng(3)
    ts = rb.set_priority(ts, torch.arange(32), torch.tensor(rng.uniform(0.1, 3.0, 32)))
    g = torch.Generator().manual_seed(0)
    counts = torch.zeros(32)
    for _ in range(100):
        counts += torch.bincount(rb.sample_index_batch_prioritized(ts, g, 512).long(),
                                 minlength=32)
    p = rb.sampling_probabilities(ts, torch.arange(32))
    assert abs(float(p.sum()) - 1.0) < 1e-5
    torch.testing.assert_close(counts / counts.sum(), p, rtol=0, atol=3e-3)


# ------------------------------------------- the online loop's pieces

def test_make_policy_network_batch_and_trainer_preprocessor_match_jax():
    rng = np.random.default_rng(4)
    d = dict(state=rng.normal(size=(6, S)), next_state=rng.normal(size=(6, S)),
             action=rng.uniform(-1, 1, 6), next_action=rng.uniform(-1, 1, 6),
             reward=rng.normal(size=(6, 1)), terminal=rng.random((6, 1)) > 0.5,
             step=np.ones((6, 1), np.int32))
    d = {k: np.asarray(v, np.float32 if v.dtype == np.float64 else v.dtype) for k, v in d.items()}
    got = make_policy_network_batch({k: torch.tensor(v) for k, v in d.items()})
    want = jax_make_policy_batch({k: jnp.asarray(v) for k, v in d.items()})
    for name in ("state", "next_state", "action", "next_action"):
        _close(getattr(got, name).float_features, getattr(want, name).float_features, FWD_TOL)
    for name in ("reward", "time_diff", "step", "not_terminal"):
        _close(getattr(got, name), getattr(want, name), FWD_TOL, name)
    assert got.action.float_features.shape == (6, 1)
    _, _, trainer = job_trainers("TD3")
    assert make_trainer_preprocessor(trainer) is make_policy_network_batch
    dqn = DQNTrainer(FullyConnectedDQN(4, 2, [8], ["relu"]), device="cpu")
    maker = make_trainer_preprocessor(dqn, num_actions=2)
    d2 = dict(state=torch.zeros(3, 4), next_state=torch.zeros(3, 4),
              action=torch.tensor([[0], [1], [1]]), next_action=torch.tensor([[1], [0], [1]]),
              reward=torch.zeros(3, 1), terminal=torch.zeros(3, 1, dtype=torch.bool),
              step=torch.ones(3, 1, dtype=torch.int32))
    torch.testing.assert_close(maker(d2).action, make_discrete_dqn_batch(d2, 2).action)
    with pytest.raises(ValueError, match="num_actions"):
        make_trainer_preprocessor(dqn)


def test_samplers_with_fed_draws_match_jax():
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(64, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax_samplers.EpsilonGreedyActionSampler(0.3).sample_action(jnp.asarray(scores), key)
    r_explore, r_choice = jax.random.split(key)
    draws = (torch.tensor(np.asarray(jax.random.uniform(r_explore, (64,)))),
             torch.tensor(np.asarray(jax.random.randint(r_choice, (64,), 0, 4))))
    sampler = EpsilonGreedyActionSampler(0.3)
    got = sampler.sample_action(torch.tensor(scores), noise=draws)
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(want.action))
    _close(got.log_prob, want.log_prob, FWD_TOL)
    _close(sampler.log_prob(torch.tensor(scores), got.action),
           jax_samplers.EpsilonGreedyActionSampler(0.3).log_prob(jnp.asarray(scores),
                                                                  want.action), FWD_TOL)
    g = torch.Generator().manual_seed(1)
    drawn = sampler.sample_action(torch.tensor(scores), g)
    assert drawn.action.shape == (64, 4) and torch.all(drawn.action.sum(1) == 1)
    top = TopKSampler(2).sample_action(torch.tensor(scores))
    np.testing.assert_array_equal(top.action.numpy(), np.asarray(
        jax_samplers.TopKSampler(2).sample_action(jnp.asarray(scores)).action))
    out = rlt.ActorOutput(action=torch.ones(2, 1), log_prob=torch.zeros(2, 1))
    assert GaussianSampler().sample_action(out) is out
    assert GaussianSampler().log_prob(out, out.action) is out.log_prob


def test_random_policies_match_jax():
    obs = np.zeros((8, S), np.float32)
    key = jax.random.PRNGKey(3)
    mask = np.ones((8, 3), np.float32)
    mask[0, :2] = 0.0
    mask[1] = 0.0  # all masked: uniform
    want = jax_random_policies.DiscreteRandomPolicy(3).act(key, jnp.asarray(obs),
                                                           jnp.asarray(mask))
    probs = np.where(mask.sum(1, keepdims=True) > 0, mask / np.maximum(mask.sum(1, keepdims=True),
                                                                       1), 1 / 3)
    gumbel = torch.tensor(np.asarray(jax.random.gumbel(key, (8, 3))))
    got = DiscreteRandomPolicy(3).act(torch.tensor(obs), possible_actions_mask=torch.tensor(mask),
                                      noise=gumbel)
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(want.action))
    _close(got.log_prob, want.log_prob, FWD_TOL)
    assert got.action[0, 2] == 1.0 and np.allclose(np.exp(got.log_prob.numpy()[:, 0]),
                                                   probs[np.arange(8), got.action.argmax(1)])
    cont = ContinuousRandomPolicy(action_dim=2, low=-2.0, high=2.0)
    want = jax_random_policies.ContinuousRandomPolicy(2, -2.0, 2.0).act(key, jnp.asarray(obs))
    got = cont.act(torch.tensor(obs), noise=torch.tensor(np.asarray(jax.random.uniform(
        key, (8, 2)))))
    _close(got.action, want.action, FWD_TOL)
    _close(got.log_prob, want.log_prob, FWD_TOL)
    multi = MultiDiscreteRandomPolicy([2, 5])
    got = multi.act(torch.tensor(obs), torch.Generator().manual_seed(0))
    want = jax_random_policies.MultiDiscreteRandomPolicy([2, 5]).act(key, jnp.asarray(obs))
    assert got.action.shape == want.action.shape
    assert (got.action[:, 0] < 2).all() and (got.action[:, 1] < 5).all()
    _close(got.log_prob, want.log_prob, FWD_TOL)
    assert isinstance(make_random_policy_for_env(Pendulum(device="cpu")), ContinuousRandomPolicy)
    assert isinstance(make_random_policy_for_env(CartPole(device="cpu")), DiscreteRandomPolicy)


def test_build_env():
    env = build_env({"Pendulum": {"device": "cpu", "max_steps": 50}})
    assert isinstance(env, Pendulum) and env.max_steps == 50
    assert isinstance(build_env({"CartPole": {"device": "cpu"}}), CartPole)
    from reagent_tpu_torch.core.registry import ENVS

    assert ENVS.get("Gym") is Gym
    from reagent_tpu.gym.envs import build_env as jax_build_env  # noqa: F401 — fills JAX's
    from reagent_tpu.core.registry import ENVS as JAX_ENVS

    # every member of JAX's union is registered (built member by member in
    # tests/test_torch_envs_extra.py)
    assert set(JAX_ENVS.members()) == set(ENVS.members())
    assert isinstance(build_env({"StringGame": {"device": "cpu"}}), ENVS.get("StringGame"))


def test_running_stats_match_jax():
    values = list(np.random.default_rng(6).normal(size=50))
    ours, theirs = running_stats.RunningStats(values), jax_running_stats.RunningStats(values)
    assert (ours.mean, ours.std, ours.meanfull, ours.k) == (
        theirs.mean, theirs.std, theirs.meanfull, theirs.k)
    hist = {"a": values, "b": values[:7]}
    assert running_stats.get_mean_of_recent_values(hist) == \
        jax_running_stats.get_mean_of_recent_values(hist)
    np.testing.assert_array_equal(
        running_stats.calculate_recent_window_average(values, 10, 1),
        jax_running_stats.calculate_recent_window_average(values, 10, 1))
    assert np.isnan(running_stats.calculate_recent_window_average([], 10, 1))
    assert len(running_stats.calculate_recent_window_average([], 10, 3)) == 3


# -------------------------------------------------------- checkpoints

CHECKPOINTS = {
    "batch_norm_schedule": (dict(use_batch_norm=True),
                            {"RAdam": {"lr": 0.01, "lr_scheduler": {"StepLR": {"step_size": 2}}}}),
    "adafactor_factored": (dict(), {"Adafactor": {}}),
    "layer_norm_rprop": (dict(use_layer_norm=True), {"Rprop": {}}),
}


@pytest.mark.parametrize("case", sorted(CHECKPOINTS))
def test_checkpoint_round_trip_of_the_new_state(tmp_path, case):
    """The batch norm's mean and var as parameters, the schedule's count and
    Adafactor's factored moments (a [160, 128] weight) come back bit for
    bit, and the restored state continues the same trajectory."""
    opts, optimizer = CHECKPOINTS[case]
    width = 160 if case == "adafactor_factored" else 8
    net = FullyConnectedDQN(5, 3, [width, 128 if width == 160 else 8], ["relu", "relu"], **opts)
    trainer = DQNTrainer(net, optimizer=optimizer, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    batches = [_dqn_batch(rlt, torch.tensor, b) for b in _dqn_batches(2, 4)]
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state)
    back = restore_checkpoint(path, trainer.state_from_q_network())
    flat, flat_back = flatten_state(state), flatten_state(back)
    assert flat.keys() == flat_back.keys()
    for k in flat:
        assert torch.equal(flat[k], flat_back[k]), k
    if opts.get("use_batch_norm"):
        assert "/q_params/net.batch_norms.0.mean" in flat
    if "lr_scheduler" in next(iter(optimizer.values())):
        assert int(back.opt_state.schedule_count) == 2
    if case == "adafactor_factored":
        assert back.opt_state.v_col["net.layers.1.weight"].shape == (160,)
    for b in batches[2:]:
        state, m = trainer.train_step(state, b)
        back, m_back = trainer.train_step(back, b)
        assert torch.equal(m["td_loss"], m_back["td_loss"])


# ------------------------------------------------ the reference's bars

@pytest.mark.slow
@pytest.mark.parametrize("name", JOBS)
def test_online_pendulum_bar_on_the_cpu(name):
    """The reference CI's online Pendulum job at full depth on the CPU
    (``chip_smoke.continuous_online_phase``: its widths, prefill, steps and
    10 greedy episodes), from the port's seed-0 init; bars -500, -750 and
    -500."""
    import chip_smoke as cs

    cfg = cs.CONTINUOUS_JOBS[name]
    r = cs.continuous_online_phase(torch, name, cfg["full_steps"], cfg["full_prefill"],
                                   device="cpu")
    assert r["mean_reward"] >= cfg["bar"], r["mean_reward"]
