"""The policy-gradient slice against the JAX package: ``training/utils.py``,
the softmax sampler's log-prob and entropy, ``ReinforceTrainer`` and
``PPOTrainer`` in 5-step lockstep over their options, ``collect_episode``
fed JAX's draws, ``make_episodic_trainer_step`` in lockstep on CartPole,
and the ``Reinforce`` and ``PPO`` managers.  The full-depth reward bars of
``tests/test_policy_gradient_trainers.py`` are the ``slow`` tests.

Inputs come from numpy seeds and go to both packages; weights and optimizer
states are JAX's init, carried through ``reagent_tpu_torch.utils.interop``.
The JAX rollout draws from a key; the port's takes the draws, so it is given
JAX's (the reset uniforms and the sampler's gumbel draws, split from the
key as ``reagent_tpu/gym/episodic.py`` splits it).  Tolerances, float32 on
two libraries: the utilities within rtol 1e-6, atol 1e-6; over 5 steps the
trainers' states within rtol 1e-5, atol 1e-6 (the SAC and CRR tolerance;
each step sums in its own order, Adam feeds it back; measured at most
2.4e-6 absolute, in entries above 1) and their metrics within rtol 1e-5,
atol 1e-5 (a loss is a dot product over the episode of whitened returns,
which sum to about 0, with log-probs or ratios: its float32 error is that of
the terms, measured up to 4.8e-6 on losses of 0.07-2.6);
observations within 1e-5 absolute (sin and cos of two libraries part by an
ulp and the pole integrates it), actions, alive masks and episode returns
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reagent_tpu.model_managers  # noqa: F401 — registers the JAX managers
import reagent_tpu_torch.model_managers  # noqa: F401 — registers managers and builders
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.registry import MODEL_MANAGERS as JAX_MODEL_MANAGERS
from reagent_tpu.gym.envs import CartPole as JaxCartPole
from reagent_tpu.gym.episodic import collect_episode as jax_collect_episode
from reagent_tpu.gym.episodic import (
    make_episodic_trainer_step as jax_make_episodic_trainer_step,
)
from reagent_tpu.gym.policies.samplers import SoftmaxActionSampler as JaxSoftmaxActionSampler
from reagent_tpu.models import FullyConnectedDQN as JaxFullyConnectedDQN
from reagent_tpu.models.value import ValueNetwork as JaxValueNetwork
from reagent_tpu.training import utils as jax_utils
from reagent_tpu.training.ppo_trainer import PPOTrainer as JaxPPOTrainer
from reagent_tpu.training.reinforce_trainer import ReinforceTrainer as JaxReinforceTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.registry import MODEL_MANAGERS
from reagent_tpu_torch.gym.envs import CartPole
from reagent_tpu_torch.gym.episodic import collect_episode, make_episodic_trainer_step
from reagent_tpu_torch.gym.online_loop import evaluate_policy
from reagent_tpu_torch.gym.policies.policy import Policy, discrete_q_scorer
from reagent_tpu_torch.gym.policies.samplers import SoftmaxActionSampler
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.value import ValueNetwork
from reagent_tpu_torch.ops import fused_mlp
from reagent_tpu_torch.training import utils
from reagent_tpu_torch.training.ppo_trainer import PPOTrainer
from reagent_tpu_torch.training.reinforce_trainer import ReinforceTrainer
from reagent_tpu_torch.utils.interop import (
    ppo_state_from_arrays,
    q_network_state_from_flax,
    reinforce_state_from_arrays,
)
from test_torch_actor_critic import _adam, _np_tree

D, A, T = 4, 3, 16
SIZES, ACTS = [16, 8], ["leaky_relu", "leaky_relu"]
UTIL_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
METRIC_TOL = dict(rtol=1e-5, atol=1e-5)
OBS_TOL = dict(rtol=0, atol=1e-5)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


# ------------------------------------------------------------------ utils

@pytest.mark.parametrize("gamma", [0.0, 0.99])
def test_discounted_returns_match_jax(gamma):
    """Padded rewards (the mask's zeros at the end), the recurrence from the
    right; also the [T, k] case the scan takes along dim 0."""
    rng = np.random.default_rng(0)
    r = rng.normal(size=T).astype(np.float32)
    r[-5:] = 0.0
    _close(utils.discounted_returns(torch.tensor(r), gamma),
           jax_utils.discounted_returns(jnp.asarray(r), gamma), UTIL_TOL)
    r2 = rng.normal(size=(T, 3)).astype(np.float32)
    _close(utils.discounted_returns(torch.tensor(r2), gamma),
           jax_utils.discounted_returns(jnp.asarray(r2), gamma), UTIL_TOL)
    np.testing.assert_allclose(utils.discounted_returns(torch.tensor([1.0, 2.0, 3.0]), 0.5),
                               [1 + 1 + 0.75, 2 + 1.5, 3.0])


@pytest.mark.parametrize("subtract_mean", [True, False])
def test_whiten_and_masked_whiten_match_jax(subtract_mean):
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, size=T).astype(np.float32)
    mask = np.ones(T, np.float32)
    mask[11:] = 0.0
    _close(utils.whiten(torch.tensor(x), subtract_mean),
           jax_utils.whiten(jnp.asarray(x), subtract_mean), UTIL_TOL)
    got = utils.masked_whiten(torch.tensor(x), torch.tensor(mask), subtract_mean)
    _close(got, jax_utils.masked_whiten(jnp.asarray(x), jnp.asarray(mask), subtract_mean),
           UTIL_TOL)
    if subtract_mean:  # the statistics of the real steps only
        want = (x[:11] - x[:11].mean()) / x[:11].std(ddof=1)
        _close(got[:11], want, dict(rtol=1e-5, atol=1e-6))


def test_rescale_actions_and_sampler_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    lo, hi = np.float32([-1, 0]), np.float32([1, 2])
    nlo, nhi = np.float32([-2, -1]), np.float32([2, 3])
    _close(utils.rescale_actions(*map(torch.tensor, (a, nlo, nhi, lo, hi))),
           jax_utils.rescale_actions(*map(jnp.asarray, (a, nlo, nhi, lo, hi))), UTIL_TOL)
    scores = rng.normal(size=(8, A)).astype(np.float32) * 3
    onehot = np.eye(A, dtype=np.float32)[rng.integers(0, A, 8)]
    for temp in (1.0, 0.5):
        ours, theirs = SoftmaxActionSampler(temp), JaxSoftmaxActionSampler(temp)
        _close(ours.log_prob(torch.tensor(scores), torch.tensor(onehot)),
               theirs.log_prob(jnp.asarray(scores), jnp.asarray(onehot)), UTIL_TOL)
        _close(ours.entropy(torch.tensor(scores)), theirs.entropy(jnp.asarray(scores)), UTIL_TOL)
        # JAX's categorical is the gumbel-max: its draws give its action
        key = jax.random.PRNGKey(3)
        want = theirs.sample_action(jnp.asarray(scores), key)
        g = torch.tensor(np.asarray(jax.random.gumbel(key, scores.shape, jnp.float32)))
        got = ours.sample_action(torch.tensor(scores), noise=g)
        np.testing.assert_array_equal(got.action.numpy(), np.asarray(want.action))
        _close(got.log_prob, want.log_prob, UTIL_TOL)


def test_policy_scorers_match_jax():
    """``Policy``'s two scorers from JAX's init: the discrete one (K3's plain
    version) on a parameter dict, and the continuous actor's, fed the normal
    draw JAX's actor takes from its key; JAX's ``Policy.act`` against the
    port's scorer and sampler given JAX's gumbel draws."""
    from reagent_tpu.gym.policies.policy import Policy as JaxPolicy
    from reagent_tpu.gym.policies.policy import actor_scorer as jax_actor_scorer
    from reagent_tpu.gym.policies.policy import discrete_q_scorer as jax_discrete_q_scorer
    from reagent_tpu.models.actor import GaussianFullyConnectedActor as JaxGaussianActor
    from reagent_tpu_torch.gym.policies.policy import actor_scorer
    from reagent_tpu_torch.models.actor import GaussianFullyConnectedActor

    jnet, jparams, net, params = _cartpole_scorers()
    obs = np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32)
    _close(discrete_q_scorer(net)(params, torch.tensor(obs)),
           jax_discrete_q_scorer(jnet)(jparams, jnp.asarray(obs)), UTIL_TOL)
    key = jax.random.PRNGKey(4)
    g = np.asarray(jax.random.gumbel(key, (6, 2), jnp.float32))
    want = JaxPolicy(jax_discrete_q_scorer(jnet), JaxSoftmaxActionSampler()).act(
        jparams, jnp.asarray(obs), key)
    got = SoftmaxActionSampler().sample_action(
        discrete_q_scorer(net)(params, torch.tensor(obs)), noise=torch.tensor(g))
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(want.action))

    jactor = JaxGaussianActor(state_dim=4, action_dim=2, sizes=[8], activations=["relu"])
    jap = jactor.init(jax.random.PRNGKey(5), jnp.zeros((1, 4)))
    actor = GaussianFullyConnectedActor(state_dim=4, action_dim=2, sizes=[8],
                                        activations=["relu"])
    ap = q_network_state_from_flax(_np_tree(jap))
    want = jax_actor_scorer(jactor)((jap, key), jnp.asarray(obs))
    noise = torch.tensor(np.asarray(jax.random.normal(key, (6, 2))))
    got = actor_scorer(actor)((ap, noise), torch.tensor(obs))
    _close(got.action, want.action, dict(rtol=1e-5, atol=1e-6))


# --------------------------------------------------------------- trainers

def _episodes(seed, n, mask_actions=False):
    """Padded numpy episodes: T steps, the last few masked, random one-hot
    actions and behaviour log-probs, rewards in [0, 2)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        valid = np.ones(T, np.float32)
        valid[T - int(rng.integers(1, 5)):] = 0.0
        actions = rng.integers(0, A, T)
        pam = np.ones((T, A), np.float32)
        if mask_actions:
            pam[np.arange(T), (actions + 1) % A] = 0.0
        yield dict(s=rng.normal(size=(T, D)).astype(np.float32),
                   a=np.eye(A, dtype=np.float32)[actions],
                   r=rng.uniform(0, 2, T).astype(np.float32),
                   lp=np.log(rng.uniform(0.2, 0.6, T)).astype(np.float32),
                   valid=valid, pam=pam if mask_actions else None)


def _episode(mod, conv, e):
    return mod.PolicyGradientInput(
        state=mod.FeatureData(float_features=conv(e["s"])), action=conv(e["a"]),
        reward=conv(e["r"]), log_prob=conv(e["lp"]),
        possible_actions_mask=None if e["pam"] is None else conv(e["pam"]),
        valid_mask=conv(e["valid"]))


REINFORCE_CASES = {
    "on_policy": dict(kw=dict(gamma=0.99)),
    "on_policy_masked_actions": dict(kw=dict(gamma=0.9), mask_actions=True),
    "off_policy_clip": dict(kw=dict(gamma=0.99, off_policy=True, clip_param=1.5)),
    "subtract_mean_only": dict(kw=dict(gamma=0.5, normalize=False, offset_clamp_min=True,
                                       reward_clip=1.5)),
    "value_net": dict(value=True, kw=dict(
        gamma=0.99, normalize=False, subtract_mean=False,
        optimizer_value_net={"Adam": {"lr": 3e-3}})),
}
PPO_CASES = {
    "one_epoch": dict(kw=dict(gamma=0.99, update_epochs=1)),
    "three_epochs_entropy": dict(kw=dict(gamma=0.99, update_epochs=3, entropy_weight=0.05,
                                         ppo_epsilon=0.1)),
    "reward_clip_clamp": dict(kw=dict(gamma=0.9, reward_clip=1.2, offset_clamp_min=True,
                                      normalize=True, subtract_mean=True), mask_actions=True),
    "value_net": dict(value=True, kw=dict(
        gamma=0.99, update_epochs=2, normalize=False,
        optimizer_value_net={"Adam": {"lr": 3e-3}})),
}
TRAINERS = {"reinforce": (JaxReinforceTrainer, ReinforceTrainer, reinforce_state_from_arrays,
                          REINFORCE_CASES),
            "ppo": (JaxPPOTrainer, PPOTrainer, ppo_state_from_arrays, PPO_CASES)}


def carry_pg_state(kind, jstate, device="cpu"):
    """The port's REINFORCE or PPO state from a JAX one."""
    carry = TRAINERS[kind][2]
    value = jstate.value_params is not None
    return carry(_np_tree(jstate.policy_params), _adam(jstate.opt_state),
                 np.asarray(jstate.step), device,
                 value_params=_np_tree(jstate.value_params) if value else None,
                 value_opt_state=_adam(jstate.value_opt_state) if value else None)


def pg_trainers(kind, case, device="cpu", sizes=SIZES, acts=ACTS, state_dim=D,
                num_actions=A, optimizer=None):
    """(JAX trainer, its init state, the port's trainer, the carried state)."""
    jcls, cls, _, cases = TRAINERS[kind]
    spec = cases[case]

    def nets(Net, Value):
        return dict(scorer=Net(state_dim=state_dim, action_dim=num_actions, sizes=sizes,
                               activations=acts),
                    value_net=(Value(state_dim=state_dim, sizes=[8], activations=["relu"])
                               if spec.get("value") else None))

    kw = dict(optimizer=optimizer or {"Adam": {"lr": 5e-3}}, **spec["kw"])
    jtrainer = jcls(sampler=JaxSoftmaxActionSampler(), **nets(JaxFullyConnectedDQN,
                                                              JaxValueNetwork), **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, state_dim)))
    trainer = cls(sampler=SoftmaxActionSampler(), device=device,
                  **nets(FullyConnectedDQN, ValueNetwork), **kw)
    return jtrainer, jstate, trainer, carry_pg_state(kind, jstate, device)


def assert_pg_state_close(state, jstate, tol=STEP_TOL):
    for name, opt in (("policy_params", "opt_state"), ("value_params", "value_opt_state")):
        want = getattr(jstate, name)
        if want is None:
            assert getattr(state, name) is None, name
            continue
        want = q_network_state_from_flax(_np_tree(want))
        assert set(getattr(state, name)) == set(want), name
        for k in want:
            _close(getattr(state, name)[k], want[k], tol, f"{name} {k}")
        got_opt, want_opt = getattr(state, opt), _adam(getattr(jstate, opt))
        assert int(got_opt.count) == int(want_opt.count)
        for field in ("mu", "nu"):
            for k, v in getattr(want_opt, field).items():
                _close(getattr(got_opt, field)[k], v, tol, f"{opt} {field} {k}")
    assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("kind,case", [("reinforce", c) for c in REINFORCE_CASES]
                         + [("ppo", c) for c in PPO_CASES])
def test_policy_gradient_lockstep_with_jax(kind, case):
    jtrainer, jstate, trainer, state = pg_trainers(kind, case)
    mask_actions = TRAINERS[kind][3][case].get("mask_actions", False)
    for e in _episodes(5, 5, mask_actions):
        jstate, jm = jtrainer.train_step(jstate, _episode(jrlt, jnp.asarray, e))
        state, m = trainer.train_step(state, _episode(rlt, torch.tensor, e))
        assert m.keys() == jm.keys()
        for name in jm:
            _close(m[name], jm[name], METRIC_TOL, name)
    assert_pg_state_close(state, jstate)
    if case == "off_policy_clip":
        assert float(m["eligibility_mean"]) <= 1.5 + 1e-6
    if TRAINERS[kind][3][case].get("value"):
        assert float(m["value_loss"]) > 0.0


def test_value_baseline_refuses_normalization():
    for cls, kw in ((ReinforceTrainer, dict(subtract_mean=True, normalize=False)),
                    (PPOTrainer, dict(normalize=True))):
        with pytest.raises(ValueError, match="value baseline"):
            cls(scorer=FullyConnectedDQN(D, A, [8], ["relu"]), sampler=SoftmaxActionSampler(),
                value_net=ValueNetwork(D, [8], ["relu"]), device="cpu", **kw)
    with pytest.raises(ValueError, match="ppo_epsilon"):
        PPOTrainer(scorer=FullyConnectedDQN(D, A, [8], ["relu"]),
                   sampler=SoftmaxActionSampler(), ppo_epsilon=1.5, device="cpu")


# -------------------------------------------------------------- episodes

def jax_episode_noise(key, max_steps, num_actions, reset_noise_dim=4):
    """The draws ``reagent_tpu/gym/episodic.py::collect_episode`` takes from
    ``key``, as the port's ``noise``: the reset uniforms and the sampler's
    gumbel draws, one [1, A] a step."""
    r0, key = jax.random.split(key)
    gumbels = []
    for _ in range(max_steps):
        key, r_act, _ = jax.random.split(key, 3)
        gumbels.append(np.asarray(jax.random.gumbel(r_act, (1, num_actions), jnp.float32))[0])
    return (torch.tensor(np.asarray(jax.random.uniform(r0, (reset_noise_dim,), jnp.float32))),
            torch.tensor(np.stack(gumbels)))


def _cartpole_scorers(seed=0, sizes=(16, 16)):
    jnet = JaxFullyConnectedDQN(state_dim=4, action_dim=2, sizes=list(sizes),
                                activations=["leaky_relu"] * len(sizes))
    jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4)))
    net = FullyConnectedDQN(4, 2, list(sizes), ["leaky_relu"] * len(sizes))
    params = {k: v for k, v in q_network_state_from_flax(_np_tree(jparams)).items()}
    return jnet, jparams, net, params


@pytest.mark.parametrize("seed", [0, 7])
def test_collect_episode_fed_jax_draws_matches_jax(seed):
    """A CartPole episode padded to 60 steps, its act step through K3's
    plain version: key 0's episode ends at step 26 (the mask's tail, where
    the env steps on and the rewards are zeroed), key 7's runs all 60.  The
    log-probs within 1e-5 (a float32 log-softmax of logits that carry the
    observations' ulps)."""
    jnet, jparams, net, params = _cartpole_scorers()
    key, max_steps = jax.random.PRNGKey(seed), 60
    jep, jret = jax_collect_episode(JaxCartPole(max_steps=200), jnet.apply,
                                    JaxSoftmaxActionSampler(), jparams, key, max_steps)
    calls = fused_mlp.fused_mlp_forward_reference.calls
    ep, ret = collect_episode(CartPole(max_steps=200, device="cpu"), discrete_q_scorer(net),
                              SoftmaxActionSampler(), params, max_steps,
                              noise=jax_episode_noise(key, max_steps, 2))
    assert fused_mlp.fused_mlp_forward_reference.calls - calls == max_steps
    _close(ep.state.float_features, jep.state.float_features, OBS_TOL)
    np.testing.assert_array_equal(ep.action.numpy(), np.asarray(jep.action))
    np.testing.assert_array_equal(ep.valid_mask.numpy(), np.asarray(jep.valid_mask))
    np.testing.assert_array_equal(ep.reward.numpy(), np.asarray(jep.reward))
    _close(ep.log_prob, jep.log_prob, dict(rtol=0, atol=1e-5))
    assert float(ret) == float(jret) == float(ep.valid_mask.sum())
    assert ep.state.float_features.shape == (max_steps, 4) and ep.action.shape == (max_steps, 2)
    assert (float(ep.valid_mask[-1]) == 0.0) == (seed == 0)


def test_collect_episode_draws_from_its_generator():
    _, _, net, params = _cartpole_scorers()
    env = CartPole(max_steps=200, device="cpu")
    runs = [collect_episode(env, discrete_q_scorer(net), SoftmaxActionSampler(), params, 40,
                            generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(runs[0].action, runs[1].action)
    assert not torch.equal(runs[0].state.float_features, runs[2].state.float_features)
    with pytest.raises(ValueError, match="noise or a generator"):
        collect_episode(env, discrete_q_scorer(net), SoftmaxActionSampler(), params, 5)


@pytest.mark.parametrize("kind", ["reinforce", "ppo"])
def test_episodic_trainer_step_lockstep_with_jax(kind):
    """3 episodes of at most 60 steps, each collected with the current policy
    and trained on, both packages from JAX's init and JAX's draws."""
    case = "on_policy" if kind == "reinforce" else "one_epoch"
    jtrainer, jstate, trainer, state = pg_trainers(
        kind, case, sizes=[16, 16], acts=["leaky_relu"] * 2, num_actions=2)
    jenv, env = JaxCartPole(max_steps=200), CartPole(max_steps=200, device="cpu")
    jstep = jax_make_episodic_trainer_step(jenv, jtrainer.scorer.apply, jtrainer.sampler,
                                           jtrainer, 60)
    step = make_episodic_trainer_step(env, discrete_q_scorer(trainer.scorer), trainer.sampler,
                                      trainer, 60)
    rng = jax.random.PRNGKey(1)
    for _ in range(3):
        rng, r = jax.random.split(rng)
        noise = jax_episode_noise(r, 60, 2)
        jstate, jret, jm = jstep(jstate, r)
        state, ret, m = step(state, noise=noise)
        assert float(ret) == float(jret)
        for name in jm:
            _close(m[name], jm[name], METRIC_TOL, name)
    assert_pg_state_close(state, jstate)


# ---------------------------------------------------------------- managers

def _pg_config(name, value=False):
    tp = dict(actions=["0", "1"], gamma=0.99, optimizer={"Adam": {"lr": 5e-3}},
              normalize=not value, subtract_mean=not value)
    if name == "PPO":
        tp.update(update_epochs=2, ppo_epsilon=0.1, entropy_weight=0.01)
    config = {"trainer_param": tp,
              "policy_net_builder": {"FullyConnected": {"sizes": [16, 8],
                                                        "activations": ["tanh", "relu"]}},
              "sampler_temperature": 0.5}
    if value:
        config["value_net_builder"] = {"FullyConnected": {"sizes": [8], "activations": ["relu"]}}
        tp["optimizer_value_net"] = {"Adam": {"lr": 1e-3}}
    return {name: config}


@pytest.mark.parametrize("name", ["Reinforce", "PPO"])
@pytest.mark.parametrize("value", [False, True])
def test_policy_gradient_managers_build_the_jax_managers_nets(name, value):
    """One config through both registries: the same nets (layer shapes,
    activations; the same outputs from carried weights), sampler and
    trainer options; ``create_policy`` scores through K3's plain version."""
    manager = MODEL_MANAGERS.build(_pg_config(name, value))
    jmanager = JAX_MODEL_MANAGERS.build(_pg_config(name, value))
    trainer = manager.build_trainer(state_dim=4, device="cpu")
    jtrainer = jmanager.build_trainer(state_dim=4)
    assert manager.action_names == jmanager.action_names == ["0", "1"]
    for attr in ("gamma", "normalize", "subtract_mean", "offset_clamp_min", "reward_clip"):
        assert getattr(trainer, attr) == getattr(jtrainer, attr), attr
    for attr in (("update_epochs", "ppo_epsilon", "entropy_weight") if name == "PPO"
                 else ("off_policy", "clip_param")):
        assert getattr(trainer, attr) == getattr(jtrainer, attr), attr
    assert trainer.sampler.temperature == jtrainer.sampler.temperature == 0.5
    jparams = jtrainer.scorer.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    params = q_network_state_from_flax(_np_tree(jparams))
    assert trainer.scorer.activations == ["tanh", "relu", "linear"]
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    _close(manager.create_policy(trainer).scorer(params, torch.tensor(x)),
           jtrainer.scorer.apply(jparams, jnp.asarray(x)), dict(rtol=1e-5, atol=1e-6))
    assert (trainer.value_net is None) == (jtrainer.value_net is None) == (not value)
    if value:
        jv = jtrainer.value_net.init(jax.random.PRNGKey(1), jnp.zeros((1, 4)))
        trainer.value_net.load_state_dict(q_network_state_from_flax(_np_tree(jv)))
        _close(trainer.value_net(torch.tensor(x)).detach(),
               jtrainer.value_net.apply(jv, jnp.asarray(x)), dict(rtol=1e-5, atol=1e-6))
    assert manager.state_dim(_norm_map()) == jmanager.state_dim(_jax_norm_map()) == 4
    policy = manager.create_policy(trainer)
    assert isinstance(policy, Policy)
    out = policy.act(params, torch.tensor(x), torch.Generator().manual_seed(0))
    assert out.action.shape == (5, 2) and out.log_prob.shape == (5,)


def _norm_map():
    from reagent_tpu_torch.core.parameters import (
        NormalizationData,
        NormalizationKey,
        NormalizationParameters,
    )
    return {NormalizationKey.STATE: NormalizationData(dense_normalization_parameters={
        i: NormalizationParameters(feature_type="CONTINUOUS", mean=0.0, stddev=1.0)
        for i in range(4)})}


def _jax_norm_map():
    from reagent_tpu.core.parameters import (
        NormalizationData,
        NormalizationKey,
        NormalizationParameters,
    )
    return {NormalizationKey.STATE: NormalizationData(dense_normalization_parameters={
        i: NormalizationParameters(feature_type="CONTINUOUS", mean=0.0, stddev=1.0)
        for i in range(4)})}


# ------------------------------------------------- the reference bars (slow)

def _greedy(net):
    scorer = discrete_q_scorer(net)

    def act(state, obs, generator):
        return torch.argmax(scorer(state.policy_params, obs), dim=1).to(torch.int32)

    return act


@pytest.mark.slow
@pytest.mark.parametrize("kind,episodes", [("reinforce", 300), ("ppo", 700)])
def test_policy_gradient_cartpole_bar(kind, episodes):
    """``tests/test_policy_gradient_trainers.py``'s two e2e runs on the port
    (discrete_reinforce/ppo_cartpole_online.yaml: bar 180 over 20 greedy
    episodes of at most 200 steps) from the port's own seed-0 init."""
    if kind == "reinforce":
        net = FullyConnectedDQN(4, 2, [64, 64], ["leaky_relu"] * 2)
        trainer = ReinforceTrainer(scorer=net, sampler=SoftmaxActionSampler(), gamma=0.99,
                                   optimizer={"Adam": {"lr": 5e-3}}, normalize=True,
                                   subtract_mean=True, device="cpu")
    else:
        net = FullyConnectedDQN(4, 2, [32, 32], ["leaky_relu"] * 2)
        trainer = PPOTrainer(scorer=net, sampler=SoftmaxActionSampler(), gamma=0.99,
                             optimizer={"Adam": {"lr": 1e-3, "weight_decay": 1e-3}},
                             ppo_epsilon=0.2, update_epochs=1, normalize=True,
                             subtract_mean=True, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    env = CartPole(max_steps=200, device="cpu")
    step = make_episodic_trainer_step(env, discrete_q_scorer(net), trainer.sampler, trainer, 200)
    generator = torch.Generator().manual_seed(1)
    for _ in range(episodes):
        state, _, _ = step(state, generator)
    evals = evaluate_policy(env, _greedy(net), state, torch.Generator().manual_seed(2), 20)
    assert float(evals.mean()) >= 180.0


@pytest.mark.slow
@pytest.mark.parametrize("kind,episodes", [("reinforce", 300), ("ppo", 700)])
def test_policy_gradient_cartpole_run_from_jax_init_and_draws(kind, episodes):
    """The runs of ``tests/test_policy_gradient_trainers.py``'s e2e tests
    (JAX's init from ``PRNGKey(0)``, each episode's key split from
    ``PRNGKey(1)``) on both packages, the port fed JAX's init and draws: the
    first 10 episodes' returns equal JAX's; the episode where the two runs
    first part, the runs' last 20 training returns and both greedy means
    over 20 episodes (the bar 180) are printed, not held.  A 200-step
    CartPole episode grows an ulp of sin or cos in the observations past
    1e-5 and then flips an action, after which the runs are two draws of
    the same training: on a CPU with torch 2.13 and JAX 0.9, REINFORCE parts
    at episode 19 and ends at 164.5 against JAX's 200 (ROADMAP.md §3)."""
    from reagent_tpu.gym.online_loop import evaluate_policy as jax_evaluate_policy

    if kind == "reinforce":
        sizes, optimizer = [64, 64], {"Adam": {"lr": 5e-3}}
        kw = dict(gamma=0.99, normalize=True, subtract_mean=True)
        jcls, cls = JaxReinforceTrainer, ReinforceTrainer
    else:
        sizes, optimizer = [32, 32], {"Adam": {"lr": 1e-3, "weight_decay": 1e-3}}
        kw = dict(gamma=0.99, ppo_epsilon=0.2, update_epochs=1, normalize=True,
                  subtract_mean=True)
        jcls, cls = JaxPPOTrainer, PPOTrainer
    acts = ["leaky_relu"] * 2
    jtrainer = jcls(scorer=JaxFullyConnectedDQN(4, 2, sizes, acts),
                    sampler=JaxSoftmaxActionSampler(), optimizer=optimizer, **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    trainer = cls(scorer=FullyConnectedDQN(4, 2, sizes, acts), sampler=SoftmaxActionSampler(),
                  optimizer=optimizer, device="cpu", **kw)
    state = carry_pg_state(kind, jstate)
    jenv, env = JaxCartPole(max_steps=200), CartPole(max_steps=200, device="cpu")
    jstep = jax_make_episodic_trainer_step(jenv, jtrainer.scorer.apply, jtrainer.sampler,
                                           jtrainer, 200)
    step = make_episodic_trainer_step(env, discrete_q_scorer(trainer.scorer), trainer.sampler,
                                      trainer, 200)
    rng, returns = jax.random.PRNGKey(1), []
    for _ in range(episodes):
        rng, r = jax.random.split(rng)
        state, ret, _ = step(state, noise=jax_episode_noise(r, 200, 2))
        jstate, jret, _ = jstep(jstate, r)
        returns.append((float(ret), float(jret)))
    assert all(p == j for p, j in returns[:10])
    parted = next((i for i, (p, j) in enumerate(returns) if p != j), None)
    ours = evaluate_policy(env, _greedy(trainer.scorer), state,
                           torch.Generator().manual_seed(2), 20)

    def jax_greedy(ts, obs, key):
        return jnp.argmax(jtrainer.scorer.apply(ts.policy_params, obs[None])[0]).astype(
            jnp.int32)

    theirs = jax_evaluate_policy(jenv, jax_greedy, jstate, jax.random.PRNGKey(2), 20)
    last = np.mean(returns[-20:], axis=0)
    print(f"{kind}: the runs part at episode {parted}; last 20 training returns: port "
          f"{last[0]}, JAX {last[1]}; greedy means over 20 episodes: port "
          f"{float(ours.mean())}, JAX {float(np.mean(np.asarray(theirs)))} (bar 180)")
    assert bool(torch.isfinite(ours).all())
