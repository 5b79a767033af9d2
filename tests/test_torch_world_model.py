"""The world-model slice against the JAX package: ``MemoryNetwork`` and
``gmm_loss``, ``MDNRNNTrainer``, ``StateEmbedEnv`` and online DQN on the
embedded StringGame, each from weights carried across
(``interop.memory_network_state_from_flax``, ``opt_state_from_optax``).

Tolerances: the forward's every output rtol 1e-5, atol 1e-6 (float32, the
gate products summed in each library's order); the trainer's losses rtol
1e-4, parameters and Adam moments rtol 5e-4, atol 5e-5 over 10 steps (the
Adam tolerance of the other lockstep tests: m / sqrt(v) turns a tiny
gradient difference into a visible step where |g| is small); the embedded
observations atol 1e-5 (the hidden state after up to six LSTM steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import MDNRNNTrainerParameters as JaxMDNRNNParams
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.gym.envs.extra import StringGame as JaxStringGame
from reagent_tpu.gym.envs.state_embed import StateEmbedEnv as JaxStateEmbedEnv
from reagent_tpu.gym.online_loop import prefill_replay_buffer as jax_prefill
from reagent_tpu.gym.preprocessors import make_discrete_dqn_batch as jax_make_batch
from reagent_tpu.models import FullyConnectedDQN as JaxDQN
from reagent_tpu.models.mdn_rnn import MemoryNetwork as JaxMemoryNetwork
from reagent_tpu.models.mdn_rnn import MDNRNNMemoryPool as JaxPool
from reagent_tpu.models.mdn_rnn import gmm_loss as jax_gmm_loss
from reagent_tpu.replay import ReplayBuffer as JaxReplayBuffer
from reagent_tpu.training import DQNTrainer as JaxDQNTrainer
from reagent_tpu.training.world_model import MDNRNNTrainer as JaxMDNRNNTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import MDNRNNTrainerParameters, RLParameters
from reagent_tpu_torch.gym.envs import StateEmbedEnv, StringGame
from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.mdn_rnn import MDNRNNMemoryPool, MemoryNetwork, gmm_loss
from reagent_tpu_torch.replay import ReplayBuffer
from reagent_tpu_torch.training import DQNTrainer
from reagent_tpu_torch.training.world_model import MDNRNNTrainer, MDNRNNTrainerState
from reagent_tpu_torch.utils.interop import (
    dqn_state_from_arrays,
    memory_network_state_from_flax,
    opt_state_from_optax,
    replay_state_from_arrays,
)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
OUTPUTS = ("mus", "sigmas", "logpi", "reward", "not_terminal", "last_step_hidden",
           "last_step_cell", "all_steps_hidden")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seq_batch(rng, T, B, S, A, pkg):
    """A [T, B] world-model batch from numpy: states, one-hot actions, next
    states, rewards, not-terminals with a few zeros."""
    state = rng.normal(size=(T, B, S)).astype(np.float32)
    action = np.eye(A, dtype=np.float32)[rng.integers(0, A, (T, B))]
    next_state = rng.normal(size=(T, B, S)).astype(np.float32)
    reward = rng.normal(size=(T, B)).astype(np.float32)
    not_terminal = (rng.random((T, B)) > 0.1).astype(np.float32)
    t, mod = (jnp.asarray, jrlt) if pkg == "jax" else (torch.tensor, rlt)
    return mod.MemoryNetworkInput(
        state=mod.FeatureData(t(state)), next_state=mod.FeatureData(t(next_state)),
        action=mod.FeatureData(t(action)), reward=t(reward), time_diff=t(np.ones((T, B), np.float32)),
        step=None, not_terminal=t(not_terminal))


def _port_net(jparams, S, A, H, L, G, delta=False):
    net = MemoryNetwork(S, A, H, L, G, delta)
    net.load_state_dict(memory_network_state_from_flax(_np(jparams)))
    return net


@pytest.mark.parametrize("layers,gaussians,delta", [
    (1, 1, False), (1, 1, True), (1, 3, False), (1, 3, True),
    (2, 1, False), (2, 1, True), (2, 3, False), (2, 3, True)])
def test_memory_network_forward_and_gmm_loss(layers, gaussians, delta):
    T, B, S, A, H = 6, 8, 3, 2, 16
    rng = np.random.default_rng(layers * 10 + gaussians)
    jb, b = _seq_batch(rng, T, B, S, A, "jax"), _seq_batch(np.random.default_rng(
        layers * 10 + gaussians), T, B, S, A, "torch")
    jnet = JaxMemoryNetwork(S, A, H, layers, gaussians, delta)
    jparams = jnet.init(jax.random.PRNGKey(layers + gaussians), jb.state, jb.action)
    want = jnet.apply(jparams, jb.state, jb.action)
    net = _port_net(jparams, S, A, H, layers, gaussians, delta)
    with torch.no_grad():
        got = net(b.state, b.action)
    for f in OUTPUTS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   **FWD_TOL, err_msg=f)
    for reduce in (True, False):
        np.testing.assert_allclose(
            gmm_loss(b.next_state.float_features, got.mus, got.sigmas, got.logpi,
                     reduce=reduce).numpy(),
            np.asarray(jax_gmm_loss(jb.next_state.float_features, want.mus, want.sigmas,
                                    want.logpi, reduce=reduce)), **FWD_TOL)


def _assert_params_close(params, jparams, what):
    want = memory_network_state_from_flax(_np(jparams))
    assert set(params) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), **PARAM_TOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("fit_only_one_next_step", [False, True])
def test_mdnrnn_trainer_lockstep_with_jax(fit_only_one_next_step):
    """10 steps from JAX's init on the same batches: every loss term each
    step, then the parameters and both Adam moments."""
    T, B, S, A, H, L, G = 5, 16, 3, 2, 16, 2, 3
    kw = dict(learning_rate=0.01, fit_only_one_next_step=fit_only_one_next_step,
              reward_loss_weight=0.5, not_terminal_loss_weight=2.0)
    jtrainer = JaxMDNRNNTrainer(JaxMemoryNetwork(S, A, H, L, G), JaxMDNRNNParams(**kw))
    rng = np.random.default_rng(9)
    jstate = jtrainer.init(jax.random.PRNGKey(2), _seq_batch(rng, T, B, S, A, "jax"))
    trainer = MDNRNNTrainer(MemoryNetwork(S, A, H, L, G), MDNRNNTrainerParameters(**kw),
                            device="cpu")
    state = MDNRNNTrainerState(
        params=memory_network_state_from_flax(_np(jstate.params)),
        opt_state=opt_state_from_optax(jstate.opt_state), step=torch.tensor(0, dtype=torch.int32))
    for i in range(10):
        seed = 100 + i
        jstate, jl = jtrainer.train_step(jstate, _seq_batch(np.random.default_rng(seed), T, B, S,
                                                            A, "jax"))
        state, losses = trainer.train_step(state, _seq_batch(np.random.default_rng(seed), T, B,
                                                             S, A, "torch"))
        for k in ("gmm", "bce", "mse", "loss"):
            np.testing.assert_allclose(float(losses[k]), float(jl[k]), **LOSS_TOL,
                                       err_msg=f"step {i} {k}")
    assert int(state.step) == int(jstate.step) == 10
    _assert_params_close(state.params, jstate.params, "params")
    theirs = opt_state_from_optax(jstate.opt_state)
    assert int(state.opt_state.count) == int(theirs.count) == 10
    for field in ("mu", "nu"):
        for k, v in getattr(theirs, field).items():
            np.testing.assert_allclose(getattr(state.opt_state, field)[k].numpy(), v.numpy(),
                                       **PARAM_TOL, err_msg=f"{field} {k}")


def _trained_string_world_model(steps=20, hid=16):
    """JAX's MemoryNetwork on StringGame after ``steps`` Adam steps on random
    [6, 64] episodes (the string job's world model, fewer steps): (the JAX
    env and params, the port's MemoryNetwork and params)."""
    jenv = JaxStringGame()
    jmn = JaxMemoryNetwork(state_dim=2, action_dim=2, num_hiddens=hid, num_hidden_layers=1,
                           num_gaussians=1)
    jtrainer = JaxMDNRNNTrainer(jmn, JaxMDNRNNParams(learning_rate=3e-3))
    rng = np.random.default_rng(0)
    T, B = 6, 64
    acts = rng.integers(0, 2, (T, B))
    obs = np.zeros((T, B, 2), np.float32)
    obs[1:] = np.eye(2, dtype=np.float32)[acts[:-1]]
    next_obs = np.eye(2, dtype=np.float32)[acts]
    rew = np.zeros((T, B), np.float32)
    for t in range(2, T):  # ABB +5, BBB -5
        w = np.stack([acts[t - 2], acts[t - 1], acts[t]], -1)
        rew[t] = np.where((w == [0, 1, 1]).all(-1), 5.0, np.where((w == 1).all(-1), -5.0, 0.0))
    nt = np.ones((T, B), np.float32)
    nt[-1] = 0.0
    batch = jrlt.MemoryNetworkInput(
        state=jrlt.FeatureData(jnp.asarray(obs)), next_state=jrlt.FeatureData(jnp.asarray(next_obs)),
        action=jrlt.FeatureData(jnp.asarray(np.eye(2, dtype=np.float32)[acts])),
        reward=jnp.asarray(rew), time_diff=jnp.ones((T, B)), step=None,
        not_terminal=jnp.asarray(nt))
    jstate = jtrainer.init(jax.random.PRNGKey(1), batch)
    for _ in range(steps):
        jstate, _ = jtrainer.train_step(jstate, batch)
    jparams = _np(jstate.params)
    net = MemoryNetwork(2, 2, hid, 1, 1)
    params = memory_network_state_from_flax(jparams)
    net.load_state_dict(params)
    return jenv, jmn, jparams, net, params


@pytest.mark.parametrize("seq_len", [6, 3])
def test_state_embed_env_episode_matches_jax(seq_len):
    """A StringGame episode of 6 steps (two of them: the second after a
    reset) with JAX's trained weights: the empty-history reset, the history
    filling and, at ``seq_len`` 3, its shift once full; observations atol
    1e-5, rewards and done flags exactly."""
    jenv, jmn, jparams, net, params = _trained_string_world_model()
    jembed = JaxStateEmbedEnv(jenv, jmn, jparams, max_embed_seq_len=seq_len)
    embed = StateEmbedEnv(StringGame(device="cpu"), net, params, max_embed_seq_len=seq_len)
    assert embed.observation_dim == jembed.observation_dim == 18
    key = jax.random.PRNGKey(3)
    for actions in ([0, 1, 1, 0, 1, 1], [1, 1, 1, 0, 0, 1]):
        jstate, jobs = jembed.reset(key)
        state, obs = embed.reset()
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-5)
        for t, a in enumerate(actions):
            jstate, jobs, jrew, jdone = jembed.step(jstate, jnp.asarray(a), key)
            state, obs, rew, done = embed.step(state, torch.tensor(a))
            np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-5,
                                       err_msg=f"step {t}")
            assert float(rew) == float(jrew) and bool(done) == bool(jdone)
            assert int(state.hist_len) == int(jstate.hist_len) == min(t + 1, seq_len)
            np.testing.assert_array_equal(state.obs_hist.numpy(), np.asarray(jstate.obs_hist))
        assert bool(done)


def test_state_embed_padding_is_causal():
    """tests/test_state_embed_env.py:67 on the port: garbage in the padding
    beyond hist_len does not change the embedding of a short history; and
    the batched embed equals the unbatched one."""
    from reagent_tpu_torch.gym.envs import CartPole

    mn = MemoryNetwork(state_dim=4, action_dim=2, num_hiddens=8, num_hidden_layers=1,
                       num_gaussians=2)
    mn.reset_parameters(torch.Generator().manual_seed(0))
    env = StateEmbedEnv(CartPole(max_steps=50, device="cpu"), mn,
                        {k: v.detach() for k, v in mn.named_parameters()}, max_embed_seq_len=6)
    obs_h = torch.zeros((6, 4))
    obs_h[0] = 1.0
    act_h = torch.zeros((6, 2))
    act_h[0] = torch.tensor([1.0, 0.0])
    e1 = env._embed(obs_h, act_h, torch.tensor(1, dtype=torch.int32))
    obs_h2, act_h2 = obs_h.clone(), act_h.clone()
    obs_h2[3] = 99.0
    act_h2[3] = -7.0
    e2 = env._embed(obs_h2, act_h2, torch.tensor(1, dtype=torch.int32))
    torch.testing.assert_close(e1, e2, rtol=1e-6, atol=0)
    both = env._embed(torch.stack([obs_h, obs_h2]), torch.stack([act_h, act_h2]),
                      torch.tensor([1, 4], dtype=torch.int32))
    torch.testing.assert_close(both[0], e1, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(both[1], env._embed(obs_h2, act_h2, torch.tensor(4)),
                               rtol=1e-6, atol=1e-7)


def test_memory_pool_batches_match_jax():
    """The same inserts and the same numpy draws give the same time-major
    batch."""
    pool, jpool = MDNRNNMemoryPool(8, device="cpu"), JaxPool(8)
    rng = np.random.default_rng(4)
    for _ in range(11):  # past the capacity: the oldest go
        row = (rng.normal(size=(5, 3)), np.eye(2)[rng.integers(0, 2, 5)], rng.normal(size=(5, 3)),
               rng.normal(size=5), (rng.random(5) > 0.2).astype(np.float32))
        pool.insert_into_memory(*row)
        jpool.insert_into_memory(*row)
    assert pool.memory_size == jpool.memory_size == 8
    got = pool.sample_memories(6, np.random.default_rng(1))
    want = jpool.sample_memories(6, np.random.default_rng(1))
    for get in (lambda b: b.state.float_features, lambda b: b.action.float_features,
                lambda b: b.next_state.float_features, lambda b: b.reward,
                lambda b: b.not_terminal, lambda b: b.time_diff):
        np.testing.assert_array_equal(get(got).numpy(), np.asarray(get(want)))
    assert got.state.float_features.shape == (5, 6, 3)


def test_world_model_dqn_lockstep_with_jax():
    """The string job's DQN on embedded observations, 10 train steps, each
    from JAX's state: JAX prefills its replay buffer on its StateEmbedEnv,
    the buffer is carried across, and each step both trainers take the batch
    of the same replay indices (JAX's draw); the JAX-side td_loss and
    q-values rtol 1e-4, and the parameters after the last step."""
    jenv, jmn, jparams, net, params = _trained_string_world_model(steps=10)
    jembed = JaxStateEmbedEnv(jenv, jmn, jparams, max_embed_seq_len=6)
    D = jembed.observation_dim
    kw = dict(state_dim=D, action_dim=2, sizes=[64, 32], activations=["leaky_relu", "leaky_relu"])
    rl = dict(gamma=0.99, target_update_rate=0.2)
    opt = {"Adam": {"lr": 0.003}}
    jtrainer = JaxDQNTrainer(q_network=JaxDQN(**kw), rl=JaxRLParameters(**rl), optimizer=opt)
    trainer = DQNTrainer(q_network=FullyConnectedDQN(**kw), rl=RLParameters(**rl), optimizer=opt,
                         device="cpu")
    jrb = JaxReplayBuffer(replay_capacity=512, update_horizon=1, gamma=0.99)
    ri, rf, rs = jax.random.split(jax.random.PRNGKey(2), 3)
    jstate = jtrainer.init(ri, jnp.zeros((1, D)))
    jrs = jrb.init(observation=jnp.zeros(D), action=jnp.int32(0), reward=jnp.float32(0),
                   terminal=jnp.bool_(False))
    jrs = jax_prefill(jembed, jrb, jrs, rf, num_steps=300)
    rb = ReplayBuffer(replay_capacity=512, update_horizon=1, gamma=0.99, device="cpu")
    rs_port = replay_state_from_arrays(
        {k: np.asarray(v) for k, v in jrs.store.items()}, np.asarray(jrs.add_count),
        np.asarray(jrs.is_valid), np.asarray(jrs.episode_len))
    for i in range(10):
        state = dqn_state_from_arrays(_np(jstate.q_params), _np(jstate.q_target_params),
                                      opt_state_from_optax(jstate.opt_state),
                                      np.asarray(jstate.step))
        rs, r = jax.random.split(rs)
        jsample = jrb.sample(jrs, r, 256)
        sample = rb.sample(rs_port, indices=torch.tensor(np.asarray(jsample["indices"])[:, 0]))
        np.testing.assert_array_equal(sample["state"].numpy(), np.asarray(jsample["state"]))
        jstate, jm = jtrainer.train_step(jstate, jax_make_batch(jsample, 2))
        state, m = trainer.train_step(state, make_discrete_dqn_batch(sample, 2))
        for k in ("td_loss", "q_values_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL, err_msg=f"{i} {k}")
    want = dqn_state_from_arrays(_np(jstate.q_params), _np(jstate.q_target_params),
                                 opt_state_from_optax(jstate.opt_state), np.asarray(jstate.step))
    for k, v in want.q_params.items():
        np.testing.assert_allclose(state.q_params[k].numpy(), v.numpy(), **PARAM_TOL, err_msg=k)
