"""The host side of the gym package against the JAX package's: ``Agent``
with ``run_episode`` and ``evaluate_for_n_episodes``, the three datasets,
the normalizer builders and ``create_df_from_replay_buffer``.

The agent acts greedily through a q-network with JAX's weights carried
across (``interop.q_network_state_from_flax``), so the trajectories and
returns are held equal; the datasets replay JAX's draws (the sampled
replay indices, each episode's reset uniforms and gumbels) and their
batches are held equal in order: integer and flag fields exactly, floats to
atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from reagent_tpu.gym import utils as jutils
from reagent_tpu.gym.agents.agent import Agent as JaxAgent
from reagent_tpu.gym.datasets import EpisodicDataset as JaxEpisodicDataset
from reagent_tpu.gym.datasets import OfflineReplayBufferDataset as JaxOfflineDataset
from reagent_tpu.gym.datasets import ReplayBufferDataset as JaxReplayBufferDataset
from reagent_tpu.gym.envs import CartPole as JaxCartPole
from reagent_tpu.gym.envs import OpenGridworld as JaxOpenGridworld
from reagent_tpu.gym.envs import Pendulum as JaxPendulum
from reagent_tpu.gym.policies.policy import Policy as JaxPolicy
from reagent_tpu.gym.policies.policy import discrete_q_scorer as jax_discrete_q_scorer
from reagent_tpu.gym.policies.samplers import GreedyActionSampler as JaxGreedy
from reagent_tpu.gym.policies.samplers import SoftmaxActionSampler as JaxSoftmax
from reagent_tpu.gym.runners.gymrunner import evaluate_for_n_episodes as jax_evaluate
from reagent_tpu.gym.runners.gymrunner import run_episode as jax_run_episode
from reagent_tpu.models import FullyConnectedDQN as JaxDQN
from reagent_tpu.replay import ReplayBuffer as JaxReplayBuffer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.gym import utils
from reagent_tpu_torch.gym.agents import Agent
from reagent_tpu_torch.gym.agents.agent import (
    continuous_action_extractor,
    discrete_action_extractor,
)
from reagent_tpu_torch.gym.datasets import (
    EpisodicDataset,
    OfflineReplayBufferDataset,
    ReplayBufferDataset,
)
from reagent_tpu_torch.gym.envs import CartPole, OpenGridworld, Pendulum
from reagent_tpu_torch.gym.policies import GreedyActionSampler, Policy, SoftmaxActionSampler
from reagent_tpu_torch.gym.policies import discrete_q_scorer
from reagent_tpu_torch.gym.runners import Trajectory, evaluate_for_n_episodes, run_episode
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.replay import ReplayBuffer
from reagent_tpu_torch.utils.interop import q_network_state_from_flax

gymnasium = pytest.importorskip("gymnasium")


class LineWalk:
    """A host env: a walker on -3..3 from 0; action 1 steps right, 0 left;
    reward -|position| a step; done at either end or after 12 steps."""

    def __init__(self):
        self.action_space = gymnasium.spaces.Discrete(2)
        self.observation_space = gymnasium.spaces.Box(-1.0, 1.0, (3,), np.float32)
        self.pos, self.t = 0, 0

    def _obs(self):
        return np.array([self.pos / 3.0, float(self.t) / 12.0, 1.0], np.float32)

    def reset(self):
        self.pos, self.t = 0, 0
        return self._obs()

    def step(self, action):
        self.pos += 1 if int(action) == 1 else -1
        self.t += 1
        return self._obs(), -float(abs(self.pos)), abs(self.pos) == 3 or self.t >= 12


def _q_nets(seed, state_dim=3, action_dim=2):
    jnet = JaxDQN(state_dim=state_dim, action_dim=action_dim, sizes=[16],
                  activations=["tanh"])
    jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, state_dim)))
    net = FullyConnectedDQN(state_dim, action_dim, [16], ["tanh"])
    params = q_network_state_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    return jnet, jparams, net, params


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agent_runs_the_same_episodes_as_jax(seed):
    jnet, jparams, net, params = _q_nets(seed)
    seen, jseen = [], []
    agent = Agent.create_for_env(
        LineWalk(), Policy(discrete_q_scorer(net), GreedyActionSampler()), lambda: params,
        post_transition_callback=seen.append, device="cpu")
    jagent = JaxAgent.create_for_env(
        LineWalk(), JaxPolicy(jax_discrete_q_scorer(jnet), JaxGreedy()), lambda: jparams,
        post_transition_callback=jseen.append)
    assert agent.action_extractor is discrete_action_extractor
    traj, jtraj = run_episode(LineWalk(), agent), jax_run_episode(LineWalk(), jagent)
    assert isinstance(traj, Trajectory)
    assert traj.actions == jtraj.actions and traj.rewards == jtraj.rewards
    for o, jo in zip(traj.observations, jtraj.observations):
        np.testing.assert_array_equal(o, jo)
    assert len(seen) == len(jseen) == len(traj)
    assert traj.calculate_cumulative_reward(0.9) == jtraj.calculate_cumulative_reward(0.9)
    got = evaluate_for_n_episodes(3, LineWalk(), agent, max_steps=5, gamma=0.95)
    want = jax_evaluate(3, LineWalk(), jagent, max_steps=5, gamma=0.95)
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_array_equal(got, want)


def test_action_extractors_and_callbacks():
    out = rlt.ActorOutput(action=torch.tensor([[0.0, 0.0, 1.0, 0.0]]))
    assert discrete_action_extractor(out) == 2
    cont = rlt.ActorOutput(action=torch.tensor([[0.25, -0.5]]))
    np.testing.assert_array_equal(continuous_action_extractor(cont), np.array([0.25, -0.5],
                                                                            np.float32))
    episodes = []
    agent = Agent(Policy(lambda p, x: x @ p, GreedyActionSampler()), lambda: torch.eye(3),
                  obs_preprocessor=lambda o: o[::-1].copy(), post_episode_callback=episodes.append,
                  device="cpu")
    assert agent.act(np.array([0.0, 1.0, 5.0], np.float32)) == 0  # reversed: [5, 1, 0]
    traj = run_episode(LineWalk(), agent, max_steps=4)
    assert episodes == [traj] and len(traj) == 3  # always left: done at -3
    box = type("BoxEnv", (), {"action_space": gymnasium.spaces.Box(-1, 1, (2,))})()
    assert Agent.create_for_env(box, Policy(None, None), dict,
                                device="cpu").action_extractor is continuous_action_extractor


def _transitions(n):
    return [dict(observation=np.full((4,), i, np.float32), action=np.int32(i % 2),
                 reward=np.float32(i % 3), terminal=np.bool_(i % 8 == 7)) for i in range(n)]


def _buffers(capacity, n, horizon=1):
    jrb = JaxReplayBuffer(replay_capacity=capacity, batch_size=16, update_horizon=horizon,
                          gamma=0.9)
    rb = ReplayBuffer(replay_capacity=capacity, batch_size=16, update_horizon=horizon,
                      gamma=0.9, device="cpu")
    ex = _transitions(1)[0]
    jstate = jrb.init(**{k: jnp.asarray(v) for k, v in ex.items()})
    state = rb.init(**{k: torch.tensor(v) for k, v in ex.items()})
    for tr in _transitions(n):
        jstate = jrb.add(jstate, **{k: jnp.asarray(v) for k, v in tr.items()})
        state = rb.add(state, **{k: torch.tensor(v) for k, v in tr.items()})
    return jrb, jstate, rb, state


def _assert_batches_equal(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("horizon", [1, 3])
def test_offline_replay_buffer_dataset_batches_match_jax(horizon):
    jrb, jstate, rb, state = _buffers(128, 64, horizon)
    jds = JaxOfflineDataset(jrb, jstate, lambda d: d, batch_size=16, num_batches=4,
                            rng=jax.random.PRNGKey(1))
    want = list(jds)
    ds = OfflineReplayBufferDataset(rb, state, lambda d: d, batch_size=16, num_batches=4,
                                    indices=[torch.tensor(np.asarray(b["indices"])[:, 0])
                                             for b in want])
    got = list(ds)
    assert len(ds) == len(got) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_batches_equal(g, w, f"batch {i}")
    # without indices, the generator's draws: valid indices only
    drawn = list(OfflineReplayBufferDataset(rb, state, lambda d: d, 16, 2,
                                            generator=torch.Generator().manual_seed(0)))
    assert all(bool(state.is_valid[b["indices"][:, 0].long()].all()) for b in drawn)


def test_replay_buffer_dataset_batches_match_jax():
    """OpenGridworld (deterministic) with a deterministic policy of the
    observation: the same transitions go in, and with JAX's sampled indices
    the same batches come out, in order, over three episodes."""
    def jax_act(params, obs, r):
        return (jnp.argmax(obs[:3]) + jnp.argmax(obs[3:]) + params) % 4

    def act(params, obs, g):
        return ((torch.argmax(obs[:3]) + torch.argmax(obs[3:]) + params) % 4).to(torch.int32)

    jenv, env = JaxOpenGridworld(max_steps=7), OpenGridworld(max_steps=7, device="cpu")
    ex = dict(observation=np.zeros(6, np.float32), action=np.int32(0), reward=np.float32(0),
              terminal=np.bool_(False))
    jrb = JaxReplayBuffer(replay_capacity=64, update_horizon=1, gamma=0.9)
    rb = ReplayBuffer(replay_capacity=64, update_horizon=1, gamma=0.9, device="cpu")
    jds = JaxReplayBufferDataset(
        jenv, jax_act, 1, jrb, jrb.init(**{k: jnp.asarray(v) for k, v in ex.items()}),
        lambda d: d, training_frequency=2, num_episodes=3, batch_size=8,
        rng=jax.random.PRNGKey(4))
    want = list(jds)
    ds = ReplayBufferDataset(
        env, act, 1, rb, rb.init(**{k: torch.tensor(v) for k, v in ex.items()}), lambda d: d,
        training_frequency=2, num_episodes=3, batch_size=8,
        indices=[torch.tensor(np.asarray(b["indices"])[:, 0]) for b in want])
    got = list(ds)
    assert len(got) == len(want) >= 5
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_batches_equal(g, w, f"batch {i}")
    assert int(ds.rb_state.add_count) == int(jds.rb_state.add_count)


def test_episodic_dataset_matches_jax():
    """CartPole episodes padded to 40 steps, softmax acting, fed JAX's draws
    (``collect_episode``'s key splits)."""
    from test_torch_policy_gradient import jax_episode_noise

    jnet, jparams, net, params = _q_nets(3, state_dim=4)
    key = jax.random.PRNGKey(8)
    jds = JaxEpisodicDataset(JaxCartPole(max_steps=40), jnet.apply, jparams, JaxSoftmax(1.0),
                             num_episodes=3, max_steps=40, rng=key)
    want = list(jds)
    keys, k = [], key
    for _ in range(3):
        k, r = jax.random.split(k)
        keys.append(r)
    ds = EpisodicDataset(CartPole(max_steps=40, device="cpu"), discrete_q_scorer(net), params,
                         SoftmaxActionSampler(1.0), num_episodes=3, max_steps=40,
                         noises=[jax_episode_noise(r, 40, 2) for r in keys])
    got = list(ds)
    assert len(ds) == len(got) == 3
    for (ep, ret), (jep, jret) in zip(got, want):
        np.testing.assert_array_equal(ep.action.numpy(), np.asarray(jep.action))
        np.testing.assert_array_equal(ep.valid_mask.numpy(), np.asarray(jep.valid_mask))
        np.testing.assert_allclose(ep.state.float_features.numpy(),
                                   np.asarray(jep.state.float_features), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ep.log_prob.numpy(), np.asarray(jep.log_prob), rtol=1e-5,
                                   atol=1e-6)
        assert float(ret) == float(jret)


@pytest.mark.parametrize("make", [
    lambda pkg: (CartPole(device="cpu") if pkg == "torch" else JaxCartPole()),
    lambda pkg: (Pendulum(device="cpu") if pkg == "torch" else JaxPendulum()),
    lambda pkg: gymnasium.make("CartPole-v1"),
    lambda pkg: gymnasium.make("Pendulum-v1"),
], ids=["functional-discrete", "functional-continuous", "gym-discrete", "gym-box"])
def test_build_normalizer_matches_jax(make):
    got, want = utils.build_normalizer(make("torch")), jutils.build_normalizer(make("jax"))
    assert set(got) == set(want)
    for key in want:
        g, w = (x[key].dense_normalization_parameters for x in (got, want))
        assert {k: dataclasses.asdict(v) for k, v in g.items()} == \
            {k: dataclasses.asdict(v) for k, v in w.items()}
    explicit = type("E", (), {"normalization_data": {"x": 1}})()
    assert utils.build_normalizer(explicit) == {"x": 1}


@pytest.mark.parametrize("discrete", [True, False])
def test_create_df_from_replay_buffer_matches_jax(discrete):
    jrb, jstate, rb, state = _buffers(32, 45)  # wrapped past the capacity
    got = utils.create_df_from_replay_buffer(rb, state, discrete_action=discrete)
    want = jutils.create_df_from_replay_buffer(jrb, jstate, discrete_action=discrete)
    assert isinstance(got, pd.DataFrame) and list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got, want)
