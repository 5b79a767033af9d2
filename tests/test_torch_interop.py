"""Weights carried between reagent_tpu's flax layout and the port's modules."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.models import FullyConnectedDQN as JaxFullyConnectedDQN
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.utils.interop import (
    flax_from_q_network_state,
    q_network_state_from_flax,
)


def _flax_params(state_dim, action_dim, sizes, acts, seed=0):
    net = JaxFullyConnectedDQN(
        state_dim=state_dim, action_dim=action_dim, sizes=sizes, activations=acts)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, state_dim)))
    return net, jax.tree_util.tree_map(np.asarray, params)


def test_flax_round_trip_is_exact():
    _, params = _flax_params(6, 3, [16, 8], ["relu", "relu"])
    back = flax_from_q_network_state(q_network_state_from_flax(params))
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh"])
def test_forward_parity_with_flax(act):
    jnet, params = _flax_params(6, 3, [16, 8], [act, act], seed=1)
    net = FullyConnectedDQN(state_dim=6, action_dim=3, sizes=[16, 8], activations=[act, act])
    net.load_state_dict(q_network_state_from_flax(params))
    x = np.random.default_rng(0).normal(size=(32, 6)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_init_follows_the_gaussian_fill():
    """Weights ~ N(0, gain*sqrt(2/fan_in)) (gain sqrt(2) for relu), zero
    biases, as the JAX module draws them."""
    net = FullyConnectedDQN(
        state_dim=256, action_dim=4, sizes=[512], activations=["relu"],
        generator=torch.Generator().manual_seed(3))
    first, last = net.net.layers[0], net.net.layers[1]
    assert first.weight.std().item() == pytest.approx(math.sqrt(2) * math.sqrt(2 / 256), rel=0.02)
    assert last.weight.std().item() == pytest.approx(math.sqrt(2 / 512), rel=0.1)
    assert not first.bias.any() and not last.bias.any()


class _TanhOutputDQN(FullyConnectedDQN):
    """Claims a linear output layer but squashes it."""

    def forward(self, state):
        return torch.tanh(super().forward(state))


class _MislabelledDQN(FullyConnectedDQN):
    """Runs tanh hidden layers but reports relu."""

    @property
    def activations(self):
        return ["relu", "linear"]


@pytest.mark.parametrize("cls", [_TanhOutputDQN, _MislabelledDQN])
def test_activation_probe_rejects_mismatched_net(cls):
    net = cls(state_dim=5, action_dim=2, sizes=[8], activations=["tanh"])
    trainer = FusedDQNTrainer(q_network=net, minibatch_size=16, device="cpu")
    with pytest.raises(ValueError, match="activation mismatch"):
        trainer.init(torch.Generator().manual_seed(0))


def test_trainer_rejects_nonlinear_output_layer():
    net = FullyConnectedDQN(state_dim=5, action_dim=2, sizes=[8], activations=["relu"])
    net.net.activations[-1] = "tanh"
    with pytest.raises(ValueError, match="linear output layer"):
        FusedDQNTrainer(q_network=net, minibatch_size=16, device="cpu")


def test_replay_states_round_trip():
    """JAX replay states -> numpy -> the port's states -> numpy is exact, and
    the carried packed rows sample like the JAX buffer's."""
    from reagent_tpu.replay import PackedReplayBuffer as JaxPacked
    from reagent_tpu.replay import ReplayBuffer as JaxReplay
    from reagent_tpu_torch.replay import PackedReplayBuffer
    from reagent_tpu_torch.utils.interop import (
        packed_replay_state_from_arrays,
        replay_state_from_arrays,
        state_to_arrays,
    )

    rng = np.random.default_rng(0)
    example = dict(observation=jnp.zeros(3), action=jnp.int32(0),
                   reward=jnp.float32(0), terminal=jnp.bool_(False))
    jp, jr = JaxPacked(replay_capacity=8), JaxReplay(replay_capacity=8, update_horizon=2)
    ps, rs = jp.init(**example), jr.init(**example)
    for i in range(11):
        tr = dict(observation=jnp.asarray(rng.normal(size=3), jnp.float32),
                  action=jnp.int32(i % 2), reward=jnp.float32(i),
                  terminal=jnp.bool_(i % 4 == 3))
        ps, rs = jp.add(ps, **tr), jr.add(rs, **tr)
    leaves = lambda s: jax.tree_util.tree_map(np.asarray, s)

    packed = packed_replay_state_from_arrays(**{
        k: v for k, v in vars(leaves(ps)).items()})
    circ = replay_state_from_arrays(**{k: v for k, v in vars(leaves(rs)).items()})
    for port, jstate in ((packed, ps), (circ, rs)):
        back = state_to_arrays(port)
        want = vars(leaves(jstate))
        assert back.keys() == want.keys()
        for k, v in want.items():
            got = back[k]
            for a, b in (zip(got.values(), v.values()) if isinstance(v, dict) else [(got, v)]):
                assert a.dtype == b.dtype and np.array_equal(a, b), k

    rb = PackedReplayBuffer(replay_capacity=8, device="cpu")
    rb.init(**{k: np.array(v) for k, v in example.items()})
    idx = np.array([0, 5, 7], np.int32)
    got = rb.sample(packed, indices=torch.tensor(idx))
    want = jp.sample(ps, jax.random.PRNGKey(0), 3, indices=jnp.asarray(idx))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
