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
