"""Categorical (C51) distributional Q-network.

Port of ``reagent_tpu/models/categorical_dqn.py`` (reference:
reagent/models/categorical_dqn.py:12): an MLP emitting ``[B, action_dim,
num_atoms]`` logits; Q = sum(softmax(logits) * support).  ``net`` is the
JAX module's flax scope ``FullyConnectedNetwork_0``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA computes it in a
    compiled step (the C51 trainer's): with ``r = 1 / (num - 1)`` rounded to
    float32 and ``i = 0 .. num - 2``, ``start * (1 - i * r) + i * (stop * r)``,
    then ``stop`` (XLA turns the division into a product by ``r`` and
    reassociates ``stop * (i * r)``).  Each operation is one float32 rounding,
    none contracted; ``torch.linspace`` rounds the interior points otherwise."""
    f32 = torch.float32
    start_t, stop_t = torch.tensor(start, dtype=f32), torch.tensor(stop, dtype=f32)
    if num == 1:
        return start_t.reshape(1)
    r = torch.tensor(1.0, dtype=f32) / torch.tensor(num - 1, dtype=f32)
    i = torch.arange(num - 1, dtype=f32)
    head = start_t * (1.0 - i * r) + i * (stop_t * r)
    return torch.cat([head, stop_t.reshape(1)])


class CategoricalDQN(nn.Module):
    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        num_atoms: int,
        qmin: float,
        qmax: float,
        sizes: Sequence[int],
        activations: Sequence[str],
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.num_atoms = num_atoms
        self.qmin = qmin
        self.qmax = qmax
        self.sizes = list(sizes)
        self.net = FullyConnectedNetwork(
            [state_dim, *sizes, action_dim * num_atoms], [*activations, "linear"],
            generator=generator)
        # not in the state dict: rebuilt from qmin, qmax, num_atoms
        self.register_buffer("support", linspace_f32(qmin, qmax, num_atoms), persistent=False)

    @property
    def activations(self) -> List[str]:
        """Per-layer activation names, the logits' "linear" included."""
        return self.net.activations

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def log_dist_of_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, action_dim * num_atoms] logits -> log-probabilities over atoms
        [B, action_dim, num_atoms]."""
        return torch.log_softmax(
            logits.reshape(logits.shape[0], self.action_dim, self.num_atoms), dim=2)

    def q_of_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """E[Z] per action, [B, action_dim]."""
        return torch.sum(torch.exp(self.log_dist_of_logits(logits)) * self.support, dim=2)

    def log_dist(self, state: torch.Tensor) -> torch.Tensor:
        """Log-probabilities over atoms: [B, action_dim, num_atoms]."""
        return self.log_dist_of_logits(self.net(state))

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        """Q-values [B, action_dim]: the mean of each action's distribution."""
        return self.q_of_logits(self.net(state))
