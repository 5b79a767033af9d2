"""Dueling Q-network.

Port of ``reagent_tpu/models/dueling_q_network.py::DuelingQNetwork`` (:18-51;
reference: reagent/models/dueling_q_network.py:21): a shared backbone with
separate advantage and value heads, ``Q = V + A - mean(A)``, optionally one
value per quantile atom; and of ``ParametricDuelingQNetwork`` (:54), Q(s, a)
for feature-vector actions.

``DuelingQNetwork``'s ``shared``, ``advantage`` and ``value`` are the JAX
module's flax scopes ``FullyConnectedNetwork_0``, ``_1`` and ``_2``, in that
order; ``ParametricDuelingQNetwork``'s ``state_emb``, ``value`` and
``advantage`` are its ``_0``, ``_1`` and ``_2`` (``utils/interop.py``
carries weights across by these mappings).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork


class DuelingQNetwork(nn.Module):
    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        layers: Sequence[int],
        activations: Sequence[str],
        num_atoms: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.num_atoms = num_atoms
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        embedding_dim = layers[-1]
        half = embedding_dim // 2
        head_acts = [activations[-1], "linear"]
        self.shared = FullyConnectedNetwork(
            [state_dim, *layers], list(activations), generator=generator)
        self.advantage = FullyConnectedNetwork(
            [embedding_dim, half, action_dim * num_atoms], head_acts, generator=generator)
        self.value = FullyConnectedNetwork(
            [embedding_dim, half, num_atoms], head_acts, generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for net in (self.shared, self.advantage, self.value):
            net.reset_parameters(generator)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        """state [B, state_dim] -> Q [B, action_dim], or [B, action_dim,
        num_atoms] when ``num_atoms > 1``."""
        shared = self.shared(state)
        adv = self.advantage(shared)
        val = self.value(shared)
        B = state.shape[0]
        if self.num_atoms > 1:
            adv = adv.reshape(B, self.action_dim, self.num_atoms)
            val = val.reshape(B, 1, self.num_atoms)
        q = val + adv - adv.mean(dim=1, keepdim=True)
        if self.num_atoms == 1:
            q = q.reshape(B, self.action_dim)
        return q


class ParametricDuelingQNetwork(nn.Module):
    """Q(s, a) for feature-vector actions: a state embedding, a value head on
    it and an advantage head on ``cat([embedding, action])``; Q = V + A,
    ``[B, 1]``."""

    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        layers: Sequence[int],
        activations: Sequence[str],
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim = state_dim
        self.action_dim = action_dim
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        embedding_dim = layers[-1]
        half = embedding_dim // 2
        head_acts = [activations[-1], "linear"]
        self.state_emb = FullyConnectedNetwork(
            [state_dim, *layers], list(activations), generator=generator)
        self.value = FullyConnectedNetwork([embedding_dim, half, 1], head_acts,
                                           generator=generator)
        self.advantage = FullyConnectedNetwork(
            [embedding_dim + action_dim, half, 1], head_acts, generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for net in (self.state_emb, self.value, self.advantage):
            net.reset_parameters(generator)

    def forward(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """state [B, state_dim], action [B, action_dim] -> Q [B, 1]."""
        state_emb = self.state_emb(state)
        val = self.value(state_emb)
        adv = self.advantage(torch.cat([state_emb, action], dim=1))
        return val + adv
