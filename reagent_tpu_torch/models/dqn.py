"""Discrete-action Q-network.

Port of ``reagent_tpu/models/dqn.py`` (reference: reagent/models/dqn.py:16
``FullyConnectedDQN``): an MLP emitting one Q-value per action.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork


class FullyConnectedDQN(nn.Module):
    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        sizes: Sequence[int],
        activations: Sequence[str],
        use_batch_norm: bool = False,
        dropout_ratio: float = 0.0,
        use_layer_norm: bool = False,
        use_skip_connections: bool = False,
        generator: Optional[torch.Generator] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.net = FullyConnectedNetwork(
            [state_dim, *sizes, action_dim],
            [*activations, "linear"],
            use_batch_norm=use_batch_norm,
            dropout_ratio=dropout_ratio,
            use_layer_norm=use_layer_norm,
            use_skip_connections=use_skip_connections,
            generator=generator,
            compute_dtype=compute_dtype,
        )

    @property
    def activations(self) -> List[str]:
        """Per-layer activation names, output layer ("linear") included."""
        return self.net.activations

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, state: torch.Tensor, training: bool = False) -> torch.Tensor:
        """state [B, state_dim] -> Q [B, action_dim]."""
        return self.net(state, training=training)
