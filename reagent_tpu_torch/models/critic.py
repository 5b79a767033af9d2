"""Parametric-action critic Q(s, a).

Port of ``reagent_tpu/models/critic.py:16`` (reference:
reagent/models/critic.py:37 ``FullyConnectedCritic``): state and action
concatenated, then an MLP, with the network's batch norm and layer norm.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork


class FullyConnectedCritic(nn.Module):
    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        sizes: Sequence[int],
        activations: Sequence[str],
        use_batch_norm: bool = False,
        use_layer_norm: bool = False,
        output_dim: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.net = FullyConnectedNetwork(
            [state_dim + action_dim, *sizes, output_dim],
            [*activations, "linear"],
            use_batch_norm=use_batch_norm,
            use_layer_norm=use_layer_norm,
            generator=generator,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, state: torch.Tensor, action: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        """state [B, state_dim], action [B, action_dim] -> Q [B, output_dim]."""
        return self.net(torch.cat([state, action], dim=1), training=training)
