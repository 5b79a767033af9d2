"""State-value network V(s).

Port of ``reagent_tpu/models/value.py:17`` (reference:
reagent/net_builder/value/fully_connected.py): the value network SAC's
optional value head and continuous CRR use.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork


class ValueNetwork(nn.Module):
    def __init__(
        self,
        state_dim: int,
        sizes: Sequence[int],
        activations: Sequence[str],
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim = state_dim
        self.net = FullyConnectedNetwork(
            [state_dim, *sizes, 1], [*activations, "linear"], generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, state: torch.Tensor, training: bool = False) -> torch.Tensor:
        """state [B, state_dim] -> V [B, 1]."""
        return self.net(state, training=training)
