"""Plain FCN contextual-bandit scorer.

Port of ``reagent_tpu/models/cb_fully_connected_network.py`` (reference
reagent/models/cb_fully_connected_network.py:17-80): it outputs
``{pred_label, pred_sigma, ucb}`` as the LinUCB family does, with zero
predicted uncertainty (``ucb == pred_label``); the supervised baseline of the
CB trainers.  The network is the port's ``FullyConnectedNetwork`` at
``net`` (flax's ``FullyConnectedNetwork_0``), whose skip connections and
layer norm follow the JAX module's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork


class CBFullyConnectedNetwork(nn.Module):
    def __init__(
        self,
        input_dim: int,
        hidden_layer_dims: Sequence[int],
        activation: str = "relu",
        output_activation: str = "linear",
        use_layer_norm: bool = False,
        use_skip_connections: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.net = FullyConnectedNetwork(
            [input_dim, *hidden_layer_dims, 1],
            [activation] * len(hidden_layer_dims) + [output_activation],
            use_layer_norm=use_layer_norm, use_skip_connections=use_skip_connections,
            generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[..., input_dim] features -> {pred_label, pred_sigma, ucb} [...]."""
        pred = self.net(x).squeeze(-1)
        return {"pred_label": pred, "pred_sigma": torch.zeros_like(pred), "ucb": pred}
