"""Configurable MLP backbone (plain dense path).

Port of ``reagent_tpu/models/fully_connected_network.py``: ``nn.Linear``
layers with per-layer activations and the reference's gaussian-fill-w-gain
init (:28).  ``compute_dtype`` (:49-50, :74) is the matmul compute type:
parameters stay float32, and each layer casts its input, weight and bias to
``compute_dtype`` and returns that type, as flax's ``nn.Dense(dtype=...)``
does; gradients reach the float32 parameters through the cast.  The
batch-norm, dropout, layer-norm and skip-connection options
of the JAX module are not ported yet (``ROADMAP.md`` §1); asking for one
raises.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = ("relu", "leaky_relu", "tanh", "linear")


def apply_activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """The activation functions the fused kernels implement (leaky slope 0.01,
    as flax's ``nn.leaky_relu``)."""
    if name == "relu":
        return F.relu(x)
    if name == "leaky_relu":
        return F.leaky_relu(x, 0.01)
    if name == "tanh":
        return torch.tanh(x)
    if name in ("linear", "identity"):
        return x
    raise ValueError(f"unsupported activation {name!r}; supported: {ACTIVATIONS}")


def gaussian_fill_w_gain(
    weight: torch.Tensor, gain: float, generator: torch.Generator
) -> None:
    """N(0, gain * sqrt(2/fan_in)) init in place; ``weight`` is [out, in]."""
    std = gain * math.sqrt(2.0 / weight.shape[1])
    with torch.no_grad():
        draw = torch.randn(weight.shape, generator=generator, dtype=weight.dtype)
        weight.copy_(draw * std)


class FullyConnectedNetwork(nn.Module):
    """MLP over the last axis: sizes [in, h1, ..., out], one activation per
    layer (len(sizes) - 1)."""

    def __init__(
        self,
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
        if len(sizes) - 1 != len(activations):
            raise ValueError(f"sizes {list(sizes)} vs activations {list(activations)}")
        if use_batch_norm or dropout_ratio > 0.0 or use_layer_norm or use_skip_connections:
            raise NotImplementedError(
                "batch norm, dropout, layer norm and skip connections are not "
                "ported yet (ROADMAP.md §1 item 3)"
            )
        for a in activations:
            apply_activation(a, torch.zeros(()))  # reject unknown names early
        self.activations: List[str] = list(activations)
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)
        )
        self.reset_parameters(
            generator if generator is not None else torch.Generator().manual_seed(0)
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Gaussian-fill weights (gain sqrt(2) for relu), zero biases — the
        JAX module's init, drawn from ``generator``."""
        for layer, act in zip(self.layers, self.activations):
            gain = math.sqrt(2.0) if act == "relu" else 1.0
            gaussian_fill_w_gain(layer.weight, gain, generator)
            with torch.no_grad():
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        for layer, act in zip(self.layers, self.activations):
            if cd == torch.float32:
                x = layer(x)
            else:
                # the product, then the bias, each rounded to compute_dtype
                x = F.linear(x.to(cd), layer.weight.to(cd)) + layer.bias.to(cd)
            x = apply_activation(act, x)
        return x
