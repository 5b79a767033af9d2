"""Configurable MLP backbone.

Port of ``reagent_tpu/models/fully_connected_network.py``: ``nn.Linear``
layers with per-layer activations, the reference's gaussian-fill-w-gain init
(:28) or an orthogonal one, and the options of the JAX module, per layer
``i`` in its order (:57-85): batch norm on the layer's input, the Dense,
layer norm (not on the last layer unless ``normalize_output``), the
activation, dropout (not on the last layer), then ``h + h_in`` where
``use_skip_connections`` is set and the widths match.

``compute_dtype`` (:49-50, :74) is the matmul compute type: parameters stay
float32, and each layer casts its input, weight and bias to
``compute_dtype`` and returns that type, as flax's ``nn.Dense(dtype=...)``
does; a norm computes in float32 and returns float32, as flax's promote.

The JAX trainers keep the whole flax variables dict, ``batch_stats``
included, as their parameters and never pass ``training=True``, so the
batch norm's running mean and variance are normalised with, differentiated
through, stepped by the optimizer and blended by the soft update.  Here they
are ``nn.Parameter``s (``BatchNorm.mean``, ``.var``) for the same reason.
``forward(x, training)`` follows flax's flag and ignores ``self.training``:
with ``training=True`` the batch norm normalises with the batch's statistics
and moves its running averages in place (momentum 0.99, the biased
variance, as flax's ``mutable=["batch_stats"]``), and dropout keeps a unit
with probability ``1 - dropout_ratio`` (masks fed, or drawn from a
``torch.Generator``) and scales it by ``1 / (1 - dropout_ratio)``.  The
Linear layers stay at ``layers.{i}`` and the norms sit in the sibling lists
``batch_norms`` and ``layer_norms``, so a dense net keeps every name K1-K3
and the interop read.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = ("relu", "leaky_relu", "tanh", "sigmoid", "softplus", "linear")
BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm's epsilon
BATCH_NORM_MOMENTUM = 0.99  # flax nn.BatchNorm's momentum
LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def apply_activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """The JAX module's activations (leaky slope 0.01, as flax's
    ``nn.leaky_relu``; softplus as flax's ``logaddexp(x, 0)``)."""
    if name == "relu":
        return F.relu(x)
    if name == "leaky_relu":
        return F.leaky_relu(x, 0.01)
    if name == "tanh":
        return torch.tanh(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "softplus":
        return torch.logaddexp(x, torch.zeros_like(x))
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


def orthogonal_fill(weight: torch.Tensor, gain: float, generator: torch.Generator) -> None:
    """An orthogonal ``[out, in]`` weight times ``gain`` in place (flax's
    ``orthogonal(scale=gain)`` on the ``[in, out]`` kernel): the QR of a
    gaussian draw, signs fixed by R's diagonal."""
    rows, cols = weight.shape
    draw = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                       dtype=torch.float32)
    q, r = torch.linalg.qr(draw)
    q = q * torch.sign(torch.diagonal(r))
    with torch.no_grad():
        weight.copy_((q if rows >= cols else q.T) * gain)


def _stats(x: torch.Tensor, dims):
    """flax's ``_compute_stats`` with its fast variance: E[x^2] - E[x]^2,
    clipped at 0, in float32."""
    mean = x.mean(dim=dims)
    var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    return mean, var


def _normalize(x, mean, var, scale, bias, eps):
    """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over every axis but the last (a ``[B, A, D]``
    input normalises over B and A), eps 1e-5, momentum 0.99.  ``mean`` and
    ``var`` (flax's ``batch_stats``) are parameters: see the module
    docstring."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            for p, v in ((self.scale, 1.0), (self.bias, 0.0), (self.mean, 0.0), (self.var, 1.0)):
                p.fill_(v)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        x = x.to(torch.float32)
        if not training:
            return _normalize(x, self.mean, self.var, self.scale, self.bias, BATCH_NORM_EPS)
        mean, var = _stats(x, tuple(range(x.ndim - 1)))
        with torch.no_grad():
            m = BATCH_NORM_MOMENTUM
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return _normalize(x, mean, var, self.scale, self.bias, BATCH_NORM_EPS)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: eps 1e-6, scale and bias,
    the fast variance."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean, var = _stats(x, -1)
        return _normalize(x, mean[..., None], var[..., None], self.scale, self.bias,
                          LAYER_NORM_EPS)


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
        normalize_output: bool = False,
        orthogonal_init: bool = False,
        use_skip_connections: bool = False,
        generator: Optional[torch.Generator] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        if len(sizes) - 1 != len(activations):
            raise ValueError(f"sizes {list(sizes)} vs activations {list(activations)}")
        for a in activations:
            apply_activation(a, torch.zeros(()))  # reject unknown names early
        self.sizes: List[int] = list(sizes)
        self.activations: List[str] = list(activations)
        self.dropout_ratio = float(dropout_ratio)
        self.orthogonal_init = bool(orthogonal_init)
        self.use_skip_connections = bool(use_skip_connections)
        n = len(sizes) - 1
        self.layers = nn.ModuleList(nn.Linear(sizes[i], sizes[i + 1]) for i in range(n))
        # batch norm on each layer's input; layer norm on each layer's output
        # but the last's, unless normalize_output
        self.batch_norms = (nn.ModuleList(BatchNorm(sizes[i]) for i in range(n))
                            if use_batch_norm else None)
        self.layer_norms = (
            nn.ModuleList(LayerNorm(sizes[i + 1]) for i in range(n if normalize_output else n - 1))
            if use_layer_norm else None)
        self.reset_parameters(
            generator if generator is not None else torch.Generator().manual_seed(0)
        )

    @property
    def has_skip_connections(self) -> bool:
        """Whether a skip connection fires: some layer keeps its width."""
        return self.use_skip_connections and any(
            a == b for a, b in zip(self.sizes[:-1], self.sizes[1:]))

    @property
    def is_dense(self) -> bool:
        """Whether the net is the plain chain of Linear layers and
        activations that K1-K3 compute: no norm and no skip connection
        (dropout never fires outside ``training=True``)."""
        return (self.batch_norms is None and self.layer_norms is None
                and not self.has_skip_connections)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Gaussian-fill weights (gain sqrt(2) for relu), or orthogonal ones
        of gain sqrt(2), zero biases, fresh norms — the JAX module's init,
        drawn from ``generator``."""
        for layer, act in zip(self.layers, self.activations):
            if self.orthogonal_init:
                orthogonal_fill(layer.weight, math.sqrt(2.0), generator)
            else:
                gain = math.sqrt(2.0) if act == "relu" else 1.0
                gaussian_fill_w_gain(layer.weight, gain, generator)
            with torch.no_grad():
                layer.bias.zero_()
        for norms in (self.batch_norms, self.layer_norms):
            for norm in norms or ():
                norm.reset_parameters()

    def forward(
        self, x: torch.Tensor, training: bool = False,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``dropout_masks``: one keep mask (bool, the hidden layer's shape)
        per layer but the last, used with ``training=True``; drawn from
        ``generator`` where not given."""
        cd = self.compute_dtype
        n = len(self.layers)
        keep = 1.0 - self.dropout_ratio
        for i, (layer, act) in enumerate(zip(self.layers, self.activations)):
            h_in = x
            if self.batch_norms is not None:
                x = self.batch_norms[i](x, training)
            if cd == torch.float32:
                x = layer(x)
            else:
                # the product, then the bias, each rounded to compute_dtype
                x = F.linear(x.to(cd), layer.weight.to(cd)) + layer.bias.to(cd)
            if self.layer_norms is not None and i < len(self.layer_norms):
                x = self.layer_norms[i](x)
            x = apply_activation(act, x)
            if training and self.dropout_ratio > 0.0 and i < n - 1:
                if dropout_masks is not None:
                    mask = dropout_masks[i]
                else:
                    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
            if self.use_skip_connections and h_in.shape[-1] == x.shape[-1]:
                x = x + h_in
        return x


class FloatFeatureFullyConnected(nn.Module):
    """An MLP from ``state_dim`` dense features to ``output_dim``
    (``reagent_tpu/models/fully_connected_network.py:88``): the hidden
    ``sizes`` with their activations, then ``final_activation``."""

    def __init__(
        self,
        state_dim: int,
        output_dim: int,
        sizes: Sequence[int],
        activations: Sequence[str],
        use_batch_norm: bool = False,
        dropout_ratio: float = 0.0,
        use_layer_norm: bool = False,
        final_activation: str = "linear",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.net = FullyConnectedNetwork(
            [state_dim, *sizes, output_dim], [*activations, final_activation],
            use_batch_norm=use_batch_norm, dropout_ratio=dropout_ratio,
            use_layer_norm=use_layer_norm, generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        return self.net(x, training=training)


class ResidualWrapper(nn.Module):
    """``x + module(x)`` (reference models/residual_wrapper.py:6-22)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return x + self.module(x, *args, **kwargs)


class Sequential(nn.Module):
    """A chain of modules, each called on the previous one's output alone
    (reference models/containers.py ``Sequential``)."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, *args, **kwargs):
        for layer in self.layers:
            x = layer(x)
        return x
