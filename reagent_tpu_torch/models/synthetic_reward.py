"""Synthetic-reward networks: an aggregate (episode) reward split into
per-step rewards.

Port of ``reagent_tpu/models/synthetic_reward.py``
(``SyntheticRewardNetworkOutput`` :24, ``_gen_mask`` :30,
``SingleStepSyntheticRewardNet`` :37, ``NGramFullyConnectedNetwork`` :58,
``NGramConvolutionalNetwork`` :88, ``SequenceSyntheticRewardNet`` :135,
``TransformerSyntheticRewardNet`` :156, ``SyntheticRewardNet`` :184;
reference reagent/models/synthetic_reward.py).  Every net maps time-major
state and action ``[T, B, ·]`` to per-step rewards ``[B, T]``;
``SyntheticRewardNet`` sums each row's last ``valid_step`` of them.

Flax's ``nn.Conv`` is NHWC with ``[kh, kw, in, out]`` kernels; the n-gram
conv net runs ``nn.Conv2d`` on NCHW windows and flattens its features in
NHWC order, as JAX's MLP head reads them.  The transformer is the post-LN
encoder layer of the ranking models (``models/seq2slate.py``: flax's
attention, which scales the query; layer norms at eps 1e-6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.fully_connected_network import (
    FullyConnectedNetwork,
    apply_activation,
)
from reagent_tpu_torch.models.mdn_rnn import LSTMLayer, _lecun_normal_fill
from reagent_tpu_torch.models.seq2slate import EncoderLayer, _reset_block
from reagent_tpu_torch.models.seq2slate_reward import _lecun_linear_

Tensor = torch.Tensor


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class SyntheticRewardNetworkOutput(NamedTuple):
    predicted_reward: Tensor  # [B, 1]
    mask: Tensor  # [B, T]
    output: Tensor  # [B, T] per-step rewards


def gen_mask(valid_step: Tensor, batch_size: int, seq_len: int) -> Tensor:
    """``mask[b, t] = 1`` for the last ``valid_step[b]`` positions (ref
    :200-226)."""
    col = torch.arange(seq_len, device=valid_step.device)[None, :]
    return (col >= seq_len - valid_step.reshape(-1, 1)).to(torch.float32)


def _windows(x: Tensor, context_size: int) -> Tensor:
    """[T, B, D] -> [T, B, context_size, D]: each step's window of
    ``context_size`` steps centred on it, zero-padded at both ends."""
    T, B, D = x.shape
    pad = torch.zeros((context_size // 2, B, D), dtype=x.dtype, device=x.device)
    padded = torch.cat([pad, x, pad], dim=0)
    return torch.stack([padded[i:i + T] for i in range(context_size)], dim=2)


class SingleStepSyntheticRewardNet(nn.Module):
    """Per-step reward from ``cat(state, action)`` through an MLP (ref :275)."""

    def __init__(self, state_dim: int, action_dim: int, sizes: Sequence[int],
                 activations: Sequence[str], last_layer_activation: str = "linear",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = FullyConnectedNetwork([state_dim + action_dim, *sizes, 1],
                                         [*activations, last_layer_activation],
                                         generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, state: Tensor, action: Tensor) -> Tensor:
        return self.net(torch.cat([state, action], dim=-1))[..., 0].T


class NGramFullyConnectedNetwork(nn.Module):
    """Per-step reward from the window of ``context_size`` steps around it
    (ref :373)."""

    def __init__(self, state_dim: int, action_dim: int, sizes: Sequence[int],
                 activations: Sequence[str], context_size: int = 3,
                 last_layer_activation: str = "linear",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.context_size = context_size
        self.net = FullyConnectedNetwork(
            [context_size * (state_dim + action_dim), *sizes, 1],
            [*activations, last_layer_activation], generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, state: Tensor, action: Tensor) -> Tensor:
        T, B = state.shape[0], state.shape[1]
        windows = _windows(torch.cat([state, action], dim=-1), self.context_size)
        return self.net(windows.reshape(T, B, -1))[..., 0].T


class NGramConvolutionalNetwork(nn.Module):
    """Per-step reward from a conv stack over each step's window (ref
    :311-370): the window ``[context_size, D]`` is a one-channel image; the
    first layer's kernel spans the whole feature axis, later ones are one
    wide; relu after each, then an MLP head on the flattened features."""

    def __init__(self, state_dim: int, action_dim: int, sizes: Sequence[int],
                 activations: Sequence[str], context_size: int = 3,
                 conv_dims: Sequence[int] = (32,), conv_height_kernels: Sequence[int] = (2,),
                 last_layer_activation: str = "linear",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if context_size % 2 != 1:
            raise ValueError(f"context_size must be odd, got {context_size}")
        self.context_size = context_size
        D = state_dim + action_dim
        ins = [1, *conv_dims[:-1]]
        self.convs = nn.ModuleList(
            nn.Conv2d(c_in, c_out, kernel_size=(kh, D if i == 0 else 1))
            for i, (c_in, c_out, kh) in enumerate(zip(ins, conv_dims, conv_height_kernels)))
        height = context_size - sum(kh - 1 for kh in conv_height_kernels[:len(conv_dims)])
        self.net = FullyConnectedNetwork([height * conv_dims[-1], *sizes, 1],
                                         [*activations, last_layer_activation],
                                         generator=generator)
        self.reset_parameters(_generator(generator))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: lecun-normal conv kernels, zero biases."""
        for conv in self.convs:
            kernel = torch.empty(conv.weight.shape[1:].numel(), conv.weight.shape[0])
            _lecun_normal_fill(kernel, generator)
            with torch.no_grad():
                conv.weight.copy_(kernel.T.reshape(conv.weight.shape))
                conv.bias.zero_()
        self.net.reset_parameters(generator)

    def forward(self, state: Tensor, action: Tensor) -> Tensor:
        T, B = state.shape[0], state.shape[1]
        windows = _windows(torch.cat([state, action], dim=-1), self.context_size)
        h = windows.reshape(T * B, 1, self.context_size, -1)  # NCHW
        for conv in self.convs:
            h = torch.relu(conv(h))
        h = h.permute(0, 2, 3, 1).reshape(T * B, -1)  # flattened in NHWC order
        return self.net(h).reshape(T, B).T


class SequenceSyntheticRewardNet(nn.Module):
    """An LSTM over the sequence from a zero carry, then a linear head (ref
    :420)."""

    def __init__(self, state_dim: int, action_dim: int, lstm_hidden_size: int = 64,
                 lstm_num_layers: int = 1, last_layer_activation: str = "linear",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.last_layer_activation = last_layer_activation
        self.layers = nn.ModuleList(
            LSTMLayer(state_dim + action_dim if i == 0 else lstm_hidden_size, lstm_hidden_size)
            for i in range(lstm_num_layers))
        self.head = nn.Linear(lstm_hidden_size, 1)
        self.reset_parameters(_generator(generator))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)
        _lecun_linear_(self.head, generator)

    def forward(self, state: Tensor, action: Tensor) -> Tensor:
        h = torch.cat([state, action], dim=-1)  # time-major [T, B, D]
        for layer in self.layers:
            _, h = layer(h)
        return apply_activation(self.last_layer_activation, self.head(h)[..., 0].T)


class TransformerSyntheticRewardNet(nn.Module):
    """Self-attention over the sequence (ref :470): a linear embedding, then
    ``num_encoder_layers`` post-LN encoder layers, then a linear head."""

    def __init__(self, state_dim: int, action_dim: int, d_model: int = 64, nhead: int = 2,
                 num_encoder_layers: int = 2, dim_feedforward: int = 128,
                 last_layer_activation: str = "linear",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.last_layer_activation = last_layer_activation
        self.embed = nn.Linear(state_dim + action_dim, d_model)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward) for _ in range(num_encoder_layers))
        self.head = nn.Linear(d_model, 1)
        self.reset_parameters(_generator(generator))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_linear_(self.embed, generator)
        for layer in self.encoder_layers:
            _reset_block(layer, generator)
        _lecun_linear_(self.head, generator)

    def forward(self, state: Tensor, action: Tensor) -> Tensor:
        h = self.embed(torch.cat([state, action], dim=-1).transpose(0, 1))  # [B, T, d]
        for layer in self.encoder_layers:
            h = layer(h)
        return apply_activation(self.last_layer_activation, self.head(h)[..., 0])


class SyntheticRewardNet(nn.Module):
    """Masks each row to its last valid steps and sums them to the
    aggregate (ref :229)."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, batch: rlt.MemoryNetworkInput) -> SyntheticRewardNetworkOutput:
        state = batch.state.float_features
        action = batch.action.float_features
        T, B = action.shape[0], action.shape[1]
        output = self.net(state, action)  # [B, T]
        mask = gen_mask(batch.valid_step, B, T)
        pred = torch.sum(output * mask, dim=1, keepdim=True)
        return SyntheticRewardNetworkOutput(predicted_reward=pred, mask=mask, output=output)

