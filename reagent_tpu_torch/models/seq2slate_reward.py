"""Slate reward models: the reward of a (state, ranked slate).

Port of ``reagent_tpu/models/seq2slate_reward.py`` (``Seq2SlateGRURewardNet``
:23, ``Seq2SlateTransformerRewardNet`` :45, ``Seq2SlateRewardNetEnsemble``
:70; reference reagent/models/seq2slate_reward.py:75, :201, :401).  The
"GRU" net runs an LSTM, as JAX's (``nn.RNN(nn.OptimizedLSTMCell)``): each
layer the written-out cell of the MDN-RNN (``models/mdn_rnn.py``) from the
carry (c, h) = (0, the state's embedding).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.mdn_rnn import LSTMLayer, _lecun_normal_fill
from reagent_tpu_torch.models.seq2slate import (
    Embedder,
    EncoderLayer,
    PositionalEncoding,
    _reset_block,
)

Tensor = torch.Tensor


def _lecun_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax's default ``nn.Dense`` init: lecun-normal kernel, zero bias."""
    kernel = torch.empty((layer.in_features, layer.out_features))
    _lecun_normal_fill(kernel, generator)
    with torch.no_grad():
        layer.weight.copy_(kernel.T)
        layer.bias.zero_()


class Seq2SlateGRURewardNet(nn.Module):
    """A recurrent slate-reward net (reference :75-200): ``tgt_out_seq``
    [B, T, C] in ranked order -> the predicted slate reward [B, 1]."""

    def __init__(self, state_dim: int, candidate_dim: int, num_hiddens: int = 64,
                 num_layers: int = 1, generator=None):
        super().__init__()
        self.num_hiddens = num_hiddens
        self.state_embed = nn.Linear(state_dim, num_hiddens)
        self.layers = nn.ModuleList(
            LSTMLayer(candidate_dim if i == 0 else num_hiddens, num_hiddens)
            for i in range(num_layers))
        self.head = nn.Linear(num_hiddens, 1)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_linear_(self.state_embed, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        _lecun_linear_(self.head, generator)

    def forward(self, input: rlt.PreprocessedRankingInput) -> Tensor:
        state = input.state.float_features
        slate = input.tgt_out_seq.float_features
        B = slate.shape[0]
        state_embed = self.state_embed(state)
        h = slate.transpose(0, 1)  # time-major [T, B, C]
        for layer in self.layers:
            carry = (torch.zeros((B, self.num_hiddens), dtype=h.dtype, device=h.device),
                     state_embed)
            _, h = layer(h, carry)
        return self.head(h[-1])


class Seq2SlateTransformerRewardNet(nn.Module):
    """A transformer slate-reward net (reference :201-364): the state's and
    the items' embeddings with positions, the encoder layers, the mean over
    the slate, a linear head."""

    def __init__(self, state_dim: int, candidate_dim: int, num_stacked_layers: int = 2,
                 num_heads: int = 2, dim_model: int = 64, dim_feedforward: int = 32,
                 generator=None):
        super().__init__()
        sed = dim_model // 2
        self.candidate_embedder = Embedder(candidate_dim, dim_model - sed)
        self.state_embedder = Embedder(state_dim, sed)
        self.positional_encoding = PositionalEncoding()
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(dim_model, num_heads, dim_feedforward)
            for _ in range(num_stacked_layers))
        self.head = nn.Linear(dim_model, 1)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in (self.candidate_embedder, self.state_embedder, *self.encoder_layers):
            _reset_block(module, generator)
        _lecun_linear_(self.head, generator)

    def forward(self, input: rlt.PreprocessedRankingInput) -> Tensor:
        state = input.state.float_features
        slate = input.tgt_out_seq.float_features
        B, T, _ = slate.shape
        cand = self.candidate_embedder(slate)
        st = self.state_embedder(state)
        st = st[:, None, :].expand(B, T, st.shape[-1])
        x = self.positional_encoding(torch.cat([st, cand], dim=2))
        for layer in self.encoder_layers:
            x = layer(x)
        return self.head(x.mean(dim=1))


class Seq2SlateRewardNetEnsemble:
    """The mean of the members' predictions (reference :401-430): one module
    run on each parameter dict."""

    def __init__(self, net: nn.Module, params_list: Sequence):
        self.net = net
        self.params_list = list(params_list)

    def __call__(self, input: rlt.PreprocessedRankingInput) -> Tensor:
        from reagent_tpu_torch.training import functional

        preds = [functional.apply(self.net, p, input) for p in self.params_list]
        return torch.stack(preds).mean(dim=0)
