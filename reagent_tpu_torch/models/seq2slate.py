"""Seq2Slate: a pointer-network transformer that re-ranks a slate.

Port of ``reagent_tpu/models/seq2slate.py`` (the mask helpers :59-83,
``Embedder``, ``positional_table``, ``PositionalEncoding``, ``FeedForward``,
``EncoderLayer``, ``CachedSelfAttention`` :156, ``DecoderLayer`` :213,
``PointerLastLayer`` :260, ``Seq2SlateTransformerModel`` :308 and the
``Seq2SlateTransformerNet`` wrapper :579; reference reagent/models/
seq2slate.py, arXiv:1810.02019).  The vocabulary of the reference: 0 is
padding, 1 the decoder's start symbol, candidate i sits at index i + 2.
Three output architectures: AUTOREGRESSIVE (the last decoder layer's masked,
head-averaged attention over the encoder's memory is the pointer
distribution), FRECHET_SORT (a softmax over static encoder scores) and
ENCODER_SCORE (rank by the encoder's scores).

The products and the attention are plain torch operations, as JAX computes
them outside any Pallas kernel, and not ``scaled_dot_product_attention``: a
library kernel sums in its own order and turns a fully masked row into NaN
where JAX's ``finfo.min`` fill gives a uniform one.  Each attention keeps
its JAX form: flax's ``MultiHeadDotProductAttention`` (the encoder's and the
cross attention) scales the query, fills masked logits with the compute
type's ``finfo.min`` and takes its softmax in that type;
``CachedSelfAttention`` (the decoders' self attention) scales the logits,
fills with float32's ``finfo.min`` (which promotes them to float32), takes
a float32 softmax and casts back.  Each layer is post-LN (flax's epsilon
1e-6).  ``compute_dtype`` bfloat16 keeps the parameters float32 and casts
inputs, kernels and biases at each product, as ``nn.Dense(dtype=...)``; the
pointer's logits and softmax and the encoder scorer are float32.

Ranking decodes with key/value caches ``[B, T, H, dh]`` per decoder layer,
written at step t, in a Python loop over the slate; the cross attention's
keys and values over the memory and the pointer's keys are computed once
(JAX recomputes the first at each step: the same values).  Greedy decoding
is ``argmax`` (the first maximum, in both packages); sampling adds explicit
gumbel draws ``[T, B, C]`` (``jax.random.categorical``'s form), or draws
them from a ``torch.Generator``; without either a sampled rank raises, as
JAX's does without a key.  ``argsort`` is stable, as ``jnp.argsort``.
"""

from __future__ import annotations

import enum
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.models.fully_connected_network import LayerNorm

Tensor = torch.Tensor

PADDING_SYMBOL = 0
DECODER_START_SYMBOL = 1


class Seq2SlateMode(enum.Enum):
    RANK_MODE = "rank"
    PER_SEQ_LOG_PROB_MODE = "per_sequence_log_prob"
    PER_SYMBOL_LOG_PROB_DIST_MODE = "per_symbol_log_prob_dist"
    DECODE_ONE_STEP_MODE = "decode_one_step"
    ENCODER_SCORE_MODE = "encoder_score_mode"


class Seq2SlateOutputArch(enum.Enum):
    ENCODER_SCORE = "encoder_score"
    AUTOREGRESSIVE = "autoregressive"
    FRECHET_SORT = "frechet_sort"


class Seq2SlateTransformerOutput(NamedTuple):
    ranked_per_symbol_probs: Optional[Tensor] = None
    ranked_per_seq_probs: Optional[Tensor] = None
    ranked_tgt_out_idx: Optional[Tensor] = None
    per_symbol_log_probs: Optional[Tensor] = None
    per_seq_log_probs: Optional[Tensor] = None
    encoder_scores: Optional[Tensor] = None


def subsequent_mask(size: int, device=None) -> Tensor:
    """[1, T, T] causal mask, True = attend (ref seq2slate_utils.py:84)."""
    return ~torch.triu(torch.ones((1, size, size), dtype=torch.bool, device=device), diagonal=1)


def per_symbol_to_per_seq_probs(per_symbol_probs: Tensor, tgt_out_idx: Tensor) -> Tensor:
    """The product of the chosen symbols' probabilities (ref utils.py:150)."""
    probs = torch.gather(per_symbol_probs, 2, tgt_out_idx.to(torch.int64)[:, :, None])[..., 0]
    return torch.clamp(torch.prod(probs, dim=1, keepdim=True), min=1e-35)


def per_symbol_to_per_seq_log_probs(per_symbol_log_probs: Tensor, tgt_out_idx: Tensor) -> Tensor:
    lp = torch.gather(per_symbol_log_probs, 2, tgt_out_idx.to(torch.int64)[:, :, None])[..., 0]
    return torch.sum(lp, dim=1, keepdim=True)


def _selected(tgt_in_idx: Tensor, C: int) -> Tensor:
    """[B, T, C]: whether symbol c is among ``tgt_in_idx[:, :t + 1]``."""
    onehot = F.one_hot(tgt_in_idx.to(torch.int64), C).to(torch.float32)
    return torch.cumsum(onehot, dim=1) > 0


def mask_logits_by_idx(logits: Tensor, tgt_in_idx: Tensor) -> Tensor:
    """-inf at the reserved symbols and the items already selected (ref
    utils.py:68-81)."""
    logits = logits.clone()
    logits[:, :, :2] = -math.inf
    return torch.where(_selected(tgt_in_idx, logits.shape[2]), -math.inf, logits)


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the operand of a JAX product with a
    weakly typed Python scalar (computed once a value)."""
    if dtype == torch.float32:
        return value
    return float(torch.tensor(value, dtype=dtype))


def dense(layer: nn.Linear, x: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
    """flax's ``nn.Dense(dtype=dtype)`` on a float32 ``nn.Linear``: input,
    kernel and bias cast to ``dtype``, the product, then the bias added.
    ``dtype=None`` takes the promoted type of the input and the parameters
    (flax's default)."""
    if dtype is None:
        dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    if dtype == torch.float32:
        return layer(x.to(torch.float32))
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def xavier_uniform_(weight: Tensor, generator: torch.Generator) -> None:
    """flax's ``xavier_uniform`` on an ``[out, in]`` weight (a
    ``DenseGeneral`` kernel over its flattened axes has the same fans)."""
    fan_out, fan_in = weight.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    draw = torch.rand(weight.shape, generator=generator, dtype=torch.float32)
    with torch.no_grad():
        weight.copy_(draw * (2.0 * limit) - limit)


def _reset_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    xavier_uniform_(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()


class Embedder(nn.Module):
    """A linear embedding scaled by sqrt(dim_out) (ref seq2slate.py:317-329)."""

    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_out = dim_out
        self.dtype = dtype
        self.dense0 = nn.Linear(dim_in, dim_out)

    def forward(self, x: Tensor) -> Tensor:
        h = dense(self.dense0, x, self.dtype)
        return h * _in_dtype(math.sqrt(self.dim_out), h.dtype)


def positional_table(T: int, D: int) -> np.ndarray:
    """[T, D] sinusoidal position table (ref seq2slate.py:331-356), float32."""
    pos = np.arange(T)[:, None]
    div = np.exp(np.arange(0, D, 2) * (-math.log(10000.0) / D))
    pe = np.zeros((T, D), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: (D + 1) // 2][: pe[:, 1::2].shape[1]])
    return pe


class PositionalEncoding(nn.Module):
    """Sinusoidal positions added to the embeddings: a float32 table, so a
    bfloat16 input comes out float32, as in JAX."""

    def forward(self, x: Tensor) -> Tensor:
        B, T, D = x.shape
        return x + torch.from_numpy(positional_table(T, D)).to(x.device)[None]


class FeedForward(nn.Module):
    def __init__(self, dim_model: int, dim_feedforward: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dense0 = nn.Linear(dim_model, dim_feedforward)
        self.dense1 = nn.Linear(dim_feedforward, dim_model)

    def forward(self, x: Tensor) -> Tensor:
        return dense(self.dense1, F.relu(dense(self.dense0, x, self.dtype)), self.dtype)


class Norm(LayerNorm):
    """flax's ``nn.LayerNorm(dtype=dtype)``: float32 statistics and
    arithmetic, the result cast to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features)
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(x).to(self.dtype)


class Attention(nn.Module):
    """Multi-head attention with per-head projections kept as ``nn.Linear``
    ``[H * dh, D]`` (a ``DenseGeneral`` kernel ``[D, H, dh]`` flattened) and
    the output ``[D, H * dh]``.  ``cached=False`` is flax's
    ``MultiHeadDotProductAttention``, ``cached=True`` the JAX package's
    ``CachedSelfAttention`` (see the module docstring)."""

    def __init__(self, dim_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 cached: bool = False):
        super().__init__()
        self.dim_model, self.num_heads = dim_model, num_heads
        self.dtype = dtype
        self.cached = cached
        self.query = nn.Linear(dim_model, dim_model)
        self.key = nn.Linear(dim_model, dim_model)
        self.value = nn.Linear(dim_model, dim_model)
        self.out = nn.Linear(dim_model, dim_model)

    def project(self, layer: nn.Linear, x: Tensor) -> Tensor:
        """[B, L, D] -> [B, L, H, dh]."""
        B, L, _ = x.shape
        H = self.num_heads
        return dense(layer, x, self.dtype).reshape(B, L, H, self.dim_model // H)

    def attend(self, q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor]) -> Tensor:
        """q [B, T, H, dh] over k, v [B, L, H, dh] -> [B, T, D]; ``mask``
        broadcasts to [B, H, T, L], True = attend."""
        B, T, H, dh = q.shape
        if self.cached:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / _in_dtype(math.sqrt(dh), q.dtype)
            logits = logits.to(torch.float32)
            if mask is not None:
                logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
            w = torch.softmax(logits, dim=-1).to(q.dtype)
        else:
            q = q / _in_dtype(math.sqrt(dh), q.dtype)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
            if mask is not None:
                logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
            w = _softmax(logits).to(q.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, H * dh)
        return dense(self.out, ctx, self.dtype)

    def forward(self, x: Tensor, kv: Optional[Tensor] = None, mask: Optional[Tensor] = None,
                kv_proj: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
        """Attention of ``x`` [B, T, D] over ``kv`` (``x`` itself where
        None), or over projected ``kv_proj = (k, v)``; ``mask`` [B, T, L] or
        already [B, 1, T, L]."""
        if mask is not None and mask.ndim == 3:
            mask = mask[:, None]
        if kv_proj is None:
            src = x if kv is None else kv
            kv_proj = (self.project(self.key, src), self.project(self.value, src))
        return self.attend(self.project(self.query, x), *kv_proj, mask)

    def step(self, x1: Tensor, cache: Tuple[Tensor, Tensor], index: int) -> Tensor:
        """One decode step: ``x1`` [B, 1, D] attends over the cached
        positions <= ``index`` after writing its key and value there (in
        place: ``cache`` is the caller's ``[B, T, H, dh]`` pair)."""
        k_cache, v_cache = cache
        k_cache[:, index] = self.project(self.key, x1)[:, 0].to(k_cache.dtype)
        v_cache[:, index] = self.project(self.value, x1)[:, 0].to(v_cache.dtype)
        T = k_cache.shape[1]
        mask = (torch.arange(T, device=x1.device) <= index)[None, None, None, :]
        return self.attend(self.project(self.query, x1), k_cache, v_cache, mask)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.query, self.key, self.value, self.out):
            _reset_linear(layer, generator)


def _softmax(x: Tensor) -> Tensor:
    """``jax.nn.softmax`` over the last axis, each operation in ``x``'s type
    (a bfloat16 softmax rounds the exponentials, their sum and the quotient)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class EncoderLayer(nn.Module):
    """A post-LN transformer encoder layer."""

    def __init__(self, dim_model: int, num_heads: int, dim_feedforward: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = Attention(dim_model, num_heads, dtype)
        self.norm1 = Norm(dim_model, dtype)
        self.ff = FeedForward(dim_model, dim_feedforward, dtype)
        self.norm2 = Norm(dim_model, dtype)

    def forward(self, x: Tensor) -> Tensor:
        x = self.norm1(x + self.attn(x))
        return self.norm2(x + self.ff(x))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_block(self, generator)


class DecoderLayer(nn.Module):
    """Causal self attention, cross attention and feed-forward, each
    post-LN: ``forward`` runs the whole sequence, ``step`` one position
    against the caller's key/value cache."""

    def __init__(self, dim_model: int, num_heads: int, dim_feedforward: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = Attention(dim_model, num_heads, dtype, cached=True)
        self.norm1 = Norm(dim_model, dtype)
        self.cross_attn = Attention(dim_model, num_heads, dtype)
        self.norm2 = Norm(dim_model, dtype)
        self.ff = FeedForward(dim_model, dim_feedforward, dtype)
        self.norm3 = Norm(dim_model, dtype)

    def forward(self, tgt: Tensor, memory: Tensor, tgt_tgt_mask: Tensor,
                tgt_src_mask: Tensor) -> Tensor:
        tgt = self.norm1(tgt + self.self_attn(tgt, mask=tgt_tgt_mask))
        tgt = self.norm2(tgt + self.cross_attn(tgt, memory, mask=tgt_src_mask[:, None]))
        return self.norm3(tgt + self.ff(tgt))

    def memory_kv(self, memory: Tensor) -> Tuple[Tensor, Tensor]:
        """The cross attention's keys and values over the memory."""
        return (self.cross_attn.project(self.cross_attn.key, memory),
                self.cross_attn.project(self.cross_attn.value, memory))

    def step(self, tgt1: Tensor, memory_kv, src_mask1: Tensor, cache, index: int) -> Tensor:
        tgt1 = self.norm1(tgt1 + self.self_attn.step(tgt1, cache, index))
        ca = self.cross_attn(tgt1, mask=src_mask1[:, None], kv_proj=memory_kv)
        tgt1 = self.norm2(tgt1 + ca)
        return self.norm3(tgt1 + self.ff(tgt1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_block(self, generator)


class PointerLastLayer(nn.Module):
    """The last decoder layer: head-averaged attention probabilities over
    the memory (reference seq2slate.py:181-206 ``DecoderLastLayerPytorch``)."""

    def __init__(self, dim_model: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_model, self.num_heads = dim_model, num_heads
        self.dtype = dtype
        self.self_attn = Attention(dim_model, num_heads, dtype, cached=True)
        self.norm1 = Norm(dim_model, dtype)
        self.q_ptr = nn.Linear(dim_model, dim_model)
        self.k_ptr = nn.Linear(dim_model, dim_model)

    def _pointer_probs(self, tgt: Tensor, k: Tensor, tgt_src_mask: Tensor) -> Tensor:
        """tgt [B, T, D] over the projected memory keys k [B, S, D] ->
        [B, T, S]: the mask, a float32 softmax, then the mean over heads."""
        H, D = self.num_heads, self.dim_model
        dh = D // H
        q = dense(self.q_ptr, tgt, self.dtype)
        B, T, _ = q.shape
        S = k.shape[1]
        q = q.reshape(B, T, H, dh).transpose(1, 2)
        kh = k.reshape(B, S, H, dh).transpose(1, 2)
        logits = torch.einsum("bhtd,bhsd->bhts", q, kh).to(torch.float32) / math.sqrt(dh)
        logits = torch.where(tgt_src_mask[:, None], logits, -math.inf)
        return torch.softmax(logits, dim=-1).mean(dim=1)

    def memory_keys(self, memory: Tensor) -> Tensor:
        return dense(self.k_ptr, memory, self.dtype)

    def forward(self, tgt: Tensor, memory: Tensor, tgt_tgt_mask: Tensor,
                tgt_src_mask: Tensor) -> Tensor:
        tgt = self.norm1(tgt + self.self_attn(tgt, mask=tgt_tgt_mask))
        return self._pointer_probs(tgt, self.memory_keys(memory), tgt_src_mask)

    def step(self, tgt1: Tensor, k_mem: Tensor, src_mask1: Tensor, cache, index: int) -> Tensor:
        tgt1 = self.norm1(tgt1 + self.self_attn.step(tgt1, cache, index))
        return self._pointer_probs(tgt1, k_mem, src_mask1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_block(self, generator)


def _reset_block(module: nn.Module, generator: torch.Generator) -> None:
    """flax's init of a block: xavier-uniform kernels, zero biases, unit
    norms, in the order of the module's children."""
    for child in module.children():
        if isinstance(child, nn.Linear):
            _reset_linear(child, generator)
        elif isinstance(child, LayerNorm):
            child.reset_parameters()
        elif isinstance(child, Attention):
            child.reset_parameters(generator)
        else:
            _reset_block(child, generator)


class Seq2SlateTransformerModel(nn.Module):
    """Reference: seq2slate.py:382.  ``forward(mode, state, src_seq, ...)``
    dispatches on the mode's value, as the flax module's ``__call__``."""

    def __init__(
        self,
        state_dim: int,
        candidate_dim: int,
        num_stacked_layers: int,
        num_heads: int,
        dim_model: int,
        dim_feedforward: int,
        max_src_seq_len: int,
        max_tgt_seq_len: int,
        output_arch: Seq2SlateOutputArch,
        temperature: float = 1.0,
        state_embed_dim: Optional[int] = None,
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim, self.candidate_dim = state_dim, candidate_dim
        self.num_stacked_layers = num_stacked_layers
        self.num_heads, self.dim_model = num_heads, dim_model
        self.dim_feedforward = dim_feedforward
        self.max_src_seq_len, self.max_tgt_seq_len = max_src_seq_len, max_tgt_seq_len
        self.output_arch = Seq2SlateOutputArch(output_arch)
        self.temperature = temperature
        self.compute_dtype = compute_dtype
        sed = state_embed_dim or dim_model // 2
        cd = compute_dtype
        self.state_embedder = Embedder(state_dim, sed, cd)
        self.candidate_embedder = Embedder(candidate_dim, dim_model - sed, cd)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(dim_model, num_heads, dim_feedforward, cd)
            for _ in range(num_stacked_layers))
        self.encoder_scorer = nn.Linear(dim_model, 1)
        self.decoder_layers = nn.ModuleList(
            [DecoderLayer(dim_model, num_heads, dim_feedforward, cd)
             for _ in range(num_stacked_layers - 1)]
            + [PointerLastLayer(dim_model, num_heads, cd)])
        self.positional_encoding_decoder = PositionalEncoding()
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_block(self, generator)

    def params_for(self, mode) -> dict:
        """Copies of the parameters ``mode``'s forward reads, by name: the
        decoder only in an AUTOREGRESSIVE model's decoding modes, the
        encoder scorer only where scores are read.  Flax creates no others,
        so a trainer's state holds what JAX's does (and nothing without a
        gradient)."""
        mode = mode.value if isinstance(mode, Seq2SlateMode) else mode
        autoregressive = self.output_arch == Seq2SlateOutputArch.AUTOREGRESSIVE
        encoder_only = mode == Seq2SlateMode.ENCODER_SCORE_MODE.value
        skip = []
        if encoder_only or not autoregressive:
            skip.append("decoder_layers.")
        if autoregressive and not encoder_only:
            skip.append("encoder_scorer.")
        return {k: p.detach().clone() for k, p in self.named_parameters()
                if not k.startswith(tuple(skip))}

    # ------------------------------------------------------------- building

    def _embed(self, state: Tensor, seq: Tensor, state_embed: Optional[Tensor] = None) -> Tensor:
        """The state's embedding repeated beside each item's (ref :771)."""
        B, T, _ = seq.shape
        cand = self.candidate_embedder(seq)
        sed = self.dim_model - cand.shape[-1]
        if state_embed is None:
            state_embed = self.state_embedder(state)
        st = state_embed[:, None, :].expand(B, T, sed)
        return torch.cat([st, cand], dim=2)

    def encode(self, state: Tensor, src_seq: Tensor) -> Tensor:
        x = self._embed(state, src_seq)
        for layer in self.encoder_layers:
            x = layer(x)
        return x  # [B, S, D]

    def encoder_scores(self, memory: Tensor) -> Tensor:
        """[B, S] float32 (the scorer is a float32 ``nn.Dense``)."""
        return dense(self.encoder_scorer, memory)[..., 0]

    def decode(self, memory: Tensor, state: Tensor, tgt_in_idx: Tensor,
               tgt_in_seq: Optional[Tensor]) -> Tensor:
        """Probabilities over the vocabulary at each target position [B, T,
        S + 2] (ref seq2slate.py:780-850)."""
        B, S, _ = memory.shape
        T = tgt_in_idx.shape[1]
        if self.output_arch == Seq2SlateOutputArch.FRECHET_SORT:
            enc = self.encoder_scores(memory)
            logits = torch.cat([torch.full((B, T, 2), -math.inf, device=memory.device),
                                enc[:, None].expand(B, T, S)], dim=2)
            return torch.softmax(mask_logits_by_idx(logits, tgt_in_idx), dim=2)
        if self.output_arch == Seq2SlateOutputArch.AUTOREGRESSIVE:
            tgt = self.positional_encoding_decoder(self._embed(state, tgt_in_seq))
            tgt_tgt_mask = subsequent_mask(T, memory.device).expand(B, T, T)
            # the candidates already selected up to each step (ref utils.py:163)
            tgt_src_mask = ~_selected(tgt_in_idx, S + 2)[:, :, 2:]
            x = tgt
            for layer in self.decoder_layers[:-1]:
                x = layer(x, memory, tgt_tgt_mask, tgt_src_mask)
            probs_src = self.decoder_layers[-1](x, memory, tgt_tgt_mask, tgt_src_mask)
            return torch.cat([torch.zeros((B, T, 2), device=memory.device), probs_src], dim=2)
        raise NotImplementedError(self.output_arch)

    # ---------------------------------------------------------------- modes

    def forward(
        self,
        mode: str,
        state: Tensor,
        src_seq: Tensor,
        tgt_in_idx: Optional[Tensor] = None,
        tgt_out_idx: Optional[Tensor] = None,
        tgt_in_seq: Optional[Tensor] = None,
        tgt_seq_len: Optional[int] = None,
        greedy: Optional[bool] = None,
        gumbel: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Seq2SlateTransformerOutput:
        mode = mode.value if isinstance(mode, Seq2SlateMode) else mode
        if mode == Seq2SlateMode.RANK_MODE.value:
            return self.rank(state, src_seq, tgt_seq_len or self.max_tgt_seq_len, bool(greedy),
                             gumbel, generator)
        if mode in (Seq2SlateMode.PER_SEQ_LOG_PROB_MODE.value,
                    Seq2SlateMode.PER_SYMBOL_LOG_PROB_DIST_MODE.value):
            return self.log_probs(state, src_seq, tgt_in_seq, tgt_in_idx, tgt_out_idx, mode)
        if mode == Seq2SlateMode.ENCODER_SCORE_MODE.value:
            return self.encoder_output_to_scores(state, src_seq, tgt_out_idx)
        raise NotImplementedError(mode)

    @torch.no_grad()
    def rank(self, state: Tensor, src_seq: Tensor, tgt_seq_len: int, greedy: bool,
             gumbel: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Seq2SlateTransformerOutput:
        """Reference seq2slate.py:554-605.  ``gumbel`` [T, B, S + 2] (or
        draws from ``generator``) where ``greedy`` is False."""
        B, S, cdim = src_seq.shape
        C = S + 2
        candidate_features = torch.cat(
            [torch.zeros((B, 2, cdim), dtype=src_seq.dtype, device=src_seq.device), src_seq],
            dim=1)
        memory = self.encode(state, src_seq)
        if self.output_arch == Seq2SlateOutputArch.ENCODER_SCORE:
            enc = self.encoder_scores(memory)
            tgt_out_idx = torch.argsort(-enc, dim=1, stable=True)[:, :tgt_seq_len] + 2
            per_symbol = F.one_hot(tgt_out_idx, C).to(torch.float32)
        elif self.output_arch == Seq2SlateOutputArch.FRECHET_SORT and greedy:
            tgt_in_idx = torch.full((B, 1), DECODER_START_SYMBOL, dtype=torch.int64,
                                    device=src_seq.device)
            tgt_in_seq = candidate_features[:, DECODER_START_SYMBOL:DECODER_START_SYMBOL + 1]
            probs = self.decode(memory, state, tgt_in_idx, tgt_in_seq)[:, -1]
            tgt_out_idx = torch.argsort(-probs, dim=1, stable=True)[:, :tgt_seq_len]
            per_symbol = F.one_hot(tgt_out_idx, C).to(torch.float32)
        else:
            tgt_out_idx, per_symbol = self._autoregressive_rank(
                state, memory, candidate_features, tgt_seq_len, greedy, gumbel, generator)
        return Seq2SlateTransformerOutput(
            ranked_per_symbol_probs=per_symbol,
            ranked_per_seq_probs=per_symbol_to_per_seq_probs(per_symbol, tgt_out_idx),
            ranked_tgt_out_idx=tgt_out_idx,
        )

    def _draws(self, T: int, B: int, C: int, greedy: bool, gumbel: Optional[Tensor],
               generator: Optional[torch.Generator], device) -> Optional[Tensor]:
        if greedy:
            return None
        if gumbel is not None:
            return gumbel.to(device=device, dtype=torch.float32)
        if generator is None:
            raise ValueError(
                "sampled ranking (greedy=False) needs gumbel draws or a generator;"
                " without them every call would return the same slate")
        from reagent_tpu_torch.gym.policies.samplers import gumbel as draw_gumbel

        return draw_gumbel((T, B, C), generator, device)

    def _pick(self, probs: Tensor, g: Optional[Tensor]) -> Tensor:
        """The next symbol: the first maximum, or a gumbel-max draw from
        ``log(probs) / temperature`` (``jax.random.categorical``)."""
        if g is None:
            return torch.argmax(probs, dim=1)
        logits = torch.log(torch.clamp(probs, min=1e-35)) / self.temperature
        return torch.argmax(g + logits, dim=1)

    def _autoregressive_rank(self, state: Tensor, memory: Tensor, candidate_features: Tensor,
                             tgt_seq_len: int, greedy: bool, gumbel: Optional[Tensor],
                             generator: Optional[torch.Generator]):
        """The key/value-cached decode: one position per step through every
        decoder layer (O(T) layer work a slate); FRECHET_SORT samples from
        its static encoder scores without the decoder layers."""
        B, C, cdim = candidate_features.shape
        T = tgt_seq_len
        dev = memory.device
        g = self._draws(T, B, C, greedy, gumbel, generator, dev)
        if self.output_arch == Seq2SlateOutputArch.FRECHET_SORT:
            return self._static_score_rank(memory, B, C, T, g)

        H = self.num_heads
        dh = self.dim_model // H
        caches = [(torch.zeros((B, T, H, dh), dtype=self.compute_dtype, device=dev),
                   torch.zeros((B, T, H, dh), dtype=self.compute_dtype, device=dev))
                  for _ in self.decoder_layers]
        pe = torch.from_numpy(positional_table(T, self.dim_model)).to(dev)
        # loop invariants: the memory's cross-attention keys and values, the
        # pointer's keys and the state's embedding
        memory_kv = [layer.memory_kv(memory) for layer in self.decoder_layers[:-1]]
        k_mem = self.decoder_layers[-1].memory_keys(memory)
        state_embed = self.state_embedder(state)
        rows = torch.arange(B, device=dev)
        cur = torch.full((B,), DECODER_START_SYMBOL, dtype=torch.int64, device=dev)
        selected = torch.zeros((B, C), dtype=torch.bool, device=dev)
        zeros2 = torch.zeros((B, 2), device=dev)
        probs_seq, idx_seq = [], []
        for t in range(T):
            tok_feat = candidate_features[rows, cur][:, None, :]  # zeros for start/padding
            x1 = self._embed(state, tok_feat, state_embed) + pe[t][None, None, :]
            # inclusive: the input symbol counts as selected, as decode()'s
            # cumsum over tgt_in_idx
            selected = selected | F.one_hot(cur, C).to(torch.bool)
            src_mask1 = ~selected[:, 2:][:, None, :]  # [B, 1, S] True = attend
            for i, layer in enumerate(self.decoder_layers[:-1]):
                x1 = layer.step(x1, memory_kv[i], src_mask1, caches[i], t)
            probs_s = self.decoder_layers[-1].step(x1, k_mem, src_mask1, caches[-1], t)
            probs = torch.cat([zeros2, probs_s[:, 0]], dim=1)  # [B, C]
            cur = self._pick(probs, None if g is None else g[t])
            probs_seq.append(probs)
            idx_seq.append(cur)
        return torch.stack(idx_seq, dim=1), torch.stack(probs_seq, dim=1)

    def _static_score_rank(self, memory: Tensor, B: int, C: int, T: int, g: Optional[Tensor]):
        """FRECHET_SORT's steps: a softmax over the static encoder scores
        with the items picked so far masked out (what ``decode`` computes
        for this architecture, without the decoder layers)."""
        dev = memory.device
        base = torch.cat([torch.full((B, 2), -math.inf, device=dev),
                          self.encoder_scores(memory).to(torch.float32)], dim=1)
        selected = torch.zeros((B, C), dtype=torch.bool, device=dev)
        probs_seq, idx_seq = [], []
        for t in range(T):
            probs = torch.softmax(torch.where(selected, -math.inf, base), dim=1)
            nxt = self._pick(probs, None if g is None else g[t])
            selected = selected | F.one_hot(nxt, C).to(torch.bool)
            probs_seq.append(probs)
            idx_seq.append(nxt)
        return torch.stack(idx_seq, dim=1), torch.stack(probs_seq, dim=1)

    def log_probs(self, state, src_seq, tgt_in_seq, tgt_in_idx, tgt_out_idx,
                  mode: str) -> Seq2SlateTransformerOutput:
        memory = self.encode(state, src_seq)
        probs = self.decode(memory, state, tgt_in_idx, tgt_in_seq)
        if mode == Seq2SlateMode.PER_SYMBOL_LOG_PROB_DIST_MODE.value:
            return Seq2SlateTransformerOutput(
                per_symbol_log_probs=torch.log(torch.clamp(probs, min=1e-35)))
        return Seq2SlateTransformerOutput(
            per_seq_log_probs=torch.log(per_symbol_to_per_seq_probs(probs, tgt_out_idx)))

    def encoder_output_to_scores(self, state, src_seq, tgt_out_idx) -> Seq2SlateTransformerOutput:
        memory = self.encode(state, src_seq)
        idx = (tgt_out_idx.to(torch.int64) - 2)[:, :, None].expand(-1, -1, memory.shape[2])
        slate_mem = torch.gather(memory, 1, idx)
        return Seq2SlateTransformerOutput(encoder_scores=self.encoder_scores(slate_mem))


class Seq2SlateTransformerNet:
    """The model bound to a typed batch (reference models/seq2slate.py:847
    ``Seq2SlateNet``, :936 ``Seq2SlateTransformerNet``): ``__call__(params,
    batch, mode, ...)`` unpacks a ``PreprocessedRankingInput`` by mode.
    ``device`` defaults to ``"cuda"`` and raises if no card is present."""

    def __init__(
        self,
        state_dim: int,
        candidate_dim: int,
        num_stacked_layers: int,
        num_heads: int,
        dim_model: int,
        dim_feedforward: int,
        max_src_seq_len: int,
        max_tgt_seq_len: int,
        output_arch: Seq2SlateOutputArch = Seq2SlateOutputArch.AUTOREGRESSIVE,
        temperature: float = 1.0,
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        from reagent_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.seq2slate = Seq2SlateTransformerModel(
            state_dim=state_dim, candidate_dim=candidate_dim,
            num_stacked_layers=num_stacked_layers, num_heads=num_heads,
            dim_model=dim_model, dim_feedforward=dim_feedforward,
            max_src_seq_len=max_src_seq_len, max_tgt_seq_len=max_tgt_seq_len,
            output_arch=output_arch, temperature=temperature, compute_dtype=compute_dtype,
        ).to(self.device)
        self.max_tgt_seq_len = max_tgt_seq_len

    def init(self, generator: torch.Generator):
        """Fresh parameters from ``generator``, by name."""
        self.seq2slate.reset_parameters(generator)
        return {k: p.detach().clone() for k, p in self.seq2slate.named_parameters()}

    def __call__(self, params, batch, mode, tgt_seq_len: Optional[int] = None,
                 greedy: Optional[bool] = None, gumbel: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Seq2SlateTransformerOutput:
        mode_value = mode.value if isinstance(mode, Seq2SlateMode) else mode
        kwargs = {}
        if mode_value == Seq2SlateMode.RANK_MODE.value:
            kwargs = dict(tgt_seq_len=tgt_seq_len or self.max_tgt_seq_len, greedy=bool(greedy),
                          gumbel=gumbel, generator=generator)
        elif mode_value in (Seq2SlateMode.PER_SEQ_LOG_PROB_MODE.value,
                            Seq2SlateMode.PER_SYMBOL_LOG_PROB_DIST_MODE.value):
            kwargs = dict(tgt_in_idx=batch.tgt_in_idx, tgt_out_idx=batch.tgt_out_idx,
                          tgt_in_seq=batch.tgt_in_seq.float_features)
        elif mode_value == Seq2SlateMode.ENCODER_SCORE_MODE.value:
            kwargs = dict(tgt_out_idx=batch.tgt_out_idx)
        from reagent_tpu_torch.training import functional

        return functional.apply(self.seq2slate, params, mode_value, batch.state.float_features,
                                batch.src_seq.float_features, **kwargs)
