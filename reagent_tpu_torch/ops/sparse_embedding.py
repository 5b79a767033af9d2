"""Sparse embedding training at scale: an update that touches only the rows
a batch of ids reads.

Port of ``reagent_tpu/ops/sparse_embedding.py`` (``SparseEmbeddingState``
:34, ``logical_table`` :57, ``init_sparse_embedding_state`` :65,
``make_sparse_embedding_train_step`` :101, ``dense_reference_step`` :180).
JAX's is an XLA program, not a Pallas kernel; this is torch operations.

Autodiff through ``table[ids]`` would build a dense ``[table_size, dim]``
gradient (2.56 GB at 10M x 64) of rows that are nearly all zero.  Instead
the gathered rows ``[B, L, D]`` are the differentiable leaf: autograd gives
their gradient and the head's, and the table and its row-wise Adagrad
accumulator are updated in place, under ``torch.no_grad``, with
``index_add_`` over the ``B * L`` ids, as JAX's scatters do:

- padded slots' gradients are zeroed, so they add 0 to their rows;
- one accumulator scalar per row, to which every occurrence adds the mean
  square of its gradient, so duplicate ids add up (per occurrence, not the
  square of the summed gradient: ``ADVICE.md:3``);
- every occurrence is scaled by ``rsqrt(accum + eps)`` read after the whole
  batch's adds;
- each occurrence's update is added to its row.

The head (``relu(x @ w1 + b1) @ w2 + b2``) is stepped by an optimizer of the
port's union (Adam at 1e-3 by default, as JAX's optax default).

The port keeps the logical ``[table_size, dim]`` table; JAX packs rows of
``dim < 128`` into 128-lane physical rows, a TPU layout, and its
``logical_table`` unpacks them.  On a CUDA tensor ``index_add_`` adds the
occurrences of a duplicate id with atomics, in an order that is not fixed,
so two runs on the card may part by a few float32 ulps of a row's sum; the
card-against-CPU check holds the table to rtol 1e-5 and atol 1e-6 for that
reason (``chip_smoke.py`` phase 44).  On the CPU the adds run in index order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
HeadParams = Dict[str, Tensor]


@dataclasses.dataclass
class SparseEmbeddingState:
    """One big table and a small dense head.  A train step updates
    ``table`` and ``accum`` in place and returns them in the new state."""

    table: Tensor  # [table_size, dim] float32
    accum: Tensor  # [table_size] row-wise Adagrad accumulator
    head_params: HeadParams
    head_opt_state: OptState


def logical_table(state: SparseEmbeddingState, table_size: int, dim: int) -> Tensor:
    """The ``[table_size, dim]`` table (the port stores no other layout)."""
    if state.table.shape != (table_size, dim):
        raise ValueError(f"table {tuple(state.table.shape)} is not [{table_size}, {dim}]")
    return state.table


def head_apply(p: HeadParams, x: Tensor) -> Tensor:
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def init_sparse_embedding_state(
    generator: torch.Generator,
    table_size: int,
    dim: int,
    head_hidden: int = 256,
    out_dim: int = 1,
    head_optimizer: Optional[Dict[str, Any]] = None,
    table_init_scale: float = 0.01,
    device="cuda",
) -> Tuple[SparseEmbeddingState, Callable, Any]:
    """``(state, head_apply, head_opt)``: a N(0, table_init_scale) table
    drawn on ``generator``'s device (a table of gigabytes is best drawn on
    the card), a zero accumulator, the head's He-normal weights and the
    head's optimizer (``head_optimizer``: a config of the union, default
    ``{"Adam": {"lr": 1e-3}}``) and its state."""
    device = resolve_device(device)
    table = torch.randn((table_size, dim), generator=generator, device=generator.device)
    table = table.mul_(table_init_scale).to(device)
    accum = torch.zeros((table_size,), dtype=torch.float32, device=device)

    def normal(shape, fan_in):
        draw = torch.randn(shape, generator=generator, device=generator.device)
        return (draw * (2.0 / fan_in) ** 0.5).to(device)

    head_params = {
        "w1": normal((dim, head_hidden), dim),
        "b1": torch.zeros(head_hidden, device=device),
        "w2": normal((head_hidden, out_dim), head_hidden),
        "b2": torch.zeros(out_dim, device=device),
    }
    opt = make_optimizer(head_optimizer or {"Adam": {"lr": 1e-3}})
    return SparseEmbeddingState(table, accum, head_params, opt.init(head_params)), head_apply, opt


def _pooled_mse(rows: Tensor, mask: Tensor, head_params: HeadParams, target: Tensor,
                apply_fn: Callable) -> Tensor:
    m = mask.to(torch.float32)[..., None]
    pooled = torch.sum(rows * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
    return torch.mean((apply_fn(head_params, pooled) - target) ** 2)


def _head_leaves(head_params: HeadParams) -> HeadParams:
    return {k: v.detach().requires_grad_(True) for k, v in head_params.items()}


def make_sparse_embedding_train_step(
    head_apply: Callable,
    head_opt,
    table_lr: float = 0.05,
    adagrad_eps: float = 1e-8,
):
    """``step(state, ids, mask, target) -> (state, loss)``.

    ``ids`` ``[B, L]`` rows of the table, ``mask`` ``[B, L]`` the valid
    slots (jagged lengths as padding), ``target`` ``[B, out_dim]``.  The
    table and the accumulator of ``state`` are updated in place (no copy of
    a multi-GB table a step); the head's parameters and optimizer state are
    new tensors."""

    def step(state: SparseEmbeddingState, ids: Tensor, mask: Tensor,
             target: Tensor) -> Tuple[SparseEmbeddingState, Tensor]:
        B, L = ids.shape
        D = state.table.shape[1]
        flat_ids = ids.reshape(-1).to(torch.int64)
        rows = state.table.index_select(0, flat_ids).view(B, L, D).requires_grad_(True)
        head = _head_leaves(state.head_params)
        with torch.enable_grad():
            loss = _pooled_mse(rows, mask, head, target, head_apply)
            g_rows, *g_head = torch.autograd.grad(loss, [rows, *head.values()])
        with torch.no_grad():
            flat_g = g_rows.reshape(-1, D) * mask.reshape(-1, 1).to(torch.float32)
            state.accum.index_add_(0, flat_ids, torch.mean(flat_g * flat_g, dim=-1))
            scale = torch.rsqrt(state.accum.index_select(0, flat_ids) + adagrad_eps)
            state.table.index_add_(0, flat_ids, -table_lr * scale[:, None] * flat_g)
            head_params, head_opt_state = head_opt.update(
                dict(zip(head, g_head)), state.head_opt_state, state.head_params)
        return (SparseEmbeddingState(state.table, state.accum, head_params, head_opt_state),
                loss.detach())

    return step


def dense_reference_step(
    head_apply: Callable,
    head_opt,
    table_lr: float = 0.05,
    adagrad_eps: float = 1e-8,
):
    """The plain version: autodiff through ``table[ids]`` gives a dense
    ``[table_size, dim]`` gradient, and row-wise Adagrad runs over the rows
    the batch touched.  For cross-checks at small tables only; it writes
    nothing in place.  It equals the touched-rows step only where no id
    repeats (the dense gradient sums a row's occurrences before squaring)."""

    def step(state: SparseEmbeddingState, ids: Tensor, mask: Tensor,
             target: Tensor) -> Tuple[SparseEmbeddingState, Tensor]:
        T = state.accum.shape[0]
        flat_ids = ids.reshape(-1).to(torch.int64)
        table = state.table.detach().requires_grad_(True)
        head = _head_leaves(state.head_params)
        with torch.enable_grad():
            rows = table.index_select(0, flat_ids).view(*ids.shape, -1)
            loss = _pooled_mse(rows, mask, head, target, head_apply)
            g_table, *g_head = torch.autograd.grad(loss, [table, *head.values()])
        with torch.no_grad():
            touched = torch.zeros(T, device=table.device).index_add_(
                0, flat_ids, mask.reshape(-1).to(torch.float32)) > 0
            g_sq = torch.mean(g_table * g_table, dim=-1)
            accum = state.accum + torch.where(touched, g_sq, 0.0)
            scale = torch.rsqrt(accum + adagrad_eps)
            new_table = table.detach() - table_lr * torch.where(
                touched[:, None], scale[:, None] * g_table, 0.0)
            head_params, head_opt_state = head_opt.update(
                dict(zip(head, g_head)), state.head_opt_state, state.head_params)
        return SparseEmbeddingState(new_table, accum, head_params, head_opt_state), loss.detach()

    return step
