"""Fused DQN update for offline-sized batches (K1).

Replaces the TPU kernel ``reagent_tpu/ops/fused_dqn_offline.py::
make_fused_dqn_offline_kernel`` (its ``pallas_call`` at :240): the same
update as K2 (``fused_dqn.py``), which the TPU streams through VMEM in
``block_size``-row blocks, carrying gradient sums across its sequential grid.

On Hopper blocks run in parallel and in no order, so nothing carries over
between them.  The CUDA entry ``fused_dqn_offline_update`` instead splits the
batch into fixed 256-row chunks: each chunk's weight gradient is a split-K
GEMM slice written to a ``[chunks, out, in]`` workspace (the same launch's
extra blocks sum each chunk's bias gradient), and one Adam+polyak launch for
every layer sums the chunks in fixed order (no atomics, so results repeat
run to run).  An update is 3L + 1 launches (10 at three layers): one
forward launch per layer for all three (net, input) pairs, the TD rows, the
weight gradients, dh, Adam.  The saved layer outputs of the whole batch (at
4096 rows and widths 512, 256 about 12.6 MB) stay in the 50 MB L2 between
the forward and the backward.  Like K2 the f32 update is bound by f32
operations on this card, so its wide products run on a persistent FFMA
kernel: 128x128 tiles with an 8x8 register block per thread (smaller tiles
where a product has too few), fed by a ring of ``cp.async`` stages, the
operands contiguous in k transposed by the copies themselves, and the last
layer's forward reads its input once, two rows a thread (``csrc/fused_dqn.cu``);
``product_routes()`` counts the products each tile took.

``matmul_dtype`` and ``save_dtype`` are the TPU kernel's options of the same
names (:71-72): ``matmul_dtype=torch.bfloat16`` rounds both operands of every
product to bfloat16 and accumulates in float32, which the CUDA entry
``fused_dqn_offline_update_bf16`` does on the tensor cores (``mma.sync``
m16n8k16 bf16, f32 accumulators, tiles brought in by ``cp.async`` from bf16
copies that each operand's producer writes once, 3L + 2 launches);
``save_dtype`` (default: ``matmul_dtype``) is the type the
saved layer outputs are kept in, from which the weight and activation
gradients are taken.  Master weights, Adam moments, ``q`` and the bias
gradient stay float32.  All four combinations run on the card.

``block_size`` is the TPU's VMEM tiling and does not steer the CUDA tiling;
it is still checked (``B % block_size == 0``) so a configuration the JAX
package rejects is rejected here too, with a clear error.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from reagent_tpu_torch.ops import _build
from reagent_tpu_torch.ops.fused_dqn import (
    _act_grad_from_h,
    check_kernel_dtype,
    launch_cuda,
    update_reference,
)
from reagent_tpu_torch.utils.profiling import annotate


def check_block_size(minibatch_size: int, block_size: Optional[int]) -> None:
    if block_size is not None and (
        block_size <= 0 or minibatch_size % block_size != 0
    ):
        raise ValueError(
            f"minibatch_size={minibatch_size} is not a multiple of "
            f"block_size={block_size}; the offline fused update streams the "
            "minibatch in whole blocks"
        )


def resolve_dtypes(matmul_dtype, save_dtype):
    """``(matmul_dtype, save_dtype)`` with the TPU kernel's defaults
    (``save_dtype=None`` means ``matmul_dtype``); ``TypeError`` for any type
    but float32 and bfloat16."""
    check_kernel_dtype("matmul_dtype", matmul_dtype)
    if save_dtype is None:
        save_dtype = matmul_dtype
    check_kernel_dtype("save_dtype", save_dtype)
    return matmul_dtype, save_dtype


def fused_dqn_offline_update_reference(
    lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, block_size: int, b1: float = 0.9, b2: float = 0.999,
    matmul_dtype: torch.dtype = torch.float32,
    save_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (activation gradients from the saved
    output ``h``, as the TPU kernel computes them), with its
    ``matmul_dtype`` / ``save_dtype`` roundings."""
    check_block_size(obs.shape[0], block_size)
    matmul_dtype, save_dtype = resolve_dtypes(matmul_dtype, save_dtype)
    fused_dqn_offline_update_reference.calls += 1
    return update_reference(
        lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8,
        activations=activations, gamma=gamma, tau=tau,
        double_q_learning=double_q_learning, b1=b1, b2=b2,
        act_grad=_act_grad_from_h, matmul_dtype=matmul_dtype, save_dtype=save_dtype,
    )


fused_dqn_offline_update_reference.calls = 0


def fused_dqn_offline_update(
    lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, block_size: int, b1: float = 0.9, b2: float = 0.999,
    matmul_dtype: torch.dtype = torch.float32,
    save_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K1: one DQN update in place on ``params8``; returns metrics [1, 4].

    ``matmul_dtype`` / ``save_dtype``: float32 or bfloat16, with the TPU
    kernel's meaning (``save_dtype=None`` follows ``matmul_dtype``); the
    batch and ``params8`` are float32 either way.  A CUDA tensor launches the
    hand-written kernel (or raises); a CPU tensor takes the plain version."""
    matmul_dtype, save_dtype = resolve_dtypes(matmul_dtype, save_dtype)
    kw = dict(activations=activations, gamma=gamma, tau=tau,
              double_q_learning=double_q_learning, b1=b1, b2=b2)
    if obs.device.type == "cpu":
        return fused_dqn_offline_update_reference(
            lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8,
            block_size=block_size, matmul_dtype=matmul_dtype, save_dtype=save_dtype, **kw)
    if obs.device.type != "cuda":
        raise ValueError(
            f"fused_dqn_offline_update runs on cuda or cpu, not {obs.device}")
    check_block_size(obs.shape[0], block_size)
    fn = fused_dqn_offline_update
    with annotate("reagent.k1"):
        if matmul_dtype == save_dtype == torch.float32:
            metrics, fn.kernels_per_update = launch_cuda(
                "fused_dqn_offline_update", lr_t, eps_t, obs, nobs, act, rew, nt, mask,
                params8, **kw)
        else:
            bf16 = torch.bfloat16
            metrics, fn.bf16_kernels_per_update = launch_cuda(
                "fused_dqn_offline_update_bf16", lr_t, eps_t, obs, nobs, act, rew, nt,
                mask, params8, precision=(int(matmul_dtype == bf16), int(save_dtype == bf16)),
                **kw)
            fn.bf16_launches += 1
    fn.launches += 1
    return metrics


fused_dqn_offline_update.launches = 0  # every launch, whatever the dtypes
fused_dqn_offline_update.bf16_launches = 0  # those with a bfloat16 option
fused_dqn_offline_update.kernels_per_update = None  # CUDA kernels in the last f32 update
fused_dqn_offline_update.bf16_kernels_per_update = None  # ... in the last bf16 one

# The tile routes of the library's products (csrc/fused_dqn.cu, Route): the
# ring kernel's tiles, the row kernel of forwards with N <= 8, the narrow tile
# (N <= 64), the tile for unaligned or bfloat16-typed operands, the tensor
# cores.
PRODUCT_ROUTES = ("ring_128x128", "ring_128x64", "ring_64x64", "rows_64x8", "narrow_64x16",
                  "typed_128x64", "tensor_cores")


def product_routes() -> dict:
    """Products the CUDA library has launched since it was loaded, K1's and
    K2's launch sequences alike, by tile route (``PRODUCT_ROUTES``): what
    shows which tile the main path took.  Needs the built library (the card's
    machine)."""
    lib = _build.load_library()
    counts = (ctypes.c_int * lib.k1_product_routes(None))()
    lib.k1_product_routes(counts)
    return dict(zip(PRODUCT_ROUTES, counts))
