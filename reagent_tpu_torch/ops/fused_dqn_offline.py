"""Fused DQN update for offline-sized batches (K1).

Replaces the TPU kernel ``reagent_tpu/ops/fused_dqn_offline.py::
make_fused_dqn_offline_kernel`` (its ``pallas_call`` at :240): the same
update as K2 (``fused_dqn.py``), which the TPU streams through VMEM in
``block_size``-row blocks, carrying gradient sums across its sequential grid.

On Hopper blocks run in parallel and in no order, so nothing carries over
between them.  The CUDA entry ``fused_dqn_offline_update`` instead splits the
batch into fixed 256-row chunks: each chunk's weight and bias gradients are a
split-K GEMM slice written to a ``[chunks, out, in+1]`` workspace, and the
Adam+polyak kernel sums the chunks in fixed order (no atomics, so results
repeat run to run).  The saved layer outputs of the whole batch (at 4096 rows
and widths 512, 256 about 12.6 MB) stay in the 50 MB L2 between the forward
and the backward.  Like K2 the update is bound by f32 operations on this card.

``block_size`` is the TPU's VMEM tiling and does not steer the CUDA tiling;
it is still checked (``B % block_size == 0``) so a configuration the JAX
package rejects is rejected here too, with a clear error.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from reagent_tpu_torch.ops.fused_dqn import _act_grad_from_h, launch_cuda, update_reference


def check_block_size(minibatch_size: int, block_size: Optional[int]) -> None:
    if block_size is not None and (
        block_size <= 0 or minibatch_size % block_size != 0
    ):
        raise ValueError(
            f"minibatch_size={minibatch_size} is not a multiple of "
            f"block_size={block_size}; the offline fused update streams the "
            "minibatch in whole blocks"
        )


def fused_dqn_offline_update_reference(
    lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, block_size: int, b1: float = 0.9, b2: float = 0.999,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (activation gradients from the output
    ``h``, as the TPU kernel computes them)."""
    check_block_size(obs.shape[0], block_size)
    fused_dqn_offline_update_reference.calls += 1
    return update_reference(
        lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8,
        activations=activations, gamma=gamma, tau=tau,
        double_q_learning=double_q_learning, b1=b1, b2=b2,
        act_grad=_act_grad_from_h,
    )


fused_dqn_offline_update_reference.calls = 0


def fused_dqn_offline_update(
    lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, block_size: int, b1: float = 0.9, b2: float = 0.999,
) -> torch.Tensor:
    """K1: one DQN update in place on ``params8``; returns metrics [1, 4].

    A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
    takes the plain version."""
    kw = dict(activations=activations, gamma=gamma, tau=tau,
              double_q_learning=double_q_learning, b1=b1, b2=b2)
    if obs.device.type == "cpu":
        return fused_dqn_offline_update_reference(
            lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8,
            block_size=block_size, **kw)
    if obs.device.type != "cuda":
        raise ValueError(
            f"fused_dqn_offline_update runs on cuda or cpu, not {obs.device}")
    check_block_size(obs.shape[0], block_size)
    metrics, fused_dqn_offline_update.kernels_per_update = launch_cuda(
        "fused_dqn_offline_update", lr_t, eps_t, obs, nobs, act, rew, nt, mask,
        params8, **kw)
    fused_dqn_offline_update.launches += 1
    return metrics


fused_dqn_offline_update.launches = 0
fused_dqn_offline_update.kernels_per_update = None  # CUDA kernels in the last update
