"""n-step replay rewards (K4): per sampled index, the window's discounted
reward sum, its step count and its terminal flag.

Replaces the TPU kernel ``reagent_tpu/ops/nstep_replay.py::nstep_rewards``
(its ``pallas_call`` at :92); the plain version is the counterpart of
``nstep_rewards_xla`` (:24-38).  ``replay/circular.py::ReplayBuffer.sample``
takes ``(nstep_reward, steps, terminal)`` from here in place of the inline
window sum of ``reagent_tpu/replay/circular.py:310-324`` and :343-344.

For start index ``i`` and ``w_k = (i + k) mod capacity``, ``k < horizon``:
``steps`` is 1 + the first ``k`` whose terminal is set, else ``horizon``;
``reward = sum_{k < steps} gamma^k * r[w_k]``; ``terminal =
terminal[w_{steps-1}]``.  ``gamma^k`` is computed in float64 and rounded to
float32, as ``ReplayBuffer`` and the TPU kernel do.

Rewards are ``[capacity]`` (the result is ``[B]``) or ``[capacity, ...]``
(the trailing dims are summed column by column, the result is
``[B, ...]``); the CUDA kernel (``csrc/nstep_replay.cu``) sees them as
``[capacity, R]`` either way.  Its time is launch latency: the bytes it moves
at B = 512 take nanoseconds at this card's memory rate.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def decays(horizon: int, gamma: float) -> np.ndarray:
    """``gamma^k`` for ``k < horizon``, in float64 then rounded to float32."""
    return (float(gamma) ** np.arange(horizon)).astype(np.float32)


def nstep_rewards_reference(
    rewards: Tensor, terminals: Tensor, indices: Tensor, horizon: int, gamma: float
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K4: gathers the ``[B, horizon]`` window and
    reduces it, adding the terms in window order."""
    nstep_rewards_reference.calls += 1
    capacity = rewards.shape[0]
    dev = rewards.device
    ks = torch.arange(horizon, device=dev)
    w = torch.remainder(indices.to(torch.int64)[:, None] + ks, capacity)  # [B, H]
    tm = terminals[w].to(torch.bool)
    tm_last = tm.clone()
    tm_last[:, -1] = True
    steps = torch.argmax(tm_last.to(torch.int32), dim=1).to(torch.int32) + 1  # first True
    terminal = torch.gather(tm, 1, (steps - 1).to(torch.int64)[:, None])[:, 0]
    r = rewards[w].to(torch.float32)  # [B, H, ...]
    d = torch.tensor(decays(horizon, gamma), device=dev)
    d = d.reshape((1, horizon) + (1,) * (r.ndim - 2))
    alive = (ks[None, :] < steps[:, None]).reshape(tm.shape + (1,) * (r.ndim - 2))
    terms = torch.where(alive, r * d, torch.zeros((), device=dev))
    acc = terms[:, 0]
    for k in range(1, horizon):
        acc = acc + terms[:, k]
    return acc, steps, terminal


nstep_rewards_reference.calls = 0


def _launch(rewards, terminals, indices, horizon, gamma):
    from reagent_tpu_torch.ops import _build

    dev = rewards.device
    capacity = rewards.shape[0]
    if rewards.dtype != torch.float32:
        raise TypeError(f"rewards must be float32, got {rewards.dtype}")
    if terminals.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"terminals must be bool or uint8, got {terminals.dtype}")
    if indices.dtype != torch.int64:
        raise TypeError(f"indices must be int64, got {indices.dtype}")
    for name, t in (("rewards", rewards), ("terminals", terminals), ("indices", indices)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rewards on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(terminals.shape) != (capacity,) or indices.ndim != 1:
        raise ValueError(
            f"terminals must be [{capacity}] and indices [B]; got "
            f"{tuple(terminals.shape)} and {tuple(indices.shape)}")
    lib = _build.load_library("nstep_replay")
    if not 1 <= horizon <= lib.nstep_max_horizon():
        raise ValueError(f"horizon {horizon} outside 1..{lib.nstep_max_horizon()}")
    B = indices.shape[0]
    trailing = tuple(rewards.shape[1:])
    R = int(np.prod(trailing)) if trailing else 1
    out_r = torch.empty((B,) + trailing, dtype=torch.float32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    terminal = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return out_r, steps, terminal
    with torch.cuda.device(dev):
        err = lib.nstep_rewards(
            rewards.data_ptr(), R, terminals.data_ptr(), indices.data_ptr(), B,
            capacity, int(horizon), (ctypes.c_float * horizon)(*decays(horizon, gamma).tolist()),
            out_r.data_ptr(), steps.data_ptr(), terminal.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nstep_rewards failed: {lib.nstep_error_string(err).decode()}")
    nstep_rewards.launches += 1
    return out_r, steps, terminal


def nstep_rewards(
    rewards: Tensor, terminals: Tensor, indices: Tensor, horizon: int, gamma: float
) -> Tuple[Tensor, Tensor, Tensor]:
    """K4: ``(nstep_reward [B, ...], steps [B] int32, terminal [B] bool)``.

    A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
    takes the plain version."""
    if rewards.device.type == "cpu":
        return nstep_rewards_reference(rewards, terminals, indices, horizon, gamma)
    if rewards.device.type != "cuda":
        raise ValueError(f"nstep_rewards runs on cuda or cpu, not {rewards.device}")
    return _launch(rewards, terminals, indices, horizon, gamma)


nstep_rewards.launches = 0
