"""Pairwise quantile-Huber loss (K5): QR-DQN's loss and its gradient.

Replaces the TPU kernel ``reagent_tpu/ops/quantile_huber.py::
quantile_huber_loss`` (its ``pallas_call`` at :77); the plain version is the
counterpart of ``quantile_huber_loss_xla`` (:27-37), the formulation
``QRDQNTrainer.train_step`` writes inline.  With ``td_ij = target_i -
current_j``, ``tau_j = (j + 0.5) / N`` and ``Huber_k(x) = 0.5 x^2`` where
``|x| < k``, else ``k (|x| - 0.5 k)``:

    loss = mean over [B, N, N] of |tau_j - 1{td_ij < 0}| * Huber_k(td_ij)

The CUDA source (``csrc/quantile_huber.cu``) holds two kernels: the forward,
which gives the per-sample sums ``[B]`` (the mean over B stays a PyTorch
call, as ``jnp.mean`` stands outside the TPU kernel), and a hand-written
backward, its own launch, which recomputes the pairs from the saved inputs:

    d per_sample[b] / d current[b, j]
        = -(1/N^2) sum_i |tau_j - 1{td_ij < 0}| * clip(td_ij, -k, k)

The weight is a constant of the gradient and the target gets none, as the
trainer holds both under ``stop_gradient``.  Neither kernel forms the
``[B, N, N]`` tensor.  Inputs are float32 or bfloat16 (both the same), rows
may be strided; sums are float32 and the gradient comes back in the inputs'
type.  On this card the work is bound by operations (12 per pair forward, 7
backward), not by its few bytes.

The TPU function's ``block_b``, ``interpret`` and ``use_kernel`` arguments
are TPU-side switches with no meaning here and are left out: a CUDA tensor
launches the kernels (or raises), a CPU tensor takes the plain version,
differentiated by autograd.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pairwise(target: Tensor, current: Tensor):
    """``(td, weight)`` as float32 ``[B, N_target, N_current]``."""
    N = target.shape[1]
    taus = (torch.arange(N, dtype=torch.float32, device=target.device) + 0.5) / N
    td = target.to(torch.float32)[:, :, None] - current.to(torch.float32)[:, None, :]
    weight = (taus[None, None, :] - (td.detach() < 0).to(torch.float32)).abs()
    return td, weight


def quantile_huber_per_sample_reference(
    target: Tensor, current: Tensor, kappa: float = 1.0
) -> Tensor:
    """Plain PyTorch version of K5's forward: per-sample losses ``[B]``."""
    quantile_huber_loss_reference.calls += 1
    N = target.shape[1]
    td, weight = _pairwise(target, current)
    a = td.abs()
    huber = torch.where(a < kappa, 0.5 * td * td, kappa * (a - 0.5 * kappa))
    return (huber * weight).sum(dim=(1, 2)) / (N * N)


def quantile_huber_loss_reference(
    target_q: Tensor, current_q: Tensor, kappa: float = 1.0
) -> Tensor:
    """Plain PyTorch version of K5 (the pairwise formulation), differentiable
    by autograd with respect to ``current_q``."""
    return quantile_huber_per_sample_reference(target_q, current_q, kappa).mean()


quantile_huber_loss_reference.calls = 0


def quantile_huber_grad_reference(
    target: Tensor, current: Tensor, kappa: float, grad_per_sample: Tensor
) -> Tensor:
    """The gradient the backward kernel computes, in plain PyTorch:
    ``grad_current [B, N]`` (in ``current``'s type) for the incoming
    ``grad_per_sample [B]``."""
    N = target.shape[1]
    td, weight = _pairwise(target, current)
    g = (weight * td.clamp(-kappa, kappa)).sum(dim=1)  # over target atoms
    scale = -grad_per_sample.to(torch.float32).reshape(-1, 1) / (N * N)
    return (scale * g).to(current.dtype)


def _check(target: Tensor, current: Tensor) -> int:
    """Raise on what the kernels do not take; returns the bf16 flag."""
    if target.ndim != 2 or target.shape != current.shape:
        raise ValueError(
            f"target and current must both be [B, N]; got {tuple(target.shape)} "
            f"and {tuple(current.shape)}")
    if current.device != target.device:
        raise ValueError(f"target is on {target.device}, current on {current.device}")
    if target.dtype != current.dtype or target.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            "target and current must both be float32 or both bfloat16; got "
            f"{target.dtype} and {current.dtype}")
    for name, t in (("target", target), ("current", current)):
        if t.shape[1] > 1 and t.stride(1) != 1 or t.stride(0) < 0:
            raise ValueError(
                f"{name} must have atom stride 1 and a non-negative row stride; "
                f"got strides {t.stride()}")
    return int(target.dtype == torch.bfloat16)


def _library(N: int):
    from reagent_tpu_torch.ops import _build

    lib = _build.load_library("quantile_huber")
    if N > lib.quantile_huber_max_atoms():
        raise ValueError(f"N = {N} atoms; the kernel takes at most {lib.quantile_huber_max_atoms()}")
    return lib


def _launch_forward(target: Tensor, current: Tensor, kappa: float) -> Tensor:
    bf16 = _check(target, current)
    B, N = target.shape
    dev = target.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return out.zero_()
    lib = _library(N)
    with torch.cuda.device(dev):
        err = lib.quantile_huber_forward(
            target.data_ptr(), target.stride(0), current.data_ptr(), current.stride(0),
            bf16, B, N, float(kappa), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"quantile_huber_forward failed: {lib.quantile_huber_error_string(err).decode()}")
    quantile_huber_loss.launches += 1
    return out


def _launch_backward(
    target: Tensor, current: Tensor, kappa: float, grad_per_sample: Tensor
) -> Tensor:
    bf16 = _check(target, current)
    B, N = target.shape
    dev = target.device
    if grad_per_sample.device != dev or grad_per_sample.dtype != torch.float32:
        raise TypeError(
            f"grad_per_sample must be float32 on {dev}; got {grad_per_sample.dtype} "
            f"on {grad_per_sample.device}")
    if tuple(grad_per_sample.shape) != (B,) or grad_per_sample.stride(0) < 0:
        raise ValueError(f"grad_per_sample must be [{B}], got {tuple(grad_per_sample.shape)}")
    grad = torch.empty((B, N), dtype=current.dtype, device=dev)
    if B == 0 or N == 0:
        return grad
    lib = _library(N)
    with torch.cuda.device(dev):
        err = lib.quantile_huber_backward(
            target.data_ptr(), target.stride(0), current.data_ptr(), current.stride(0),
            bf16, B, N, float(kappa), grad_per_sample.data_ptr(), grad_per_sample.stride(0),
            grad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"quantile_huber_backward failed: {lib.quantile_huber_error_string(err).decode()}")
    quantile_huber_loss.backward_launches += 1
    return grad


class _QuantileHuberPerSample(torch.autograd.Function):
    """K5 on a CUDA tensor: forward and backward are one kernel launch each."""

    @staticmethod
    def forward(ctx, target: Tensor, current: Tensor, kappa: float) -> Tensor:
        ctx.save_for_backward(target, current)
        ctx.kappa = kappa
        return _launch_forward(target, current, kappa)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_per_sample: Tensor):
        target, current = ctx.saved_tensors
        return None, _launch_backward(target, current, ctx.kappa, grad_per_sample), None


def quantile_huber_per_sample(target: Tensor, current: Tensor, kappa: float = 1.0) -> Tensor:
    """K5 without the final mean: per-sample losses ``[B]`` float32 (the TPU
    kernel's ``[B, 1]`` output), differentiable with respect to ``current``.

    A CUDA tensor launches the hand-written kernels (or raises); a CPU tensor
    takes the plain version."""
    if target.requires_grad:
        raise ValueError(
            "the quantile-Huber target takes no gradient (the trainer holds it "
            "under stop_gradient); detach it")
    if target.device.type == "cpu":
        _check(target, current)
        return quantile_huber_per_sample_reference(target, current, kappa)
    if target.device.type != "cuda":
        raise ValueError(f"quantile_huber_loss runs on cuda or cpu, not {target.device}")
    return _QuantileHuberPerSample.apply(target, current, kappa)


def quantile_huber_loss(target_q: Tensor, current_q: Tensor, kappa: float = 1.0) -> Tensor:
    """K5: the mean quantile-Huber loss (a scalar) of target quantiles
    ``[B, N]`` against current quantiles ``[B, N]``."""
    return quantile_huber_per_sample(target_q, current_q, kappa).mean()


quantile_huber_loss.launches = 0
quantile_huber_loss.backward_launches = 0
