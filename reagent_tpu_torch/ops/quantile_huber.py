"""Pairwise quantile-Huber loss (K5): QR-DQN's loss and its gradient.

Replaces the TPU kernel ``reagent_tpu/ops/quantile_huber.py::
quantile_huber_loss`` (its ``pallas_call`` at :77); the plain version is the
counterpart of ``quantile_huber_loss_xla`` (:27-37), the formulation
``QRDQNTrainer.train_step`` writes inline.  With ``td_ij = target_i -
current_j``, ``tau_j = (j + 0.5) / N``, ``w_ij = |tau_j - 1{td_ij < 0}|`` and
``Huber_k(x) = 0.5 x^2`` where ``|x| < k``, else ``k (|x| - 0.5 k)``:

    loss = mean over [B, N, N] of w_ij * Huber_k(td_ij)

The CUDA source (``csrc/quantile_huber.cu``) computes the per-sample sums
``[B]`` (the mean over B stays a PyTorch call, as ``jnp.mean`` stands
outside the TPU kernel) by one of two routes of one kernel:

- **loss only**, where no gradient will be taken (grad mode off, or
  ``current`` without ``requires_grad``): the per-sample losses alone;
- **loss and gradient sums**, where it will: the same pass over the pairs
  also writes ``sums[b, j] = sum_i w_ij clip(td_ij, -k, k)`` as a float32
  ``[B, N]`` buffer, which the autograd function saves.  The backward is a
  second, small kernel that scales it:

      d per_sample[b] / d current[b, j] = -(1/N^2) sums[b, j]

The weight is a constant of the gradient and the target gets none, as the
trainer holds both under ``stop_gradient``.  No kernel forms the
``[B, N, N]`` tensor.  Inputs are float32 or bfloat16 (both the same), rows
may be strided; sums are float32 and the gradient comes back in the inputs'
type.  On this card the forward is bound by issued instructions (8 a pair
with the sums, 7 without), the scaling by bytes.

The TPU function's ``block_b``, ``interpret`` and ``use_kernel`` arguments
are TPU-side switches with no meaning here and are left out: a CUDA tensor
launches the kernels (or raises), a CPU tensor takes the plain version,
differentiated by autograd.
"""

from __future__ import annotations

import contextlib

import torch

from reagent_tpu_torch.utils.profiling import annotate

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


def quantile_huber_sums_reference(target: Tensor, current: Tensor, kappa: float) -> Tensor:
    """The gradient sums the forward's gradient route writes, in plain
    PyTorch: ``sums[b, j] = sum_i w_ij clip(td_ij, -k, k)``, float32 ``[B, N]``."""
    td, weight = _pairwise(target, current)
    return (weight * td.clamp(-kappa, kappa)).sum(dim=1)  # over target atoms


def quantile_huber_scale_reference(
    sums: Tensor, grad_per_sample: Tensor, dtype: torch.dtype
) -> Tensor:
    """The backward kernel in plain PyTorch: ``grad_current [B, N]`` in
    ``dtype`` from the saved ``sums`` and the incoming ``grad_per_sample [B]``."""
    N = sums.shape[1]
    scale = -grad_per_sample.to(torch.float32).reshape(-1, 1) / (N * N)
    return (scale * sums).to(dtype)


def quantile_huber_grad_reference(
    target: Tensor, current: Tensor, kappa: float, grad_per_sample: Tensor
) -> Tensor:
    """The gradient the two kernels compute, in plain PyTorch:
    ``grad_current [B, N]`` (in ``current``'s type) for the incoming
    ``grad_per_sample [B]``."""
    return quantile_huber_scale_reference(
        quantile_huber_sums_reference(target, current, kappa), grad_per_sample, current.dtype)


def takes_gradient_route(current: Tensor) -> bool:
    """Whether K5's forward also writes the gradient sums: only where autograd
    will ask for ``current``'s gradient.  (Decided before the autograd
    function runs: inside it, ``ctx.needs_input_grad`` reads True under
    ``torch.no_grad()`` for a ``current`` that requires grad.)"""
    return torch.is_grad_enabled() and current.requires_grad


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


def _raise_on(err: int, lib, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} failed: {lib.quantile_huber_error_string(err).decode()}")


def _launch_forward(target: Tensor, current: Tensor, kappa: float, sums: bool):
    """``(per_sample [B], sums [B, N] or None)``; ``sums`` picks the route."""
    bf16 = _check(target, current)
    B, N = target.shape
    dev = target.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    g = torch.empty((B, N), dtype=torch.float32, device=dev) if sums else None
    if B == 0 or N == 0:
        return out.zero_(), None if g is None else g.zero_()
    lib = _library(N)
    args = (target.data_ptr(), target.stride(0), current.data_ptr(), current.stride(0),
            bf16, B, N, float(kappa), out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if sums:
            err = lib.quantile_huber_forward_sums(*args, g.data_ptr(), stream)
        else:
            err = lib.quantile_huber_forward(*args, stream)
    _raise_on(err, lib, "quantile_huber_forward_sums" if sums else "quantile_huber_forward")
    quantile_huber_loss.launches += 1
    quantile_huber_loss.sums_launches += int(sums)
    return out, g


def _launch_scale(sums: Tensor, grad_per_sample: Tensor, dtype: torch.dtype) -> Tensor:
    B, N = sums.shape
    dev = sums.device
    if grad_per_sample.device != dev or grad_per_sample.dtype != torch.float32:
        raise TypeError(
            f"grad_per_sample must be float32 on {dev}; got {grad_per_sample.dtype} "
            f"on {grad_per_sample.device}")
    if tuple(grad_per_sample.shape) != (B,) or grad_per_sample.stride(0) < 0:
        raise ValueError(f"grad_per_sample must be [{B}], got {tuple(grad_per_sample.shape)}")
    grad = torch.empty((B, N), dtype=dtype, device=dev)
    if B == 0 or N == 0:
        return grad
    lib = _library(N)
    with torch.cuda.device(dev):
        err = lib.quantile_huber_scale(
            sums.data_ptr(), int(dtype == torch.bfloat16), B, N, grad_per_sample.data_ptr(),
            grad_per_sample.stride(0), grad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "quantile_huber_scale")
    quantile_huber_loss.backward_launches += 1
    return grad


class _QuantileHuberPerSample(torch.autograd.Function):
    """K5's gradient route on a CUDA tensor: the forward launch also writes
    the gradient sums, which the backward launch scales."""

    @staticmethod
    def forward(ctx, target: Tensor, current: Tensor, kappa: float) -> Tensor:
        per_sample, sums = _launch_forward(target, current, kappa, sums=True)
        ctx.save_for_backward(sums)
        ctx.dtype = current.dtype
        return per_sample

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_per_sample: Tensor):
        (sums,) = ctx.saved_tensors
        with annotate("reagent.k5"):
            return None, _launch_scale(sums, grad_per_sample, ctx.dtype), None


def quantile_huber_per_sample(target: Tensor, current: Tensor, kappa: float = 1.0) -> Tensor:
    """K5 without the final mean: per-sample losses ``[B]`` float32 (the TPU
    kernel's ``[B, 1]`` output), differentiable with respect to ``current``.

    A CUDA tensor launches the hand-written kernels (or raises): the
    gradient route where ``takes_gradient_route(current)``, else the loss
    only, with no ``[B, N]`` buffer.  A CPU tensor takes the plain version."""
    if target.requires_grad:
        raise ValueError(
            "the quantile-Huber target takes no gradient (the trainer holds it "
            "under stop_gradient); detach it")
    if target.device.type == "cpu":
        _check(target, current)
        return quantile_huber_per_sample_reference(target, current, kappa)
    if target.device.type != "cuda":
        raise ValueError(f"quantile_huber_loss runs on cuda or cpu, not {target.device}")
    if takes_gradient_route(current):
        return _QuantileHuberPerSample.apply(target, current, kappa)
    return _launch_forward(target, current, kappa, sums=False)[0]


def quantile_huber_loss(target_q: Tensor, current_q: Tensor, kappa: float = 1.0) -> Tensor:
    """K5: the mean quantile-Huber loss (a scalar) of target quantiles
    ``[B, N]`` against current quantiles ``[B, N]``.  On the card the
    forward and its mean are the span ``reagent.k5``, as is the backward."""
    with annotate("reagent.k5") if target_q.is_cuda else contextlib.nullcontext():
        return quantile_huber_per_sample(target_q, current_q, kappa).mean()


quantile_huber_loss.launches = 0  # forward launches, both routes
quantile_huber_loss.sums_launches = 0  # of them, on the gradient route
quantile_huber_loss.backward_launches = 0
