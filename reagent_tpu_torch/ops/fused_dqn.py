"""Fully fused DQN update (K2): one call runs a whole training step.

Replaces the TPU kernel ``reagent_tpu/ops/fused_dqn.py::
make_fused_dqn_train_kernel`` (its ``pallas_call`` at :259): the tensor
interface (``fused_dqn_update``) and the packed interface
(``fused_dqn_update_packed``, :164-176), which reads raw ``PackedReplayBuffer``
rows: the CUDA GEMMs take the observation columns through the rows' stride
and the TD-row kernel reads the action, reward and terminal columns, so the
batch is never copied out of the rows.

One update is: online forward over ``[obs; nobs]``, target forward over
``nobs``, masked first-index-argmax TD target (double-Q or target argmax),
mse loss, analytic backward, Adam with the bias correction folded into the
per-step scalars ``lr_t``/``eps_t``, the polyak target blend, and the metrics
row ``[td_loss, mean(q), mean(q_taken), mean(r)]``:

    upd = lr_t * m' / (sqrt(v') + eps_t),
    lr_t = lr*sqrt(1-b2^t)/(1-b1^t),  eps_t = eps*sqrt(1-b2^t).

Weights are ``[out, in]`` (``nn.Linear``'s layout, and the TPU kernel's),
biases ``[1, out]``; ``params8`` is the flat list W[], b[], W_tgt[], b_tgt[],
mW[], mb[], vW[], vb[].  The update writes ``params8`` IN PLACE (the JAX
trainer donates them) and returns the ``[1, 4]`` metrics row.

On this card (H100, f32 without tensor cores) the update is bound by
operations: about 5 * B * sum(in*out) multiply-adds against a few MB of
parameter and batch traffic.  The CUDA design (``csrc/fused_dqn.cu``) runs it
as a fixed sequence of launches on the current stream: shared-memory-tiled
GEMMs with the bias/activation or activation-gradient epilogue fused in, one
row-wise TD kernel, weight gradients as split-K partial sums reduced in fixed
order inside the Adam+polyak kernel (no atomics, so results repeat run to
run).  K2 passes the whole batch as one split-K chunk, the way the TPU kernel
holds it in one VMEM block; K1 (``fused_dqn_offline.py``) splits it.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

ACTION_NOT_POSSIBLE_VAL = -1e9
_BIG_I32 = 2**30
_ACT_CODES = {"linear": 0, "identity": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}


def _act(name: str, z: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.clamp(z, min=0.0)
    if name == "leaky_relu":
        return torch.where(z > 0, z, 0.01 * z)
    if name == "tanh":
        return torch.tanh(z)
    if name in ("linear", "identity", None):
        return z
    raise ValueError(f"unsupported activation {name!r}")


def _act_grad(name: str, z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Activation derivative from the pre-activation ``z`` (K2's form)."""
    if name == "relu":
        return (z > 0).to(torch.float32)
    if name == "leaky_relu":
        return torch.where(z > 0, 1.0, 0.01)
    if name == "tanh":
        return 1.0 - h * h
    return torch.ones_like(z)


def _act_grad_from_h(name: str, z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Activation derivative from the output ``h`` alone (K1's form): relu and
    leaky_relu keep the sign of ``z``, tanh's derivative is 1-h^2."""
    if name == "relu":
        return (h > 0).to(torch.float32)
    if name == "leaky_relu":
        return torch.where(h > 0, 1.0, 0.01)
    if name == "tanh":
        return 1.0 - h * h
    if name in ("linear", "identity", None):
        return torch.ones_like(h)
    raise ValueError(f"unsupported activation {name!r}")


def _first_argmax_onehot(q: torch.Tensor) -> torch.Tensor:
    """One-hot of the FIRST max index per row (ties -> lowest index)."""
    mx = torch.amax(q, dim=1, keepdim=True)
    iota = torch.arange(q.shape[1], device=q.device).expand_as(q)
    idx = torch.amin(torch.where(q >= mx, iota, _BIG_I32), dim=1, keepdim=True)
    return (iota == idx).to(torch.float32)


# --------------------------------------------------------------- layouts


def extract_mlp_layout(q_network: nn.Module) -> Tuple[List[nn.Linear], List[Tuple[int, int]]]:
    """The network's ``nn.Linear`` layers in order and dims [(in_i, out_i)].

    Raises if the module holds parameters outside those layers (not a plain
    dense MLP)."""
    linears = [m for m in q_network.modules() if isinstance(m, nn.Linear)]
    n_params = sum(1 for _ in q_network.parameters())
    if not linears or n_params != 2 * len(linears) or any(l.bias is None for l in linears):
        raise ValueError("q-network is not a plain dense MLP")
    return linears, [(l.in_features, l.out_features) for l in linears]


def params_to_kernel_layout(q_network: nn.Module):
    """Module weights -> (W list [out, in], bias list [1, out]), as copies."""
    linears, _ = extract_mlp_layout(q_network)
    Ws = [l.weight.detach().to(torch.float32).clone() for l in linears]
    bs = [l.bias.detach().to(torch.float32).reshape(1, -1).clone() for l in linears]
    return Ws, bs


def mlp_forward_transposed(x: torch.Tensor, Ws, bs, activations) -> torch.Tensor:
    """Plain forward with [out, in] weights (for policy scoring)."""
    h = x
    for w, b, a in zip(Ws, bs, activations):
        h = _act(a, h @ w.T + b)
    return h


# -------------------------------------------------------- plain version


def _split8(params8):
    L = len(params8) // 8
    if len(params8) != 8 * L or L == 0:
        raise ValueError(f"params8 must hold 8*L tensors, got {len(params8)}")
    return L, [list(params8[i * L:(i + 1) * L]) for i in range(8)]


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_kernel_dtype(name: str, dtype) -> None:
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} must be torch.float32 or torch.bfloat16, got {dtype!r}")


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32 (float32: unchanged)."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


@torch.no_grad()
def update_reference(
    lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, b1: float, b2: float, act_grad,
    matmul_dtype: torch.dtype = torch.float32,
    save_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The update in plain PyTorch with the analytic backward (shared by the
    K1 and K2 plain versions, which differ only in ``act_grad``).

    K1's options, with the rounding points of the TPU kernel
    (``reagent_tpu/ops/fused_dqn_offline.py:96-100, :138-143, :179-183``):
    every product rounds both operands to ``matmul_dtype`` and is taken in
    float32 (a product of two bfloat16 values is exact in float32, so only
    the order of the sum differs from a tensor-core product); the saved layer
    outputs, the observation among them, are kept in ``save_dtype``, and the
    weight and activation gradients read those rounded copies; the bias
    gradient is the sum of the unrounded ``dz``; ``q`` is never rounded."""
    L, (W, b, Wt, bt, mW, mb, vW, vb) = _split8(params8)
    B = obs.shape[0]

    def mm(x, w):
        return _round_to(x, matmul_dtype) @ _round_to(w, matmul_dtype)

    def fwd(x, Ws, bs):
        h, zs, hs = x, [], [_round_to(x, save_dtype)]
        for i in range(L):
            z = mm(h, Ws[i].T) + bs[i]
            h = _act(activations[i], z)
            zs.append(z)
            hs.append(_round_to(h, save_dtype))
        return h, zs, hs

    penalty = ACTION_NOT_POSSIBLE_VAL * (1.0 - mask)
    q2, zs, hs = fwd(torch.cat([obs, nobs], dim=0), W, b)
    q = q2[:B]
    next_q_t = fwd(nobs, Wt, bt)[0] + penalty
    sel = _first_argmax_onehot(q2[B:] + penalty if double_q_learning else next_q_t)
    next_q_sel = torch.sum(next_q_t * sel, dim=1, keepdim=True)
    y = rew + gamma * next_q_sel * nt
    q_taken = torch.sum(q * act, dim=1, keepdim=True)
    err = q_taken - y
    metrics = torch.stack(
        [torch.mean(err * err), torch.mean(q), torch.mean(q_taken), torch.mean(rew)]
    ).reshape(1, 4)

    # Backward over the obs half only: the TPU kernels run it over [2B] rows
    # with a zero dL/dq on the nobs half, and zero rows add nothing.
    dz = (2.0 / B) * err * act
    for i in range(L - 1, -1, -1):
        dWt = mm(dz.T, hs[i][:B])
        db = torch.sum(dz, dim=0, keepdim=True)
        if i > 0:
            dz = mm(dz, W[i]) * act_grad(activations[i - 1], zs[i - 1][:B], hs[i][:B])
        for p, pt, m, v, g in ((W[i], Wt[i], mW[i], vW[i], dWt), (b[i], bt[i], mb[i], vb[i], db)):
            m_n = b1 * m + (1.0 - b1) * g
            v_n = b2 * v + (1.0 - b2) * g * g
            p_n = p - lr_t * m_n / (torch.sqrt(v_n) + eps_t)
            m.copy_(m_n)
            v.copy_(v_n)
            p.copy_(p_n)
            pt.copy_(tau * p_n + (1.0 - tau) * pt)
    return metrics


def fused_dqn_update_reference(
    lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, b1: float = 0.9, b2: float = 0.999,
) -> torch.Tensor:
    """Plain PyTorch version of K2 (activation gradients from ``z``)."""
    fused_dqn_update_reference.calls += 1
    return update_reference(
        lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8,
        activations=activations, gamma=gamma, tau=tau,
        double_q_learning=double_q_learning, b1=b1, b2=b2, act_grad=_act_grad,
    )


fused_dqn_update_reference.calls = 0


# -------------------------------------------------------- packed interface


def _unpack_rows(rows, next_rows, cols: Sequence[int], D: int, A: int):
    """The tensor interface's batch from raw ``PackedReplayBuffer`` rows, as
    the TPU kernel's packed interface reads them (``reagent_tpu/ops/
    fused_dqn.py:164-176``): observation columns, the action one-hot as
    ``|a - j| < 0.5``, ``nt = 1 - terminal`` and an all-ones mask."""
    obs_col, act_col, rew_col, term_col = cols
    B = rows.shape[0]
    iota = torch.arange(A, device=rows.device, dtype=torch.float32)
    act = (torch.abs(iota - rows[:, act_col:act_col + 1]) < 0.5).to(torch.float32)
    return (
        rows[:, obs_col:obs_col + D], next_rows[:, obs_col:obs_col + D], act,
        rows[:, rew_col:rew_col + 1], 1.0 - rows[:, term_col:term_col + 1],
        torch.ones((B, A), dtype=torch.float32, device=rows.device),
    )


def fused_dqn_update_packed_reference(
    lr_t, eps_t, rows, next_rows, params8, *, cols: Sequence[int],
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, b1: float = 0.9, b2: float = 0.999,
) -> torch.Tensor:
    """Plain PyTorch version of K2's packed interface: unpack the columns and
    run the tensor update with an all-ones mask (``-1e9 * (1 - 1)`` is
    exactly 0, as the packed TPU kernel, which has no mask, computes)."""
    fused_dqn_update_packed_reference.calls += 1
    L, (W, *_rest) = _split8(params8)
    batch = _unpack_rows(rows, next_rows, cols, W[0].shape[1], W[-1].shape[0])
    return update_reference(
        lr_t, eps_t, *batch, params8, activations=activations, gamma=gamma,
        tau=tau, double_q_learning=double_q_learning, b1=b1, b2=b2,
        act_grad=_act_grad,
    )


fused_dqn_update_packed_reference.calls = 0


# -------------------------------------------------------- CUDA launch


def _check_tensors(named, want, dev) -> None:
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the batch on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape = want[name]
        if shape is None:
            if t.numel() != 1:
                raise ValueError(f"{name} must hold one value, got {tuple(t.shape)}")
        elif tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _check_params(lr_t, eps_t, params8, activations, D):
    """Layer dims, the params8 groups, and the named tensors with the shapes
    the C entries expect (weights [out, in], biases [1, out])."""
    L, groups = _split8(params8)
    dims = [D] + [w.shape[0] for w in groups[0]]
    if len(activations) != L:
        raise ValueError(f"{len(activations)} activations for {L} layers")
    unknown = [a for a in activations if a not in _ACT_CODES]
    if unknown:
        raise ValueError(f"unsupported activations {unknown}; supported: {sorted(_ACT_CODES)}")
    if activations[-1] not in ("linear", "identity"):
        raise ValueError("the fused update needs a linear output layer")
    named = {"lr_t": lr_t, "eps_t": eps_t}
    want = {"lr_t": None, "eps_t": None}
    for i in range(L):
        for g, name in enumerate(("W", "b", "Wt", "bt", "mW", "mb", "vW", "vb")):
            named[f"{name}{i}"] = groups[g][i]
            want[f"{name}{i}"] = (
                (dims[i + 1], dims[i]) if g % 2 == 0 else (1, dims[i + 1])
            )
    return L, groups, dims, named, want


def _run_entry(entry, dev, B, L, groups, dims, batch_args, lr_t, eps_t, *,
               activations, gamma, tau, double_q_learning, b1, b2, precision=()):
    """Allocate metrics and workspace and call one C entry of
    ``csrc/fused_dqn.cu`` on the current stream; returns the metrics row and
    the number of CUDA kernels the update launched.  ``precision`` = the ints
    ``(matmul_bf16, save_bf16)`` for the entry that takes K1's options."""
    from reagent_tpu_torch.ops import _build

    lib = _build.load_library()
    offline = entry.startswith("fused_dqn_offline_update")
    save_bf16 = precision[1] if precision else 0
    c_dims = (ctypes.c_int * (L + 1))(*dims)
    c_acts = (ctypes.c_int * L)(*(_ACT_CODES[a] for a in activations))
    consts = np.array(
        [gamma, tau, 1.0 - tau, b1, 1.0 - b1, b2, 1.0 - b2, 2.0 / B], np.float32
    )
    c_consts = (ctypes.c_float * 8)(*consts.tolist())
    c_params = (ctypes.c_void_p * (8 * L))(*(p.data_ptr() for g in groups for p in g))
    n_ws = lib.fused_dqn_workspace_floats(L, c_dims, B, int(offline), save_bf16)
    if n_ws < 0:
        raise ValueError(f"{entry}: unsupported layer count {L} or batch {B}")
    with torch.cuda.device(dev):
        metrics = torch.empty((1, 4), dtype=torch.float32, device=dev)
        workspace = torch.empty((n_ws,), dtype=torch.float32, device=dev)
        n_launches = ctypes.c_int(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            L, c_dims, c_acts, B, int(bool(double_q_learning)), *precision,
            c_consts, c_params, *batch_args, lr_t.data_ptr(), eps_t.data_ptr(),
            metrics.data_ptr(), workspace.data_ptr(), ctypes.byref(n_launches), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} failed: {lib.fused_dqn_error_string(err).decode()}")
    return metrics, n_launches.value


def launch_cuda(
    entry: str, lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations, gamma, tau, double_q_learning, b1, b2, precision=(),
) -> Tuple[torch.Tensor, int]:
    """Check the inputs and run one of the tensor-interface C entries
    (``fused_dqn_update``, ``fused_dqn_offline_update`` and, with
    ``precision``, ``fused_dqn_offline_update_bf16``)."""
    B, D = obs.shape
    L, groups, dims, named, want = _check_params(lr_t, eps_t, params8, activations, D)
    A = dims[-1]
    named.update(obs=obs, nobs=nobs, act=act, rew=rew, nt=nt, mask=mask)
    want.update(obs=(B, D), nobs=(B, D), act=(B, A), rew=(B, 1), nt=(B, 1), mask=(B, A))
    _check_tensors(named, want, obs.device)
    return _run_entry(
        entry, obs.device, B, L, groups, dims,
        [t.data_ptr() for t in (obs, nobs, act, rew, nt, mask)], lr_t, eps_t,
        activations=activations, gamma=gamma, tau=tau,
        double_q_learning=double_q_learning, b1=b1, b2=b2, precision=precision)


def launch_cuda_packed(
    lr_t, eps_t, rows, next_rows, params8, *, cols, activations, gamma, tau,
    double_q_learning, b1, b2,
) -> Tuple[torch.Tensor, int]:
    """Check the inputs and run the C entry ``fused_dqn_update_packed``, which
    reads the observation, action, reward and terminal columns of ``rows`` /
    ``next_rows`` [B, row_width] in place."""
    if rows.ndim != 2:
        raise ValueError(f"rows must be [B, row_width], got {tuple(rows.shape)}")
    B, width = rows.shape
    D = params8[0].shape[1]
    L, groups, dims, named, want = _check_params(lr_t, eps_t, params8, activations, D)
    named.update(rows=rows, next_rows=next_rows)
    want.update(rows=(B, width), next_rows=(B, width))
    _check_tensors(named, want, rows.device)
    cols = tuple(int(c) for c in cols)
    if (len(cols) != 4 or min(cols) < 0 or cols[0] + D > width
            or max(cols[1:]) >= width):
        raise ValueError(
            f"cols {cols} (obs, action, reward, terminal) do not fit rows of "
            f"width {width} with {D} observation columns")
    c_cols = (ctypes.c_int * 4)(*cols)
    return _run_entry(
        "fused_dqn_update_packed", rows.device, B, L, groups, dims,
        [rows.data_ptr(), next_rows.data_ptr(), width, c_cols], lr_t, eps_t,
        activations=activations, gamma=gamma, tau=tau,
        double_q_learning=double_q_learning, b1=b1, b2=b2)


def fused_dqn_update(
    lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, b1: float = 0.9, b2: float = 0.999,
) -> torch.Tensor:
    """K2: one DQN update in place on ``params8``; returns metrics [1, 4].

    A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
    takes the plain version."""
    kw = dict(activations=activations, gamma=gamma, tau=tau,
              double_q_learning=double_q_learning, b1=b1, b2=b2)
    if obs.device.type == "cpu":
        return fused_dqn_update_reference(
            lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, **kw)
    if obs.device.type != "cuda":
        raise ValueError(f"fused_dqn_update runs on cuda or cpu, not {obs.device}")
    metrics, fused_dqn_update.kernels_per_update = launch_cuda(
        "fused_dqn_update", lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, **kw)
    fused_dqn_update.launches += 1
    return metrics


fused_dqn_update.launches = 0
fused_dqn_update.kernels_per_update = None  # CUDA kernels in the last update


def fused_dqn_update_packed(
    lr_t, eps_t, rows, next_rows, params8, *, cols: Sequence[int],
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, b1: float = 0.9, b2: float = 0.999,
) -> torch.Tensor:
    """K2's packed interface: one DQN update straight from gathered replay
    rows ``rows`` / ``next_rows`` [B, row_width] (``cols`` = the observation,
    action, reward and terminal columns); every next action is possible.
    Updates ``params8`` in place and returns metrics [1, 4].

    A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
    takes the plain version."""
    kw = dict(cols=cols, activations=activations, gamma=gamma, tau=tau,
              double_q_learning=double_q_learning, b1=b1, b2=b2)
    if rows.device.type == "cpu":
        return fused_dqn_update_packed_reference(
            lr_t, eps_t, rows, next_rows, params8, **kw)
    if rows.device.type != "cuda":
        raise ValueError(f"fused_dqn_update_packed runs on cuda or cpu, not {rows.device}")
    metrics, fused_dqn_update_packed.kernels_per_update = launch_cuda_packed(
        lr_t, eps_t, rows, next_rows, params8, **kw)
    fused_dqn_update_packed.launches += 1
    return metrics


fused_dqn_update_packed.launches = 0
fused_dqn_update_packed.kernels_per_update = None
