"""Fully fused DQN update (K2): one call runs a whole training step.

Replaces the TPU kernel ``reagent_tpu/ops/fused_dqn.py::
make_fused_dqn_train_kernel`` (its ``pallas_call`` at :259), tensor interface.
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


@torch.no_grad()
def update_reference(
    lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations: Sequence[str], gamma: float, tau: float,
    double_q_learning: bool, b1: float, b2: float, act_grad,
) -> torch.Tensor:
    """The update in plain PyTorch with the analytic backward (shared by the
    K1 and K2 plain versions, which differ only in ``act_grad``)."""
    L, (W, b, Wt, bt, mW, mb, vW, vb) = _split8(params8)
    B = obs.shape[0]

    def fwd(x, Ws, bs):
        h, zs, hs = x, [], [x]
        for i in range(L):
            z = h @ Ws[i].T + bs[i]
            h = _act(activations[i], z)
            zs.append(z)
            hs.append(h)
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
        dWt = dz.T @ hs[i][:B]
        db = torch.sum(dz, dim=0, keepdim=True)
        if i > 0:
            dz = (dz @ W[i]) * act_grad(activations[i - 1], zs[i - 1][:B], hs[i][:B])
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


# -------------------------------------------------------- CUDA launch


def launch_cuda(
    entry: str, lr_t, eps_t, obs, nobs, act, rew, nt, mask, params8, *,
    activations, gamma, tau, double_q_learning, b1, b2,
) -> Tuple[torch.Tensor, int]:
    """Check the inputs, allocate metrics and workspace, and run one of the
    two C entries of ``csrc/fused_dqn.cu`` on the current stream.  Returns
    the metrics row and the number of CUDA kernels the update launched."""
    from reagent_tpu_torch.ops import _build

    L, groups = _split8(params8)
    B, D = obs.shape
    W = groups[0]
    dims = [D] + [w.shape[0] for w in W]
    A = dims[-1]
    if len(activations) != L:
        raise ValueError(f"{len(activations)} activations for {L} layers")
    unknown = [a for a in activations if a not in _ACT_CODES]
    if unknown:
        raise ValueError(f"unsupported activations {unknown}; supported: {sorted(_ACT_CODES)}")
    if activations[-1] not in ("linear", "identity"):
        raise ValueError("the fused update needs a linear output layer")
    want = {
        "obs": (B, D), "nobs": (B, D), "act": (B, A), "rew": (B, 1),
        "nt": (B, 1), "mask": (B, A), "lr_t": None, "eps_t": None,
    }
    named = dict(obs=obs, nobs=nobs, act=act, rew=rew, nt=nt, mask=mask,
                 lr_t=lr_t, eps_t=eps_t)
    for i in range(L):
        for g, name in enumerate(("W", "b", "Wt", "bt", "mW", "mb", "vW", "vb")):
            named[f"{name}{i}"] = groups[g][i]
            want[f"{name}{i}"] = (
                (dims[i + 1], dims[i]) if g % 2 == 0 else (1, dims[i + 1])
            )
    dev = obs.device
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, obs on {dev}")
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

    lib = _build.load_library()
    offline = entry == "fused_dqn_offline_update"
    c_dims = (ctypes.c_int * (L + 1))(*dims)
    c_acts = (ctypes.c_int * L)(*(_ACT_CODES[a] for a in activations))
    consts = np.array(
        [gamma, tau, 1.0 - tau, b1, 1.0 - b1, b2, 1.0 - b2, 2.0 / B], np.float32
    )
    c_consts = (ctypes.c_float * 8)(*consts.tolist())
    c_params = (ctypes.c_void_p * (8 * L))(*(p.data_ptr() for g in groups for p in g))
    n_ws = lib.fused_dqn_workspace_floats(L, c_dims, B, int(offline))
    if n_ws < 0:
        raise ValueError(f"{entry}: unsupported layer count {L} or batch {B}")
    with torch.cuda.device(dev):
        metrics = torch.empty((1, 4), dtype=torch.float32, device=dev)
        workspace = torch.empty((n_ws,), dtype=torch.float32, device=dev)
        n_launches = ctypes.c_int(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            L, c_dims, c_acts, B, int(bool(double_q_learning)), c_consts, c_params,
            obs.data_ptr(), nobs.data_ptr(), act.data_ptr(), rew.data_ptr(),
            nt.data_ptr(), mask.data_ptr(), lr_t.data_ptr(), eps_t.data_ptr(),
            metrics.data_ptr(), workspace.data_ptr(), ctypes.byref(n_launches), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} failed: {lib.fused_dqn_error_string(err).decode()}")
    return metrics, n_launches.value


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
