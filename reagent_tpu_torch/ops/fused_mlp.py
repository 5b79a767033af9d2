"""Fused small-MLP forward (K3): a dense MLP's forward in hand-written kernels.

Replaces the TPU kernel ``reagent_tpu/ops/fused_mlp.py::fused_mlp_forward``
(its ``pallas_call`` at :75), with its signature: ``weights`` is
``[(W_i [d_i, d_{i+1}], b_i [d_{i+1}]), ...]`` and one activation per layer
(relu, leaky_relu with slope 0.01, tanh, linear).  It scores policies (the
act step of both online loops, ``FusedDQNTrainer.q_values``,
``gym/policies/scorers.py::discrete_dqn_scorer``) and runs the evaluation,
OPE, imitation and surrogate forwards.

The CUDA kernels (``csrc/fused_mlp.cu``) take each weight's two strides, so
a caller holding ``[out, in]`` weights (``nn.Linear``, the trainer state)
passes ``W.T`` views with no copy.  Two routes, which
``takes_resident_route`` names:

* resident, one CUDA kernel a call: where the whole net fits in a block's
  shared memory (the act step's nets).  Their work is nanoseconds of this
  card's memory and arithmetic; the launch and the latency of the loads
  are the cost, so each block of up to 16 rows issues every load of the
  launch (x, all weights and biases) at its start and each layer waits only
  for its own.
* streamed, L CUDA kernels a call, one a layer: larger nets (0.5-1 MB of
  weights).  f32 fmas bound them at thousands of rows, load and launch
  latency at tens, so each layer is a register-blocked tile product with
  its bias and activation fused, each weight tile serving a whole row tile,
  and the tile is picked from the layer's shape so that small batches
  spread over every SM.  Hidden activations pass through a workspace this
  wrapper allocates.

Both routes sum every output in the same order (fmaf over k ascending,
then the bias), so results do not depend on the route or the tile.
``block_b`` is the TPU kernel's batch tile: it caps the resident route's
tile of at most 16 rows from above; results do not depend on it.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch import nn

from reagent_tpu_torch.ops.fused_dqn import _ACT_CODES, _act, extract_mlp_layout

MAX_TILE_ROWS = 16  # csrc/fused_mlp.cu


def mlp_weight_list(q_network: nn.Module) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """A dense MLP's ``nn.Linear`` layers as K3's ``[(W [in, out], b [out])]``
    (transposed views of the module's weights: no copy); raises for a net
    with a norm or a skip connection."""
    linears, _ = extract_mlp_layout(q_network)
    return [(l.weight.detach().T, l.bias.detach()) for l in linears]


def fused_mlp_forward_reference(x, weights, activations) -> torch.Tensor:
    """Plain PyTorch version of K3.  Each product is taken on a contiguous
    ``[in, out]`` weight, so a ``W.T`` view scores bit for bit like its
    contiguous copy (the CPU's BLAS sums a transposed operand in another
    order)."""
    fused_mlp_forward_reference.calls += 1
    h = x.to(torch.float32)
    for (w, b), a in zip(weights, activations):
        h = _act(a, h @ w.contiguous() + b)
    return h


fused_mlp_forward_reference.calls = 0


def _tile_rows(block_b: int, B: int) -> int:
    return max(1, min(int(block_b), MAX_TILE_ROWS, B))


def takes_resident_route(B: int, weights, block_b: int = 256) -> bool:
    """Whether a call at B rows holds these weights in shared memory in one
    CUDA kernel (the resident route) or runs one tile product a layer (the
    streamed route).  Asks the built library (on the machine with the card)."""
    from reagent_tpu_torch.ops import _build

    L = len(weights)
    dims = [weights[0][0].shape[0]] + [w.shape[1] for w, _ in weights]
    strides = [s for w, _ in weights for s in w.stride()]
    route = _build.load_library("fused_mlp").fused_mlp_resident(
        L, (ctypes.c_int * (L + 1))(*dims), (ctypes.c_longlong * (2 * L))(*strides),
        B, _tile_rows(block_b, B))
    if route < 0:
        raise ValueError(f"invalid net {dims} at B={B}")
    return route == 1


def _launch(x, weights, activations, block_b) -> torch.Tensor:
    from reagent_tpu_torch.ops import _build

    dev = x.device
    if x.ndim != 2:
        raise ValueError(f"x must be [B, D], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    unknown = [a for a in activations if a not in _ACT_CODES]
    if unknown:
        raise ValueError(f"unsupported activations {unknown}; supported: {sorted(_ACT_CODES)}")
    B = x.shape[0]
    dims = [x.shape[1]]
    strides = []
    for i, (w, b) in enumerate(weights):
        for name, t in ((f"W{i}", w), (f"b{i}", b)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, x on {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
        if w.ndim != 2 or w.shape[0] != dims[-1] or min(w.stride()) < 1:
            raise ValueError(
                f"W{i} has shape {tuple(w.shape)} (strides {w.stride()}); "
                f"expected [{dims[-1]}, out] with positive strides")
        if tuple(b.shape) != (w.shape[1],) or not b.is_contiguous():
            raise ValueError(f"b{i} must be contiguous [{w.shape[1]}], got {tuple(b.shape)}")
        dims.append(w.shape[1])
        strides.extend(w.stride())
    L = len(weights)
    y = torch.empty((B, dims[-1]), dtype=torch.float32, device=dev)
    if B == 0:
        return y
    lib = _build.load_library("fused_mlp")
    tile = _tile_rows(block_b, B)
    c_dims = (ctypes.c_int * (L + 1))(*dims)
    c_strides = (ctypes.c_longlong * (2 * L))(*strides)
    # the streamed route's hidden activations; none on the resident route
    ws_floats = lib.fused_mlp_workspace_floats(L, c_dims, c_strides, B, tile)
    if ws_floats < 0:
        raise ValueError(f"invalid net {dims} at B={B}")
    ws = torch.empty(ws_floats, dtype=torch.float32, device=dev) if ws_floats else None
    with torch.cuda.device(dev):
        err = lib.fused_mlp_forward(
            L, c_dims,
            (ctypes.c_int * L)(*(_ACT_CODES[a] for a in activations)),
            (ctypes.c_void_p * L)(*(w.data_ptr() for w, _ in weights)),
            c_strides,
            (ctypes.c_void_p * L)(*(b.data_ptr() for _, b in weights)),
            x.data_ptr(), B, tile, y.data_ptr(), None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp_forward failed: {lib.fused_mlp_error_string(err).decode()}")
    fused_mlp_forward.launches += 1
    return y


def fused_mlp_forward(
    x: torch.Tensor,
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    activations: Sequence[str],
    block_b: int = 256,
) -> torch.Tensor:
    """K3: ``y = MLP(x)``; x [B, d_0] -> [B, d_L], one CUDA kernel a call on
    the resident route, one a layer on the streamed route.

    A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
    takes the plain version."""
    if len(weights) != len(activations):
        raise ValueError(f"{len(activations)} activations for {len(weights)} layers")
    if block_b < 1:
        raise ValueError(f"block_b must be positive, got {block_b}")
    if x.device.type == "cpu":
        return fused_mlp_forward_reference(x, weights, activations)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_forward runs on cuda or cpu, not {x.device}")
    return _launch(x, weights, activations, block_b)


fused_mlp_forward.launches = 0
