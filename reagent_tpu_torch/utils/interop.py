"""Carry weights and replay state between the JAX package's layouts and the
port's.

Numpy in, torch out (and back); no JAX import.  The flax tree of a
``FullyConnectedDQN`` is
``{'params': {'FullyConnectedNetwork_0': {'Dense_i': {'kernel': [in, out],
'bias': [out]}}}}``; the port's ``FullyConnectedDQN`` keeps ``nn.Linear``
weights ``[out, in]`` under ``net.layers.i``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping

import numpy as np
import torch

from reagent_tpu_torch.replay.circular import ReplayBufferState
from reagent_tpu_torch.replay.packed import PackedReplayBufferState
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainerState

_NET = "FullyConnectedNetwork_0"


def _dense_index(name: str) -> int:
    m = re.fullmatch(r"Dense_(\d+)", name)
    if m is None:
        raise ValueError(f"unexpected layer {name!r} in a FullyConnectedDQN tree")
    return int(m.group(1))


def q_network_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``FullyConnectedDQN`` params (numpy leaves) -> the port's
    ``FullyConnectedDQN`` state dict."""
    layers = params_np["params"][_NET]
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(layers, key=_dense_index):
        i = _dense_index(name)
        out[f"net.layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layers[name]["kernel"], np.float32).T))
        out[f"net.layers.{i}.bias"] = torch.from_numpy(
            np.array(layers[name]["bias"], np.float32))
    return out


def flax_from_q_network_state(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of ``q_network_state_from_flax`` (numpy leaves)."""
    layers = {}
    for key, t in state_dict.items():
        m = re.fullmatch(r"net\.layers\.(\d+)\.(weight|bias)", key)
        if m is None:
            raise ValueError(f"unexpected key {key!r} in a FullyConnectedDQN state dict")
        a = t.detach().cpu().numpy().astype(np.float32)
        entry = layers.setdefault(f"Dense_{m.group(1)}", {})
        if m.group(2) == "weight":
            entry["kernel"] = np.ascontiguousarray(a.T)
        else:
            entry["bias"] = a
    return {"params": {_NET: layers}}


def _scalar_i32(x, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)


def fused_state_from_arrays(
    W, b, Wt, bt, mW, mb, vW, vb, step, device="cpu"
) -> FusedDQNTrainerState:
    """The port's trainer state from a ``reagent_tpu`` ``FusedDQNTrainerState``
    whose leaves were turned into numpy (same [out, in] / [1, out] layout)."""

    def tensors(xs):
        return tuple(
            torch.tensor(np.asarray(x), dtype=torch.float32, device=device) for x in xs
        )

    return FusedDQNTrainerState(
        W=tensors(W), b=tensors(b), Wt=tensors(Wt), bt=tensors(bt),
        mW=tensors(mW), mb=tensors(mb), vW=tensors(vW), vb=tensors(vb),
        step=_scalar_i32(step, device),
    )


def packed_replay_state_from_arrays(
    rows, add_count, episode_len, device="cpu"
) -> PackedReplayBufferState:
    """The port's packed buffer state from a ``reagent_tpu``
    ``PackedReplayBufferState`` whose leaves were turned into numpy.  The row
    layout is the same, so rows are copied unchanged; the port's buffer must
    have been ``init``-ed with the same example transition."""
    return PackedReplayBufferState(
        rows=torch.tensor(np.asarray(rows, np.float32), device=device),
        add_count=_scalar_i32(add_count, device),
        episode_len=_scalar_i32(episode_len, device),
    )


def replay_state_from_arrays(
    store: Mapping, add_count, is_valid, episode_len, device="cpu"
) -> ReplayBufferState:
    """The port's circular buffer state from a ``reagent_tpu``
    ``ReplayBufferState`` whose leaves were turned into numpy (``store`` a
    dict of ``[capacity, ...]`` arrays; dtypes kept)."""
    return ReplayBufferState(
        store={k: torch.tensor(np.asarray(v), device=device) for k, v in store.items()},
        add_count=_scalar_i32(add_count, device),
        is_valid=torch.tensor(np.asarray(is_valid, bool), device=device),
        episode_len=_scalar_i32(episode_len, device),
    )


def state_to_arrays(state) -> Dict:
    """Any of the port's state dataclasses as a dict of numpy leaves (dicts
    of tensors stay dicts), field by field: the inverse of the carriers."""

    def leaf(v):
        if isinstance(v, dict):
            return {k: leaf(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(leaf(x) for x in v)
        return v.detach().cpu().numpy()

    return {f.name: leaf(getattr(state, f.name)) for f in dataclasses.fields(state)}
