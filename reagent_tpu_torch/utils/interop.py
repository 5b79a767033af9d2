"""Carry weights between the JAX package's layouts and the port's.

Numpy in, torch out (and back); no JAX import.  The flax tree of a
``FullyConnectedDQN`` is
``{'params': {'FullyConnectedNetwork_0': {'Dense_i': {'kernel': [in, out],
'bias': [out]}}}}``; the port's ``FullyConnectedDQN`` keeps ``nn.Linear``
weights ``[out, in]`` under ``net.layers.i``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

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
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
    )
