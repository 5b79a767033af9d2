"""Carry weights, optimizer state and replay state between the JAX package's
layouts and the port's.

Numpy in, torch out (and back); no JAX import.  The flax tree of a
``FullyConnectedDQN`` is
``{'params': {'FullyConnectedNetwork_0': {'Dense_i': {'kernel': [in, out],
'bias': [out]}}}}``; the port's ``FullyConnectedDQN`` keeps ``nn.Linear``
weights ``[out, in]`` under ``net.layers.i``.  A ``DuelingQNetwork``'s tree
has three such scopes, ``FullyConnectedNetwork_0/1/2``: the port's
``shared``, ``advantage`` and ``value``.  An optax moment tree has its
parameters' layout and is carried the same way.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from reagent_tpu_torch.optim import OptState
from reagent_tpu_torch.replay.circular import ReplayBufferState
from reagent_tpu_torch.replay.packed import PackedReplayBufferState
from reagent_tpu_torch.training.dqn_trainer import DQNTrainerState
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainerState
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainerState

_NET = "FullyConnectedNetwork_0"
# flax scope -> the port's submodule, by network
_SCOPES = {
    1: {_NET: "net"},
    3: {_NET: "shared", "FullyConnectedNetwork_1": "advantage",
        "FullyConnectedNetwork_2": "value"},
}


def _dense_index(name: str) -> int:
    m = re.fullmatch(r"Dense_(\d+)", name)
    if m is None:
        raise ValueError(f"unexpected layer {name!r} in a dense flax scope")
    return int(m.group(1))


def q_network_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``FullyConnectedDQN`` or ``DuelingQNetwork`` params (numpy
    leaves) -> the state dict of the port's module of the same name."""
    tree = params_np["params"]
    scopes = _SCOPES.get(len(tree))
    if scopes is None or set(tree) != set(scopes):
        raise ValueError(f"unexpected scopes {sorted(tree)} in a q-network tree")
    out: Dict[str, torch.Tensor] = {}
    for scope, prefix in scopes.items():
        layers = tree[scope]
        for name in sorted(layers, key=_dense_index):
            i = _dense_index(name)
            out[f"{prefix}.layers.{i}.weight"] = torch.from_numpy(
                np.array(np.asarray(layers[name]["kernel"], np.float32).T, order="C"))
            out[f"{prefix}.layers.{i}.bias"] = torch.from_numpy(
                np.array(layers[name]["bias"], np.float32))
    return out


def flax_from_q_network_state(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of ``q_network_state_from_flax`` (numpy leaves)."""
    prefixes = {k.split(".")[0] for k in state_dict}
    scopes = next((m for m in _SCOPES.values() if set(m.values()) == prefixes), None)
    if scopes is None:
        raise ValueError(f"unexpected submodules {sorted(prefixes)} in a q-network state dict")
    scope_of = {prefix: scope for scope, prefix in scopes.items()}
    tree: Dict = {scope: {} for scope in scopes}
    for key, t in state_dict.items():
        m = re.fullmatch(r"(\w+)\.layers\.(\d+)\.(weight|bias)", key)
        if m is None:
            raise ValueError(f"unexpected key {key!r} in a q-network state dict")
        a = t.detach().cpu().numpy().astype(np.float32)
        entry = tree[scope_of[m.group(1)]].setdefault(f"Dense_{m.group(2)}", {})
        if m.group(3) == "weight":
            entry["kernel"] = np.ascontiguousarray(a.T)
        else:
            entry["bias"] = a
    return {"params": tree}


def _params_on(params_np: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in q_network_state_from_flax(params_np).items()}


def opt_state_from_arrays(
    count, mu: Optional[Mapping] = None, nu: Optional[Mapping] = None,
    nu_max: Optional[Mapping] = None, trace: Optional[Mapping] = None, device="cpu",
) -> OptState:
    """The port's optimizer state from the fields of an optax
    ``ScaleByAdamState`` / ``ScaleByAmsgradState`` (``count``, ``mu``, ``nu``,
    ``nu_max``) or ``TraceState`` (``trace``), each moment a flax tree with
    numpy leaves."""
    def tree(x):
        return None if x is None else _params_on(x, device)

    return OptState(count=_scalar_i32(count, device), mu=tree(mu), nu=tree(nu),
                    nu_max=tree(nu_max), trace=tree(trace))


def _unfused_state(cls, q_params, q_target_params, opt_state, step, device):
    return cls(
        q_params=_params_on(q_params, device),
        q_target_params=_params_on(q_target_params, device),
        opt_state=opt_state, step=_scalar_i32(step, device))


def qrdqn_state_from_arrays(
    q_params: Mapping, q_target_params: Mapping, opt_state: OptState, step, device="cpu"
) -> QRDQNTrainerState:
    """The port's ``QRDQNTrainerState`` from a ``reagent_tpu`` one: flax
    parameter trees with numpy leaves, ``opt_state`` from
    ``opt_state_from_arrays``."""
    return _unfused_state(QRDQNTrainerState, q_params, q_target_params, opt_state, step, device)


def dqn_state_from_arrays(
    q_params: Mapping, q_target_params: Mapping, opt_state: OptState, step, device="cpu",
    *, reward_params: Optional[Mapping] = None, reward_opt_state: Optional[OptState] = None,
    cpe_params: Optional[Mapping] = None, cpe_target_params: Optional[Mapping] = None,
    cpe_opt_state: Optional[OptState] = None,
) -> DQNTrainerState:
    """The port's ``DQNTrainerState``, as ``qrdqn_state_from_arrays``; the
    CPE heads' parameter trees (flax, numpy leaves) and optimizer states
    (from ``opt_state_from_arrays``) where the JAX state has them."""
    state = _unfused_state(DQNTrainerState, q_params, q_target_params, opt_state, step, device)

    def tree(x):
        return None if x is None else _params_on(x, device)

    return dataclasses.replace(
        state, reward_params=tree(reward_params), reward_opt_state=reward_opt_state,
        cpe_params=tree(cpe_params), cpe_target_params=tree(cpe_target_params),
        cpe_opt_state=cpe_opt_state)


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
        if v is None:
            return None
        if dataclasses.is_dataclass(v):
            return state_to_arrays(v)
        if isinstance(v, dict):
            return {k: leaf(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(leaf(x) for x in v)
        return v.detach().cpu().numpy()

    return {f.name: leaf(getattr(state, f.name)) for f in dataclasses.fields(state)}
