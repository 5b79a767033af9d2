"""Carry weights, optimizer state and replay state between the JAX package's
layouts and the port's.

Numpy in, torch out (and back); no JAX import.  The flax tree of a
``FullyConnectedDQN`` is
``{'params': {'FullyConnectedNetwork_0': {'Dense_i': {'kernel': [in, out],
'bias': [out]}}}}``; the port's ``FullyConnectedDQN`` keeps ``nn.Linear``
weights ``[out, in]`` under ``net.layers.i``.  The critic, the value net and
the deterministic and Dirichlet actors have the same one scope; the gaussian
actor's is ``fc``; each is the port's ``net``.  A ``DuelingQNetwork``'s tree
has three such scopes, ``FullyConnectedNetwork_0/1/2``: the port's
``shared``, ``advantage`` and ``value``; a ``ParametricDuelingQNetwork``'s
three are its ``state_emb``, ``value`` and ``advantage``
(``PARAMETRIC_DUELING_SCOPES``, passed as ``scopes``: the scope names alone
do not tell the two apart).  An optax moment tree has its
parameters' layout and is carried the same way; SAC's scalar log-alpha and
its moments are carried under the name ``log_alpha``.
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
from reagent_tpu_torch.training.c51_trainer import C51TrainerState
from reagent_tpu_torch.training.discrete_crr_trainer import CRRTrainerState
from reagent_tpu_torch.training.dqn_trainer import DQNTrainerState
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainerState
from reagent_tpu_torch.training.parametric_dqn_trainer import ParametricDQNTrainerState
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainerState
from reagent_tpu_torch.training.reinforce_trainer import PolicyGradientTrainerState
from reagent_tpu_torch.training.sac_trainer import SACTrainerState
from reagent_tpu_torch.training.td3_trainer import TD3TrainerState

_NET = "FullyConnectedNetwork_0"
# flax scope -> the port's submodule, by network
_SCOPES = (
    {_NET: "net"},
    {"fc": "net"},  # GaussianFullyConnectedActor's setup-named trunk
    {_NET: "shared", "FullyConnectedNetwork_1": "advantage",
     "FullyConnectedNetwork_2": "value"},
)
PARAMETRIC_DUELING_SCOPES = {_NET: "state_emb", "FullyConnectedNetwork_1": "value",
                             "FullyConnectedNetwork_2": "advantage"}


def _dense_index(name: str) -> int:
    m = re.fullmatch(r"Dense_(\d+)", name)
    if m is None:
        raise ValueError(f"unexpected layer {name!r} in a dense flax scope")
    return int(m.group(1))


def q_network_state_from_flax(
    params_np: Mapping, scopes: Optional[Mapping[str, str]] = None,
) -> Dict[str, torch.Tensor]:
    """Flax ``FullyConnectedDQN``, ``CategoricalDQN``, ``DuelingQNetwork``,
    critic, value or actor params (numpy leaves) -> the state dict of the
    port's module of the same name; ``scopes`` (flax scope -> the port's
    submodule) where the scope names are ambiguous."""
    tree = params_np["params"]
    if scopes is None:
        scopes = next((m for m in _SCOPES if set(tree) == set(m)), None)
    if scopes is None:
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
    scopes = next((m for m in _SCOPES if set(m.values()) == prefixes), None)
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
    """A flax tree's parameters by the port's names, or a flat ``{name:
    array}`` dict (log-alpha's) as it is."""
    if "params" not in params_np:
        return {k: torch.tensor(np.asarray(v, np.float32), device=device)
                for k, v in params_np.items()}
    return {k: v.to(device) for k, v in q_network_state_from_flax(params_np).items()}


def opt_state_from_arrays(
    count, mu: Optional[Mapping] = None, nu: Optional[Mapping] = None,
    nu_max: Optional[Mapping] = None, trace: Optional[Mapping] = None, device="cpu",
) -> OptState:
    """The port's optimizer state from the fields of an optax
    ``ScaleByAdamState`` / ``ScaleByAmsgradState`` (``count``, ``mu``, ``nu``,
    ``nu_max``) or ``TraceState`` (``trace``), each moment a flax tree with
    numpy leaves (or ``{"log_alpha": array}`` for SAC's temperature)."""
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


def c51_state_from_arrays(
    q_params: Mapping, q_target_params: Mapping, opt_state: OptState, step, device="cpu"
) -> C51TrainerState:
    """The port's ``C51TrainerState`` from a ``reagent_tpu`` one, as
    ``qrdqn_state_from_arrays``."""
    return _unfused_state(C51TrainerState, q_params, q_target_params, opt_state, step, device)


def parametric_dqn_state_from_arrays(
    q_params: Mapping, q_target_params: Mapping, opt_state: OptState, step, device="cpu",
    *, reward_params: Optional[Mapping] = None, reward_opt_state: Optional[OptState] = None,
) -> ParametricDQNTrainerState:
    """The port's ``ParametricDQNTrainerState`` from a ``reagent_tpu`` one,
    as ``qrdqn_state_from_arrays``; the optional reward network's parameter
    tree and optimizer state where the JAX state has them."""
    state = _unfused_state(
        ParametricDQNTrainerState, q_params, q_target_params, opt_state, step, device)
    return dataclasses.replace(
        state, reward_params=None if reward_params is None else _params_on(reward_params, device),
        reward_opt_state=reward_opt_state)


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


def sac_state_from_arrays(
    actor_params: Mapping, q1_params: Mapping, q1_target_params: Mapping,
    actor_opt_state: OptState, q1_opt_state: OptState, step, device="cpu", *,
    q2_params: Optional[Mapping] = None, q2_target_params: Optional[Mapping] = None,
    q2_opt_state: Optional[OptState] = None, log_alpha=None,
    alpha_opt_state: Optional[OptState] = None, value_params: Optional[Mapping] = None,
    value_target_params: Optional[Mapping] = None, value_opt_state: Optional[OptState] = None,
) -> SACTrainerState:
    """The port's ``SACTrainerState`` from a ``reagent_tpu`` one: flax
    parameter trees with numpy leaves, optimizer states from
    ``opt_state_from_arrays``, ``log_alpha`` a numpy scalar.  JAX's ``rng``
    has no field here: the port's trainer holds its noise stream."""
    def tree(x):
        return None if x is None else _params_on(x, device)

    return SACTrainerState(
        actor_params=tree(actor_params), q1_params=tree(q1_params),
        q1_target_params=tree(q1_target_params), actor_opt_state=actor_opt_state,
        q1_opt_state=q1_opt_state, step=_scalar_i32(step, device),
        q2_params=tree(q2_params), q2_target_params=tree(q2_target_params),
        q2_opt_state=q2_opt_state,
        log_alpha=None if log_alpha is None else torch.tensor(
            np.asarray(log_alpha, np.float32), device=device),
        alpha_opt_state=alpha_opt_state, value_params=tree(value_params),
        value_target_params=tree(value_target_params), value_opt_state=value_opt_state)


def td3_state_from_arrays(
    actor_params: Mapping, actor_target_params: Mapping, q1_params: Mapping,
    q1_target_params: Mapping, actor_opt_state: OptState, q1_opt_state: OptState, step,
    device="cpu", *, q2_params: Optional[Mapping] = None,
    q2_target_params: Optional[Mapping] = None, q2_opt_state: Optional[OptState] = None,
) -> TD3TrainerState:
    """The port's ``TD3TrainerState``, as ``sac_state_from_arrays``."""
    def tree(x):
        return None if x is None else _params_on(x, device)

    return TD3TrainerState(
        actor_params=tree(actor_params), actor_target_params=tree(actor_target_params),
        q1_params=tree(q1_params), q1_target_params=tree(q1_target_params),
        actor_opt_state=actor_opt_state, q1_opt_state=q1_opt_state,
        step=_scalar_i32(step, device), q2_params=tree(q2_params),
        q2_target_params=tree(q2_target_params), q2_opt_state=q2_opt_state)


def crr_state_from_arrays(
    actor_params: Mapping, actor_target_params: Mapping, q1_params: Mapping,
    q1_target_params: Mapping, actor_opt_state: OptState, q1_opt_state: OptState, step,
    device="cpu", *, q2_params: Optional[Mapping] = None,
    q2_target_params: Optional[Mapping] = None, q2_opt_state: Optional[OptState] = None,
) -> CRRTrainerState:
    """The port's ``CRRTrainerState`` from a ``reagent_tpu`` one, as
    ``sac_state_from_arrays``."""
    def tree(x):
        return None if x is None else _params_on(x, device)

    return CRRTrainerState(
        actor_params=tree(actor_params), actor_target_params=tree(actor_target_params),
        q1_params=tree(q1_params), q1_target_params=tree(q1_target_params),
        actor_opt_state=actor_opt_state, q1_opt_state=q1_opt_state,
        step=_scalar_i32(step, device), q2_params=tree(q2_params),
        q2_target_params=tree(q2_target_params), q2_opt_state=q2_opt_state)


def reinforce_state_from_arrays(
    policy_params: Mapping, opt_state: OptState, step, device="cpu", *,
    value_params: Optional[Mapping] = None, value_opt_state: Optional[OptState] = None,
) -> PolicyGradientTrainerState:
    """The port's REINFORCE or PPO state from a ``reagent_tpu``
    ``ReinforceTrainerState`` or ``PPOTrainerState``: flax parameter trees
    with numpy leaves, optimizer states from ``opt_state_from_arrays``."""
    def tree(x):
        return None if x is None else _params_on(x, device)

    return PolicyGradientTrainerState(
        policy_params=tree(policy_params), opt_state=opt_state, step=_scalar_i32(step, device),
        value_params=tree(value_params), value_opt_state=value_opt_state)


ppo_state_from_arrays = reinforce_state_from_arrays


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
