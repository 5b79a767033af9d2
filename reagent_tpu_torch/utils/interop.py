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
do not tell the two apart).  Inside a network scope flax numbers its
``Dense_i``, ``BatchNorm_i`` and ``LayerNorm_i`` scopes by separate
counters, as the port's ``layers``, ``batch_norms`` and ``layer_norms``
lists index them; a batch norm's ``mean`` and ``var`` come from the
``batch_stats`` collection, where the JAX trainers keep them among their
parameters, and the gaussian actor's ``loc_ln`` and ``scale_ln`` keep their
names.  An optax moment tree has its parameters' layout and is carried the
same way; SAC's scalar log-alpha and its moments are carried under the name
``log_alpha``; ``opt_state_from_optax`` reads any optax chain of the union,
a schedule's count included.  A ``MemoryNetwork``'s tree (scope ``MDNRNN_0``)
maps through ``memory_network_state_from_flax``, its moments too.  A
``SparseDQN``'s tree (``EmbeddingBagConcat_0/EmbeddingBagCollection_0/
bag_<name>/embedding`` and the overarch's ``FullyConnectedNetwork_0``; under a
``SparseDQN_0`` scope where a module wraps it) maps through
``sparse_dqn_state_from_flax``, and JAX's ``SparseEmbeddingState`` through
``sparse_embedding_state_from_arrays``.  The ranking models map through
``seq2slate_state_from_flax`` (a ``Seq2SlateTransformerModel`` of any output
architecture, and a ``Seq2SlateTransformerRewardNet``: a ``DenseGeneral``
kernel ``[D, H, dh]`` becomes an ``nn.Linear`` weight ``[H * dh, D]`` and
``[H, dh, D]`` one ``[D, H * dh]``, the heads in their order),
``slate_reward_state_from_flax`` (the LSTM-backed ``Seq2SlateGRURewardNet``),
``probabilistic_network_state_from_flax`` and
``convolutional_network_state_from_flax``.  The model-based family maps
through ``seq2reward_state_from_flax`` (``map_linear``, the LSTM cells,
``lstm_linear``), ``synthetic_reward_state_from_flax`` (any synthetic-reward
net, by its scopes), ``fcn_state_from_flax`` (a bare
``FullyConnectedNetwork``: the Seq2Reward trainer's step classifier) and
``cem_ensemble_params_from_flax`` (a planner's members); the trainer states through
``slate_q_state_from_arrays`` and ``seq2slate_trainer_state_from_arrays``.
The bandit slice's: ``deep_represent_state_from_flax`` (the
``_DeepRepresentMLP``'s ``FullyConnectedNetwork_0`` trunk and ``Dense_0``
head), ``cb_fcn_state_from_flax`` (a ``CBFullyConnectedNetwork``), and
``linucb_state_from_arrays``, ``disjoint_linucb_state_from_arrays``,
``mab_state_from_arrays`` (with ``extra``), ``offline_eval_state_from_arrays``,
``supervised_trainer_state_from_arrays`` and
``deep_represent_trainer_state_from_arrays`` for their states.
The off-policy-estimation slice's: ``dualdice_net_state_from_flax`` (a
``NeuralDualDICE`` nu or zeta net's ``Dense_0..2``) and
``nn_trainer_params_from_arrays`` (``NNTrainer``'s list of ``{"w", "b"}``).
The imitation and counterfactual-evaluation slice's: the behavioural-cloning
and bandit reward nets are ``FullyConnectedDQN``s (``q_network_state_from_flax``);
``bayesian_mlp_state_from_flax`` maps a ``BayesianMLP``'s ``w{i}_mu``,
``w{i}_rho`` and ``b{i}`` (flax's ``[din, dout]`` layout, kept), and
``behavioral_cloning_state_from_arrays``, ``bandit_reward_net_state_from_arrays``,
``bayes_by_backprop_state_from_arrays`` and ``evolution_pool_state_from_arrays``
carry the trainers' and the ES pool's states.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from reagent_tpu_torch.evaluation.cb.base_evaluator import OfflineEvalState
from reagent_tpu_torch.mab.mab_algorithm import MABState
from reagent_tpu_torch.models.deep_represent_linucb import DeepRepresentLinUCBState
from reagent_tpu_torch.models.linear_regression import DisjointLinUCBState, LinUCBState
from reagent_tpu_torch.ops.sparse_embedding import SparseEmbeddingState
from reagent_tpu_torch.optim import OptState
from reagent_tpu_torch.replay.circular import ReplayBufferState
from reagent_tpu_torch.replay.packed import PackedReplayBufferState
from reagent_tpu_torch.training.behavioral_cloning_trainer import (
    BehavioralCloningTrainerState,
)
from reagent_tpu_torch.training.c51_trainer import C51TrainerState
from reagent_tpu_torch.training.cfeval.bandit_reward_network_trainer import (
    BanditRewardNetTrainerState,
)
from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import (
    BayesByBackpropTrainerState,
)
from reagent_tpu_torch.training.cb.supervised_trainer import SupervisedTrainerState
from reagent_tpu_torch.training.discrete_crr_trainer import CRRTrainerState
from reagent_tpu_torch.training.dqn_trainer import DQNTrainerState
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainerState
from reagent_tpu_torch.training.gradient_free.evolution_pool import EvolutionPoolState
from reagent_tpu_torch.training.parametric_dqn_trainer import ParametricDQNTrainerState
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainerState
from reagent_tpu_torch.training.ranking.seq2slate_trainer import Seq2SlateTrainerState
from reagent_tpu_torch.training.reinforce_trainer import PolicyGradientTrainerState
from reagent_tpu_torch.training.sac_trainer import SACTrainerState
from reagent_tpu_torch.training.slate_q_trainer import SlateQTrainerState
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


_LAYER = re.compile(r"(Dense|BatchNorm|LayerNorm)_(\d+)")
# flax layer scope -> the port's list in FullyConnectedNetwork (flax numbers
# Dense, BatchNorm and LayerNorm scopes by separate counters, as the port's
# lists index them)
_LIST = {"Dense": "layers", "BatchNorm": "batch_norms", "LayerNorm": "layer_norms"}
_FLAX_KIND = {v: k for k, v in _LIST.items()}
# a norm's flax leaf -> the port's parameter, by collection
_NORM_LEAVES = {"params": ("scale", "bias"), "batch_stats": ("mean", "var")}
# the gaussian actor's layer norms after its trunk: flax scope = port name
_TOP_NORMS = ("loc_ln", "scale_ln")


def _layer(name: str):
    m = _LAYER.fullmatch(name)
    if m is None:
        raise ValueError(f"unexpected layer {name!r} in a flax network scope")
    return m.group(1), int(m.group(2))


def _array(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x, np.float32), order="C"))


def q_network_state_from_flax(
    params_np: Mapping, scopes: Optional[Mapping[str, str]] = None,
) -> Dict[str, torch.Tensor]:
    """Flax ``FullyConnectedDQN``, ``CategoricalDQN``, ``DuelingQNetwork``,
    critic, value or actor variables (numpy leaves; ``batch_stats`` where
    the net has batch norm) -> the state dict of the port's module of the
    same name; ``scopes`` (flax scope -> the port's submodule) where the
    scope names are ambiguous.  ``Dense_i`` becomes ``layers.i`` (kernel
    transposed), ``BatchNorm_i`` ``batch_norms.i`` (scale, bias; mean and
    var from ``batch_stats``) and ``LayerNorm_i`` ``layer_norms.i``."""
    tree = params_np["params"]
    nets = {k: v for k, v in tree.items() if k not in _TOP_NORMS}
    if scopes is None:
        scopes = next((m for m in _SCOPES if set(nets) == set(m)), None)
    if scopes is None:
        raise ValueError(f"unexpected scopes {sorted(tree)} in a q-network tree")
    out: Dict[str, torch.Tensor] = {}
    for collection, norm_leaves in _NORM_LEAVES.items():
        for scope, prefix in scopes.items():
            for name, leaves in params_np.get(collection, {}).get(scope, {}).items():
                kind, i = _layer(name)
                base = f"{prefix}.{_LIST[kind]}.{i}"
                if kind == "Dense":
                    out[f"{base}.weight"] = _array(np.asarray(leaves["kernel"], np.float32).T)
                    out[f"{base}.bias"] = _array(leaves["bias"])
                else:
                    for leaf in norm_leaves:
                        out[f"{base}.{leaf}"] = _array(leaves[leaf])
    for name in _TOP_NORMS:
        for leaf in tree.get(name, {}):
            out[f"{name}.{leaf}"] = _array(tree[name][leaf])
    return out


def flax_from_q_network_state(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of ``q_network_state_from_flax`` (numpy leaves; a
    ``batch_stats`` collection where the net has batch norm)."""
    prefixes = {k.split(".")[0] for k in state_dict} - set(_TOP_NORMS)
    scopes = next((m for m in _SCOPES if set(m.values()) == prefixes), None)
    if scopes is None:
        raise ValueError(f"unexpected submodules {sorted(prefixes)} in a q-network state dict")
    scope_of = {prefix: scope for scope, prefix in scopes.items()}
    out: Dict = {"params": {scope: {} for scope in scopes}}
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        top = re.fullmatch(r"(loc_ln|scale_ln)\.(scale|bias)", key)
        if top is not None:
            out["params"].setdefault(top.group(1), {})[top.group(2)] = a
            continue
        m = re.fullmatch(r"(\w+)\.(layers|batch_norms|layer_norms)\.(\d+)\.(\w+)", key)
        if m is None:
            raise ValueError(f"unexpected key {key!r} in a q-network state dict")
        prefix, lst, i, leaf = m.groups()
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        scope = out.setdefault(collection, {}).setdefault(scope_of[prefix], {})
        entry = scope.setdefault(f"{_FLAX_KIND[lst]}_{i}", {})
        if leaf == "weight":
            entry["kernel"] = np.ascontiguousarray(a.T)
        else:
            entry["bias" if leaf == "bias" and lst == "layers" else leaf] = a
    return out


_GATES = "ifgo"  # flax's OptimizedLSTMCell gate order, the port's kernel columns


def memory_network_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``MemoryNetwork`` variables (numpy leaves) -> the port's
    ``MemoryNetwork`` state dict.  Layer ``l``'s ``OptimizedLSTMCell_l``
    holds one kernel per gate: ``ii``..``io`` [in, H] (no bias) side by side
    become ``mdnrnn.rnn.layers.l.input_kernel`` [in, 4H], ``hi``..``ho``
    [H, H] ``hidden_kernel`` [H, 4H] and their biases ``hidden_bias`` [4H],
    in the gate order i, f, g, o; the head ``Dense_0`` becomes
    ``mdnrnn.head`` (kernel transposed)."""
    tree = params_np["params"]["MDNRNN_0"]
    out: Dict[str, torch.Tensor] = {}
    for name, cell in tree["StackedLSTM_0"].items():
        m = re.fullmatch(r"OptimizedLSTMCell_(\d+)", name)
        if m is None:
            raise ValueError(f"unexpected scope {name!r} in a StackedLSTM tree")
        out.update(_lstm_cell(cell, f"mdnrnn.rnn.layers.{m.group(1)}"))
    out.update(_dense(tree["Dense_0"], "mdnrnn.head"))
    return out


def _lstm_cell(cell: Mapping, base: str) -> Dict[str, torch.Tensor]:
    """A flax ``OptimizedLSTMCell``'s gate kernels side by side, in the gate
    order i, f, g, o, as the port's ``LSTMLayer`` at ``base``."""
    return {
        f"{base}.input_kernel": _array(np.concatenate(
            [np.asarray(cell["i" + g]["kernel"]) for g in _GATES], axis=-1)),
        f"{base}.hidden_kernel": _array(np.concatenate(
            [np.asarray(cell["h" + g]["kernel"]) for g in _GATES], axis=-1)),
        f"{base}.hidden_bias": _array(np.concatenate(
            [np.asarray(cell["h" + g]["bias"]) for g in _GATES], axis=-1)),
    }


def _dense(node: Mapping, base: str) -> Dict[str, torch.Tensor]:
    return {f"{base}.weight": _array(np.asarray(node["kernel"], np.float32).T),
            f"{base}.bias": _array(node["bias"])}


def _lstm_layers(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        m = re.fullmatch(r"OptimizedLSTMCell_(\d+)", name)
        if m is not None:
            out.update(_lstm_cell(node, f"{prefix}layers.{m.group(1)}"))
    return out


def fcn_state_from_flax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax ``FullyConnectedNetwork``'s own scope (its ``Dense_i``,
    ``BatchNorm_i``, ``LayerNorm_i``) -> the port's ``FullyConnectedNetwork``
    names under ``prefix``."""
    dense = q_network_state_from_flax({"params": {_NET: tree}})
    return {prefix + k[len("net."):]: v for k, v in dense.items()}


def seq2reward_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``Seq2RewardNetwork`` variables (numpy leaves) -> the port's
    state dict: ``map_linear`` and ``lstm_linear`` (kernels transposed) and
    each ``OptimizedLSTMCell_l`` as ``layers.l`` (the gate kernels side by
    side, as ``memory_network_state_from_flax``)."""
    tree = params_np["params"]
    out = _lstm_layers(tree, "")
    for name in ("map_linear", "lstm_linear"):
        out.update(_dense(tree[name], name))
    return out


def cem_ensemble_params_from_flax(trees) -> list:
    """A CEM planner's ``mem_net_params_list`` from the members' flax
    ``MemoryNetwork`` trees (numpy leaves)."""
    return [memory_network_state_from_flax(t) for t in trees]


def synthetic_reward_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``SyntheticRewardNet`` or ``SyntheticRewardSparseArchNet``
    variables (numpy leaves) -> the port's state dict, by the inner net's
    scopes (the inner net is the port's ``net``):

    - the single-step and n-gram MLPs: ``FullyConnectedNetwork_0`` as
      ``net.net``;
    - the n-gram conv net: ``Conv_i`` (``[kh, kw, in, out]``) as
      ``net.convs.i`` (``[out, in, kh, kw]``), its MLP as ``net.net``;
    - the LSTM net: ``OptimizedLSTMCell_l`` as ``net.layers.l``, ``Dense_0``
      as ``net.head``;
    - the transformer: ``Dense_0`` as ``net.embed``, layer ``i``'s
      ``MultiHeadDotProductAttention_i``, ``LayerNorm_2i``, ``LayerNorm_2i+1``
      as ``net.encoder_layers.i.attn``, ``norm1``, ``norm2``, its
      feed-forward ``Dense_2i+2`` (into the hidden width; flax names it
      second) and ``Dense_2i+1`` as ``ff.dense0`` and ``ff.dense1``, the last
      ``Dense`` as ``net.head``;
    - the sparse arch: ``FullyConnectedNetwork_0`` (the dense tower) as
      ``net.dense``, ``FullyConnectedNetwork_1`` (the over-arch) as
      ``net.over``, each feature's ``embedding`` as ``net.bags.<name>``."""
    tree = params_np["params"]["net"]
    out: Dict[str, torch.Tensor] = {}
    if "MultiHeadDotProductAttention_0" in tree:
        n_layers = sum(1 for k in tree if k.startswith("MultiHeadDotProductAttention_"))
        out.update(_dense(tree["Dense_0"], "net.embed"))
        for i in range(n_layers):
            base = f"net.encoder_layers.{i}"
            for leaf, x in _flatten(tree[f"MultiHeadDotProductAttention_{i}"]):
                out.update(_ranking_leaf(f"{base}.attn.{leaf[0]}", leaf[0], leaf[1], x))
            for j, norm in ((2 * i, "norm1"), (2 * i + 1, "norm2")):
                for leaf in ("scale", "bias"):
                    out[f"{base}.{norm}.{leaf}"] = _array(tree[f"LayerNorm_{j}"][leaf])
            out.update(_dense(tree[f"Dense_{2 * i + 2}"], f"{base}.ff.dense0"))
            out.update(_dense(tree[f"Dense_{2 * i + 1}"], f"{base}.ff.dense1"))
        out.update(_dense(tree[f"Dense_{2 * n_layers + 1}"], "net.head"))
        return out
    if "OptimizedLSTMCell_0" in tree:
        out.update(_lstm_layers(tree, "net."))
        out.update(_dense(tree["Dense_0"], "net.head"))
        return out
    if "FullyConnectedNetwork_1" in tree:
        out.update(fcn_state_from_flax(tree[_NET], "net.dense."))
        out.update(fcn_state_from_flax(tree["FullyConnectedNetwork_1"], "net.over."))
        for name, node in tree.items():
            if not name.startswith("FullyConnectedNetwork_"):
                out[f"net.bags.{name}.embedding"] = _array(node["embedding"])
        return out
    for name, node in tree.items():
        m = re.fullmatch(r"Conv_(\d+)", name)
        if m is not None:
            out[f"net.convs.{m.group(1)}.weight"] = _array(
                np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1))
            out[f"net.convs.{m.group(1)}.bias"] = _array(node["bias"])
        elif name != _NET:
            raise ValueError(f"unexpected scope {name!r} in a synthetic reward tree")
    out.update(fcn_state_from_flax(tree[_NET], "net.net."))
    return out


def _flatten(node: Mapping):
    """((scope, leaf), array) pairs of a two-level flax tree."""
    for scope, leaves in node.items():
        for leaf, x in leaves.items():
            yield (scope, leaf), x


_BAGS = ("EmbeddingBagConcat_0", "EmbeddingBagCollection_0")
_SPARSE_DQN = "SparseDQN_0"  # the scope of a SparseDQN inside a wrapping module


def sparse_dqn_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``SparseDQN`` variables (numpy leaves) -> the port's state dict:
    each ``bag_<name>/embedding`` table as ``concat.collection.bag_<name>.
    embedding`` and the overarch's ``Dense_i`` as ``net.layers.i``.  Under a
    lone ``SparseDQN_0`` scope (a wrapping module, as the changing-arms
    job's) the names take the port's ``sparse_dqn.`` prefix
    (``gym/sparse_arms.py::ArmsSparseQNet``)."""
    tree = params_np["params"]
    prefix = ""
    if set(tree) == {_SPARSE_DQN}:
        tree, prefix = tree[_SPARSE_DQN], "sparse_dqn."
    out = {f"{prefix}concat.collection.{scope}.embedding": _array(leaves["embedding"])
           for scope, leaves in tree[_BAGS[0]][_BAGS[1]].items()}
    dense = q_network_state_from_flax({"params": {_NET: tree[_NET]}})
    out.update({prefix + k: v for k, v in dense.items()})
    return out


# flax scope -> the port's submodule in the ranking models, by name or by
# pattern (the layers' lists are ModuleLists)
_RANKING_SCOPES = {
    "MultiHeadDotProductAttention_0": "attn", "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
    "FeedForward_0": "ff", "Dense_0": "dense0", "Dense_1": "dense1",
    "q_proj": "query", "k_proj": "key", "v_proj": "value", "out_proj": "out",
}
# the transformer reward net's top-level scopes
_REWARD_TOP = {"Embedder_0": "candidate_embedder", "Embedder_1": "state_embedder",
               "Dense_0": "head"}


def _ranking_leaf(prefix: str, scope: str, leaf: str, x) -> Dict[str, torch.Tensor]:
    a = np.asarray(x, np.float32)
    if leaf == "kernel":
        if a.ndim == 3 and scope in ("out", "out_proj"):  # [H, dh, D]
            a = a.reshape(-1, a.shape[-1])
        elif a.ndim == 3:  # [D, H, dh]
            a = a.reshape(a.shape[0], -1)
        return {f"{prefix}.weight": _array(a.T)}
    return {f"{prefix}.{leaf}": _array(a.reshape(-1) if leaf == "bias" else a)}


def seq2slate_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``Seq2SlateTransformerModel`` (any output architecture) or
    ``Seq2SlateTransformerRewardNet`` variables (numpy leaves) -> the state
    dict of the port's module: ``encoder_layers_i`` / ``decoder_layers_i``
    / ``EncoderLayer_i`` become ``encoder_layers.i`` / ``decoder_layers.i``,
    a layer's ``MultiHeadDotProductAttention_0``, ``LayerNorm_0/1`` and
    ``FeedForward_0`` its ``attn``, ``norm1/2`` and ``ff``, the
    ``CachedSelfAttention``'s ``q/k/v/out_proj`` ``query``, ``key``,
    ``value`` and ``out``, each ``Dense_i`` inside a block ``dense{i}``; the
    reward net's ``Embedder_0`` (candidates), ``Embedder_1`` (state) and
    head ``Dense_0`` its ``candidate_embedder``, ``state_embedder`` and
    ``head``.  A checkpoint from before the KV-cache decoder has the old
    layout: pass it through
    ``utils/checkpoint_compat.py::remap_pre_kv_cache_seq2slate_params``
    first, then here."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if not isinstance(child, Mapping):
                out.update(_ranking_leaf(".".join(path), path[-1], name, child))
                continue
            m = re.fullmatch(r"(encoder_layers|decoder_layers|EncoderLayer)_(\d+)", name)
            if m is not None:
                part = f"encoder_layers.{m.group(2)}" if m.group(1) == "EncoderLayer" \
                    else f"{m.group(1)}.{m.group(2)}"
            elif not path and name in _REWARD_TOP:
                part = _REWARD_TOP[name]
            else:
                part = _RANKING_SCOPES.get(name, name)
            walk(child, path + [part])

    walk(params_np["params"], [])
    return out


def slate_reward_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``Seq2SlateGRURewardNet`` variables (numpy leaves) -> the port's
    state dict: ``Dense_0`` (the state's embedding) becomes ``state_embed``,
    ``OptimizedLSTMCell_l`` ``layers.l`` (the gate kernels side by side, as
    ``memory_network_state_from_flax``) and ``Dense_1`` ``head``."""
    tree = params_np["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        m = re.fullmatch(r"OptimizedLSTMCell_(\d+)", name)
        if m is not None:
            out.update(_lstm_cell(node, f"layers.{m.group(1)}"))
        elif name in ("Dense_0", "Dense_1"):
            out.update(_dense(node, "state_embed" if name == "Dense_0" else "head"))
        else:
            raise ValueError(f"unexpected scope {name!r} in a slate reward tree")
    return out


def probabilistic_network_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``FullyConnectedProbabilisticNetwork`` variables -> the port's
    state dict: ``LinearBBB_i``'s ``w_mu``, ``w_rho`` [in, out], ``b_mu``
    and ``b_rho`` as ``layers.i.*``, unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in params_np["params"].items():
        m = re.fullmatch(r"LinearBBB_(\d+)", name)
        if m is None:
            raise ValueError(f"unexpected scope {name!r} in a probabilistic network tree")
        for leaf, x in node.items():
            out[f"layers.{m.group(1)}.{leaf}"] = _array(x)
    return out


def convolutional_network_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``ConvolutionalNetwork`` variables -> the port's state dict:
    ``Conv_i``'s kernel [kh, kw, in, out] becomes ``convs.i.weight`` [out,
    in, kh, kw], and the head ``FullyConnectedNetwork_0`` ``net``."""
    tree = params_np["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        m = re.fullmatch(r"Conv_(\d+)", name)
        if m is not None:
            k = np.asarray(node["kernel"], np.float32)
            out[f"convs.{m.group(1)}.weight"] = _array(k.transpose(3, 2, 0, 1))
            out[f"convs.{m.group(1)}.bias"] = _array(node["bias"])
        elif name != _NET:
            raise ValueError(f"unexpected scope {name!r} in a convolutional network tree")
    out.update(q_network_state_from_flax({"params": {_NET: tree[_NET]}}))
    return out


def _from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    tree = params_np["params"]
    if "map_linear" in tree:
        return seq2reward_state_from_flax(params_np)
    if tree and all(_LAYER.fullmatch(k) for k in tree):
        return fcn_state_from_flax(tree)
    if "state_embedder" in tree or "EncoderLayer_0" in tree:
        return seq2slate_state_from_flax(params_np)
    if "OptimizedLSTMCell_0" in tree:
        return slate_reward_state_from_flax(params_np)
    if "LinearBBB_0" in tree:
        return probabilistic_network_state_from_flax(params_np)
    if "Conv_0" in tree:
        return convolutional_network_state_from_flax(params_np)
    if "MDNRNN_0" in tree:
        return memory_network_state_from_flax(params_np)
    if _BAGS[0] in tree or set(tree) == {_SPARSE_DQN}:
        return sparse_dqn_state_from_flax(params_np)
    if set(tree) == {_NET, "Dense_0"}:
        return deep_represent_state_from_flax(params_np)
    if "w0_mu" in tree:
        return bayesian_mlp_state_from_flax(params_np)
    return q_network_state_from_flax(params_np)


def _params_on(params_np: Mapping, device) -> Dict[str, torch.Tensor]:
    """A flax tree's parameters by the port's names (a ``MemoryNetwork``'s,
    a ``SparseDQN``'s or a q-network's), or a flat ``{name: array}`` dict
    (log-alpha's, the sparse embedding head's) as it is."""
    if "params" not in params_np:
        return {k: torch.tensor(np.asarray(v, np.float32), device=device)
                for k, v in params_np.items()}
    return {k: v.to(device) for k, v in _from_flax(params_np).items()}


_MOMENTS = ("mu", "nu", "nu_max", "trace", "sum_of_squares", "e_g", "e_x", "step_sizes",
            "prev_updates", "v_row", "v_col", "v")


def opt_state_from_arrays(
    count, mu: Optional[Mapping] = None, nu: Optional[Mapping] = None,
    nu_max: Optional[Mapping] = None, trace: Optional[Mapping] = None, device="cpu",
    schedule_count=None, **moments: Optional[Mapping],
) -> OptState:
    """The port's optimizer state from the fields of an optax state
    (``count``, ``mu``, ``nu``, ``nu_max``, ``trace``, and by keyword the
    other ``OptState`` moments: ``sum_of_squares``, ``e_g``, ``e_x``,
    ``step_sizes``, ``prev_updates``, ``v_row``, ``v_col``, ``v``), each a
    flax tree with numpy leaves (or ``{"log_alpha": array}`` for SAC's
    temperature), and a schedule's count.  Adafactor's factored moments of a
    square kernel swap rows for columns: the port's weight is the flax
    kernel transposed, and optax picks the axes of a square tensor by
    position."""
    unknown = set(moments) - set(_MOMENTS)
    if unknown:
        raise ValueError(f"unknown optimizer state fields {sorted(unknown)}")

    def tree(x):
        return None if x is None else _params_on(x, device)

    fields = {name: tree(x) for name, x in dict(mu=mu, nu=nu, nu_max=nu_max, trace=trace,
                                                 **moments).items()}
    rows, cols = fields.get("v_row"), fields.get("v_col")
    if rows is not None and cols is not None:
        for k in rows:
            if (k.endswith(".weight") and rows[k].shape == cols[k].shape
                    and rows[k].numel() > 1):
                rows[k], cols[k] = cols[k], rows[k]
    return OptState(count=_scalar_i32(count, device),
                    schedule_count=None if schedule_count is None
                    else _scalar_i32(schedule_count, device), **fields)


def opt_state_from_optax(state, device="cpu") -> OptState:
    """The port's optimizer state from an optax state (a chain's tuple of
    named states, leaves JAX or numpy arrays), field by field: the first
    ``count`` of an optimizer's state, every moment ``OptState`` names, and
    ``ScaleByScheduleState``'s count as ``schedule_count``."""
    found: Dict = {}

    def to_np(x):
        if isinstance(x, Mapping):
            return {k: to_np(v) for k, v in x.items()}
        return np.asarray(x)

    def walk(node):
        name = type(node).__name__
        if name == "ScaleByScheduleState":
            found["schedule_count"] = np.asarray(node.count)
            return
        names = getattr(node, "_fields", None) or (
            [f.name for f in dataclasses.fields(node)] if dataclasses.is_dataclass(node) else None)
        if names is None:
            if isinstance(node, (tuple, list)):
                for child in node:
                    walk(child)
            return
        for field in names:
            value = getattr(node, field)
            if field == "count":
                found.setdefault("count", np.asarray(value))
            elif field in _MOMENTS and value is not None:
                found[field] = to_np(value)
            elif isinstance(value, (tuple, list)) or hasattr(value, "_fields"):
                walk(value)

    walk(state)
    found.setdefault("count", np.zeros((), np.int32))
    return opt_state_from_arrays(device=device, **found)


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


def slate_q_state_from_arrays(
    q_params: Mapping, q_target_params: Mapping, opt_state: OptState, step, device="cpu"
) -> SlateQTrainerState:
    """The port's ``SlateQTrainerState`` from a ``reagent_tpu`` one: the
    critic's flax trees (numpy leaves, carried as
    ``q_network_state_from_flax``), ``opt_state`` from
    ``opt_state_from_optax``."""
    return _unfused_state(SlateQTrainerState, q_params, q_target_params, opt_state, step, device)


def seq2slate_trainer_state_from_arrays(
    policy_params: Mapping, policy_opt_state: OptState, step, device="cpu", *,
    baseline_params: Optional[Mapping] = None, baseline_opt_state: Optional[OptState] = None,
) -> Seq2SlateTrainerState:
    """The port's ``Seq2SlateTrainerState`` from a ``reagent_tpu`` one (or
    its teacher-forcing or pairwise-attention state, whose ``params`` are
    the policy's): the policy's flax tree (``seq2slate_state_from_flax``),
    the optional baseline's and the optimizer states from
    ``opt_state_from_optax``."""
    def tree(x):
        return None if x is None else _params_on(x, device)

    return Seq2SlateTrainerState(
        policy_params=tree(policy_params), policy_opt_state=policy_opt_state,
        step=_scalar_i32(step, device), baseline_params=tree(baseline_params),
        baseline_opt_state=baseline_opt_state)


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


def sparse_embedding_state_from_arrays(
    table, accum, head_params: Mapping, head_opt_state: OptState, device="cpu"
) -> SparseEmbeddingState:
    """The port's ``SparseEmbeddingState`` from a ``reagent_tpu`` one:
    ``table`` its ``logical_table`` (the lane packing undone), ``accum``,
    the head's ``{w1, b1, w2, b2}`` (numpy) and its optimizer state (from
    ``opt_state_from_optax``)."""
    return SparseEmbeddingState(
        table=torch.tensor(np.asarray(table, np.float32), device=device),
        accum=torch.tensor(np.asarray(accum, np.float32), device=device),
        head_params=_params_on(head_params, device),
        head_opt_state=head_opt_state,
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


def deep_represent_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``_DeepRepresentMLP`` variables (numpy leaves) -> the port's
    names: the ``FullyConnectedNetwork_0`` trunk under ``trunk.`` and the
    bias-free ``Dense_0`` head as ``head.weight`` [1, in]."""
    tree = params_np["params"]
    out = fcn_state_from_flax(tree[_NET], "trunk.")
    out["head.weight"] = _array(np.asarray(tree["Dense_0"]["kernel"], np.float32).T)
    return out


def cb_fcn_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``CBFullyConnectedNetwork`` variables -> the port's state dict
    (its ``FullyConnectedNetwork_0`` is the port's ``net``)."""
    return q_network_state_from_flax(params_np, {_NET: "net"})


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def linucb_state_from_arrays(avg_A, avg_b, sum_weight, num_obs, coefs, inv_avg_A,
                             device="cpu") -> LinUCBState:
    """The port's ``LinUCBState`` from a ``reagent_tpu`` one's numpy leaves."""
    return LinUCBState(avg_A=_tensor(avg_A, device), avg_b=_tensor(avg_b, device),
                       sum_weight=_tensor(sum_weight, device),
                       num_obs=_scalar_i32(num_obs, device), coefs=_tensor(coefs, device),
                       inv_avg_A=_tensor(inv_avg_A, device))


def disjoint_linucb_state_from_arrays(A, b, inv_A, coefs, num_obs,
                                      device="cpu") -> DisjointLinUCBState:
    """The port's ``DisjointLinUCBState`` from a ``reagent_tpu`` one's numpy leaves."""
    return DisjointLinUCBState(A=_tensor(A, device), b=_tensor(b, device),
                               inv_A=_tensor(inv_A, device), coefs=_tensor(coefs, device),
                               num_obs=_scalar_i32(num_obs, device))


def mab_state_from_arrays(total_n_obs_per_arm, total_sum_reward_per_arm,
                          total_sum_reward_squared_per_arm, extra: Optional[Mapping] = None,
                          device="cpu") -> MABState:
    """The port's ``MABState`` from a ``reagent_tpu`` one's numpy leaves
    (``extra`` a dict of them, as the NormalGamma posterior's)."""
    return MABState(
        total_n_obs_per_arm=_tensor(total_n_obs_per_arm, device),
        total_sum_reward_per_arm=_tensor(total_sum_reward_per_arm, device),
        total_sum_reward_squared_per_arm=_tensor(total_sum_reward_squared_per_arm, device),
        extra=None if extra is None else {k: _tensor(v, device) for k, v in extra.items()})


def offline_eval_state_from_arrays(device="cpu", **fields) -> OfflineEvalState:
    """The port's ``OfflineEvalState`` from a ``reagent_tpu`` one's numpy
    leaves, every field by name."""
    return OfflineEvalState(**{k: _tensor(v, device) for k, v in fields.items()})


def supervised_trainer_state_from_arrays(params: Mapping, opt_state: OptState, step,
                                         device="cpu") -> SupervisedTrainerState:
    """The port's ``SupervisedTrainerState`` from a ``reagent_tpu`` one: the
    network's flax tree (a bare ``FullyConnectedNetwork``'s or a
    q-network's), ``opt_state`` from ``opt_state_from_optax``."""
    return SupervisedTrainerState(params=_params_on(params, device), opt_state=opt_state,
                                  step=_scalar_i32(step, device))


def deep_represent_trainer_state_from_arrays(mlp_params: Mapping, opt_state: OptState,
                                             linucb: Mapping,
                                             device="cpu") -> DeepRepresentLinUCBState:
    """The port's ``DeepRepresentLinUCBState`` from a ``reagent_tpu`` one: the
    MLP's flax tree, ``opt_state`` from ``opt_state_from_optax`` and the
    LinUCB state's numpy leaves by name."""
    return DeepRepresentLinUCBState(
        mlp_params={k: v.to(device) for k, v in deep_represent_state_from_flax(
            mlp_params).items()},
        opt_state=opt_state, linucb=linucb_state_from_arrays(device=device, **linucb))


def dualdice_net_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables of a ``NeuralDualDICE`` net (``Dense_0..2`` at the top
    scope; ``reagent_tpu/ope/estimators/sequential_estimators.py:268-277``)
    -> the port's ``FullyConnectedNetwork`` names (``layers.i``)."""
    return fcn_state_from_flax(params_np["params"])


def nn_trainer_params_from_arrays(params_np, device="cpu") -> Dict[str, torch.Tensor]:
    """JAX ``NNTrainer``'s list of ``{"w" [in, out], "b" [out]}`` -> the
    port's ``NNTrainer.params`` (``layers.{i}.w``, ``layers.{i}.b``, the same
    ``[in, out]`` layout) on ``device``."""
    out = {}
    for i, layer in enumerate(params_np):
        for leaf in ("w", "b"):
            out[f"layers.{i}.{leaf}"] = _array(layer[leaf]).to(device)
    return out


_BBB_LEAF = re.compile(r"w\d+_(mu|rho)|b\d+")


def bayesian_mlp_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``BayesianMLP`` variables -> the port's ``BayesianMLP`` state dict:
    ``w{i}_mu``, ``w{i}_rho`` (``[din, dout]`` in both) and ``b{i}`` by name."""
    tree = params_np["params"]
    unknown = [k for k in tree if not _BBB_LEAF.fullmatch(k)]
    if unknown:
        raise ValueError(f"unexpected leaves {unknown} in a BayesianMLP tree")
    return {k: _array(v) for k, v in tree.items()}


def _params_step(cls, params: Mapping, opt_state: OptState, step, device):
    return cls(params=_params_on(params, device), opt_state=opt_state,
               step=_scalar_i32(step, device))


def behavioral_cloning_state_from_arrays(params: Mapping, opt_state: OptState, step,
                                         device="cpu") -> BehavioralCloningTrainerState:
    """The port's ``BehavioralCloningTrainerState`` from a ``reagent_tpu``
    one: the net's flax tree (a ``FullyConnectedDQN``'s), ``opt_state`` from
    ``opt_state_from_optax``."""
    return _params_step(BehavioralCloningTrainerState, params, opt_state, step, device)


def bandit_reward_net_state_from_arrays(params: Mapping, opt_state: OptState, step,
                                        device="cpu") -> BanditRewardNetTrainerState:
    """The port's ``BanditRewardNetTrainerState``, as
    ``behavioral_cloning_state_from_arrays``."""
    return _params_step(BanditRewardNetTrainerState, params, opt_state, step, device)


def bayes_by_backprop_state_from_arrays(params: Mapping, opt_state: OptState, step,
                                        device="cpu") -> BayesByBackpropTrainerState:
    """The port's ``BayesByBackpropTrainerState`` from a ``reagent_tpu`` one
    (its ``rng`` dropped: the port's draws are values or come from the
    trainer's generator); the ``BayesianMLP`` tree by
    ``bayesian_mlp_state_from_flax``."""
    return _params_step(BayesByBackpropTrainerState, params, opt_state, step, device)


def evolution_pool_state_from_arrays(parent_tensors: Mapping, opt_state: OptState,
                                     noise: Mapping, device="cpu") -> EvolutionPoolState:
    """An ``EvolutionPool``'s state from JAX's pool: ``parent_tensors``,
    ``opt_state`` (from ``opt_state_from_optax``) and ``_noise`` (each
    child's scaled mutation), numpy leaves by tensor name."""
    return EvolutionPoolState(parent_tensors=_params_on(parent_tensors, device),
                              opt_state=opt_state, noise=_params_on(noise, device))
