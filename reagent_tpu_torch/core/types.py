"""Typed training batches as tensor dataclasses.

Port of ``reagent_tpu/core/types.py``: the sparse feature types
(``IdListFeature`` :40, ``IdScoreListFeature`` :58) and the host-side feature
configuration (``IdListFeatureConfig`` :72, ``IdScoreListFeatureConfig`` :81,
``FloatFeatureInfo`` :90, ``IdMappingConfig`` :98, ``ModelFeatureConfig``
:109), ``DocList`` :154, ``FeatureData`` :179 (its ``candidate_docs`` and
helpers :215-223), ``ValuePresence`` :229, ``GaussianSamplerScore``
:237, ``ActorOutput`` :246, ``ExtraData`` :255, ``BaseInput`` :275,
``DiscreteDqnInput`` :290, ``SlateQInput`` :301, ``ParametricDqnInput``
:315, ``PolicyNetworkInput`` :329, ``PolicyGradientInput`` :338,
``BanditRewardModelInput`` :358, ``BehavioralCloningModelInput`` :368,
``MemoryNetworkInput`` :377, ``MemoryNetworkOutput`` :389,
``PreprocessedRankingInput`` :442, ``RankingOutput`` :472,
``Seq2RewardOutput`` :403, ``CBInput`` :410, ``stack_feature_data`` :487
and ``batch_to_device`` :492.  Fields hold
``torch.Tensor``s (or ``None``); ``.to(device)`` moves every tensor field,
recursing into nested batches and into dicts of them (a ``FeatureData``'s
``{name: IdListFeature}``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

Tensor = torch.Tensor


def _move(v, device):
    if isinstance(v, (Tensor, _TensorDataClass)):
        return v.to(device)
    if isinstance(v, dict):
        return {k: _move(x, device) for k, x in v.items()}
    return v


class _TensorDataClass:
    def to(self, device) -> "_TensorDataClass":
        return dataclasses.replace(
            self, **{f.name: _move(getattr(self, f.name), device)
                     for f in dataclasses.fields(self)})

    def replace(self, **changes) -> "_TensorDataClass":
        """A copy with ``changes`` (flax's ``struct.dataclass.replace``)."""
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Sparse (ID-list) features: fixed-width padded rows with a validity mask
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IdListFeature(_TensorDataClass):
    """A jagged ID-list feature padded to ``[batch, max_len]``: ``ids``
    (integers, 0 in the padding) and ``mask`` (True or 1 where an id is)."""

    ids: Tensor
    mask: Tensor

    @property
    def lengths(self) -> Tensor:
        return self.mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)


@dataclasses.dataclass
class IdScoreListFeature(_TensorDataClass):
    """Padded jagged (id, score) pairs: weighted ID-list features."""

    ids: Tensor
    scores: Tensor
    mask: Tensor


# ---------------------------------------------------------------------------
# Feature configuration (host-side and static)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IdListFeatureConfig:
    name: str
    feature_id: int
    id_mapping_name: str


@dataclasses.dataclass(frozen=True)
class IdScoreListFeatureConfig:
    name: str
    feature_id: int
    id_mapping_name: str


@dataclasses.dataclass(frozen=True)
class FloatFeatureInfo:
    name: str
    feature_id: int


@dataclasses.dataclass(frozen=True)
class IdMappingConfig:
    """The embedding table of one ID space."""

    embedding_table_size: int
    embedding_dim: int
    hashing: bool = True
    pooling: str = "mean"  # "mean" | "sum"
    max_length: int = 32  # padded width of the jagged dimension


@dataclasses.dataclass
class ModelFeatureConfig:
    """The dense and sparse features a model reads.  Sparse feature ids and
    names must each be distinct across the id-list and id-score-list
    configs (``ValueError`` otherwise)."""

    float_feature_infos: List[FloatFeatureInfo] = dataclasses.field(default_factory=list)
    id_mapping_config: Dict[str, IdMappingConfig] = dataclasses.field(default_factory=dict)
    id_list_feature_configs: List[IdListFeatureConfig] = dataclasses.field(default_factory=list)
    id_score_list_feature_configs: List[IdScoreListFeatureConfig] = dataclasses.field(
        default_factory=list
    )

    def __post_init__(self) -> None:
        both = list(self.id_list_feature_configs) + list(self.id_score_list_feature_configs)
        ids = [c.feature_id for c in both]
        names = [c.name for c in both]
        if len(ids) != len(set(ids)):
            raise ValueError(f"duplicate sparse feature ids: {ids}")
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate sparse feature names: {names}")
        self._id2name = {c.feature_id: c.name for c in both}
        self._name2id = {c.name: c.feature_id for c in both}
        self._name2config = {c.name: c for c in both}

    @property
    def only_dense(self) -> bool:
        return not (self.id_list_feature_configs or self.id_score_list_feature_configs)

    @property
    def id2name(self) -> Dict[int, str]:
        return self._id2name

    @property
    def name2id(self) -> Dict[str, int]:
        return self._name2id

    @property
    def name2config(self) -> Dict[str, Any]:
        return self._name2config


# ---------------------------------------------------------------------------
# Feature containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DocList(_TensorDataClass):
    """A slate of candidate documents (reference types.py:254):
    ``float_features`` [batch, num_candidates, dim], ``mask`` and ``value``
    [batch, num_candidates]."""

    float_features: Tensor
    mask: Optional[Tensor] = None
    value: Optional[Tensor] = None

    def select_slate(self, action: Tensor) -> "DocList":
        """The docs at slate positions ``action`` [batch, slate_size]."""
        row = torch.arange(self.float_features.shape[0], device=action.device)[:, None]
        action = action.to(torch.int64)
        return DocList(
            float_features=self.float_features[row, action],
            mask=None if self.mask is None else self.mask[row, action],
            value=None if self.value is None else self.value[row, action],
        )

    def as_feature_data(self) -> "FeatureData":
        b, n, d = self.float_features.shape
        return FeatureData(float_features=self.float_features.reshape(b * n, d))


@dataclasses.dataclass
class FeatureData(_TensorDataClass):
    """Dense and sparse features for one entity (reference types.py:314),
    and the candidate documents of the ranking models (``candidate_docs``)."""

    float_features: Tensor
    id_list_features: Optional[Dict[str, IdListFeature]] = None
    id_score_list_features: Optional[Dict[str, IdScoreListFeature]] = None
    stacked_float_features: Optional[Tensor] = None
    time_since_first: Optional[Tensor] = None
    candidate_docs: Optional[DocList] = None

    @property
    def has_float_features_only(self) -> bool:
        return (
            not self.id_list_features
            and not self.id_score_list_features
            and self.time_since_first is None
            and self.candidate_docs is None
        )

    def get_ranking_state(self, has_user_feat: bool) -> Tensor:
        """The user and docs concatenated, or the docs alone (reference
        types.py:382-387)."""
        if has_user_feat:
            return self.concat_user_doc()
        if self.candidate_docs is None:
            raise ValueError("get_ranking_state needs candidate_docs")
        return self.candidate_docs.float_features

    def concat_user_doc(self) -> Tensor:
        """[b, user_dim + num_docs * doc_dim] (reference types.py:367)."""
        if self.candidate_docs is None:
            raise ValueError("concat_user_doc needs candidate_docs")
        b, n, d = self.candidate_docs.float_features.shape
        return torch.cat(
            [self.float_features, self.candidate_docs.float_features.reshape(b, n * d)], dim=1)

    def get_tiled_batch(self, num_tiles: int) -> "FeatureData":
        """Each row repeated ``num_tiles`` times in place, [b, d] -> [b*t, d]
        (``[s0, s0, s1, s1, ...]``, as ``jnp.repeat``; reference
        types.py:350), the layout of max-over-possible-actions Q."""
        return FeatureData(
            float_features=self.float_features.repeat_interleave(num_tiles, dim=0))


@dataclasses.dataclass
class ValuePresence(_TensorDataClass):
    """Raw (value, presence) pair before normalization (reference types.py:241)."""

    value: Tensor
    presence: Optional[Tensor] = None


@dataclasses.dataclass
class GaussianSamplerScore(_TensorDataClass):
    """A gaussian policy head's (loc, log-scale) (reference
    reagent/gym/types.py GaussianSamplerScore; JAX types.py:237)."""

    loc: Tensor
    scale_log: Tensor


@dataclasses.dataclass
class ActorOutput(_TensorDataClass):
    """A sampler's output (reference types.py:247)."""

    action: Tensor
    log_prob: Optional[Tensor] = None
    squashed_mean: Optional[Tensor] = None


@dataclasses.dataclass
class ExtraData(_TensorDataClass):
    """Logged metadata riding alongside a batch (reference types.py:442)."""

    mdp_id: Optional[Tensor] = None
    sequence_number: Optional[Tensor] = None
    action_probability: Optional[Tensor] = None
    max_num_actions: Optional[int] = None
    metrics: Optional[Tensor] = None


@dataclasses.dataclass
class BaseInput(_TensorDataClass):
    """The MDP-transition fields every transition batch has (reference
    types.py:689)."""

    state: FeatureData
    next_state: FeatureData
    reward: Tensor
    time_diff: Optional[Tensor]
    step: Optional[Tensor]
    not_terminal: Tensor

    def batch_size(self) -> int:
        return self.state.float_features.shape[0]


@dataclasses.dataclass
class DiscreteDqnInput(BaseInput):
    """Reference types.py:774.  ``action`` is one-hot [b, num_actions]."""

    action: Tensor = None
    next_action: Tensor = None
    possible_actions_mask: Tensor = None
    possible_next_actions_mask: Tensor = None
    extras: ExtraData = dataclasses.field(default_factory=ExtraData)


@dataclasses.dataclass
class SlateQInput(BaseInput):
    """Reference types.py:821: ``action`` [b, slate_size] item indices into
    ``state.candidate_docs``; ``reward`` and ``reward_mask`` [b,
    slate_size], one per position."""

    action: Tensor = None
    next_action: Tensor = None
    reward_mask: Tensor = None
    extras: Optional[ExtraData] = None


@dataclasses.dataclass
class ParametricDqnInput(BaseInput):
    """Reference types.py:868: actions are feature vectors.  The possible
    actions are ``[b * max_num_actions, action_dim]``, row ``i * M + j``
    the j-th possible action of row i."""

    action: FeatureData = None
    next_action: FeatureData = None
    possible_actions: FeatureData = None
    possible_actions_mask: Tensor = None
    possible_next_actions: FeatureData = None
    possible_next_actions_mask: Tensor = None
    extras: Optional[ExtraData] = None
    weight: Optional[Tensor] = None


@dataclasses.dataclass
class PolicyNetworkInput(BaseInput):
    """Continuous-control transition batch (reference types.py:901):
    ``action`` and ``next_action`` hold the dense action features."""

    action: FeatureData = None
    next_action: FeatureData = None
    extras: ExtraData = dataclasses.field(default_factory=ExtraData)


@dataclasses.dataclass
class PolicyGradientInput(_TensorDataClass):
    """One full episode, padded to a fixed length (reference types.py:920).

    ``action`` is one-hot [T, num_actions]; ``reward`` and ``log_prob`` are
    [T].  ``valid_mask`` [T] marks the real steps of an episode padded to
    ``max_steps`` (the JAX package's static shapes, kept so an episode stays
    on the device); None means every step is real."""

    state: FeatureData
    action: Tensor
    reward: Tensor
    log_prob: Tensor
    possible_actions_mask: Optional[Tensor] = None
    valid_mask: Optional[Tensor] = None

    def batch_size(self) -> int:
        return self.state.float_features.shape[0]


@dataclasses.dataclass
class BanditRewardModelInput(_TensorDataClass):
    """A logged bandit batch for a reward model (reference types.py:964):
    ``action`` one-hot [B, num_actions], ``reward`` [B] or [B, 1],
    ``action_prob`` the logged propensity [B, 1]."""

    state: FeatureData
    action: Tensor
    reward: Tensor
    action_prob: Optional[Tensor] = None


@dataclasses.dataclass
class BehavioralCloningModelInput(_TensorDataClass):
    """Logged states and one-hot actions for behavioural cloning (reference
    types.py:985)."""

    state: FeatureData
    action: Tensor
    possible_actions_mask: Optional[Tensor] = None


@dataclasses.dataclass
class MemoryNetworkInput(BaseInput):
    """World-model training sequences (reference types.py:1004): every
    leading dim is [seq_len, batch, ...]; ``action`` is a ``FeatureData``."""

    action: FeatureData = None
    valid_step: Optional[Tensor] = None
    extras: ExtraData = dataclasses.field(default_factory=ExtraData)


@dataclasses.dataclass
class MemoryNetworkOutput(_TensorDataClass):
    """MDN-RNN forward output (reference types.py:1045): the mixture's
    ``mus``/``sigmas`` [T, B, G, S] and ``logpi`` [T, B, G], the reward and
    not-terminal logits [T, B], the last layer's final hidden and cell state
    [B, H] and its hidden state at every step [T, B, H]."""

    mus: Tensor
    sigmas: Tensor
    logpi: Tensor
    reward: Tensor
    not_terminal: Tensor
    last_step_hidden: Tensor
    last_step_cell: Tensor
    all_steps_hidden: Tensor


@dataclasses.dataclass
class PreprocessedRankingInput(_TensorDataClass):
    """Seq2Slate's batch (reference types.py:455).  The vocabulary of the
    reference: 0 is padding, 1 the decoder's start symbol, candidate i sits
    at index i + 2."""

    state: FeatureData
    src_seq: FeatureData
    src_src_mask: Optional[Tensor] = None
    tgt_in_seq: Optional[FeatureData] = None
    tgt_out_seq: Optional[FeatureData] = None
    tgt_tgt_mask: Optional[Tensor] = None
    slate_reward: Optional[Tensor] = None
    position_reward: Optional[Tensor] = None
    src_in_idx: Optional[Tensor] = None
    tgt_in_idx: Optional[Tensor] = None
    tgt_out_idx: Optional[Tensor] = None
    tgt_out_probs: Optional[Tensor] = None
    optim_tgt_in_idx: Optional[Tensor] = None
    optim_tgt_out_idx: Optional[Tensor] = None
    optim_tgt_in_seq: Optional[FeatureData] = None
    optim_tgt_out_seq: Optional[FeatureData] = None
    extras: Optional[ExtraData] = None

    def batch_size(self) -> int:
        return self.state.float_features.shape[0]


@dataclasses.dataclass
class RankingOutput(_TensorDataClass):
    """Seq2Slate's output (reference types.py:1078)."""

    ranked_tgt_out_idx: Optional[Tensor] = None
    ranked_per_symbol_probs: Optional[Tensor] = None
    ranked_per_seq_probs: Optional[Tensor] = None
    log_probs: Optional[Tensor] = None
    encoder_scores: Optional[Tensor] = None


@dataclasses.dataclass
class Seq2RewardOutput(_TensorDataClass):
    """Seq2Reward's output (reference types.py:1056): the accumulated reward
    of each action sequence, [B, 1]."""

    acc_reward: Tensor


@dataclasses.dataclass
class CBInput(_TensorDataClass):
    """A contextual-bandit batch (reference types.py:1123):
    ``context_arm_features`` [B, num_arms, feature_dim]; ``action``,
    ``reward``, ``log_prob``, ``weight``, ``importance_weight`` [B, 1];
    ``arms`` [B, num_arms] ids; ``arm_presence`` [B, num_arms]."""

    context_arm_features: Tensor
    arm_presence: Optional[Tensor] = None
    action: Optional[Tensor] = None
    reward: Optional[Tensor] = None
    label: Optional[Tensor] = None
    log_prob: Optional[Tensor] = None
    weight: Optional[Tensor] = None
    arms: Optional[Tensor] = None
    mdp_id: Optional[Tensor] = None
    importance_weight: Optional[Tensor] = None
    features_of_chosen_arm: Optional[Tensor] = None
    chosen_arm_id: Optional[Tensor] = None

    @classmethod
    def input_prototype(cls, batch_size: int = 2, num_arms: int = 3, dim: int = 4,
                        device="cpu") -> "CBInput":
        return cls(context_arm_features=torch.ones((batch_size, num_arms, dim), device=device))

    @property
    def device(self) -> torch.device:
        return self.context_arm_features.device

    def batch_size(self) -> int:
        return self.context_arm_features.shape[0]


def _stack(xs):
    first = xs[0]
    if first is None:
        return None
    if isinstance(first, Tensor):
        return torch.stack(xs)
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in xs]) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(x, f.name) for x in xs]) for f in dataclasses.fields(first)})
    return first


def stack_feature_data(items: List[FeatureData]) -> FeatureData:
    """Stack unbatched ``FeatureData`` into one batch, field by field (sparse
    dicts included), as ``jax.tree_util.tree_map(jnp.stack)``."""
    return _stack(list(items))


def batch_to_device(batch: Any, device="cuda") -> Any:
    """A batch (a tensor dataclass, a dict of them or a tensor) on
    ``device``: the port's ``jax.device_put``."""
    return _move(batch, device)
