"""Hyper-parameter dataclasses (reference: reagent/core/parameters.py).

The port's copy of the five classes of ``reagent_tpu/core/parameters.py`` the
offline DQN path uses, of ``MDNRNNTrainerParameters`` (:71), of
``CONTINUOUS_TRAINING_ACTION_RANGE`` (:17) and of the ranking models'
``SlateOptMethod`` :28, ``SlateOptParameters`` :44, ``ConvNetParameters``
:165, ``TransformerParameters`` :174, ``LearningMethod`` :197,
``IPSClampMethod`` :204, ``IPSClamp`` :210, ``Seq2SlateParameters`` :216
and ``RankingParameters`` :225, and of the model-based family's
``Seq2RewardTrainerParameters`` :88, ``CEMTrainerParameters`` :101 and
``GRUParameters`` :185, and ``ProblemDomain`` :20, ``EvolutionParameters``
:122 and ``BaselineParameters`` :191,
kept identical so configs and normalization specs compare equal across the
two packages.
Plain frozen dataclasses — hashable so they can serve as cache keys.
Field names and defaults keep the reference's config contract
(reagent/core/parameters.py:47 ``RLParameters`` etc.) so YAML configs carry over.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import field
from typing import Dict, Optional, Tuple

# TD3/SAC train on normalized actions in this range, rescaled at serving time
# (reference: parameters.py:21).
CONTINUOUS_TRAINING_ACTION_RANGE: Tuple[float, float] = (-1.0, 1.0)


class ProblemDomain(enum.Enum):
    CONTINUOUS_ACTION = "continuous_action"
    DISCRETE_ACTION = "discrete_action"
    PARAMETRIC_ACTION = "parametric_action"
    SEQ_TO_REWARD = "seq2reward"
    MDN_RNN = "mdn_rnn"


def _tuple_safe(x):
    """Coerce lists (unhashable) to tuples so frozen params stay hashable."""
    if isinstance(x, list):
        return tuple(_tuple_safe(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _tuple_safe(v)) for k, v in x.items()))
    return x


@dataclasses.dataclass(frozen=True)
class RLParameters:
    """Reference: reagent/core/parameters.py:47-68."""

    gamma: float = 0.9
    epsilon: float = 0.1
    target_update_rate: float = 0.001
    maxq_learning: bool = True
    reward_boost: Optional[Dict[str, float]] = None
    temperature: float = 0.01
    softmax_policy: bool = False
    use_seq_num_diff_as_time_diff: bool = False
    q_network_loss: str = "mse"
    set_missing_value_to_zero: bool = False
    tensorboard_logging_freq: int = 0
    time_diff_unit_length: float = 1.0
    multi_steps: Optional[int] = None

    def __hash__(self) -> int:
        return hash(tuple(_tuple_safe(getattr(self, f.name)) for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class EvaluationParameters:
    calc_cpe_in_training: bool = True


@dataclasses.dataclass(frozen=True)
class EvolutionParameters:
    population_size: int = 1000
    mutation_power: float = 0.1
    learning_rate: float = 0.01


@dataclasses.dataclass(frozen=True)
class NormalizationParameters:
    """Per-feature normalization spec (reference: parameters.py:138-151)."""

    feature_type: str
    boxcox_lambda: Optional[float] = None
    boxcox_shift: Optional[float] = None
    mean: Optional[float] = None
    stddev: Optional[float] = None
    possible_values: Optional[Tuple[int, ...]] = None  # ENUM
    quantiles: Optional[Tuple[float, ...]] = None  # QUANTILE, sorted
    min_value: Optional[float] = None
    max_value: Optional[float] = None

    def __post_init__(self):
        # Coerce lists (e.g. from YAML/JSON) into hashable tuples.
        for name in ("possible_values", "quantiles"):
            v = getattr(self, name)
            if isinstance(v, list):
                object.__setattr__(self, name, tuple(v))


class NormalizationKey:
    STATE = "state"
    ACTION = "action"
    ITEM = "item"
    CANDIDATE = "candidate"


@dataclasses.dataclass(frozen=True)
class NormalizationData:
    dense_normalization_parameters: Dict[int, NormalizationParameters] = field(
        default_factory=dict
    )


@dataclasses.dataclass(frozen=True)
class MDNRNNTrainerParameters:
    """Reference: parameters.py:71."""

    hidden_size: int = 64
    num_hidden_layers: int = 2
    learning_rate: float = 0.001
    num_gaussians: int = 5
    reward_loss_weight: float = 1.0
    next_state_loss_weight: float = 1.0
    not_terminal_loss_weight: float = 1.0
    fit_only_one_next_step: bool = False
    action_dim: int = 2
    action_names: Optional[Tuple[str, ...]] = None
    multi_steps: int = 1


@dataclasses.dataclass(frozen=True)
class Seq2RewardTrainerParameters:
    """Reference: parameters.py:89."""

    learning_rate: float = 0.001
    multi_steps: int = 1
    action_names: Tuple[str, ...] = ()
    compress_model_learning_rate: float = 0.001
    gamma: float = 1.0
    view_q_value: bool = False
    step_predict_net_size: int = 64


@dataclasses.dataclass(frozen=True)
class CEMTrainerParameters:
    """Reference: parameters.py:103."""

    plan_horizon_length: int = 0
    num_world_models: int = 0
    cem_population_size: int = 0
    cem_num_iterations: int = 0
    ensemble_population_size: int = 0
    num_elites: int = 0
    mdnrnn: MDNRNNTrainerParameters = field(default_factory=MDNRNNTrainerParameters)
    rl: RLParameters = field(default_factory=RLParameters)
    alpha: float = 0.25
    epsilon: float = 0.001


@dataclasses.dataclass(frozen=True)
class GRUParameters:
    dim_model: int
    num_stacked_layers: int


@dataclasses.dataclass(frozen=True)
class BaselineParameters:
    dim_feedforward: int
    num_stacked_layers: int
    warmup_num_batches: int = 0


class SlateOptMethod(enum.Enum):
    GREEDY = "greedy"
    TOP_K = "top_k"
    EXACT = "exact"


@dataclasses.dataclass(frozen=True)
class SlateOptParameters:
    method: SlateOptMethod = SlateOptMethod.TOP_K


@dataclasses.dataclass(frozen=True)
class ConvNetParameters:
    conv_dims: Tuple[int, ...]
    conv_height_kernels: Tuple[int, ...]
    pool_types: Tuple[str, ...]
    pool_kernel_sizes: Tuple[int, ...]
    conv_width_kernels: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class TransformerParameters:
    """Reference: parameters.py:183."""

    num_heads: int = 1
    dim_model: int = 64
    dim_feedforward: int = 32
    num_stacked_layers: int = 2
    state_embed_dim: Optional[int] = None


class LearningMethod(enum.Enum):
    REINFORCEMENT_LEARNING = "reinforcement_learning"
    TEACHER_FORCING = "teacher_forcing"
    PAIRWISE_ATTENTION = "pairwise_attention"
    SIMULATION = "simulation"


class IPSClampMethod(enum.Enum):
    AGGRESSIVE = "aggressive"
    UNIVERSAL = "universal"


@dataclasses.dataclass(frozen=True)
class IPSClamp:
    clamp_method: IPSClampMethod = IPSClampMethod.UNIVERSAL
    clamp_max: float = 10.0


@dataclasses.dataclass(frozen=True)
class Seq2SlateParameters:
    """Reference: parameters_seq2slate.py / parameters.py:204."""

    on_policy: bool = True
    learning_method: LearningMethod = LearningMethod.REINFORCEMENT_LEARNING
    ips_clamp: Optional[IPSClamp] = None


@dataclasses.dataclass(frozen=True)
class RankingParameters:
    max_src_seq_len: int = 0
    max_tgt_seq_len: int = 0
    greedy_serving: bool = False
