"""World-model managers: the MDN-RNN world model and Seq2Reward.

Port of ``reagent_tpu/model_managers/world_model.py`` (``WorldModel`` :37,
``Seq2RewardModel`` :66; reference
reagent/model_managers/model_based/world_model.py:24-70 and
seq2reward_model.py:25-78): each builds its network from the trainer
parameters and the normalized widths (or explicit ones) and hands it to its
trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from reagent_tpu_torch.core.parameters import (
    MDNRNNTrainerParameters,
    NormalizationData,
    NormalizationKey,
    Seq2RewardTrainerParameters,
)
from reagent_tpu_torch.core.registry import MODEL_MANAGERS
from reagent_tpu_torch.model_managers.model_manager import ModelManager
from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
from reagent_tpu_torch.models.seq2reward_model import Seq2RewardNetwork
from reagent_tpu_torch.preprocessing.normalization import get_num_output_features
from reagent_tpu_torch.training.world_model.mdnrnn_trainer import MDNRNNTrainer
from reagent_tpu_torch.training.world_model.seq2reward_trainer import Seq2RewardTrainer


def dim_of(normalization_data_map, key: str, fallback: Optional[int]) -> int:
    """The normalized width of ``key``, else ``fallback``."""
    if normalization_data_map and key in normalization_data_map:
        return get_num_output_features(
            normalization_data_map[key].dense_normalization_parameters)
    if fallback is None:
        raise ValueError(f"need {key} normalization or an explicit dim")
    return fallback


def known_fields(cls, kwargs) -> Dict[str, Any]:
    """The entries of ``kwargs`` that name a field of the dataclass ``cls``."""
    known = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in dict(kwargs).items() if k in known}


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class WorldModel(ModelManager):
    trainer_param: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.params = MDNRNNTrainerParameters(
            **known_fields(MDNRNNTrainerParameters, self.trainer_param))

    def build_trainer(
        self,
        normalization_data_map: Optional[Dict[str, NormalizationData]] = None,
        use_gpu: bool = False,
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
        device="cuda",
    ) -> MDNRNNTrainer:
        """``use_gpu`` has no effect; ``device`` places the trainer."""
        memory_network = MemoryNetwork(
            state_dim=dim_of(normalization_data_map, NormalizationKey.STATE, state_dim),
            action_dim=dim_of(normalization_data_map, NormalizationKey.ACTION, action_dim),
            num_hiddens=self.params.hidden_size,
            num_hidden_layers=self.params.num_hidden_layers,
            num_gaussians=self.params.num_gaussians,
        )
        return MDNRNNTrainer(memory_network=memory_network, params=self.params, device=device)


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class Seq2RewardModel(ModelManager):
    trainer_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    net_builder: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.params = Seq2RewardTrainerParameters(
            **known_fields(Seq2RewardTrainerParameters, self.trainer_param))

    def build_trainer(
        self,
        normalization_data_map: Optional[Dict[str, NormalizationData]] = None,
        use_gpu: bool = False,
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
        device="cuda",
    ) -> Seq2RewardTrainer:
        """The network is 64 hidden units in 2 layers unless ``net_builder``
        says otherwise; ``use_gpu`` has no effect."""
        nb = dict(self.net_builder)
        seq2reward_network = Seq2RewardNetwork(
            state_dim=dim_of(normalization_data_map, NormalizationKey.STATE, state_dim),
            action_dim=action_dim or len(self.params.action_names),
            num_hiddens=nb.get("num_hiddens", 64),
            num_hidden_layers=nb.get("num_hidden_layers", 2),
        )
        return Seq2RewardTrainer(seq2reward_network=seq2reward_network, params=self.params,
                                 device=device)
