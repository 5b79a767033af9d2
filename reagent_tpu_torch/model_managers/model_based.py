"""Model-based managers: the CEM planner and synthetic reward.

Port of ``reagent_tpu/model_managers/model_based.py`` (``CrossEntropyMethod``
:42, ``SyntheticReward`` :113; reference
reagent/model_managers/model_based/cross_entropy_method.py:33-152 and
synthetic_reward.py:60-268).  ``CrossEntropyMethod`` builds one MDN-RNN
trainer per world model and a planner over them (gamma 1, the terminal
head effective); the planner's parameters are set once the world models are
trained.  ``SyntheticReward`` builds its net from the builder union and a
``RewardNetTrainer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

import reagent_tpu_torch.net_builder  # noqa: F401 — registers the builders
from reagent_tpu_torch.core.parameters import (
    CEMTrainerParameters,
    MDNRNNTrainerParameters,
    NormalizationData,
    NormalizationKey,
)
from reagent_tpu_torch.core.registry import MODEL_MANAGERS, SYNTHETIC_REWARD_NET_BUILDERS
from reagent_tpu_torch.model_managers.model_manager import ModelManager
from reagent_tpu_torch.model_managers.world_model import dim_of, known_fields
from reagent_tpu_torch.models.cem_planner import CEMPlannerNetwork
from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
from reagent_tpu_torch.training.cem_trainer import CEMTrainer
from reagent_tpu_torch.training.reward_network_trainer import LossFunction, RewardNetTrainer
from reagent_tpu_torch.training.world_model.mdnrnn_trainer import MDNRNNTrainer


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class CrossEntropyMethod(ModelManager):
    trainer_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    discrete_action: bool = True

    def __post_init__(self):
        tp = dict(self.trainer_param)
        mdnrnn = MDNRNNTrainerParameters(
            **known_fields(MDNRNNTrainerParameters, tp.pop("mdnrnn", {}) or {}))
        cem = known_fields(CEMTrainerParameters, tp)
        cem.pop("mdnrnn", None)
        self.params = CEMTrainerParameters(mdnrnn=mdnrnn, **cem)

    def build_trainer(
        self,
        normalization_data_map: Optional[Dict[str, NormalizationData]] = None,
        use_gpu: bool = False,
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
        action_upper_bounds: Optional[np.ndarray] = None,
        action_lower_bounds: Optional[np.ndarray] = None,
        device="cuda",
    ) -> CEMTrainer:
        """``use_gpu`` has no effect; ``device`` places the trainers and the
        planner."""
        p = self.params
        sdim = dim_of(normalization_data_map, NormalizationKey.STATE, state_dim)
        adim = (action_dim if action_dim is not None
                else dim_of(normalization_data_map, NormalizationKey.ACTION, None))
        mem_net = MemoryNetwork(
            state_dim=sdim, action_dim=adim, num_hiddens=p.mdnrnn.hidden_size,
            num_hidden_layers=p.mdnrnn.num_hidden_layers, num_gaussians=p.mdnrnn.num_gaussians)
        world_model_trainers: List[MDNRNNTrainer] = [
            MDNRNNTrainer(memory_network=mem_net, params=p.mdnrnn, device=device)
            for _ in range(p.num_world_models)]
        cem_planner_network = CEMPlannerNetwork(
            mem_net=mem_net,
            mem_net_params_list=[None] * p.num_world_models,
            cem_num_iterations=p.cem_num_iterations,
            cem_population_size=p.cem_population_size,
            ensemble_population_size=p.ensemble_population_size,
            num_elites=p.num_elites,
            plan_horizon_length=p.plan_horizon_length,
            state_dim=sdim,
            action_dim=adim,
            discrete_action=self.discrete_action,
            terminal_effective=True,
            gamma=1.0,
            action_upper_bounds=action_upper_bounds,
            action_lower_bounds=action_lower_bounds,
            device=device,
        )
        return CEMTrainer(cem_planner_network=cem_planner_network,
                          world_model_trainers=world_model_trainers, parameters=p)


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class SyntheticReward(ModelManager):
    """Learn per-step rewards from delayed episode feedback."""

    trainer_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"SingleStepSyntheticReward": {}})

    def __post_init__(self):
        self._tp = dict(self.trainer_param)

    def build_trainer(
        self,
        normalization_data_map: Optional[Dict[str, NormalizationData]] = None,
        use_gpu: bool = False,
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
        device="cuda",
    ) -> RewardNetTrainer:
        sdim = dim_of(normalization_data_map, NormalizationKey.STATE, state_dim)
        adim = (action_dim if action_dim is not None
                else dim_of(normalization_data_map, NormalizationKey.ACTION, None))
        builder = SYNTHETIC_REWARD_NET_BUILDERS.build(self.net_builder)
        reward_net = builder.build_synthetic_reward_network(
            None, None, state_dim=sdim, action_dim=adim)
        tp = self._tp
        loss = tp.get("loss_type", "MSE")
        return RewardNetTrainer(
            reward_net=reward_net,
            optimizer=tp.get("optimizer"),
            loss_type=LossFunction[loss] if isinstance(loss, str) else loss,
            reward_ignore_threshold=tp.get("reward_ignore_threshold"),
            weighted_by_inverse_propensity=tp.get("weighted_by_inverse_propensity", False),
            device=device,
        )
