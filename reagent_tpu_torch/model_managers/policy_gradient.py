"""Policy-gradient model managers: ``Reinforce`` and ``PPO``.

Port of ``reagent_tpu/model_managers/policy_gradient.py`` (reference:
reagent/model_managers/policy_gradient/{reinforce.py:34-133,
ppo.py:33-135}): a discrete policy net (a DQN-shaped scorer from the
discrete-DQN builders, which takes a possible-actions mask) with a softmax
sampler, and an optional value-net baseline from the value builders.
``create_policy`` scores through ``training/functional.py::score`` (one K3
launch for a dense MLP on a CUDA tensor).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import reagent_tpu_torch.net_builder  # noqa: F401 — registers net builders
from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationKey
from reagent_tpu_torch.core.registry import (
    DISCRETE_DQN_NET_BUILDERS,
    MODEL_MANAGERS,
    VALUE_NET_BUILDERS,
)
from reagent_tpu_torch.gym.policies.policy import Policy, discrete_q_scorer
from reagent_tpu_torch.gym.policies.samplers import SoftmaxActionSampler
from reagent_tpu_torch.model_managers.model_manager import ModelManager
from reagent_tpu_torch.preprocessing.normalization import get_num_output_features
from reagent_tpu_torch.training.ppo_trainer import PPOTrainer
from reagent_tpu_torch.training.reinforce_trainer import ReinforceTrainer


@dataclasses.dataclass
class _PolicyGradientBase(ModelManager):
    trainer_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    policy_net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"FullyConnected": {}}
    )
    value_net_builder: Optional[Dict[str, Any]] = None
    sampler_temperature: float = 1.0

    def __post_init__(self):
        tp = dict(self.trainer_param)
        self.action_names: List[str] = [str(a) for a in tp.get("actions", [])]
        self._tp = tp

    def state_dim(self, normalization_data_map: Dict[str, NormalizationData]) -> int:
        return get_num_output_features(
            normalization_data_map[NormalizationKey.STATE].dense_normalization_parameters
        )

    def _build_nets(self, normalization_data_map, state_dim: Optional[int] = None):
        num_actions = len(self.action_names)
        if num_actions <= 1:
            raise ValueError(f"need at least 2 actions, got {self.action_names}")
        state_norm = (normalization_data_map.get(NormalizationKey.STATE)
                      if normalization_data_map else None)
        scorer = DISCRETE_DQN_NET_BUILDERS.build(self.policy_net_builder).build_q_network(
            state_norm, output_dim=num_actions, state_dim=state_dim)
        value_net = None
        if self.value_net_builder:
            value_net = VALUE_NET_BUILDERS.build(self.value_net_builder).build_value_network(
                state_norm, state_dim=state_dim)
        return scorer, value_net

    def _sampler(self) -> SoftmaxActionSampler:
        return SoftmaxActionSampler(temperature=self.sampler_temperature)

    def create_policy(self, trainer, trainer_state=None, serving: bool = False) -> Policy:
        """The softmax policy over the trainer's scorer, on a parameter dict
        (``trainer_state.policy_params``)."""
        return Policy(scorer=discrete_q_scorer(trainer.scorer), sampler=self._sampler())


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class Reinforce(_PolicyGradientBase):
    def build_trainer(
        self,
        normalization_data_map: Optional[Dict[str, NormalizationData]] = None,
        use_gpu: bool = False,
        state_dim: Optional[int] = None,
        device="cuda",
    ) -> ReinforceTrainer:
        """``use_gpu`` is accepted so the JAX package's configs load; it has
        no effect — ``device`` places the trainer."""
        scorer, value_net = self._build_nets(normalization_data_map, state_dim)
        tp = self._tp
        return ReinforceTrainer(
            scorer=scorer,
            sampler=self._sampler(),
            value_net=value_net,
            gamma=tp.get("gamma", 0.0),
            optimizer=tp.get("optimizer"),
            optimizer_value_net=tp.get("optimizer_value_net"),
            off_policy=tp.get("off_policy", False),
            clip_param=tp.get("clip_param", 1e6),
            normalize=tp.get("normalize", True),
            subtract_mean=tp.get("subtract_mean", True),
            device=device,
        )


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class PPO(_PolicyGradientBase):
    def build_trainer(
        self,
        normalization_data_map: Optional[Dict[str, NormalizationData]] = None,
        use_gpu: bool = False,
        state_dim: Optional[int] = None,
        device="cuda",
    ) -> PPOTrainer:
        """``use_gpu`` is accepted so the JAX package's configs load; it has
        no effect — ``device`` places the trainer."""
        scorer, value_net = self._build_nets(normalization_data_map, state_dim)
        tp = self._tp
        return PPOTrainer(
            scorer=scorer,
            sampler=self._sampler(),
            value_net=value_net,
            gamma=tp.get("gamma", 0.0),
            optimizer=tp.get("optimizer"),
            optimizer_value_net=tp.get("optimizer_value_net"),
            normalize=tp.get("normalize", False),
            subtract_mean=tp.get("subtract_mean", False),
            update_epochs=tp.get("update_epochs", 1),
            ppo_epsilon=tp.get("ppo_epsilon", 0.2),
            entropy_weight=tp.get("entropy_weight", 0.0),
            device=device,
        )
