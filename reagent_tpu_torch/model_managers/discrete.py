"""Distributional discrete-DQN model managers: C51 and QR-DQN.

Port of ``reagent_tpu/model_managers/discrete.py`` (``DiscreteC51DQN`` :26,
``DiscreteQRDQN`` :62; reference:
reagent/model_managers/discrete/discrete_c51dqn.py:28-122 and
discrete_qrdqn.py:30-131): the data plumbing of ``DiscreteDQN`` with a
distributional net and its trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationKey
from reagent_tpu_torch.core.registry import (
    CATEGORICAL_DQN_NET_BUILDERS,
    MODEL_MANAGERS,
    QR_DQN_NET_BUILDERS,
)
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training.c51_trainer import C51Trainer
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class DiscreteC51DQN(DiscreteDQN):
    net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"Categorical": {}}
    )

    def build_trainer(
        self,
        normalization_data_map: Dict[str, NormalizationData],
        use_gpu: bool = False,
        device="cuda",
    ) -> C51Trainer:
        """``use_gpu`` is accepted so the JAX package's configs load; it has
        no effect — ``device`` places the trainer."""
        state_norm = normalization_data_map[NormalizationKey.STATE]
        num_actions = len(self._param.actions)
        builder = CATEGORICAL_DQN_NET_BUILDERS.build(self.net_builder)
        q_network = builder.build_q_network(state_norm, output_dim=num_actions)
        return C51Trainer(
            q_network=q_network,
            rl=self.rl_parameters,
            double_q_learning=self._param.double_q_learning,
            optimizer=self._param.optimizer,
            action_names=tuple(self._param.actions),
            device=device,
        )

    def build_serving_module(self, trainer: C51Trainer, trainer_state, normalization_data_map):
        """E[Z] scoring artifact (ref discrete_c51dqn.py:96-122)."""
        from reagent_tpu_torch.prediction.predictor_wrapper import (
            CategoricalDqnPredictorWrapper,
        )

        state_norm = normalization_data_map[NormalizationKey.STATE]
        pre = Preprocessor(state_norm.dense_normalization_parameters, device=trainer.device)
        return CategoricalDqnPredictorWrapper(
            trainer.export_q_network(trainer_state), pre, self._param.actions)


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class DiscreteQRDQN(DiscreteDQN):
    net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"QuantileFullyConnected": {}}
    )

    def build_trainer(
        self,
        normalization_data_map: Dict[str, NormalizationData],
        use_gpu: bool = False,
        device="cuda",
    ) -> QRDQNTrainer:
        """``use_gpu`` is accepted so the JAX package's configs load; it has
        no effect — ``device`` places the trainer."""
        state_norm = normalization_data_map[NormalizationKey.STATE]
        num_actions = len(self._param.actions)
        builder = QR_DQN_NET_BUILDERS.build(self.net_builder)
        q_network = builder.build_q_network(state_norm, output_dim=num_actions)
        return QRDQNTrainer(
            q_network=q_network,
            num_atoms=builder.num_atoms,
            rl=self.rl_parameters,
            double_q_learning=self._param.double_q_learning,
            optimizer=self._param.optimizer,
            action_names=tuple(self._param.actions),
            device=device,
        )

    def build_serving_module(self, trainer: QRDQNTrainer, trainer_state, normalization_data_map):
        """Mean-over-atoms Q artifact (ref discrete_qrdqn.py:100-131)."""
        from reagent_tpu_torch.prediction.predictor_wrapper import (
            make_quantile_dqn_predictor_wrapper,
        )

        state_norm = normalization_data_map[NormalizationKey.STATE]
        pre = Preprocessor(state_norm.dense_normalization_parameters, device=trainer.device)
        return make_quantile_dqn_predictor_wrapper(
            trainer.export_q_network(trainer_state), pre, self._param.actions,
            trainer.num_atoms,
        )
