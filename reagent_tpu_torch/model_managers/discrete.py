"""Distributional discrete-DQN model managers: QR-DQN.

Port of ``reagent_tpu/model_managers/discrete.py::DiscreteQRDQN`` (:62-100;
reference: reagent/model_managers/discrete/discrete_qrdqn.py:30-131): the
data plumbing of ``DiscreteDQN`` with a quantile net and ``QRDQNTrainer``.
``DiscreteC51DQN`` waits for the C51 slice (``ROADMAP.md`` §1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationKey
from reagent_tpu_torch.core.registry import MODEL_MANAGERS, QR_DQN_NET_BUILDERS
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer


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
