"""DiscreteCRR model manager (offline discrete control).

Port of ``reagent_tpu/model_managers/discrete_crr.py`` (reference:
reagent/model_managers/discrete/discrete_crr.py): ``DiscreteDQN``'s data
plumbing with the CRR trainer.  The actor (logits) is built from
``actor_net_builder`` and the twin critics from ``net_builder``, both
through the discrete-DQN builders, as the JAX manager builds them; the
serving artifact is the **actor** as a discrete-DQN ``manifest.json`` +
``weights.bin``, which the C++ scorer and ``load_predictor`` read, with the
actor's true activations (the JAX manager writes relu for every hidden
layer; see ``ROADMAP.md`` §3).  The CRR trainer has no CPE heads, so the
workflow runs no evaluation for it, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationKey
from reagent_tpu_torch.core.registry import DISCRETE_DQN_NET_BUILDERS, MODEL_MANAGERS
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.reporting.reporters import DiscreteCRRReporter
from reagent_tpu_torch.training.discrete_crr_trainer import DiscreteCRRTrainer


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class DiscreteCRR(DiscreteDQN):
    actor_net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"FullyConnected": {}}
    )

    def get_reporter(self) -> DiscreteCRRReporter:
        return DiscreteCRRReporter(actions=list(self._param.actions))

    def build_trainer(
        self,
        normalization_data_map: Dict[str, NormalizationData],
        use_gpu: bool = False,
        device="cuda",
    ) -> DiscreteCRRTrainer:
        """``use_gpu`` is accepted so the JAX package's configs load; it has
        no effect — ``device`` places the trainer."""
        state_norm = normalization_data_map[NormalizationKey.STATE]
        num_actions = len(self._param.actions)
        actor_builder = DISCRETE_DQN_NET_BUILDERS.build(self.actor_net_builder)
        actor_network = actor_builder.build_q_network(state_norm, output_dim=num_actions)
        q_builder = DISCRETE_DQN_NET_BUILDERS.build(self.net_builder)
        q1_network = q_builder.build_q_network(state_norm, output_dim=num_actions)
        q2_network = q_builder.build_q_network(state_norm, output_dim=num_actions)
        tp = dict(self.trainer_param)
        return DiscreteCRRTrainer(
            emit_reporter_arrays=True,
            actor_network=actor_network,
            q1_network=q1_network,
            q2_network=q2_network,
            rl=self.rl_parameters,
            q_network_optimizer=self._param.optimizer,
            actor_network_optimizer=tp.get("actor_network_optimizer", self._param.optimizer),
            beta=tp.get("beta", 1.0),
            max_weight=tp.get("max_weight", 20.0),
            device=device,
        )

    def build_serving_module(self, trainer, trainer_state, normalization_data_map):
        """The actor's logits as the serving scorer, on the trainer's device."""
        from reagent_tpu_torch.prediction.predictor_wrapper import (
            DiscreteDqnPredictorWrapper,
            DiscreteDqnWithPreprocessor,
        )

        actor = trainer.export_actor_network(trainer_state)
        if not isinstance(actor, FullyConnectedDQN):
            raise ValueError(
                "the manifest.json + weights.bin artifact holds a flat MLP; a "
                f"{type(actor).__name__} actor cannot be exported through it")
        state_norm = normalization_data_map[NormalizationKey.STATE]
        pre = Preprocessor(state_norm.dense_normalization_parameters, device=trainer.device)
        return DiscreteDqnPredictorWrapper(
            DiscreteDqnWithPreprocessor(actor, pre), self._param.actions,
            activations=actor.activations)
