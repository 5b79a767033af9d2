"""SlateQ model manager.

Port of ``reagent_tpu/model_managers/slate_q.py`` (``SlateQ`` :29;
reference reagent/model_managers/slate_q_base.py + discrete/slate_q.py): a
parametric Q(s, doc) critic scored per candidate, decomposed over the slate
by ``SlateQTrainer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

import reagent_tpu_torch.net_builder  # noqa: F401 — registers the builders
from reagent_tpu_torch.core.parameters import (
    NormalizationData,
    NormalizationKey,
    RLParameters,
)
from reagent_tpu_torch.core.registry import MODEL_MANAGERS, PARAMETRIC_DQN_NET_BUILDERS
from reagent_tpu_torch.model_managers.model_manager import ModelManager
from reagent_tpu_torch.preprocessing.normalization import get_num_output_features
from reagent_tpu_torch.training.slate_q_trainer import SlateQTrainer


@MODEL_MANAGERS.register()
@dataclasses.dataclass
class SlateQ(ModelManager):
    slate_size: int = -1
    num_candidates: int = -1
    trainer_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    net_builder: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"FullyConnected": {}}
    )

    def get_reporter(self):
        from reagent_tpu_torch.reporting.reporters import SlateQReporter

        return SlateQReporter()

    def __post_init__(self):
        if self.slate_size <= 0:
            raise ValueError(f"slate_size is invalid: {self.slate_size}")
        tp = dict(self.trainer_param)
        self.rl_parameters = RLParameters(**dict(tp.get("rl", {}) or {}))
        self._tp = tp

    def build_trainer(
        self,
        normalization_data_map: Optional[Dict[str, NormalizationData]] = None,
        use_gpu: bool = False,
        state_dim: Optional[int] = None,
        candidate_dim: Optional[int] = None,
        device="cuda",
    ) -> SlateQTrainer:
        """The critic from ``net_builder`` over the state's and the item's
        normalized widths (or ``state_dim`` and ``candidate_dim``), and the
        trainer with the reporter's arrays on; ``use_gpu`` has no effect —
        ``device`` places the trainer."""
        if normalization_data_map:
            state_dim = get_num_output_features(
                normalization_data_map[NormalizationKey.STATE].dense_normalization_parameters)
            candidate_dim = get_num_output_features(
                normalization_data_map[NormalizationKey.ITEM].dense_normalization_parameters)
        q_network = PARAMETRIC_DQN_NET_BUILDERS.build(self.net_builder).build_q_network(
            None, None, state_dim=state_dim, action_dim=candidate_dim)
        tp = self._tp
        return SlateQTrainer(
            emit_reporter_arrays=True,
            q_network=q_network,
            slate_size=self.slate_size,
            rl=self.rl_parameters,
            optimizer=tp.get("optimizer"),
            single_selection=tp.get("single_selection", True),
            discount_time_scale=tp.get("discount_time_scale"),
            device=device,
        )

    def init_trainer_state(self, trainer: SlateQTrainer, generator: torch.Generator):
        """Fresh weights from ``generator`` (JAX's manager takes a key and
        prototypes; the port's module knows its widths)."""
        return trainer.init(generator)
