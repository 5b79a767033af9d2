"""CEM trainer: trains the ensemble of MDN-RNN world models a planner reads.

Port of ``reagent_tpu/training/cem_trainer.py`` (``CEMTrainer`` :24;
reference reagent/training/cem_trainer.py:36).  Planning needs no gradient
update; each world model trains on every batch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import CEMTrainerParameters
from reagent_tpu_torch.training.world_model.mdnrnn_trainer import (
    MDNRNNTrainer,
    MDNRNNTrainerState,
)

Tensor = torch.Tensor


class CEMTrainer:
    def __init__(
        self,
        cem_planner_network,
        world_model_trainers: List[MDNRNNTrainer],
        parameters: CEMTrainerParameters = CEMTrainerParameters(),
    ):
        self.cem_planner_network = cem_planner_network
        self.world_model_trainers = world_model_trainers
        self.parameters = parameters

    def init(self, generator: torch.Generator) -> List[MDNRNNTrainerState]:
        """Each member's fresh weights, drawn in turn from ``generator``."""
        return [t.init(generator) for t in self.world_model_trainers]

    def train_step(
        self, states: List[MDNRNNTrainerState], batch: rlt.MemoryNetworkInput
    ) -> Tuple[List[MDNRNNTrainerState], Dict[str, Tensor]]:
        """Every world model trains on the batch (reference cem_trainer.py:60-80)."""
        new_states = []
        metrics: Dict[str, Tensor] = {}
        for i, (trainer, st) in enumerate(zip(self.world_model_trainers, states)):
            st, m = trainer.train_step(st, batch)
            new_states.append(st)
            metrics[f"wm{i}_loss"] = m["loss"]
        return new_states, metrics
