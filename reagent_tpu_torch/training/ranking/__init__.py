"""Slate-ranking trainers (the port of ``reagent_tpu/training/ranking/``)."""

from reagent_tpu_torch.training.ranking.seq2slate_attn_trainer import (
    Seq2SlatePairwiseAttnTrainer,
    Seq2SlatePairwiseAttnTrainerState,
)
from reagent_tpu_torch.training.ranking.seq2slate_tf_trainer import (
    Seq2SlateSimulationTrainer,
    Seq2SlateTeacherForcingTrainer,
    Seq2SlateTFTrainerState,
)
from reagent_tpu_torch.training.ranking.seq2slate_trainer import (
    Seq2SlateTrainer,
    Seq2SlateTrainerState,
)

__all__ = [
    "Seq2SlateTrainer",
    "Seq2SlateTrainerState",
    "Seq2SlateTeacherForcingTrainer",
    "Seq2SlateTFTrainerState",
    "Seq2SlateSimulationTrainer",
    "Seq2SlatePairwiseAttnTrainer",
    "Seq2SlatePairwiseAttnTrainerState",
]
