"""Contextual-bandit trainers (port of ``reagent_tpu/training/cb/__init__.py``)."""

from reagent_tpu_torch.training.cb.deep_represent_linucb_trainer import (
    DeepRepresentLinUCBTrainer,
)
from reagent_tpu_torch.training.cb.disjoint_linucb_trainer import DisjointLinUCBTrainer
from reagent_tpu_torch.training.cb.linucb_trainer import LinUCBTrainer
from reagent_tpu_torch.training.cb.mab_trainer import MABTrainer
from reagent_tpu_torch.training.cb.supervised_trainer import SupervisedTrainer

__all__ = ["LinUCBTrainer", "DisjointLinUCBTrainer", "SupervisedTrainer",
           "DeepRepresentLinUCBTrainer", "MABTrainer"]
