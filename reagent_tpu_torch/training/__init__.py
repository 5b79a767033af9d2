"""Trainers: one functional train step per algorithm.

Port of ``reagent_tpu/training/__init__.py`` for the trainers ported so far.
Each trainer is a plain object holding static configuration and the
q-network, exposing ``init(generator) -> TrainerState`` and
``train_step(state, batch) -> (state, metrics)``.
"""

from reagent_tpu_torch.training.discrete_crr_trainer import CRRTrainerState, DiscreteCRRTrainer
from reagent_tpu_torch.training.dqn_trainer import DQNTrainer, DQNTrainerState
from reagent_tpu_torch.training.ppo_trainer import PPOTrainer, PPOTrainerState
from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer, QRDQNTrainerState
from reagent_tpu_torch.training.reinforce_trainer import ReinforceTrainer, ReinforceTrainerState
from reagent_tpu_torch.training.scan_loop import (
    make_sampled_train_fn,
    make_scanned_train_fn,
)

__all__ = [
    "make_sampled_train_fn",
    "make_scanned_train_fn",
    "DQNTrainer",
    "DQNTrainerState",
    "QRDQNTrainer",
    "QRDQNTrainerState",
    "DiscreteCRRTrainer",
    "CRRTrainerState",
    "ReinforceTrainer",
    "ReinforceTrainerState",
    "PPOTrainer",
    "PPOTrainerState",
]
