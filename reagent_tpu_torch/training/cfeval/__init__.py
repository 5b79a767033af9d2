"""Counterfactual-evaluation trainers (reference: reagent/training/cfeval/)."""

from reagent_tpu_torch.training.cfeval.bandit_reward_network_trainer import (
    BanditRewardNetTrainer,
)
from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import BayesByBackpropTrainer

__all__ = ["BanditRewardNetTrainer", "BayesByBackpropTrainer"]
