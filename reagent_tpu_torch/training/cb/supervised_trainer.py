"""Supervised contextual-bandit trainer: plain regression on the chosen arms.

Port of ``reagent_tpu/training/cb/supervised_trainer.py`` (reference
reagent/training/cb/supervised_trainer.py).  The network's parameters live
in the state as a ``{name: tensor}`` dict, stepped by the port's optimizer
union (``make_optimizer``: Adam at 1e-3 where none is given).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core.types import CBInput, _TensorDataClass
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.cb.utils import chosen_arm_features
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class SupervisedTrainerState(_TensorDataClass):
    params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar


class SupervisedTrainer:
    def __init__(self, network: nn.Module, optimizer: Any = None, device="cuda"):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self.optimizer = make_optimizer(optimizer)

    def init(self, generator: Optional[torch.Generator] = None) -> SupervisedTrainerState:
        """Fresh parameters (drawn from ``generator`` where given, else the
        network's own) and optimizer state."""
        if generator is not None:
            self.network.reset_parameters(generator)
        params = functional.params_of(self.network)
        return SupervisedTrainerState(
            params=params, opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def train_step(self, state: SupervisedTrainerState, batch: CBInput
                   ) -> Tuple[SupervisedTrainerState, Dict[str, Tensor]]:
        x = chosen_arm_features(batch)
        y = batch.reward.reshape(-1, 1)

        def loss_fn(params):
            return torch.mean((functional.apply(self.network, params, x) - y) ** 2)

        loss, grads, _ = functional.value_and_grad(loss_fn, state.params)
        params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        return (state.replace(params=params, opt_state=opt_state, step=state.step + 1),
                {"loss": loss})
