"""Bandit reward-model trainer for counterfactual evaluation.

Port of ``reagent_tpu/training/cfeval/bandit_reward_network_trainer.py``
(:32-77; reference reagent/training/cfeval/bandit_reward_network_trainer.py:21):
fit r_hat(s, a) on a logged ``BanditRewardModelInput``, the net's
prediction for the logged action against its reward, per example by
``training/reward_network_trainer.py::elementwise_loss``.  With
``weighted_by_inverse_propensity`` and a batch that carries
``action_prob``, each example weighs ``1 / clip(action_prob, 1e-6)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.reward_network_trainer import LossFunction, elementwise_loss
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class BanditRewardNetTrainerState(rlt._TensorDataClass):
    params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar


class BanditRewardNetTrainer:
    def __init__(
        self,
        reward_net: nn.Module,  # state -> [B, num_actions] reward predictions
        optimizer: Any = None,
        loss_type: LossFunction = LossFunction.MSE,
        weighted_by_inverse_propensity: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.reward_net = reward_net.to(self.device)
        self.optimizer = make_optimizer(optimizer)
        self.loss_type = loss_type
        self.weighted_by_inverse_propensity = weighted_by_inverse_propensity

    def init(self, generator: torch.Generator) -> BanditRewardNetTrainerState:
        """Fresh weights from ``generator`` (on the CPU)."""
        self.reward_net.reset_parameters(generator)
        return self.state_from_network()

    def state_from_network(self) -> BanditRewardNetTrainerState:
        params = functional.params_of(self.reward_net)
        return BanditRewardNetTrainerState(
            params=params, opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def train_step(self, state: BanditRewardNetTrainerState, batch: rlt.BanditRewardModelInput
                   ) -> Tuple[BanditRewardNetTrainerState, Dict[str, Tensor]]:
        action = batch.action  # one-hot [B, A]
        target = batch.reward.reshape(-1, 1)
        weight = None
        if self.weighted_by_inverse_propensity and batch.action_prob is not None:
            weight = 1.0 / torch.clamp(batch.action_prob.reshape(-1, 1), min=1e-6)

        def loss_fn(params):
            pred_all = functional.apply(self.reward_net, params, batch.state.float_features)
            pred = torch.sum(pred_all * action, dim=1, keepdim=True)
            per_ex = elementwise_loss(self.loss_type, pred, target)
            if weight is not None:
                per_ex = per_ex * weight
            return torch.mean(per_ex), pred

        loss, grads, pred = functional.value_and_grad(loss_fn, state.params, has_aux=True)
        with torch.no_grad():
            params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        return (state.replace(params=params, opt_state=opt_state, step=state.step + 1),
                {"loss": loss, "pred_reward_mean": torch.mean(pred.detach())})
