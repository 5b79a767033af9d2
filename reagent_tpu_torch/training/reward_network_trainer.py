"""Reward-model trainer.

Port of ``reagent_tpu/training/reward_network_trainer.py`` (``LossFunction``
:25, ``RewardNetTrainerState`` :46, ``RewardNetTrainer`` :53; reference
reagent/training/reward_network_trainer.py:70): MSE, smooth-L1, L1 or BCE
(on logits) per example, optionally weighted by the inverse logged
propensity (clipped below at 1e-6) of a ranking batch, optionally averaged
over the examples whose target is at most ``reward_ignore_threshold``.

As in JAX, a ``PreprocessedRankingInput`` passes ``(state, src_seq)``
float features to the net, and any other batch only
``batch.state.float_features``, with ``batch.reward`` as the target.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.world_model.mdnrnn_trainer import sigmoid_binary_cross_entropy
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class LossFunction(enum.Enum):
    MSE = "MSE_Loss"
    SmoothL1Loss = "SmoothL1_Loss"
    L1Loss = "L1_Loss"
    BCELoss = "BCE_Loss"


def elementwise_loss(loss_type: LossFunction, pred: Tensor, target: Tensor) -> Tensor:
    if loss_type == LossFunction.MSE:
        return (pred - target) ** 2
    if loss_type == LossFunction.L1Loss:
        return torch.abs(pred - target)
    if loss_type == LossFunction.SmoothL1Loss:
        d = torch.abs(pred - target)
        return torch.where(d < 1.0, 0.5 * d**2, d - 0.5)
    if loss_type == LossFunction.BCELoss:
        return sigmoid_binary_cross_entropy(pred, target)
    raise ValueError(loss_type)


@dataclasses.dataclass
class RewardNetTrainerState:
    params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar


class RewardNetTrainer:
    def __init__(
        self,
        reward_net: nn.Module,
        optimizer: Any = None,
        loss_type: LossFunction = LossFunction.MSE,
        reward_ignore_threshold: Optional[float] = None,
        weighted_by_inverse_propensity: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.reward_net = reward_net.to(self.device)
        self.optimizer = make_optimizer(optimizer)
        self.loss_type = loss_type
        self.reward_ignore_threshold = reward_ignore_threshold
        self.weighted_by_inverse_propensity = weighted_by_inverse_propensity

    def init(self, generator: torch.Generator) -> RewardNetTrainerState:
        """Fresh weights from ``generator`` (on the CPU)."""
        self.reward_net.reset_parameters(generator)
        return self.state_from_network()

    def state_from_network(self) -> RewardNetTrainerState:
        params = functional.params_of(self.reward_net)
        return RewardNetTrainerState(
            params=params, opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def train_step(self, state: RewardNetTrainerState, batch
                   ) -> Tuple[RewardNetTrainerState, Dict[str, Tensor]]:
        if isinstance(batch, rlt.PreprocessedRankingInput):
            target = batch.slate_reward.reshape(-1, 1)
            inputs = (batch.state.float_features, batch.src_seq.float_features)
            weight = (1.0 / torch.clamp(batch.tgt_out_probs.reshape(-1, 1), min=1e-6)
                      if self.weighted_by_inverse_propensity else None)
        else:
            target = batch.reward.reshape(-1, 1)
            inputs = (batch.state.float_features,)
            weight = None

        def loss_fn(params):
            pred = functional.apply(self.reward_net, params, *inputs).reshape(-1, 1)
            per_ex = elementwise_loss(self.loss_type, pred, target)
            if weight is not None:
                per_ex = per_ex * weight
            if self.reward_ignore_threshold is not None:
                keep = (target <= self.reward_ignore_threshold).to(torch.float32)
                return torch.sum(per_ex * keep) / torch.clamp(torch.sum(keep), min=1.0), pred
            return torch.mean(per_ex), pred

        loss, grads, pred = functional.value_and_grad(loss_fn, state.params, has_aux=True)
        with torch.no_grad():
            params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        return (
            RewardNetTrainerState(params=params, opt_state=opt_state, step=state.step + 1),
            {"loss": loss, "pred_reward_mean": torch.mean(pred.detach())},
        )
