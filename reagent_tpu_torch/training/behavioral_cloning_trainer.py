"""Behavioural-cloning trainer: cross-entropy on the logged actions.

Port of ``reagent_tpu/training/behavioral_cloning_trainer.py`` (:30-67;
reference reagent/training/behavioral_cloning_trainer.py:18).  The labels
are ``argmax(batch.action)``.  A possible-actions mask is added to the logits
as ``log(clip(mask, 1e-20, 1))``, as JAX adds it, not as ``-inf``: a masked
logit is lowered by 46.05, and the loss and the accuracy see that value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class BehavioralCloningTrainerState(rlt._TensorDataClass):
    params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar


class BehavioralCloningTrainer:
    def __init__(self, bc_net: nn.Module, optimizer: Any = None, device="cuda"):
        self.device = resolve_device(device)
        self.bc_net = bc_net.to(self.device)
        self.optimizer = make_optimizer(optimizer)

    def init(self, generator: torch.Generator) -> BehavioralCloningTrainerState:
        """Fresh weights from ``generator`` (on the CPU)."""
        self.bc_net.reset_parameters(generator)
        return self.state_from_network()

    def state_from_network(self) -> BehavioralCloningTrainerState:
        params = functional.params_of(self.bc_net)
        return BehavioralCloningTrainerState(
            params=params, opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def train_step(self, state: BehavioralCloningTrainerState,
                   batch: rlt.BehavioralCloningModelInput
                   ) -> Tuple[BehavioralCloningTrainerState, Dict[str, Tensor]]:
        labels = torch.argmax(batch.action, dim=1)
        mask = batch.possible_actions_mask

        def loss_fn(params):
            logits = functional.apply(self.bc_net, params, batch.state.float_features)
            if mask is not None:
                logits = logits + torch.log(torch.clamp(mask.to(logits.dtype), 1e-20, 1.0))
            loss = F.cross_entropy(logits, labels)
            acc = torch.mean((torch.argmax(logits, dim=1) == labels).to(torch.float32))
            return loss, acc

        loss, grads, acc = functional.value_and_grad(loss_fn, state.params, has_aux=True)
        with torch.no_grad():
            params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        return (state.replace(params=params, opt_state=opt_state, step=state.step + 1),
                {"loss": loss, "accuracy": acc.detach()})
