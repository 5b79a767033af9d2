"""PPO trainer: the clipped surrogate objective, an optional value
baseline and entropy bonus.

Port of ``reagent_tpu/training/ppo_trainer.py:26-163`` (reference:
reagent/training/ppo_trainer.py:34-160).  One ``train_step`` takes one
padded episode: the discounted returns of the clipped rewards, whitened
over the real steps where ``normalize``, clamped at 0 where
``offset_clamp_min``; the value net's update and baseline where there is
one; then ``update_epochs`` full-batch steps of the policy on
``-min(offset . ratio, offset . clip(ratio, 1 - eps, 1 + eps))`` minus
``entropy_weight`` times the summed entropy, the ratio taken against the
episode's behaviour log-probs.  It reads no value on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.training.reinforce_trainer import (
    PolicyGradientTrainer,
    PolicyGradientTrainerState,
    masked_scores,
)

Tensor = torch.Tensor
Params = Dict[str, Tensor]

PPOTrainerState = PolicyGradientTrainerState


class PPOTrainer(PolicyGradientTrainer):
    """``scorer`` maps states to action scores; ``sampler`` gives
    ``log_prob(scores, onehot_action)`` and ``entropy(scores)``.  A
    ``value_net`` baseline excludes ``normalize``.  ``device`` defaults to
    ``"cuda"`` and raises if no card is present."""

    def __init__(
        self,
        scorer: nn.Module,
        sampler,
        gamma: float = 0.0,
        optimizer: Any = None,
        optimizer_value_net: Any = None,
        reward_clip: float = 1e6,
        normalize: bool = True,
        subtract_mean: bool = True,
        offset_clamp_min: bool = False,
        update_epochs: int = 1,
        ppo_epsilon: float = 0.2,
        entropy_weight: float = 0.0,
        value_net: Optional[nn.Module] = None,
        device="cuda",
    ) -> None:
        if not 0 <= ppo_epsilon <= 1:
            raise ValueError("ppo_epsilon must be in [0, 1]")
        if value_net is not None and normalize:
            raise ValueError("Can't apply a value baseline and normalize rewards simultaneously")
        super().__init__(scorer, sampler, gamma, optimizer, optimizer_value_net, reward_clip,
                         normalize, subtract_mean, offset_clamp_min, value_net, device)
        self.update_epochs = update_epochs
        self.ppo_epsilon = ppo_epsilon
        self.entropy_weight = entropy_weight

    def _loss(self, params: Params, batch: rlt.PolicyGradientInput, offset: Tensor,
              behavior_log_prob: Tensor):
        scores = masked_scores(self.scorer, params, batch)
        ratio = torch.exp(self.sampler.log_prob(scores, batch.action) - behavior_log_prob)
        unclipped = torch.dot(offset, ratio)
        clipped = torch.dot(
            offset, torch.clamp(ratio, 1 - self.ppo_epsilon, 1 + self.ppo_epsilon))
        loss = -torch.minimum(unclipped, clipped)
        if self.entropy_weight != 0:
            loss = loss - self.entropy_weight * torch.sum(self.sampler.entropy(scores))
        return loss, torch.mean(ratio.detach())

    def train_step(
        self, state: PPOTrainerState, batch: rlt.PolicyGradientInput
    ) -> Tuple[PPOTrainerState, Dict[str, Tensor]]:
        offset, value_loss, value_params, value_opt_state = self.offset_and_value_step(
            state, batch)
        obs = batch.state.float_features
        behavior_log_prob = batch.log_prob.reshape(-1).detach()
        policy_params, opt_state = state.policy_params, state.opt_state
        loss = torch.zeros((), dtype=torch.float32, device=obs.device)
        ratio_mean = torch.ones((), dtype=torch.float32, device=obs.device)
        for _ in range(self.update_epochs):
            leaves = {k: v.detach().requires_grad_(True) for k, v in policy_params.items()}
            loss, ratio_mean = self._loss(leaves, batch, offset, behavior_log_prob)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            with torch.no_grad():
                policy_params, opt_state = self.optimizer.update(grads, opt_state, policy_params)
            loss = loss.detach()
        return (
            dataclasses.replace(
                state, policy_params=policy_params, opt_state=opt_state,
                value_params=value_params, value_opt_state=value_opt_state,
                step=state.step + 1),
            {"ppo_loss": loss, "value_loss": value_loss, "ratio_mean": ratio_mean},
        )
