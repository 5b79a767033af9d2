"""REINFORCE trainer, on-policy or off-policy with clipped importance
weights.

Port of ``reagent_tpu/training/reinforce_trainer.py:26-162`` (reference:
reagent/training/reinforce_trainer.py:93-149).  One ``train_step`` takes one
padded episode (``PolicyGradientInput`` with its ``valid_mask``): the
discounted returns of the clipped rewards, whitened over the real steps
(``normalize``) or centred (``subtract_mean``), clamped at 0 where
``offset_clamp_min``; then the value net's regression toward them and its
baseline subtracted, where there is one; then the policy's step on
``-offset . eligibility``, the eligibility being the log-prob of the taken
action or, off-policy, the importance weight ``exp(min(log pi - log mu,
log clip_param))``.  Impossible actions (``possible_actions_mask`` 0) get
``log(1e-20)`` added to their scores.  It reads no value on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.utils import discounted_returns, masked_whiten
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass
class PolicyGradientTrainerState:
    """The state of REINFORCE and PPO (JAX keeps two classes of these
    fields: ``ReinforceTrainerState`` and ``PPOTrainerState`` name this one)."""

    policy_params: Params
    opt_state: OptState
    step: Tensor  # int32 scalar on the device
    value_params: Optional[Params] = None
    value_opt_state: Optional[OptState] = None


ReinforceTrainerState = PolicyGradientTrainerState


def episode_mask(batch: rlt.PolicyGradientInput) -> Tensor:
    """The episode's real steps as float32 [T] (all of them without a
    ``valid_mask``)."""
    rewards = batch.reward.reshape(-1)
    if batch.valid_mask is None:
        return torch.ones_like(rewards)
    return batch.valid_mask.reshape(-1).to(torch.float32)


def masked_scores(scorer: nn.Module, params: Params, batch: rlt.PolicyGradientInput) -> Tensor:
    """The scorer's action scores, ``log(clip(mask, 1e-20, 1))`` added where
    the batch has a possible-actions mask."""
    scores = functional.apply(scorer, params, batch.state.float_features)
    if batch.possible_actions_mask is not None:
        scores = scores + torch.log(torch.clamp(batch.possible_actions_mask, 1e-20, 1.0))
    return scores


def value_baseline_step(value_net, value_optimizer, state, obs, offset, mask):
    """The value net's masked regression toward ``offset`` and its update:
    ``(loss, baselines without a graph, new params, new optimizer state)``
    (reference reinforce_trainer.py:116-127, ppo_trainer.py:117-128)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in state.value_params.items()}
    baselines = functional.apply(value_net, leaves, obs).reshape(-1)
    loss = torch.sum(mask * (baselines - offset) ** 2) / torch.clamp(torch.sum(mask), min=1.0)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        params, opt_state = value_optimizer.update(
            grads, state.value_opt_state, state.value_params)
    return loss.detach(), baselines.detach(), params, opt_state


class PolicyGradientTrainer:
    """What REINFORCE and PPO share: the nets and optimizers, ``init``, and
    a step's offsets with the value net's update.  ``device`` defaults to
    ``"cuda"`` and raises if no card is present."""

    # Whether ``subtract_mean`` centres the returns without ``normalize``:
    # REINFORCE's does, PPO's does not (as in JAX).
    center_without_normalize = False

    def __init__(self, scorer, sampler, gamma, optimizer, optimizer_value_net, reward_clip,
                 normalize, subtract_mean, offset_clamp_min, value_net, device) -> None:
        self.device = resolve_device(device)
        self.scorer = scorer.to(self.device)
        self.sampler = sampler
        self.gamma = gamma
        self.reward_clip = reward_clip
        self.normalize = normalize
        self.subtract_mean = subtract_mean
        self.offset_clamp_min = offset_clamp_min
        self.value_net = None if value_net is None else value_net.to(self.device)
        self.optimizer = make_optimizer(optimizer)
        self.value_optimizer = make_optimizer(optimizer_value_net)

    def init(self, generator: torch.Generator) -> PolicyGradientTrainerState:
        """Draw fresh weights from ``generator`` (the scorer, then the value
        net) and build the state."""
        self.scorer.reset_parameters(generator)
        if self.value_net is not None:
            self.value_net.reset_parameters(generator)
        return self.state_from_networks()

    def state_from_networks(self) -> PolicyGradientTrainerState:
        policy_params = functional.params_of(self.scorer)
        state = PolicyGradientTrainerState(
            policy_params=policy_params, opt_state=self.optimizer.init(policy_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        if self.value_net is not None:
            value_params = functional.params_of(self.value_net)
            state = dataclasses.replace(
                state, value_params=value_params,
                value_opt_state=self.value_optimizer.init(value_params))
        return state

    def offset_and_value_step(self, state: PolicyGradientTrainerState,
                              batch: rlt.PolicyGradientInput):
        """``(offset, value loss, value params, value optimizer state)``:
        the discounted returns of the clipped rewards, whitened or centred,
        clamped at 0 where ``offset_clamp_min``, less the value net's
        baseline after its update where there is one; 0 past the episode."""
        obs = batch.state.float_features
        mask = episode_mask(batch)
        with torch.no_grad():
            offset = discounted_returns(
                torch.clamp(batch.reward.reshape(-1), max=self.reward_clip) * mask, self.gamma)
            if self.normalize:
                offset = masked_whiten(offset, mask, self.subtract_mean)
            elif self.subtract_mean and self.center_without_normalize:
                n = torch.clamp(torch.sum(mask), min=1.0)
                offset = offset - torch.sum(offset * mask) / n
            if self.offset_clamp_min:
                offset = torch.clamp(offset, min=0)
            offset = offset * mask

        value_loss = torch.zeros((), dtype=torch.float32, device=obs.device)
        value_params, value_opt_state = state.value_params, state.value_opt_state
        if self.value_net is not None:
            value_loss, baselines, value_params, value_opt_state = value_baseline_step(
                self.value_net, self.value_optimizer, state, obs, offset, mask)
            offset = (offset - baselines) * mask
        return offset, value_loss, value_params, value_opt_state


class ReinforceTrainer(PolicyGradientTrainer):
    """``scorer`` maps states to action scores; ``sampler`` gives
    ``log_prob(scores, onehot_action)``.  A ``value_net`` baseline excludes
    ``normalize`` and ``subtract_mean``.  ``device`` defaults to ``"cuda"``
    and raises if no card is present."""

    center_without_normalize = True

    def __init__(
        self,
        scorer: nn.Module,
        sampler,
        gamma: float = 0.0,
        optimizer: Any = None,
        optimizer_value_net: Any = None,
        off_policy: bool = False,
        reward_clip: float = 1e6,
        clip_param: float = 1e6,
        normalize: bool = True,
        subtract_mean: bool = True,
        offset_clamp_min: bool = False,
        value_net: Optional[nn.Module] = None,
        device="cuda",
    ) -> None:
        if value_net is not None and (normalize or subtract_mean):
            raise ValueError("Can't use a value baseline and reward normalization at once")
        super().__init__(scorer, sampler, gamma, optimizer, optimizer_value_net, reward_clip,
                         normalize, subtract_mean, offset_clamp_min, value_net, device)
        self.off_policy = off_policy
        self.clip_param = clip_param

    def train_step(
        self, state: PolicyGradientTrainerState, batch: rlt.PolicyGradientInput
    ) -> Tuple[PolicyGradientTrainerState, Dict[str, Tensor]]:
        offset, value_loss, value_params, value_opt_state = self.offset_and_value_step(
            state, batch)
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.policy_params.items()}
        log_prob = self.sampler.log_prob(masked_scores(self.scorer, leaves, batch), batch.action)
        if self.off_policy:
            eligibility = torch.exp(torch.clamp(
                log_prob - batch.log_prob.reshape(-1), max=math.log(float(self.clip_param))))
        else:
            eligibility = log_prob
        loss = -torch.dot(offset, eligibility)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            policy_params, opt_state = self.optimizer.update(
                grads, state.opt_state, state.policy_params)
        return (
            dataclasses.replace(
                state, policy_params=policy_params, opt_state=opt_state,
                value_params=value_params, value_opt_state=value_opt_state,
                step=state.step + 1),
            {"loss": loss.detach(), "value_loss": value_loss,
             "eligibility_mean": torch.mean(eligibility.detach())},
        )
