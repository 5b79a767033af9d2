"""Discrete CRR (Critic-Regularized Regression) trainer.

Port of ``reagent_tpu/training/discrete_crr_trainer.py:26-220`` (reference:
reagent/training/discrete_crr_trainer.py:32-390, arXiv:2006.15134): the
critics regress toward the next state's value under the policy,
``E_pi[Q_target]`` (the smaller of the twin critics' where there are two),
and the actor is advantage-weighted behaviour cloning with weights
``exp(A / beta)`` clamped to ``max_weight``, plus an optional entropy-like
term on the importance ratio clipped to ``clip_limit``.

One ``train_step`` takes the JAX trainer's steps in its order (:96-215): the
target (the actor, or its target copy, on the next state), q1's update, q2's
update, the actor's update against q1's values from before its update, then
the soft updates.  The actor moves on steps where ``step %
delayed_policy_update == 0``; that select is ``torch.where`` on the device,
as JAX's ``jnp.where``, so the step reads no value on the host.  It returns
a new state and leaves the one it was given untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.optim import OptState, make_optimizer, soft_update
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass
class CRRTrainerState:
    actor_params: Params
    actor_target_params: Params
    q1_params: Params
    q1_target_params: Params
    actor_opt_state: OptState
    q1_opt_state: OptState
    step: Tensor  # int32 scalar on the device
    q2_params: Optional[Params] = None
    q2_target_params: Optional[Params] = None
    q2_opt_state: Optional[OptState] = None


class DiscreteCRRTrainer:
    """``actor_network`` maps states to action logits [B, A], the critics to
    Q-values [B, A].  ``emit_reporter_arrays`` adds the per-sample arrays a
    ``DiscreteCRRReporter``'s action histograms read.  ``device`` defaults
    to ``"cuda"`` and raises if no card is present."""

    def __init__(
        self,
        actor_network: nn.Module,
        q1_network: nn.Module,
        q2_network: Optional[nn.Module] = None,
        rl: RLParameters = RLParameters(gamma=0.9, target_update_rate=0.005),
        q_network_optimizer: Any = None,
        actor_network_optimizer: Any = None,
        use_target_actor: bool = False,
        beta: float = 1.0,
        max_weight: float = 20.0,
        entropy_coeff: float = 0.0,
        clip_limit: float = 10.0,
        emit_reporter_arrays: bool = False,
        delayed_policy_update: int = 1,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.emit_reporter_arrays = emit_reporter_arrays
        self.actor_network = actor_network.to(self.device)
        self.q1_network = q1_network.to(self.device)
        self.q2_network = None if q2_network is None else q2_network.to(self.device)
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.q_opt = make_optimizer(q_network_optimizer)
        self.actor_opt = make_optimizer(actor_network_optimizer)
        self.use_target_actor = use_target_actor
        self.beta = beta
        self.max_weight = max_weight
        self.entropy_coeff = entropy_coeff
        self.clip_limit = clip_limit
        self.delayed_policy_update = delayed_policy_update

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> CRRTrainerState:
        """Draw fresh weights from ``generator`` (the actor, q1, then q2)
        and build the state."""
        for net in (self.actor_network, self.q1_network, self.q2_network):
            if net is not None:
                net.reset_parameters(generator)
        return self.state_from_networks()

    def state_from_networks(self) -> CRRTrainerState:
        """The training state for the networks' current weights (targets
        copies, fresh optimizer states)."""
        def with_target(net, opt):
            params = functional.params_of(net)
            return params, {k: v.clone() for k, v in params.items()}, opt.init(params)

        actor, actor_t, actor_opt = with_target(self.actor_network, self.actor_opt)
        q1, q1_t, q1_opt = with_target(self.q1_network, self.q_opt)
        state = CRRTrainerState(
            actor_params=actor, actor_target_params=actor_t, q1_params=q1,
            q1_target_params=q1_t, actor_opt_state=actor_opt, q1_opt_state=q1_opt,
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        if self.q2_network is not None:
            q2, q2_t, q2_opt = with_target(self.q2_network, self.q_opt)
            state = dataclasses.replace(
                state, q2_params=q2, q2_target_params=q2_t, q2_opt_state=q2_opt)
        return state

    # ------------------------------------------------------------ train step

    def _td_update(self, net, params, opt_state, obs, action, target_q):
        """(loss, new params, new optimizer state, all Q-values) of one
        critic's regression toward ``target_q`` at the logged actions."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        all_q = functional.apply(net, leaves, obs)
        q_taken = torch.sum(all_q * action, dim=1, keepdim=True)
        loss = torch.mean((q_taken - target_q) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            new_params, new_opt = self.q_opt.update(grads, opt_state, params)
        return loss.detach(), new_params, new_opt, all_q.detach()

    def _actor_loss(self, params: Params, obs: Tensor, batch: rlt.DiscreteDqnInput,
                    all_q_values: Tensor) -> Tensor:
        logits = functional.apply(self.actor_network, params, obs)
        log_probs = F.log_softmax(logits, dim=1)
        probs = torch.exp(log_probs)
        values = torch.sum(all_q_values * probs, dim=1, keepdim=True)
        advantages = all_q_values - values
        weight = torch.clamp(
            torch.exp((1.0 / self.beta) * torch.sum(advantages * batch.action, dim=1,
                                                    keepdim=True)),
            0.0, self.max_weight)
        log_pi_b = torch.sum(log_probs * batch.action, dim=1, keepdim=True)
        loss = torch.mean(-log_pi_b * weight.detach())
        if self.entropy_coeff > 0:
            pi_t = torch.sum(probs * batch.action, dim=1, keepdim=True)
            pi_b = batch.extras.action_probability
            pi_ratio = torch.clamp(pi_t / pi_b, 1e-4, self.clip_limit)
            loss = loss + self.entropy_coeff * torch.mean(pi_ratio * log_pi_b)
        return loss

    def train_step(
        self, state: CRRTrainerState, batch: rlt.DiscreteDqnInput
    ) -> Tuple[CRRTrainerState, Dict[str, Tensor]]:
        obs = batch.state.float_features
        next_obs = batch.next_state.float_features
        rewards = batch.reward
        not_terminal = batch.not_terminal.to(torch.float32)

        # target V = E_pi[Q_target] (reference :199-213)
        with torch.no_grad():
            actor_src = (state.actor_target_params if self.use_target_actor
                         else state.actor_params)
            next_probs = F.softmax(functional.apply(self.actor_network, actor_src, next_obs),
                                   dim=1)
            next_q1 = functional.apply(self.q1_network, state.q1_target_params, next_obs)
            next_v = torch.sum(next_q1 * next_probs, dim=1, keepdim=True)
            if self.q2_network is not None:
                next_q2 = functional.apply(self.q2_network, state.q2_target_params, next_obs)
                next_v = torch.minimum(
                    next_v, torch.sum(next_q2 * next_probs, dim=1, keepdim=True))
            target_q = rewards + self.gamma * next_v * not_terminal

        q1_loss, q1_params, q1_opt_state, all_q1 = self._td_update(
            self.q1_network, state.q1_params, state.q1_opt_state, obs, batch.action, target_q)
        q2_params, q2_opt_state = state.q2_params, state.q2_opt_state
        q2_loss = torch.zeros((), dtype=torch.float32, device=obs.device)
        if self.q2_network is not None:
            q2_loss, q2_params, q2_opt_state, _ = self._td_update(
                self.q2_network, state.q2_params, state.q2_opt_state, obs, batch.action,
                target_q)

        # actor: advantage-weighted behaviour cloning (reference :221-289)
        # against q1's values from before its update; the delayed update is
        # a select on the device
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.actor_params.items()}
        actor_loss_raw = self._actor_loss(leaves, obs, batch, all_q1)
        a_grads = dict(zip(leaves, torch.autograd.grad(actor_loss_raw, list(leaves.values()))))
        with torch.no_grad():
            flag = torch.remainder(state.step, self.delayed_policy_update) == 0
            new_actor, new_actor_opt = self.actor_opt.update(
                a_grads, state.actor_opt_state, state.actor_params)
            actor_params = functional.select(flag, new_actor, state.actor_params)
            new_state = dataclasses.replace(
                state,
                actor_params=actor_params,
                actor_target_params=functional.select(
                    flag, soft_update(actor_params, state.actor_target_params, self.tau),
                    state.actor_target_params),
                q1_params=q1_params,
                q1_target_params=soft_update(q1_params, state.q1_target_params, self.tau),
                actor_opt_state=functional.select(flag, new_actor_opt, state.actor_opt_state),
                q1_opt_state=q1_opt_state,
                q2_params=q2_params,
                q2_target_params=(
                    soft_update(q2_params, state.q2_target_params, self.tau)
                    if self.q2_network is not None else state.q2_target_params),
                q2_opt_state=q2_opt_state,
                step=state.step + 1,
            )
            metrics = {
                "q1_loss": q1_loss,
                "q2_loss": q2_loss,
                "actor_loss": torch.where(flag, actor_loss_raw.detach(), 0.0),
            }
            if self.emit_reporter_arrays:
                # the reporter's action histograms (reference
                # discrete_crr_reporter.py, dqn_trainer.py:311-320)
                metrics.update(
                    logged_actions=torch.argmax(batch.action, dim=1),
                    logged_rewards=rewards.reshape(-1),
                    model_values=all_q1,
                    model_action_idxs=torch.argmax(all_q1, dim=1),
                )
        return new_state, metrics

    # ------------------------------------------------------------- inference

    def q_values(self, state: CRRTrainerState, obs: Tensor) -> Tensor:
        """q1's Q [B, A]; a dense MLP's forward is one K3 launch on a CUDA
        tensor."""
        return functional.score(self.q1_network, state.q1_params, obs)

    def actor_logits(self, state: CRRTrainerState, obs: Tensor) -> Tensor:
        """The actor's logits [B, A], through K3 as ``q_values``."""
        return functional.score(self.actor_network, state.actor_params, obs)

    def export_actor_network(self, state: CRRTrainerState) -> nn.Module:
        """A copy of the actor holding the state's online weights."""
        return functional.module_with(self.actor_network, state.actor_params)
