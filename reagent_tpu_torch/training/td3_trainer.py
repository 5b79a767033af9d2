"""TD3 trainer: twin critics, target-policy smoothing, delayed policy updates.

Port of ``reagent_tpu/training/td3_trainer.py:27-190`` (reference:
reagent/training/td3_trainer.py:30-215).  As in the JAX trainer, the delayed
actor update and the targets' soft updates are computed every step and
selected by ``step % delayed_policy_update == 0`` on the device
(``torch.where``, which keeps the integer leaves of the optimizer state at
their dtype), so the step never waits for the device to learn which branch
to take.  The smoothing noise's standard-normal draw comes from the
trainer's ``torch.Generator`` on its device, or from ``noise`` where the
caller gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import CONTINUOUS_TRAINING_ACTION_RANGE, RLParameters
from reagent_tpu_torch.optim import OptState, make_optimizer, soft_update
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass
class TD3TrainerState:
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


class TD3Trainer:
    """``device`` defaults to ``"cuda"`` and raises if no card is present."""

    def __init__(
        self,
        actor_network: nn.Module,
        q1_network: nn.Module,
        q2_network: Optional[nn.Module] = None,
        rl: RLParameters = RLParameters(gamma=0.9, target_update_rate=0.005),
        q_network_optimizer: Any = None,
        actor_network_optimizer: Any = None,
        noise_variance: float = 0.2,
        noise_clip: float = 0.5,
        delayed_policy_update: int = 2,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.actor_network = actor_network.to(self.device)
        self.q1_network = q1_network.to(self.device)
        self.q2_network = None if q2_network is None else q2_network.to(self.device)
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.q_opt = make_optimizer(q_network_optimizer)
        self.actor_opt = make_optimizer(actor_network_optimizer)
        self.noise_variance = noise_variance
        self.noise_clip = noise_clip
        self.delayed_policy_update = delayed_policy_update
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)

    def init(self, generator: torch.Generator) -> TD3TrainerState:
        """Draw fresh weights from ``generator`` (the actor, q1, then q2),
        seed the trainer's noise stream from it and build the state."""
        for net in (self.actor_network, self.q1_network, self.q2_network):
            if net is not None:
                net.reset_parameters(generator)
        self.generator.manual_seed(int(torch.randint(2**62, (), generator=generator)))
        return self.state_from_networks()

    def state_from_networks(self) -> TD3TrainerState:
        """The training state for the networks' current weights (targets
        copies, fresh optimizer states)."""
        def copy(params):
            return {k: v.clone() for k, v in params.items()}

        actor_params = functional.params_of(self.actor_network)
        q1_params = functional.params_of(self.q1_network)
        state = TD3TrainerState(
            actor_params=actor_params, actor_target_params=copy(actor_params),
            q1_params=q1_params, q1_target_params=copy(q1_params),
            actor_opt_state=self.actor_opt.init(actor_params),
            q1_opt_state=self.q_opt.init(q1_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        if self.q2_network is not None:
            q2_params = functional.params_of(self.q2_network)
            state = dataclasses.replace(
                state, q2_params=q2_params, q2_target_params=copy(q2_params),
                q2_opt_state=self.q_opt.init(q2_params))
        return state

    def train_step(
        self, state: TD3TrainerState, batch: rlt.PolicyNetworkInput,
        noise: Optional[Tensor] = None,
    ) -> Tuple[TD3TrainerState, Dict[str, Tensor]]:
        """One update.  ``noise`` [B, action_dim]: the standard-normal draw of
        the target policy's smoothing; drawn from the trainer's generator
        when not given."""
        obs = batch.state.float_features
        action = batch.action.float_features
        next_obs = batch.next_state.float_features
        not_done = batch.not_terminal.to(torch.float32)
        lo, hi = CONTINUOUS_TRAINING_ACTION_RANGE
        if noise is None:
            noise = torch.randn(action.shape, generator=self.generator, device=action.device)

        # target with policy smoothing (ref td3_trainer.py:141-156)
        with torch.no_grad():
            next_actor = functional.apply(
                self.actor_network, state.actor_target_params, next_obs).action
            smoothing = torch.clamp(noise * self.noise_variance, -self.noise_clip, self.noise_clip)
            next_actor = torch.clamp(next_actor + smoothing, lo, hi)
            next_q = functional.apply(self.q1_network, state.q1_target_params, next_obs, next_actor)
            if self.q2_network is not None:
                next_q = torch.minimum(next_q, functional.apply(
                    self.q2_network, state.q2_target_params, next_obs, next_actor))
            target_q = batch.reward + self.gamma * next_q * not_done

        def q_loss(net):
            return lambda params: torch.mean(
                (functional.apply(net, params, obs, action) - target_q) ** 2)

        q1_loss, q1_grads, _ = functional.value_and_grad(q_loss(self.q1_network), state.q1_params)
        q2_loss, q2_grads = torch.zeros((), device=obs.device), None
        if self.q2_network is not None:
            q2_loss, q2_grads, _ = functional.value_and_grad(
                q_loss(self.q2_network), state.q2_params)
        with torch.no_grad():
            q1_params, q1_opt_state = self.q_opt.update(
                q1_grads, state.q1_opt_state, state.q1_params)
            q2_params, q2_opt_state = state.q2_params, state.q2_opt_state
            if q2_grads is not None:
                q2_params, q2_opt_state = self.q_opt.update(
                    q2_grads, state.q2_opt_state, state.q2_params)

        # delayed actor + target update (ref :186-215), against the updated q1
        flag = state.step % self.delayed_policy_update == 0
        actor_loss_raw, a_grads, _ = functional.value_and_grad(
            lambda a_params: -torch.mean(functional.apply(
                self.q1_network, q1_params, obs,
                functional.apply(self.actor_network, a_params, obs).action)),
            state.actor_params)
        with torch.no_grad():
            new_actor, new_actor_opt_state = self.actor_opt.update(
                a_grads, state.actor_opt_state, state.actor_params)
            actor_params = functional.select(flag, new_actor, state.actor_params)
            new_state = TD3TrainerState(
                actor_params=actor_params,
                actor_target_params=functional.select(
                    flag, soft_update(actor_params, state.actor_target_params, self.tau),
                    state.actor_target_params),
                q1_params=q1_params,
                q1_target_params=functional.select(
                    flag, soft_update(q1_params, state.q1_target_params, self.tau),
                    state.q1_target_params),
                actor_opt_state=functional.select(flag, new_actor_opt_state, state.actor_opt_state),
                q1_opt_state=q1_opt_state,
                step=state.step + 1,
                q2_params=q2_params,
                q2_target_params=(
                    functional.select(flag, soft_update(q2_params, state.q2_target_params, self.tau),
                            state.q2_target_params)
                    if self.q2_network is not None else state.q2_target_params),
                q2_opt_state=q2_opt_state,
            )
            metrics = {
                "q1_loss": q1_loss,
                "q2_loss": q2_loss,
                "actor_loss": torch.where(flag, actor_loss_raw, 0.0),
                "target_q_mean": torch.mean(target_q),
            }
        return new_state, metrics

    def export_actor(self, state: TD3TrainerState) -> nn.Module:
        """A copy of the actor holding the state's weights."""
        return functional.module_with(self.actor_network, state.actor_params)
