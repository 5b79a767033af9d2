"""Parametric-action DQN trainer: Q(s, a) over feature-vector actions.

Port of ``reagent_tpu/training/parametric_dqn_trainer.py`` (reference:
reagent/training/parametric_dqn_trainer.py:111-200).  Max-Q scores every
possible next action of a row (the batch's tiled ``possible_next_actions``
against each next state repeated in place), SARSA the logged next action;
an optional reward network regresses the logged reward with its own MSE
step.

``train_step`` reads no value on the host, so the online loop can call it
without waiting for the device.  It returns a new state and leaves the one
it was given untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.optim import OptState, make_optimizer, soft_update
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.rl_trainer_base import (
    compute_discount_tensor,
    get_max_q_values_with_target,
    q_network_loss_fn,
)
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class ParametricDQNTrainerState:
    q_params: Dict[str, Tensor]
    q_target_params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar on the device
    reward_params: Optional[Dict[str, Tensor]] = None
    reward_opt_state: Optional[OptState] = None


class ParametricDQNTrainer:
    """``q_network`` and ``reward_network`` map (state, action) to ``[B, 1]``;
    the reward network takes the q-network's optimizer config.  ``device``
    defaults to ``"cuda"`` and raises if no card is present."""

    def __init__(
        self,
        q_network: nn.Module,
        rl: RLParameters = RLParameters(),
        double_q_learning: bool = True,
        optimizer: Any = None,
        reward_network: Optional[nn.Module] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.q_network = q_network.to(self.device)
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.maxq_learning = rl.maxq_learning
        self.double_q_learning = double_q_learning
        self.optimizer = make_optimizer(optimizer)
        self.loss_fn = q_network_loss_fn(rl.q_network_loss)
        self.reward_network = None if reward_network is None else reward_network.to(self.device)

    def init(self, generator: torch.Generator) -> ParametricDQNTrainerState:
        """Draw fresh weights from ``generator`` (the q-network, then the
        reward network) and build the state."""
        self.q_network.reset_parameters(generator)
        if self.reward_network is not None:
            self.reward_network.reset_parameters(generator)
        return self.state_from_networks()

    def state_from_networks(self) -> ParametricDQNTrainerState:
        """The training state for the networks' current weights (target a
        copy, fresh optimizer states)."""
        q_params = functional.params_of(self.q_network)
        state = ParametricDQNTrainerState(
            q_params=q_params,
            q_target_params={k: v.clone() for k, v in q_params.items()},
            opt_state=self.optimizer.init(q_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        if self.reward_network is not None:
            reward_params = functional.params_of(self.reward_network)
            state = dataclasses.replace(
                state, reward_params=reward_params,
                reward_opt_state=self.optimizer.init(reward_params))
        return state

    def train_step(
        self, state: ParametricDQNTrainerState, batch: rlt.ParametricDqnInput
    ) -> Tuple[ParametricDQNTrainerState, Dict[str, Tensor]]:
        reward = batch.reward
        obs = batch.state.float_features
        action = batch.action.float_features
        with torch.no_grad():
            not_terminal = batch.not_terminal.to(torch.float32)
            discount = compute_discount_tensor(
                batch, self.gamma, self.rl.use_seq_num_diff_as_time_diff, self.rl.multi_steps
            )
            if self.maxq_learning:
                # possible_next_actions: [B * max_num_action, k], row i*M + j
                # the j-th action of row i; next states repeated to match
                pna = batch.possible_next_actions.float_features
                mask = batch.possible_next_actions_mask.to(torch.float32)
                max_num_action = pna.shape[0] // mask.shape[0]
                tiled_next = batch.next_state.get_tiled_batch(max_num_action).float_features
                all_next_q = functional.apply(self.q_network, state.q_params, tiled_next, pna)
                all_next_q_t = functional.apply(
                    self.q_network, state.q_target_params, tiled_next, pna)
                next_q, _ = get_max_q_values_with_target(
                    all_next_q, all_next_q_t, mask, self.double_q_learning)
            else:  # SARSA on the logged next action, through the target net
                next_q = functional.apply(
                    self.q_network, state.q_target_params, batch.next_state.float_features,
                    batch.next_action.float_features)
            target_q = reward + not_terminal * discount * next_q

        def loss(params):
            q = functional.apply(self.q_network, params, obs, action)
            return self.loss_fn(q, target_q), q.detach().mean()

        td_loss, grads, q_mean = functional.value_and_grad(loss, state.q_params, has_aux=True)
        with torch.no_grad():
            q_params, opt_state = self.optimizer.update(grads, state.opt_state, state.q_params)
        metrics = {"td_loss": td_loss, "q_mean": q_mean}

        reward_params, reward_opt_state = state.reward_params, state.reward_opt_state
        if self.reward_network is not None:
            def r_loss_fn(rp):
                pred = functional.apply(self.reward_network, rp, obs, action)
                return torch.mean((pred - reward) ** 2)

            r_loss, r_grads, _ = functional.value_and_grad(r_loss_fn, state.reward_params)
            with torch.no_grad():
                reward_params, reward_opt_state = self.optimizer.update(
                    r_grads, state.reward_opt_state, state.reward_params)
            metrics["reward_loss"] = r_loss

        with torch.no_grad():
            new_state = ParametricDQNTrainerState(
                q_params=q_params,
                q_target_params=soft_update(q_params, state.q_target_params, self.tau),
                opt_state=opt_state,
                step=state.step + 1,
                reward_params=reward_params,
                reward_opt_state=reward_opt_state,
            )
        return new_state, metrics

    def export_q_network(self, state: ParametricDQNTrainerState) -> nn.Module:
        """A copy of the q-network holding the state's online weights."""
        return functional.module_with(self.q_network, state.q_params)
