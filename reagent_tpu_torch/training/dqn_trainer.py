"""DQN trainer (double-Q, SARSA mode, BCQ, reward boosting, CPE heads),
the unfused path.

Port of ``reagent_tpu/training/dqn_trainer.py`` (reference:
reagent/training/dqn_trainer.py:28-120 + dqn_trainer_base.py).  One
``train_step`` computes the TD loss, its gradient by autograd, the optimizer
update and the target-network polyak blend, then, where the trainer has CPE
heads, trains the reward head and the CPE Q head the same way; it reads no
value on the host, returns a new state and leaves the one it was given
untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.models.bcq import bcq_mask_q_values
from reagent_tpu_torch.optim import OptState, make_optimizer, soft_update
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.rl_trainer_base import (
    boost_rewards,
    compute_discount_tensor,
    get_max_q_values_with_target,
    q_network_loss_fn,
    reward_boost_array,
)
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class DQNTrainerState:
    q_params: Dict[str, Tensor]
    q_target_params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar on the device
    # the CPE heads (None without them)
    reward_params: Optional[Dict[str, Tensor]] = None
    reward_opt_state: Optional[OptState] = None
    cpe_params: Optional[Dict[str, Tensor]] = None
    cpe_target_params: Optional[Dict[str, Tensor]] = None
    cpe_opt_state: Optional[OptState] = None


class DQNTrainer:
    """Discrete-action DQN with double-Q, optional BCQ and CPE heads.

    BCQ (``bcq_drop_threshold`` not None) runs ``bcq_imitator`` on the
    q-network's parameters, as the JAX trainer does, so the imitator must
    have the q-network's parameter names.  The CPE heads are
    ``reward_network`` and ``q_network_cpe``, both or neither; they take the
    q-network's optimizer config.  ``device`` defaults to ``"cuda"`` and
    raises if no card is present.
    """

    def __init__(
        self,
        q_network: nn.Module,
        rl: RLParameters = RLParameters(),
        double_q_learning: bool = True,
        bcq_drop_threshold: Optional[float] = None,  # not None => BCQ
        bcq_imitator: Optional[nn.Module] = None,
        optimizer: Any = None,
        action_names: Optional[Tuple[str, ...]] = None,
        reward_network: Optional[nn.Module] = None,
        q_network_cpe: Optional[nn.Module] = None,
        emit_reporter_arrays: bool = False,
        device="cuda",
    ) -> None:
        if bcq_drop_threshold is not None and bcq_imitator is None:
            raise ValueError("bcq_drop_threshold needs a bcq_imitator")
        if (reward_network is None) != (q_network_cpe is None):
            raise ValueError("the CPE heads come as a pair: reward_network and q_network_cpe")
        self.device = resolve_device(device)
        self.emit_reporter_arrays = emit_reporter_arrays
        self.q_network = q_network.to(self.device)
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.double_q_learning = double_q_learning
        self.maxq_learning = rl.maxq_learning
        self.multi_steps = rl.multi_steps
        self.bcq = bcq_drop_threshold is not None
        self.bcq_drop_threshold = bcq_drop_threshold or 0.0
        self.bcq_imitator = None if bcq_imitator is None else bcq_imitator.to(self.device)
        self.optimizer = make_optimizer(optimizer)
        self.loss_fn = q_network_loss_fn(rl.q_network_loss)
        boosts = reward_boost_array(rl.reward_boost, action_names)
        self.reward_boosts = None if boosts is None else boosts.to(self.device)
        # CPE heads (reference dqn_trainer_base.py:244 _initialize_cpe)
        self.calc_cpe_in_training = reward_network is not None
        self.reward_network = None if reward_network is None else reward_network.to(self.device)
        self.q_network_cpe = None if q_network_cpe is None else q_network_cpe.to(self.device)

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> DQNTrainerState:
        """Draw fresh weights from ``generator`` (the q-network, then the
        reward and CPE heads) and build the state."""
        self.q_network.reset_parameters(generator)
        if self.calc_cpe_in_training:
            self.reward_network.reset_parameters(generator)
            self.q_network_cpe.reset_parameters(generator)
        return self.state_from_q_network()

    def state_from_q_network(self) -> DQNTrainerState:
        """The training state for the networks' current weights (targets
        copies, fresh optimizer states)."""
        q_params = functional.params_of(self.q_network)
        state = DQNTrainerState(
            q_params=q_params,
            q_target_params={k: v.clone() for k, v in q_params.items()},
            opt_state=self.optimizer.init(q_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        if self.calc_cpe_in_training:
            reward_params = functional.params_of(self.reward_network)
            cpe_params = functional.params_of(self.q_network_cpe)
            state = dataclasses.replace(
                state,
                reward_params=reward_params,
                reward_opt_state=self.optimizer.init(reward_params),
                cpe_params=cpe_params,
                cpe_target_params={k: v.clone() for k, v in cpe_params.items()},
                cpe_opt_state=self.optimizer.init(cpe_params),
            )
        return state

    # ------------------------------------------------------------- td target

    def _td_target(self, state: DQNTrainerState, batch: rlt.DiscreteDqnInput):
        with torch.no_grad():
            rewards = boost_rewards(batch.reward, batch.action, self.reward_boosts)
            discount = compute_discount_tensor(
                batch, self.gamma, self.rl.use_seq_num_diff_as_time_diff, self.multi_steps
            )
            not_done = batch.not_terminal.to(torch.float32)
            next_obs = batch.next_state.float_features
            next_q = functional.apply(self.q_network, state.q_params, next_obs)
            next_q_target = functional.apply(self.q_network, state.q_target_params, next_obs)
            if self.maxq_learning:
                mask = batch.possible_next_actions_mask.to(torch.float32)
                if self.bcq:
                    logits = functional.apply(self.bcq_imitator, state.q_params, next_obs)
                    masked = bcq_mask_q_values(
                        torch.zeros_like(logits), logits, self.bcq_drop_threshold)
                    mask = mask * (masked > -1e30).to(torch.float32)
            else:  # SARSA: evaluate the logged next action
                mask = batch.next_action
            next_q_sel, _ = get_max_q_values_with_target(
                next_q, next_q_target, mask, self.double_q_learning
            )
            return rewards + discount * next_q_sel * not_done, rewards

    # ------------------------------------------------------------ train step

    def train_step(
        self, state: DQNTrainerState, batch: rlt.DiscreteDqnInput
    ) -> Tuple[DQNTrainerState, Dict[str, Tensor]]:
        target_q, rewards = self._td_target(state, batch)

        td_loss, grads, (all_q, q_taken) = _value_and_grad(
            self.q_network, state.q_params, batch,
            lambda q_taken: self.loss_fn(q_taken, target_q))

        with torch.no_grad():
            q_params, opt_state = self.optimizer.update(grads, state.opt_state, state.q_params)
            new_state = dataclasses.replace(
                state,
                q_params=q_params,
                q_target_params=soft_update(q_params, state.q_target_params, self.tau),
                opt_state=opt_state,
                step=state.step + 1,
            )
            all_q = all_q.detach()
            metrics = {
                "td_loss": td_loss.detach(),
                "q_values_mean": all_q.mean(),
                "q_taken_mean": q_taken.detach().mean(),
                "reward_mean": rewards.mean(),
            }
            if self.emit_reporter_arrays:
                # per-sample arrays for a reporter's action histograms and
                # recent windows (reference dqn_trainer.py:311-320)
                masked_q = torch.where(batch.possible_actions_mask > 0, all_q, -torch.inf)
                metrics.update(
                    logged_actions=torch.argmax(batch.action, dim=1),
                    logged_rewards=rewards.reshape(-1),
                    model_values=all_q,
                    model_action_idxs=torch.argmax(masked_q, dim=1),
                )
        if self.calc_cpe_in_training:
            new_state, cpe_metrics = self._cpe_step(new_state, batch, rewards)
            metrics.update(cpe_metrics)
        return new_state, metrics

    # ----------------------------------------------------------- CPE heads

    def _cpe_step(self, state: DQNTrainerState, batch: rlt.DiscreteDqnInput, rewards):
        """Train the reward and CPE Q heads (reference
        dqn_trainer_base.py:333-454), in the JAX trainer's order.  The reward
        head regresses the boosted rewards of the logged action; the CPE Q
        head's TD target always masks with ``possible_next_actions_mask``,
        SARSA or not, as the JAX trainer's does."""
        r_loss, r_grads, _ = _value_and_grad(
            self.reward_network, state.reward_params, batch,
            lambda pred_taken: torch.mean((pred_taken - rewards) ** 2))
        with torch.no_grad():
            reward_params, r_opt = self.optimizer.update(
                r_grads, state.reward_opt_state, state.reward_params)
            discount = compute_discount_tensor(
                batch, self.gamma, self.rl.use_seq_num_diff_as_time_diff, self.multi_steps
            )
            not_done = batch.not_terminal.to(torch.float32)
            next_obs = batch.next_state.float_features
            next_q_cpe = functional.apply(self.q_network_cpe, state.cpe_params, next_obs)
            next_q_cpe_t = functional.apply(self.q_network_cpe, state.cpe_target_params, next_obs)
            next_sel, _ = get_max_q_values_with_target(
                next_q_cpe, next_q_cpe_t, batch.possible_next_actions_mask.to(torch.float32),
                self.double_q_learning)
            cpe_target = rewards + discount * next_sel * not_done

        c_loss, c_grads, _ = _value_and_grad(
            self.q_network_cpe, state.cpe_params, batch,
            lambda q_taken: torch.mean((q_taken - cpe_target) ** 2))
        with torch.no_grad():
            cpe_params, c_opt = self.optimizer.update(
                c_grads, state.cpe_opt_state, state.cpe_params)
            new_state = dataclasses.replace(
                state,
                reward_params=reward_params,
                reward_opt_state=r_opt,
                cpe_params=cpe_params,
                cpe_target_params=soft_update(cpe_params, state.cpe_target_params, self.tau),
                cpe_opt_state=c_opt,
            )
        return new_state, {"reward_loss": r_loss.detach(), "cpe_td_loss": c_loss.detach()}

    # ------------------------------------------------------------- inference

    def q_values(self, state: DQNTrainerState, obs: Tensor) -> Tensor:
        """Q [B, A]; a dense MLP's forward is one K3 launch on a CUDA tensor."""
        return functional.score(self.q_network, state.q_params, obs)

    def export_q_network(self, state: DQNTrainerState) -> nn.Module:
        """A copy of the q-network holding the state's online weights."""
        return functional.module_with(self.q_network, state.q_params)


def _value_and_grad(net: nn.Module, params, batch: rlt.DiscreteDqnInput, loss_of_taken):
    """(loss, gradients by name, (all outputs, the logged action's)) of
    ``loss_of_taken(net(state)[logged action])`` with respect to ``params``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = functional.apply(net, leaves, batch.state.float_features)
    taken = torch.sum(out * batch.action, dim=1, keepdim=True)
    loss = loss_of_taken(taken)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss, grads, (out, taken)
