"""DQN trainer (double-Q, SARSA mode, reward boosting), the unfused path.

Port of ``reagent_tpu/training/dqn_trainer.py`` (reference:
reagent/training/dqn_trainer.py:28-120 + dqn_trainer_base.py) without the
CPE heads and without BCQ, which are not ported yet (``ROADMAP.md`` §1 item
2) and raise.  One ``train_step`` computes the TD loss, its gradient by
autograd, the optimizer update and the target-network polyak blend; it
reads no value on the host, returns a new state and leaves the one it was
given untouched.
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


class DQNTrainer:
    """Discrete-action DQN with double-Q.

    ``device`` defaults to ``"cuda"`` and raises if no card is present.
    """

    def __init__(
        self,
        q_network: nn.Module,
        rl: RLParameters = RLParameters(),
        double_q_learning: bool = True,
        bcq_drop_threshold: Optional[float] = None,
        optimizer: Any = None,
        action_names: Optional[Tuple[str, ...]] = None,
        reward_network: Optional[nn.Module] = None,
        q_network_cpe: Optional[nn.Module] = None,
        emit_reporter_arrays: bool = False,
        device="cuda",
    ) -> None:
        if bcq_drop_threshold is not None:
            raise NotImplementedError("BCQ is not ported yet (ROADMAP.md §1 item 2)")
        if reward_network is not None or q_network_cpe is not None:
            raise NotImplementedError(
                "the CPE heads (reward_network, q_network_cpe) are not ported yet "
                "(ROADMAP.md §1 item 2)")
        self.device = resolve_device(device)
        self.emit_reporter_arrays = emit_reporter_arrays
        self.q_network = q_network.to(self.device)
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.double_q_learning = double_q_learning
        self.maxq_learning = rl.maxq_learning
        self.multi_steps = rl.multi_steps
        self.optimizer = make_optimizer(optimizer)
        self.loss_fn = q_network_loss_fn(rl.q_network_loss)
        boosts = reward_boost_array(rl.reward_boost, action_names)
        self.reward_boosts = None if boosts is None else boosts.to(self.device)

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> DQNTrainerState:
        """Draw fresh q-network weights from ``generator`` and build the state."""
        self.q_network.reset_parameters(generator)
        return self.state_from_q_network()

    def state_from_q_network(self) -> DQNTrainerState:
        """The training state for the q-network's current weights (target a
        copy, fresh optimizer state)."""
        q_params = functional.params_of(self.q_network)
        return DQNTrainerState(
            q_params=q_params,
            q_target_params={k: v.clone() for k, v in q_params.items()},
            opt_state=self.optimizer.init(q_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

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

        params = {k: v.detach().requires_grad_(True) for k, v in state.q_params.items()}
        all_q = functional.apply(self.q_network, params, batch.state.float_features)
        q_taken = torch.sum(all_q * batch.action, dim=1, keepdim=True)
        td_loss = self.loss_fn(q_taken, target_q)
        grads = dict(zip(params, torch.autograd.grad(td_loss, list(params.values()))))

        with torch.no_grad():
            q_params, opt_state = self.optimizer.update(grads, state.opt_state, state.q_params)
            new_state = DQNTrainerState(
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
        return new_state, metrics

    # ------------------------------------------------------------- inference

    def q_values(self, state: DQNTrainerState, obs: Tensor) -> Tensor:
        """Q [B, A]; a dense MLP's forward is one K3 launch on a CUDA tensor."""
        return functional.score(self.q_network, state.q_params, obs)

    def export_q_network(self, state: DQNTrainerState) -> nn.Module:
        """A copy of the q-network holding the state's online weights."""
        return functional.module_with(self.q_network, state.q_params)
