"""QR-DQN (quantile-regression distributional DQN) trainer.

Port of ``reagent_tpu/training/qrdqn_trainer.py`` (reference:
reagent/training/qrdqn_trainer.py:109-200): quantile-Huber loss between the
Bellman-updated target quantiles and the current quantiles.  The JAX trainer
writes the pairwise loss inline (:116-122); here it is
``ops.quantile_huber.quantile_huber_loss`` (K5), the same function: on a
CUDA tensor one forward and one backward launch of the hand-written kernel
per step, on a CPU tensor the plain pairwise formulation under autograd.

``train_step`` reads no value on the host, so the online loops can call it
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
from reagent_tpu_torch.ops.quantile_huber import quantile_huber_loss
from reagent_tpu_torch.optim import OptState, make_optimizer, soft_update
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.rl_trainer_base import (
    ACTION_NOT_POSSIBLE_VAL,
    boost_rewards,
    compute_discount_tensor,
    reward_boost_array,
)
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class QRDQNTrainerState:
    q_params: Dict[str, Tensor]
    q_target_params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar on the device


class QRDQNTrainer:
    """The q-network emits ``[B, num_actions, num_atoms]`` quantile values, or
    ``[B, num_actions * num_atoms]`` (``FullyConnectedDQN`` from the
    ``QuantileFullyConnected`` builder), which is reshaped.

    ``device`` defaults to ``"cuda"`` and raises if no card is present.
    """

    def __init__(
        self,
        q_network: nn.Module,
        num_atoms: int,
        rl: RLParameters = RLParameters(),
        double_q_learning: bool = True,
        optimizer: Any = None,
        action_names: Optional[Tuple[str, ...]] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.q_network = q_network.to(self.device)
        self.num_atoms = num_atoms
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.double_q_learning = double_q_learning
        self.maxq_learning = rl.maxq_learning
        self.optimizer = make_optimizer(optimizer)
        boosts = reward_boost_array(rl.reward_boost, action_names)
        self.reward_boosts = None if boosts is None else boosts.to(self.device)

    def init(self, generator: torch.Generator) -> QRDQNTrainerState:
        """Draw fresh q-network weights from ``generator`` and build the state."""
        self.q_network.reset_parameters(generator)
        return self.state_from_q_network()

    def state_from_q_network(self) -> QRDQNTrainerState:
        """The training state for the q-network's current weights (target a
        copy, fresh optimizer state)."""
        q_params = functional.params_of(self.q_network)
        return QRDQNTrainerState(
            q_params=q_params,
            q_target_params={k: v.clone() for k, v in q_params.items()},
            opt_state=self.optimizer.init(q_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def _qf(self, params: Dict[str, Tensor], obs: Tensor) -> Tensor:
        """[B, A, N] quantile values."""
        out = functional.apply(self.q_network, params, obs)
        if out.ndim == 2:
            out = out.reshape(out.shape[0], -1, self.num_atoms)
        return out

    def train_step(
        self, state: QRDQNTrainerState, batch: rlt.DiscreteDqnInput
    ) -> Tuple[QRDQNTrainerState, Dict[str, Tensor]]:
        with torch.no_grad():
            rewards = boost_rewards(batch.reward, batch.action, self.reward_boosts)
            discount = compute_discount_tensor(
                batch, self.gamma, self.rl.use_seq_num_diff_as_time_diff, self.rl.multi_steps
            )
            not_done = batch.not_terminal.to(torch.float32)
            next_obs = batch.next_state.float_features

            next_qf = self._qf(state.q_target_params, next_obs)  # [B, A, N]
            if self.maxq_learning:
                sel_src = (
                    self._qf(state.q_params, next_obs) if self.double_q_learning else next_qf
                )
                next_q = sel_src.mean(dim=2)
                mask = batch.possible_next_actions_mask.to(torch.float32)
                next_q = next_q + ACTION_NOT_POSSIBLE_VAL * (1.0 - mask)
                next_action = torch.argmax(next_q, dim=1)  # first index among equals
                index = next_action[:, None, None].expand(-1, 1, self.num_atoms)
                next_qf_sel = torch.gather(next_qf, 1, index)[:, 0]
            else:
                next_qf_sel = torch.sum(next_qf * batch.next_action[:, :, None], dim=1)
            target_q = rewards + discount * not_done * next_qf_sel  # [B, N]

        params = {k: v.detach().requires_grad_(True) for k, v in state.q_params.items()}
        qf = self._qf(params, batch.state.float_features)  # [B, A, N]
        qf_taken = torch.sum(qf * batch.action[:, :, None], dim=1)  # [B, N]
        loss = quantile_huber_loss(target_q, qf_taken, 1.0)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

        with torch.no_grad():
            q_params, opt_state = self.optimizer.update(grads, state.opt_state, state.q_params)
            new_state = QRDQNTrainerState(
                q_params=q_params,
                q_target_params=soft_update(q_params, state.q_target_params, self.tau),
                opt_state=opt_state,
                step=state.step + 1,
            )
            metrics = {"td_loss": loss.detach(), "q_values_mean": qf.detach().mean()}
        return new_state, metrics

    def q_values(self, state: QRDQNTrainerState, obs: Tensor) -> Tensor:
        """Q [B, A]: the mean over atoms of the online quantiles."""
        out = functional.score(self.q_network, state.q_params, obs)
        return out.reshape(out.shape[0], -1, self.num_atoms).mean(dim=2)

    def export_q_network(self, state: QRDQNTrainerState) -> nn.Module:
        """A copy of the q-network holding the state's online weights."""
        return functional.module_with(self.q_network, state.q_params)
