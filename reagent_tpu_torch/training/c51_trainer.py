"""C51 (categorical distributional DQN) trainer.

Port of ``reagent_tpu/training/c51_trainer.py`` (reference:
reagent/training/c51_trainer.py:100-190): the Bellman-updated support is
projected onto the fixed atom grid, and the loss is the cross-entropy of the
logged action's distribution against that projection.

``train_step`` reads no value on the host, so the online loop can call it
without waiting for the device.  It returns a new state and leaves the one
it was given untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.models.categorical_dqn import CategoricalDQN
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
class C51TrainerState:
    q_params: Dict[str, Tensor]
    q_target_params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar on the device


def categorical_projection(
    next_dist: Tensor, target_q: Tensor, qmin: float, qmax: float, num_atoms: int
) -> Tensor:
    """Project the target distribution onto the atom grid (reference
    c51_trainer.py:138-166).  ``next_dist`` [B, N] probabilities at the
    atoms, ``target_q`` [B, N] = r + gamma * support.

    Each atom's mass splits between the grid points below and above
    ``b = (clip(target_q) - qmin) / scale``; where ``b`` is integral the
    corner adjustment gives it to one of them.  The two sums over atoms are
    one-hot products, as JAX writes them, so the card sums each output in
    one fixed order (a ``scatter_add_`` would add them by atomics)."""
    f32 = torch.float32
    scale = (qmax - qmin) / (num_atoms - 1)
    # a product with the float32 reciprocal of the spacing: XLA compiles JAX's
    # division by this constant so (and CUDA divides by a host scalar so)
    b = (torch.clamp(target_q, qmin, qmax) - qmin) * (1.0 / scale)
    lo = torch.floor(b).to(torch.int64)
    up = torch.ceil(b).to(torch.int64)
    # corner case: l == u still contributes its mass (reference :148-158)
    lo = torch.where((up > 0) & (lo == up), lo - 1, lo)
    up = torch.where((lo < num_atoms - 1) & (lo == up), up + 1, up)

    m_lo = next_dist * (up.to(f32) - b)
    m_up = next_dist * (b - lo.to(f32))
    lo_oh = F.one_hot(lo, num_atoms).to(f32)  # [B, N, N]
    up_oh = F.one_hot(up, num_atoms).to(f32)
    return (torch.einsum("bn,bna->ba", m_lo, lo_oh)
            + torch.einsum("bn,bna->ba", m_up, up_oh))


class C51Trainer:
    """Double-Q, max-Q or SARSA (``rl.maxq_learning: false``) targets over a
    ``CategoricalDQN``'s distributions, with the possible-next-actions mask
    and per-action reward boosts.  ``device`` defaults to ``"cuda"`` and
    raises if no card is present."""

    def __init__(
        self,
        q_network: CategoricalDQN,
        rl: RLParameters = RLParameters(),
        double_q_learning: bool = True,
        optimizer: Any = None,
        action_names: Optional[Tuple[str, ...]] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.q_network = q_network.to(self.device)
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.double_q_learning = double_q_learning
        self.maxq_learning = rl.maxq_learning
        self.optimizer = make_optimizer(optimizer)
        boosts = reward_boost_array(rl.reward_boost, action_names)
        self.reward_boosts = None if boosts is None else boosts.to(self.device)
        self.qmin = q_network.qmin
        self.qmax = q_network.qmax
        self.num_atoms = q_network.num_atoms

    def init(self, generator: torch.Generator) -> C51TrainerState:
        """Draw fresh q-network weights from ``generator`` and build the state."""
        self.q_network.reset_parameters(generator)
        return self.state_from_q_network()

    def state_from_q_network(self) -> C51TrainerState:
        """The training state for the q-network's current weights (target a
        copy, fresh optimizer state)."""
        q_params = functional.params_of(self.q_network)
        return C51TrainerState(
            q_params=q_params,
            q_target_params={k: v.clone() for k, v in q_params.items()},
            opt_state=self.optimizer.init(q_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def _log_dist(self, params: Dict[str, Tensor], obs: Tensor) -> Tensor:
        return functional.apply_method(self.q_network, params, "log_dist", obs)

    def train_step(
        self, state: C51TrainerState, batch: rlt.DiscreteDqnInput
    ) -> Tuple[C51TrainerState, Dict[str, Tensor]]:
        support = self.q_network.support
        with torch.no_grad():
            rewards = boost_rewards(batch.reward, batch.action, self.reward_boosts)
            discount = compute_discount_tensor(
                batch, self.gamma, self.rl.use_seq_num_diff_as_time_diff, self.rl.multi_steps
            )
            not_terminal = batch.not_terminal.to(torch.float32)
            next_obs = batch.next_state.float_features

            next_dist_all = torch.exp(self._log_dist(state.q_target_params, next_obs))  # [B, A, N]
            if self.maxq_learning:
                if self.double_q_learning:
                    next_q = torch.sum(
                        torch.exp(self._log_dist(state.q_params, next_obs)) * support, dim=2)
                else:
                    next_q = torch.sum(next_dist_all * support, dim=2)
                mask = batch.possible_next_actions_mask.to(torch.float32)
                next_q = next_q + ACTION_NOT_POSSIBLE_VAL * (1.0 - mask)
                next_action = torch.argmax(next_q, dim=1)  # first index among equals
                index = next_action[:, None, None].expand(-1, 1, self.num_atoms)
                next_dist = torch.gather(next_dist_all, 1, index)[:, 0]
            else:
                next_dist = torch.sum(next_dist_all * batch.next_action[:, :, None], dim=1)

            # Bellman support update; terminal rows collapse to the reward atom
            target_q = rewards + discount * not_terminal * support[None, :]
            m = categorical_projection(next_dist, target_q, self.qmin, self.qmax, self.num_atoms)

        def loss_fn(params):
            log_dist = self._log_dist(params, batch.state.float_features)
            all_q = torch.sum(torch.exp(log_dist) * support, dim=2)
            log_dist_taken = torch.sum(log_dist * batch.action[:, :, None], dim=1)
            return -torch.mean(torch.sum(m * log_dist_taken, dim=1)), all_q

        loss, grads, all_q = functional.value_and_grad(loss_fn, state.q_params, has_aux=True)

        with torch.no_grad():
            q_params, opt_state = self.optimizer.update(grads, state.opt_state, state.q_params)
            new_state = C51TrainerState(
                q_params=q_params,
                q_target_params=soft_update(q_params, state.q_target_params, self.tau),
                opt_state=opt_state,
                step=state.step + 1,
            )
            metrics = {
                "td_loss": loss,
                "q_values_mean": all_q.detach().mean(),
                "reward_mean": rewards.mean(),
            }
        return new_state, metrics

    def q_values(self, state: C51TrainerState, obs: Tensor) -> Tensor:
        """E[Z] [B, A] of the online distributions; the MLP's forward is one
        K3 launch on a float32 CUDA tensor."""
        return functional.score(self.q_network, state.q_params, obs)

    def export_q_network(self, state: C51TrainerState) -> CategoricalDQN:
        """A copy of the q-network holding the state's online weights."""
        return functional.module_with(self.q_network, state.q_params)
