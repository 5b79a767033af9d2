"""Shared RL-trainer utilities.

Port of ``reagent_tpu/training/rl_trainer_base.py`` (reference:
reagent/training/dqn_trainer_base.py:24-79, rl_trainer_pytorch.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

# Q-value for an impossible action: guaranteed worse than any real action
# (reference dqn_trainer_base.py:27).
ACTION_NOT_POSSIBLE_VAL = -1e9


def get_max_q_values_with_target(
    q_values: Tensor,
    q_values_target: Tensor,
    possible_actions_mask: Tensor,
    double_q_learning: bool,
) -> Tuple[Tensor, Tensor]:
    """Max-Q with action masking and optional double-Q selection.

    Reference: dqn_trainer_base.py:34-79.  Returns ([B,1] max q, [B,1] argmax).
    Among equal maxima (an untrained net, a fully masked row) the first index
    wins, as with ``jnp.argmax``: ``torch.argmax`` documents the same.
    """
    q_values = q_values.reshape(possible_actions_mask.shape)
    q_values_target = q_values_target.reshape(possible_actions_mask.shape)
    penalty = ACTION_NOT_POSSIBLE_VAL * (1.0 - possible_actions_mask)
    q_values = q_values + penalty
    q_values_target = q_values_target + penalty
    selector = q_values if double_q_learning else q_values_target
    max_idx = torch.argmax(selector, dim=1, keepdim=True)
    return torch.gather(q_values_target, 1, max_idx), max_idx


def get_max_q_values(
    q_values: Tensor, possible_actions_mask: Tensor
) -> Tuple[Tensor, Tensor]:
    return get_max_q_values_with_target(
        q_values, q_values, possible_actions_mask, double_q_learning=False
    )


def boost_rewards(
    rewards: Tensor, actions_onehot: Tensor, reward_boosts: Optional[Tensor]
) -> Tensor:
    """Add per-action reward boost (reference dqn_trainer_base.py:116-126)."""
    if reward_boosts is None:
        return rewards
    boost = torch.sum(actions_onehot * reward_boosts.to(rewards.device), dim=1, keepdim=True)
    return rewards + boost


def compute_discount_tensor(
    batch,
    gamma: float,
    use_seq_num_diff_as_time_diff: bool = False,
    multi_steps: Optional[int] = None,
) -> Tensor:
    """gamma, gamma^time_diff, or gamma^step (reference dqn_trainer.py:168-178)."""
    discount = torch.full_like(batch.reward, gamma)
    if use_seq_num_diff_as_time_diff:
        discount = gamma ** batch.time_diff.to(torch.float32)
    if multi_steps is not None and batch.step is not None:
        discount = gamma ** batch.step.to(torch.float32)
    return discount


def q_network_loss_fn(name: str) -> Callable[[Tensor, Tensor], Tensor]:
    """"mse" or "huber" (reference rl_trainer_pytorch.py q_network_loss)."""
    if name == "mse":
        return lambda pred, target: torch.mean((pred - target) ** 2)
    if name in ("huber", "smooth_l1"):
        def huber(pred, target):
            err = pred - target
            a = err.abs()
            return torch.mean(torch.where(a < 1.0, 0.5 * err**2, a - 0.5))
        return huber
    raise ValueError(f"unknown q_network_loss {name!r}")


def reward_boost_array(
    reward_boost: Optional[Dict[str, float]], action_names: Optional[Tuple[str, ...]]
) -> Optional[Tensor]:
    if not reward_boost or not action_names:
        return None
    return torch.tensor([reward_boost.get(a, 0.0) for a in action_names], dtype=torch.float32)
