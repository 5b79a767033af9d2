"""Shared training utilities.

Port of ``reagent_tpu/training/utils.py`` (reference:
reagent/training/utils.py): ``whiten`` (standard deviation with ddof 1),
``discounted_returns`` (the reward-to-go, right to left as
``carry = r + gamma * carry``), ``masked_whiten`` over the real steps of a
padded episode and ``rescale_actions``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

EPS = 1e-8


def whiten(x: Tensor, subtract_mean: bool) -> Tensor:
    numer = x - torch.mean(x) if subtract_mean else x
    return numer / (torch.std(x, correction=1) + EPS)


def discounted_returns(rewards: Tensor, gamma: float = 0.0) -> Tensor:
    """Reward-to-go along dim 0 (reference utils.py:40-51): a loop over the
    steps from the last, each one elementwise op on the device."""
    rewards = rewards.to(torch.float32)
    if gamma == 0:
        return rewards
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + gamma * carry
        out[t] = carry
    return out


def masked_whiten(x: Tensor, mask: Tensor, subtract_mean: bool) -> Tensor:
    """Whiten with the statistics of the steps where ``mask`` is 1."""
    n = torch.clamp(torch.sum(mask), min=1.0)
    mean = torch.sum(x * mask) / n
    var = torch.sum(((x - mean) * mask) ** 2) / torch.clamp(n - 1.0, min=1.0)
    numer = x - mean if subtract_mean else x
    return numer / (torch.sqrt(var) + EPS)


def rescale_actions(
    actions: Tensor, new_min: Tensor, new_max: Tensor, prev_min: Tensor, prev_max: Tensor,
) -> Tensor:
    """Map actions from [prev_min, prev_max] to [new_min, new_max] (reference
    utils.py:55)."""
    prev_range = prev_max - prev_min
    new_range = new_max - new_min
    return ((actions - prev_min) / prev_range) * new_range + new_min
