"""Replay sample -> typed batch.

Port of ``make_discrete_dqn_batch`` and ``make_parametric_dqn_batch`` from
``reagent_tpu/gym/preprocessors.py`` (:20, :45; reference
trainer_preprocessor.py DiscreteDqnInputMaker, ParametricDqnInputMaker).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core import types as rlt

Tensor = torch.Tensor


def make_discrete_dqn_batch(batch: Dict[str, Tensor], num_actions: int) -> rlt.DiscreteDqnInput:
    action_idx = batch["action"].reshape(-1).to(torch.int64)
    next_action_idx = batch["next_action"].reshape(-1).to(torch.int64)
    B = action_idx.shape[0]
    dev = action_idx.device
    terminal = batch["terminal"].reshape(B, 1).to(torch.float32)
    ones = torch.ones((B, num_actions), dtype=torch.float32, device=dev)
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(float_features=batch["state"]),
        next_state=rlt.FeatureData(float_features=batch["next_state"]),
        action=F.one_hot(action_idx, num_actions).to(torch.float32),
        next_action=F.one_hot(next_action_idx, num_actions).to(torch.float32),
        reward=batch["reward"].reshape(B, 1),
        time_diff=torch.ones((B, 1), dtype=torch.float32, device=dev),
        step=batch["step"].reshape(B, 1),
        not_terminal=1.0 - terminal,
        possible_actions_mask=batch.get("possible_actions_mask", ones),
        possible_next_actions_mask=batch.get("next_possible_actions_mask", ones),
        extras=rlt.ExtraData(),
    )


def make_parametric_dqn_batch(
    batch: Dict[str, Tensor], num_actions: int
) -> rlt.ParametricDqnInput:
    """A discrete env's sample as a parametric batch: the actions become
    one-hot feature vectors, and every action is possible, ``tile(eye(A),
    (B, 1))`` (row ``i * A + j`` is action j of row i)."""
    action_idx = batch["action"].reshape(-1).to(torch.int64)
    next_action_idx = batch["next_action"].reshape(-1).to(torch.int64)
    B = action_idx.shape[0]
    dev = action_idx.device
    terminal = batch["terminal"].reshape(B, 1).to(torch.float32)
    tiled_actions = torch.eye(num_actions, device=dev).repeat(B, 1)  # [B*A, A]
    ones = torch.ones((B, num_actions), dtype=torch.float32, device=dev)
    return rlt.ParametricDqnInput(
        state=rlt.FeatureData(float_features=batch["state"]),
        next_state=rlt.FeatureData(float_features=batch["next_state"]),
        action=rlt.FeatureData(
            float_features=F.one_hot(action_idx, num_actions).to(torch.float32)),
        next_action=rlt.FeatureData(
            float_features=F.one_hot(next_action_idx, num_actions).to(torch.float32)),
        possible_actions=rlt.FeatureData(float_features=tiled_actions),
        possible_actions_mask=ones,
        possible_next_actions=rlt.FeatureData(float_features=tiled_actions),
        possible_next_actions_mask=ones,
        reward=batch["reward"].reshape(B, 1),
        time_diff=torch.ones((B, 1), dtype=torch.float32, device=dev),
        step=batch["step"].reshape(B, 1),
        not_terminal=1.0 - terminal,
        extras=rlt.ExtraData(),
    )
