"""Replay sample -> typed batch.

Port of ``make_discrete_dqn_batch``, ``make_parametric_dqn_batch``,
``make_policy_network_batch``, ``make_slate_q_batch`` and
``make_trainer_preprocessor`` from ``reagent_tpu/gym/preprocessors.py``
(:20, :45, :76, :98, :142; reference trainer_preprocessor.py
DiscreteDqnInputMaker, ParametricDqnInputMaker, PolicyNetworkInputMaker,
SlateQInputMaker).
"""

from __future__ import annotations

import typing
from typing import Dict, Optional

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


def make_policy_network_batch(batch: Dict[str, Tensor]) -> rlt.PolicyNetworkInput:
    """A continuous-control sample as SAC's and TD3's batch
    (trainer_preprocessor.py PolicyNetworkInputMaker): rank-1 actions
    become ``[B, 1]``."""
    B = batch["state"].shape[0]
    dev = batch["state"].device
    terminal = batch["terminal"].reshape(B, 1).to(torch.float32)
    action, next_action = batch["action"], batch["next_action"]
    if action.ndim == 1:
        action, next_action = action[:, None], next_action[:, None]
    return rlt.PolicyNetworkInput(
        state=rlt.FeatureData(float_features=batch["state"]),
        next_state=rlt.FeatureData(float_features=batch["next_state"]),
        action=rlt.FeatureData(float_features=action),
        next_action=rlt.FeatureData(float_features=next_action),
        reward=batch["reward"].reshape(B, 1),
        time_diff=torch.ones((B, 1), dtype=torch.float32, device=dev),
        step=batch["step"].reshape(B, 1),
        not_terminal=1.0 - terminal,
        extras=rlt.ExtraData(),
    )


def make_slate_q_batch(batch: Dict[str, Tensor]) -> rlt.SlateQInput:
    """A slate sample as ``SlateQInput`` (reference trainer_preprocessor.py:
    230-275 SlateQInputMaker).  The keys: ``doc`` [B, C, D] candidate
    features, ``doc_value`` [B, C] (the ValueWrapper's head), ``action`` [B,
    S] slate indices, ``position_reward`` [B, S] (watch time),
    ``response_click`` [B, S] click indicators, their ``next_*`` twins, and
    optionally ``item_mask`` (all ones where absent) and ``step``.  The
    slate stays without the reference's null action, as JAX's: one click
    masks the unclicked positions out of the loss through ``reward_mask``,
    many clicks train every position on its own reward."""
    B = batch["state"].shape[0]
    dev = batch["state"].device
    terminal = batch["terminal"].reshape(B, 1).to(torch.float32)

    def docs(prefix: str = "") -> rlt.DocList:
        feats = batch[prefix + "doc"]
        mask = batch.get(prefix + "item_mask")
        return rlt.DocList(
            float_features=feats,
            mask=torch.ones(feats.shape[:2], dtype=torch.float32, device=dev)
            if mask is None else mask,
            value=batch[prefix + "doc_value"],
        )

    return rlt.SlateQInput(
        state=rlt.FeatureData(float_features=batch["state"], candidate_docs=docs()),
        next_state=rlt.FeatureData(float_features=batch["next_state"],
                                   candidate_docs=docs("next_")),
        action=batch["action"].to(torch.int32),
        next_action=batch["next_action"].to(torch.int32),
        reward=batch["position_reward"],
        reward_mask=batch["response_click"].to(torch.bool),
        time_diff=torch.ones((B, 1), dtype=torch.float32, device=dev),
        step=batch["step"].reshape(B, 1) if "step" in batch else None,
        not_terminal=1.0 - terminal,
    )


def make_trainer_preprocessor(trainer, num_actions: Optional[int] = None):
    """The batch maker for ``trainer``, picked from the annotation of its
    ``train_step``'s ``batch`` (reference trainer_preprocessor.py:32-57)."""
    hints = typing.get_type_hints(type(trainer).train_step)
    batch_type = hints.get("batch")
    name = getattr(batch_type, "__name__", str(batch_type))
    if name in ("DiscreteDqnInput", "ParametricDqnInput"):
        if num_actions is None:
            raise ValueError(f"{name} needs num_actions")
        maker = make_discrete_dqn_batch if name == "DiscreteDqnInput" else make_parametric_dqn_batch
        return lambda d: maker(d, num_actions)
    if name == "PolicyNetworkInput":
        return make_policy_network_batch
    if name == "SlateQInput":
        return make_slate_q_batch
    raise NotImplementedError(
        f"no batch maker for trainer {type(trainer).__name__} (batch: {name})")
