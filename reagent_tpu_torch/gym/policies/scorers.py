"""Scorers: (weights, obs) -> action scores for a policy.

Port of ``apply_possible_actions_mask``, ``discrete_dqn_scorer`` and
``parametric_dqn_scorer`` from ``reagent_tpu/gym/policies/scorers.py``
(:22-56).  The DQN scorer runs a dense MLP's forward as one K3 launch
(``ops/fused_mlp.py``) on the weights it is given:
``mlp_weight_list(q_network)`` for a module,
``FusedDQNTrainer.mlp_weights(state)`` for a fused trainer state, or the
``q_params`` dict of an unfused trainer state, which also serves modules
that are no flat MLP (``training.functional.score``: a ``CategoricalDQN``'s
logits through K3 and E[Z] in torch; others their own forward).  A
``[B, A, N]`` quantile head is averaged over its atoms.  The parametric
scorer scores every action of each row in one forward over the tiled rows,
one K3 launch for a ``FullyConnectedCritic``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward
from reagent_tpu_torch.training import functional

Tensor = torch.Tensor

NEG_INF = -1e9  # finite so a masked softmax stays well-defined in float32


def apply_possible_actions_mask(
    scores: Tensor,
    possible_actions_mask: Optional[Tensor] = None,
    invalid_score: float = NEG_INF,
) -> Tensor:
    """Invalid actions get ``invalid_score`` (ref discrete_scorer.py:18-30)."""
    if possible_actions_mask is None:
        return scores
    return torch.where(possible_actions_mask.to(torch.bool), scores, invalid_score)


def discrete_dqn_scorer(q_network: nn.Module) -> Callable:
    """Q scores per action (ref discrete_scorer.py:33-49):
    ``score(weights, obs [B, D], mask=None) -> [B, A]``, where ``weights`` is
    K3's ``[(W [in, out], b [out]), ...]`` for a dense MLP q-network, or a
    ``{name: tensor}`` parameter dict of ``q_network``."""

    def score(weights, obs: Tensor, possible_actions_mask: Optional[Tensor] = None) -> Tensor:
        if isinstance(weights, dict):
            scores = functional.score(q_network, weights, obs)
        else:
            scores = fused_mlp_forward(obs, weights, list(q_network.activations))
        if scores.ndim == 3:  # quantile head: mean over atoms
            scores = scores.mean(dim=2)
        return apply_possible_actions_mask(scores, possible_actions_mask)

    return score


def parametric_dqn_scorer(max_num_actions: int, q_network: nn.Module) -> Callable:
    """Q(s, one-hot a) for every action (ref discrete_scorer.py:66-88):
    ``score(params, obs [B, D]) -> [B, max_num_actions]``, over each state
    repeated in place (``[s0, s0, s1, s1, ...]``) against ``tile(eye(A),
    (B, 1))``."""

    def score(params, obs: Tensor) -> Tensor:
        B = obs.shape[0]
        tiled = obs.repeat_interleave(max_num_actions, dim=0)
        actions = torch.eye(max_num_actions, device=obs.device).repeat(B, 1)
        return functional.score(q_network, params, tiled, actions).reshape(B, max_num_actions)

    return score
