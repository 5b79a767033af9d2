"""Scorers: (weights, obs) -> action scores for a policy.

Port of ``apply_possible_actions_mask``, ``discrete_dqn_scorer``,
``parametric_dqn_scorer``, ``sac_scorer`` and ``slate_q_scorer`` from
``reagent_tpu/gym/policies/scorers.py`` (:22-80).  The DQN scorer runs a dense MLP's forward
as one K3 launch (``ops/fused_mlp.py``) on the weights it is given:
``mlp_weight_list(q_network)`` for a module,
``FusedDQNTrainer.mlp_weights(state)`` for a fused trainer state, or the
``q_params`` dict of an unfused trainer state, which also serves modules
that are no flat MLP (``training.functional.score``: a ``CategoricalDQN``'s
logits through K3 and E[Z] in torch; others their own forward).  A
``[B, A, N]`` quantile head is averaged over its atoms.  The parametric
scorer scores every action of each row in one forward over the tiled rows,
one K3 launch for a ``FullyConnectedCritic``; the slate-Q scorer scores
every candidate of each row the same way.  ``sac_scorer`` (:57-66) runs a
gaussian actor's dense trunk as one K3 launch and takes the split, the layer
norms and the clip in torch.  A net with a norm or a skip connection runs
its module's own forward (``training.functional.takes_k3``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
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


def sac_scorer(actor_network: nn.Module) -> Callable:
    """A gaussian policy head's (loc, log-scale) (ref continuous_scorer.py:
    12-21): ``score(params, obs [B, D]) -> GaussianSamplerScore``, the
    float32 dense trunk one K3 launch on a CUDA tensor
    (``training.functional.loc_and_scale_log``, as the online jobs' act
    step)."""

    def score(params, obs: Tensor) -> rlt.GaussianSamplerScore:
        loc, scale_log = functional.loc_and_scale_log(actor_network, params, obs)
        return rlt.GaussianSamplerScore(loc=loc, scale_log=scale_log)

    return score


def slate_q_scorer(num_candidates: int, q_network: nn.Module) -> Callable:
    """p(select) * Q(s, doc) per candidate (ref slate_q_scorer.py:13-30):
    ``score(params, state: FeatureData with candidate_docs) -> [B, C]``.
    Each state is repeated in place against its candidates, and a float32
    dense ``FullyConnectedCritic`` scores the ``[B * C, S + D]`` rows in one
    K3 launch (``training.functional.score``); the choice model's softmax
    over the docs' values follows in torch."""

    def score(params, state: rlt.FeatureData) -> Tensor:
        docs = state.candidate_docs
        if docs is None:
            raise ValueError("slate_q_scorer needs state.candidate_docs")
        B = state.float_features.shape[0]
        tiled = state.float_features.repeat_interleave(num_candidates, dim=0)
        feats = docs.float_features.reshape(B * num_candidates, -1)
        scores = functional.score(q_network, params, tiled, feats).reshape(B, num_candidates)
        return torch.softmax(docs.value, dim=1) * scores

    return score
