"""Contextual-bandit training utilities.

Port of ``reagent_tpu/training/cb/utils.py`` (reference
reagent/training/cb/utils.py:16-142): ``add_chosen_arm_features``,
``argmax_random_tie_breaks`` (row-wise argmax, ties broken by one random
column permutation shared by every row) and ``get_model_actions`` (masked
argmax).  JAX draws the permutation from an explicit key and raises
without one; here it is given as ``perm`` (JAX's
``jax.random.permutation(key, K)``) or drawn from a ``torch.Generator``,
and the function raises without either.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from reagent_tpu_torch.core.types import CBInput

Tensor = torch.Tensor
NEG_INF = -1e30


def add_chosen_arm_features(
    batch: Union[CBInput, List[CBInput]],
) -> Union[CBInput, List[CBInput]]:
    """Fill ``features_of_chosen_arm`` (and ``chosen_arm_id``).

    Joint models: ``context_arm_features`` [B, num_arms, arm_dim] and
    ``action`` [B, 1] selects the arm of each row.  Disjoint models: a list
    of per-arm batches whose 2-D features pass through unchanged.
    """
    if isinstance(batch, CBInput):
        assert batch.context_arm_features.ndim == 3
        assert batch.action is not None
        act = batch.action.reshape(-1).to(torch.int64)
        chosen = torch.take_along_dim(batch.context_arm_features, act[:, None, None], dim=1)
        updates = {"features_of_chosen_arm": chosen[:, 0, :]}
        if batch.arms is not None:
            updates["chosen_arm_id"] = torch.take_along_dim(batch.arms, act[:, None], dim=1)
        return batch.replace(**updates)
    if isinstance(batch, list):
        assert isinstance(batch[0], CBInput)
        assert batch[0].context_arm_features.ndim == 2
        return [b.replace(features_of_chosen_arm=b.context_arm_features) for b in batch]
    raise ValueError(f"Unexpected input type {type(batch)} for add_chosen_arm_features")


def argmax_random_tie_breaks(scores: Tensor, mask: Optional[Tensor] = None,
                             perm: Optional[Tensor] = None,
                             generator: Optional[torch.Generator] = None) -> Tensor:
    """Row-wise argmax; ties are broken by one random column permutation, so
    the same tied columns resolve the same way on every row (reference
    :74-112)."""
    assert scores.ndim == 2
    if perm is None:
        if generator is None:
            raise ValueError(
                "argmax_random_tie_breaks needs a permutation or a generator: the reference "
                "draws fresh randomness per call, so a fixed default would make 'randomized' "
                "tie-breaking deterministic.")
        perm = torch.randperm(scores.shape[1], generator=generator, device=scores.device)
    perm = perm.to(device=scores.device, dtype=torch.int64)
    permuted = scores[:, perm]
    if mask is not None:
        permuted = torch.where(mask[:, perm].to(torch.bool), permuted,
                               torch.full_like(permuted, NEG_INF))
    return perm[torch.argmax(permuted, dim=1)]


def get_model_actions(scores: Tensor, mask: Optional[Tensor] = None,
                      randomize_ties: bool = False, perm: Optional[Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> Tensor:
    """[B, 1] chosen-action indices = masked row argmax (reference :114-142)."""
    if randomize_ties:
        return argmax_random_tie_breaks(scores, mask, perm, generator).reshape(-1, 1)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, torch.full_like(scores, NEG_INF))
    return torch.argmax(scores, dim=1).reshape(-1, 1)


def chosen_arm_features(batch: CBInput) -> Tensor:
    """[B, D]: each row's features at its logged action."""
    row = torch.arange(batch.context_arm_features.shape[0],
                       device=batch.context_arm_features.device)
    return batch.context_arm_features[row, batch.action.reshape(-1).to(torch.int64)]
