"""Target-network soft update.

Port of ``reagent_tpu/optim/soft_update.py``: ``soft_update`` (:13-17),
``target <- tau * source + (1 - tau) * target`` over a dict of parameters,
and ``soft_update_excluding`` (:20), which hard-copies the leaves a predicate
picks.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from reagent_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor


def soft_update(
    source_params: Dict[str, Tensor], target_params: Dict[str, Tensor], tau: float
) -> Dict[str, Tensor]:
    """Polyak averaging, ``tau=1`` a hard copy.  Returns new tensors; neither
    argument is written."""
    with annotate("reagent.optim.soft_update"):
        return {
            k: tau * source_params[k].detach() + (1.0 - tau) * t
            for k, t in target_params.items()
        }


def soft_update_excluding(
    source_params: Dict[str, Tensor], target_params: Dict[str, Tensor], tau: float,
    hard_copy_fn: Callable[[str], bool],
) -> Dict[str, Tensor]:
    """``soft_update``, except that a leaf whose ``/``-joined name satisfies
    ``hard_copy_fn`` is copied from the source (the reference's
    no_soft_update_embedding.py: embedding tables are synced, not blended).
    The port's names are ``.``-joined module paths; the predicate sees them
    ``/``-joined, as JAX's sees its key paths, e.g. ``lambda path:
    "embedding" in path``."""
    return {
        k: (source_params[k].detach().clone() if hard_copy_fn(k.replace(".", "/"))
            else tau * source_params[k].detach() + (1.0 - tau) * t)
        for k, t in target_params.items()
    }
