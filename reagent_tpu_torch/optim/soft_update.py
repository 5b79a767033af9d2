"""Target-network soft update.

Port of ``reagent_tpu/optim/soft_update.py::soft_update`` (:13-17):
``target <- tau * source + (1 - tau) * target`` over a dict of parameters.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


def soft_update(
    source_params: Dict[str, Tensor], target_params: Dict[str, Tensor], tau: float
) -> Dict[str, Tensor]:
    """Polyak averaging, ``tau=1`` a hard copy.  Returns new tensors; neither
    argument is written."""
    return {
        k: tau * source_params[k].detach() + (1.0 - tau) * t
        for k, t in target_params.items()
    }
