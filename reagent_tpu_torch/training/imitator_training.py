"""BCQ imitator helpers: mask the actions the behaviour model finds implausible.

Port of ``reagent_tpu/training/imitator_training.py`` (reference
reagent/training/imitator_training.py:13-26): drop the actions whose
imitator propensity, relative to the most likely action's, is below
``drop_threshold``.  ``models/bcq.py`` masks Q-values with a threshold on the
raw softmax; this is the other rule and stays a separate function.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch
from torch import nn

from reagent_tpu_torch.training import functional

Tensor = torch.Tensor
Imitator = Union[Callable[[Tensor], Tensor], Tuple[nn.Module, functional.Params]]


def get_valid_actions_from_imitator(
    imitator: Imitator, float_features: Tensor, drop_threshold: float
) -> Tensor:
    """[B, A] float mask of the viable actions under the imitator.

    ``imitator`` is a callable features -> logits, or a ``(module, params)``
    pair scored through ``functional.score``: a float32 dense chain there is
    one K3 launch on a CUDA tensor.  The softmax, the division by the row's
    largest probability and the threshold stay in torch."""
    if isinstance(imitator, tuple):
        module, params = imitator
        logits = functional.score(module, params, float_features)
    else:
        logits = imitator(float_features)
    probs = torch.softmax(torch.as_tensor(logits), dim=1)
    filter_values = probs / torch.amax(probs, dim=1, keepdim=True)
    return (filter_values >= drop_threshold).to(torch.float32)
