"""Optimizer configuration: the tagged-union configs and the soft update.

Port of ``reagent_tpu/optim/``: the same ``{Name: {kwargs}}`` config shape
builds a plain update rule on explicit state tensors, written to optax's
formulas.
"""

from reagent_tpu_torch.optim.soft_update import soft_update
from reagent_tpu_torch.optim.union import (
    SGD,
    Adam,
    AdamW,
    OptimizerConfig,
    OptState,
    make_optimizer,
)

__all__ = [
    "Adam",
    "AdamW",
    "SGD",
    "OptimizerConfig",
    "OptState",
    "make_optimizer",
    "soft_update",
]
