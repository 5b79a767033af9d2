"""Optimizer configuration: the tagged-union configs and the soft update.

Port of ``reagent_tpu/optim/``: the same ``{Name: {kwargs}}`` config shape
builds a plain update rule on explicit state tensors, written to optax's
formulas.
"""

from reagent_tpu_torch.optim.scheduler import LR_SCHEDULERS, with_scheduler
from reagent_tpu_torch.optim.soft_update import soft_update, soft_update_excluding
from reagent_tpu_torch.optim.union import (
    SGD,
    Adagrad,
    Adam,
    AdamW,
    Lion,
    OptimizerConfig,
    OptState,
    RMSprop,
    make_optimizer,
)

__all__ = [
    "Adam",
    "AdamW",
    "Adagrad",
    "LR_SCHEDULERS",
    "Lion",
    "RMSprop",
    "SGD",
    "OptimizerConfig",
    "OptState",
    "make_optimizer",
    "soft_update",
    "soft_update_excluding",
    "with_scheduler",
]
