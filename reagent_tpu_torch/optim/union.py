"""Optimizer tagged union as plain update rules on explicit state tensors.

Port of ``reagent_tpu/optim/union.py`` (``Adam`` :33, ``AdamW`` :53, ``SGD``
:76, ``make_optimizer`` :281).  The config contract is kept:
``{"Adam": {"lr": 1e-3}}`` selects and parameterizes the optimizer.  The JAX
package builds optax transforms; the rules here are written to **optax's**
formulas, not ``torch.optim``'s, so a state carried across from optax
continues the same trajectory:

- ``eps`` is added outside the square root, after both bias corrections;
- amsgrad keeps the running max of the bias-corrected second moment and
  divides the bias-corrected first moment by it
  (``optax.scale_by_amsgrad``); ``torch.optim.Adam(amsgrad=True)`` keeps the
  max of the raw moment and corrects afterwards, which gives other
  parameters from the second step on;
- weight decay is decoupled (``optax.adamw``: ``+ weight_decay * p`` after
  the Adam scaling, before ``* -lr``), for ``Adam`` too, where
  ``torch.optim.Adam`` adds an L2 term to the gradient.  As in the JAX
  package, ``Adam`` with a weight decay ignores ``amsgrad``;
- SGD adds ``weight_decay * p`` to the gradient, then takes optax's trace
  (``t <- g + momentum * t``; nesterov: ``g + momentum * t``), then ``* -lr``.

An optimizer is ``init(params) -> OptState`` and ``update(grads, state,
params) -> (new_params, new_state)`` over dicts of tensors; both return new
tensors and write nothing in place.  The other members of the JAX union and
the ``lr_scheduler`` key are not ported yet (``ROADMAP.md`` §1) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from reagent_tpu_torch.core.registry import OPTIMIZERS

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# members of the JAX package's union that the port does not have yet
UNPORTED = (
    "RMSprop", "Adagrad", "Lion", "Adadelta", "Adamax", "NAdam", "RAdam", "Rprop",
    "LBFGS", "ASGD", "SparseAdam", "Lamb", "Adafactor",
)


@dataclasses.dataclass
class OptState:
    """The fields of optax's ``ScaleByAdamState`` / ``ScaleByAmsgradState``
    (``count``, ``mu``, ``nu``, ``nu_max``) and ``TraceState`` (``trace``);
    a rule fills the ones it uses."""

    count: Tensor  # int32 scalar on the parameters' device
    mu: Optional[Params] = None
    nu: Optional[Params] = None
    nu_max: Optional[Params] = None
    trace: Optional[Params] = None


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _count(params: Params) -> Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


class AdamRule:
    """``optax.adam`` / ``amsgrad`` / ``adamw`` and the amsgrad-adamw chain."""

    def __init__(self, lr, b1, b2, eps, weight_decay=0.0, amsgrad=False):
        self.lr, self.b1, self.b2, self.eps = float(lr), float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.amsgrad = bool(amsgrad)

    def init(self, params: Params) -> OptState:
        return OptState(
            count=_count(params), mu=_zeros_like(params), nu=_zeros_like(params),
            nu_max=_zeros_like(params) if self.amsgrad else None)

    def update(self, grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        count = state.count + 1
        t = count.to(torch.float32)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        mu, nu, nu_max, new_params = {}, {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1.0 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * state.nu[k]
            v = nu[k] / bc2
            if self.amsgrad:
                v = nu_max[k] = torch.maximum(state.nu_max[k], v)
            u = (mu[k] / bc1) / (torch.sqrt(v) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            new_params[k] = p + (-self.lr) * u
        return new_params, OptState(
            count=count, mu=mu, nu=nu, nu_max=nu_max if self.amsgrad else None)


class SGDRule:
    """``optax.sgd`` behind ``add_decayed_weights``."""

    def __init__(self, lr, momentum=0.0, weight_decay=0.0, nesterov=False):
        self.lr = float(lr)
        self.momentum = float(momentum) if momentum else None
        self.weight_decay = float(weight_decay)
        self.nesterov = bool(nesterov)

    def init(self, params: Params) -> OptState:
        return OptState(
            count=_count(params),
            trace=_zeros_like(params) if self.momentum is not None else None)

    def update(self, grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        trace, new_params = {}, {}
        for k, p in params.items():
            u = grads[k]
            if self.weight_decay:
                u = u + self.weight_decay * p
            if self.momentum is not None:
                trace[k] = u + self.momentum * state.trace[k]
                u = u + self.momentum * trace[k] if self.nesterov else trace[k]
            new_params[k] = p + (-self.lr) * u
        return new_params, OptState(
            count=state.count + 1, trace=trace if self.momentum is not None else None)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Base class of the union's members."""

    def make_optimizer(self):
        raise NotImplementedError


@OPTIMIZERS.register()
@dataclasses.dataclass(frozen=True)
class Adam(OptimizerConfig):
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    amsgrad: bool = False

    def make_optimizer(self) -> AdamRule:
        return AdamRule(
            self.lr, self.betas[0], self.betas[1], self.eps,
            weight_decay=self.weight_decay,
            amsgrad=self.amsgrad and not self.weight_decay)


@OPTIMIZERS.register()
@dataclasses.dataclass(frozen=True)
class AdamW(OptimizerConfig):
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    amsgrad: bool = False

    def make_optimizer(self) -> AdamRule:
        return AdamRule(
            self.lr, self.betas[0], self.betas[1], self.eps,
            weight_decay=self.weight_decay, amsgrad=self.amsgrad)


@OPTIMIZERS.register()
@dataclasses.dataclass(frozen=True)
class SGD(OptimizerConfig):
    lr: float = 1e-2
    momentum: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False

    def make_optimizer(self) -> SGDRule:
        return SGDRule(self.lr, self.momentum, self.weight_decay, self.nesterov)


def make_optimizer(config: Any):
    """Build an update rule from a tagged-union config, an
    ``OptimizerConfig`` instance, or ``None`` (Adam, lr 1e-3)."""
    if config is None:
        return Adam().make_optimizer()
    if isinstance(config, OptimizerConfig):
        return config.make_optimizer()
    if isinstance(config, dict) and len(config) == 1:
        name, kwargs = next(iter(config.items()))
        if name in UNPORTED:
            raise NotImplementedError(
                f"optimizer {name!r} is not ported yet (ROADMAP.md §1 item 3); "
                "the port has Adam, AdamW and SGD")
        if isinstance(kwargs, dict) and "lr_scheduler" in kwargs:
            raise NotImplementedError(
                "lr_scheduler (optim/scheduler.py) is not ported yet (ROADMAP.md §1 item 3)")
    return OPTIMIZERS.build(config).make_optimizer()
