"""Optimizer tagged union as plain update rules on explicit state tensors.

Port of ``reagent_tpu/optim/union.py`` (every member, :33-279, and
``make_optimizer`` :281).  The config contract is kept:
``{"Adam": {"lr": 1e-3}}`` selects and parameterizes the optimizer, and an
``lr_scheduler`` key in its kwargs composes a schedule (``optim/
scheduler.py``).  The JAX package builds optax transforms; the rules here
are written to **optax 0.2's** formulas and order of operations, not
``torch.optim``'s, so a state carried across from optax continues the same
trajectory.  Where they part from ``torch.optim``:

- Adam: ``eps`` outside the square root, after both bias corrections;
  amsgrad keeps the running max of the bias-corrected second moment; weight
  decay is decoupled (``+ weight_decay * p`` after the scaling, before
  ``* -lr``), for ``Adam`` too, which then ignores ``amsgrad``;
- SGD (and ``ASGD``, which is SGD with no averaging): ``weight_decay * p``
  added to the gradient, then optax's trace, then ``* -lr``;
- RMSprop: eps inside the square root, ``rsqrt(nu + eps)``; momentum is a
  trace taken after the ``* -lr``;
- Adagrad: the accumulator starts at 0.1 and scales by ``rsqrt(acc + eps)``;
- NAdam is Adam with optax's nesterov moment, RAdam optax's rectified
  Adam (threshold 5), Lamb Adam with decoupled decay and the per-tensor
  trust ratio, SparseAdam Adam;
- Adafactor (``lr`` None, as JAX's default): the second moment factored
  into row and column means for every tensor whose two largest dims are at
  least 128, decay ``1 - (t + 1)^-0.8``, the update clipped to block RMS 1,
  multiplied by the parameter's RMS (at least 1e-3);
- LBFGS: ``optax.lbfgs`` needs the loss's value, gradient and ``value_fn``
  at update, so ``update(grads, state, params)`` raises ``TypeError`` in
  the JAX package and no JAX trainer can run it; the port's rule raises the
  same way (``ROADMAP.md`` §1 item 3).

An optimizer is ``init(params) -> OptState`` and ``update(grads, state,
params) -> (new_params, new_state)`` over dicts of tensors; both return new
tensors and write nothing in place.  ``updates`` gives the step itself
(optax's ``updates``), which a schedule scales.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from reagent_tpu_torch.core.registry import OPTIMIZERS
from reagent_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass
class OptState:
    """The fields of optax's states, by name: ``ScaleByAdamState`` /
    ``ScaleByAmsgradState`` / ``ScaleByLionState`` (``count``, ``mu``,
    ``nu``, ``nu_max``), ``TraceState`` (``trace``), ``ScaleByRmsState``
    and ``ScaleByRStdDevState`` (``nu``, ``mu``), ``ScaleByRssState``
    (``sum_of_squares``), ``ScaleByAdaDeltaState`` (``e_g``, ``e_x``),
    ``ScaleByRpropState`` (``step_sizes``, ``prev_updates``),
    ``FactoredState`` (``count``, ``v_row``, ``v_col``, ``v``) and
    ``ScaleByScheduleState`` (``schedule_count``); a rule fills the ones it
    uses.  ``count`` counts the updates for every rule."""

    count: Tensor  # int32 scalar on the parameters' device
    mu: Optional[Params] = None
    nu: Optional[Params] = None
    nu_max: Optional[Params] = None
    trace: Optional[Params] = None
    sum_of_squares: Optional[Params] = None
    e_g: Optional[Params] = None
    e_x: Optional[Params] = None
    step_sizes: Optional[Params] = None
    prev_updates: Optional[Params] = None
    v_row: Optional[Params] = None
    v_col: Optional[Params] = None
    v: Optional[Params] = None
    schedule_count: Optional[Tensor] = None  # int32 scalar: the schedule's own count


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _full_like(params: Params, value: float) -> Params:
    return {k: torch.full_like(p, value) for k, p in params.items()}


def _count(params: Params) -> Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _moment(g: Tensor, m: Tensor, decay: float, order: int) -> Tensor:
    """optax's ``update_moment``: ``(1 - decay) * g**order + decay * m``."""
    return (1.0 - decay) * (g if order == 1 else g * g) + decay * m


def _bias_correction(m: Tensor, decay: float, t: Tensor) -> Tensor:
    return m / (1.0 - decay ** t)


class Rule:
    """``update`` applies ``updates``: ``p + u`` for each parameter."""

    def init(self, params: Params) -> OptState:
        raise NotImplementedError

    def updates(self, grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        raise NotImplementedError

    def update(self, grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        with annotate("reagent.optim.update"):
            u, state = self.updates(grads, state, params)
            return {k: p + u[k] for k, p in params.items()}, state


class AdamRule(Rule):
    """``optax.adam`` / ``amsgrad`` / ``adamw`` / ``nadam`` / ``nadamw``
    and the amsgrad-adamw chain."""

    def __init__(self, lr, b1, b2, eps, weight_decay=0.0, amsgrad=False, nesterov=False):
        self.lr, self.b1, self.b2, self.eps = float(lr), float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.amsgrad = bool(amsgrad)
        self.nesterov = bool(nesterov)

    def init(self, params: Params) -> OptState:
        return OptState(
            count=_count(params), mu=_zeros_like(params), nu=_zeros_like(params),
            nu_max=_zeros_like(params) if self.amsgrad else None)

    def scaled(self, grads: Params, state: OptState):
        """optax's ``scale_by_adam`` (or ``scale_by_amsgrad``): the scaled
        step of each parameter, and the new count and moments."""
        count = state.count + 1
        t = count.to(torch.float32)
        mu, nu, nu_max, u = {}, {}, {}, {}
        for k, g in grads.items():
            mu[k] = _moment(g, state.mu[k], self.b1, 1)
            nu[k] = _moment(g, state.nu[k], self.b2, 2)
            if self.nesterov:
                m_hat = (self.b1 * _bias_correction(mu[k], self.b1, t + 1.0)
                         + (1.0 - self.b1) * _bias_correction(g, self.b1, t))
            else:
                m_hat = _bias_correction(mu[k], self.b1, t)
            v = _bias_correction(nu[k], self.b2, t)
            if self.amsgrad:
                v = nu_max[k] = torch.maximum(state.nu_max[k], v)
            u[k] = m_hat / (torch.sqrt(v) + self.eps)
        return u, OptState(count=count, mu=mu, nu=nu, nu_max=nu_max if self.amsgrad else None)

    def updates(self, grads, state, params):
        u, new = self.scaled(grads, state)
        out = {}
        for k, p in params.items():
            uk = u[k] + self.weight_decay * p if self.weight_decay else u[k]
            out[k] = (-self.lr) * uk
        return out, new


class SGDRule(Rule):
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

    def updates(self, grads, state, params):
        trace, out = {}, {}
        for k, p in params.items():
            u = grads[k]
            if self.weight_decay:
                u = u + self.weight_decay * p
            if self.momentum is not None:
                trace[k] = u + self.momentum * state.trace[k]
                u = u + self.momentum * trace[k] if self.nesterov else trace[k]
            out[k] = (-self.lr) * u
        return out, OptState(
            count=state.count + 1, trace=trace if self.momentum is not None else None)


class RMSpropRule(Rule):
    """``optax.rmsprop``: ``scale_by_rms`` (or ``scale_by_stddev``,
    centered) with eps inside the root, ``* -lr``, then the momentum trace."""

    def __init__(self, lr, decay, eps, momentum=None, centered=False):
        self.lr, self.decay, self.eps = float(lr), float(decay), float(eps)
        self.momentum = float(momentum) if momentum else None
        self.centered = bool(centered)

    def init(self, params: Params) -> OptState:
        return OptState(count=_count(params), nu=_zeros_like(params),
                        mu=_zeros_like(params) if self.centered else None,
                        trace=_zeros_like(params) if self.momentum is not None else None)

    def updates(self, grads, state, params):
        mu, nu, trace, out = {}, {}, {}, {}
        for k, g in grads.items():
            nu[k] = _moment(g, state.nu[k], self.decay, 2)
            if self.centered:
                mu[k] = _moment(g, state.mu[k], self.decay, 1)
                u = torch.rsqrt(nu[k] - mu[k] * mu[k] + self.eps) * g
            else:
                u = torch.rsqrt(nu[k] + self.eps) * g
            u = (-self.lr) * u
            if self.momentum is not None:
                u = trace[k] = u + self.momentum * state.trace[k]
            out[k] = u
        return out, OptState(count=state.count + 1, nu=nu, mu=mu if self.centered else None,
                             trace=trace if self.momentum is not None else None)


class AdagradRule(Rule):
    """``optax.adagrad``: ``scale_by_rss`` from an accumulator of 0.1."""

    INITIAL_ACCUMULATOR = 0.1

    def __init__(self, lr, eps):
        self.lr, self.eps = float(lr), float(eps)

    def init(self, params: Params) -> OptState:
        return OptState(count=_count(params),
                        sum_of_squares=_full_like(params, self.INITIAL_ACCUMULATOR))

    def updates(self, grads, state, params):
        sos, out = {}, {}
        for k, g in grads.items():
            sos[k] = g * g + state.sum_of_squares[k]
            inv = torch.where(sos[k] > 0, torch.rsqrt(sos[k] + self.eps), 0.0)
            out[k] = (-self.lr) * (inv * g)
        return out, OptState(count=state.count + 1, sum_of_squares=sos)


class LionRule(Rule):
    """``optax.lion``: the sign of the interpolated moment, decoupled decay."""

    def __init__(self, lr, b1, b2, weight_decay):
        self.lr, self.b1, self.b2 = float(lr), float(b1), float(b2)
        self.weight_decay = float(weight_decay)

    def init(self, params: Params) -> OptState:
        return OptState(count=_count(params), mu=_zeros_like(params))

    def updates(self, grads, state, params):
        mu, out = {}, {}
        for k, p in params.items():
            g = grads[k]
            u = torch.sign((1.0 - self.b1) * g + self.b1 * state.mu[k])
            mu[k] = _moment(g, state.mu[k], self.b2, 1)
            out[k] = (-self.lr) * (u + self.weight_decay * p)
        return out, OptState(count=state.count + 1, mu=mu)


class AdadeltaRule(Rule):
    """``optax.adadelta`` behind ``add_decayed_weights``."""

    def __init__(self, lr, rho, eps, weight_decay=0.0):
        self.lr, self.rho, self.eps = float(lr), float(rho), float(eps)
        self.weight_decay = float(weight_decay)

    def init(self, params: Params) -> OptState:
        return OptState(count=_count(params), e_g=_zeros_like(params), e_x=_zeros_like(params))

    def updates(self, grads, state, params):
        e_g, e_x, out = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            if self.weight_decay:
                g = g + self.weight_decay * p
            e_g[k] = _moment(g, state.e_g[k], self.rho, 2)
            u = torch.sqrt(state.e_x[k] + self.eps) / torch.sqrt(e_g[k] + self.eps) * g
            e_x[k] = _moment(u, state.e_x[k], self.rho, 2)
            out[k] = (-self.lr) * u
        return out, OptState(count=state.count + 1, e_g=e_g, e_x=e_x)


class AdamaxRule(Rule):
    """``optax.adamax`` (``adamaxw`` with a weight decay): the first moment
    over the infinity norm ``max(|g| + eps, b2 * nu)``."""

    def __init__(self, lr, b1, b2, eps, weight_decay=0.0):
        self.lr, self.b1, self.b2, self.eps = float(lr), float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)

    def init(self, params: Params) -> OptState:
        return OptState(count=_count(params), mu=_zeros_like(params), nu=_zeros_like(params))

    def updates(self, grads, state, params):
        count = state.count + 1
        t = count.to(torch.float32)
        mu, nu, out = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = _moment(g, state.mu[k], self.b1, 1)
            nu[k] = torch.maximum(torch.abs(g) + self.eps, self.b2 * state.nu[k])
            u = _bias_correction(mu[k], self.b1, t) / nu[k]
            if self.weight_decay:
                u = u + self.weight_decay * p
            out[k] = (-self.lr) * u
        return out, OptState(count=count, mu=mu, nu=nu)


class RAdamRule(Rule):
    """``optax.radam`` (threshold 5) behind ``add_decayed_weights``."""

    THRESHOLD = 5.0

    def __init__(self, lr, b1, b2, eps, weight_decay=0.0):
        self.lr, self.b1, self.b2, self.eps = float(lr), float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)

    def init(self, params: Params) -> OptState:
        return OptState(count=_count(params), mu=_zeros_like(params), nu=_zeros_like(params))

    def updates(self, grads, state, params):
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        count = state.count + 1
        t = count.to(torch.float32)
        b2t = self.b2 ** t
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        mu, nu, out = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu[k] = _moment(g, state.mu[k], self.b1, 1)
            nu[k] = _moment(g, state.nu[k], self.b2, 2)
            m_hat = _bias_correction(mu[k], self.b1, t)
            v_hat = _bias_correction(nu[k], self.b2, t)
            u = torch.where(ro >= self.THRESHOLD, r * m_hat / (torch.sqrt(v_hat) + self.eps),
                            m_hat)
            out[k] = (-self.lr) * u
        return out, OptState(count=count, mu=mu, nu=nu)


class RpropRule(Rule):
    """``optax.rprop``: per-entry step sizes grown by ``eta_plus`` while the
    gradient keeps its sign and cut by ``eta_minus`` when it flips, in
    ``[min_step_size, max_step_size]``; optax's order, in which the step
    returned is the previous one, zeroed where the sign flipped."""

    def __init__(self, lr, eta_minus, eta_plus, min_step_size, max_step_size):
        self.lr = float(lr)
        self.eta_minus, self.eta_plus = float(eta_minus), float(eta_plus)
        self.min_step, self.max_step = float(min_step_size), float(max_step_size)

    def init(self, params: Params) -> OptState:
        return OptState(count=_count(params), step_sizes=_full_like(params, self.lr),
                        prev_updates=_zeros_like(params))

    def updates(self, grads, state, params):
        steps, prev, out = {}, {}, {}
        for k, g in grads.items():
            sign = g * state.prev_updates[k]
            grown = torch.clamp(
                state.step_sizes[k] * torch.where(sign > 0, self.eta_plus, self.eta_minus),
                min=self.min_step, max=self.max_step)
            steps[k] = torch.where(sign == 0, state.step_sizes[k], grown)
            prev[k] = torch.where(sign < 0, torch.zeros_like(g), steps[k] * torch.sign(g))
            u = torch.where(sign < 0, torch.zeros_like(g), state.prev_updates[k])
            out[k] = -1.0 * u
        return out, OptState(count=state.count + 1, step_sizes=steps, prev_updates=prev)


class LambRule(AdamRule):
    """``optax.lamb``: Adam's step plus decoupled decay, scaled by each
    tensor's trust ratio ``|p| / |u|`` (1 where either norm is 0)."""

    def updates(self, grads, state, params):
        u, new = self.scaled(grads, state)
        out = {}
        for k, p in params.items():
            uk = u[k] + self.weight_decay * p
            p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(uk)
            ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0),
                                torch.ones((), dtype=p.dtype, device=p.device), p_norm / u_norm)
            out[k] = (-self.lr) * (uk * ratio)
        return out, new


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second largest, largest) axes of a
    tensor of rank 2 or more whose second largest dim is at least
    ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])  # numpy's argsort on these
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class AdafactorRule(Rule):
    """``optax.adafactor(lr)`` at its defaults: ``scale_by_factored_rms``
    (decay 0.8, eps 1e-30, factoring at 128), ``clip_by_block_rms(1.0)``,
    ``* lr`` where given, ``scale_by_param_block_rms`` (min 1e-3), ``* -1``."""

    DECAY, EPS, MIN_DIM, CLIP, MIN_SCALE = 0.8, 1e-30, 128, 1.0, 1e-3

    def __init__(self, lr=None):
        self.lr = None if lr is None else float(lr)

    def init(self, params: Params) -> OptState:
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            dims = factored_dims(p.shape, self.MIN_DIM)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                v_row[k], v_col[k], v[k] = one, one.clone(), torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                v_row[k] = torch.zeros(shape[:d0] + shape[d0 + 1:], dtype=p.dtype, device=p.device)
                v_col[k] = torch.zeros(shape[:d1] + shape[d1 + 1:], dtype=p.dtype, device=p.device)
                v[k] = one.clone()
        return OptState(count=_count(params), v_row=v_row, v_col=v_col, v=v)

    def updates(self, grads, state, params):
        decay_t = 1.0 - (state.count.to(torch.float32) + 1.0) ** (-self.DECAY)
        v_row, v_col, v, out = {}, {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            g2 = g * g + self.EPS
            dims = factored_dims(p.shape, self.MIN_DIM)
            if dims is None:
                v[k] = decay_t * state.v[k] + (1.0 - decay_t) * g2
                v_row[k], v_col[k] = state.v_row[k], state.v_col[k]
                u = g * v[k] ** -0.5
            else:
                d1, d0 = dims
                v_row[k] = decay_t * state.v_row[k] + (1.0 - decay_t) * g2.mean(dim=d0)
                v_col[k] = decay_t * state.v_col[k] + (1.0 - decay_t) * g2.mean(dim=d1)
                v[k] = state.v[k]
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row[k].mean(dim=reduced_d1, keepdim=True)
                row_factor = (v_row[k] / row_col_mean) ** -0.5
                col_factor = v_col[k] ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / self.CLIP, min=1.0)
            if self.lr is not None:
                u = self.lr * u
            rms = torch.sqrt(torch.mean(p * p))
            u = u * torch.where(rms <= self.MIN_SCALE, self.MIN_SCALE, rms)
            out[k] = -1 * u
        return out, OptState(count=state.count + 1, v_row=v_row, v_col=v_col, v=v)


class LBFGSRule(Rule):
    """``optax.lbfgs``'s place in the union: its update needs the loss's
    value, gradient and ``value_fn``, which no trainer passes, so the JAX
    package's ``update(g, s, p)`` raises ``TypeError``; so does this one."""

    def __init__(self, lr, memory_size):
        self.lr, self.memory_size = float(lr), int(memory_size)

    def init(self, params: Params) -> OptState:
        return OptState(count=_count(params))

    def updates(self, grads, state, params):
        raise TypeError(
            "LBFGS needs the loss's value, grad and value_fn at update (optax.lbfgs); "
            "no trainer passes them, in this package or the JAX one (ROADMAP.md §1 item 3)")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Base class of the union's members."""

    def make_optimizer(self) -> Rule:
        raise NotImplementedError


def _register(cls):
    return OPTIMIZERS.register()(dataclasses.dataclass(frozen=True)(cls))


@_register
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


@_register
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


@_register
class SGD(OptimizerConfig):
    lr: float = 1e-2
    momentum: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False

    def make_optimizer(self) -> SGDRule:
        return SGDRule(self.lr, self.momentum, self.weight_decay, self.nesterov)


@_register
class RMSprop(OptimizerConfig):
    lr: float = 1e-2
    alpha: float = 0.99
    eps: float = 1e-8
    momentum: float = 0.0
    centered: bool = False

    def make_optimizer(self) -> RMSpropRule:
        return RMSpropRule(self.lr, self.alpha, self.eps, self.momentum or None, self.centered)


@_register
class Adagrad(OptimizerConfig):
    lr: float = 1e-2
    eps: float = 1e-10

    def make_optimizer(self) -> AdagradRule:
        return AdagradRule(self.lr, self.eps)


@_register
class Lion(OptimizerConfig):
    lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.99)
    weight_decay: float = 0.0

    def make_optimizer(self) -> LionRule:
        return LionRule(self.lr, self.betas[0], self.betas[1], self.weight_decay)


@_register
class Adadelta(OptimizerConfig):
    lr: float = 1.0
    rho: float = 0.9
    eps: float = 1e-6
    weight_decay: float = 0.0

    def make_optimizer(self) -> AdadeltaRule:
        return AdadeltaRule(self.lr, self.rho, self.eps, self.weight_decay)


@_register
class Adamax(OptimizerConfig):
    """Reference optimizer/uninferrable_optimizers.py:Adamax."""

    lr: float = 2e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0

    def make_optimizer(self) -> AdamaxRule:
        return AdamaxRule(self.lr, self.betas[0], self.betas[1], self.eps, self.weight_decay)


@_register
class NAdam(OptimizerConfig):
    lr: float = 2e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0

    def make_optimizer(self) -> AdamRule:
        return AdamRule(self.lr, self.betas[0], self.betas[1], self.eps,
                        weight_decay=self.weight_decay, nesterov=True)


@_register
class RAdam(OptimizerConfig):
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0

    def make_optimizer(self) -> RAdamRule:
        return RAdamRule(self.lr, self.betas[0], self.betas[1], self.eps, self.weight_decay)


@_register
class Rprop(OptimizerConfig):
    lr: float = 1e-2
    etas: Tuple[float, float] = (0.5, 1.2)
    step_sizes: Tuple[float, float] = (1e-6, 50.0)

    def make_optimizer(self) -> RpropRule:
        return RpropRule(self.lr, self.etas[0], self.etas[1], self.step_sizes[0],
                         self.step_sizes[1])


@_register
class LBFGS(OptimizerConfig):
    """Reference optimizer/uninferrable_optimizers.py:LBFGS; see
    ``LBFGSRule``."""

    lr: float = 1.0
    memory_size: int = 10

    def make_optimizer(self) -> LBFGSRule:
        return LBFGSRule(self.lr, self.memory_size)


@_register
class ASGD(OptimizerConfig):
    """SGD with optional decay and no iterate averaging, as the JAX
    package's (:223-236)."""

    lr: float = 1e-2
    alpha: float = 0.75
    weight_decay: float = 0.0

    def make_optimizer(self) -> SGDRule:
        return SGDRule(self.lr, 0.0, self.weight_decay)


@_register
class SparseAdam(OptimizerConfig):
    """Adam, as the JAX package's (dense gradients)."""

    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8

    def make_optimizer(self) -> AdamRule:
        return AdamRule(self.lr, self.betas[0], self.betas[1], self.eps)


@_register
class Lamb(OptimizerConfig):
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-6
    weight_decay: float = 0.0

    def make_optimizer(self) -> LambRule:
        return LambRule(self.lr, self.betas[0], self.betas[1], self.eps,
                        weight_decay=self.weight_decay)


@_register
class Adafactor(OptimizerConfig):
    lr: Optional[float] = None

    def make_optimizer(self) -> AdafactorRule:
        return AdafactorRule(self.lr)


def make_optimizer(config: Any) -> Rule:
    """Build an update rule from a tagged-union config, an
    ``OptimizerConfig`` instance, or ``None`` (Adam, lr 1e-3).  An
    ``lr_scheduler`` key in the optimizer's kwargs composes a schedule
    (``{"Adam": {"lr": 1e-3, "lr_scheduler": {"StepLR": {"step_size":
    100}}}}``), as the JAX package's ``with_scheduler``."""
    if config is None:
        return Adam().make_optimizer()
    if isinstance(config, OptimizerConfig):
        return config.make_optimizer()
    if isinstance(config, dict) and len(config) == 1:
        name, kwargs = next(iter(config.items()))
        if isinstance(kwargs, dict) and "lr_scheduler" in kwargs:
            from reagent_tpu_torch.optim.scheduler import LR_SCHEDULERS, with_scheduler

            kwargs = dict(kwargs)
            scheduler = LR_SCHEDULERS.build(kwargs.pop("lr_scheduler"))
            return with_scheduler(OPTIMIZERS.build({name: kwargs}).make_optimizer(), scheduler)
    return OPTIMIZERS.build(config).make_optimizer()
