"""Linear-regression UCB models (LinUCB).

Port of ``reagent_tpu/models/linear_regression.py``: ``batch_quadratic_form``
(:25), ``LinUCBState`` (:31) and ``LinearRegressionUCB`` (:41) — running
weighted averages of A = X^T X and b = X^T y, the ridge solve on demand, UCB
= x.coefs + alpha * sqrt(x A^-1 x / sum_weight) — and ``DisjointLinUCBState``
(:115) and ``DisjointLinearRegressionUCB`` (:124), one regression per arm.
The states are tensors on one device and the functions plain torch, in
float32 as JAX's.

The pseudo-inverse keeps JAX's cutoff (``pinv``): ``jnp.linalg.pinv`` zeroes
singular values at or below ``10 * max(m, n) * eps`` times the largest, ten
times ``torch.linalg.pinv``'s default.  LinUCB's unexplored directions have
the singular value ``lambda / sum_weight``, and over a run at D 500 hundreds
of them lie between the two cutoffs: JAX gives them 0 in ``inv_avg_A`` and a
default ``torch.linalg.pinv`` would give them ``sum_weight / lambda``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core.types import _TensorDataClass
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def pinv(A: Tensor) -> Tensor:
    """``jnp.linalg.pinv(A)``: the (batched) pseudo-inverse with JAX's
    default cutoff, ``10 * max(m, n) * eps`` of the largest singular value."""
    m, n = A.shape[-2:]
    return torch.linalg.pinv(A, rtol=10.0 * max(m, n) * torch.finfo(A.dtype).eps)


def batch_quadratic_form(x: Tensor, A: Tensor) -> Tensor:
    """Row-wise x^T A x (reference linear_regression.py:41)."""
    return torch.einsum("bi,ij,bj->b", x, A, x)


@dataclasses.dataclass
class LinUCBState(_TensorDataClass):
    avg_A: Tensor  # [D, D] weighted average of x x^T
    avg_b: Tensor  # [D]
    sum_weight: Tensor  # scalar
    num_obs: Tensor  # int32 scalar
    coefs: Tensor  # [D]
    inv_avg_A: Tensor  # [D, D]


class LinearRegressionUCB:
    """Joint LinUCB: one regression over (context, arm) features."""

    def __init__(self, input_dim: int, l2_reg_lambda: float = 1.0, ucb_alpha: float = 1.0,
                 gamma: float = 1.0):
        assert 0.0 < gamma <= 1.0
        self.input_dim = input_dim
        self.l2_reg_lambda = l2_reg_lambda
        self.ucb_alpha = ucb_alpha
        self.gamma = gamma

    def init(self, device="cuda") -> LinUCBState:
        D = self.input_dim
        device = resolve_device(device)
        return LinUCBState(
            avg_A=torch.zeros((D, D), device=device),
            avg_b=torch.zeros(D, device=device),
            sum_weight=torch.tensor(1e-5, device=device),
            num_obs=torch.zeros((), dtype=torch.int32, device=device),
            coefs=torch.zeros(D, device=device),
            inv_avg_A=torch.zeros((D, D), device=device),
        )

    def update(self, state: LinUCBState, x: Tensor, y: Tensor,
               weight: Optional[Tensor] = None) -> LinUCBState:
        """Fold a batch into the weighted averages (ref linucb_trainer.py:51-77)."""
        y = y.reshape(-1, 1)
        weight = torch.ones_like(y) if weight is None else weight
        weight = weight.reshape(-1, 1).to(torch.float32)
        new_sum_weight = state.sum_weight + weight.sum()
        frac_old = state.sum_weight / new_sum_weight
        avg_A = state.avg_A * frac_old + (x.T @ (x * weight)) / new_sum_weight
        avg_b = state.avg_b * frac_old + (x.T @ (y * weight)).reshape(-1) / new_sum_weight
        return state.replace(avg_A=avg_A, avg_b=avg_b, sum_weight=new_sum_weight,
                             num_obs=state.num_obs + y.shape[0])

    def calculate_coefs(self, state: LinUCBState) -> LinUCBState:
        """Solve the ridge regression (ref linear_regression.py:157-199)."""
        eye = torch.eye(self.input_dim, device=state.avg_A.device)
        inv_A = pinv(state.avg_A + self.l2_reg_lambda * eye / state.sum_weight)
        return state.replace(coefs=inv_A @ state.avg_b, inv_avg_A=inv_A)

    def apply_discounting(self, state: LinUCBState) -> LinUCBState:
        """gamma-discount the effective sample size (ref linucb_trainer.py:89)."""
        return state.replace(sum_weight=state.sum_weight * self.gamma)

    def forward(self, state: LinUCBState, x: Tensor,
                ucb_alpha: Optional[float] = None) -> Dict[str, Tensor]:
        """Assumes ``calculate_coefs`` was called after the last update."""
        alpha = self.ucb_alpha if ucb_alpha is None else ucb_alpha
        pred_label = x @ state.coefs
        pred_sigma = torch.sqrt(torch.clamp(
            batch_quadratic_form(x, state.inv_avg_A) / state.sum_weight, min=0.0))
        return {"pred_label": pred_label, "pred_sigma": pred_sigma,
                "ucb": pred_label + alpha * pred_sigma}


@dataclasses.dataclass
class DisjointLinUCBState(_TensorDataClass):
    A: Tensor  # [num_arms, D, D]
    b: Tensor  # [num_arms, D]
    inv_A: Tensor  # [num_arms, D, D]
    coefs: Tensor  # [num_arms, D]
    num_obs: Tensor  # int32 scalar


class DisjointLinearRegressionUCB:
    """One independent ridge regression per arm (reference
    disjoint_linucb_predictor.py)."""

    def __init__(self, num_arms: int, input_dim: int, l2_reg_lambda: float = 1.0,
                 ucb_alpha: float = 1.0):
        self.num_arms = num_arms
        self.input_dim = input_dim
        self.l2_reg_lambda = l2_reg_lambda
        self.ucb_alpha = ucb_alpha

    def init(self, device="cuda") -> DisjointLinUCBState:
        D, K = self.input_dim, self.num_arms
        device = resolve_device(device)
        eye = torch.eye(D, device=device)
        return DisjointLinUCBState(
            A=(self.l2_reg_lambda * eye).expand(K, D, D).clone(),
            b=torch.zeros((K, D), device=device),
            inv_A=(eye / self.l2_reg_lambda).expand(K, D, D).clone(),
            coefs=torch.zeros((K, D), device=device),
            num_obs=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(self, state: DisjointLinUCBState, arm: Tensor, x: Tensor,
               y: Tensor) -> DisjointLinUCBState:
        """Per-arm updates through a one-hot product (arm [B], x [B, D], y
        [B]), as JAX's einsum: each arm's rows are summed in one fixed
        order, which the card's ``index_add_`` does not keep."""
        onehot = F.one_hot(arm.reshape(-1).to(torch.int64), self.num_arms).to(x.dtype)
        dA = torch.einsum("bk,bi,bj->kij", onehot, x, x)
        db = torch.einsum("bk,bi,b->ki", onehot, x, y.reshape(-1))
        return state.replace(A=state.A + dA, b=state.b + db,
                             num_obs=state.num_obs + x.shape[0])

    def calculate_coefs(self, state: DisjointLinUCBState) -> DisjointLinUCBState:
        inv_A = pinv(state.A)
        return state.replace(inv_A=inv_A, coefs=torch.einsum("kij,kj->ki", inv_A, state.b))

    def forward(self, state: DisjointLinUCBState, x: Tensor,
                ucb_alpha: Optional[float] = None) -> Dict[str, Tensor]:
        """x [B, D] -> scores for every arm [B, K]."""
        alpha = self.ucb_alpha if ucb_alpha is None else ucb_alpha
        pred = torch.einsum("bd,kd->bk", x, state.coefs)
        sigma = torch.sqrt(torch.clamp(
            torch.einsum("bi,kij,bj->bk", x, state.inv_A, x), min=0.0))
        return {"pred_label": pred, "pred_sigma": sigma, "ucb": pred + alpha * sigma}
