"""DeepRepresent LinUCB: a trainable MLP feature extractor under a LinUCB head.

Port of ``reagent_tpu/models/deep_represent_linucb.py`` (reference
reagent/models/deep_represent_linucb.py:16-180): the MLP's bottom layers are
trained by gradient descent through a linear head that predicts mu, and the
LinUCB statistics over the MLP's embedding (``LinUCBState``) give the
uncertainty.  ``_DeepRepresentMLP`` (:34) is the ``FullyConnectedNetwork``
trunk at ``trunk`` (flax's ``FullyConnectedNetwork_0``), the normalisation
``h / max(|h|, 1e-6)``, a column of ones in front, and the bias-free mu head
at ``head`` (flax's ``Dense_0``).  The MLP's parameters live in the trainer
state as a ``{name: tensor}`` dict, as the JAX trainer keeps its flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from reagent_tpu_torch.core.types import _TensorDataClass
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
from reagent_tpu_torch.models.linear_regression import (
    LinearRegressionUCB,
    LinUCBState,
    batch_quadratic_form,
)
from reagent_tpu_torch.models.mdn_rnn import _lecun_normal_fill
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class _DeepRepresentMLP(nn.Module):
    """Bottom layers + linear mu head (ref deep_represent_linucb.py:100-112)."""

    def __init__(self, input_dim: int, sizes: List[int], activations: List[str],
                 normalize_output: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize_output = normalize_output
        self.trunk = FullyConnectedNetwork([input_dim, *sizes], list(activations))
        self.head = nn.Linear(sizes[-1] + 1, 1, bias=False)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The trunk's gaussian fill and flax's lecun-normal head."""
        self.trunk.reset_parameters(generator)
        _lecun_normal_fill(self.head.weight.T, generator)

    def head_of(self, h: Tensor) -> Dict[str, Tensor]:
        """The trunk's output -> ``{mlp_out_with_ones, pred_label}``."""
        if self.normalize_output:
            h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-6)
        ones = torch.ones((*h.shape[:-1], 1), dtype=h.dtype, device=h.device)
        emb = torch.cat([ones, h], dim=-1)
        return {"mlp_out_with_ones": emb, "pred_label": self.head(emb).squeeze(-1)}

    def forward(self, x: Tensor) -> Dict[str, Tensor]:
        return self.head_of(self.trunk(x))


@dataclasses.dataclass
class DeepRepresentLinUCBState(_TensorDataClass):
    mlp_params: Dict[str, Tensor]
    opt_state: Any
    linucb: LinUCBState


class DeepRepresentLinearRegressionUCB(LinearRegressionUCB):
    """UCB = nn-predicted mu + alpha * LinUCB sigma over the MLP embedding."""

    def __init__(
        self,
        input_dim: int,
        sizes: List[int],
        activations: List[str],
        *,
        l2_reg_lambda: float = 1.0,
        ucb_alpha: float = 1.0,
        gamma: float = 1.0,
        normalize_output: bool = True,
    ):
        # LinUCB works on the MLP output (+1 for the intercept column)
        super().__init__(input_dim=sizes[-1] + 1, l2_reg_lambda=l2_reg_lambda,
                         ucb_alpha=ucb_alpha, gamma=gamma)
        assert input_dim > 0 and sizes[-1] > 0
        assert len(sizes) == len(activations)
        self.raw_input_dim = input_dim
        self.mlp = _DeepRepresentMLP(input_dim, sizes, activations, normalize_output)

    def init_deep(self, generator: torch.Generator, device="cuda") -> Dict[str, Tensor]:
        """Fresh MLP parameters drawn from ``generator``, by name."""
        self.mlp.reset_parameters(generator)
        device = resolve_device(device)
        return {k: p.detach().clone().to(device) for k, p in self.mlp.named_parameters()}

    def forward_deep(self, mlp_params: Dict[str, Tensor], linucb_state: LinUCBState, x: Tensor,
                     ucb_alpha: Optional[float] = None) -> Dict[str, Tensor]:
        """Raw features -> {pred_label, pred_sigma, ucb, mlp_out_with_ones}."""
        alpha = self.ucb_alpha if ucb_alpha is None else ucb_alpha
        out = torch.func.functional_call(self.mlp, mlp_params, (x,))
        return self.ucb_of(out, linucb_state, alpha)

    def ucb_of(self, out: Dict[str, Tensor], linucb_state: LinUCBState,
               alpha: float) -> Dict[str, Tensor]:
        """The MLP's ``{mlp_out_with_ones, pred_label}`` -> the UCB dict."""
        emb, pred_label = out["mlp_out_with_ones"], out["pred_label"]
        pred_sigma = torch.sqrt(torch.clamp(
            batch_quadratic_form(emb, linucb_state.inv_avg_A)
            / torch.clamp(linucb_state.sum_weight, min=1e-5), min=0.0))
        return {"pred_label": pred_label, "pred_sigma": pred_sigma,
                "ucb": pred_label + alpha * pred_sigma, "mlp_out_with_ones": emb}
