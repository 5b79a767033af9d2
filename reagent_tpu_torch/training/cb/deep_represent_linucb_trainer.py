"""DeepRepresent LinUCB trainer: gradient steps on the MLP, the closed-form
LinUCB update on its embedding.

Port of ``reagent_tpu/training/cb/deep_represent_linucb_trainer.py``
(reference reagent/training/cb/deep_represent_linucb_trainer.py:18-110):
each step (1) the weighted MSE between the mu head and the observed reward
steps the MLP (Adam, or AdamW where ``weight_decay`` is set, as
``optax.adam`` / ``optax.adamw``), (2) the detached embedding updates the
LinUCB statistics, (3) the coefficients are solved again.

``score`` runs the MLP's trunk as one K3 launch on a CUDA tensor through
``training/functional.py::score`` (a trunk with an activation K3 lacks runs
its own forward); the normalisation, the ones column, the mu head and the
sigma follow in torch.  JAX applies the flax module in XLA: no Pallas
kernel is on its path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from reagent_tpu_torch.core.types import CBInput
from reagent_tpu_torch.models.deep_represent_linucb import (
    DeepRepresentLinearRegressionUCB,
    DeepRepresentLinUCBState,
)
from reagent_tpu_torch.optim import Adam, AdamW
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.cb.utils import chosen_arm_features
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
_TRUNK = "trunk."


class DeepRepresentLinUCBTrainer:
    def __init__(self, scorer: DeepRepresentLinearRegressionUCB, lr: float = 1e-3,
                 weight_decay: float = 0.0, device="cuda"):
        assert isinstance(scorer, DeepRepresentLinearRegressionUCB)
        self.device = resolve_device(device)
        self.scorer = scorer
        self.scorer.mlp.to(self.device)
        self.optimizer = (AdamW(lr=lr, weight_decay=weight_decay) if weight_decay
                          else Adam(lr=lr)).make_optimizer()

    def init(self, generator: torch.Generator) -> DeepRepresentLinUCBState:
        mlp_params = self.scorer.init_deep(generator, self.device)
        return DeepRepresentLinUCBState(
            mlp_params=mlp_params, opt_state=self.optimizer.init(mlp_params),
            linucb=self.scorer.init(self.device))

    def train_step(self, state: DeepRepresentLinUCBState, batch: CBInput
                   ) -> Tuple[DeepRepresentLinUCBState, Dict[str, Tensor]]:
        assert batch.action is not None and batch.reward is not None
        x = chosen_arm_features(batch)
        y = batch.reward.reshape(-1)
        weight = batch.weight.reshape(-1) if batch.weight is not None else torch.ones_like(y)

        def loss_fn(mlp_params):
            out = functional.apply(self.scorer.mlp, mlp_params, x)
            return (torch.mean(weight * (out["pred_label"] - y) ** 2),
                    out["mlp_out_with_ones"].detach())

        loss, grads, emb = functional.value_and_grad(loss_fn, state.mlp_params, has_aux=True)
        mlp_params, opt_state = self.optimizer.update(grads, state.opt_state, state.mlp_params)
        # the LinUCB statistics on the embedding; the coefficients re-solved
        # every step ("automatically re-computed at every step")
        linucb = self.scorer.calculate_coefs(self.scorer.update(state.linucb, emb, y, weight))
        return (DeepRepresentLinUCBState(mlp_params=mlp_params, opt_state=opt_state,
                                         linucb=linucb),
                {"mse_loss": loss, "num_obs": linucb.num_obs})

    def score(self, state: DeepRepresentLinUCBState, batch: CBInput,
              ucb_alpha: Optional[float] = None) -> Tensor:
        """UCB per arm: [B, num_arms]; the trunk one K3 launch on the card."""
        B, K, D = batch.context_arm_features.shape
        mlp = self.scorer.mlp
        trunk = {k[len(_TRUNK):]: v for k, v in state.mlp_params.items() if k.startswith(_TRUNK)}
        with torch.no_grad():
            h = functional.score(mlp.trunk, trunk, batch.context_arm_features.reshape(B * K, D))
            out = functional.apply_method(mlp, state.mlp_params, "head_of", h)
            alpha = self.scorer.ucb_alpha if ucb_alpha is None else ucb_alpha
            return self.scorer.ucb_of(out, state.linucb, alpha)["ucb"].reshape(B, K)
