"""World-model debug evaluators: the losses, feature importance and action
sensitivity.

Port of ``reagent_tpu/evaluation/world_model_evaluator.py``
(``_median_feature_value`` :26, ``LossEvaluator`` :36,
``FeatureImportanceEvaluator`` :48, ``FeatureSensitivityEvaluator`` :110;
reference reagent/evaluation/world_model_evaluator.py:16-246).  Each takes
the trainer's net parameters explicitly.  A feature's neutral value is the
mode of a one-hot block and the median of anything else, the median of an
even count being ``(lo + hi) * 0.5`` of its two middle values, as
``jnp.median`` computes it (torch's ``median`` returns the lower one).  ``FeatureSensitivityEvaluator`` takes
the permutation of the batch's actions as a value (``perm``), or draws it
from its generator, where JAX splits a key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.world_model.mdnrnn_trainer import MDNRNNTrainer

Tensor = torch.Tensor


def median_feature_value(features: Tensor) -> Tensor:
    """A one-hot block's mode (its first most frequent column), or each
    column's median, as a [1, width] row (ref compute_median_feature_value
    :159-174)."""
    if features.shape[1] > 1 and bool(((features == 0) | (features == 1)).all()):
        mode = torch.zeros_like(features[0])
        mode[torch.argmax(torch.sum(features, dim=0))] = 1.0
        return mode[None, :]
    ordered = torch.sort(features, dim=0).values
    n = ordered.shape[0]
    return ((ordered[(n - 1) // 2] + ordered[n // 2]) * 0.5)[None, :]


class LossEvaluator:
    """Reference :16-34."""

    def __init__(self, trainer: MDNRNNTrainer, state_dim: int) -> None:
        self.trainer = trainer
        self.state_dim = state_dim

    @torch.no_grad()
    def evaluate(self, net_params, batch: rlt.MemoryNetworkInput) -> Dict[str, float]:
        losses = self.trainer.get_loss(net_params, batch)
        return {k: float(v) for k, v in losses.items()}


class FeatureImportanceEvaluator:
    """The loss's increase from neutralizing each feature (ref :37-174)."""

    def __init__(
        self,
        trainer: MDNRNNTrainer,
        discrete_action: bool,
        state_feature_num: int,
        action_feature_num: int,
        sorted_action_feature_start_indices: List[int],
        sorted_state_feature_start_indices: List[int],
    ) -> None:
        self.trainer = trainer
        self.discrete_action = discrete_action
        self.state_feature_num = state_feature_num
        self.action_feature_num = action_feature_num
        self.action_starts = sorted_action_feature_start_indices
        self.state_starts = sorted_state_feature_start_indices

    def _loss(self, net_params, batch) -> float:
        return float(self.trainer.get_loss(net_params, batch)["loss"])

    @torch.no_grad()
    def evaluate(self, net_params, batch: rlt.MemoryNetworkInput) -> Dict[str, np.ndarray]:
        T, B, state_dim = batch.state.float_features.shape
        action_dim = batch.action.float_features.shape[2]
        orig_loss = self._loss(net_params, batch)
        importance = np.zeros(self.action_feature_num + self.state_feature_num)
        action_bounds = list(self.action_starts) + [action_dim]
        state_bounds = list(self.state_starts) + [state_dim]

        for i in range(self.action_feature_num):
            flat = batch.action.float_features.reshape(T * B, action_dim).clone()
            if self.discrete_action:
                if action_dim != self.action_feature_num:
                    raise ValueError(f"{self.action_feature_num} discrete actions, "
                                     f"action_dim {action_dim}")
                flat.zero_()
                flat[:, i] = 1.0
            else:
                lo, hi = action_bounds[i], action_bounds[i + 1]
                flat[:, lo:hi] = median_feature_value(flat[:, lo:hi])
            new_batch = dataclasses.replace(batch, action=rlt.FeatureData(
                float_features=flat.reshape(T, B, action_dim)))
            importance[i] = self._loss(net_params, new_batch) - orig_loss

        for i in range(self.state_feature_num):
            flat = batch.state.float_features.reshape(T * B, state_dim).clone()
            lo, hi = state_bounds[i], state_bounds[i + 1]
            flat[:, lo:hi] = median_feature_value(flat[:, lo:hi])
            new_batch = dataclasses.replace(batch, state=rlt.FeatureData(
                float_features=flat.reshape(T, B, state_dim)))
            importance[self.action_feature_num + i] = (
                self._loss(net_params, new_batch) - orig_loss)
        return {"feature_loss_increase": importance}


class FeatureSensitivityEvaluator:
    """The mean |change| of the predicted next-state means, feature by
    feature, when the batch's actions are shuffled across rows (ref
    :176-246)."""

    def __init__(
        self,
        trainer: MDNRNNTrainer,
        state_feature_num: int,
        sorted_state_feature_start_indices: List[int],
        generator: Optional[torch.Generator] = None,
    ) -> None:
        self.trainer = trainer
        self.state_feature_num = state_feature_num
        self.state_starts = sorted_state_feature_start_indices
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)

    @torch.no_grad()
    def evaluate(self, net_params, batch: rlt.MemoryNetworkInput,
                 perm: Optional[Tensor] = None) -> Dict[str, np.ndarray]:
        """``perm`` [B] shuffles the rows' actions; else drawn from the
        evaluator's generator."""
        T, B, state_dim = batch.next_state.float_features.shape
        net = self.trainer.memory_network
        out = functional.apply(net, net_params, batch.state, batch.action)
        if perm is None:
            perm = torch.randperm(B, generator=self.generator, device=self.generator.device)
        perm = perm.to(batch.action.float_features.device, torch.int64)
        shuffled = functional.apply(net, net_params, batch.state, rlt.FeatureData(
            float_features=batch.action.float_features[:, perm, :]))
        bounds = list(self.state_starts) + [state_dim]
        sensitivity = np.zeros(self.state_feature_num)
        for i in range(self.state_feature_num):
            lo, hi = bounds[i], bounds[i + 1]
            sensitivity[i] = float(torch.mean(torch.sum(
                torch.abs(shuffled.mus[..., lo:hi] - out.mus[..., lo:hi]), dim=3)))
        return {"feature_sensitivity": sensitivity}
