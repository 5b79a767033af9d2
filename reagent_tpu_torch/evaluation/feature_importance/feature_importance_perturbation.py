"""Permutation feature importance.

Port of ``reagent_tpu/evaluation/feature_importance/
feature_importance_perturbation.py`` (reference
reagent/evaluation/feature_importance/feature_importance_base.py:12-18 and
feature_importance_perturbation.py:21-77): for each feature, shuffle that
column across the batch and measure the mean |change of the prediction|.

JAX draws each shuffle from a key split off one running key.  Here
``compute_feature_importance`` hands ``perturb_fn`` a function ``draw(n)``
that returns the next permutation of ``n`` rows: the next of ``perms``
where given (JAX's permutations, in the order of the calls), else
``torch.randperm`` from ``generator``.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import pandas as pd
import torch

logger = logging.getLogger(__name__)
Tensor = torch.Tensor


@dataclasses.dataclass
class FeatureImportanceBase:
    model: Any
    sorted_feature_ids: List[int]

    def compute_feature_importance(self) -> pd.DataFrame:
        raise NotImplementedError


@dataclasses.dataclass
class FeatureImportancePerturbation(FeatureImportanceBase):
    data_loader: Any = None
    # (model, data) -> [batch, 1] predictions
    pred_fn: Callable[[Any, Any], Tensor] = None
    # (data, feature_idx, draw) -> perturbed data; draw(n) -> a permutation of n
    perturb_fn: Callable[[Any, int, Callable[[int], Tensor]], Any] = None
    repeat: int = 1
    generator: Optional[torch.Generator] = None
    perms: Optional[Sequence[Tensor]] = None

    def compute_feature_importance(self) -> pd.DataFrame:
        given = iter(self.perms) if self.perms is not None else None
        generator = (self.generator if self.generator is not None
                     else torch.Generator().manual_seed(0))

        def draw(n: int) -> Tensor:
            if given is not None:
                return torch.as_tensor(np.array(next(given)), dtype=torch.int64)
            return torch.randperm(n, generator=generator, device=generator.device)

        vals = defaultdict(list)
        for batch_idx, data in enumerate(self.data_loader):
            for r in range(self.repeat):
                pred = self.pred_fn(self.model, data)
                for feature_idx, feature_id in enumerate(self.sorted_feature_ids):
                    perturbed = self.perturb_fn(_copy_data(data), feature_idx, draw)
                    perturbed_pred = self.pred_fn(self.model, perturbed)
                    vals[feature_id].append(float(torch.mean(torch.abs(perturbed_pred - pred))))
                logger.info("Processed %d batches %d-th time", batch_idx, r)
        means = {k: float(np.mean(v)) for k, v in vals.items()}
        df = pd.DataFrame.from_dict(
            means, orient="index", columns=["feature_importance"]
        ).sort_values(by=["feature_importance"], ascending=False)
        df.insert(0, "feature_id", df.index)
        return df


def _copy_data(data):
    """A copy of the dict and tuple structure; the tensors are not written
    (``perturb_fn`` builds new ones)."""
    if isinstance(data, dict):
        return {k: _copy_data(v) for k, v in data.items()}
    if isinstance(data, tuple):
        return tuple(_copy_data(v) for v in data)
    return data


def create_default_perturb_fn(key: str):
    """Shuffle one (value, presence) column across the batch (ref :65-77)."""

    def default_perturb_fn(data, feature_idx: int, draw: Callable[[int], Tensor]):
        values, presence = (torch.as_tensor(x) for x in data[key])
        perm = draw(values.shape[0]).to(values.device)
        values, presence = values.clone(), presence.clone()
        values[:, feature_idx] = values[perm, feature_idx]
        presence[:, feature_idx] = presence[perm, feature_idx]
        data[key] = (values, presence)
        return data

    return default_perturb_fn
