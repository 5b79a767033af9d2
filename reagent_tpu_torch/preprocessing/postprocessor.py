"""Postprocessor: invert action normalization for serving.

Port of ``reagent_tpu/preprocessing/postprocessor.py:26`` (reference:
reagent/preprocessing/postprocessor.py:19-90): maps the actor's [-1, 1]
training-range actions back to the environment's serving range for
CONTINUOUS_ACTION features; the identity for DISCRETE_ACTION and
DO_NOT_PREPROCESS.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from reagent_tpu_torch.core.parameters import NormalizationParameters
from reagent_tpu_torch.preprocessing.identify_types import (
    CONTINUOUS_ACTION,
    DISCRETE_ACTION,
    DO_NOT_PREPROCESS,
)
from reagent_tpu_torch.preprocessing.normalization import EPS, get_num_output_features


class Postprocessor(nn.Module):
    def __init__(
        self, normalization_parameters: Dict[int, NormalizationParameters], device="cpu"
    ) -> None:
        super().__init__()
        self.normalization_parameters = normalization_parameters
        self.num_output_features = get_num_output_features(normalization_parameters)
        feature_types = {p.feature_type for p in normalization_parameters.values()}
        if len(feature_types) != 1:
            raise ValueError("All dimensions of actions should have the same preprocessing")
        self.feature_type = next(iter(feature_types))
        if self.feature_type not in {DISCRETE_ACTION, CONTINUOUS_ACTION, DO_NOT_PREPROCESS}:
            raise ValueError(f"{self.feature_type} is not an action type")
        if self.feature_type == CONTINUOUS_ACTION:
            params = [normalization_parameters[f] for f in sorted(normalization_parameters)]
            self.register_buffer("min_serving_value", torch.as_tensor(
                np.array([p.min_value for p in params]), dtype=torch.float32))
            self.register_buffer("scaling_factor", torch.as_tensor(
                np.array([(p.max_value - p.min_value) / (2 * (1 - EPS)) for p in params]),
                dtype=torch.float32))
        self.almost_one = 1.0 - EPS
        self.to(device)

    @torch.no_grad()
    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if self.feature_type == CONTINUOUS_ACTION:
            return (
                self.almost_one + torch.clamp(input, -self.almost_one, self.almost_one)
            ) * self.scaling_factor + self.min_serving_value
        return input
