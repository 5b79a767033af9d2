"""Shared net-builder helpers (port of ``reagent_tpu/net_builder/base.py``)."""

from __future__ import annotations

from typing import Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.preprocessing.normalization import get_num_output_features


def state_dim_of(
    normalization_data: Optional[NormalizationData], fallback: Optional[int] = None
) -> int:
    """The width normalization data gives, else ``fallback``."""
    if normalization_data is not None and normalization_data.dense_normalization_parameters:
        return get_num_output_features(normalization_data.dense_normalization_parameters)
    if fallback is None:
        raise ValueError("need normalization data or an explicit dim")
    return fallback
