"""Feature-identification flow.

Port of ``reagent_tpu/workflow/identify_types_flow.py`` (reference:
reagent/workflow/identify_types_flow.py:24-80) — normalization_helper +
identify_normalization_parameters over a logged table (Spark there, pandas
columns here).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import pandas as pd

from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationParameters
from reagent_tpu_torch.data.data_module import TableSpec
from reagent_tpu_torch.preprocessing.normalization import (
    DEFAULT_MAX_QUANTILE_SIZE,
    DEFAULT_NUM_SAMPLES,
    DEFAULT_QUANTILE_K2_THRESHOLD,
    get_feature_norm_metadata,
)
from reagent_tpu_torch.preprocessing.identify_types import DEFAULT_MAX_UNIQUE_ENUM


def normalization_helper(
    max_unique_enum_values: int = DEFAULT_MAX_UNIQUE_ENUM,
    quantile_size: int = DEFAULT_MAX_QUANTILE_SIZE,
    quantile_k2_threshold: float = DEFAULT_QUANTILE_K2_THRESHOLD,
    skip_box_cox: bool = False,
    skip_quantiles: bool = True,
    feature_overrides: Optional[Dict[int, str]] = None,
    allowedlist_features: Optional[List[int]] = None,
):
    """Returns a fn mapping {feature_id: [values]} -> normalization params.

    Reference: identify_types_flow.py:24-56.
    """
    norm_params = {
        "max_unique_enum_values": max_unique_enum_values,
        "quantile_size": quantile_size,
        "quantile_k2_threshold": quantile_k2_threshold,
        "skip_box_cox": skip_box_cox,
        "skip_quantiles": skip_quantiles,
        "feature_overrides": feature_overrides,
    }
    allowed = set(allowedlist_features or [])

    def process(rows: Dict[int, List[float]]) -> Dict[int, NormalizationParameters]:
        out = {}
        for fid, values in rows.items():
            if allowed and int(fid) not in allowed:
                continue
            p = get_feature_norm_metadata(str(fid), values, norm_params)
            if p is not None:
                out[int(fid)] = p
        return out

    return process


def identify_normalization_parameters(
    table_spec: TableSpec,
    column_name: str,
    preprocessing_options: Optional[dict] = None,
    seed: Optional[int] = None,
) -> NormalizationData:
    """Sample the table column of feature maps, fit normalization per feature.

    Reference: identify_types_flow.py:58-80 (Spark sampling there).
    """
    opts = preprocessing_options or {}
    df = (
        pd.read_pickle(table_spec.path)
        if table_spec.path and table_spec.path.endswith((".pkl", ".pickle"))
        else pd.read_parquet(table_spec.path)
    )
    num_samples = opts.get("num_samples", DEFAULT_NUM_SAMPLES)
    if len(df) > num_samples:
        df = df.sample(n=num_samples, random_state=seed or 0)
    by_feature: Dict[int, List[float]] = {}
    for d in df[column_name]:
        if not d:
            continue
        for fid, v in d.items():
            if v is not None:
                by_feature.setdefault(int(fid), []).append(float(v))
    helper = normalization_helper(
        max_unique_enum_values=opts.get("max_unique_enum_values", DEFAULT_MAX_UNIQUE_ENUM),
        quantile_size=opts.get("quantile_size", DEFAULT_MAX_QUANTILE_SIZE),
        quantile_k2_threshold=opts.get("quantile_k2_threshold", DEFAULT_QUANTILE_K2_THRESHOLD),
        skip_box_cox=opts.get("skip_box_cox", False),
        skip_quantiles=opts.get("skip_quantiles", True),
        feature_overrides=opts.get("feature_overrides"),
        allowedlist_features=opts.get("allowedlist_features"),
    )
    return NormalizationData(dense_normalization_parameters=helper(by_feature))
