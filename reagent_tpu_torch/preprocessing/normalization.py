"""Normalization-parameter fitting (host-side; scipy) + helpers.

The port's numpy/scipy copy of ``reagent_tpu/preprocessing/normalization.py``:
the same inputs give identical ``NormalizationParameters``.

Reference: reagent/preprocessing/normalization.py:45 ``identify_parameter``.
The identification math (K^2 normality test choosing boxcox vs quantile vs
plain standardization) is reproduced so normalization specs are interchangeable
with the reference's; the on-device application lives in ``preprocessor.py``.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import stats
from scipy.stats.mstats import mquantiles

from reagent_tpu_torch.core.parameters import NormalizationParameters
from reagent_tpu_torch.preprocessing import identify_types
from reagent_tpu_torch.preprocessing.identify_types import DEFAULT_MAX_UNIQUE_ENUM, FEATURE_TYPES

logger = logging.getLogger(__name__)

BOX_COX_MAX_STDDEV = 1e8
BOX_COX_MARGIN = 1e-4
MISSING_VALUE = -1337.1337
DEFAULT_QUANTILE_K2_THRESHOLD = 1000.0
MINIMUM_SAMPLES_TO_IDENTIFY = 20
DEFAULT_MAX_QUANTILE_SIZE = 20
DEFAULT_NUM_SAMPLES = 100000
# Range achieved by the probability transform at clamped limits (1e-5, 1-1e-5).
MAX_FEATURE_VALUE = 11.513
MIN_FEATURE_VALUE = -MAX_FEATURE_VALUE
EPS = 1e-6


def no_op_feature() -> NormalizationParameters:
    return NormalizationParameters(
        feature_type=identify_types.CONTINUOUS, mean=0.0, stddev=1.0
    )


def identify_parameter(
    feature_name,
    values: np.ndarray,
    max_unique_enum_values: int = DEFAULT_MAX_UNIQUE_ENUM,
    quantile_size: int = DEFAULT_MAX_QUANTILE_SIZE,
    quantile_k2_threshold: float = DEFAULT_QUANTILE_K2_THRESHOLD,
    skip_box_cox: bool = False,
    skip_quantiles: bool = False,
    feature_type: Optional[str] = None,
) -> Optional[NormalizationParameters]:
    """Fit one feature's normalization spec from a sample of its values.

    Decision cascade (reference normalization.py:45-173):
      1. identify raw type (binary/probability/enum/continuous) unless forced;
      2. for continuous, try boxcox — accept when lambda is far from 1, the
         K^2 normality statistic improves 10x, and stddev is sane;
      3. otherwise if still significantly non-normal (K^2 > threshold), fall
         back to quantile bucketing;
      4. otherwise standardize (mean/stddev with ddof=1, stddev floored at 1).
    """
    values = np.asarray(values, dtype=np.float64)
    force_boxcox = feature_type == identify_types.BOXCOX
    force_continuous = feature_type == identify_types.CONTINUOUS
    force_quantile = feature_type == identify_types.QUANTILE
    if feature_type is None:
        feature_type = identify_types.identify_type(values, max_unique_enum_values)

    boxcox_lambda: Optional[float] = None
    boxcox_shift = 0.0
    mean = 0.0
    stddev = 1.0
    possible_values = None
    quantiles = None
    assert feature_type in FEATURE_TYPES, f"unknown type {feature_type}"
    assert len(values) >= MINIMUM_SAMPLES_TO_IDENTIFY, (
        "insufficient information to identify parameter"
    )

    min_value = float(np.min(values))
    max_value = float(np.max(values))

    if feature_type == identify_types.DO_NOT_PREPROCESS:
        mean = float(np.mean(values))
        values = values - mean
        stddev = max(float(np.std(values, ddof=1)), 1.0)

    if feature_type == identify_types.CONTINUOUS or force_boxcox or force_quantile:
        if max_value - min_value < BOX_COX_MARGIN and not (force_boxcox or force_quantile):
            return no_op_feature()
        k2_original, p_original = stats.normaltest(values)
        boxcox_shift = float(-min_value)
        candidate_values, lambda_ = stats.boxcox(
            np.maximum(values + boxcox_shift, BOX_COX_MARGIN)
        )
        k2_boxcox, p_boxcox = stats.normaltest(candidate_values)
        logger.debug(
            "Feature stats. Original K2: %s P: %s Boxcox K2: %s P: %s",
            k2_original, p_original, k2_boxcox, p_boxcox,
        )
        if (lambda_ < 0.9 or lambda_ > 1.1 or force_boxcox) and not (
            force_continuous or force_quantile
        ):
            if (k2_original > k2_boxcox * 10 and k2_boxcox <= quantile_k2_threshold) or force_boxcox:
                stddev = float(np.std(candidate_values, ddof=1))
                if (
                    np.isfinite(stddev)
                    and stddev < BOX_COX_MAX_STDDEV
                    and not np.isclose(stddev, 0)
                ) or force_boxcox:
                    values = candidate_values
                    boxcox_lambda = float(lambda_)
        if boxcox_lambda is None or skip_box_cox:
            boxcox_shift = None
            boxcox_lambda = None
        if boxcox_lambda is not None:
            feature_type = identify_types.BOXCOX
        if (
            boxcox_lambda is None
            and k2_original > quantile_k2_threshold
            and (not skip_quantiles)
            and not force_continuous
        ) or force_quantile:
            feature_type = identify_types.QUANTILE
            quantiles = tuple(
                float(q)
                for q in np.unique(
                    mquantiles(
                        values,
                        np.arange(quantile_size + 1, dtype=np.float64) / float(quantile_size),
                        alphap=0.0,
                        betap=1.0,
                    )
                )
            )
            logger.debug("Feature is non-normal, using quantiles: %s", quantiles)

    if feature_type in (
        identify_types.CONTINUOUS,
        identify_types.BOXCOX,
        identify_types.CONTINUOUS_ACTION,
    ):
        mean = float(np.mean(values))
        values = values - mean
        stddev = max(float(np.std(values, ddof=1)), 1.0)
        if not np.isfinite(stddev):
            logger.info("Std. dev not finite for feature %s", feature_name)
            return None
        values = values / stddev

    if feature_type == identify_types.ENUM:
        possible_values = tuple(int(v) for v in np.unique(values.astype(int)))

    return NormalizationParameters(
        feature_type=feature_type,
        boxcox_lambda=boxcox_lambda,
        boxcox_shift=boxcox_shift,
        mean=mean,
        stddev=stddev,
        possible_values=possible_values,
        quantiles=quantiles,
        min_value=min_value,
        max_value=max_value,
    )


def get_num_output_features(
    normalization_parameters: Dict[int, NormalizationParameters],
) -> int:
    """Reference: normalization.py:189."""
    return sum(
        len(p.possible_values) if p.feature_type == identify_types.ENUM else 1
        for p in normalization_parameters.values()
    )


def sort_features_by_normalization(
    normalization_parameters: Dict[int, NormalizationParameters],
) -> Tuple[List[int], List[int]]:
    """Group feature ids by feature type, in FEATURE_TYPES order.

    Returns (sorted_features, feature_starts) — reference normalization.py:221.
    """
    sorted_features: List[int] = []
    feature_starts: List[int] = []
    assert isinstance(next(iter(normalization_parameters.keys())), int), (
        "Normalization Parameters need int keys"
    )
    for feature_type in FEATURE_TYPES:
        feature_starts.append(len(sorted_features))
        for feature in sorted(normalization_parameters.keys()):
            if normalization_parameters[feature].feature_type == feature_type:
                sorted_features.append(feature)
    return sorted_features, feature_starts


def get_feature_start_indices(
    sorted_features: List[int],
    normalization_parameters: Dict[int, NormalizationParameters],
) -> List[int]:
    """The first output column of each feature (an ENUM feature takes one
    column per possible value)."""
    start_indices = []
    cur = 0
    for feature in sorted_features:
        p = normalization_parameters[feature]
        start_indices.append(cur)
        if p.feature_type == identify_types.ENUM:
            assert p.possible_values is not None
            cur += len(p.possible_values)
        else:
            cur += 1
    return start_indices


def serialize_one(feature_parameters: NormalizationParameters) -> str:
    return json.dumps(asdict(feature_parameters))


def serialize(parameters: Dict[int, NormalizationParameters]) -> Dict[int, str]:
    return {f: serialize_one(p) for f, p in parameters.items()}


def deserialize(parameters_json: Dict) -> Dict[int, NormalizationParameters]:
    parameters = {}
    for feature, feature_parameters in parameters_json.items():
        params = NormalizationParameters(**json.loads(feature_parameters))
        if params.feature_type == identify_types.ENUM:
            assert params.possible_values is not None
        parameters[int(feature)] = params
    return parameters


def get_feature_norm_metadata(feature_name, feature_value_list, norm_params: Dict):
    """Identification entry used by the Spark/offline flow (reference :265)."""
    if len(feature_value_list) < MINIMUM_SAMPLES_TO_IDENTIFY:
        return None
    feature_override = None
    if norm_params.get("feature_overrides") is not None:
        feature_override = norm_params["feature_overrides"].get(feature_name)
    feature_override = feature_override or norm_params.get("default_feature_override")

    feature_values = np.array(feature_value_list, dtype=np.float32)
    assert not np.any(np.isinf(feature_values)), "Feature values contain infinity"
    assert not np.any(np.isnan(feature_values)), "Feature values contain nan"
    return identify_parameter(
        feature_name,
        feature_values,
        norm_params["max_unique_enum_values"],
        norm_params["quantile_size"],
        norm_params["quantile_k2_threshold"],
        norm_params["skip_box_cox"],
        norm_params["skip_quantiles"],
        feature_override,
    )


def construct_action_scale_arrays(
    action_norm_params: Dict[int, NormalizationParameters],
    action_scale_overrides: Optional[Dict[int, Tuple[float, float]]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The serving range ``(mins [1, A], maxs [1, A])`` of each action
    dimension in sorted order, an override's ``(min, max)`` where given."""
    action_scale_overrides = action_scale_overrides or {}
    sorted_features, _ = sort_features_by_normalization(action_norm_params)
    mins = np.zeros((1, len(sorted_features)))
    maxs = np.zeros((1, len(sorted_features)))
    for idx, fid in enumerate(sorted_features):
        if fid in action_scale_overrides:
            mins[0, idx], maxs[0, idx] = action_scale_overrides[fid]
        else:
            mins[0, idx] = action_norm_params[fid].min_value
            maxs[0, idx] = action_norm_params[fid].max_value
    return mins, maxs
