"""Feature-type identification from raw value samples (host-side numpy).

Reference: reagent/preprocessing/identify_types.py.  The decision cascade is
binary -> probability -> enum -> continuous; BOXCOX/QUANTILE are promoted from
CONTINUOUS later by `normalization.identify_parameter` based on normality tests.
"""

from __future__ import annotations

import numpy as np

BINARY = "BINARY"
PROBABILITY = "PROBABILITY"
CONTINUOUS = "CONTINUOUS"
BOXCOX = "BOXCOX"
ENUM = "ENUM"
QUANTILE = "QUANTILE"
CONTINUOUS_ACTION = "CONTINUOUS_ACTION"
DISCRETE_ACTION = "DISCRETE_ACTION"
DO_NOT_PREPROCESS = "DO_NOT_PREPROCESS"
CLIP_LOG = "CLIP_LOG"

FEATURE_TYPES = (
    BINARY,
    PROBABILITY,
    CONTINUOUS,
    BOXCOX,
    ENUM,
    QUANTILE,
    CONTINUOUS_ACTION,
    DISCRETE_ACTION,
    DO_NOT_PREPROCESS,
    CLIP_LOG,
)

DEFAULT_MAX_UNIQUE_ENUM = 10


def _is_binary(values: np.ndarray) -> bool:
    return bool(
        np.all(np.logical_or(values == 0, values == 1))
        or np.min(values) == np.max(values)
    )


def _is_probability(values: np.ndarray) -> bool:
    return bool(np.all(values >= 0) and np.all(values <= 1))


def _is_enum(values: np.ndarray, enum_threshold: int) -> bool:
    return bool(
        np.min(values) >= 0
        and len(np.unique(values)) <= enum_threshold
        and np.all(np.equal(np.mod(values, 1), 0))
    )


def identify_type(values: np.ndarray, enum_threshold: int = DEFAULT_MAX_UNIQUE_ENUM) -> str:
    values = np.asarray(values)
    if _is_binary(values):
        return BINARY
    if _is_probability(values):
        return PROBABILITY
    if _is_enum(values, enum_threshold):
        return ENUM
    return CONTINUOUS
