"""Sparse (dict-keyed) feature rows -> dense (value, presence) matrices.

Port of ``reagent_tpu/preprocessing/sparse_to_dense.py``
(``SparseToDenseProcessor``, ``PythonSparseToDenseProcessor`` :35,
``StringKeySparseToDenseProcessor`` :63,
``PythonIdScoreListToTensorProcessor`` :82).  Host-side numpy, as in the JAX
package.  These processors mark a missing value with the ``MISSING_VALUE``
sentinel and derive the presence from it; the batch preprocessors'
``sparse_to_dense`` (``batch_preprocessor.py``) writes zeros and an explicit
presence instead.  Both behaviours are kept.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from reagent_tpu_torch.preprocessing.normalization import MISSING_VALUE


class SparseToDenseProcessor:
    """Base: maps rows of {feature_id: value} to ([N, F] values, presence)."""

    def __init__(
        self, sorted_features: Sequence[int], set_missing_value_to_zero: bool = False
    ) -> None:
        self.sorted_features = list(sorted_features)
        self.set_missing_value_to_zero = set_missing_value_to_zero

    def __call__(self, sparse_data):
        return self.process(sparse_data)

    def process(self, sparse_data):
        raise NotImplementedError


class PythonSparseToDenseProcessor(SparseToDenseProcessor):
    """Dict-of-int rows; a ``None`` or NaN value counts as missing."""

    def __init__(
        self, sorted_features: Sequence[int], set_missing_value_to_zero: bool = False
    ) -> None:
        super().__init__(sorted_features, set_missing_value_to_zero)
        self.feature_to_index: Dict[int, int] = {
            f: i for i, f in enumerate(self.sorted_features)
        }

    def process(
        self, sparse_data: List[Dict[int, float]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        missing = 0.0 if self.set_missing_value_to_zero else MISSING_VALUE
        values = np.full((len(sparse_data), len(self.sorted_features)), missing, np.float32)
        for r, row in enumerate(sparse_data):
            for k, v in row.items():
                idx = self.feature_to_index.get(k)
                if idx is not None:
                    values[r, idx] = missing if v is None or np.isnan(v) else v
        if self.set_missing_value_to_zero:
            presence = np.ones_like(values, dtype=bool)
        else:
            presence = values != missing
        return values, presence


class StringKeySparseToDenseProcessor(SparseToDenseProcessor):
    """Same, for rows keyed by stringified feature ids."""

    def __init__(
        self, sorted_features: Sequence[int], set_missing_value_to_zero: bool = False
    ) -> None:
        super().__init__(sorted_features, set_missing_value_to_zero)
        self._inner = PythonSparseToDenseProcessor(
            sorted_features, set_missing_value_to_zero
        )

    def process(
        self, sparse_data: List[Dict[str, float]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        return self._inner.process(
            [{int(k): v for k, v in row.items()} for row in sparse_data]
        )


class PythonIdScoreListToTensorProcessor:
    """Weighted-multi-categorical rows -> per-feature (offsets, ids, scores).

    The jagged (KeyedJaggedTensor-style) layout: each row's offset into
    the concatenated ids and scores.
    """

    def __init__(self, id_score_list_feature_ids: Sequence[int]) -> None:
        self.id_score_list_feature_ids = list(id_score_list_feature_ids)

    def __call__(
        self, list_id_score_list_features: List[Dict[int, Dict[int, float]]]
    ) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        out: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for fid in self.id_score_list_feature_ids:
            offsets, ids, scores = [0], [], []
            for row in list_id_score_list_features:
                mapping = row.get(fid, {})
                ids.extend(mapping.keys())
                scores.extend(mapping.values())
                offsets.append(len(ids))
            out[fid] = (
                np.asarray(offsets[:-1], np.int32),
                np.asarray(ids, np.int64),
                np.asarray(scores, np.float32),
            )
        return out
