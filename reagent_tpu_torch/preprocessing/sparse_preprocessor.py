"""Sparse (ID-list / ID-score-list) feature preprocessing on the host.

Port of ``reagent_tpu/preprocessing/sparse_preprocessor.py``: the
``MapIDList`` / ``MapIDScoreList`` mappers (exact, or a hash into an
embedding table's range) and the ``SparsePreprocessor`` that renames
feature ids to names, maps raw ids to table rows and drops the features the
config does not name.  Jagged lists become ``[B, max_length]`` id tensors
padded with 0 and a boolean mask (``core/types.py`` ``IdListFeature`` /
``IdScoreListFeature``).

The hash is the splitmix64 finalizer on ``uint64``: it needs logical right
shifts and products that wrap mod 2^64, which torch's arithmetic-shift
``int64`` does not give, so it runs in numpy, as JAX's does, and the padded
arrays become tensors at the end.
"""

from __future__ import annotations

import abc
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from reagent_tpu_torch.core import types as rlt


def _splitmix64(x):
    """Vectorized 64-bit finalizer (public-domain splitmix64 constants)."""
    x = np.asarray(x, np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(31)
    return x


def hash_ids(raw_ids: np.ndarray, table_size: int, salt: int = 0) -> np.ndarray:
    """``sigrid_hash``-equivalent: raw int64 ids -> [0, table_size) rows."""
    mixed = _splitmix64(np.asarray(raw_ids, np.int64).view(np.uint64) ^ np.uint64(salt))
    return (mixed % np.uint64(table_size)).astype(np.int64)


class MapIDList(abc.ABC):
    """Raw ID list -> embedding-table ids."""

    @abc.abstractmethod
    def __call__(self, raw_ids: np.ndarray) -> np.ndarray: ...


class MapIDScoreList(abc.ABC):
    """Raw (ids, scores) -> (table ids, scores)."""

    @abc.abstractmethod
    def __call__(
        self, raw_ids: np.ndarray, raw_values: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]: ...


class ExactMapIDList(MapIDList):
    def __call__(self, raw_ids: np.ndarray) -> np.ndarray:
        return np.asarray(raw_ids, np.int64)


class ExactMapIDScoreList(MapIDScoreList):
    def __call__(self, raw_ids, raw_values):
        return np.asarray(raw_ids, np.int64), np.asarray(raw_values, np.float32)


class HashingMapIDList(MapIDList):
    """``sigrid_hash``-style hashing into [0, embedding_table_size)."""

    def __init__(self, embedding_table_size: int, salt: int = 0):
        self.embedding_table_size = embedding_table_size
        self.salt = salt

    def __call__(self, raw_ids: np.ndarray) -> np.ndarray:
        return hash_ids(raw_ids, self.embedding_table_size, self.salt)


class HashingMapIDScoreList(MapIDScoreList):
    def __init__(self, embedding_table_size: int, salt: int = 0):
        self.embedding_table_size = embedding_table_size
        self.salt = salt

    def __call__(self, raw_ids, raw_values):
        return (
            hash_ids(raw_ids, self.embedding_table_size, self.salt),
            np.asarray(raw_values, np.float32),
        )


def _pad_id_rows(
    rows: Sequence[Sequence[int]], mapper: MapIDList, max_length: int
) -> rlt.IdListFeature:
    B = len(rows)
    ids = np.zeros((B, max_length), np.int32)
    mask = np.zeros((B, max_length), bool)
    for i, row in enumerate(rows):
        row = np.asarray(list(row)[:max_length], np.int64)
        if row.size:
            ids[i, : row.size] = mapper(row)
            mask[i, : row.size] = True
    return rlt.IdListFeature(ids=torch.from_numpy(ids), mask=torch.from_numpy(mask))


def _pad_id_score_rows(
    rows: Sequence[Sequence[Tuple[int, float]]],
    mapper: MapIDScoreList,
    max_length: int,
) -> rlt.IdScoreListFeature:
    B = len(rows)
    ids = np.zeros((B, max_length), np.int32)
    scores = np.zeros((B, max_length), np.float32)
    mask = np.zeros((B, max_length), bool)
    for i, row in enumerate(rows):
        pairs = list(row)[:max_length]
        if pairs:
            raw_i = np.asarray([p[0] for p in pairs], np.int64)
            raw_s = np.asarray([p[1] for p in pairs], np.float32)
            mi, ms = mapper(raw_i, raw_s)
            ids[i, : len(pairs)] = mi
            scores[i, : len(pairs)] = ms
            mask[i, : len(pairs)] = True
    return rlt.IdScoreListFeature(
        ids=torch.from_numpy(ids), scores=torch.from_numpy(scores), mask=torch.from_numpy(mask)
    )


class SparsePreprocessor:
    """Jagged raw sparse features -> padded, mapped, name-keyed arrays.

    Keys become feature names, ids are mapped per the feature's
    ``IdMappingConfig`` (hashing or exact), rows are cut to its
    ``max_length`` and features missing from the config are dropped.  Rows
    may be keyed by feature_id (int) or by name (str).
    """

    def __init__(self, feature_config: rlt.ModelFeatureConfig):
        self.feature_config = feature_config
        self.id2name: Dict[int, str] = {
            c.feature_id: c.name
            for c in (
                list(feature_config.id_list_feature_configs)
                + list(feature_config.id_score_list_feature_configs)
            )
        }
        self.name2id: Dict[str, int] = {v: k for k, v in self.id2name.items()}
        self._id_list_mappers: Dict[str, MapIDList] = {}
        self._id_list_maxlen: Dict[str, int] = {}
        for cfg in feature_config.id_list_feature_configs:
            m = feature_config.id_mapping_config[cfg.id_mapping_name]
            self._id_list_mappers[cfg.name] = (
                HashingMapIDList(m.embedding_table_size) if m.hashing else ExactMapIDList()
            )
            self._id_list_maxlen[cfg.name] = m.max_length
        self._id_score_list_mappers: Dict[str, MapIDScoreList] = {}
        self._id_score_list_maxlen: Dict[str, int] = {}
        for cfg in feature_config.id_score_list_feature_configs:
            m = feature_config.id_mapping_config[cfg.id_mapping_name]
            self._id_score_list_mappers[cfg.name] = (
                HashingMapIDScoreList(m.embedding_table_size)
                if m.hashing
                else ExactMapIDScoreList()
            )
            self._id_score_list_maxlen[cfg.name] = m.max_length

    def _to_name(self, key) -> str:
        return self.id2name.get(key, key) if isinstance(key, int) else key

    def preprocess_id_list(
        self, raw: Dict
    ) -> Dict[str, rlt.IdListFeature]:
        """{feature_id|name: [[ids...] per row]} -> {name: IdListFeature}."""
        out: Dict[str, rlt.IdListFeature] = {}
        for key, rows in raw.items():
            name = self._to_name(key)
            mapper = self._id_list_mappers.get(name)
            if mapper is None:
                continue  # features the config does not name are dropped
            out[name] = _pad_id_rows(rows, mapper, self._id_list_maxlen[name])
        return out

    def preprocess_id_score_list(
        self, raw: Dict
    ) -> Dict[str, rlt.IdScoreListFeature]:
        """{feature_id|name: [[(id, score)...] per row]} -> {name: IdScoreListFeature}."""
        out: Dict[str, rlt.IdScoreListFeature] = {}
        for key, rows in raw.items():
            name = self._to_name(key)
            mapper = self._id_score_list_mappers.get(name)
            if mapper is None:
                continue
            rows = [
                list(r.items()) if isinstance(r, dict) else r for r in rows
            ]
            out[name] = _pad_id_score_rows(
                rows, mapper, self._id_score_list_maxlen[name]
            )
        return out

    def preprocess(self, raw_id_lists: Dict, raw_id_score_lists: Dict):
        return (
            self.preprocess_id_list(raw_id_lists),
            self.preprocess_id_score_list(raw_id_score_lists),
        )


def make_sparse_preprocessor(
    feature_config: rlt.ModelFeatureConfig,
) -> SparsePreprocessor:
    return SparsePreprocessor(feature_config)
