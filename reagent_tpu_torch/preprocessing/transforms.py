"""Composable dict-batch transforms: raw table columns -> model-ready arrays.

Port of ``reagent_tpu/preprocessing/transforms.py`` (reference:
reagent/preprocessing/transforms.py, Compose:22 ... StackVarLength:976).
They run on the host between the data reader and the train step, in numpy,
as JAX's do; ``DenseNormalization`` runs the port's ``Preprocessor`` (on the
CPU) and hands back numpy, ``MapIDListFeatures`` the port's
``SparsePreprocessor``, and ``IDListFeatures`` / ``IDScoreListFeatures``
return the port's tensors where JAX's return ``jnp`` arrays (the ids as
``int64``, torch's index type).

Each transform is a callable ``dict -> dict`` over a batch dictionary whose
values are arrays, (value, presence) tuples, or python lists, mirroring the
reference's petastorm-row contract.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor

Array = np.ndarray


class Compose:
    """Apply transforms in order (ref transforms.py:22)."""

    def __init__(self, *transforms):
        self.transforms = transforms

    def __call__(self, data: Dict) -> Dict:
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        inner = "\n    ".join(repr(t) for t in self.transforms)
        return f"{self.__class__.__name__}(\n    {inner}\n)"


class ValuePresence:
    """Pair ``x`` with ``x_presence`` into a tuple (ref :41)."""

    def __call__(self, data: Dict) -> Dict:
        for k in list(data.keys()):
            pk = f"{k}_presence"
            if pk in data:
                data[k] = (data[k], data[pk])
                del data[pk]
        return data


class Lambda:
    """Apply an arbitrary callable to keys (ref :59)."""

    def __init__(self, keys: List[str], fn: Callable):
        self.keys = keys
        self.fn = fn

    def __call__(self, data: Dict) -> Dict:
        for k in self.keys:
            data[k] = self.fn(data[k])
        return data


class SelectValuePresenceColumns:
    """Column-select from a (value, presence) source (ref :72)."""

    def __init__(self, source: str, dest: str, indices: List[int]):
        self.source = source
        self.dest = dest
        self.indices = indices

    def __call__(self, data: Dict) -> Dict:
        value, presence = data[self.source]
        data[self.dest] = (value[:, self.indices], presence[:, self.indices])
        return data


class DenseNormalization:
    """Run the Preprocessor over (value, presence) keys (ref :88); NaN
    values count as absent."""

    def __init__(self, keys: List[str], normalization_data: NormalizationData):
        self.keys = keys
        self.normalization_data = normalization_data
        self._preprocessor: Optional[Preprocessor] = None

    def __call__(self, data: Dict) -> Dict:
        if self._preprocessor is None:
            self._preprocessor = Preprocessor(
                self.normalization_data.dense_normalization_parameters
            )
        for k in self.keys:
            value, presence = data[k]
            value = np.asarray(value, np.float32)
            presence = np.asarray(presence)
            nan = np.isnan(value)
            presence = np.where(nan, False, presence.astype(bool))
            value = np.where(nan, 0.0, value)
            with torch.no_grad():
                out = self._preprocessor(torch.from_numpy(np.ascontiguousarray(value)),
                                         torch.from_numpy(presence))
            data[k] = out.numpy().astype(np.float32)
        return data


class OneHotActions:
    """Value == num_actions means invalid -> zero vector (ref :386)."""

    def __init__(self, keys: List[str], num_actions: int):
        self.keys = keys
        self.num_actions = num_actions

    def __call__(self, data: Dict) -> Dict:
        eye = np.eye(self.num_actions + 1, dtype=np.float32)[:, : self.num_actions]
        for k in self.keys:
            data[k] = eye[np.asarray(data[k], np.int64)]
        return data


class ColumnVector:
    """Reshape 1-d (or [B, 1]) values to column vectors (ref :406)."""

    def __init__(self, keys: List[str]):
        self.keys = keys

    def __call__(self, data: Dict) -> Dict:
        for k in self.keys:
            raw = data[k]
            if isinstance(raw, tuple):
                value = np.asarray(raw[0])
            elif isinstance(raw, list):
                value = np.array(raw)
            else:
                value = np.asarray(raw)
            assert value.ndim == 1 or (value.ndim == 2 and value.shape[1] == 1), (
                f"Invalid shape for key {k}: {value.shape}"
            )
            data[k] = value.reshape(-1, 1)
        return data


class ExtractValue:
    """list[(value, presence)] -> list[value] (ref :439)."""

    def __init__(self, keys: List[str]):
        self.keys = keys

    def __call__(self, data: Dict) -> Dict:
        for k in self.keys:
            raw = data[k]
            assert isinstance(raw, list) and raw, f"{k} must be a non-empty list"
            data[k] = [np.asarray(v) for v, _p in raw]
        return data


class MaskByPresence:
    """value * presence (ref :465)."""

    def __init__(self, keys: List[str]):
        self.keys = keys

    def __call__(self, data: Dict) -> Dict:
        for k in self.keys:
            value, presence = data[k]
            value, presence = np.asarray(value), np.asarray(presence)
            assert value.shape == presence.shape, (
                f"Unmatching value/presence shapes for {k}:"
                f" {value.shape} vs {presence.shape}"
            )
            data[k] = value * presence.astype(np.float32)
        return data


class StackDenseFixedSizeArray:
    """Stack list[(value, presence)] into [B, size] (ref :490)."""

    def __init__(self, keys: List[str], size: int, dtype=np.float32):
        self.keys = keys
        self.size = size
        self.dtype = dtype

    def __call__(self, data: Dict) -> Dict:
        for k in self.keys:
            value = data[k]
            if isinstance(value, np.ndarray):
                if not (value.ndim == 2 and value.shape[1] == self.size):
                    raise ValueError(f"Wrong shape for key {k}: {value.shape}")
                data[k] = value.astype(self.dtype)
            else:
                data[k] = (
                    np.concatenate([np.asarray(v) for v, _p in value])
                    .reshape(-1, self.size)
                    .astype(self.dtype)
                )
        return data


class FixedLengthSequences:
    """Check fixed stride and unpack {fid: (offsets, (value, presence))}
    sequence features (ref :520)."""

    def __init__(
        self,
        keys: List[str],
        sequence_id: int,
        expected_length: Optional[int] = None,
        *,
        to_keys: Optional[List[str]] = None,
    ):
        self.keys = keys
        self.sequence_id = sequence_id
        self.to_keys = to_keys or keys
        assert len(self.to_keys) == len(keys)
        self.expected_length = expected_length

    def __call__(self, data: Dict) -> Dict:
        for key, to_key in zip(self.keys, self.to_keys):
            offsets, value_presence = data[key][self.sequence_id]
            offsets = np.asarray(offsets)
            expected_length = self.expected_length
            if expected_length is None:
                if len(offsets) > 1:
                    expected_length = int(offsets[1] - offsets[0])
                else:
                    expected_length = int(np.asarray(value_presence[0]).shape[0])
                self.expected_length = expected_length
            expected = np.arange(len(offsets), dtype=offsets.dtype) * expected_length
            if not np.array_equal(offsets, expected):
                raise ValueError(
                    f"Unexpected offsets for {key}: {offsets} != {expected}"
                )
            data[to_key] = value_presence
        return data


class SlateView:
    """[B*slate_size, D] -> [B, slate_size, D] (ref :582).

    ``slate_size`` may be overridden per call — compositions whose slate size
    is only known at batch time (variable-length sequences) pass it
    explicitly instead of mutating transform state.
    """

    def __init__(self, keys: List[str], slate_size: int):
        self.keys = keys
        self.slate_size = slate_size

    def __call__(self, data: Dict, slate_size: Optional[int] = None) -> Dict:
        size = self.slate_size if slate_size is None else slate_size
        assert size > 0, f"slate_size must be known at call time, got {size}"
        for k in self.keys:
            value = np.asarray(data[k])
            _, dim = value.shape
            data[k] = value.reshape(-1, size, dim)
        return data


class VarLengthSequences:
    """Pad jagged sequences to the batch max length + item presence (ref :603)."""

    def __init__(
        self,
        keys: List[str],
        sequence_id: int,
        *,
        to_keys: Optional[List[str]] = None,
        to_keys_item_presence: Optional[List[str]] = None,
    ):
        self.keys = keys
        self.sequence_id = sequence_id
        self.to_keys = to_keys or keys
        self.to_keys_item_presence = to_keys_item_presence or [
            k + "_item_presence" for k in self.to_keys
        ]
        assert len(self.to_keys) == len(keys)

    def __call__(self, data: Dict) -> Dict:
        for key, to_key, to_key_ip in zip(
            self.keys, self.to_keys, self.to_keys_item_presence
        ):
            offsets, (value, presence) = data[key][self.sequence_id]
            offsets = np.asarray(offsets)
            value, presence = np.asarray(value), np.asarray(presence)
            lengths = np.diff(np.concatenate([offsets, [value.shape[0]]]))
            num_obs = len(lengths)
            max_len = int(lengths.max())
            self.max_len = max_len  # read by VarLengthSequenceDenseNormalization
            feature_dim = value.shape[1]
            padded_value = np.zeros((num_obs * max_len, feature_dim), value.dtype)
            padded_presence = np.zeros((num_obs * max_len, feature_dim), presence.dtype)
            indices = np.concatenate(
                [np.arange(lengths[i]) + i * max_len for i in range(num_obs)]
            )
            padded_value[indices] = value
            padded_presence[indices] = presence
            item_presence = (
                np.arange(max_len)[None, :] < lengths[:, None]
            ).astype(np.float32)
            data[to_key] = (padded_value, padded_presence)
            data[to_key_ip] = item_presence
        return data


class FixedLengthSequenceDenseNormalization:
    """FixedLengthSequences + DenseNormalization + SlateView (ref :691)."""

    def __init__(
        self,
        keys: List[str],
        sequence_id: int,
        normalization_data: NormalizationData,
        expected_length: Optional[int] = None,
        to_keys: Optional[List[str]] = None,
    ):
        to_keys = to_keys or [f"{k}:{sequence_id}" for k in keys]
        self.fixed_length_sequences = FixedLengthSequences(
            keys, sequence_id, expected_length=expected_length, to_keys=to_keys
        )
        self.dense_normalization = DenseNormalization(to_keys, normalization_data)
        self.slate_view = SlateView(to_keys, slate_size=-1)

    def __call__(self, data: Dict) -> Dict:
        data = self.fixed_length_sequences(data)
        data = self.dense_normalization(data)
        # expected_length may itself have been inferred from the first batch
        return self.slate_view(
            data, slate_size=self.fixed_length_sequences.expected_length
        )


class VarLengthSequenceDenseNormalization:
    """VarLengthSequences + DenseNormalization + SlateView (ref :722).

    The slate size is inferred at runtime from the largest sequence in the
    batch (VarLengthSequences records it) and patched into SlateView.
    """

    def __init__(
        self,
        keys: List[str],
        sequence_id: int,
        normalization_data: NormalizationData,
        to_keys_item_presence: Optional[List[str]] = None,
        to_keys: Optional[List[str]] = None,
    ):
        to_keys = to_keys or [f"{k}:{sequence_id}" for k in keys]
        self.var_length_sequences = VarLengthSequences(
            keys,
            sequence_id,
            to_keys=to_keys,
            to_keys_item_presence=to_keys_item_presence,
        )
        self.dense_normalization = DenseNormalization(to_keys, normalization_data)
        self.slate_view = SlateView(to_keys, slate_size=-1)

    def __call__(self, data: Dict) -> Dict:
        data = self.var_length_sequences(data)
        data = self.dense_normalization(data)
        # slate size is a per-batch quantity for jagged input (the batch max,
        # shared across keys); pass it per call rather than patching state
        return self.slate_view(
            data, slate_size=self.var_length_sequences.max_len
        )


class MapIDListFeatures:
    """Apply a SparsePreprocessor to raw jagged id-list / id-score-list
    columns (ref :347; deprecated there in favor of IDListFeatures /
    IDScoreListFeatures but still part of the public surface).

    Missing keys (or an empty feature config) map to None.
    """

    def __init__(
        self,
        id_list_keys: List[str],
        id_score_list_keys: List[str],
        feature_config,
    ):
        from reagent_tpu_torch.preprocessing.sparse_preprocessor import (
            make_sparse_preprocessor,
        )

        self.id_list_keys = id_list_keys
        self.id_score_list_keys = id_score_list_keys
        overlap = set(id_list_keys) & set(id_score_list_keys)
        assert not overlap, f"overlapping keys: {overlap}"
        self.feature_config = feature_config
        self.sparse_preprocessor = make_sparse_preprocessor(feature_config)

    def __call__(self, data: Dict) -> Dict:
        for k in self.id_list_keys + self.id_score_list_keys:
            if not self.sparse_preprocessor.id2name or k not in data:
                data[k] = None
                continue
            assert isinstance(data[k], dict), f"{k} has type {type(data[k])}"
            if k in self.id_list_keys:
                data[k] = self.sparse_preprocessor.preprocess_id_list(data[k])
            else:
                data[k] = self.sparse_preprocessor.preprocess_id_score_list(data[k])
        return data


class AppendConstant:
    """Prepend a constant column (LinUCB intercept; ref :759)."""

    def __init__(self, keys: List[str], dim: int = -1, const: float = 1.0):
        self.keys = keys
        self.dim = dim
        self.const = const

    def __call__(self, data: Dict) -> Dict:
        for k in self.keys:
            value = np.asarray(data[k])
            extra = self.const * np.ones((*value.shape[:-1], 1), value.dtype)
            data[k] = np.concatenate([extra, value], axis=self.dim)
        return data


class UnsqueezeRepeat:
    """Insert a dim and tile along it (ref :780)."""

    def __init__(self, keys: List[str], dim: int, num_repeat: int = 1):
        self.keys = keys
        self.dim = dim
        self.num_repeat = num_repeat

    def __call__(self, data: Dict) -> Dict:
        for k in self.keys:
            value = np.expand_dims(np.asarray(data[k]), self.dim)
            if self.num_repeat != 1:
                reps = [1] * value.ndim
                reps[self.dim] = self.num_repeat
                value = np.tile(value, reps)
            data[k] = value
        return data


def _get_product_features(x: Array, y: Array) -> Array:
    """Flattened outer product along the last dim (ref :801-819)."""
    return np.einsum("...i,...j->...ij", x, y).reshape(*x.shape[:-1], -1)


class OuterProduct:
    """Outer product of two keys into a new key (ref :821)."""

    def __init__(self, key1: str, key2: str, output_key: str, drop_inputs: bool = False):
        self.key1 = key1
        self.key2 = key2
        self.output_key = output_key
        self.drop_inputs = drop_inputs

    def __call__(self, data: Dict) -> Dict:
        prod = _get_product_features(np.asarray(data[self.key1]), np.asarray(data[self.key2]))
        data[self.output_key] = prod
        if self.drop_inputs:
            del data[self.key1], data[self.key2]
        return data


class GetEye:
    """Put an identity matrix under a key (ref :850)."""

    def __init__(self, key: str, size: int):
        self.key = key
        self.size = size

    def __call__(self, data: Dict) -> Dict:
        data[self.key] = np.eye(self.size, dtype=np.float32)
        return data


def _broadcast_for_cat(tensors: List[Array], dim: int) -> List[Array]:
    """Broadcast all shapes except the concat dim (ref :863-889)."""
    dims = [dim if dim >= 0 else t.ndim + dim for t in tensors]
    shapes = []
    for t, d in zip(tensors, dims):
        s = list(t.shape)
        s.pop(d)
        shapes.append(tuple(s))
    broadcast = np.broadcast_shapes(*shapes)
    out = []
    for t, d in zip(tensors, dims):
        target = list(broadcast)
        target.insert(d, t.shape[d])
        out.append(np.broadcast_to(t, target))
    return out


class Cat:
    """Concatenate keys along a dim, broadcasting the rest (ref :892)."""

    def __init__(self, input_keys: List[str], output_key: str, dim: int, broadcast: bool = True):
        self.input_keys = input_keys
        self.output_key = output_key
        self.dim = dim
        self.broadcast = broadcast

    def __call__(self, data: Dict) -> Dict:
        tensors = [np.asarray(data[k]) for k in self.input_keys]
        if self.broadcast:
            tensors = _broadcast_for_cat(tensors, self.dim)
        data[self.output_key] = np.concatenate(tensors, axis=self.dim)
        return data


class Rename:
    """Rename keys (ref :915)."""

    def __init__(self, old_names: List[str], new_names: List[str]):
        self.old_names = old_names
        self.new_names = new_names

    def __call__(self, data: Dict) -> Dict:
        new_data = dict(data)
        for o, n in zip(self.old_names, self.new_names):
            new_data[n] = new_data.pop(o)
        return new_data


class Filter:
    """Keep or remove keys (ref :931)."""

    def __init__(self, *, keep_keys: Optional[List[str]] = None, remove_keys: Optional[List[str]] = None):
        assert (keep_keys is None) != (remove_keys is None)
        self.keep_keys = keep_keys
        self.remove_keys = remove_keys

    def __call__(self, data: Dict) -> Dict:
        if self.keep_keys:
            return {k: data[k] for k in self.keep_keys if k in data}
        new_data = dict(data)
        for k in self.remove_keys:
            new_data.pop(k, None)
        return new_data


class ToDtype:
    """Cast keys to dtypes (ref :961)."""

    def __init__(self, dtypes: Dict[str, np.dtype]):
        self.dtypes = dtypes

    def __call__(self, data: Dict) -> Dict:
        new_data = dict(data)
        for key, dtype in self.dtypes.items():
            new_data[key] = np.asarray(data[key]).astype(dtype)
        return new_data


class StackVarLength:
    """Right-pad 1-d arrays of different lengths and stack (ref :976)."""

    def __init__(self, keys: List[str], default_value: float = -1.0):
        self.keys = keys
        self.default_value = default_value

    def __call__(self, data: Dict) -> Dict:
        for k in self.keys:
            values = [np.asarray(v) for v in data[k]]
            assert values[0].ndim == 1
            max_length = max(len(x) for x in values)
            stacked = np.full((len(values), max_length), self.default_value, values[0].dtype)
            for i, x in enumerate(values):
                stacked[i, : len(x)] = x
            data[k] = stacked
        return data


class IDListFeatures:
    """Gather jagged id-list features into the padded IdListFeature layout.

    Reference :184 builds torchrec KeyedJaggedTensors; here the layout is
    the padded [B, max_len] ids + mask of core/types.py (IdListFeature),
    ready for the EmbeddingBag models.
    """

    def __init__(self, keys: List[str], feature_ids: List[int], max_len: int = 16):
        self.keys = keys
        self.feature_ids = feature_ids
        self.max_len = max_len

    def __call__(self, data: Dict) -> Dict:
        from reagent_tpu_torch.core.types import IdListFeature

        for k in self.keys:
            per_feature = {}
            for fid in self.feature_ids:
                rows: List[List[int]] = data[k].get(fid, [])
                B = len(rows)
                ids = np.zeros((B, self.max_len), np.int64)
                mask = np.zeros((B, self.max_len), np.float32)
                for i, row in enumerate(rows):
                    n = min(len(row), self.max_len)
                    ids[i, :n] = row[:n]
                    mask[i, :n] = 1.0
                per_feature[fid] = IdListFeature(
                    ids=torch.from_numpy(ids), mask=torch.from_numpy(mask)
                )
            data[k] = per_feature
        return data


class IDScoreListFeatures:
    """Gather jagged (id, score) features into padded IdScoreListFeature layout.

    Reference transforms.py:263 builds weighted KeyedJaggedTensors; here each
    row is a list of (id, score) pairs (or a {id: score} dict) padded to
    [B, max_len] ids/scores with a validity mask.
    """

    def __init__(self, keys: List[str], feature_ids: List[int], max_len: int = 16):
        self.keys = keys
        self.feature_ids = feature_ids
        self.max_len = max_len

    def __call__(self, data: Dict) -> Dict:
        from reagent_tpu_torch.core.types import IdScoreListFeature

        for k in self.keys:
            per_feature = {}
            for fid in self.feature_ids:
                rows = data[k].get(fid, [])
                rows = [list(r.items()) if isinstance(r, dict) else r for r in rows]
                B = len(rows)
                ids = np.zeros((B, self.max_len), np.int64)
                scores = np.zeros((B, self.max_len), np.float32)
                mask = np.zeros((B, self.max_len), np.float32)
                for i, pairs in enumerate(rows):
                    n = min(len(pairs), self.max_len)
                    for j in range(n):
                        ids[i, j], scores[i, j] = pairs[j]
                        mask[i, j] = 1.0
                per_feature[fid] = IdScoreListFeature(
                    ids=torch.from_numpy(ids),
                    scores=torch.from_numpy(scores),
                    mask=torch.from_numpy(mask),
                )
            data[k] = per_feature
        return data
