"""Item 6's host preprocessing and types against the JAX package: the sparse
types and ``ModelFeatureConfig``'s duplicate checks, both processors of
``sparse_to_dense.py`` (``None``, NaN, string keys), ``SparsePreprocessor``
exact and hashing (truncation to ``max_length``, unknown features dropped),
every transform ``tests/test_transforms.py`` covers (each run through both
packages on the same input, outputs compared bit for bit), the
preprocessor's and normalization's missing names, ``ManualDataModule``'s
batches, the ``workflow/types.py`` options, and ``.to`` / stacking of a
``FeatureData`` that holds sparse dicts.  Inputs come from numpy seeds.
"""

import copy
import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from reagent_tpu.core import parameters as jparams
from reagent_tpu.core import types as jrlt
from reagent_tpu.data import data_module as jdm
from reagent_tpu.model_managers.discrete_dqn import DiscreteDQN as JaxDiscreteDQN
from reagent_tpu.preprocessing import normalization as jnorm
from reagent_tpu.preprocessing import preprocessor as jpre
from reagent_tpu.preprocessing import sparse_preprocessor as jsp
from reagent_tpu.preprocessing import sparse_to_dense as jstd
from reagent_tpu.preprocessing import transforms as JT
from reagent_tpu.workflow import types as jwt
from reagent_tpu_torch.core import parameters as params
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.data import data_module as dm
from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
from reagent_tpu_torch.preprocessing import batch_preprocessor as bp
from reagent_tpu_torch.preprocessing import normalization as norm
from reagent_tpu_torch.preprocessing import preprocessor as pre
from reagent_tpu_torch.preprocessing import sparse_preprocessor as sp
from reagent_tpu_torch.preprocessing import sparse_to_dense as std
from reagent_tpu_torch.preprocessing import transforms as T
from reagent_tpu_torch.workflow import types as wt

PRE_TOL = dict(rtol=1e-6, atol=1e-6)  # the Preprocessor's float32 transforms


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(got, want, path="out"):
    """Equal structure and values: port tensors against JAX arrays, the
    sparse dataclasses field by field."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, (str, int, float, bool)):
        assert got == want, path
    else:
        np.testing.assert_array_equal(_as_np(got), _as_np(want), err_msg=path)


def both(make, data, **pre_kw):
    """Run ``make(T)`` of each package on a deep copy of ``data``."""
    got = make(T)(copy.deepcopy(data), **pre_kw)
    want = make(JT)(copy.deepcopy(data), **pre_kw)
    return got, want


# --------------------------------------------------------------------- types


def _feature_config(mod, hashing=False, max_length=3, table=100):
    return mod.ModelFeatureConfig(
        float_feature_infos=[mod.FloatFeatureInfo(name="f", feature_id=1)],
        id_mapping_config={"page": mod.IdMappingConfig(
            embedding_table_size=table, embedding_dim=4, hashing=hashing, max_length=max_length)},
        id_list_feature_configs=[
            mod.IdListFeatureConfig(name="page_ids", feature_id=42, id_mapping_name="page")],
        id_score_list_feature_configs=[
            mod.IdScoreListFeatureConfig(name="page_scores", feature_id=43,
                                         id_mapping_name="page")])


def test_model_feature_config_and_duplicates():
    for mod in (rlt, jrlt):
        fc = _feature_config(mod)
        assert not fc.only_dense and mod.ModelFeatureConfig().only_dense
        assert fc.id2name == {42: "page_ids", 43: "page_scores"}
        assert fc.name2id == {"page_ids": 42, "page_scores": 43}
        assert fc.name2config["page_ids"].id_mapping_name == "page"
        idl = mod.IdListFeatureConfig(name="a", feature_id=1, id_mapping_name="m")
        with pytest.raises(ValueError, match="duplicate sparse feature ids"):
            mod.ModelFeatureConfig(id_list_feature_configs=[idl], id_score_list_feature_configs=[
                mod.IdScoreListFeatureConfig(name="b", feature_id=1, id_mapping_name="m")])
        with pytest.raises(ValueError, match="duplicate sparse feature names"):
            mod.ModelFeatureConfig(id_list_feature_configs=[
                idl, mod.IdListFeatureConfig(name="a", feature_id=2, id_mapping_name="m")])
    assert dataclasses.asdict(rlt.IdMappingConfig(10, 4)) == dataclasses.asdict(
        jrlt.IdMappingConfig(10, 4))


def test_id_list_lengths_and_has_float_features_only():
    mask = np.array([[1, 1, 0], [0, 0, 0], [1, 1, 1]], bool)
    got = rlt.IdListFeature(ids=torch.zeros(3, 3, dtype=torch.int32), mask=torch.from_numpy(mask))
    want = jrlt.IdListFeature(ids=jnp.zeros((3, 3), jnp.int32), mask=jnp.asarray(mask))
    assert got.lengths.dtype == torch.int32
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    dense = rlt.FeatureData(torch.zeros(3, 2))
    assert dense.has_float_features_only
    assert not dataclasses.replace(dense, id_list_features={"a": got}).has_float_features_only
    assert not dataclasses.replace(dense, time_since_first=torch.zeros(3)).has_float_features_only
    assert dataclasses.replace(dense, id_list_features={}).has_float_features_only


def _sparse_feature_data(rng, B=4):
    return rlt.FeatureData(
        float_features=torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32)),
        id_list_features={"page": rlt.IdListFeature(
            ids=torch.from_numpy(rng.integers(0, 9, (B, 5))),
            mask=torch.from_numpy(rng.random((B, 5)) < 0.5))},
        id_score_list_features={"s": rlt.IdScoreListFeature(
            ids=torch.from_numpy(rng.integers(0, 9, (B, 2))),
            scores=torch.from_numpy(rng.random((B, 2)).astype(np.float32)),
            mask=torch.ones(B, 2, dtype=torch.bool))})


def test_to_moves_sparse_dicts():
    """``.to`` recurses into the dicts of sparse features (a meta device
    stands in for the card: every tensor must follow)."""
    fd = _sparse_feature_data(np.random.default_rng(0))
    batch = rlt.DiscreteDqnInput(state=fd, next_state=fd, reward=torch.zeros(4, 1),
                                 time_diff=None, step=None, not_terminal=torch.ones(4, 1))
    for moved in (batch.to("meta"), rlt.batch_to_device(batch, "meta")):
        for f in (moved.state, moved.next_state):
            assert f.float_features.is_meta
            assert f.id_list_features["page"].ids.is_meta
            assert f.id_list_features["page"].mask.is_meta
            s = f.id_score_list_features["s"]
            assert s.ids.is_meta and s.scores.is_meta and s.mask.is_meta
        assert moved.time_diff is None and moved.reward.is_meta
    assert not batch.state.id_list_features["page"].ids.is_meta  # the original stays
    assert rlt.batch_to_device({"x": torch.zeros(2)}, "meta")["x"].is_meta
    assert batch.batch_size() == 4


def test_stack_feature_data_against_jax():
    rng = np.random.default_rng(1)
    rows = [_sparse_feature_data(rng, B=1) for _ in range(3)]
    rows = [dataclasses.replace(r, float_features=r.float_features[0]) for r in rows]
    got = rlt.stack_feature_data(rows)

    def to_jax(r):
        return jrlt.FeatureData(
            float_features=jnp.asarray(r.float_features.numpy()),
            id_list_features={k: jrlt.IdListFeature(ids=jnp.asarray(v.ids.numpy()),
                                                    mask=jnp.asarray(v.mask.numpy()))
                              for k, v in r.id_list_features.items()},
            id_score_list_features={k: jrlt.IdScoreListFeature(
                ids=jnp.asarray(v.ids.numpy()), scores=jnp.asarray(v.scores.numpy()),
                mask=jnp.asarray(v.mask.numpy())) for k, v in r.id_score_list_features.items()})

    want = jrlt.stack_feature_data([to_jax(r) for r in rows])
    assert got.float_features.shape == (3, 3)
    assert got.id_list_features["page"].ids.shape == (3, 1, 5)
    for f in ("float_features",):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for k in ("ids", "mask"):
        np.testing.assert_array_equal(getattr(got.id_list_features["page"], k).numpy(),
                                      np.asarray(getattr(want.id_list_features["page"], k)))
    np.testing.assert_array_equal(got.id_score_list_features["s"].scores.numpy(),
                                  np.asarray(want.id_score_list_features["s"].scores))


def test_value_presence_and_base_input():
    vp = rlt.ValuePresence(value=torch.ones(2), presence=None)
    assert vp.to("meta").value.is_meta and vp.to("meta").presence is None
    assert issubclass(rlt.DiscreteDqnInput, rlt.BaseInput)
    assert [f.name for f in dataclasses.fields(rlt.BaseInput)] == [
        f.name for f in dataclasses.fields(jrlt.BaseInput)]


# ------------------------------------------------------------ sparse_to_dense


ROWS = [{1: 3.0, 7: None, 9: 2.5}, {}, {7: float("nan"), 3: 1.0, 11: -4.0}, {3: -1337.1337}]


@pytest.mark.parametrize("zero", [False, True])
def test_python_sparse_to_dense_against_jax(zero):
    got = std.PythonSparseToDenseProcessor([1, 3, 7, 9], zero)(ROWS)
    want = jstd.PythonSparseToDenseProcessor([1, 3, 7, 9], zero)(ROWS)
    assert_same(got, want)
    if not zero:  # None, NaN and the sentinel itself count as missing
        np.testing.assert_array_equal(got[1][2], [False, True, False, False])
        assert not got[1][3, 1]


@pytest.mark.parametrize("zero", [False, True])
def test_string_key_sparse_to_dense_against_jax(zero):
    rows = [{str(k): v for k, v in r.items()} for r in ROWS]
    got = std.StringKeySparseToDenseProcessor([1, 3, 7, 9], zero)(rows)
    want = jstd.StringKeySparseToDenseProcessor([1, 3, 7, 9], zero)(rows)
    assert_same(got, want)


def test_id_score_list_to_tensor_against_jax():
    rows = [{5: {10: 0.5, 11: 1.5}, 6: {}}, {}, {5: {12: -2.0}}, {6: {1: 3.0, 2: 4.0}}]
    got = std.PythonIdScoreListToTensorProcessor([5, 6, 8])(rows)
    want = jstd.PythonIdScoreListToTensorProcessor([5, 6, 8])(rows)
    assert_same(got, want)
    for fid in got:
        assert [a.dtype for a in got[fid]] == [a.dtype for a in want[fid]]


def test_batch_sparse_to_dense_keeps_zero_and_presence():
    """The batch preprocessors' decoder writes zeros and an explicit
    presence (not the sentinel), as JAX's."""
    from reagent_tpu.preprocessing.batch_preprocessor import sparse_to_dense as jax_std

    rows = [{1: 3.0, 7: None}, None, {"3": 1.0}]
    assert_same(bp.sparse_to_dense(rows, [1, 3, 7]), jax_std(rows, [1, 3, 7]))
    assert issubclass(bp.DiscreteDqnBatchPreprocessor, bp.BatchPreprocessor)
    assert issubclass(bp.PolicyNetworkBatchPreprocessor, bp.BatchPreprocessor)


# -------------------------------------------------------- sparse preprocessor


@pytest.mark.parametrize("hashing", [False, True])
def test_sparse_preprocessor_against_jax(hashing):
    """Exact and hashing maps, truncation to ``max_length``, rows keyed by id
    or by name, features the config does not name dropped."""
    got_p = sp.make_sparse_preprocessor(_feature_config(rlt, hashing, table=97))
    want_p = jsp.make_sparse_preprocessor(_feature_config(jrlt, hashing, table=97))
    rng = np.random.default_rng(2)
    id_lists = {42: [list(rng.integers(0, 2**40, n)) for n in (0, 1, 3, 6)],
                99: [[1, 2]] * 4}
    by_name = {"page_ids": [[5, 6, 7, 8], [9], [], [2**33]]}
    scores = {43: [[(7, 0.5), (8, 1.5)], {9: 2.0, 10: 3.0, 11: 4.0, 12: 5.0}, [], [(1, 0.1)]],
              "nope": [[(1, 1.0)]] * 4}
    for raw in (id_lists, by_name):
        got = got_p.preprocess_id_list(raw)
        want = want_p.preprocess_id_list(raw)
        assert set(got) == {"page_ids"}
        assert_same(got, want)
        assert got["page_ids"].ids.shape == (4, 3) and got["page_ids"].ids.dtype == torch.int32
    got_il, got_isl = got_p.preprocess(id_lists, scores)
    want_il, want_isl = want_p.preprocess(id_lists, scores)
    assert_same(got_il, want_il)
    assert_same(got_isl, want_isl)
    assert set(got_isl) == {"page_scores"}


def test_splitmix_hash_against_jax():
    rng = np.random.default_rng(3)
    raw = np.concatenate([rng.integers(-(2**62), 2**62, 1000), [0, -1, 2**63 - 1, -(2**63)]])
    for size, salt in ((97, 0), (10_000_019, 7), (1, 3)):
        np.testing.assert_array_equal(sp.hash_ids(raw, size, salt), jsp.hash_ids(raw, size, salt))
        np.testing.assert_array_equal(sp.HashingMapIDList(size, salt)(raw),
                                      jsp.HashingMapIDList(size, salt)(raw))
    ids, vals = sp.HashingMapIDScoreList(97)(raw[:5], np.arange(5.0))
    jids, jvals = jsp.HashingMapIDScoreList(97)(raw[:5], np.arange(5.0))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(vals, jvals)


# ---------------------------------------------------------------- transforms


def _norm(mod):
    return mod.NormalizationData(dense_normalization_parameters={
        0: mod.NormalizationParameters(feature_type="CONTINUOUS", mean=1.0, stddev=2.0),
        1: mod.NormalizationParameters(feature_type="CONTINUOUS", mean=0.0, stddev=1.0),
    })


def _norm1(mod):
    return mod.NormalizationData(dense_normalization_parameters={
        0: mod.NormalizationParameters(feature_type="CONTINUOUS", mean=1.0, stddev=2.0)})


def _pmod(TM):
    return params if TM is T else jparams


def test_compose_value_presence_dense_normalization():
    data = {"state": np.array([[3.0, 1.0], [np.nan, 2.0], [40.0, -3.0]], np.float32),
            "state_presence": np.array([[True, True], [True, True], [False, True]])}
    got, want = both(lambda TM: TM.Compose(
        TM.ValuePresence(),
        TM.DenseNormalization(keys=["state"], normalization_data=_norm(_pmod(TM)))), data)
    assert "state_presence" not in got
    assert got["state"].dtype == np.float32
    np.testing.assert_allclose(got["state"], want["state"], **PRE_TOL)
    np.testing.assert_allclose(got["state"][0], [(3 - 1) / 2, 1.0], atol=1e-5)
    np.testing.assert_allclose(got["state"][1, 0], 0.0, atol=1e-5)  # NaN -> missing -> 0
    assert "Compose" in repr(T.Compose(T.ValuePresence()))


def test_one_hot_column_vector_mask_by_presence():
    cases = [
        (lambda TM: TM.OneHotActions(keys=["action"], num_actions=3),
         {"action": np.array([0, 2, 3])}),
        (lambda TM: TM.ColumnVector(keys=["reward"]), {"reward": np.array([1.0, 2.0])}),
        (lambda TM: TM.ColumnVector(keys=["r"]), {"r": ([1.0, 2.0], [1, 1])}),
        (lambda TM: TM.ColumnVector(keys=["r"]), {"r": [3.0, 4.0]}),
        (lambda TM: TM.MaskByPresence(keys=["x"]),
         {"x": (np.array([[1.0, 2.0]]), np.array([[1.0, 0.0]]))}),
        (lambda TM: TM.ExtractValue(keys=["x"]), {"x": [(np.ones(2), 1), (np.zeros(2), 0)]}),
        (lambda TM: TM.StackDenseFixedSizeArray(keys=["x"], size=2),
         {"x": [(np.ones(2), 1), (np.arange(2.0), 0)]}),
        (lambda TM: TM.Lambda(keys=["x"], fn=lambda v: v * 2), {"x": np.arange(3)}),
        (lambda TM: TM.SelectValuePresenceColumns("x", "y", [0, 2]),
         {"x": (np.arange(6.0).reshape(2, 3), np.ones((2, 3)))}),
    ]
    for make, data in cases:
        got, want = both(make, data)
        assert_same(got, want)
    np.testing.assert_array_equal(
        T.OneHotActions(keys=["a"], num_actions=3)({"a": np.array([3])})["a"], [[0, 0, 0]])
    with pytest.raises(ValueError, match="Wrong shape"):
        T.StackDenseFixedSizeArray(keys=["x"], size=3)({"x": np.ones((2, 2))})


def test_fixed_length_sequences_and_slate_view():
    value = np.arange(12, dtype=np.float32).reshape(6, 2)
    data = {"seq": {5: (np.array([0, 3]), (value, np.ones((6, 2), bool)))}}
    got, want = both(lambda TM: TM.FixedLengthSequences(keys=["seq"], sequence_id=5), data)
    assert_same(got, want)
    got, want = both(lambda TM: TM.SlateView(keys=["slate"], slate_size=3), {"slate": value})
    assert got["slate"].shape == (2, 3, 2)
    assert_same(got, want)
    bad = {"seq": {5: (np.array([0, 4]), (np.zeros((6, 2)), np.ones((6, 2), bool)))}}
    for TM in (T, JT):
        with pytest.raises(ValueError):
            TM.FixedLengthSequences(keys=["seq"], sequence_id=5, expected_length=3)(
                copy.deepcopy(bad))


def test_var_length_sequences_pads_and_tracks_presence():
    value = np.array([[1.0], [2.0], [3.0]], np.float32)
    data = {"seq": {7: (np.array([0, 2]), (value, np.ones((3, 1), bool)))}}
    got, want = both(lambda TM: TM.VarLengthSequences(keys=["seq"], sequence_id=7), data)
    assert got["seq"][0].shape == (4, 1)
    assert_same(got, want)


def test_sequence_dense_normalizations():
    value = np.array([[3.0], [5.0], [7.0]], np.float32)
    var = {"seq": {7: (np.array([0, 2]), (value, np.ones((3, 1), bool)))}}
    got, want = both(lambda TM: TM.VarLengthSequenceDenseNormalization(
        keys=["seq"], sequence_id=7, normalization_data=_norm1(_pmod(TM))), var)
    assert got["seq:7"].shape == (2, 2, 1)
    np.testing.assert_allclose(got["seq:7"], want["seq:7"], **PRE_TOL)
    assert_same(got["seq:7_item_presence"], want["seq:7_item_presence"])
    fixed = {"seq": {7: (np.array([0, 2]), (np.arange(4.0, dtype=np.float32).reshape(4, 1),
                                            np.ones((4, 1), bool)))}}
    got, want = both(lambda TM: TM.FixedLengthSequenceDenseNormalization(
        keys=["seq"], sequence_id=7, normalization_data=_norm1(_pmod(TM))), fixed)
    assert got["seq:7"].shape == (2, 2, 1)
    np.testing.assert_allclose(got["seq:7"], want["seq:7"], **PRE_TOL)


def test_outer_product_append_constant_cat_unsqueeze_eye():
    data = {"a": np.array([[1.0, 2.0]]), "b": np.array([[3.0, 4.0]]), "c": np.ones((1, 3, 2)),
            "d": np.full((1, 1, 1), 5.0)}
    for make in (lambda TM: TM.OuterProduct("a", "b", "ab"),
                 lambda TM: TM.OuterProduct("a", "b", "ab", drop_inputs=True),
                 lambda TM: TM.AppendConstant(keys=["a"]),
                 lambda TM: TM.AppendConstant(keys=["c"], const=2.0),
                 lambda TM: TM.Cat(["a", "b"], "cat", dim=-1),
                 lambda TM: TM.Cat(["c", "d"], "cat", dim=-1),
                 lambda TM: TM.UnsqueezeRepeat(keys=["a"], dim=1, num_repeat=3),
                 lambda TM: TM.UnsqueezeRepeat(keys=["a"], dim=0),
                 lambda TM: TM.GetEye("eye", 5)):
        got, want = both(make, data)
        assert_same(got, want)


def test_rename_filter_todtype_stackvarlength():
    data = {"x": np.array([1.0]), "y": np.array([2.0]), "v": [np.array([1.0, 2.0]),
                                                              np.array([3.0])]}
    for make in (lambda TM: TM.Rename(["x"], ["z"]),
                 lambda TM: TM.Filter(keep_keys=["y"]),
                 lambda TM: TM.Filter(remove_keys=["y", "w"]),
                 lambda TM: TM.ToDtype({"x": np.int32}),
                 lambda TM: TM.StackVarLength(keys=["v"]),
                 lambda TM: TM.StackVarLength(keys=["v"], default_value=7.0)):
        got, want = both(make, data)
        assert_same(got, want)
    assert T.ToDtype({"x": np.int32})(dict(data))["x"].dtype == np.int32


def test_id_list_and_id_score_list_features():
    rng = np.random.default_rng(4)
    data = {"ids": {42: [[1, 2, 3], [4], [], list(rng.integers(0, 1000, 9))], 7: []},
            "sc": {43: [[(1, 0.5), (2, 1.5)], {3: 2.0}, [], [(4, 4.0)] * 20]}}
    got, want = both(lambda TM: TM.IDListFeatures(keys=["ids"], feature_ids=[42, 7], max_len=4),
                     data)
    assert_same(got, want)
    assert isinstance(got["ids"][42], rlt.IdListFeature) and got["ids"][42].ids.dtype == torch.int64
    np.testing.assert_array_equal(got["ids"][42].ids[:2].numpy(), [[1, 2, 3, 0], [4, 0, 0, 0]])
    got, want = both(lambda TM: TM.IDScoreListFeatures(keys=["sc"], feature_ids=[43], max_len=3),
                     data)
    assert_same(got, want)
    assert isinstance(got["sc"][43], rlt.IdScoreListFeature)


@pytest.mark.parametrize("hashing", [False, True])
def test_map_id_list_features(hashing):
    data = {"state_id_list": {42: [[7, 8, 9, 10], [9]]},
            "state_id_score_list": {43: [[(7, 0.5)], [(9, 1.5)]]}}
    got, want = both(lambda TM: TM.MapIDListFeatures(
        id_list_keys=["state_id_list"], id_score_list_keys=["state_id_score_list"],
        feature_config=_feature_config(rlt if TM is T else jrlt, hashing)), data)
    assert_same(got, want)
    assert got["state_id_list"]["page_ids"].ids.shape == (2, 3)
    got, want = both(lambda TM: TM.MapIDListFeatures(
        id_list_keys=["state_id_list"], id_score_list_keys=["state_id_score_list"],
        feature_config=_feature_config(rlt if TM is T else jrlt, hashing)),
        {"state_id_list": {42: [[1]]}})
    assert got["state_id_score_list"] is None
    assert_same(got, want)


# ------------------------------------------- preprocessor and normalization


def _mixed_norm(mod):
    return {
        5: mod.NormalizationParameters(feature_type="CONTINUOUS", mean=1.0, stddev=2.0),
        2: mod.NormalizationParameters(feature_type="ENUM", possible_values=[0.0, 3.0, 7.0]),
        9: mod.NormalizationParameters(feature_type="BINARY"),
        4: mod.NormalizationParameters(feature_type="CONTINUOUS_ACTION", min_value=-2.0,
                                       max_value=3.0),
        1: mod.NormalizationParameters(feature_type="CONTINUOUS_ACTION", min_value=0.0,
                                       max_value=1.0),
    }


def test_make_preprocessor_and_presence_from_missing():
    rng = np.random.default_rng(5)
    fn, p = pre.make_preprocessor(_mixed_norm(params))
    jfn, jp = jpre.make_preprocessor(_mixed_norm(jparams))
    assert p.sorted_features == jp.sorted_features
    values = rng.normal(size=(6, 5)).astype(np.float32) * 3
    values[:, p.sorted_features.index(2)] = [0, 3, 7, 1, 3, 0]
    values[0, 1] = norm.MISSING_VALUE
    values[2, 4] = norm.MISSING_VALUE
    presence = pre.presence_from_missing(torch.from_numpy(values))
    jpresence = jpre.presence_from_missing(jnp.asarray(values))
    assert presence.dtype == torch.float32
    np.testing.assert_array_equal(presence.numpy(), np.asarray(jpresence))
    assert presence.sum() == values.size - 2
    out = fn(torch.from_numpy(values), presence)
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(jnp.asarray(values), jpresence)),
                               **PRE_TOL)


def test_feature_start_indices_and_action_scale_arrays():
    n, jn = _mixed_norm(params), _mixed_norm(jparams)
    sorted_features, _ = norm.sort_features_by_normalization(n)
    assert norm.get_feature_start_indices(sorted_features, n) == \
        jnorm.get_feature_start_indices(sorted_features, jn)
    actions = {k: v for k, v in n.items() if v.feature_type == "CONTINUOUS_ACTION"}
    jactions = {k: v for k, v in jn.items() if v.feature_type == "CONTINUOUS_ACTION"}
    for overrides in (None, {4: (-1.0, 1.0)}):
        assert_same(norm.construct_action_scale_arrays(actions, overrides),
                    jnorm.construct_action_scale_arrays(jactions, overrides))


# ------------------------------------------------- data module and options


def _timeline(path, n=300, seed=6):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "mdp_id": [f"m{i // 10}" for i in range(n)],
        "sequence_number": np.arange(n) % 10,
        "state_features": [{0: float(a), 1: float(b)} for a, b in rng.normal(size=(n, 2))],
        "next_state_features": [{0: float(a), 1: float(b)} for a, b in rng.normal(size=(n, 2))],
        "action": [str(a) for a in rng.integers(0, 2, n)],
        "next_action": [str(a) for a in rng.integers(0, 2, n)],
        "reward": rng.normal(size=n).astype(np.float32),
        "not_terminal": (rng.random(n) > 0.1).astype(np.float32),
        "time_diff": np.ones(n, np.float32),
        "action_probability": np.full(n, 0.5, np.float32),
    })
    df.to_pickle(path)
    return df


MODEL = {"trainer_param": {"actions": ["0", "1"], "rl": {"gamma": 0.9}},
         "net_builder": {"FullyConnected": {"sizes": [8], "activations": ["relu"]}}}


def test_manual_data_module_batches_against_jax(tmp_path):
    """``prepare_data`` fits normalization (or takes the pickled setup data),
    splits by mdp-id hash and yields the manager's batches: the same rows
    and values as JAX's module, on the CPU."""
    path = str(tmp_path / "t.pkl")
    _timeline(path)
    spec = dict(table_name="t", table_sample=80.0, eval_table_sample=20.0, path=path)
    mods = {}
    for name, mod, mgr in (("port", dm, DiscreteDQN), ("jax", jdm, JaxDiscreteDQN)):
        kw = dict(input_table_spec=mod.TableSpec(**spec), model_manager=mgr(**MODEL))
        mods[name] = mod.ManualDataModule(**kw, **({"device": "cpu"} if name == "port" else {}))
    for m in mods.values():
        with pytest.raises(AssertionError, match="prepare_data"):
            m.get_normalization_data_map()
        m.prepare_data()
    got_norm = mods["port"].get_normalization_data_map()
    want_norm = mods["jax"].get_normalization_data_map()
    assert {k: dataclasses.asdict(v) for k, v in got_norm.items()} == \
        {k: dataclasses.asdict(v) for k, v in want_norm.items()}
    for split in ("train_dataset", "eval_dataset"):
        kw = {"batch_size": 32}
        got = list(getattr(mods["port"], split)(**kw))
        want = list(getattr(mods["jax"], split)(**kw))
        assert len(got) == len(want) > 0, split
        for g, w in zip(got, want):
            for f in ("reward", "not_terminal", "action", "possible_next_actions_mask"):
                np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)))
            np.testing.assert_allclose(g.state.float_features.numpy(),
                                       np.asarray(w.state.float_features), **PRE_TOL)
    # the pickled setup data replaces the identification
    setup = {"normalization_data_map": pickle.dumps(got_norm)}
    again = dm.ManualDataModule(input_table_spec=dm.TableSpec(**spec), model_manager=None,
                                setup_data=setup, device="cpu")
    again.prepare_data()
    assert again.get_normalization_data_map().keys() == got_norm.keys()
    assert issubclass(dm.ManualDataModule, dm.ReAgentDataModule)
    for hook in ("get_normalization_data_map", "prepare_data", "train_dataset", "eval_dataset"):
        with pytest.raises(NotImplementedError):
            getattr(dm.ReAgentDataModule(), hook)()


def test_dataset_reads_pickle(tmp_path):
    path = str(tmp_path / "t.pkl")
    df = _timeline(path, n=20)
    pd.testing.assert_frame_equal(wt.Dataset(parquet_url=path).read(), df)


def test_workflow_options_against_jax():
    assert dataclasses.asdict(wt.ReaderOptions()) == dataclasses.asdict(jwt.ReaderOptions())
    assert dataclasses.asdict(wt.ResourceOptions(gpu=1)) == dataclasses.asdict(
        jwt.ResourceOptions(gpu=1))
    for kw in ({}, dict(max_unique_enum_values=4, quantile_size=5, quantile_k2_threshold=9.0,
                        skip_box_cox=True, skip_quantiles=False, feature_overrides={3: "ENUM"},
                        allowedlist_features=[1, 2])):
        got, want = wt.PreprocessingOptions(**kw), jwt.PreprocessingOptions(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.normalization_kwargs() == want.normalization_kwargs()
    fc = _feature_config(rlt)
    assert wt.ModelFeatureConfigProvider(raw=fc).get_model_feature_config() is fc
    assert wt.ModelFeatureConfigProvider().get_model_feature_config().only_dense
