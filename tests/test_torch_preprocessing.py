"""Preprocessing and data plumbing: the port against reagent_tpu."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from reagent_tpu.core import parameters as jparams
from reagent_tpu.data import data_module as jdm
from reagent_tpu.preprocessing import normalization as jnorm
from reagent_tpu.preprocessing.batch_preprocessor import (
    DiscreteDqnBatchPreprocessor as JaxBatchPreprocessor,
)
from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
from reagent_tpu_torch.core import parameters as params
from reagent_tpu_torch.data import data_module as dm
from reagent_tpu_torch.preprocessing import normalization as norm
from reagent_tpu_torch.preprocessing.batch_preprocessor import DiscreteDqnBatchPreprocessor
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor

NORM_KW = {
    "feature_overrides": {"6": "CONTINUOUS_ACTION", "7": "DO_NOT_PREPROCESS",
                          "8": "CLIP_LOG"},
    "max_unique_enum_values": 10,
    "quantile_size": 20,
    "quantile_k2_threshold": 1000.0,
    "skip_box_cox": False,
    "skip_quantiles": False,
}


@pytest.mark.parametrize(
    "name", ["RLParameters", "EvaluationParameters", "NormalizationParameters",
             "NormalizationData"])
def test_parameter_classes_match_jax(name):
    """Same fields and defaults, so the JAX package's configs load unchanged."""
    ours, theirs = getattr(params, name), getattr(jparams, name)
    assert repr(dataclasses.fields(ours)) == repr(dataclasses.fields(theirs))
    assert vars(params.NormalizationKey).keys() >= {"STATE", "ACTION"}
    assert params.NormalizationKey.STATE == jparams.NormalizationKey.STATE


def _feature_samples(rng, n=2000):
    """One sample per feature type identification can produce."""
    return {
        0: rng.normal(3.0, 2.0, n),                       # CONTINUOUS
        1: rng.lognormal(0.0, 1.0, n),                    # BOXCOX
        2: rng.integers(0, 2, n).astype(float),           # BINARY
        3: rng.random(n),                                 # PROBABILITY
        4: rng.integers(0, 4, n).astype(float) * 2,       # ENUM
        5: np.concatenate([rng.normal(0, 1, n - 50), rng.normal(0, 1, 50) * 1e4]),  # QUANTILE
        6: rng.uniform(-2.0, 5.0, n),                     # CONTINUOUS_ACTION (override)
        7: rng.normal(1.0, 3.0, n),                       # DO_NOT_PREPROCESS (override)
        8: rng.exponential(2.0, n),                       # CLIP_LOG (override)
    }


def _both_specs():
    samples = _feature_samples(np.random.default_rng(0))
    ours = {f: norm.get_feature_norm_metadata(str(f), v, NORM_KW) for f, v in samples.items()}
    theirs = {f: jnorm.get_feature_norm_metadata(str(f), v, NORM_KW) for f, v in samples.items()}
    return samples, ours, theirs


def test_normalization_parameters_identical():
    _, ours, theirs = _both_specs()
    kinds = {p.feature_type for p in ours.values()}
    assert kinds == {"CONTINUOUS", "BOXCOX", "BINARY", "PROBABILITY", "ENUM", "QUANTILE",
                     "CONTINUOUS_ACTION", "DO_NOT_PREPROCESS", "CLIP_LOG"}
    for f in ours:
        assert dict(vars(ours[f])) == dict(vars(theirs[f])), f
    assert norm.serialize(ours) == jnorm.serialize(theirs)
    assert norm.get_num_output_features(ours) == jnorm.get_num_output_features(theirs)
    assert norm.deserialize(norm.serialize(ours)) == ours


def test_preprocessor_matches_jax():
    samples, ours, theirs = _both_specs()
    pre, jpre = Preprocessor(ours), JaxPreprocessor(theirs)
    assert pre.sorted_features == jpre.sorted_features
    rng = np.random.default_rng(1)
    values = np.stack(
        [rng.choice(samples[f], 64) for f in pre.sorted_features], axis=1).astype(np.float32)
    values[:4] = values[:4] * 50.0  # past the clamps and the quantile range
    presence = (rng.random(values.shape) > 0.1).astype(np.float32)
    got = pre(torch.tensor(values), torch.tensor(presence)).numpy()
    want = np.asarray(jpre(jnp.asarray(values), jnp.asarray(presence)))
    assert got.shape == want.shape == (64, pre.num_output_features)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _table(rng, n=48):
    actions = ["a", "b", "c"]
    return pd.DataFrame({
        "mdp_id": [f"m{i // 4}" for i in range(n)],
        "sequence_number": np.arange(n) % 4,
        "state_features": [
            {0: float(rng.normal()), 2: float(rng.integers(0, 2))} if i % 7 else {}
            for i in range(n)],
        "next_state_features": [{0: float(rng.normal())} for _ in range(n)],
        "action": [actions[i % 3] for i in range(n)],
        "next_action": [actions[(i + 1) % 3] for i in range(n)],
        "reward": rng.normal(size=n),
        "not_terminal": (np.arange(n) % 4 != 3).astype(int),
        "time_diff": np.ones(n),
        "possible_actions": [actions] * n,
        "possible_next_actions": [actions[: 1 + i % 3] if i % 4 != 3 else [] for i in range(n)],
    })


def test_batch_preprocessor_matches_jax():
    rng = np.random.default_rng(2)
    df = _table(rng)
    spec = {0: norm.NormalizationParameters("CONTINUOUS", mean=0.5, stddev=2.0),
            2: norm.NormalizationParameters("BINARY")}
    ours = DiscreteDqnBatchPreprocessor(3, Preprocessor(spec), ["a", "b", "c"])(df)
    theirs = JaxBatchPreprocessor(3, JaxPreprocessor(spec), ["a", "b", "c"])(df)
    pairs = {
        "state": (ours.state.float_features, theirs.state.float_features),
        "next_state": (ours.next_state.float_features, theirs.next_state.float_features),
        "mdp_id": (ours.extras.mdp_id, theirs.extras.mdp_id),
        "sequence_number": (ours.extras.sequence_number, theirs.extras.sequence_number),
        "action_probability": (ours.extras.action_probability, theirs.extras.action_probability),
    }
    for f in ("action", "next_action", "reward", "time_diff", "step", "not_terminal",
              "possible_actions_mask", "possible_next_actions_mask"):
        pairs[f] = (getattr(ours, f), getattr(theirs, f))
    for name, (a, b) in pairs.items():
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
    moved = ours.to("cpu")  # .to(device) reaches nested batches
    assert moved.state.float_features.equal(ours.state.float_features)
    assert moved.extras.mdp_id.equal(ours.extras.mdp_id)


def test_minibatches_and_split_match_jax():
    df = _table(np.random.default_rng(3), n=200)
    for seed in (None, 0, 5):
        for bs, drop_last in ((32, True), (64, False)):
            ours = [list(b.index) for b in dm.iterate_minibatches(df, bs, drop_last, seed)]
            theirs = [list(b.index) for b in jdm.iterate_minibatches(df, bs, drop_last, seed)]
            assert ours == theirs
    for cpe in (False, True):
        spec = dm.TableSpec(table_sample=70.0, eval_table_sample=20.0)
        jspec = jdm.TableSpec(table_sample=70.0, eval_table_sample=20.0)
        r = dm.get_sample_range(spec, cpe)
        assert tuple(r) == tuple(jdm.get_sample_range(jspec, cpe))
        for rng_ in r:
            pd.testing.assert_frame_equal(
                dm.split_by_sample_range(df, rng_), jdm.split_by_sample_range(df, rng_))
    with pytest.raises(ValueError, match="table_sample"):
        dm.get_sample_range(dm.TableSpec(table_sample=90.0), True)
