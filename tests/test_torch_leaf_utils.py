"""The leaf utilities against the JAX package: ``FrechetSort`` on JAX's
Gumbel draws, the hyper-parameter searches, ``StepTimer``, ``trace`` and
``annotate``, the TensorBoard logger's buffer, and the pre-KV-cache
Seq2Slate remap followed by ``seq2slate_state_from_flax``.

Tolerances: Frechet permutations identical, log-probs rtol 1e-5 (20 float32
log-softmax heads in each library's order); the searches and the timer's
summary equal (both packages' code is numpy on the same inputs); Seq2Slate
log-probs rtol 1e-5 atol 1e-6, as ``tests/test_checkpoint_compat.py`` holds
JAX's two models.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core.oss_tensorboard_logger import OssTensorboardLogger as JaxLogger
from reagent_tpu.samplers import FrechetSort as JaxFrechetSort
from reagent_tpu.scripts import hparam_tuning as jhp
from reagent_tpu.utils.checkpoint_compat import (
    remap_pre_kv_cache_seq2slate_params as jax_remap,
)
from reagent_tpu.utils.profiling import StepTimer as JaxStepTimer
from reagent_tpu_torch.core.oss_tensorboard_logger import OssTensorboardLogger
from reagent_tpu_torch.samplers import FrechetSort
from reagent_tpu_torch.scripts import hparam_tuning as php
from reagent_tpu_torch.utils.checkpoint_compat import remap_pre_kv_cache_seq2slate_params
from reagent_tpu_torch.utils.interop import seq2slate_state_from_flax
from reagent_tpu_torch.utils.profiling import StepTimer, annotate, trace

B, N = 64, 20
LOG_PROB_TOL = dict(rtol=1e-5, atol=1e-6)
_FIXTURE = os.path.join(os.path.dirname(__file__), "data", "seq2slate_pre_kv_cache.py")


# ------------------------------------------------------------------ Frechet

FRECHET_CASES = {
    "default": dict(),
    "shape 2": dict(shape=2.0),
    "topk 5": dict(topk=5),
    "topk 6, equiv_len 3": dict(topk=6, equiv_len=3),
    "log_scores, shape 0.5": dict(log_scores=True, shape=0.5),
}


def frechet_scores(log_scores, seed=0):
    rng = np.random.default_rng(seed)
    if log_scores:
        return rng.normal(size=(B, N)).astype(np.float32)
    return rng.uniform(0.05, 2.0, (B, N)).astype(np.float32)


@pytest.mark.parametrize("case", list(FRECHET_CASES))
def test_frechet_sample_action_equals_jax_on_its_draws(case):
    kw = FRECHET_CASES[case]
    scores = frechet_scores(kw.get("log_scores", False))
    key = jax.random.PRNGKey(11)
    want = JaxFrechetSort(**kw).sample_action(jnp.asarray(scores), key)
    noise = torch.tensor(np.asarray(jax.random.gumbel(key, (B, N))))
    got = FrechetSort(**kw).sample_action(torch.tensor(scores), noise=noise)
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(want.action))
    np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(want.log_prob), **LOG_PROB_TOL)
    # drawn from a generator: a permutation of each row (its top-k prefix)
    drawn = FrechetSort(**kw).sample_action(torch.tensor(scores),
                                            generator=torch.Generator().manual_seed(0))
    k = kw.get("topk") or N
    assert drawn.action.shape == (B, k)
    assert all(len(set(row)) == k for row in drawn.action.tolist())


def test_frechet_ties_go_to_the_lower_index():
    """Equal perturbed scores: ``jnp.argsort`` is stable, so is the port's."""
    scores = np.ones((3, 6), np.float32)
    zero = jnp.zeros((3, 6))
    want = np.argsort(-np.asarray(jnp.log(scores) + zero), axis=1, kind="stable")
    got = FrechetSort().sample_action(torch.tensor(scores), noise=torch.zeros(3, 6))
    np.testing.assert_array_equal(got.action.numpy(), want)
    np.testing.assert_array_equal(got.action.numpy(), np.tile(np.arange(6), (3, 1)))


def test_frechet_log_prob_padding_and_tensor_override_equal_jax():
    rng = np.random.default_rng(3)
    scores = frechet_scores(False, seed=4)
    perms = np.stack([rng.permutation(N) for _ in range(B)])
    # shorter slates padded with index N (the -inf slot)
    lengths = rng.integers(1, N + 1, B)
    padded = np.where(np.arange(N)[None] < lengths[:, None], perms, N)
    override = rng.integers(0, N + 1, B)
    for kw in ({}, {"shape": 3.0}, {"topk": 8}, {"topk": 8, "equiv_len": 4}):
        j, p = JaxFrechetSort(**kw), FrechetSort(**kw)
        for action in (perms, padded):
            np.testing.assert_allclose(
                p.log_prob(torch.tensor(scores), torch.tensor(action)).numpy(),
                np.asarray(j.log_prob(jnp.asarray(scores), jnp.asarray(action))),
                **LOG_PROB_TOL)
            np.testing.assert_allclose(
                p.log_prob(torch.tensor(scores), torch.tensor(action),
                           equiv_len_override=torch.tensor(override)).numpy(),
                np.asarray(j.log_prob(jnp.asarray(scores), jnp.asarray(action),
                                      equiv_len_override=jnp.asarray(override))),
                **LOG_PROB_TOL)
    # one slate (1-D) and an int override
    j, p = JaxFrechetSort(), FrechetSort()
    np.testing.assert_allclose(
        p.log_prob(torch.tensor(scores[0]), torch.tensor(perms[0]), equiv_len_override=5),
        np.asarray(j.log_prob(jnp.asarray(scores[0]), jnp.asarray(perms[0]),
                              equiv_len_override=5)), **LOG_PROB_TOL)


def test_frechet_equiv_len_cannot_exceed_topk():
    with pytest.raises(ValueError, match="cannot exceed"):
        FrechetSort(topk=2, equiv_len=3)


# ------------------------------------------------------ hyper-parameter search


def eval_fn(p):
    """Deterministic in the config and the seed."""
    lr, layers = p["lr"], p.get("layers", 2)
    return {"score": float(-(np.log10(lr) + 2.5) ** 2 - 0.1 * (layers - 3) ** 2
                           + 0.01 * np.sin(p["seed"])),
            "cost": float(layers * 10 + p["seed"])}


def parse(p):
    return dict(p, lr=float(p["lr"]))


@pytest.mark.parametrize("num_proc", [1, 4])
def test_hparam_searches_equal_jax(num_proc):
    params = [{"lr": 1e-3, "layers": 2}, {"lr": 1e-2, "layers": 4}]
    fixed = {"extra": 1}
    assert (php.evaluate_params(params, fixed, eval_fn, parse, num_seeds=3, num_proc=num_proc)
            == jhp.evaluate_params(params, fixed, eval_fn, parse, num_seeds=3,
                                   num_proc=num_proc))
    grid = {"lr": [1e-4, 1e-3, 1e-2], "layers": [2, 3]}
    for minimize, objective in ((False, "score"), (True, "cost")):
        assert (php.grid_search(grid, eval_fn, objective, num_seeds=2, minimize=minimize,
                                num_proc=num_proc)
                == jhp.grid_search(grid, eval_fn, objective, num_seeds=2, minimize=minimize,
                                   num_proc=num_proc))
    space = [{"name": "lr", "type": "range", "bounds": [1e-4, 1e-1]},
             {"name": "layers", "type": "choice", "values": [1, 2, 3, 4]}]
    kw = dict(num_iterations=8, num_random_init=3, num_seeds=2, num_proc=num_proc,
              num_candidates=64, seed=5)
    got = php.bayesian_search(space, eval_fn, "score", **kw)
    assert got == jhp.bayesian_search(space, eval_fn, "score", **kw)
    assert got[0]["layers"] in (1, 2, 3, 4)


# -------------------------------------------------------------- profiling


def test_step_timer_summary_equals_jax():
    times = [0.5, 0.010, 0.012, 0.011, 0.030, 0.009]
    ours, theirs = StepTimer(), JaxStepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    ours.times, theirs.times = [0.25], [0.25]  # one step: nothing dropped
    assert ours.summary() == theirs.summary()


def test_step_timer_measures_and_blocks():
    timer = StepTimer()
    box = {}
    for _ in range(3):
        with timer.measure(box):
            box["y"] = torch.ones(64, 64) @ torch.ones(64, 64)
    assert len(timer.times) == 3 and all(t >= 0 for t in timer.times)
    assert set(timer.summary()) == {"mean_s", "p50_s", "p99_s", "steps_per_s"}


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with trace(str(tmp_path)):
        with annotate("leaf_utils_region"):
            torch.relu(torch.randn(32, 32) @ torch.randn(32, 32))
    path = tmp_path / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "leaf_utils_region" for e in events)


# ----------------------------------------------------------------- logger


@pytest.mark.parametrize("with_writer", [False, True])
def test_logger_buffer_equals_jax(tmp_path, with_writer):
    if with_writer and importlib.util.find_spec("tensorboardX") is None:
        pytest.skip("tensorboardX is not installed")
    dirs = ((str(tmp_path / "ours"), str(tmp_path / "theirs")) if with_writer
            else (None, None))
    ours, theirs = OssTensorboardLogger(dirs[0]), JaxLogger(dirs[1])
    for step in range(4):
        metrics = {"td_loss": np.float32(1.0 / (step + 1)), "reward": step * 2}
        ours.log_metrics(metrics, step)
        theirs.log_metrics(metrics, step)
    assert ours.get_logger_data() == theirs.get_logger_data()
    ours.close()
    theirs.close()
    if with_writer:
        assert os.listdir(dirs[0])


# ---------------------------------------------------- the Seq2Slate remap


def _load_old_module():
    import sys

    spec = importlib.util.spec_from_file_location("old_seq2slate", _FIXTURE)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["old_seq2slate"] = mod  # flax dataclasses resolve cls.__module__
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_pre_kv_cache_remap_equals_jax_and_scores_like_jax():
    from reagent_tpu.models import seq2slate as J
    from reagent_tpu_torch.models import seq2slate as P

    old = _load_old_module()
    cfg = dict(state_dim=5, candidate_dim=7, num_stacked_layers=2, num_heads=2, dim_model=16,
               dim_feedforward=32, max_src_seq_len=6, max_tgt_seq_len=4)
    g = np.random.default_rng(0)
    Bs, S, T = 3, cfg["max_src_seq_len"], cfg["max_tgt_seq_len"]
    state = g.normal(size=(Bs, cfg["state_dim"])).astype(np.float32)
    src = g.normal(size=(Bs, S, cfg["candidate_dim"])).astype(np.float32)
    tgt_out = np.stack([g.permutation(S)[:T] + 2 for _ in range(Bs)]).astype(np.int64)
    tgt_in = np.concatenate([np.ones((Bs, 1), np.int64), tgt_out[:, :-1]], 1)
    cand = np.concatenate([np.zeros((Bs, 2, cfg["candidate_dim"]), np.float32), src], axis=1)
    tgt_in_seq = np.take_along_axis(cand, tgt_in[:, :, None], axis=1)
    kwargs = dict(state=jnp.asarray(state), src_seq=jnp.asarray(src),
                  tgt_in_seq=jnp.asarray(tgt_in_seq), tgt_in_idx=jnp.asarray(tgt_in, jnp.int32),
                  tgt_out_idx=jnp.asarray(tgt_out, jnp.int32))
    old_model = old.Seq2SlateTransformerModel(
        **cfg, output_arch=old.Seq2SlateOutputArch.AUTOREGRESSIVE)
    old_params = old_model.init(jax.random.PRNGKey(0),
                                old.Seq2SlateMode.PER_SEQ_LOG_PROB_MODE.value, **kwargs)
    old_np = jax.tree_util.tree_map(np.asarray, old_params)

    theirs = jax_remap(jax.tree_util.tree_map(lambda x: x, old_params))
    ours = remap_pre_kv_cache_seq2slate_params(old_np)
    f_ours, f_theirs = _flat(ours), _flat(jax.tree_util.tree_map(np.asarray, theirs))
    assert sorted(f_ours) == sorted(f_theirs)
    for k, v in f_theirs.items():
        np.testing.assert_array_equal(f_ours[k], v, err_msg="/".join(k))

    want = J.Seq2SlateTransformerModel(
        **cfg, output_arch=J.Seq2SlateOutputArch.AUTOREGRESSIVE).apply(
        theirs, J.Seq2SlateMode.PER_SEQ_LOG_PROB_MODE.value, **kwargs).per_seq_log_probs
    model = P.Seq2SlateTransformerModel(**cfg, output_arch=P.Seq2SlateOutputArch.AUTOREGRESSIVE)
    res = model.load_state_dict(seq2slate_state_from_flax(ours), strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith("encoder_scorer") for k in res.missing_keys), res.missing_keys
    with torch.no_grad():
        got = model(P.Seq2SlateMode.PER_SEQ_LOG_PROB_MODE, torch.tensor(state),
                    torch.tensor(src), tgt_in_idx=torch.tensor(tgt_in),
                    tgt_out_idx=torch.tensor(tgt_out),
                    tgt_in_seq=torch.tensor(tgt_in_seq)).per_seq_log_probs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOG_PROB_TOL)
