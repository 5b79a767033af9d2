"""SlateQ against the JAX package: ``DocList`` and the ``FeatureData``
ranking helpers, ``make_slate_q_batch`` on the golden transitions of
``tests/test_batch_makers_golden.py:129-212`` through both packages' replay
buffers, the dispatch, ``slate_q_scorer`` (tied values included) and
``SlateQTrainer`` in 5-step lockstep with JAX's from its init for the five
RecSim variants and a tied max-Q case, the ``SlateQ`` manager, and the
port's RecSim collector and batch.

Inputs come from numpy seeds and go to both packages; weights and Adam
states are JAX's, carried through ``reagent_tpu_torch.utils.interop``.
Tolerances, float32 on two libraries: forwards rtol 1e-5 atol 1e-6; each
lockstep step's metrics, parameters, targets and second moments rtol 1e-5
atol 1e-6, first moments atol 1e-7; the batch maker and the top-k indices
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reagent_tpu_torch.model_managers  # noqa: F401 — registers the managers
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.gym.policies.scorers import slate_q_scorer as jax_slate_q_scorer
from reagent_tpu.gym.preprocessors import make_slate_q_batch as jax_make_slate_q_batch
from reagent_tpu.models.critic import FullyConnectedCritic as JaxCritic
from reagent_tpu.replay import ReplayBuffer as JaxReplayBuffer
from reagent_tpu.training.slate_q_trainer import (
    NextSlateValueNormMethod as JaxNorm,
)
from reagent_tpu.training.slate_q_trainer import SlateQTrainer as JaxSlateQTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.core.registry import MODEL_MANAGERS
from reagent_tpu_torch.gym import slate_q_recsim as sq
from reagent_tpu_torch.gym.envs.recsim import RecSimInterestEvolution
from reagent_tpu_torch.gym.policies import slate_q_scorer
from reagent_tpu_torch.gym.preprocessors import make_slate_q_batch, make_trainer_preprocessor
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.ops import fused_mlp
from reagent_tpu_torch.replay import ReplayBuffer
from reagent_tpu_torch.training.slate_q_trainer import (
    NextSlateValueNormMethod,
    SlateQTrainer,
    stable_top_k,
)
from reagent_tpu_torch.utils.interop import (
    q_network_state_from_flax,
    slate_q_state_from_arrays,
)
from test_torch_qrdqn import _adam_fields, _np_tree
from test_torch_parametric_dqn import _opt

SD, CDIM, C, S, B = 4, 3, 5, 2, 32
TOL = dict(rtol=1e-5, atol=1e-6)
M1_TOL = dict(rtol=1e-5, atol=1e-7)


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, equal_nan=False,
                               **tol)


# ------------------------------------------------------------------- types

def test_doclist_and_ranking_state_match_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, C, CDIM)).astype(np.float32)
    mask = (rng.random((3, C)) > 0.3).astype(np.float32)
    value = rng.normal(size=(3, C)).astype(np.float32)
    user = rng.normal(size=(3, SD)).astype(np.float32)
    action = rng.integers(0, C, (3, S))
    docs = rlt.DocList(torch.tensor(feats), torch.tensor(mask), torch.tensor(value))
    jdocs = jrlt.DocList(jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(value))
    got, want = docs.select_slate(torch.tensor(action)), jdocs.select_slate(jnp.asarray(action))
    for name in ("float_features", "mask", "value"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(docs.as_feature_data().float_features.numpy(),
                                  np.asarray(jdocs.as_feature_data().float_features))
    fd = rlt.FeatureData(torch.tensor(user), candidate_docs=docs)
    jfd = jrlt.FeatureData(jnp.asarray(user), candidate_docs=jdocs)
    for has_user in (True, False):
        np.testing.assert_array_equal(fd.get_ranking_state(has_user).numpy(),
                                      np.asarray(jfd.get_ranking_state(has_user)))
    assert not fd.has_float_features_only
    assert rlt.FeatureData(torch.tensor(user)).has_float_features_only


# ------------------------------------------------------------- batch maker

def _golden_buffers():
    """The golden test's 4 slate transitions in both packages' buffers."""
    docs = [np.full((4, 3), i, np.float32) for i in range(4)]
    values = [np.arange(4, dtype=np.float32) + i for i in range(4)]
    slates = [np.asarray([i % 4, (i + 1) % 4], np.int64) for i in range(4)]
    pos_rew = [np.asarray([i, 0.0], np.float32) for i in range(4)]
    clicks = [np.asarray([1.0, 0.0], np.float32) for i in range(4)]
    kw = dict(replay_capacity=6, update_horizon=1, gamma=0.99)
    jrb, rb = JaxReplayBuffer(**kw), ReplayBuffer(**kw, device="cpu")
    example = dict(observation=np.zeros(3, np.float32), action=np.zeros(2, np.int32),
                   reward=np.float32(0), terminal=np.bool_(False), doc=docs[0],
                   doc_value=values[0], position_reward=pos_rew[0], response_click=clicks[0])
    jstate = jrb.init(**{k: jnp.asarray(v) for k, v in example.items()})
    state = rb.init(**{k: torch.as_tensor(v) for k, v in example.items()})
    for i in range(4):
        t = dict(observation=np.full(3, float(i), np.float32),
                 action=slates[i].astype(np.int32), reward=np.float32(pos_rew[i].sum()),
                 terminal=np.bool_(i == 3), doc=docs[i], doc_value=values[i],
                 position_reward=pos_rew[i], response_click=clicks[i])
        jstate = jrb.add(jstate, **{k: jnp.asarray(v) for k, v in t.items()})
        state = rb.add(state, **{k: torch.as_tensor(v) for k, v in t.items()})
    return (jrb, jstate), (rb, state), slates


def _flat(batch):
    out = {}
    for name, v in vars(batch).items():
        if isinstance(v, (jrlt.FeatureData, rlt.FeatureData)):
            out[name] = np.asarray(v.float_features)
            d = v.candidate_docs
            out.update({f"{name}.docs.{k}": np.asarray(getattr(d, k))
                        for k in ("float_features", "mask", "value")})
        elif v is not None and hasattr(v, "shape"):
            out[name] = np.asarray(v)
    return out


def test_slate_q_batch_maker_matches_jax_golden():
    """Index 1 of the golden buffer, and indices 0 and 1, through both
    packages' ``make_slate_q_batch``: every field equal, the golden values
    asserted as ``test_batch_makers_golden.py`` does."""
    (jrb, jstate), (rb, state), slates = _golden_buffers()
    for idx in ([1], [0, 1]):
        jb = jax_make_slate_q_batch(jrb.sample(jstate, jax.random.PRNGKey(0), len(idx),
                                               indices=jnp.asarray(idx, jnp.int32)))
        b = make_slate_q_batch(rb.sample(state, indices=torch.tensor(idx)))
        want, got = _flat(jb), {k: v.numpy() if hasattr(v, "numpy") else v
                                for k, v in _flat(b).items()}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    b = make_slate_q_batch(rb.sample(state, indices=torch.tensor([1])))
    np.testing.assert_array_equal(b.action.numpy(), [slates[1]])
    np.testing.assert_array_equal(b.next_action.numpy(), [slates[2]])
    np.testing.assert_array_equal(b.reward_mask.numpy(), [[True, False]])
    np.testing.assert_array_equal(b.not_terminal.numpy(), [[1.0]])
    trainer = SlateQTrainer(FullyConnectedCritic(3, 3, [8], ["relu"]), slate_size=2,
                            device="cpu")
    assert make_trainer_preprocessor(trainer) is make_slate_q_batch
    ts, m = trainer.train_step(trainer.init(torch.Generator().manual_seed(0)),
                               make_slate_q_batch(rb.sample(state, indices=torch.tensor([0, 1]))))
    assert np.isfinite(m["td_loss"].item())


# ----------------------------------------------------------------- scorer

def _critics():
    jnet = JaxCritic(state_dim=SD, action_dim=CDIM, sizes=[16, 8],
                     activations=["leaky_relu", "leaky_relu"])
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, SD)), jnp.zeros((1, CDIM)))
    net = FullyConnectedCritic(SD, CDIM, [16, 8], ["leaky_relu", "leaky_relu"])
    return jnet, params, net, q_network_state_from_flax(_np_tree(params))


def test_slate_q_scorer_matches_jax_with_tied_values():
    """p(select) * Q per candidate from JAX's weights: the port scores the
    tiled [B * C, SD + CDIM] rows through ``functional.score`` (K3's plain
    version on the CPU, counted once); equal doc values tie the choice
    model, and the stable top-k keeps JAX's order."""
    jnet, params, net, sd = _critics()
    rng = np.random.default_rng(1)
    user = rng.normal(size=(6, SD)).astype(np.float32)
    feats = rng.normal(size=(6, C, CDIM)).astype(np.float32)
    value = rng.normal(size=(6, C)).astype(np.float32)
    value[0] = 0.5
    feats[1] = feats[1, :1]  # every doc the same: all scores tie
    value[1] = 0.0
    jstate = jrlt.FeatureData(jnp.asarray(user), candidate_docs=jrlt.DocList(
        jnp.asarray(feats), value=jnp.asarray(value)))
    state = rlt.FeatureData(torch.tensor(user), candidate_docs=rlt.DocList(
        torch.tensor(feats), value=torch.tensor(value)))
    want = jax_slate_q_scorer(C, jnet)(params, jstate)
    before = fused_mlp.fused_mlp_forward_reference.calls
    got = slate_q_scorer(C, net)(sd, state)
    assert fused_mlp.fused_mlp_forward_reference.calls == before + 1
    _close(got, want)
    np.testing.assert_array_equal(stable_top_k(got, S).numpy(),
                                  np.asarray(jax.lax.top_k(want, S)[1]))
    np.testing.assert_array_equal(stable_top_k(got, S)[1].numpy(), [0, 1])


# ---------------------------------------------------------- SlateQTrainer

CASES = {
    "base": (True, {}),
    "maxq_topk": (True, {"rl": dict(maxq_learning=True)}),
    "multi_selection": (False, {"norm": "NORM_BY_NEXT_SLATE_SIZE"}),
    "multi_selection_avg_curr": (False, {"norm": "NORM_BY_CURRENT_SLATE_SIZE"}),
    "with_time_scale": (True, {"discount_time_scale": 2.0}),
    "maxq_topk_ties": (True, {"rl": dict(maxq_learning=True), "ties": True}),
}


def _slate_batches(seed, n, ties=False):
    """Batches with terminal rows, masked candidates (the slate-size
    normalisation), clicks on some positions only and time gaps; with
    ``ties`` the next state's docs and values repeat inside each row, so the
    max-Q top-k picks among equal target scores."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        nf = rng.normal(size=(B, C, CDIM)).astype(np.float32)
        nv = rng.normal(size=(B, C)).astype(np.float32)
        if ties:
            nf[:] = nf[:, :1]
            nv[:] = nv[:, :1]
        mask = (rng.random((B, C)) > 0.2).astype(np.float32)
        nmask = (rng.random((B, C)) > 0.2).astype(np.float32)
        mask[:, 0] = nmask[:, 0] = 1.0  # no row without a candidate
        mask[0, 1:] = 0.0
        if ties:
            nmask[:] = 1.0
        nt = (rng.random((B, 1)) > 0.2).astype(np.float32)
        nt[1] = 0.0
        yield dict(
            s=rng.normal(size=(B, SD)).astype(np.float32),
            ns=rng.normal(size=(B, SD)).astype(np.float32),
            f=rng.normal(size=(B, C, CDIM)).astype(np.float32), nf=nf,
            v=rng.normal(size=(B, C)).astype(np.float32), nv=nv, mask=mask,
            nmask=nmask,
            a=np.stack([rng.permutation(C)[:S] for _ in range(B)]).astype(np.int32),
            na=np.stack([rng.permutation(C)[:S] for _ in range(B)]).astype(np.int32),
            r=rng.uniform(0, 4, (B, S)).astype(np.float32),
            click=rng.random((B, S)) > 0.5,
            td=rng.integers(1, 4, (B, 1)).astype(np.float32), nt=nt)


def _slate_batch(mod, conv, b):
    def docs(f, v, m):
        return mod.DocList(float_features=conv(b[f]), mask=conv(b[m]), value=conv(b[v]))

    return mod.SlateQInput(
        state=mod.FeatureData(float_features=conv(b["s"]), candidate_docs=docs("f", "v", "mask")),
        next_state=mod.FeatureData(float_features=conv(b["ns"]),
                                   candidate_docs=docs("nf", "nv", "nmask")),
        action=conv(b["a"]), next_action=conv(b["na"]), reward=conv(b["r"]),
        reward_mask=conv(b["click"]), time_diff=conv(b["td"]), step=None,
        not_terminal=conv(b["nt"]))


def slate_q_trainers(case, device="cpu"):
    single, spec = CASES[case]
    spec = dict(spec)
    rl_kw = dict(gamma=0.9, target_update_rate=0.1, **spec.pop("rl", {}))
    kw = dict(slate_size=S, optimizer={"Adam": {"lr": 0.003}}, single_selection=single,
              discount_time_scale=spec.get("discount_time_scale"), emit_reporter_arrays=True)
    norm = spec.get("norm", "NORM_BY_CURRENT_SLATE_SIZE")
    jnet, params, net, _ = _critics()
    jtrainer = JaxSlateQTrainer(q_network=jnet, rl=JaxRLParameters(**rl_kw),
                                next_slate_value_norm_method=JaxNorm[norm], **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, SD)), jnp.zeros((1, CDIM)))
    trainer = SlateQTrainer(net, rl=RLParameters(**rl_kw),
                            next_slate_value_norm_method=NextSlateValueNormMethod[norm],
                            device=device, **kw)
    return jtrainer, jstate, trainer, spec.get("ties", False)


def carry_slate_q_state(jstate, device="cpu"):
    return slate_q_state_from_arrays(
        _np_tree(jstate.q_params), _np_tree(jstate.q_target_params),
        _opt(jstate.opt_state, device), np.asarray(jstate.step), device)


def assert_slate_q_state_close(state, jstate, msg=""):
    for name in ("q_params", "q_target_params"):
        want = q_network_state_from_flax(_np_tree(getattr(jstate, name)))
        got = getattr(state, name)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], TOL, f"{msg} {name} {k}")
    theirs = _adam_fields(jstate.opt_state)
    assert int(state.opt_state.count) == int(theirs["count"])
    for field, tol in (("mu", M1_TOL), ("nu", TOL)):
        want = q_network_state_from_flax(theirs[field])
        for k, v in getattr(state.opt_state, field).items():
            _close(v, want[k], tol, f"{msg} {field} {k}")
    assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("case", list(CASES))
def test_slate_q_trainer_lockstep_with_jax(case):
    """5 steps from JAX's init, the two packages' states evolving apart:
    every metric (the reporter's ``logged_rewards`` included) and the
    parameters, targets and Adam moments after each step."""
    jtrainer, jstate, trainer, ties = slate_q_trainers(case)
    state = carry_slate_q_state(jstate)
    for i, b in enumerate(_slate_batches(2, 5, ties)):
        jb = _slate_batch(jrlt, jnp.asarray, b)
        if case.startswith("maxq"):
            want = np.asarray(jtrainer._maxq_topk_next_action(jstate, jb.next_state))
            got = trainer._maxq_topk_next_action(state, _slate_batch(rlt, torch.tensor, b).next_state)
            np.testing.assert_array_equal(got.numpy(), want)
            if ties:
                np.testing.assert_array_equal(got.numpy(), np.tile(np.arange(S), (B, 1)))
        before = {k: v.clone() for k, v in state.q_params.items()}
        jstate, jm = jtrainer.train_step(jstate, jb)
        new_state, m = trainer.train_step(state, _slate_batch(rlt, torch.tensor, b))
        assert m.keys() == jm.keys() == {"td_loss", "q_mean", "logged_rewards"}
        for key in jm:
            _close(m[key], jm[key], TOL, f"step {i} {key}")
        assert_slate_q_state_close(new_state, jstate, f"step {i}")
        assert all(torch.equal(before[k], v) for k, v in state.q_params.items())
        state = new_state


def test_slate_q_manager_builds_the_reference_trainer():
    """``SlateQ`` from its config: the [64, 64] leaky_relu critic over the
    state and item widths, the reporter's arrays on, the RL and optimizer
    options through."""
    manager = MODEL_MANAGERS.build({"SlateQ": {
        "slate_size": 3, "num_candidates": 10,
        "trainer_param": {"rl": {"gamma": 0.9, "target_update_rate": 0.1,
                                 "maxq_learning": True},
                          "optimizer": {"Adam": {"lr": 0.001}}, "single_selection": False},
        "net_builder": {"FullyConnected": {"sizes": [64, 64],
                                           "activations": ["leaky_relu", "leaky_relu"]}}}})
    trainer = manager.build_trainer(state_dim=20, candidate_dim=21, device="cpu")
    assert isinstance(trainer, SlateQTrainer)
    assert trainer.emit_reporter_arrays and trainer.maxq_learning and not trainer.single_selection
    assert [l.weight.shape[1] for l in trainer.q_network.net.layers] == [41, 64, 64]
    state = manager.init_trainer_state(trainer, torch.Generator().manual_seed(0))
    assert int(state.step) == 0
    assert type(manager.get_reporter()).__name__ == "SlateQReporter"
    with pytest.raises(ValueError):
        MODEL_MANAGERS.build({"SlateQ": {"slate_size": -1}})


# ------------------------------------------------------- the RecSim job

def test_recsim_collector_batch_and_short_job():
    """Two episodes at epsilon 1 and one greedy: the collector's act steps
    each one scorer call (one K3 plain call on the CPU), transitions end at
    the env's done, the batch's masks credit the clicked position (one
    click) or all (many); a cut job trains and evaluates."""
    for single in (True, False):
        env = RecSimInterestEvolution(single_selection=single, device="cpu")
        trainer = sq.make_trainer("base", single, {}, "cpu")
        ts = trainer.init(torch.Generator().manual_seed(0))
        collector = sq.SlateQCollector(env, trainer.q_network)
        gen = torch.Generator().manual_seed(5)
        before = fused_mlp.fused_mlp_forward_reference.calls
        recs = collector.collect(ts.q_params, 1.0, 2, gen)
        n = recs["reward"].shape[0]
        assert collector.act_steps == n and fused_mlp.fused_mlp_forward_reference.calls == before + n
        assert float(recs["not_terminal"][-1]) == 0.0
        assert recs["not_terminal"].sum() == n - 2
        np.testing.assert_allclose(recs["episode_return"].sum().item(), recs["reward"].sum().item(),
                                   rtol=1e-5)
        batch = sq.batchify(env, recs)
        if single:
            clicked = recs["clicked_pos"]
            assert torch.equal(batch.reward_mask.sum(dim=1), (clicked >= 0).to(torch.int64))
        else:
            assert bool(batch.reward_mask.all())
        ts, m = trainer.train_step(ts, sq.subsample(batch, torch.arange(8)))
        assert np.isfinite(m["td_loss"].item())
    r = sq.train_and_eval("maxq_topk", True, dict(sq.VARIANTS[1][2]), "cpu", episodes=3,
                          train_steps=5, eval_episodes=1, epsilons=(1.0,))
    assert np.isfinite(r["mean_return"]) and r["eval_act_steps"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("name,single,kwargs", sq.VARIANTS, ids=[v[0] for v in sq.VARIANTS])
def test_slate_q_recsim_full_job_on_cpu(name, single, kwargs):
    """The full protocol on the CPU from the seed-0 init; the score is
    printed beside the bar of 154 (a bar depends on the draws: the card's
    runs in ``tools/ranking_jobs.py`` record it)."""
    r = sq.train_and_eval(name, single, kwargs, "cpu")
    print(f"slate-Q {name}: mean return {r['mean_return']:.2f} (bar {r['bar']})")
    assert np.isfinite(r["mean_return"])
