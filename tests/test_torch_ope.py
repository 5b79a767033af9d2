"""The off-policy-estimation slice's numpy side against the JAX package on
the CPU: every bandit, sequential and slate estimator, the types, utils and
datasets, both EDP adapters, the gridworld and tabular trainers, the sklearn
trainers, the three file loaders and the harnesses, each from the same
numpy-made inputs with ``np.random`` seeded alike; and the DQN artifact's
refusal of activations the C++ scorer cannot apply."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from reagent_tpu.evaluation.evaluation_data_page import EvaluationDataPage as JaxEDP
from reagent_tpu.evaluation.ope_adapter import OPEstimatorAdapter as JaxAdapter
from reagent_tpu.evaluation.ope_adapter import SequentialOPEstimatorAdapter as JaxSeqAdapter
from reagent_tpu.ope import datasets as jax_datasets
from reagent_tpu.ope import utils as jax_utils
from reagent_tpu.ope.estimators import contextual_bandits_estimators as jax_cb
from reagent_tpu.ope.estimators import estimator as jax_estimator
from reagent_tpu.ope.estimators import sequential_estimators as jax_seq
from reagent_tpu.ope.estimators import slate_estimators as jax_slate
from reagent_tpu.ope.estimators import types as jax_types
from reagent_tpu.ope.test import gridworld as jax_gridworld
from reagent_tpu.ope.test import multiclass_bandits as jax_multiclass
from reagent_tpu.ope.test import slate_benchmark as jax_slate_bench
from reagent_tpu.ope.test import web_search as jax_web
from reagent_tpu.ope.trainers import linear_trainers as jax_linear
from reagent_tpu.ope.trainers import rl_tabular_trainers as jax_tabular
from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage
from reagent_tpu_torch.evaluation.ope_adapter import (
    OPEstimatorAdapter,
    SequentialOPEstimatorAdapter,
)
from reagent_tpu_torch.ope import datasets, utils
from reagent_tpu_torch.ope.estimators import contextual_bandits_estimators as cb
from reagent_tpu_torch.ope.estimators import estimator
from reagent_tpu_torch.ope.estimators import sequential_estimators as seq
from reagent_tpu_torch.ope.estimators import slate_estimators as slate
from reagent_tpu_torch.ope.estimators import types
from reagent_tpu_torch.ope.test import gridworld, multiclass_bandits, slate_benchmark, web_search
from reagent_tpu_torch.ope.trainers import linear_trainers, rl_tabular_trainers as tabular

DATA = os.path.join(os.path.dirname(__file__), "data")
REL = 1e-6


def _same_result(got, want, rel=REL):
    """Every field of two ``EstimatorResult``s within ``rel``."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for k in g:
        if w[k] is None:
            assert g[k] is None, k
        else:
            assert g[k] == pytest.approx(w[k], rel=rel, abs=1e-12), k


# ------------------------------------------------------------------ bandits


def _bandit_arrays(N=600, A=3, seed=0, no_action=True):
    rng = np.random.default_rng(seed)
    log_p = rng.dirichlet(np.ones(A), size=N)
    log_p[:5, 0] = 0.0  # zero logged propensities
    log_p /= log_p.sum(1, keepdims=True)
    actions = np.array([rng.choice(A, p=p) for p in log_p])
    if no_action:
        actions[::37] = -1  # no logged action
    return dict(
        log_action=actions,
        log_reward=rng.uniform(size=N),
        log_propensities=log_p,
        tgt_propensities=rng.dirichlet(np.ones(A), size=N),
        dm_rewards=rng.uniform(size=(N, A)),
        ground_truth_reward=0.5,
    )


BANDIT_CASES = {
    "DM": lambda m: m.DMEstimator(),
    "IPS": lambda m: m.IPSEstimator(),
    "IPS_clamped_weighted": lambda m: m.IPSEstimator(clamp_max=3.0, weighted=True),
    "DR": lambda m: m.DoublyRobustEstimator(),
    "DR_clamped": lambda m: m.DoublyRobustEstimator(clamp_max=2.0),
    "Switch": lambda m: m.SwitchEstimator(),
    "Switch_rmax": lambda m: m.SwitchEstimator(rmax=1.0, clamp_max=5.0),
    "SwitchDR": lambda m: m.SwitchDREstimator(),
}


@pytest.mark.parametrize("name", sorted(BANDIT_CASES))
@pytest.mark.parametrize("logged_model_rewards", [False, True])
def test_bandit_estimators_match_jax(name, logged_model_rewards):
    arrays = _bandit_arrays()
    if logged_model_rewards:
        arrays["dm_rewards_for_logged_action"] = np.random.default_rng(9).uniform(size=600)
    for kw in ({}, {"exp_base": 1.2, "candidates": 7}):
        want = BANDIT_CASES[name](jax_cb).evaluate(jax_cb.BanditsEstimatorInput(**arrays), **kw)
        got = BANDIT_CASES[name](cb).evaluate(cb.BanditsEstimatorInput(**arrays), **kw)
        _same_result(got, want)
    # a generator threaded through for the bootstrap
    want = BANDIT_CASES[name](jax_cb).evaluate(jax_cb.BanditsEstimatorInput(**arrays),
                                               rng=np.random.default_rng(5))
    got = BANDIT_CASES[name](cb).evaluate(cb.BanditsEstimatorInput(**arrays),
                                          rng=np.random.default_rng(5))
    _same_result(got, want)


def test_bandit_estimators_below_four_samples_and_all_zero_weights():
    arrays = _bandit_arrays(N=3, no_action=False)
    for name in BANDIT_CASES:
        _same_result(BANDIT_CASES[name](cb).evaluate(cb.BanditsEstimatorInput(**arrays)),
                     BANDIT_CASES[name](jax_cb).evaluate(jax_cb.BanditsEstimatorInput(**arrays)))
    arrays = _bandit_arrays(N=40)
    arrays["tgt_propensities"] = np.zeros_like(arrays["tgt_propensities"])
    _same_result(cb.IPSEstimator(weighted=True).evaluate(cb.BanditsEstimatorInput(**arrays)),
                 jax_cb.IPSEstimator(weighted=True).evaluate(
                     jax_cb.BanditsEstimatorInput(**arrays)))


def test_evaluator_and_report_match_jax():
    exps = [_bandit_arrays(N=300, seed=s) for s in range(3)]
    want = jax_estimator.Evaluator(
        [([jax_cb.DMEstimator(), jax_cb.IPSEstimator()], jax_cb.BanditsEstimatorInput(**a))
         for a in exps], max_workers=1).evaluate()
    got = estimator.Evaluator(
        [([cb.DMEstimator(), cb.IPSEstimator()], cb.BanditsEstimatorInput(**a))
         for a in exps], max_workers=1).evaluate()
    assert set(got) == set(want) == {"DMEstimator", "IPSEstimator"}
    for k in got:
        np.testing.assert_allclose(got[k].report(), want[k].report(), rtol=REL)
    results = estimator.EstimatorResults()
    results.append(estimator.EstimatorResult(log_reward=0.0, estimated_reward=float("nan")))
    assert results.report() == (0.0, 0.0, 0.0)


# --------------------------------------------------------------- sequential


def _rl_arrays(N=60, T=9, A=3, seed=1, states=True):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, T + 1, size=N)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(float)
    log_p = rng.dirichlet(np.ones(A), size=(N, T))
    actions = np.array([[rng.choice(A, p=p) for p in row] for row in log_p])
    return dict(
        gamma=0.9,
        actions=actions,
        rewards=rng.uniform(size=(N, T)) * mask,
        log_propensities=log_p[np.arange(N)[:, None], np.arange(T)[None, :], actions],
        tgt_propensities=rng.dirichlet(np.ones(A), size=(N, T)),
        mask=mask,
        q_values=rng.uniform(size=(N, T, A)),
        states=rng.normal(size=(N, T, 4)) if states else None,
        ground_truth_reward=1.5,
    )


SEQ_CASES = {
    "DM": lambda m: m.DMEstimator(),
    "IPS": lambda m: m.IPSEstimator(),
    "IPS_unnormalized": lambda m: m.IPSEstimator(self_normalize=False),
    "DR": lambda m: m.DoublyRobustEstimator(),
    "DR_unnormalized": lambda m: m.DoublyRobustEstimator(self_normalize=False),
}


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
@pytest.mark.parametrize("absorbing", [False, True])
def test_sequential_estimators_match_jax(name, absorbing):
    arrays = _rl_arrays()
    jin, pin = jax_seq.RLEstimatorInput(**arrays), seq.RLEstimatorInput(**arrays)
    if absorbing:
        jin, pin = jin.with_absorbing_padding(), pin.with_absorbing_padding()
    _same_result(SEQ_CASES[name](seq).evaluate(pin), SEQ_CASES[name](jax_seq).evaluate(jin))
    np.testing.assert_allclose(pin.cum_importance_weights(False),
                               jin.cum_importance_weights(False), rtol=REL)


def test_magic_matches_jax():
    """MAGIC through the port's WSDR estimator and evaluation page, within
    rel 2e-5 (as tests/test_torch_cpe.py holds it); np.random seeded alike
    for its bootstrap."""
    arrays = _rl_arrays(N=120, T=10)
    np.random.seed(0)
    want = jax_seq.MAGICEstimator(num_j_steps=6).evaluate(jax_seq.RLEstimatorInput(**arrays))
    np.random.seed(0)
    got = seq.MAGICEstimator(num_j_steps=6).evaluate(seq.RLEstimatorInput(**arrays))
    assert got.estimated_reward == pytest.approx(want.estimated_reward, rel=2e-5)
    assert got.estimated_reward_std_error == pytest.approx(want.estimated_reward_std_error,
                                                           rel=2e-5)
    assert got.log_reward == pytest.approx(want.log_reward, rel=REL)


# -------------------------------------------------------------------- slates


def _slate_arrays(N=300, K=3, M=5, seed=2):
    rng = np.random.default_rng(seed)
    log_p = rng.dirichlet(np.ones(M), size=(N, K))
    return dict(
        log_slate=np.stack([rng.permutation(M)[:K] for _ in range(N)]),
        log_reward=rng.uniform(size=N),
        log_item_probs=log_p,
        tgt_item_probs=rng.dirichlet(np.ones(M), size=(N, K)),
        position_weights=1.0 / np.log2(np.arange(K) + 2),
        item_rewards=rng.uniform(size=(N, K, M)),
        ground_truth_reward=0.7,
    )


SLATE_CASES = {
    "DM": lambda m: m.DMEstimator(),
    "IPS": lambda m: m.IPSEstimator(),
    "IPS_clamped_normalized": lambda m: m.IPSEstimator(clamp_max=4.0, self_normalize=True),
    "IPS_chain_weighted": lambda m: m.IPSEstimator(chain_prob=True, weighted=True),
    "IPS_chain_clamped": lambda m: m.IPSEstimator(chain_prob=True, clamp_max=3.0),
    "PBM": lambda m: m.PBMEstimator(),
    "PBM_clamped": lambda m: m.PBMEstimator(clamp_max=2.0),
    "PBM_expectations_weighted": lambda m: m.PBMEstimator(use_expectations=True, weighted=True),
    "PseudoInverse": lambda m: m.PseudoInverseEstimator(),
    "PseudoInverse_clamped": lambda m: m.PseudoInverseEstimator(clamp_max=3.0),
    "PseudoInverse_reference_weighted": lambda m: m.PseudoInverseEstimator(
        reference_pinv=True, weighted=True),
}


@pytest.mark.parametrize("name", sorted(SLATE_CASES))
def test_slate_estimators_match_jax(name):
    arrays = _slate_arrays()
    _same_result(SLATE_CASES[name](slate).evaluate(slate.SlateEstimatorInput(**arrays)),
                 SLATE_CASES[name](jax_slate).evaluate(jax_slate.SlateEstimatorInput(**arrays)))
    if name.startswith("IPS"):  # given slate probabilities
        arrays["log_slate_prob"] = np.random.default_rng(3).uniform(0.1, 1, size=300)
        arrays["tgt_slate_prob"] = np.random.default_rng(4).uniform(0, 1, size=300)
        _same_result(
            SLATE_CASES[name](slate).evaluate(slate.SlateEstimatorInput(**arrays)),
            SLATE_CASES[name](jax_slate).evaluate(jax_slate.SlateEstimatorInput(**arrays)))


def test_slate_probabilities_metrics_and_rankings_match_jax():
    arrays = _slate_arrays(N=20)
    pin, jin = slate.SlateEstimatorInput(**arrays), jax_slate.SlateEstimatorInput(**arrays)
    for fn in ("slate_prob_chain", "slot_item_expectations"):
        np.testing.assert_allclose(getattr(pin, fn)(arrays["tgt_item_probs"]),
                                   getattr(jin, fn)(arrays["tgt_item_probs"]), rtol=REL)
    with pytest.raises(ValueError, match="enumeration states"):
        slate._slot_expectation_dp(np.full((6, 20), 1 / 20))
    rel = np.random.default_rng(5).integers(0, 4, size=(7, 4)).astype(float)
    for name, args in (("SlateMetric", ()), ("DCGSlateMetric", ()),
                       ("NDCGSlateMetric", (np.arange(8.0),)), ("ERRSlateMetric", (3.0,))):
        np.testing.assert_allclose(getattr(slate, name)(*args)(rel),
                                   getattr(jax_slate, name)(*args)(rel), rtol=REL)
    values = np.random.default_rng(6).uniform(0.1, 2.0, size=9)
    for m in (slate, jax_slate):  # its shifted values put 0 mass on the least item
        with pytest.raises(ValueError, match="non-zero entries"):
            m.PassThruDistribution().sample_ranking(values, rng=np.random.default_rng(7))
    for name, args, dets in (("PassThruDistribution", (), (True,)),
                             ("FrechetDistribution", (2.0,), (False, True))):
        for det in dets:
            np.testing.assert_array_equal(
                getattr(slate, name)(*args, deterministic=det).sample_ranking(
                    values, rng=np.random.default_rng(7)),
                getattr(jax_slate, name)(*args, deterministic=det).sample_ranking(
                    values, rng=np.random.default_rng(7)))


# ------------------------------------------------------ types, utils, datasets


def test_types_match_jax():
    for m in (types, jax_types):
        assert m.Action(2) == m.Action(2) and hash(m.Action(2)) == hash(m.Action(2))
        assert m.Action(np.array([1, 2])) == m.Action(np.array([1, 2]))
        assert int(m.Action(3)) == 3 and m.TypeWrapper(1) < m.TypeWrapper(5)
    sp, jsp = types.ActionSpace(3), jax_types.ActionSpace(3)
    d, jd = sp.distribution([0.2, 0.5, 0.3]), jsp.distribution([0.2, 0.5, 0.3])
    assert int(d.greedy()) == int(jd.greedy()) == 1
    assert [int(a) for a in d.greedy(2)] == [int(a) for a in jd.greedy(2)]
    np.testing.assert_array_equal(d.as_distribution(), jd.as_distribution())
    assert d.probability(types.Action(2)) == jd.probability(jax_types.Action(2))
    v, jv = (m.Values({m.Action(0): 1.0, m.Action(5): 3.0}) for m in (types, jax_types))
    assert [int(k) for k in v.sort()[0]] == [int(k) for k in jv.sort()[0]] == [5, 0]
    assert v.replace([5.0, 1.0])[types.Action(0)] == 5.0
    assert types.Items(4).fill([1.0, 2.0, 3.0, 4.0]).greedy() == 3
    assert types.Values([0.0, 0.0]).probability(1) == 0.5
    x, y = np.arange(20.0).reshape(10, 2), np.arange(10.0)
    got = types.Trainer._sample(x, y, np.ones(10), 4, np.random.default_rng(0))
    want = jax_types.Trainer._sample(x, y, np.ones(10), 4, np.random.default_rng(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_utils_match_jax():
    np.testing.assert_array_equal(utils.convert_to_one_hots([2, 0, 1], 3),
                                  jax_utils.convert_to_one_hots([2, 0, 1], 3))
    cache = utils.LRUCache(maxsize=2)
    cache["a"], cache["b"] = 1, 2
    _ = cache["a"]
    cache["c"] = 3
    assert list(cache) == ["a", "c"]
    avg, javg = utils.RunningAverage(), jax_utils.RunningAverage()
    for v in (1.0, float("nan"), 3.0, float("inf"), 8.0):
        avg.add(v)
        javg.add(v)
    assert (avg.average, avg.count, avg.total) == (javg.average, javg.count, javg.total)
    clamp = utils.Clamper(-1.0, 2.0)
    assert clamp(5) == 2.0 and clamp([-3, 0.5]) == [-1.0, 0.5]
    np.testing.assert_array_equal(clamp(np.array([-3.0, 3.0])), [-1.0, 2.0])
    t = clamp(torch.tensor([-3.0, 0.25, 3.0]))
    assert isinstance(t, torch.Tensor) and t.tolist() == [-1.0, 0.25, 2.0]
    big = torch.tensor([1e30])
    assert torch.equal(utils.Clamper()(big), big)
    with pytest.raises(ValueError):
        utils.Clamper(1.0, 0.0)


def test_array_bandits_dataset_matches_jax():
    rng = np.random.default_rng(0)
    args = (rng.normal(size=(30, 4)), rng.integers(0, 3, 30), rng.uniform(size=30))
    ds, jds = datasets.ArrayBanditsDataset(*args), jax_datasets.ArrayBanditsDataset(*args)
    assert (len(ds), ds.num_features, ds.num_actions) == (len(jds), jds.num_features,
                                                         jds.num_actions)
    sample = ds[4]
    assert sample.action == jds[4].action and sample.reward == jds[4].reward
    for (a, b) in zip(ds.train_eval_split(0.7, seed=3), jds.train_eval_split(0.7, seed=3)):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.actions, b.actions)


# ------------------------------------------------------------------ adapters


def _edp_arrays(N=400, A=3, seed=4):
    """Episodes of 1-6 steps (mdp ids in runs) over A actions, one EDP."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 7, size=N // 3)
    mdp = np.repeat(np.arange(len(lengths)), lengths)[:N]
    n = len(mdp)
    actions = rng.integers(0, A, size=n)
    mask = np.eye(A)[actions]
    mask[::29] = 0.0  # logged actions outside the evaluated policy's support
    true_r = rng.uniform(size=A)
    return dict(
        mdp_id=mdp.reshape(-1, 1),
        sequence_number=np.concatenate([np.arange(k) for k in lengths])[:n].reshape(-1, 1),
        logged_propensities=rng.uniform(0.2, 0.6, size=(n, 1)),
        logged_rewards=(rng.uniform(size=n) < true_r[actions]).astype(float).reshape(-1, 1),
        action_mask=mask,
        model_propensities=rng.dirichlet(np.ones(A), size=n),
        model_rewards=np.tile(true_r, (n, 1)),
        model_rewards_for_logged_action=(mask * true_r).sum(1, keepdims=True),
        model_values=rng.uniform(size=(n, A)),
    )


@pytest.mark.parametrize("name", ["DM", "IPS", "DR", "Switch", "SwitchDR"])
def test_bandit_adapter_matches_jax(name):
    arrays = _edp_arrays()
    make = {"DM": "DMEstimator", "IPS": "IPSEstimator", "DR": "DoublyRobustEstimator",
            "Switch": "SwitchEstimator", "SwitchDR": "SwitchDREstimator"}[name]
    got = OPEstimatorAdapter(getattr(cb, make)()).estimate(EvaluationDataPage(**arrays))
    want = JaxAdapter(getattr(jax_cb, make)()).estimate(JaxEDP(**arrays))
    np.testing.assert_allclose(tuple(got), tuple(want), rtol=REL)
    log = OPEstimatorAdapter.edp_to_contextual_bandit_log(EvaluationDataPage(**arrays))
    assert (log.log_action == -1).sum() == (arrays["action_mask"].sum(1) == 0).sum()


@pytest.mark.parametrize("name", ["IPS", "DR", "MAGIC"])
def test_sequential_adapter_matches_jax(name):
    arrays = _edp_arrays(N=300)
    make = {"IPS": lambda m: m.IPSEstimator(), "DR": lambda m: m.DoublyRobustEstimator(),
            "MAGIC": lambda m: m.MAGICEstimator(num_j_steps=4)}[name]
    np.random.seed(1)
    want = JaxSeqAdapter(make(jax_seq), gamma=0.9).estimate(JaxEDP(**arrays))
    np.random.seed(1)
    got = SequentialOPEstimatorAdapter(make(seq), gamma=0.9).estimate(
        EvaluationDataPage(**arrays))
    np.testing.assert_allclose(tuple(got), tuple(want), rtol=2e-5 if name == "MAGIC" else REL)


# ------------------------------------------------ gridworld and tabular trainers


def _grid_policies(m, gamma=0.9):
    world = m["gridworld"].GridWorld(size=3)
    tgt = m["tabular"].TabularPolicy(world.num_actions, epsilon=0.1)
    v = m["tabular"].DPTrainer(world, tgt).train(gamma=gamma)
    log = m["tabular"].TabularPolicy(world.num_actions, epsilon=0.6)
    for s in world.states:
        log.update(s, int(np.argmax(tgt.action_dist(s))))
    value_fn = m["tabular"].DPValueFunction(tgt, world, gamma)
    return world, tgt, log, value_fn, v


PORT = {"gridworld": gridworld, "tabular": tabular}
JAX = {"gridworld": jax_gridworld, "tabular": jax_tabular}


def test_gridworld_logs_and_dp_match_jax():
    world, tgt, log, value_fn, v = _grid_policies(PORT)
    jworld, jtgt, jlog, jvalue_fn, jv = _grid_policies(JAX)
    assert v == jv
    assert value_fn.evaluate() == jvalue_fn.evaluate()
    assert value_fn.state_value((0, 0)) == jvalue_fn.state_value((0, 0))
    got = gridworld.generate_logs(world, log, tgt, value_fn, 30, 10, 0.9, seed=2)
    want = jax_gridworld.generate_logs(jworld, jlog, jtgt, jvalue_fn, 30, 10, 0.9, seed=2)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tgt.sample((1, 1)) == jtgt.sample((1, 1))
    np.testing.assert_array_equal(tgt((2, 2)), jtgt((2, 2)))


def test_monte_carlo_trainers_match_jax():
    world, jworld = gridworld.GridWorld(size=3), jax_gridworld.GridWorld(size=3)
    pol = tabular.TabularPolicy(4, epsilon=0.2, rng=np.random.default_rng(0))
    jpol = jax_tabular.TabularPolicy(4, epsilon=0.2, rng=np.random.default_rng(0))
    tabular.MonteCarloTrainer(world, pol, seed=0).train(iterations=20, update_interval=10,
                                                        max_steps=15)
    jax_tabular.MonteCarloTrainer(jworld, jpol, seed=0).train(iterations=20,
                                                              update_interval=10,
                                                              max_steps=15)
    for s in world.states:
        np.testing.assert_array_equal(pol.action_dist(s), jpol.action_dist(s))
    for first_visit in (True, False):
        mc = tabular.MonteCarloValueFunction(pol, world, gamma=0.9, first_visit=first_visit,
                                             count_threshold=10, max_iteration=20, seed=1)
        jmc = jax_tabular.MonteCarloValueFunction(jpol, jworld, gamma=0.9,
                                                  first_visit=first_visit,
                                                  count_threshold=10, max_iteration=20,
                                                  seed=1)
        for s in [(0, 0), (1, 2)]:
            assert mc(s) == jmc(s)
        mc.reset(clear_state_values=True)
    est = tabular.EstimatedStateValueFunction(pol, world, 0.9, num_episodes=10, seed=2)
    jest = jax_tabular.EstimatedStateValueFunction(jpol, jworld, 0.9, num_episodes=10, seed=2)
    assert est((0, 1)) == jest((0, 1))
    steps = tabular.generate_episode(world, pol, (0, 0), np.random.default_rng(4))
    assert steps == jax_tabular.generate_episode(jworld, jpol, (0, 0),
                                                 np.random.default_rng(4))


# ---------------------------------------------------------- sklearn trainers


def _regression_data(m, seed=0, n=200, d=6):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=d)
    w[d // 2:] = 0.0
    x = rng.normal(size=(n, d))
    xv = rng.normal(size=(n // 2, d))
    return m.TrainingData(x, x @ w + rng.normal(scale=0.05, size=n), None, xv, xv @ w)


@pytest.mark.parametrize("name", ["LinearTrainer", "LassoTrainer", "DecisionTreeTrainer",
                                  "DecisionTreeClassifierTrainer", "LogisticRegressionTrainer",
                                  "SGDClassifierTrainer"])
def test_sklearn_trainers_match_jax(name):
    """The sklearn trainers are JAX's: the same model from the same data."""
    classify = "Classifier" in name or "Logistic" in name
    preds = []
    for m in (linear_trainers, jax_linear):
        data = _regression_data(m)
        if classify:
            data = m.TrainingData(data.train_x, (data.train_y > 0).astype(int), None,
                                  data.validation_x, (data.validation_y > 0).astype(int))
        kw = {"SGDClassifierTrainer": dict(max_iter=50)}.get(name, {})
        tr = getattr(m, name)(**kw)
        np.random.seed(0)  # the trees and SGD draw from the global RandomState
        tr.train(data)
        preds.append(tr.predict(data.validation_x))
    np.testing.assert_allclose(preds[0], preds[1], rtol=1e-12)


# ------------------------------------------------------ loaders and harnesses


def test_file_loaders_match_jax(tmp_path):
    corpus = slate_benchmark.QueryCorpus.from_mslr(os.path.join(DATA, "mslr_sample.txt"))
    jcorpus = jax_slate_bench.QueryCorpus.from_mslr(os.path.join(DATA, "mslr_sample.txt"))
    np.testing.assert_array_equal(corpus.features, jcorpus.features)
    np.testing.assert_array_equal(corpus.relevances, jcorpus.relevances)
    assert (corpus.num_queries, corpus.num_docs) == (4, 8)
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    with pytest.raises(ValueError, match="no MSLR rows"):
        slate_benchmark.QueryCorpus.from_mslr(str(empty))
    queries = web_search.parse_yandex_log(os.path.join(DATA, "yandex_sample.txt"))
    jqueries = jax_web.parse_yandex_log(os.path.join(DATA, "yandex_sample.txt"))
    assert [(q.user_id, q.query_id, q.url_list, q.clicks, q.position_relevances)
            for q in queries] == [(q.user_id, q.query_id, q.url_list, q.clicks,
                                   q.position_relevances) for q in jqueries]
    uci = {"file": os.path.join(DATA, "uci_sample.data"), "sep": r"\s+", "index_col": 0,
           "label_col": -1}
    ds, jds = multiclass_bandits.MultiClassDataset.from_csv(uci), \
        jax_multiclass.MultiClassDataset.from_csv(uci)
    np.testing.assert_array_equal(ds.features, jds.features)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    with pytest.raises(ValueError, match="label_col"):
        multiclass_bandits.MultiClassDataset.from_csv({"file": "x.csv"})


def _same_results(got, want, rel=REL):
    assert got.keys() == want.keys()
    for k in got:
        _same_result(got[k], want[k], rel)


def test_slate_and_web_search_harnesses_match_jax():
    kw = dict(slate_size=3, num_samples_per_query=20, seed=0)
    _same_results(slate_benchmark.evaluate_slate_benchmark(
        slate_benchmark.QueryCorpus.from_mslr(os.path.join(DATA, "mslr_sample.txt")), **kw),
        jax_slate_bench.evaluate_slate_benchmark(
            jax_slate_bench.QueryCorpus.from_mslr(os.path.join(DATA, "mslr_sample.txt")), **kw))
    # the tree draws from the global RandomState
    np.random.seed(0)
    got = slate_benchmark.evaluate_slate_benchmark(
        slate_benchmark.QueryCorpus.synthetic(40, 10, seed=2), log_trainer=linear_trainers.
        LassoTrainer(), tgt_trainer=linear_trainers.DecisionTreeTrainer(max_depth=4), **kw)
    np.random.seed(0)
    _same_results(got, jax_slate_bench.evaluate_slate_benchmark(
        jax_slate_bench.QueryCorpus.synthetic(40, 10, seed=2), log_trainer=jax_linear.
        LassoTrainer(), tgt_trainer=jax_linear.DecisionTreeTrainer(max_depth=4), **kw))
    logs = web_search.generate_client_logs(num_queries=10, num_users=30, seed=3)
    jlogs = jax_web.generate_client_logs(num_queries=10, num_users=30, seed=3)
    queries = web_search.load_logged_queries(logs, min_query_count=5)
    jqueries = jax_web.load_logged_queries(jlogs, min_query_count=5)
    queries[0].merge(queries[1])
    jqueries[0].merge(jqueries[1])
    for build in ("from_training_queries", "from_real_queries"):
        ds = getattr(web_search.WebSearchDataset, build)(queries, 12)
        jds = getattr(jax_web.WebSearchDataset, build)(jqueries, 12)
        np.testing.assert_array_equal(ds.url_relevances, jds.url_relevances)
        _same_results(web_search.evaluate_web_search(ds, samples_per_query=10, seed=1),
                      jax_web.evaluate_web_search(jds, samples_per_query=10, seed=1))
    assert web_search.WebSearchSlateModel(ds).item_rewards(0).tolist() == \
        ds.item_relevances(0).tolist()


def test_multiclass_harness_matches_jax():
    """sklearn's bundled iris through the multiclass harness (sklearn on the
    host in both packages)."""
    _same_results(multiclass_bandits.evaluate_all(
        multiclass_bandits.MultiClassDataset.from_sklearn("iris"), seed=1),
        jax_multiclass.evaluate_all(jax_multiclass.MultiClassDataset.from_sklearn("iris"),
                                    seed=1))


# --------------------------------------------- F1: the artifact's activations


def _dqn_wrappers(act):
    """The port's and JAX's DQN predictor wrappers over one net (3 -> 4 ->
    2, ``act`` hidden) from JAX's init, with the net's true activations."""
    import jax
    import jax.numpy as jnp

    from reagent_tpu.core.parameters import NormalizationParameters as JaxNorm
    from reagent_tpu.models import FullyConnectedDQN as JaxDQN
    from reagent_tpu.prediction import predictor_wrapper as jax_pw
    from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
    from reagent_tpu_torch.core.parameters import NormalizationParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.prediction import predictor_wrapper as pw
    from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
    from reagent_tpu_torch.utils.interop import q_network_state_from_flax

    jnet = JaxDQN(state_dim=3, action_dim=2, sizes=[4], activations=[act])
    variables = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    net = FullyConnectedDQN(3, 2, [4], [act])
    net.load_state_dict(q_network_state_from_flax(jax.tree.map(np.asarray, variables)))
    norm = dict(feature_type="CONTINUOUS", mean=0.0, stddev=1.0)
    ours = pw.DiscreteDqnPredictorWrapper(
        pw.DiscreteDqnWithPreprocessor(net, Preprocessor(
            {i: NormalizationParameters(**norm) for i in range(3)}, device="cpu")),
        ["a", "b"], activations=net.activations)
    theirs = jax_pw.DiscreteDqnPredictorWrapper(
        jax_pw.DiscreteDqnWithPreprocessor(jnet, variables, JaxPreprocessor(
            {i: JaxNorm(**norm) for i in range(3)})), ["a", "b"])
    return ours, theirs


@pytest.mark.parametrize("act", ["sigmoid", "softplus"])
def test_dqn_artifact_refuses_what_the_scorer_cannot_apply(tmp_path, act):
    """The C++ scorer serves any activation but relu, leaky_relu and tanh as
    the identity: ``save`` raises, naming the activation and the layer, and
    writes nothing."""
    ours, _ = _dqn_wrappers(act)
    with pytest.raises(ValueError, match=f"layer 0 has activation '{act}'"):
        ours.save(str(tmp_path / "artifact"))
    assert not (tmp_path / "artifact").exists()


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh"])
def test_dqn_artifact_of_a_scorer_activation_equals_jax(tmp_path, act):
    """relu, leaky_relu and tanh still write the artifact: its weights.bin
    equals JAX's, its manifest records the true activations."""
    ours, theirs = _dqn_wrappers(act)
    ours.save(str(tmp_path / "ours"))
    theirs.save(str(tmp_path / "theirs"))
    a = np.fromfile(str(tmp_path / "ours" / "weights.bin"), "<f4")
    b = np.fromfile(str(tmp_path / "theirs" / "weights.bin"), "<f4")
    np.testing.assert_array_equal(a, b)
    with open(tmp_path / "ours" / "manifest.json") as f:
        assert json.load(f)["activations"] == [act, "linear"]


def test_the_package_imports_without_sklearn_or_pandas():
    """The card's machine has neither: every module of the port's ``ope``
    package and the adapter import with both blocked."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['sklearn'] = None; sys.modules['pandas'] = None\n"
        "import importlib, pkgutil, reagent_tpu_torch.ope as ope\n"
        "for m in pkgutil.walk_packages(ope.__path__, 'reagent_tpu_torch.ope.'):\n"
        "    importlib.import_module(m.name)\n"
        "import reagent_tpu_torch.evaluation.ope_adapter\n"
        "print(sorted(k for k in sys.modules if k.startswith('reagent_tpu_torch.ope.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(DATA)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "reagent_tpu_torch.ope.test.multiclass_bandits" in out.stdout
    assert "reagent_tpu_torch.ope.trainers.linear_trainers" in out.stdout
