"""Ranking serving and evaluation against the JAX package: the DPP
re-ranker (against JAX's and the brute-force greedy determinant of
``tests/test_prediction_ranking.py``), the seq2slate evaluation page (greedy
and sampled: the closed forms of ``tests/test_seq2slate_edp_golden.py`` and
JAX's page from the same nets), the trainers' validation step and page
accumulation, the predictor wrappers (Seq2Slate greedy and sampled on JAX's
draws, the slate reward, the ranking actor), the MLP scorer, the
convolutional network and the probabilistic network (on JAX's draws).

Tolerances, float32 on two libraries: forwards and pages rtol 1e-5 atol
1e-6; ranked slates and DPP orders exact; the closed forms atol 1e-6; the
ELBO's gradient rtol 1e-5 atol 1e-6 of its largest entry.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import ConvNetParameters as JaxConvNetParameters
from reagent_tpu.core.parameters import NormalizationParameters as JaxNormParams
from reagent_tpu.evaluation.evaluation_data_page import (
    EvaluationDataPage as JaxEvaluationDataPage,
)
from reagent_tpu.models.convolutional_network import ConvolutionalNetwork as JaxConvNet
from reagent_tpu.models.mlp_scorer import MLPScorer as JaxMLPScorer
from reagent_tpu.models.value import ValueNetwork as JaxValueNetwork
from reagent_tpu.models.probabilistic_fully_connected_network import (
    FullyConnectedProbabilisticNetwork as JaxProbNet,
)
from reagent_tpu.prediction.ranking import predictor_wrapper as jpw
from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
from reagent_tpu.training.ranking import seq2slate_trainer as jtr
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import ConvNetParameters, NormalizationParameters
from reagent_tpu_torch.evaluation import EvaluationDataPage
from reagent_tpu_torch.evaluation.doubly_robust_estimator import DoublyRobustEstimator
from reagent_tpu_torch.models import seq2slate as P
from reagent_tpu_torch.models.convolutional_network import ConvolutionalNetwork
from reagent_tpu_torch.models.mlp_scorer import MLPScorer
from reagent_tpu_torch.models.probabilistic_fully_connected_network import (
    FullyConnectedProbabilisticNetwork,
)
from reagent_tpu_torch.models.value import ValueNetwork
from reagent_tpu_torch.prediction.ranking import predictor_wrapper as pw
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training.ranking import Seq2SlateTrainer
from reagent_tpu_torch.training.ranking.seq2slate_trainer import accumulate_edp_pairs
from reagent_tpu_torch.utils.interop import (
    convolutional_network_state_from_flax,
    probabilistic_network_state_from_flax,
    q_network_state_from_flax,
    seq2slate_trainer_state_from_arrays,
)
from test_torch_qrdqn import _np_tree
from test_torch_seq2slate import (
    CD,
    SD,
    B,
    S,
    T,
    all_params,
    jax_draws,
    jax_model,
    load,
    port_model,
    ranking_batch,
    reward_nets,
)

TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = P.Seq2SlateOutputArch.AUTOREGRESSIVE


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=msg, equal_nan=False, **tol)


# ---------------------------------------------------------------------- DPP

@pytest.mark.parametrize("kernel,topk", [("linear", None), ("rbf", None), ("linear", 3),
                                         ("rbf", 2)])
def test_dpp_matches_jax(kernel, topk):
    """The order, each step's gains and the kernel, from the same scores and
    features, the reranked top k then the rest in their order."""
    rng = np.random.default_rng(4)
    n = 7
    quality = (np.abs(rng.normal(size=(n, 1))) + 0.5).astype(np.float32)
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    got = pw.DeterminantalPointProcessPredictorWrapper(
        0.5, pw.Kernel(kernel), sigma=0.8, rerank_topk=topk)(torch.tensor(quality),
                                                             torch.tensor(feats))
    want = jpw.DeterminantalPointProcessPredictorWrapper(
        0.5, jpw.Kernel(kernel), sigma=0.8, rerank_topk=topk)(jnp.asarray(quality),
                                                              jnp.asarray(feats))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])
    _close(got[2], want[2])


def test_dpp_greedy_is_the_brute_force_determinant_order():
    """Each pick maximizes the determinant of the chosen submatrix
    (``tests/test_prediction_ranking.py``'s brute force); a rank-deficient
    kernel still gives a permutation; diversity outranks quality."""
    rng = np.random.default_rng(1)
    n = 5
    quality = np.abs(rng.normal(size=(n, 1))) + 0.5
    feats = rng.normal(size=(n, 5))
    chosen, _, L = pw.DeterminantalPointProcessPredictorWrapper(0.5)(
        torch.tensor(quality, dtype=torch.float32), torch.tensor(feats, dtype=torch.float32))
    chosen, L = chosen.tolist(), L.double().numpy()
    picked = []
    for step in range(n - 1):
        best = max((i for i in range(n) if i not in picked),
                   key=lambda i: np.linalg.det(L[np.ix_(picked + [i], picked + [i])]))
        assert chosen[step] == best
        picked.append(best)
    for kernel in pw.Kernel:
        order, _, _ = pw.DeterminantalPointProcessPredictorWrapper(1.0, kernel)(
            torch.tensor(np.abs(rng.normal(size=(8, 1))) + 0.5, dtype=torch.float32),
            torch.tensor(rng.normal(size=(8, 2)), dtype=torch.float32))
        assert sorted(order.tolist()) == list(range(8))
    order, _, _ = pw.DeterminantalPointProcessPredictorWrapper(1.0)(
        torch.tensor([[1.0], [0.99], [0.8]]),
        torch.tensor([[1.0, 0.0], [1.0, 1e-3], [0.0, 1.0]]))
    assert order[1].item() == 2


# -------------------------------------------------- the seq2slate page

# tests/test_seq2slate_edp_golden.py's 3-sample log
RANKED_IDX = np.array([[2, 3], [3, 2], [2, 3]], np.int64)
LOGGED_IDX = np.array([[3, 2], [3, 2], [3, 2]], np.int64)
LOGGED_REWARD = np.array([4.0, 5.0, 7.0])
LOGGED_PROP = np.array([0.2, 0.5, 0.4])
MODEL_PROP = np.array([0.4, 0.3, 0.7])
REWARD_FIRST = np.array([1.0, 3.0, 5.0])   # predicted reward of slate [2, 3]
REWARD_SECOND = np.array([2.0, 4.0, 6.0])  # ... of slate [3, 2]


class FakeRanker(nn.Module):
    """The golden test's ranker: fixed greedy slates and logged-slate
    propensities."""

    def forward(self, mode, state, src_seq, **kwargs):
        if mode == P.Seq2SlateMode.RANK_MODE.value:
            assert kwargs.get("greedy")
            return P.Seq2SlateTransformerOutput(ranked_tgt_out_idx=torch.tensor(RANKED_IDX))
        return P.Seq2SlateTransformerOutput(
            per_seq_log_probs=torch.log(torch.tensor(MODEL_PROP)).reshape(-1, 1))


class FakeRewardNet(nn.Module):
    """The golden test's reward table, by state and slate order."""

    def forward(self, inp):
        state, idx = inp.state.float_features.numpy(), inp.tgt_out_idx.numpy()
        out = np.where((idx == np.array([2, 3])).all(axis=1),
                       REWARD_FIRST[np.argmax(state, axis=1)],
                       REWARD_SECOND[np.argmax(state, axis=1)])
        return torch.tensor(out).reshape(-1, 1)


def golden_batch():
    src = np.tile(np.eye(2, dtype=np.float32), (3, 1, 1))
    return rlt.PreprocessedRankingInput(
        state=rlt.FeatureData(float_features=torch.eye(3)),
        src_seq=rlt.FeatureData(float_features=torch.tensor(src)),
        tgt_out_seq=rlt.FeatureData(float_features=torch.tensor(
            np.take_along_axis(src, (LOGGED_IDX - 2)[:, :, None], axis=1))),
        tgt_out_idx=torch.tensor(LOGGED_IDX),
        tgt_out_probs=torch.tensor(LOGGED_PROP, dtype=torch.float32),
        slate_reward=torch.tensor(LOGGED_REWARD, dtype=torch.float32))


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_seq2slate_page_closed_forms(greedy):
    """The golden fields, and DM, IPS and DR through the port's estimator
    against the closed forms (reference test_ope_integration.py:282-352)."""
    edp = EvaluationDataPage.create_from_tensors_seq2slate(
        FakeRanker(), None, FakeRewardNet(), None, golden_batch(), greedy)
    np.testing.assert_allclose(edp.logged_rewards.reshape(-1), LOGGED_REWARD)
    np.testing.assert_allclose(edp.logged_propensities.reshape(-1), LOGGED_PROP, rtol=1e-6)
    np.testing.assert_allclose(edp.model_rewards_for_logged_action.reshape(-1), REWARD_SECOND)
    dm, ips, dr = DoublyRobustEstimator().estimate(edp)
    avg_logged = LOGGED_REWARD.mean()
    if greedy:
        np.testing.assert_allclose(edp.model_propensities, np.ones((3, 1)))
        np.testing.assert_allclose(edp.action_mask, [[0.0], [1.0], [0.0]])
        np.testing.assert_allclose(edp.model_rewards.reshape(-1), [1.0, 4.0, 5.0])
        assert dm.raw == pytest.approx((1 + 4 + 5) / 3, abs=1e-6)
        assert ips.raw == pytest.approx(5 / 0.5 / 3, abs=1e-6)
        assert dr.raw == pytest.approx(dm.raw + 1 / 0.5 * (5 - 4) / 3, abs=1e-6)
        assert dr.normalized == pytest.approx(dr.raw / avg_logged, abs=1e-6)
    else:
        np.testing.assert_allclose(edp.model_propensities.reshape(-1), MODEL_PROP, rtol=1e-6)
        np.testing.assert_allclose(edp.action_mask, np.ones((3, 1)))
        expected = (0.4 / 0.2 * 4 + 0.3 / 0.5 * 5 + 0.7 / 0.4 * 7) / 3
        assert ips.raw == pytest.approx(expected, abs=1e-5)
        assert ips.normalized == pytest.approx(expected / avg_logged, abs=1e-5)


PAGE_FIELDS = ("logged_propensities", "logged_rewards", "action_mask", "model_propensities",
               "model_rewards", "model_rewards_for_logged_action")


def _page_close(got, want):
    for f in PAGE_FIELDS:
        _close(getattr(got, f), getattr(want, f), msg=f)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_seq2slate_page_from_jax_nets(greedy):
    """The page of a real ranker and transformer reward net, both packages
    from JAX's weights, field by field."""
    jm = jax_model()
    params = all_params(jm)
    pm = load(port_model(ARCH), params)
    jreward, rparams, reward = reward_nets("transformer")
    want = JaxEvaluationDataPage.create_from_tensors_seq2slate(
        jm, params, jreward, rparams, ranking_batch(jrlt, jnp.asarray, 60), greedy)
    got = EvaluationDataPage.create_from_tensors_seq2slate(
        pm, None, reward, None, ranking_batch(rlt, torch.tensor, 60), greedy)
    _page_close(got, want)


def test_validation_step_and_page_accumulation_match_jax():
    """``Seq2SlateTrainer.validation_step`` with CPE and a baseline, both
    packages from JAX's state: the four metrics, the two pages, their
    accumulation over two batches; without CPE no pages."""
    jreward, rparams, reward = reward_nets("gru")
    jtrainer = jtr.Seq2SlateTrainer(jax_model(), baseline_net=JaxValueNetwork(SD, [8], ["relu"]),
                                    calc_cpe=True, reward_network=jreward, reward_params=rparams)
    jstate = jtrainer.init(jax.random.PRNGKey(0), ranking_batch(jrlt, jnp.asarray, 0))
    trainer = Seq2SlateTrainer(port_model(ARCH), baseline_net=ValueNetwork(SD, [8], ["relu"]),
                               calc_cpe=True, reward_network=reward, device="cpu")
    state = seq2slate_trainer_state_from_arrays(
        _np_tree(jstate.policy_params), None, 0, baseline_params=_np_tree(jstate.baseline_params))
    jpairs, pairs = [], []
    for seed in (61, 62):
        jm, jg, jng = jtrainer.validation_step(jstate, ranking_batch(jrlt, jnp.asarray, seed))
        m, g, ng = trainer.validation_step(state, ranking_batch(rlt, torch.tensor, seed))
        assert m.keys() == jm.keys()
        for k in jm:
            _close(m[k], jm[k], msg=k)
        jpairs.append((jg, jng))
        pairs.append((g, ng))
    for got, want in zip(accumulate_edp_pairs(pairs), jtr.accumulate_edp_pairs(jpairs)):
        assert got.logged_rewards.shape == (2 * B, 1)
        _page_close(got, want)
    assert accumulate_edp_pairs([(None, None)]) == (None, None)
    trainer.calc_cpe = False
    m, g, ng = trainer.validation_step(state, ranking_batch(rlt, torch.tensor, 61))
    assert g is None and ng is None


# --------------------------------------------------------- predictor wrappers

def _norm(mod):
    return {i: mod(feature_type="CONTINUOUS", mean=0.1 * i, stddev=1.0 + 0.5 * i)
            for i in range(1000, 1000 + 8)}


def _preprocessors(dim):
    spec = {k: v for k, v in list(_norm(NormalizationParameters).items())[:dim]}
    jspec = {k: v for k, v in list(_norm(JaxNormParams).items())[:dim]}
    return Preprocessor(spec), JaxPreprocessor(jspec)


def _raw(seed, batch=B):
    rng = np.random.default_rng(seed)
    sv = rng.normal(size=(batch, SD)).astype(np.float32)
    cv = rng.normal(size=(batch, S, CD)).astype(np.float32)
    return ((sv, (rng.random(sv.shape) > 0.1).astype(np.float32)),
            (cv, (rng.random(cv.shape) > 0.1).astype(np.float32)))


def _vp(pair, conv):
    return tuple(conv(x) for x in pair)


def test_seq2slate_predictor_wrappers_match_jax():
    """Preprocessing then a greedy rank, and a sampled rank on JAX's draws:
    the propensities and the 0-based slates; a sampled wrapper without
    draws raises."""
    state_pre, jstate_pre = _preprocessors(SD)
    cand_pre, jcand_pre = _preprocessors(CD)
    kw = dict(state_dim=SD, candidate_dim=CD, max_src_seq_len=S, max_tgt_seq_len=T,
              num_stacked_layers=2, num_heads=2, dim_model=16, dim_feedforward=32)
    from reagent_tpu.models.seq2slate import Seq2SlateTransformerNet as JaxNet

    jnet = JaxNet(**kw)
    params = all_params(jnet.seq2slate)
    P_net = P.Seq2SlateTransformerNet(device="cpu", **kw)
    load(P_net.seq2slate, params)
    sv, cv = _raw(70)
    for greedy in (True, False):
        jw = jpw.Seq2SlatePredictorWrapper(jpw.Seq2SlateWithPreprocessor(
            jnet, params, jstate_pre, jcand_pre, greedy))
        w = pw.Seq2SlatePredictorWrapper(pw.Seq2SlateWithPreprocessor(
            P_net, None, state_pre, cand_pre, greedy))
        key = None if greedy else jax.random.PRNGKey(3)
        want = jw(_vp(sv, jnp.asarray), _vp(cv, jnp.asarray), key)
        got = w(_vp(sv, torch.tensor), _vp(cv, torch.tensor),
                None if greedy else jax_draws(key, S, B, S + 2))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[0], want[0])
        assert got[1].min() >= 0 and got[1].max() < S
        if not greedy:
            with pytest.raises(ValueError):
                w(_vp(sv, torch.tensor), _vp(cv, torch.tensor))
    s, c = pw.SlateRankingPreprocessor(state_pre, cand_pre, S)(_vp(sv, torch.tensor),
                                                              _vp(cv, torch.tensor))
    js, jc = jpw.SlateRankingPreprocessor(jstate_pre, jcand_pre, S)(_vp(sv, jnp.asarray),
                                                                   _vp(cv, jnp.asarray))
    _close(s, js)
    _close(c, jc)


@pytest.mark.parametrize("with_pre", [True, False])
def test_seq2slate_reward_wrapper_matches_jax(with_pre):
    jreward, rparams, reward = reward_nets("gru")
    state_pre, jstate_pre = _preprocessors(SD) if with_pre else (None, None)
    cand_pre, jcand_pre = _preprocessors(CD) if with_pre else (None, None)
    sv, cv = _raw(71)
    want = jpw.Seq2SlateRewardWithPreprocessor(jreward, rparams, S, T, jstate_pre, jcand_pre)(
        _vp(sv, jnp.asarray), _vp(cv, jnp.asarray))
    got = pw.Seq2SlateRewardWithPreprocessor(reward, None, S, T, state_pre, cand_pre)(
        _vp(sv, torch.tensor), _vp(cv, torch.tensor))
    assert got.shape == (B,)
    _close(got, want)


def test_ranking_actor_wrapper_matches_jax():
    """An ``MLPScorer`` over the preprocessed candidates as the actor."""
    state_pre, jstate_pre = _preprocessors(SD)
    cand_pre, jcand_pre = _preprocessors(CD)
    jscorer = JaxMLPScorer(input_dim=CD, sizes=[8], activations=["relu"])
    sv, cv = _raw(72)
    jfeat = jrlt.FeatureData(jnp.zeros((1, SD)), candidate_docs=jrlt.DocList(jnp.zeros((1, S, CD))))
    params = jscorer.init(jax.random.PRNGKey(0), jfeat)
    scorer = MLPScorer(CD, [8], ["relu"])
    scorer.load_state_dict(q_network_state_from_flax(_np_tree(params)))
    want = jpw.RankingActorPredictorWrapper(jpw.RankingActorWithPreprocessor(
        jscorer, params, jstate_pre, jcand_pre, S))(_vp(sv, jnp.asarray), _vp(cv, jnp.asarray))
    got = pw.RankingActorPredictorWrapper(pw.RankingActorWithPreprocessor(
        scorer, None, state_pre, cand_pre, S))(_vp(sv, torch.tensor), _vp(cv, torch.tensor))
    _close(got, want)
    with pytest.raises(ValueError):
        pw.RankingActorWithPreprocessor(scorer, None, state_pre, cand_pre, S + 1)(
            _vp(sv, torch.tensor), _vp(cv, torch.tensor))


# ---------------------------------------------------- the smaller models

@pytest.mark.parametrize("has_user_feat", [False, True])
def test_mlp_scorer_matches_jax(has_user_feat):
    rng = np.random.default_rng(8)
    user = rng.normal(size=(B, SD)).astype(np.float32)
    docs = rng.normal(size=(B, S, CD)).astype(np.float32)
    dim = SD + S * CD if has_user_feat else CD
    jnet = JaxMLPScorer(input_dim=dim, sizes=[16, 8], activations=["relu", "tanh"],
                        has_user_feat=has_user_feat)
    jfeat = jrlt.FeatureData(jnp.asarray(user), candidate_docs=jrlt.DocList(jnp.asarray(docs)))
    params = jnet.init(jax.random.PRNGKey(1), jfeat)
    net = MLPScorer(dim, [16, 8], ["relu", "tanh"], has_user_feat=has_user_feat)
    net.load_state_dict(q_network_state_from_flax(_np_tree(params)))
    got = net(rlt.FeatureData(torch.tensor(user), candidate_docs=rlt.DocList(torch.tensor(docs))))
    assert got.shape == ((B,) if has_user_feat else (B, S))
    _close(got, jnet.apply(params, jfeat))


@pytest.mark.parametrize("pools,widths,channels", [
    (("max", "avg"), None, 3), (("avg", "max"), (2, 3), 1), (("max",), None, None)])
def test_convolutional_network_matches_jax(pools, widths, channels):
    """NHWC images (a [B, H, W] image where ``channels`` is None), 'SAME'
    convolutions with odd and even kernels, max and average pools, the head
    on the (H, W, C) flattening."""
    n = len(pools)
    kw = dict(conv_dims=(4, 6)[:n], conv_height_kernels=(3, 2)[:n], pool_types=pools,
              pool_kernel_sizes=(2, 2)[:n],
              conv_width_kernels=None if widths is None else widths[:n])
    H, W = 8, 9
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, H, W) + (() if channels is None else (channels,))).astype(np.float32)
    jnet = JaxConvNet(JaxConvNetParameters(**kw), H, W, channels or 1, [16], ["relu"], 3)
    params = jnet.init(jax.random.PRNGKey(2), jnp.asarray(x))
    net = ConvolutionalNetwork(ConvNetParameters(**kw), H, W, channels or 1, [16], ["relu"], 3)
    net.load_state_dict(convolutional_network_state_from_flax(_np_tree(params)))
    _close(net(torch.tensor(x)), jnet.apply(params, jnp.asarray(x)))


def _bbb_draws(key, sizes):
    """JAX's per-layer weight and bias draws of one forward from ``key``."""
    out = []
    for i in range(len(sizes) - 1):
        key, sub = jax.random.split(key)
        kw, kb = jax.random.split(sub)
        out.append((torch.tensor(np.asarray(jax.random.normal(kw, (sizes[i], sizes[i + 1])))),
                    torch.tensor(np.asarray(jax.random.normal(kb, (sizes[i + 1],))))))
    return out


def test_probabilistic_network_matches_jax_on_its_draws():
    """One posterior draw's prediction and KL, and the ELBO over 3 draws with
    its gradient, on the draws JAX makes from its keys."""
    sizes, acts = [SD, 16, 8, 1], ["relu", "tanh"]
    jnet = JaxProbNet(sizes=sizes, activations=acts, prior_sigma=0.5, noise_tol=0.2)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, SD)).astype(np.float32)
    y = rng.normal(size=(B, 1)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x), jax.random.PRNGKey(4))
    net = FullyConnectedProbabilisticNetwork(sizes, acts, prior_sigma=0.5, noise_tol=0.2)
    sd = probabilistic_network_state_from_flax(_np_tree(params))
    net.load_state_dict(sd)
    key = jax.random.PRNGKey(5)
    jpred, jkl = jnet.apply(params, jnp.asarray(x), key)
    pred, kl = net(torch.tensor(x), _bbb_draws(key, sizes))
    _close(pred, jpred)
    _close(kl, jkl)

    def jloss(p):
        return jnet.sample_elbo(p, jnp.asarray(x), jnp.asarray(y), 3, jax.random.PRNGKey(6))

    keys = jax.random.split(jax.random.PRNGKey(6), 3)
    noises = [_bbb_draws(k, sizes) for k in keys]
    leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    loss = net.sample_elbo(leaves, torch.tensor(x), torch.tensor(y), 3, noises)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    jvalue, jgrad = jax.jit(jax.value_and_grad(jloss))(params)
    _close(loss, jvalue)
    jgrads = probabilistic_network_state_from_flax(_np_tree(jgrad))
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for (k, g) in zip(leaves, grads):
        _close(g, jgrads[k], dict(rtol=1e-5, atol=1e-6 * scale), k)
    assert all(np.isfinite(v) for v in itertools.chain(
        [loss.item()], (float(g.abs().max()) for g in grads)))
