"""The combinatorial optimizers against the JAX package.

Random search, Q-learning and the MLP-ensemble optimizer draw from the same
numpy stream in both packages: the same samples, costs and best solutions,
exactly.  Policy gradient and Gumbel-softmax take JAX's own draws, recomputed
here from the keys JAX's ``_next_key`` splits (the Gumbel draws behind
``jax.random.categorical``, the uniforms of the relaxed samples).  The
Bayes-by-backprop surrogates and optimizer start from JAX's parameters and
take its weight noise (``split(key, 4)`` / ``split(key)`` then one normal a
weight).  Then JAX's learning bars (``tests/test_lite.py``,
``tests/test_optim_lite_extras.py``) on the port's own draws.

Tolerances: logits after 10 Adam steps rtol 1e-5 atol 1e-6 (float32 sums
of a softmax's gradient in each library's order); the surrogates' forward
rtol 1e-5 and KL rtol 1e-6; the optimizer's parameters after 3 x 5 Adam
steps rtol 5e-4 atol 5e-5 and its last loss rtol 1e-4; its chosen
candidates equal unless their predictions at the cut are within 1e-5 of
max(1, |prediction at the cut|): then the port takes JAX's and goes on.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.lite import optimizer as J
from reagent_tpu_torch.lite import optimizer as P

PARAM = {"x": [0.0, 1.0, 2.0, 3.0], "y": [0.0, 1.0]}
JX, JY = jnp.asarray(PARAM["x"]), jnp.asarray(PARAM["y"])
TX, TY = torch.tensor(PARAM["x"]), torch.tensor(PARAM["y"])
LOGITS_TOL = dict(rtol=1e-5, atol=1e-6)
BBB_PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
NEAR_TIE = 1e-5  # of max(1, |prediction at the cut|)


def jax_obj(s):
    return ((JX[s["x"]] - 2.0) ** 2 + JY[s["y"]] ** 2).reshape(-1, 1)


def port_obj(s):
    return ((TX[s["x"]] - 2.0) ** 2 + TY[s["y"]] ** 2).reshape(-1, 1)


def jax_soft_obj(s):
    return ((s["x"] @ JX - 2.0) ** 2 + (s["y"] @ JY) ** 2).reshape(-1, 1)


def port_soft_obj(s):
    return ((s["x"] @ TX - 2.0) ** 2 + (s["y"] @ TY) ** 2).reshape(-1, 1)


def host(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def tensors(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def next_keys(jopt, n):
    """The next ``n`` keys ``jopt._next_key`` will return, without moving it."""
    rng, keys = jopt.jrng, []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        keys.append(k)
    return keys


def assert_same_samples(got, want):
    got, want = host(got), host(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------- numpy streams


@pytest.mark.parametrize("name", ["RandomSearchOptimizer", "QLearningOptimizer",
                                  "BayesianMLPEnsemblerOptimizer"])
def test_numpy_stream_optimizers_equal_jax(name):
    kw = {"RandomSearchOptimizer": dict(batch_size=16),
          "QLearningOptimizer": dict(batch_size=16, epsilon=0.3),
          "BayesianMLPEnsemblerOptimizer": dict(batch_size=8, candidate_pool=64,
                                                num_ensemble=3)}[name]
    jopt = getattr(J, name)(PARAM, jax_obj, seed=3, **kw)
    popt = getattr(P, name)(PARAM, port_obj, seed=3, device="cpu", **kw)
    for _ in range(5):
        js, jc = jopt.optimize_step()
        ps, pc = popt.optimize_step()
        assert_same_samples(ps, js)
        assert all(v.dtype == torch.int64 for v in ps.values())
        np.testing.assert_array_equal(pc, jc)
    assert popt.best_solutions(50) == jopt.best_solutions(50)
    assert_same_samples(popt.sample(7), jopt.sample(7))
    if name == "BayesianMLPEnsemblerOptimizer":
        for pw, jw in zip(popt.weights, jopt.weights):
            for a, b in zip(pw, jw):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["RandomSearchOptimizer", "QLearningOptimizer",
                                  "BayesianMLPEnsemblerOptimizer",
                                  "BayesianByBackpropOptimizer"])
def test_a_step_reads_back_only_what_the_device_computed(name, monkeypatch):
    """The sampled indices are made on the host and their host arrays kept:
    a step reads back the objective's cost and, for Bayes by backprop, the
    surrogate's predictions, and nothing else."""
    kw = {"BayesianMLPEnsemblerOptimizer": dict(candidate_pool=64, num_ensemble=2),
          "BayesianByBackpropOptimizer": dict(num_mutations=8, train_steps=2)}.get(name, {})
    opt = getattr(P, name)(PARAM, port_obj, batch_size=16, seed=0, device="cpu", **kw)
    reads, np_of = [], P._np

    def counting(x):
        if isinstance(x, torch.Tensor):
            reads.append(tuple(x.shape))
        return np_of(x)

    monkeypatch.setattr(P, "_np", counting)
    for step in range(3):
        reads.clear()
        sampled, _ = opt.optimize_step()
        ranked = name == "BayesianByBackpropOptimizer" and step > 0
        assert reads == [(64,)] * ranked + [(16, 1)], reads
        for v in sampled.values():
            np.testing.assert_array_equal(opt._host(v), v.numpy())
    reads.clear()
    opt.indices_to_raw_choices(sampled)
    assert reads == []


def test_weighted_random_search_and_raw_choices_equal_jax():
    weights = {"x": np.array([0.1, 0.2, 0.3, 0.4])}
    jopt = J.RandomSearchOptimizer(PARAM, jax_obj, batch_size=9, sampling_weights=weights)
    popt = P.RandomSearchOptimizer(PARAM, port_obj, batch_size=9, sampling_weights=weights,
                                   device="cpu")
    (js,), (ps,) = jopt.sample_internal(9), popt.sample_internal(9)
    assert_same_samples(ps, js)
    assert popt.indices_to_raw_choices(ps) == jopt.indices_to_raw_choices(js)


def test_best_results_queue():
    q = P.BestResultsQueue(max_len=2)
    q.insert(5.0, {"a": 1})
    q.insert(1.0, {"a": 2})
    q.insert(3.0, {"a": 3})
    top = q.topk(2)
    assert top[0][0] == 1.0 and top[1][0] == 3.0


def test_nevergrad_optimizer_raises_without_nevergrad():
    if importlib.util.find_spec("nevergrad") is not None:
        pytest.skip("nevergrad is installed; this test holds the error without it")
    with pytest.raises(ImportError, match="nevergrad"):
        P.NeverGradOptimizer(PARAM, port_obj, device="cpu")
    with pytest.raises(ImportError, match="nevergrad"):
        J.NeverGradOptimizer(PARAM, jax_obj)


# ------------------------------------------------------ JAX's key draws


def test_policy_gradient_equal_jax_on_its_draws():
    bs, lr = 64, 0.2
    jopt = J.PolicyGradientOptimizer(PARAM, jax_obj, batch_size=bs, learning_rate=lr, seed=5)
    popt = P.PolicyGradientOptimizer(PARAM, port_obj, batch_size=bs, learning_rate=lr, seed=5,
                                     device="cpu")
    for _ in range(10):
        keys = next_keys(jopt, len(PARAM))
        gumbel = {k: jax.random.gumbel(key, (bs, len(v)), jnp.float32)
                  for key, (k, v) in zip(keys, PARAM.items())}
        js, jc = jopt.optimize_step()
        ps, pc = popt.optimize_step(sample_draws=tensors(gumbel))
        assert_same_samples(ps, js)
        np.testing.assert_array_equal(pc, jc)
    for k in PARAM:
        np.testing.assert_allclose(popt.logits[k].numpy(), np.asarray(jopt.logits[k]),
                                   **LOGITS_TOL)
    assert popt.best_solutions(50) == jopt.best_solutions(50)
    # the greedy-ish sample at a temperature, on JAX's draws
    keys = next_keys(jopt, len(PARAM))
    gumbel = {k: jax.random.gumbel(key, (20, len(v)), jnp.float32)
              for key, (k, v) in zip(keys, PARAM.items())}
    assert_same_samples(popt.sample(20, 0.5, gumbel=tensors(gumbel)), jopt.sample(20, 0.5))


def test_gumbel_softmax_equal_jax_on_its_draws():
    bs = 64
    kw = dict(batch_size=bs, learning_rate=0.1, temperature=1.0, anneal_rate=0.97,
              min_temperature=0.2, seed=7)
    jopt = J.GumbelSoftmaxOptimizer(PARAM, jax_soft_obj, **kw)
    popt = P.GumbelSoftmaxOptimizer(PARAM, port_soft_obj, device="cpu", **kw)
    for _ in range(10):
        (key,) = next_keys(jopt, 1)
        u = {k: jax.random.uniform(jax.random.fold_in(key, i), (bs, len(v)), minval=1e-20,
                                   maxval=1.0)
             for i, (k, v) in enumerate(PARAM.items())}
        js, jc = jopt.optimize_step()
        ps, pc = popt.optimize_step(sample_draws=tensors(u))
        assert_same_samples(ps, js)
        np.testing.assert_allclose(pc, jc, rtol=1e-5)
        assert popt.temperature == jopt.temperature
    for k in PARAM:
        np.testing.assert_allclose(popt.logits[k].numpy(), np.asarray(jopt.logits[k]),
                                   **LOGITS_TOL)
    # the relaxed samples of sample_internal on JAX's draws
    (key,) = next_keys(jopt, 1)
    u = {k: jax.random.uniform(jax.random.fold_in(key, i), (5, len(v)), minval=1e-20,
                               maxval=1.0)
         for i, (k, v) in enumerate(PARAM.items())}
    (js,), (ps,) = jopt.sample_internal(5), popt.sample_internal(5, draws=tensors(u))
    for k in PARAM:
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ Bayes by backprop


def mlp_noise(key, params):
    """JAX's MLPBayesianByBackprop.forward draws: split(key, 4), one normal a
    weight (w, b, w2, b2)."""
    ks = jax.random.split(key, 4)
    return {n: jax.random.normal(k, params[f"{n}_mu"].shape)
            for n, k in zip(("w", "b", "w2", "b2"), ks)}


def linear_noise(key, params):
    kw, kb = jax.random.split(key)
    return {"w": jax.random.normal(kw, params["w_mu"].shape),
            "b": jax.random.normal(kb, params["b_mu"].shape)}


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_bbb_surrogates_equal_jax(kind):
    if kind == "mlp":
        jnet, noise_of = J.MLPBayesianByBackprop(6, hidden=8, seed=2), mlp_noise
        pnet = P.MLPBayesianByBackprop(6, hidden=8, device="cpu")
    else:
        jnet, noise_of = J.LinearBayesianByBackprop(6, seed=2), linear_noise
        pnet = P.LinearBayesianByBackprop(6, device="cpu")
    # the means moved off their init so the rho terms matter too
    g = np.random.default_rng(0)
    jparams = {k: v + 0.3 * g.normal(size=v.shape).astype(np.float32)
               for k, v in host(jnet.params).items()}
    pparams = tensors(jparams)
    x = g.normal(size=(11, 6)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jnet.forward(jparams, jnp.asarray(x), key)
    noise = tensors(noise_of(key, jparams))
    got = pnet.forward(pparams, torch.tensor(x), noise)
    assert got.shape == (11,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pnet.train_forward(pparams, torch.tensor(x), noise).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pnet.kl(pparams)), float(jnet.kl(jparams)), rtol=1e-6)
    assert set(pnet.params) == set(jnet.params)
    for k, v in pnet.params.items():
        assert tuple(v.shape) == tuple(jnet.params[k].shape), k


def test_bbb_optimizer_equal_jax_on_its_init_and_draws():
    param = {"a": [0, 1, 2, 3], "b": [0, 1, 2], "c": list(range(5))}

    def jobj(s):
        return (jnp.abs(s["a"] - 2) + jnp.abs(s["b"] - 1) + 0.1 * s["c"]).astype(jnp.float32)

    def pobj(s):
        return (torch.abs(s["a"] - 2) + torch.abs(s["b"] - 1) + 0.1 * s["c"]).to(torch.float32)

    kw = dict(batch_size=16, num_mutations=8, train_steps=5, seed=0)
    jopt = J.BayesianByBackpropOptimizer(param, jobj, **kw)
    popt = P.BayesianByBackpropOptimizer(param, pobj, device="cpu", **kw)
    popt.net.params = tensors(jopt.net.params)
    preds = {}

    def recording(fwd, label):
        def f(params, x, noise):
            out = fwd(params, x, noise)
            preds[label] = np.asarray(out)
            return out
        return f

    jopt.net.forward = recording(jopt.net.forward, "jax")
    popt.net.forward = recording(popt.net.forward, "port")
    port_sample, followed = popt.sample_internal, []

    def following(batch_size=None, draws=None):
        # only near-ties may part the orders: then the port takes JAX's
        # chosen candidates, so that the runs go on in step
        (sampled,) = port_sample(batch_size, draws)
        if "port" in preds:
            pj, pp = preds["jax"], preds["port"]
            oj, op = np.argsort(pj)[:16], np.argsort(pp)[:16]
            parted = oj != op
            if parted.any():
                cut = np.sort(pj)[15]
                assert (np.abs(pj[oj[parted]] - pj[op[parted]]).max()
                        <= NEAR_TIE * max(1.0, abs(cut)))
                sampled = popt._upload(host(js))
                popt.last_sample_internal_res = (sampled,)
                followed.append(step)
        return (sampled,)

    popt.sample_internal = following
    compared_orders = 0
    for step in range(3):
        sampling = bool(jopt.xs)
        keys = next_keys(jopt, int(sampling) + kw["train_steps"])
        draws = [tensors(mlp_noise(k, jopt.net.params)) for k in keys]
        sample_draws = draws.pop(0) if sampling else None
        preds.clear()
        js, jc = jopt.optimize_step()
        ps, pc = popt.optimize_step(sample_draws=sample_draws, update_draws=draws)
        if sampling:
            np.testing.assert_allclose(preds["port"], preds["jax"], rtol=1e-5, atol=1e-5)
            compared_orders += 1
        assert_same_samples(ps, js)
        np.testing.assert_array_equal(pc, jc)
        for k, v in popt.net.params.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jopt.net.params[k]),
                                       err_msg=k, **BBB_PARAM_TOL)
        np.testing.assert_allclose(popt.last_predictor_loss_mean,
                                   jopt.last_predictor_loss_mean, rtol=1e-4)
        assert popt.temp == jopt.temp
    assert popt.best_solutions(50) == jopt.best_solutions(50)
    assert compared_orders == 2


# ------------------------------------------- JAX's learning bars, port draws


def test_random_search_finds_optimum():
    opt = P.RandomSearchOptimizer(PARAM, port_obj, batch_size=64, device="cpu")
    for _ in range(5):
        opt.optimize_step()
    cost, sol = opt.best_solutions(1)[0]
    assert cost == pytest.approx(0.0)
    assert sol["x"] == 2 and sol["y"] == 0


def test_policy_gradient_concentrates():
    opt = P.PolicyGradientOptimizer(PARAM, port_obj, batch_size=128, learning_rate=0.2,
                                    device="cpu")
    for _ in range(60):
        opt.optimize_step()
    sampled = opt.sample(200)
    assert float(np.mean(sampled["x"].numpy() == 2)) > 0.8
    assert opt.best_solutions(1)[0][0] == pytest.approx(0.0)


def test_gumbel_softmax_concentrates():
    opt = P.GumbelSoftmaxOptimizer(
        PARAM, port_soft_obj, batch_size=128, learning_rate=0.1,
        temperature=1.0, anneal_rate=0.97, min_temperature=0.2, device="cpu",
    )
    for _ in range(80):
        opt.optimize_step()
    sampled = opt.sample(200, temperature=0.2)
    assert float(np.mean(sampled["x"].numpy() == 2)) > 0.7


def test_qlearning_optimizer():
    opt = P.QLearningOptimizer(PARAM, port_obj, batch_size=64, epsilon=0.3, device="cpu")
    for _ in range(30):
        opt.optimize_step()
    sampled = opt.sample(10)
    assert int(sampled["x"][0]) == 2 and int(sampled["y"][0]) == 0


def test_bayesian_ensemble_optimizer():
    opt = P.BayesianMLPEnsemblerOptimizer(
        PARAM, port_obj, batch_size=32, candidate_pool=256, num_ensemble=3, device="cpu"
    )
    for _ in range(10):
        opt.optimize_step()
    cost, sol = opt.best_solutions(1)[0]
    assert cost == pytest.approx(0.0)
    assert sol["x"] == 2


def test_bbb_optimizer_finds_optimum():
    param = {"a": [0, 1, 2, 3], "b": [0, 1, 2]}

    def obj(sol):
        return (torch.abs(sol["a"] - 2) + torch.abs(sol["b"] - 1)).to(torch.float32)

    opt = P.BayesianByBackpropOptimizer(
        param, obj, batch_size=16, num_mutations=8, train_steps=15, seed=0, device="cpu"
    )
    for _ in range(8):
        opt.optimize_step()
    best_cost, _ = opt.best_solutions(1)[0]
    assert best_cost <= 1.0
    assert opt.last_predictor_loss_mean is not None


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (lambda: P.RandomSearchOptimizer(PARAM, port_obj),
                 lambda: P.BayesianByBackpropOptimizer(PARAM, port_obj),
                 lambda: P.MLPBayesianByBackprop(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
