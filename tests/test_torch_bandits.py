"""The bandit models, trainers and MAB algorithms against the JAX package.

Each case feeds the same numpy inputs to both packages; a trainer step
starts from JAX's state carried across (``interop.linucb_state_from_arrays``
and its siblings, ``deep_represent_state_from_flax``, ``opt_state_from_optax``),
and every random choice takes JAX's own draws (the gumbels of its
``categorical``, its permutations, its Beta, gamma and normal draws).

Tolerances: the accumulations (``update``, the one-hot sums) rtol 1e-5,
atol 1e-6, float32 products summed in each library's order.  The
pseudo-inverse amplifies that rounding by the condition number it keeps,
at most ``1 / (10 * D * eps)`` under JAX's cutoff: the inverses and
coefficients are held at ``PINV_TOL`` (2e-4) times their largest entry and
the UCB scores at rtol 1e-4, atol 1e-4.  The MLP steps (supervised,
deep-represent) hold losses at rtol 1e-5 and parameters at rtol 1e-4, atol
1e-5, one Adam step from one state.  The MAB scores and regrets are equal
(rtol 1e-6) and the chosen arms identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import types as jrlt
from reagent_tpu import mab as jmab
from reagent_tpu.mab import simulation as jsim
from reagent_tpu.models import deep_represent_linucb as jdr
from reagent_tpu.models import linear_regression as jlr
from reagent_tpu.models.fully_connected_network import FullyConnectedNetwork as JaxFCN
from reagent_tpu.training import cb as jcb
from reagent_tpu.training.cb import utils as jutils
from reagent_tpu_torch import mab
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.mab import simulation as sim
from reagent_tpu_torch.models import linear_regression as lr
from reagent_tpu_torch.models.cb_fully_connected_network import CBFullyConnectedNetwork
from reagent_tpu_torch.models.deep_represent_linucb import DeepRepresentLinearRegressionUCB
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
from reagent_tpu_torch.training import cb
from reagent_tpu_torch.training.cb import utils
from reagent_tpu_torch.utils import interop

ACC = dict(rtol=1e-5, atol=1e-6)
PINV_TOL = 2e-4
UCB = dict(rtol=1e-4, atol=1e-4)
LOSS = dict(rtol=1e-5, atol=1e-7)
PARAM = dict(rtol=1e-4, atol=1e-5)


def t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), **tol)


def close_scaled(got, want, tol=PINV_TOL):
    """|got - want| within ``tol`` of ``want``'s largest entry."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), (
        np.abs(got - want).max(), np.abs(want).max())


def linucb_arrays(state):
    return {k: np.asarray(getattr(state, k)) for k in
            ("avg_A", "avg_b", "sum_weight", "num_obs", "coefs", "inv_avg_A")}


def assert_linucb_close(got, want):
    close(got.avg_A, want.avg_A, **ACC)
    close(got.avg_b, want.avg_b, **ACC)
    close(got.sum_weight, want.sum_weight, rtol=1e-6)
    assert int(got.num_obs) == int(want.num_obs)
    close_scaled(got.coefs, want.coefs)
    close_scaled(got.inv_avg_A, want.inv_avg_A)


# ------------------------------------------------------------------ LinUCB


@pytest.mark.parametrize("D", [4, 16, 64])
def test_batch_quadratic_form(D):
    rng = np.random.default_rng(D)
    x = rng.normal(size=(32, D)).astype(np.float32)
    A = rng.normal(size=(D, D)).astype(np.float32)
    close(lr.batch_quadratic_form(t(x), t(A)), jlr.batch_quadratic_form(x, A), rtol=1e-5,
          atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("D", [4, 16, 64])
def test_linucb_model(D, weighted):
    """update (twice), calculate_coefs, apply_discounting and forward, each
    from JAX's state."""
    rng = np.random.default_rng(D + 100 * weighted)
    jm = jlr.LinearRegressionUCB(input_dim=D, l2_reg_lambda=0.5, ucb_alpha=1.5, gamma=0.9)
    m = lr.LinearRegressionUCB(input_dim=D, l2_reg_lambda=0.5, ucb_alpha=1.5, gamma=0.9)
    jstate = jm.init()
    for i in range(2):
        x = rng.normal(size=(48, D)).astype(np.float32)
        y = rng.normal(size=48).astype(np.float32)
        w = rng.uniform(0.5, 2.0, size=48).astype(np.float32) if weighted else None
        state = interop.linucb_state_from_arrays(**linucb_arrays(jstate))
        got = m.update(state, t(x), t(y), None if w is None else t(w))
        jstate = jm.update(jstate, x, y, w)
        assert_linucb_close(got, jstate)
    got = m.calculate_coefs(interop.linucb_state_from_arrays(**linucb_arrays(jstate)))
    jstate = jm.calculate_coefs(jstate)
    assert_linucb_close(got, jstate)
    got = m.apply_discounting(interop.linucb_state_from_arrays(**linucb_arrays(jstate)))
    jdisc = jm.apply_discounting(jstate)
    close(got.sum_weight, jdisc.sum_weight, rtol=1e-7)
    xs = rng.normal(size=(20, D)).astype(np.float32)
    state = interop.linucb_state_from_arrays(**linucb_arrays(jstate))
    for alpha in (None, 0.0):
        out, jout = m.forward(state, t(xs), alpha), jm.forward(jstate, xs, alpha)
        for k in ("pred_label", "pred_sigma", "ucb"):
            close(out[k], jout[k], **UCB)


def test_pinv_keeps_jax_cutoff():
    """Singular values between torch's default cutoff (D eps s1) and JAX's
    (10 D eps s1): the port zeroes them as JAX does; torch.linalg.pinv with
    its default rtol would invert them."""
    D, rank = 16, 8
    rng = np.random.default_rng(5)
    basis = np.linalg.qr(rng.normal(size=(D, rank)))[0].astype(np.float32)
    x = (rng.normal(size=(32, rank)) @ basis.T).astype(np.float32)
    y = rng.normal(size=32).astype(np.float32)
    w = np.full(32, 3125.0, np.float32)  # sum_weight 1e5: the ridge is 1e-5
    jm = jlr.LinearRegressionUCB(input_dim=D)
    jstate = jm.update(jm.init(), x, y, w)
    A_ext = np.asarray(jstate.avg_A) + np.eye(D, dtype=np.float32) / float(jstate.sum_weight)
    s = np.linalg.svd(A_ext, compute_uv=False)
    eps = np.finfo(np.float32).eps
    between = (s > D * eps * s[0]) & (s <= 10 * D * eps * s[0])
    assert between.sum() == D - rank, s  # the ridge directions, and only they
    state = interop.linucb_state_from_arrays(**linucb_arrays(jstate))
    got = lr.LinearRegressionUCB(input_dim=D).calculate_coefs(state)
    jstate = jm.calculate_coefs(jstate)
    close_scaled(got.inv_avg_A, jstate.inv_avg_A)
    close_scaled(got.coefs, jstate.coefs)
    default = torch.linalg.pinv(t(A_ext))
    assert (default - t(jstate.inv_avg_A)).abs().max() > 1e4  # 1 / 1e-5 on the ridge


def test_linucb_at_500_features_from_the_dynamic_run():
    """calculate_coefs and forward at D 500 from JAX's state after 25 steps
    of run_dynamic_bandit_env at DynamicBanditEnv's defaults (400 ridge
    singular values between the two cutoffs there)."""
    from reagent_tpu.evaluation.cb import synthetic_contextual_bandit_data as jsyn

    rng = jax.random.PRNGKey(937162211)
    env = jsyn.DynamicBanditEnv(rng=rng)
    agent = jsyn.DynamicBanditAgent.make_agent(feature_dim=500)
    jstate = agent.init_state()
    for _ in range(25):
        rng, sub = jax.random.split(rng)
        obs, rewards_all = env.get_batch(sub)
        action, _ = agent.act(jstate, obs)
        obs = env.add_chosen_action_reward(action.reshape(-1), obs, rewards_all)
        jstate, _ = agent.learn(jstate, obs)
    arrays = linucb_arrays(jstate)
    jstate = agent.trainer.scorer.calculate_coefs(jstate)
    A_ext = arrays["avg_A"] + np.eye(500, dtype=np.float32) / arrays["sum_weight"]
    s = np.linalg.svd(A_ext.astype(np.float64), compute_uv=False)
    eps = np.finfo(np.float32).eps
    assert ((s > 500 * eps * s[0]) & (s <= 5000 * eps * s[0])).sum() == 400
    m = lr.LinearRegressionUCB(input_dim=500)
    got = m.calculate_coefs(interop.linucb_state_from_arrays(**arrays))
    close_scaled(got.inv_avg_A, jstate.inv_avg_A)
    close_scaled(got.coefs, jstate.coefs)
    feats = np.asarray(obs.context_arm_features).reshape(-1, 500)
    out, jout = m.forward(got, t(feats)), agent.trainer.scorer.forward(jstate, feats)
    for k in ("pred_label", "pred_sigma", "ucb"):
        close(out[k], jout[k], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("D", [4, 16, 64])
def test_disjoint_linucb_model(D):
    K = 3
    rng = np.random.default_rng(D)
    jm = jlr.DisjointLinearRegressionUCB(num_arms=K, input_dim=D, l2_reg_lambda=0.5)
    m = lr.DisjointLinearRegressionUCB(num_arms=K, input_dim=D, l2_reg_lambda=0.5)
    jstate = jm.init()
    init = m.init("cpu")
    close(init.A, jstate.A, rtol=0, atol=0)
    close(init.inv_A, jstate.inv_A, rtol=0, atol=0)
    x = rng.normal(size=(96, D)).astype(np.float32)
    y = rng.normal(size=96).astype(np.float32)
    arm = rng.integers(0, K, 96)
    got = m.update(init, t(arm), t(x), t(y))
    jstate = jm.update(jstate, jnp.asarray(arm), x, y)
    close(got.A, jstate.A, rtol=1e-5, atol=1e-4)
    close(got.b, jstate.b, rtol=1e-5, atol=1e-4)
    assert int(got.num_obs) == 96
    carried = interop.disjoint_linucb_state_from_arrays(
        **{k: np.asarray(getattr(jstate, k)) for k in ("A", "b", "inv_A", "coefs", "num_obs")})
    got = m.calculate_coefs(carried)
    jstate = jm.calculate_coefs(jstate)
    close_scaled(got.inv_A, jstate.inv_A)
    close_scaled(got.coefs, jstate.coefs)
    xs = rng.normal(size=(10, D)).astype(np.float32)
    out, jout = m.forward(got, t(xs), 2.0), jm.forward(jstate, xs, 2.0)
    for k in ("pred_label", "pred_sigma", "ucb"):
        assert out[k].shape == (10, K)
        close(out[k], jout[k], **UCB)


# ---------------------------------------------------------------- trainers


def cb_batch(rng, B, K, D, weighted=False, w=None):
    feats = rng.normal(size=(B, K, D)).astype(np.float32)
    action = rng.integers(0, K, B)
    if w is None:
        reward = rng.normal(size=B).astype(np.float32)
    else:
        reward = np.abs(feats[np.arange(B), action] @ w).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, size=(B, 1)).astype(np.float32) if weighted else None
    jb = jrlt.CBInput(context_arm_features=jnp.asarray(feats),
                      action=jnp.asarray(action).reshape(-1, 1),
                      reward=jnp.asarray(reward).reshape(-1, 1),
                      weight=None if weight is None else jnp.asarray(weight))
    b = rlt.CBInput(context_arm_features=t(feats), action=t(action).reshape(-1, 1),
                    reward=t(reward).reshape(-1, 1), weight=None if weight is None else t(weight))
    return jb, b


@pytest.mark.parametrize("weighted", [False, True])
def test_linucb_trainer_in_lockstep(weighted):
    """10 steps, each train_step + on_epoch_end from JAX's state, and the
    scores of every arm."""
    B, K, D = 16, 4, 8
    rng = np.random.default_rng(3)
    jt = jcb.LinUCBTrainer(jlr.LinearRegressionUCB(input_dim=D, gamma=0.95))
    pt = cb.LinUCBTrainer(lr.LinearRegressionUCB(input_dim=D, gamma=0.95))
    jstate = jt.init()
    for _ in range(10):
        jb, b = cb_batch(rng, B, K, D, weighted)
        state = interop.linucb_state_from_arrays(**linucb_arrays(jstate))
        got, m = pt.train_step(state, b)
        jstate, jm = jt.train_step(jstate, jb)
        assert int(m["num_obs"]) == int(jm["num_obs"])
        assert_linucb_close(got, jstate)
        got = pt.on_epoch_end(interop.linucb_state_from_arrays(**linucb_arrays(jstate)))
        jstate = jt.on_epoch_end(jstate)
        assert_linucb_close(got, jstate)
        close(got.sum_weight, jstate.sum_weight, rtol=1e-6)
        close(pt.score(got, b), jt.score(jstate, jb), **UCB)


def test_disjoint_linucb_trainer_in_lockstep():
    B, K, D = 24, 3, 6
    rng = np.random.default_rng(4)
    jt = jcb.DisjointLinUCBTrainer(jlr.DisjointLinearRegressionUCB(num_arms=K, input_dim=D))
    pt = cb.DisjointLinUCBTrainer(lr.DisjointLinearRegressionUCB(num_arms=K, input_dim=D))
    jstate = jt.init()
    names = ("A", "b", "inv_A", "coefs", "num_obs")
    for _ in range(10):
        jb, b = cb_batch(rng, B, K, D)
        state = interop.disjoint_linucb_state_from_arrays(
            **{k: np.asarray(getattr(jstate, k)) for k in names})
        got, m = pt.train_step(state, b)
        jstate, _ = jt.train_step(jstate, jb)
        close(got.A, jstate.A, rtol=1e-5, atol=1e-4)
        close(got.b, jstate.b, rtol=1e-5, atol=1e-4)
        got = pt.on_epoch_end(got)
        jstate = jt.on_epoch_end(jstate)
        close_scaled(got.inv_A, jstate.inv_A)
        close_scaled(got.coefs, jstate.coefs)


def supervised_nets(D, skip, layer_norm):
    sizes, acts = [D, 16, 16, 1], ["relu", "relu", "linear"]
    jnet = JaxFCN(sizes=sizes, activations=acts, use_skip_connections=skip,
                  use_layer_norm=layer_norm)
    net = FullyConnectedNetwork(sizes, acts, use_skip_connections=skip,
                                use_layer_norm=layer_norm)
    return jnet, net


@pytest.mark.parametrize("skip,layer_norm", [(False, False), (True, False), (True, True)])
def test_supervised_trainer_in_lockstep(skip, layer_norm):
    B, K, D = 32, 3, 6
    rng = np.random.default_rng(6)
    jnet, net = supervised_nets(D, skip, layer_norm)
    config = {"Adam": {"lr": 0.01}}
    jt = jcb.SupervisedTrainer(jnet, config)
    pt = cb.SupervisedTrainer(net, config, device="cpu")
    jstate = jt.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))
    for _ in range(10):
        jb, b = cb_batch(rng, B, K, D)
        params = jax.tree_util.tree_map(np.asarray, jstate.params)
        state = interop.supervised_trainer_state_from_arrays(
            params, interop.opt_state_from_optax(jstate.opt_state), jstate.step)
        got, m = pt.train_step(state, b)
        jstate, jm = jt.train_step(jstate, jb)
        close(m["loss"], jm["loss"], **LOSS)
        want = interop._params_on(jax.tree_util.tree_map(np.asarray, jstate.params), "cpu")
        assert set(got.params) == set(want)
        for k in want:
            close(got.params[k], want[k], **PARAM)
        assert int(got.step) == int(jstate.step)


def test_cb_fully_connected_network_forward():
    """CBFullyConnectedNetwork (skips and layer norm on) against flax's."""
    from reagent_tpu.models.cb_fully_connected_network import (
        CBFullyConnectedNetwork as JaxCBFCN,
    )

    D = 5
    jnet = JaxCBFCN(input_dim=D, hidden_layer_dims=[8, 8], use_layer_norm=True)
    x = np.random.default_rng(0).normal(size=(7, 3, D)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(1), x))
    net = CBFullyConnectedNetwork(D, [8, 8], use_layer_norm=True)
    net.load_state_dict(interop.cb_fcn_state_from_flax(params))
    out, jout = net(t(x)), jnet.apply(params, x)
    for k in ("pred_label", "pred_sigma", "ucb"):
        assert out[k].shape == (7, 3)
        close(out[k], jout[k], rtol=1e-5, atol=1e-6)


def deep_state_from(jstate):
    as_np = jax.tree_util.tree_map(np.asarray, jstate)
    return interop.deep_represent_trainer_state_from_arrays(
        as_np.mlp_params, interop.opt_state_from_optax(jstate.opt_state),
        linucb_arrays(as_np.linucb))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_deep_represent_trainer_in_lockstep(weight_decay):
    """The JAX test's sizes (D 6, K 4, [16, 4] relu), 10 steps under Adam
    and AdamW, each from JAX's state; then score (K3's plain version on the
    CPU) against JAX's."""
    B, K, D = 32, 4, 6
    rng = np.random.default_rng(9)
    w = rng.normal(size=D).astype(np.float32)
    js = jdr.DeepRepresentLinearRegressionUCB(input_dim=D, sizes=[16, 4],
                                              activations=["relu", "relu"])
    ps = DeepRepresentLinearRegressionUCB(input_dim=D, sizes=[16, 4],
                                          activations=["relu", "relu"])
    jt = jcb.DeepRepresentLinUCBTrainer(js, lr=3e-3, weight_decay=weight_decay)
    pt = cb.DeepRepresentLinUCBTrainer(ps, lr=3e-3, weight_decay=weight_decay, device="cpu")
    jstate = jt.init(jax.random.PRNGKey(0))
    for _ in range(10):
        jb, b = cb_batch(rng, B, K, D, weighted=True, w=w)
        got, m = pt.train_step(deep_state_from(jstate), b)
        jstate, jm = jt.train_step(jstate, jb)
        close(m["mse_loss"], jm["mse_loss"], **LOSS)
        assert int(m["num_obs"]) == int(jm["num_obs"])
        want = interop.deep_represent_state_from_flax(
            jax.tree_util.tree_map(np.asarray, jstate.mlp_params))
        for k in want:
            close(got.mlp_params[k], want[k], **PARAM)
        close(got.linucb.avg_A, jstate.linucb.avg_A, rtol=1e-4, atol=1e-6)
        close_scaled(got.linucb.inv_avg_A, jstate.linucb.inv_avg_A)
    feats = rng.normal(size=(64, K, D)).astype(np.float32)
    state = deep_state_from(jstate)
    for alpha in (None, 0.0):
        close(pt.score(state, rlt.CBInput(context_arm_features=t(feats)), alpha),
              jt.score(jstate, jrlt.CBInput(context_arm_features=jnp.asarray(feats)), alpha),
              **UCB)
    out = ps.forward_deep(state.mlp_params, state.linucb, t(feats[:, 0]))
    jout = js.forward_deep(jstate.mlp_params, jstate.linucb, feats[:, 0])
    for k in ("pred_label", "pred_sigma", "ucb", "mlp_out_with_ones"):
        close(out[k], jout[k], **UCB)


# ------------------------------------------------------------------- utils


def test_add_chosen_arm_features():
    feats = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    arms = np.array([[10, 11, 12], [20, 21, 22]])
    action = np.array([[2], [0]])
    jout = jutils.add_chosen_arm_features(jrlt.CBInput(
        context_arm_features=jnp.asarray(feats), action=jnp.asarray(action),
        arms=jnp.asarray(arms)))
    out = utils.add_chosen_arm_features(rlt.CBInput(
        context_arm_features=t(feats), action=t(action), arms=t(arms)))
    close(out.features_of_chosen_arm, jout.features_of_chosen_arm, rtol=0, atol=0)
    close(out.chosen_arm_id, jout.chosen_arm_id, rtol=0, atol=0)
    listed = utils.add_chosen_arm_features([rlt.CBInput(context_arm_features=torch.ones(4, 5))])
    close(listed[0].features_of_chosen_arm, np.ones((4, 5)), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_argmax_random_tie_breaks_fed_jax_permutation(seed):
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 3, size=(8, 6)).astype(np.float32)  # many ties
    mask = (rng.uniform(size=(8, 6)) > 0.3).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    perm = np.asarray(jax.random.permutation(key, 6))
    for m in (None, mask):
        want = jutils.argmax_random_tie_breaks(scores, None if m is None else jnp.asarray(m),
                                               key)
        got = utils.argmax_random_tie_breaks(t(scores), None if m is None else t(m), t(perm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            utils.get_model_actions(t(scores), None if m is None else t(m), True, t(perm)),
            jutils.get_model_actions(scores, m, True, key))
    with pytest.raises(ValueError):
        utils.argmax_random_tie_breaks(t(scores))
    idx = utils.argmax_random_tie_breaks(torch.zeros(6, 4),
                                         generator=torch.Generator().manual_seed(0))
    assert (idx == idx[0]).all()


def test_get_model_actions_with_masks():
    scores = np.array([[1.0, 5.0, 3.0], [9.0, 0.0, 2.0]], np.float32)
    mask = np.array([[1, 0, 1], [0, 1, 1]])
    for m in (None, mask):
        np.testing.assert_array_equal(
            utils.get_model_actions(t(scores), None if m is None else t(m)).numpy(),
            np.asarray(jutils.get_model_actions(scores, m)))


# --------------------------------------------------------------------- MAB


def mab_state(algo_cls, jalgo):
    jstate = jalgo.init()
    n = jnp.array([10.0, 3.0, 7.0, 1.0])
    s = jnp.array([6.0, 1.0, 5.0, 1.0])
    jstate = jalgo.add_batch_observations(jstate, n, s, s * 1.3)
    extra = None if jstate.extra is None else {k: np.asarray(v) for k, v in jstate.extra.items()}
    state = interop.mab_state_from_arrays(
        np.asarray(jstate.total_n_obs_per_arm), np.asarray(jstate.total_sum_reward_per_arm),
        np.asarray(jstate.total_sum_reward_squared_per_arm), extra)
    return jstate, state


def jax_score_draws(name, jstate, key):
    """The draws JAX's ``get_scores(state, key)`` samples from."""
    if name == "RandomActionsAlgo":
        return np.asarray(jax.random.uniform(key, (4,)))
    if name == "BernoulliBetaThompson":
        alpha = 1.0 + jstate.total_sum_reward_per_arm
        beta = 1.0 + jstate.total_n_obs_per_arm - jstate.total_sum_reward_per_arm
        return np.asarray(jax.random.beta(key, alpha, beta))
    if name == "NormalGammaThompson":
        r1, r2 = jax.random.split(key)
        return np.stack([np.asarray(jax.random.gamma(r1, jstate.extra["alpha_0"])),
                         np.asarray(jax.random.normal(r2, (4,)))])
    return None


ALGOS = ["UCB1", "MetricUCB", "UCBTuned", "GreedyAlgo", "RandomActionsAlgo",
         "BernoulliBetaThompson", "NormalGammaThompson"]


def algos(name, **kw):
    from reagent_tpu.mab import mab_algorithm as jbase

    jcls = getattr(jmab, name, None) or getattr(jbase, name)
    return jcls(n_arms=4, **kw), getattr(mab, name)(n_arms=4, **kw)


@pytest.mark.parametrize("name", ALGOS + ["UCB1-no-variance", "UCBTuned-no-variance"])
def test_mab_scores_and_actions_fed_jax_draws(name):
    """Every algorithm's scores on one state, then get_action fed JAX's
    gumbels and score draws, on that state and on one with an unseen arm."""
    base, _, novar = name.partition("-")
    jalgo, algo = algos(base, **({"estimate_variance": False} if novar else {}))
    jstate, state = mab_state(base, jalgo)
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        draws = jax_score_draws(base, jstate, key)
        got = algo.get_scores(state, None if draws is None else t(draws))
        close(got, jalgo.get_scores(jstate, key), rtol=1e-6, atol=1e-7)
        r1, r2 = jax.random.split(key)
        g = np.asarray(jax.random.gumbel(r1, (4,)))
        draws = jax_score_draws(base, jstate, r2)
        assert algo.get_action(state, t(g), None if draws is None else t(draws)) == \
            jalgo.get_action(jstate, key)
        fresh = jalgo.init()
        assert algo.get_action(algo.init("cpu"), t(g)) == jalgo.get_action(fresh, key)
    sampled = algo.get_scores(state, generator=torch.Generator().manual_seed(0))
    assert sampled.shape == (4,) and torch.isfinite(sampled).all()


def test_randomized_argmax_fed_jax_gumbels():
    x = np.array([1.0, 3.0, 3.0, 0.5, 3.0], np.float32)
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        g = np.asarray(jax.random.gumbel(key, (5,)))
        assert int(mab.randomized_argmax(t(x), t(g))) == int(jmab.randomized_argmax(x, key))


def test_standard_gamma_moments():
    """The generator's Gamma draws (alpha below and above 1): mean alpha,
    variance alpha, within 5 standard errors over 20,000 draws."""
    alpha = torch.tensor([0.3, 1.0, 1.5, 7.0]).repeat(20000, 1)
    x = mab.mab_algorithm.standard_gamma(alpha, torch.Generator().manual_seed(0))
    a = alpha[0]
    assert ((x.mean(0) - a).abs() < 5 * torch.sqrt(a / 20000)).all(), x.mean(0)
    assert ((x.var(0) - a).abs() / a < 0.1).all(), x.var(0)


def jax_ucb1_draws(seed, T, K):
    """The draws of JAX's single_evaluation_bandit_algo for an algorithm that
    samples no scores: per step split(rng, 3) -> (rng, r_act, r_rew), the
    gumbels of split(r_act)[0] and the reward's uniform."""
    rng = jax.random.PRNGKey(seed)
    gumbels, uniforms = [], []
    for _ in range(T):
        rng, r_act, r_rew = jax.random.split(rng, 3)
        r1, _ = jax.random.split(r_act)
        gumbels.append(jax.random.gumbel(r1, (K,)))
        uniforms.append(jax.random.uniform(r_rew, ()))
    return {"gumbels": t(np.stack(gumbels)), "uniforms": t(np.stack(uniforms))}


def test_ucb1_regret_trajectory_fed_jax_draws():
    """400 UCB1 steps on [0.2, 0.8, 0.5] fed JAX's draws: JAX's regrets."""
    probs = np.array([0.2, 0.8, 0.5], np.float32)
    want = jsim.single_evaluation_bandit_algo(
        jsim.BernoulliMAB(max_steps=400, probs=jnp.asarray(probs)), jmab.UCB1(n_arms=3), seed=0)
    got = sim.single_evaluation_bandit_algo(
        sim.BernoulliMAB(max_steps=400, probs=probs, device="cpu"), mab.UCB1(n_arms=3),
        draws=jax_ucb1_draws(0, 400, 3))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_mab_trainer_bridge():
    """CBInput batches into UCB1's sums, against JAX's MABTrainer."""
    jt, pt = jcb.MABTrainer(jmab.UCB1(n_arms=3)), cb.MABTrainer(mab.UCB1(n_arms=3))
    jstate, state = jt.init(), pt.init("cpu")
    rng = np.random.default_rng(0)
    means = np.array([0.2, 0.8, 0.5])
    for i in range(20):
        actions = rng.integers(0, 3, size=16)
        rewards = rng.binomial(1, means[actions]).astype(np.float32)
        weight = rng.uniform(0.5, 2, size=(16, 1)).astype(np.float32) if i % 2 else None
        jstate, jm = jt.train_step(jstate, jrlt.CBInput(
            context_arm_features=jnp.zeros((16, 3, 1)), action=jnp.asarray(actions)[:, None],
            reward=jnp.asarray(rewards)[:, None],
            weight=None if weight is None else jnp.asarray(weight)))
        state, m = pt.train_step(state, rlt.CBInput(
            context_arm_features=torch.zeros(16, 3, 1), action=t(actions)[:, None],
            reward=t(rewards)[:, None], weight=None if weight is None else t(weight)))
        close(m["num_obs"], jm["num_obs"], rtol=1e-6)
    for k in ("total_n_obs_per_arm", "total_sum_reward_per_arm",
              "total_sum_reward_squared_per_arm"):
        close(getattr(state, k), getattr(jstate, k), rtol=1e-6)
    close(pt.score(state), jt.score(jstate), rtol=1e-6)
    assert int(torch.argmax(pt.score(state))) == 1


# ----------------------------------------------- the JAX tests' own bars


def test_mab_ucb1_bar_on_the_port():
    """tests/test_cb_mab.py::test_mab_ucb1_finds_best_arm, from the port's
    generator."""
    regret = sim.single_evaluation_bandit_algo(
        sim.BernoulliMAB(max_steps=400, probs=[0.2, 0.8, 0.5], device="cpu"), mab.UCB1(n_arms=3),
        seed=0)
    assert regret[-1] - regret[-100] < (regret[99] - regret[0]) * 0.8
    assert regret[-1] < 0.6 * 0.5 * 400


@pytest.mark.parametrize("name", ["MetricUCB", "UCBTuned", "BernoulliBetaThompson"])
def test_mab_algos_beat_random_on_the_port(name):
    regret = sim.single_evaluation_bandit_algo(
        sim.BernoulliMAB(max_steps=300, probs=[0.1, 0.9], device="cpu"),
        getattr(mab, name)(n_arms=2), seed=1)
    assert regret[-1] < 0.4 * 0.8 * 300 / 2


def test_compare_bandit_algos_on_the_port():
    out = sim.compare_bandit_algos([mab.UCB1, mab.GreedyAlgo, mab.NormalGammaThompson],
                                   sim.BernoulliMAB(max_steps=50, probs=[0.1, 0.9], device="cpu"),
                                   n_trials=2)
    assert set(out) == {"UCB1", "GreedyAlgo", "NormalGammaThompson"}
    assert all(v.shape == (50,) and np.all(np.diff(v) >= 0) for v in out.values())


def test_linucb_bars_on_the_port():
    """tests/test_cb_mab.py's LinUCB fits: exact-fit coefficients, the
    incremental update, the trainer and the disjoint trainer."""
    rng = np.random.default_rng(0)
    w = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    model = lr.LinearRegressionUCB(input_dim=4, l2_reg_lambda=1e-6)
    x = rng.normal(size=(500, 4)).astype(np.float32)
    state = model.calculate_coefs(model.update(model.init("cpu"), t(x), t(x @ w)))
    close(state.coefs, w, atol=1e-3)
    out = model.forward(state, t(x[:5]), ucb_alpha=0.0)
    close(out["ucb"], x[:5] @ w, atol=1e-3)
    assert (model.forward(state, t(x[:5]), ucb_alpha=1.0)["ucb"] >= out["ucb"]).all()
    B, K, D = 300, 2, 3
    wd = np.array([[1.0, 0.0, 2.0], [0.0, -1.0, 1.0]], np.float32)
    feats = rng.normal(size=(B, K, D)).astype(np.float32)
    actions = rng.integers(0, K, B)
    rewards = np.einsum("bd,bd->b", feats[np.arange(B), actions], wd[actions])
    trainer = cb.DisjointLinUCBTrainer(
        lr.DisjointLinearRegressionUCB(num_arms=K, input_dim=D, l2_reg_lambda=1e-4))
    dstate, _ = trainer.train_step(trainer.init("cpu"), rlt.CBInput(
        context_arm_features=t(feats), action=t(actions).reshape(-1, 1),
        reward=t(rewards).reshape(-1, 1)))
    close(trainer.on_epoch_end(dstate).coefs, wd, atol=0.05)


def test_normal_gamma_update_on_the_port():
    algo = mab.NormalGammaThompson(n_arms=2)
    state = algo.add_batch_observations(algo.init("cpu"), torch.tensor([10.0, 0.0]),
                                        torch.tensor([50.0, 0.0]), torch.tensor([260.0, 0.0]))
    assert float(state.extra["mus"][0]) == pytest.approx(50.0 / 11, rel=1e-3)
    assert float(state.extra["mus"][1]) == 0.0
    assert algo.get_scores(state, generator=torch.Generator().manual_seed(0)).shape == (2,)


@pytest.mark.parametrize("seed", range(5))
def test_normal_gamma_own_update_against_jax(seed):
    """The port's own ``add_batch_observations`` and ``add_single_observation``
    from the prior of ``init``, beside JAX's: 6 batches whose arms draw
    nothing now and then, then 10 single observations; the posterior and the
    sums after each, rtol 1e-6 (float32 updates in each library's order)."""
    rng = np.random.default_rng(seed)
    jalgo, algo = jmab.NormalGammaThompson(n_arms=4), mab.NormalGammaThompson(n_arms=4)
    jstate, state = jalgo.init(), algo.init("cpu")

    def check():
        for k, v in jstate.extra.items():
            close(state.extra[k], v, rtol=1e-6, atol=1e-7)
        for k in ("total_n_obs_per_arm", "total_sum_reward_per_arm",
                  "total_sum_reward_squared_per_arm"):
            close(getattr(state, k), getattr(jstate, k), rtol=1e-6, atol=1e-7)

    for _ in range(6):
        n = rng.integers(0, 5, 4).astype(np.float32) * (rng.uniform(size=4) > 0.3)
        r = rng.normal(1.0, 2.0, (4, 5)).astype(np.float32) * (np.arange(5) < n[:, None])
        s, s2 = r.sum(1), (r ** 2).sum(1)
        jstate = jalgo.add_batch_observations(jstate, jnp.asarray(n), jnp.asarray(s),
                                              jnp.asarray(s2))
        state = algo.add_batch_observations(state, t(n), t(s), t(s2))
        check()
    assert (np.asarray(jstate.total_n_obs_per_arm) > 0).any()
    for arm, reward in zip(rng.integers(0, 4, 10), rng.normal(size=10).astype(np.float32)):
        arm_id = algo.arm_ids[arm]
        jstate = jalgo.add_single_observation(jstate, arm_id, float(reward))
        state = algo.add_single_observation(state, arm_id, float(reward))
        check()


# ------------------------------------------------ the entry points' device


def _default_device_entry_points():
    """Each entry point of the slice called with its default device: a
    tensor it made there."""
    from reagent_tpu_torch.evaluation.cb import PolicyEvaluator
    from reagent_tpu_torch.evaluation.cb import synthetic_contextual_bandit_data as syn

    def deep():
        scorer = DeepRepresentLinearRegressionUCB(input_dim=3, sizes=[4], activations=["relu"])
        return scorer, torch.Generator().manual_seed(0)

    return {
        "run_dynamic_bandit_env": lambda: syn.run_dynamic_bandit_env(2, 1, 2, 3, 1)[0]
        .init_state().avg_A,
        "DynamicBanditEnv": lambda: syn.DynamicBanditEnv(2, 1, 2, 3).mf,
        "DynamicBanditAgent.make_agent": lambda: syn.DynamicBanditAgent.make_agent(3)
        .init_state().avg_A,
        "BernoulliMAB": lambda: sim.BernoulliMAB(5, [0.2, 0.8]).expected_rewards,
        "MABAlgo.init": lambda: mab.NormalGammaThompson(n_arms=2).init().extra["mus"],
        "gumbel": lambda: mab.mab_algorithm.gumbel((2,)),
        "LinearRegressionUCB.init": lambda: lr.LinearRegressionUCB(input_dim=3).init().avg_A,
        "DisjointLinearRegressionUCB.init": lambda: lr.DisjointLinearRegressionUCB(
            num_arms=2, input_dim=3).init().A,
        "LinUCBTrainer.init": lambda: cb.LinUCBTrainer(lr.LinearRegressionUCB(3)).init().avg_b,
        "DisjointLinUCBTrainer.init": lambda: cb.DisjointLinUCBTrainer(
            lr.DisjointLinearRegressionUCB(2, 3)).init().b,
        "MABTrainer.init": lambda: cb.MABTrainer(mab.UCB1(n_arms=2)).init().total_n_obs_per_arm,
        "SupervisedTrainer": lambda: cb.SupervisedTrainer(
            FullyConnectedNetwork([3, 1], ["linear"])).init().step,
        "DeepRepresentLinUCBTrainer": lambda: cb.DeepRepresentLinUCBTrainer(deep()[0]).init(
            deep()[1]).linucb.avg_A,
        "DeepRepresentLinearRegressionUCB.init_deep": lambda: next(iter(
            deep()[0].init_deep(deep()[1]).values())),
        "PolicyEvaluator.init_state": lambda: PolicyEvaluator().init_state().frac_accepted,
    }


@pytest.mark.parametrize("name", sorted(_default_device_entry_points()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Every entry point defaults to ``"cuda"`` through ``resolve_device``:
    with no card it raises and names ``device='cpu'``, never dropping to the
    CPU on its own (the card's side: ``test_torch_cuda_bandits.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        _default_device_entry_points()[name]()
