"""``FullyConnectedNetwork``'s options against flax's, and the modules built
on it: batch norm, dropout, layer norm (with and without
``normalize_output``), skip connections, the orthogonal init, every
activation, ``FloatFeatureFullyConnected``, ``ResidualWrapper`` and
``Sequential``; ``FullyConnectedDQN``, the critic and both actors with the
options their JAX counterparts take; the routes that run a dense chain
through K1-K3 refusing a net with a norm or a skip connection; the DQN
artifact folding the batch norm.

Weights are flax's init with the norms' parameters and batch statistics
moved off their init values, carried through ``reagent_tpu_torch.utils.
interop``; inputs come from numpy seeds.  Tolerances, float32 on two
libraries: a forward within rtol 1e-5, atol 1e-6; gradients (``jax.grad``
of a weighted sum against autograd), the batch statistics' included, within
rtol 1e-4 and an atol of 1e-6 times the gradient's largest entry (at least
1): through up to three layer norms, whose fast variance E[x^2] - E[x]^2
cancels, a gradient of scale 6 carries absolute errors of 2e-6 in float32
on both sides.  Each float32 gradient of the port is also held within that
atol of its float64 twin, the truth both round away from (measured: the
port 1.8e-6 from it, JAX 6.8e-6).  JAX's trainers differentiate the whole variables
dict, so the gradients into the batch norm's mean and var are held too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.models import actor as jax_actor
from reagent_tpu.models import fully_connected_network as jfcn
from reagent_tpu.models.critic import FullyConnectedCritic as JaxCritic
from reagent_tpu.models.dqn import FullyConnectedDQN as JaxDQN
from reagent_tpu.training.fused_dqn_trainer import FusedDQNTrainer as JaxFusedDQNTrainer
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.models import actor
from reagent_tpu_torch.models import fully_connected_network as fcn
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.ops import fused_mlp
from reagent_tpu_torch.ops.fused_dqn import extract_mlp_layout
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
from reagent_tpu_torch.utils.interop import flax_from_q_network_state, q_network_state_from_flax

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)

OPTIONS = {
    "plain": {},
    "batch_norm": dict(use_batch_norm=True),
    "layer_norm": dict(use_layer_norm=True),
    "layer_norm_output": dict(use_layer_norm=True, normalize_output=True),
    "dropout_inactive": dict(dropout_ratio=0.3),
    "skip": dict(use_skip_connections=True),
    "all": dict(use_batch_norm=True, use_layer_norm=True, dropout_ratio=0.2,
                use_skip_connections=True),
}
SIZES = [5, 8, 8, 3]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _perturb(variables, seed):
    """Move the norms' scale, bias and batch statistics off their init
    (var kept positive), so the test sees them."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.array, _np_tree(variables))

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif any(p.startswith(("BatchNorm", "LayerNorm")) or p in ("loc_ln", "scale_ln")
                     for p in path):
                noise = rng.normal(0, 0.3, v.shape).astype(np.float32)
                node[k] = np.abs(v + noise) + 0.1 if k == "var" else v + noise

    walk(out, ())
    return out


def _flax_fcn(opts, acts):
    return jfcn.FullyConnectedNetwork(sizes=SIZES, activations=acts, **opts)


def _wrap(variables):
    """A bare flax FCN's variables under the ``FullyConnectedNetwork_0``
    scope that ``q_network_state_from_flax`` reads as the port's ``net``."""
    return {col: {"FullyConnectedNetwork_0": tree} for col, tree in variables.items()}


def _port_fcn(opts, acts, variables):
    net = fcn.FullyConnectedNetwork(SIZES, acts, **opts)
    sd = q_network_state_from_flax(_wrap(variables))
    net.load_state_dict({k[len("net."):]: v for k, v in sd.items()})
    return net


def _x(seed, shape=(6, SIZES[0])):
    return np.random.default_rng(seed).normal(0, 1.5, shape).astype(np.float32)


def _grads_of_port(module, fn):
    params = dict(module.named_parameters())
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = fn(leaves)
    return out, dict(zip(leaves, torch.autograd.grad(out, list(leaves.values()))))


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_options_forward_and_gradients_match_flax(name):
    opts = OPTIONS[name]
    acts = ["relu", "tanh", "linear"]
    fmod = _flax_fcn(opts, acts)
    x = _x(1)
    variables = _perturb(fmod.init(jax.random.PRNGKey(3), jnp.asarray(x)), 4)
    net = _port_fcn(opts, acts, variables)
    want = np.asarray(fmod.apply(variables, jnp.asarray(x)))
    got = net(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **FWD)

    w = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(fmod.apply(v, jnp.asarray(x)) * w))(variables)
    _, tg = _grads_of_port(net, lambda p: torch.sum(
        torch.func.functional_call(net, p, (torch.tensor(x),)) * torch.tensor(w)))
    want_g = {k[len("net."):]: v for k, v in q_network_state_from_flax(
        _wrap(_np_tree(jg))).items()}
    assert set(want_g) == set(tg)
    # the float64 twin: the truth both float32 gradients round away from
    net64 = _port_fcn(opts, acts, variables).to(torch.float64)
    _, tg64 = _grads_of_port(net64, lambda p: torch.sum(torch.func.functional_call(
        net64, p, (torch.tensor(x, dtype=torch.float64),)) * torch.tensor(w, dtype=torch.float64)))
    for k, g in tg.items():
        scale = max(1.0, float(np.abs(want_g[k].numpy()).max()))
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=GRAD["rtol"],
                                   atol=GRAD["atol"] * scale, err_msg=k)
        np.testing.assert_allclose(g.numpy(), tg64[k].numpy(), rtol=0,
                                   atol=GRAD["atol"] * scale, err_msg=k)
    if opts.get("use_batch_norm"):
        # the trained statistics: flax's gradient reaches batch_stats
        assert any(np.abs(tg[k].numpy()).sum() > 0 for k in tg if k.endswith(".var"))


@pytest.mark.parametrize("act", fcn.ACTIVATIONS)
def test_every_activation_matches_flax(act):
    acts = [act, act, "linear"]
    fmod = _flax_fcn({}, acts)
    x = _x(2)
    variables = _np_tree(fmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    net = _port_fcn({}, acts, variables)
    np.testing.assert_allclose(net(torch.tensor(x)).detach().numpy(),
                               np.asarray(fmod.apply(variables, jnp.asarray(x))), **FWD)


@pytest.mark.parametrize("shape", [(7, SIZES[0]), (4, 3, SIZES[0])])
def test_batch_norm_training_mode_matches_flax_mutable_batch_stats(shape):
    """``training=True``: the batch's statistics (over every axis but the
    last, the biased variance) and the running averages at momentum 0.99, as
    ``apply(..., training=True, mutable=["batch_stats"])``."""
    opts = dict(use_batch_norm=True, use_layer_norm=True)
    acts = ["leaky_relu", "relu", "linear"]
    fmod = _flax_fcn(opts, acts)
    x = _x(6, shape)
    variables = _perturb(fmod.init(jax.random.PRNGKey(2), jnp.asarray(x)), 7)
    net = _port_fcn(opts, acts, variables)
    want, new_vars = fmod.apply(variables, jnp.asarray(x), training=True,
                                mutable=["batch_stats"])
    got = net(torch.tensor(x), training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    stats = _np_tree(new_vars["batch_stats"])
    for i, bn in enumerate(net.batch_norms):
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, leaf).detach().numpy(),
                                       stats[f"BatchNorm_{i}"][leaf], **FWD)


def test_module_mode_is_ignored():
    """torch's ``train()`` mode does not switch the net: only ``training``
    does, as flax's flag."""
    net = fcn.FullyConnectedNetwork(SIZES, ["relu", "relu", "linear"], use_batch_norm=True,
                                    dropout_ratio=0.5)
    x = torch.tensor(_x(3))
    net.train()
    a = net(x)
    net.eval()
    torch.testing.assert_close(a, net(x), rtol=0, atol=0)


def test_dropout_with_fed_masks_matches_flax():
    """flax draws its masks inside; the test reads them from its
    intermediates (tanh keeps every unit nonzero) and feeds them to the port."""
    opts = dict(dropout_ratio=0.4)
    acts = ["tanh", "tanh", "linear"]
    fmod = _flax_fcn(opts, acts)
    x = _x(8)
    variables = _np_tree(fmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want, inter = fmod.apply(variables, jnp.asarray(x), training=True,
                             rngs={"dropout": jax.random.PRNGKey(9)},
                             capture_intermediates=True, mutable=["intermediates"])
    masks = [torch.tensor(np.asarray(inter["intermediates"][f"Dropout_{i}"]["__call__"][0]) != 0)
             for i in range(2)]
    assert all(0 < m.float().mean() < 1 for m in masks)
    net = _port_fcn(opts, acts, variables)
    got = net(torch.tensor(x), training=True, dropout_masks=masks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    # drawn from a generator: kept units scaled by 1 / (1 - p), the rest 0
    g = torch.Generator().manual_seed(0)
    h = net(torch.tensor(x), training=True, generator=g)
    assert h.shape == got.shape and torch.isfinite(h).all()


def test_orthogonal_init_has_gain_sqrt2():
    net = fcn.FullyConnectedNetwork([6, 16, 4, 4], ["relu", "relu", "linear"],
                                    orthogonal_init=True, generator=torch.Generator().manual_seed(1))
    for layer in net.layers:
        w = layer.weight.detach().to(torch.float64)  # [out, in]
        gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        torch.testing.assert_close(gram, 2.0 * torch.eye(gram.shape[0], dtype=torch.float64),
                                   rtol=0, atol=1e-5)
        assert not torch.count_nonzero(layer.bias)


def test_float_feature_fc_residual_and_sequential_match_flax():
    x = _x(10, (5, 4))
    fmod = jfcn.FloatFeatureFullyConnected(state_dim=4, output_dim=4, sizes=[8],
                                           activations=["relu"], use_layer_norm=True)
    variables = _perturb(fmod.init(jax.random.PRNGKey(4), jnp.asarray(x)), 11)
    mod = fcn.FloatFeatureFullyConnected(4, 4, [8], ["relu"], use_layer_norm=True)
    mod.load_state_dict(q_network_state_from_flax(variables))
    np.testing.assert_allclose(mod(torch.tensor(x)).detach().numpy(),
                               np.asarray(fmod.apply(variables, jnp.asarray(x))), **FWD)
    res = jfcn.ResidualWrapper(module=fmod)
    rvars = {"params": {"module": variables["params"]}}
    np.testing.assert_allclose(fcn.ResidualWrapper(mod)(torch.tensor(x)).detach().numpy(),
                               np.asarray(res.apply(rvars, jnp.asarray(x))), **FWD)
    seq = jfcn.Sequential(layers=(fmod, fmod))
    svars = {"params": {"layers_0": variables["params"], "layers_1": variables["params"]}}
    np.testing.assert_allclose(fcn.Sequential(mod, mod)(torch.tensor(x)).detach().numpy(),
                               np.asarray(seq.apply(svars, jnp.asarray(x))), **FWD)


def _dqn_pair(opts, seed=0):
    kw = dict(state_dim=5, action_dim=3, sizes=[8, 8], activations=["relu", "leaky_relu"])
    jnet = JaxDQN(**kw, **opts)
    x = _x(seed, (6, 5))
    variables = _perturb(jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    net = FullyConnectedDQN(**kw, **opts)
    net.load_state_dict(q_network_state_from_flax(variables))
    return jnet, net, variables, x


@pytest.mark.parametrize("name", ["batch_norm", "layer_norm", "all"])
def test_models_match_flax_with_options(name):
    opts = OPTIONS[name]
    jnet, net, variables, x = _dqn_pair(opts)
    np.testing.assert_allclose(net(torch.tensor(x)).detach().numpy(),
                               np.asarray(jnet.apply(variables, jnp.asarray(x))), **FWD)
    # interop round trip, batch_stats included
    back = flax_from_q_network_state(net.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        _np_tree(variables))

    norm_opts = {k: v for k, v in opts.items() if k in ("use_batch_norm", "use_layer_norm")}
    s, a = _x(12, (6, 3)), _x(13, (6, 2))
    jc = JaxCritic(state_dim=3, action_dim=2, sizes=[8, 8], activations=["relu", "relu"],
                   **norm_opts)
    cv = _perturb(jc.init(jax.random.PRNGKey(5), jnp.asarray(s), jnp.asarray(a)), 14)
    critic = FullyConnectedCritic(3, 2, [8, 8], ["relu", "relu"], **norm_opts)
    critic.load_state_dict(q_network_state_from_flax(cv))
    np.testing.assert_allclose(critic(torch.tensor(s), torch.tensor(a)).detach().numpy(),
                               np.asarray(jc.apply(cv, jnp.asarray(s), jnp.asarray(a))), **FWD)


@pytest.mark.parametrize("action_dim", [1, 2])
def test_actors_with_norms_match_flax(action_dim):
    s = _x(20, (6, 3))
    ja = jax_actor.GaussianFullyConnectedActor(state_dim=3, action_dim=action_dim, sizes=[8, 8],
                                              activations=["relu", "relu"], use_layer_norm=True)
    av = _perturb(ja.init(jax.random.PRNGKey(6), jnp.asarray(s)), 21)
    gauss = actor.GaussianFullyConnectedActor(3, action_dim, [8, 8], ["relu", "relu"],
                                              use_layer_norm=True)
    gauss.load_state_dict(q_network_state_from_flax(av))
    want = ja.apply(av, jnp.asarray(s))
    got = gauss(torch.tensor(s))
    np.testing.assert_allclose(got.action.detach().numpy(), np.asarray(want.action), **FWD)
    np.testing.assert_allclose(got.log_prob.detach().numpy(), np.asarray(want.log_prob), **FWD)
    loc, scale_log = ja.apply(av, jnp.asarray(s), False, method="_loc_and_scale_log")
    ploc, pscale = gauss._loc_and_scale_log(torch.tensor(s))
    np.testing.assert_allclose(ploc.detach().numpy(), np.asarray(loc), **FWD)
    # the log-scale through its layer norm is held by the log-prob above: at
    # action_dim 2 it divides by |a - b| / 2 of two trunk outputs, and where
    # they nearly tie one ulp of the trunk moves it by 1e-5
    np.testing.assert_allclose(pscale.detach().numpy(), np.asarray(scale_log),
                               rtol=FWD["rtol"], atol=FWD["atol"] if action_dim == 1 else 2e-5)
    if action_dim == 1:
        # a layer norm over one feature returns its bias, as in JAX
        np.testing.assert_allclose(ploc.detach().numpy()[:, 0],
                                   np.full(6, av["params"]["loc_ln"]["bias"][0]), rtol=0, atol=0)

    jd = jax_actor.FullyConnectedActor(state_dim=3, action_dim=action_dim, sizes=[8, 8],
                                       activations=["relu", "relu"], use_batch_norm=True)
    dv = _perturb(jd.init(jax.random.PRNGKey(8), jnp.asarray(s)), 22)
    det = actor.FullyConnectedActor(3, action_dim, [8, 8], ["relu", "relu"], use_batch_norm=True)
    det.load_state_dict(q_network_state_from_flax(dv))
    np.testing.assert_allclose(det(torch.tensor(s)).action.detach().numpy(),
                               np.asarray(jd.apply(dv, jnp.asarray(s)).action), **FWD)


@pytest.mark.parametrize("name", ["batch_norm", "layer_norm", "skip"])
def test_k3_routes_take_the_modules_forward_for_a_net_that_is_not_dense(name):
    """``functional.score`` (the act step, CPE's forwards) sends only a dense
    chain to K3; a net with a norm or a skip runs its own forward (no K3
    call), and ``mlp_weight_list`` refuses it."""
    opts = OPTIONS[name]
    jnet, net, variables, x = _dqn_pair(opts, seed=3)
    params = functional.params_of(net)
    before = fused_mlp.fused_mlp_forward_reference.calls
    got = functional.score(net, params, torch.tensor(x))
    assert fused_mlp.fused_mlp_forward_reference.calls == before
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.apply(variables, jnp.asarray(x))),
                               **FWD)
    with pytest.raises(ValueError, match="not a plain dense MLP"):
        fused_mlp.mlp_weight_list(net)
    dense = FullyConnectedDQN(5, 3, [8, 8], ["relu", "relu"], dropout_ratio=0.3)
    functional.score(dense, functional.params_of(dense), torch.tensor(x))
    assert fused_mlp.fused_mlp_forward_reference.calls == before + 1


@pytest.mark.parametrize("name", ["batch_norm", "layer_norm", "skip"])
def test_fused_trainer_refuses_a_net_that_is_not_dense(name):
    """The port's ``FusedDQNTrainer`` raises ``ValueError`` on a net with a
    norm or a skip connection, and so does JAX's at ``init``: on a norm its
    layout finds more biases than kernels, and on a skip net its probe finds
    the dense chain's forward away from the module's (``ROADMAP.md`` §3)."""
    opts = OPTIONS[name]
    with pytest.raises(ValueError, match="not a plain dense MLP"):
        FusedDQNTrainer(FullyConnectedDQN(4, 2, [8, 8], ["relu", "relu"], **opts),
                        minibatch_size=8, device="cpu")
    with pytest.raises(ValueError, match="not a plain dense MLP"):
        extract_mlp_layout(FullyConnectedDQN(4, 2, [8, 8], ["relu", "relu"], **opts))
    jt = JaxFusedDQNTrainer(JaxDQN(state_dim=4, action_dim=2, sizes=[8, 8],
                                   activations=["relu", "relu"], **opts),
                            rl=JaxRLParameters(), minibatch_size=8)
    match = "activation mismatch" if name == "skip" else "not a plain dense MLP"
    with pytest.raises(ValueError, match=match):
        jt.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    # dropout never fires in a trainer: the dense chain is the same function
    FusedDQNTrainer(FullyConnectedDQN(4, 2, [8, 8], ["relu", "relu"], dropout_ratio=0.2),
                    rl=RLParameters(), minibatch_size=8, device="cpu")


def test_dqn_artifact_folds_the_batch_norm(tmp_path):
    """The running-average batch norm is affine and folds into the next
    Dense: the artifact scores what the in-process module scores (1e-4);
    a layer norm raises."""
    from reagent_tpu_torch.core.parameters import NormalizationParameters
    from reagent_tpu_torch.prediction.predictor_wrapper import (
        DiscreteDqnPredictorWrapper,
        DiscreteDqnWithPreprocessor,
        serving_layers,
    )
    from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor

    _, net, _, x = _dqn_pair(dict(use_batch_norm=True, dropout_ratio=0.1), seed=9)
    norm = {i: NormalizationParameters(feature_type="CONTINUOUS", mean=0.0, stddev=1.0)
            for i in range(5)}
    wrapped = DiscreteDqnWithPreprocessor(net, Preprocessor(norm, device="cpu"))
    wrapper = DiscreteDqnPredictorWrapper(wrapped, ["a", "b", "c"], activations=net.activations)
    wrapper.save(str(tmp_path))
    presence = np.ones_like(x)
    _, served = DiscreteDqnPredictorWrapper.load(str(tmp_path))(x, presence)
    _, live = wrapper(torch.tensor(x), torch.tensor(presence))
    np.testing.assert_allclose(served, live.numpy(), rtol=0, atol=1e-4)
    _, ln_net, _, _ = _dqn_pair(dict(use_layer_norm=True))
    with pytest.raises(ValueError, match="layer norm"):
        serving_layers(ln_net)
