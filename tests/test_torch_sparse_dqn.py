"""The embedding bags and ``SparseDQN`` against the JAX package:
``hash_ids`` bit for bit, the bags, the concat and ``SparseDQN`` from carried
weights (atol 1e-6), the ``FullyConnectedWithEmbedding`` builder,
``soft_update_excluding``, ids out of a table's range, K3's overarch route,
and the sparse changing-arms DQN in 5-step lockstep with JAX's
``DQNTrainer`` from carried weights and optax state on the same batches;
``-m slow``: the full changing-arms job against its bar of 400.  Inputs come
from numpy seeds and go to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import reagent_tpu.net_builder.discrete_dqn  # noqa: F401 (registry population)
import reagent_tpu_torch.net_builder.discrete_dqn  # noqa: F401 (registry population)
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.core.registry import DISCRETE_DQN_NET_BUILDERS as JAX_BUILDERS
from reagent_tpu.gym.preprocessors import make_discrete_dqn_batch as jax_make_batch
from reagent_tpu.models import embedding_bag as jeb
from reagent_tpu.optim.soft_update import soft_update_excluding as jax_soft_update_excluding
from reagent_tpu.training import DQNTrainer as JaxDQNTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.core.registry import DISCRETE_DQN_NET_BUILDERS
from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
from reagent_tpu_torch.gym.sparse_arms import ArmsSparseQNet, legal_actions_mask
from reagent_tpu_torch.models import embedding_bag as eb
from reagent_tpu_torch.optim import soft_update_excluding
from reagent_tpu_torch.training import DQNTrainer, functional
from reagent_tpu_torch.utils.interop import (
    dqn_state_from_arrays,
    opt_state_from_optax,
    sparse_dqn_state_from_flax,
)

FWD_TOL = dict(rtol=0, atol=1e-6)  # float32 sums over a few terms, another order
ARMS_TOL = dict(rtol=1e-6, atol=1e-6)  # the same at Q of up to ~10 (a few ulps)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)  # Adam turns ulps of a near-0 gradient into ~lr steps
K = 5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _id_list(rng, B, L, vocab, lo=0):
    ids = rng.integers(lo, vocab, (B, L)).astype(np.int32)
    mask = rng.random((B, L)) < 0.7
    mask[:, 0] = True
    mask[0] = False  # a row with no id: the mean divides by max(0, 1)
    return ids, mask


def _jax_feature(ids, mask):
    return jrlt.IdListFeature(ids=jnp.asarray(ids), mask=jnp.asarray(mask))


def _feature(ids, mask):
    return rlt.IdListFeature(ids=torch.from_numpy(ids), mask=torch.from_numpy(mask))


# ---------------------------------------------------------------- hash_ids


@pytest.mark.parametrize("table_size,salt", [(6, 0), (7, 3), (1000, 0), (2**31 - 1, 12345),
                                             (1, 0)])
def test_hash_ids_bit_for_bit(table_size, salt):
    rng = np.random.default_rng(table_size % 97 + salt)
    ids = np.concatenate([
        rng.integers(-(2**31), 2**31 - 1, 4000, dtype=np.int64),
        np.array([0, 1, -1, 2**31 - 1, -(2**31), 65535, 65536, -65536]),
    ]).astype(np.int32)
    want = np.asarray(jeb.hash_ids(jnp.asarray(ids), table_size, salt))
    got = eb.hash_ids(torch.from_numpy(ids), table_size, salt)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.min() >= 0 and got.max() < table_size


def test_hash_ids_int64_input_wraps_as_uint32():
    """An int64 id is taken mod 2^32, as JAX's uint32 cast of its int32."""
    ids = np.array([5, -7, 2**20 + 3], np.int64)
    got = eb.hash_ids(torch.from_numpy(ids + (3 << 32)), 11)
    want = np.asarray(jeb.hash_ids(jnp.asarray(ids.astype(np.int32)), 11))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- the bags


def _carry_bag(jparams, bag):
    with torch.no_grad():
        bag.embedding.copy_(torch.from_numpy(np.array(jparams["params"]["embedding"])))


@pytest.mark.parametrize("pooling", ["mean", "sum"])
@pytest.mark.parametrize("hashing", [True, False])
def test_embedding_bag_against_flax(pooling, hashing):
    rng = np.random.default_rng(3)
    T, D, B, L = 13, 4, 9, 6
    ids, mask = _id_list(rng, B, L, vocab=T if not hashing else 1000, lo=0 if not hashing else -500)
    jbag = jeb.EmbeddingBag(table_size=T, embedding_dim=D, pooling=pooling, hashing=hashing)
    jparams = jbag.init(jax.random.PRNGKey(1), _jax_feature(ids, mask))
    bag = eb.EmbeddingBag(T, D, pooling=pooling, hashing=hashing)
    _carry_bag(jparams, bag)
    want = np.asarray(jbag.apply(jparams, _jax_feature(ids, mask)))
    got = bag(_feature(ids, mask)).detach().numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_array_equal(got[0], 0.0)  # the empty row pools to 0


def test_out_of_range_ids_clamp_as_jax_gathers():
    """Without hashing, ids below 0 or past the table: JAX's gather wraps a
    negative id once and clamps the rest; the port's ``clamp_ids`` does the
    same (a CUDA gather would assert)."""
    T, D = 6, 3
    ids = np.array([[-1, -6, -7, -100, 5, 6, 9, 2**31 - 1]], np.int32)
    mask = np.ones_like(ids, bool)
    for j in range(ids.shape[1]):
        one = ids[:, j:j + 1]
        jbag = jeb.EmbeddingBag(table_size=T, embedding_dim=D, pooling="sum", hashing=False)
        jparams = jbag.init(jax.random.PRNGKey(2), _jax_feature(one, mask[:, :1]))
        bag = eb.EmbeddingBag(T, D, pooling="sum", hashing=False)
        _carry_bag(jparams, bag)
        want = np.asarray(jbag.apply(jparams, _jax_feature(one, mask[:, :1])))
        got = bag(_feature(one, mask[:, :1])).detach().numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"id {one[0, 0]}")
    np.testing.assert_array_equal(
        eb.clamp_ids(torch.from_numpy(ids), T).numpy(), [[5, 0, 0, 0, 5, 5, 5, 5]])


def _state_pair(rng, B, dense, features):
    """A FeatureData of each package with ``features`` {name: (L, vocab)}."""
    f = rng.normal(size=(B, dense)).astype(np.float32)
    lists = {name: _id_list(rng, B, L, vocab) for name, (L, vocab) in features.items()}
    jstate = jrlt.FeatureData(float_features=jnp.asarray(f), id_list_features={
        n: _jax_feature(*v) for n, v in lists.items()})
    state = rlt.FeatureData(float_features=torch.from_numpy(f), id_list_features={
        n: _feature(*v) for n, v in lists.items()})
    return jstate, state


CONFIGS = (("page", 100, 8), ("item", 50, 4))


def test_embedding_bag_concat_against_flax():
    rng = np.random.default_rng(4)
    jstate, state = _state_pair(rng, 7, 5, {"page": (6, 300), "item": (3, 80)})
    jmod = jeb.EmbeddingBagConcat(state_dense_dim=5, configs=CONFIGS)
    jparams = jmod.init(jax.random.PRNGKey(0), jstate)
    mod = eb.EmbeddingBagConcat(5, CONFIGS)
    bags = jparams["params"]["EmbeddingBagCollection_0"]
    for name, _, _ in CONFIGS:
        _carry_bag({"params": bags[f"bag_{name}"]}, mod.collection.bag(name))
    assert mod.output_dim == jmod.output_dim == 17
    np.testing.assert_allclose(mod(state).detach().numpy(), np.asarray(jmod.apply(jparams, jstate)),
                               **FWD_TOL)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "tanh"])
def test_sparse_dqn_from_carried_weights(activation):
    rng = np.random.default_rng(5)
    jstate, state = _state_pair(rng, 11, 5, {"page": (6, 300), "item": (3, 80)})
    kw = dict(state_dense_dim=5, action_dim=3, configs=CONFIGS, overarch_dims=[32, 16],
              activation=activation)
    jnet = jeb.SparseDQN(**kw)
    jparams = jnet.init(jax.random.PRNGKey(7), jstate)
    net = eb.SparseDQN(**kw)
    net.load_state_dict(sparse_dqn_state_from_flax(_np(jparams)))
    want = np.asarray(jnet.apply(jparams, jstate))
    np.testing.assert_allclose(net(state).detach().numpy(), want, **FWD_TOL)
    # the act step's route (the overarch as K3: its plain version on the CPU)
    params = functional.params_of(net)
    assert functional.takes_k3(net)
    np.testing.assert_allclose(functional.score(net, params, state).numpy(), want, **FWD_TOL)


def test_fully_connected_with_embedding_builder():
    """As ``tests/test_sparse_models.py:25``, on both packages' registries,
    then the port's net on JAX's init."""
    cfg = {"FullyConnectedWithEmbedding": {
        "sizes": [32, 16], "activations": ["relu", "relu"],
        "embedding_configs": [["page", 100, 8], ["item", 50, 4]]}}
    jnet = JAX_BUILDERS.build(cfg).build_q_network(None, output_dim=3, state_dim=5)
    net = DISCRETE_DQN_NET_BUILDERS.build(cfg).build_q_network(None, output_dim=3, state_dim=5)
    assert isinstance(net, eb.SparseDQN)
    B = 4
    jstate = jrlt.FeatureData(float_features=jnp.ones((B, 5)), id_list_features={
        "page": jrlt.IdListFeature(ids=jnp.zeros((B, 6), jnp.int32), mask=jnp.ones((B, 6), bool)),
        "item": jrlt.IdListFeature(ids=jnp.ones((B, 3), jnp.int32), mask=jnp.ones((B, 3), bool))})
    state = rlt.FeatureData(float_features=torch.ones((B, 5)), id_list_features={
        "page": rlt.IdListFeature(ids=torch.zeros((B, 6), dtype=torch.int32),
                                  mask=torch.ones((B, 6), dtype=torch.bool)),
        "item": rlt.IdListFeature(ids=torch.ones((B, 3), dtype=torch.int32),
                                  mask=torch.ones((B, 3), dtype=torch.bool))})
    jparams = jnet.init(jax.random.PRNGKey(0), jstate)
    q = net(state)
    assert q.shape == (B, 3) and torch.isfinite(q).all()
    net.load_state_dict(sparse_dqn_state_from_flax(_np(jparams)))
    np.testing.assert_allclose(net(state).detach().numpy(),
                               np.asarray(jnet.apply(jparams, jstate)), **FWD_TOL)


# ------------------------------------------------------ soft_update_excluding


def test_soft_update_excluding_as_jax():
    """``tests/test_ope_types_misc.py:58`` on the port, then both packages'
    SparseDQN parameters: the predicate picks the same leaves (the tables)
    and the blends agree."""
    src = {"embedding.table": torch.ones(3), "dense.w": torch.ones(3)}
    tgt = {"embedding.table": torch.zeros(3), "dense.w": torch.zeros(3)}
    out = soft_update_excluding(src, tgt, 0.1, lambda p: "embedding" in p)
    assert float(out["embedding.table"][0]) == 1.0  # hard copy
    np.testing.assert_allclose(out["dense.w"].numpy(), 0.1, rtol=1e-6)

    rng = np.random.default_rng(6)
    jstate, _ = _state_pair(rng, 3, 5, {"page": (6, 300), "item": (3, 80)})
    kw = dict(state_dense_dim=5, action_dim=3, configs=CONFIGS, overarch_dims=[8])
    jnet = jeb.SparseDQN(**kw)
    jsrc = jnet.init(jax.random.PRNGKey(1), jstate)
    jtgt = jnet.init(jax.random.PRNGKey(2), jstate)
    seen = []

    def pick(path):
        seen.append(path)
        return "embedding" in path

    jout = jax_soft_update_excluding(jsrc, jtgt, 0.3, pick)
    jax_picked = sorted(p for p in seen if "embedding" in p)
    seen.clear()
    out = soft_update_excluding(sparse_dqn_state_from_flax(_np(jsrc)),
                                sparse_dqn_state_from_flax(_np(jtgt)), 0.3, pick)
    assert len([p for p in seen if "embedding" in p]) == len(jax_picked) == 2
    want = sparse_dqn_state_from_flax(_np(jout))
    assert set(out) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(out[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
        if "embedding" in k:
            np.testing.assert_array_equal(out[k].numpy(), v.numpy())


# ------------------------------------------------- the changing-arms network


class JaxArmsSparseQNet(fnn.Module):
    """``tests/test_sparse_models.py:187``'s network."""

    @fnn.compact
    def __call__(self, obs):
        mus, legal, changes = obs[:, :K], obs[:, K:2 * K], obs[:, 2 * K:]
        ids = jnp.tile(jnp.arange(K, dtype=jnp.int32)[None, :], (obs.shape[0], 1))
        state = jrlt.FeatureData(
            float_features=jnp.concatenate([mus, changes], axis=1),
            id_list_features={"legal": jrlt.IdListFeature(ids=ids, mask=legal > 0.5)})
        return jeb.SparseDQN(state_dense_dim=2 * K, action_dim=K + 1,
                             configs=(("legal", K + 1, 8),), overarch_dims=[64],
                             activation="leaky_relu")(state)


def _jax_mask_of(obs_batch):
    legal = obs_batch[..., K:2 * K] > 0.5
    always_pass = jnp.ones(obs_batch.shape[:-1] + (1,), bool)
    return jnp.concatenate([legal, always_pass], axis=-1).astype(jnp.float32)


def _arms_obs(rng, n):
    mus = rng.uniform(-10, 10, (n, K))
    legal = (rng.random((n, K)) > 0.5).astype(np.float64)
    legal[0] = 0.0  # only the pass is legal
    changes = rng.normal(size=(n, K))
    return np.concatenate([mus, legal, changes], axis=1).astype(np.float32)


def test_arms_net_and_mask_against_jax():
    rng = np.random.default_rng(8)
    obs = _arms_obs(rng, 16)
    jnet = JaxArmsSparseQNet()
    jparams = jnet.init(jax.random.PRNGKey(3), jnp.asarray(obs))
    net = ArmsSparseQNet(num_arms=K)
    net.load_state_dict(sparse_dqn_state_from_flax(_np(jparams)))
    want = np.asarray(jnet.apply(jparams, jnp.asarray(obs)))
    np.testing.assert_allclose(net(torch.from_numpy(obs)).detach().numpy(), want, **ARMS_TOL)
    params = functional.params_of(net)
    assert functional.takes_k3(net)
    np.testing.assert_allclose(functional.score(net, params, torch.from_numpy(obs)).numpy(),
                               want, **ARMS_TOL)
    np.testing.assert_array_equal(legal_actions_mask(torch.from_numpy(obs), K).numpy(),
                                  np.asarray(_jax_mask_of(jnp.asarray(obs))))


def _arms_batches(seed, n, B=64):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        terminal = rng.random(B) < 0.1
        yield dict(state=_arms_obs(rng, B), next_state=_arms_obs(rng, B),
                   action=rng.integers(0, K + 1, B).astype(np.int32),
                   next_action=rng.integers(0, K + 1, B).astype(np.int32),
                   reward=rng.normal(size=B).astype(np.float32) * 3,
                   terminal=terminal, step=np.ones(B, np.int32))


def test_changing_arms_dqn_lockstep_with_jax():
    """The job's trainer (gamma 0.5, target update rate 0.2, double-Q, Adam
    0.003) 5 steps from JAX's init and optax state on the same masked
    batches: each step's metrics, then every parameter, target and Adam
    moment after the last."""
    jnet = JaxArmsSparseQNet()
    rl = dict(gamma=0.5, target_update_rate=0.2, maxq_learning=True)
    opt = {"Adam": {"lr": 0.003}}
    jtrainer = JaxDQNTrainer(q_network=jnet, rl=JaxRLParameters(**rl), double_q_learning=True,
                             optimizer=opt)
    trainer = DQNTrainer(q_network=ArmsSparseQNet(num_arms=K), rl=RLParameters(**rl),
                         double_q_learning=True, optimizer=opt, device="cpu")
    jstate = jtrainer.init(jax.random.PRNGKey(4), jnp.zeros((1, 3 * K)))
    state = dqn_state_from_arrays(_np(jstate.q_params), _np(jstate.q_target_params),
                                  opt_state_from_optax(jstate.opt_state), np.asarray(jstate.step))
    for i, b in enumerate(_arms_batches(9, 5)):
        jb = jax_make_batch({k: jnp.asarray(v) for k, v in b.items()}, K + 1)
        jb = jb.replace(possible_actions_mask=_jax_mask_of(jb.state.float_features),
                        possible_next_actions_mask=_jax_mask_of(jb.next_state.float_features))
        pb = make_discrete_dqn_batch({k: torch.from_numpy(v) for k, v in b.items()}, K + 1)
        pb = dataclasses.replace(
            pb, possible_actions_mask=legal_actions_mask(pb.state.float_features, K),
            possible_next_actions_mask=legal_actions_mask(pb.next_state.float_features, K))
        jstate, jm = jtrainer.train_step(jstate, jb)
        state, m = trainer.train_step(state, pb)
        for k in ("td_loss", "q_values_mean", "q_taken_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL, err_msg=f"{i} {k}")
    want = dqn_state_from_arrays(_np(jstate.q_params), _np(jstate.q_target_params),
                                 opt_state_from_optax(jstate.opt_state), np.asarray(jstate.step))
    assert "sparse_dqn.concat.collection.bag_legal.embedding" in want.q_params
    for name in ("q_params", "q_target_params"):
        for k, v in getattr(want, name).items():
            np.testing.assert_allclose(getattr(state, name)[k].numpy(), v.numpy(), **PARAM_TOL,
                                       err_msg=f"{name} {k}")
    # a moment near 0 is a sum that cancels: its atol scales with the tensor
    for moment in ("mu", "nu"):
        for k, v in getattr(want.opt_state, moment).items():
            np.testing.assert_allclose(getattr(state.opt_state, moment)[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5 * float(v.abs().max()),
                                       err_msg=f"{moment} {k}")
    assert int(state.opt_state.count) == int(want.opt_state.count) == 5


@pytest.mark.slow
def test_changing_arms_sparse_job_reaches_bar():
    """The full job (``tools/sparse_jobs.py``'s depth: 2,000 masked-random
    prefill steps, 15,000 steps, 10 greedy masked episodes) on the CPU,
    through ``chip_smoke.sparse_arms_phase``: the bar of 400
    (``tests/test_sparse_models.py:157``)."""
    import chip_smoke as cs

    cfg = cs.SPARSE_ARMS_JOB
    result = cs.sparse_arms_phase(torch, cfg["full_prefill"], cfg["full_steps"],
                                  cfg["full_eval_episodes"], device="cpu")
    assert result["launches"]["fused_mlp_forward"] == 0  # the CPU takes the plain versions
    assert result["mean_reward"] >= cfg["bar"], result["mean_reward"]
