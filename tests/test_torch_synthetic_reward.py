"""Synthetic reward against the JAX package: the six nets through their
builders, ``RewardNetTrainer`` with each loss, the inverse-propensity
weights and the ignore threshold, the ``SyntheticReward`` manager and the
predictor wrapper, each from weights carried across
(``interop.synthetic_reward_state_from_flax``, ``q_network_state_from_flax``,
``opt_state_from_optax``).

Tolerances: forwards rtol 1e-5, atol 1e-6 (float32 sums in each library's
order: the convolution, the attention and the LSTM included); the trainer's
losses rtol 1e-4 and parameters and Adam moments rtol 5e-4, atol 5e-5 over
3 free steps, as the other lockstep tests.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import NormalizationParameters as JaxNormParams
from reagent_tpu.core.registry import SYNTHETIC_REWARD_NET_BUILDERS as JAX_BUILDERS
from reagent_tpu.model_managers.model_based import SyntheticReward as JaxSyntheticReward
from reagent_tpu.models.dqn import FullyConnectedDQN as JaxDQN
from reagent_tpu.prediction.synthetic_reward import SyntheticRewardPredictorWrapper as JaxWrapper
from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
from reagent_tpu.training.reward_network_trainer import LossFunction as JaxLoss
from reagent_tpu.training.reward_network_trainer import RewardNetTrainer as JaxRewardNetTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import NormalizationParameters
from reagent_tpu_torch.core.registry import SYNTHETIC_REWARD_NET_BUILDERS
from reagent_tpu_torch.model_managers import SyntheticReward
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.ops import fused_mlp
from reagent_tpu_torch.prediction.synthetic_reward import (
    SyntheticRewardPredictorWrapper,
    split_features,
)
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training.reward_network_trainer import (
    LossFunction,
    RewardNetTrainer,
    RewardNetTrainerState,
)
from reagent_tpu_torch.utils.interop import (
    fcn_state_from_flax,
    opt_state_from_optax,
    q_network_state_from_flax,
    synthetic_reward_state_from_flax,
)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
T, B, S, A = 6, 4, 3, 2
VOCAB = (("page", 50, 4), ("item", 40, 4))


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _batch(seed, pkg, sparse=False):
    """A [T, B] synthetic-reward batch: normal states and actions, the
    aggregate reward, valid steps in [1, T]; with ``sparse``, two padded
    ID-list features (raw ids, hashed by the bags)."""
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(T, B, S)).astype(np.float32)
    action = rng.normal(size=(T, B, A)).astype(np.float32)
    valid = rng.integers(1, T + 1, (B, 1)).astype(np.int32)
    reward = rng.normal(size=(T, B)).astype(np.float32)
    ids = {name: (rng.integers(-5, 1000, (T, B, 3)).astype(np.int32),
                  (rng.random((T, B, 3)) > 0.3).astype(np.float32)) for name, _, _ in VOCAB}
    t, mod = (jnp.asarray, jrlt) if pkg == "jax" else (torch.tensor, rlt)
    features = ({k: mod.IdListFeature(ids=t(i), mask=t(m)) for k, (i, m) in ids.items()}
                if sparse else None)
    st = mod.FeatureData(float_features=t(state), id_list_features=features)
    return mod.MemoryNetworkInput(
        state=st, action=mod.FeatureData(float_features=t(action)), next_state=st,
        reward=t(reward), not_terminal=t(np.ones((T, B), np.float32)), time_diff=None,
        step=None, valid_step=t(valid))


BUILDERS = {
    "single_step": {"SingleStepSyntheticReward": {"sizes": [8, 6], "activations":
                                                  ["relu", "tanh"]}},
    "ngram": {"NGramSyntheticReward": {"sizes": [8], "activations": ["leaky_relu"],
                                       "context_size": 5}},
    "ngram_conv": {"NGramConvNetSyntheticReward": {
        "sizes": [8], "activations": ["relu"], "context_size": 5, "conv_dims": [4, 5],
        "conv_height_kernels": [2, 2]}},
    "lstm": {"SequenceSyntheticReward": {"lstm_hidden_size": 8, "lstm_num_layers": 2,
                                         "last_layer_activation": "tanh"}},
    "transformer": {"TransformerSyntheticReward": {"d_model": 8, "nhead": 2,
                                                   "num_encoder_layers": 2,
                                                   "dim_feedforward": 16}},
    "sparse_arch": {"SparseArchSyntheticReward": {
        "dense_sizes": [8, 4], "overall_sizes": [6],
        "embedding_configs": [list(c) for c in VOCAB]}},
}


def _nets(name, seed=0):
    """(JAX net, its variables, the port's net holding them)."""
    cfg = BUILDERS[name]
    jnet = JAX_BUILDERS.build(cfg).build_synthetic_reward_network(None, None, state_dim=S,
                                                                  action_dim=A)
    net = SYNTHETIC_REWARD_NET_BUILDERS.build(cfg).build_synthetic_reward_network(
        None, None, state_dim=S, action_dim=A)
    jparams = jnet.init(jax.random.PRNGKey(seed), _batch(0, "jax", name == "sparse_arch"))
    net.load_state_dict(synthetic_reward_state_from_flax(_np(jparams)))
    return jnet, jparams, net


@pytest.mark.parametrize("name", list(BUILDERS))
def test_synthetic_reward_nets_through_builders_match_jax(name):
    """Each builder makes the JAX package's net (every variable maps onto
    the port's, strictly), and its per-step rewards, mask and masked sum
    agree."""
    jnet, jparams, net = _nets(name, seed=len(name))
    sparse = name == "sparse_arch"
    want = jax.jit(jnet.apply)(jparams, _batch(1, "jax", sparse))
    with torch.no_grad():
        got = net(_batch(1, "torch", sparse))
    for f in ("predicted_reward", "mask", "output"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   **FWD_TOL, err_msg=f)
    assert got.output.shape == (B, T)


class _JaxRankNet(fnn.Module):
    """(state, candidates) -> a slate reward: an MLP on the state and the
    candidates' mean."""

    @fnn.compact
    def __call__(self, state, src):
        x = jnp.concatenate([state, jnp.mean(src, axis=1)], axis=-1)
        h = fnn.relu(fnn.Dense(8)(x))
        return fnn.Dense(1)(h)


class _RankNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(S + 3, 8), nn.Linear(8, 1)])

    def forward(self, state, src):
        x = torch.cat([state, src.mean(dim=1)], dim=-1)
        return self.layers[1](torch.relu(self.layers[0](x)))


def _reward_batch(seed, pkg, ranking, bce):
    rng = np.random.default_rng(seed)
    rows = 16
    state = rng.normal(size=(rows, S)).astype(np.float32)
    reward = (rng.random(rows) if bce else 2.0 * rng.normal(size=rows)).astype(np.float32)
    t, mod = (jnp.asarray, jrlt) if pkg == "jax" else (torch.tensor, rlt)
    if ranking:
        src = rng.normal(size=(rows, 5, 3)).astype(np.float32)
        probs = np.concatenate([[1e-9], rng.uniform(0.05, 1.0, rows - 1)]).astype(np.float32)
        return mod.PreprocessedRankingInput(
            state=mod.FeatureData(t(state)), src_seq=mod.FeatureData(t(src)),
            slate_reward=t(reward[:, None]), tgt_out_probs=t(probs[:, None]))
    return mod.MemoryNetworkInput(
        state=mod.FeatureData(t(state)), action=mod.FeatureData(t(np.zeros((rows, A),
                                                                            np.float32))),
        next_state=mod.FeatureData(t(state)), reward=t(reward), not_terminal=None,
        time_diff=None, step=None)


@pytest.mark.parametrize("loss,ranking,ips,threshold", [
    ("MSE", False, False, None), ("SmoothL1Loss", False, False, None),
    ("L1Loss", False, False, None), ("BCELoss", False, False, None),
    ("MSE", False, False, 0.5), ("SmoothL1Loss", True, True, 1.0)])
def test_reward_net_trainer_lockstep_with_jax(loss, ranking, ips, threshold):
    """3 steps from JAX's init on the same batches: the loss and the mean
    prediction each step, then the parameters and Adam's moments; a ranking
    batch feeds (state, candidates) and, with ``ips``, weights each example
    by its clipped inverse propensity (one propensity under the clip)."""
    opt = {"Adam": {"lr": 0.01}}
    kw = dict(reward_ignore_threshold=threshold, weighted_by_inverse_propensity=ips)
    bce = loss == "BCELoss"
    if ranking:
        jnet, net = _JaxRankNet(), _RankNet()
        protos = (jnp.zeros((1, S)), jnp.zeros((1, 5, 3)))
        convert = lambda p: fcn_state_from_flax(p["params"])  # noqa: E731
    else:
        jnet = JaxDQN(state_dim=S, action_dim=1, sizes=[8], activations=["relu"])
        net = FullyConnectedDQN(S, 1, [8], ["relu"])
        protos = (jnp.zeros((1, S)),)
        convert = q_network_state_from_flax
    jtrainer = JaxRewardNetTrainer(jnet, optimizer=opt, loss_type=JaxLoss[loss], **kw)
    jstate = jtrainer.init(jax.random.PRNGKey(2), *protos)
    trainer = RewardNetTrainer(net, optimizer=opt, loss_type=LossFunction[loss], device="cpu",
                               **kw)
    js = _np(jstate)
    state = RewardNetTrainerState(params=convert(js.params),
                                  opt_state=opt_state_from_optax(js.opt_state),
                                  step=torch.tensor(0, dtype=torch.int32))
    for i in range(3):
        state, m = trainer.train_step(state, _reward_batch(i, "torch", ranking, bce))
        jstate, jm = jtrainer.train_step(jstate, _reward_batch(i, "jax", ranking, bce))
        for k in ("loss", "pred_reward_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL,
                                       err_msg=f"step {i} {k}")
    js = _np(jstate)
    for got, want in ((state.params, convert(js.params)),
                      (state.opt_state.mu, opt_state_from_optax(js.opt_state).mu),
                      (state.opt_state.nu, opt_state_from_optax(js.opt_state).nu)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **PARAM_TOL, err_msg=k)
    assert int(state.step) == 3


def test_synthetic_reward_manager_cannot_train_in_either_package():
    """``SyntheticReward`` builds a ``RewardNetTrainer`` whose step passes
    ``batch.state.float_features`` to a net that reads ``batch.state``: the
    JAX package raises ``AttributeError``, and the port keeps that
    behaviour."""
    tp = {"loss_type": "MSE", "optimizer": {"Adam": {"lr": 0.01}}}
    jtrainer = JaxSyntheticReward(trainer_param=tp).build_trainer(None, state_dim=S, action_dim=A)
    trainer = SyntheticReward(trainer_param=tp).build_trainer(None, state_dim=S, action_dim=A,
                                                              device="cpu")
    assert isinstance(trainer, RewardNetTrainer) and trainer.loss_type == LossFunction.MSE
    jstate = jtrainer.init(jax.random.PRNGKey(0), _batch(0, "jax"))
    state = trainer.init(torch.Generator().manual_seed(0))
    with pytest.raises(AttributeError, match="state"):
        jtrainer.train_step(jstate, _batch(0, "jax"))
    with pytest.raises(AttributeError, match="state"):
        trainer.train_step(state, _batch(0, "torch"))


def _preprocessors(first, n):
    spec = {first + i: dict(feature_type="CONTINUOUS", mean=0.2 * i, stddev=1.0 + 0.25 * i)
            for i in range(n)}
    return (Preprocessor({k: NormalizationParameters(**v) for k, v in spec.items()}),
            JaxPreprocessor({k: JaxNormParams(**v) for k, v in spec.items()}))


@pytest.mark.parametrize("name", ["single_step", "lstm"])
def test_predictor_wrapper_matches_jax(name):
    """A window of ``T`` raw (state | action) rows: the single-step net's
    MLP as one K3 call (its plain version on the CPU), the LSTM net's own
    forward; the per-step rewards against JAX's wrapper."""
    jnet, jparams, net = _nets(name)
    spre, jspre = _preprocessors(1000, S)
    apre, japre = _preprocessors(2000, A)
    rng = np.random.default_rng(3)
    values = rng.normal(size=(T, S + A)).astype(np.float32)
    presence = (rng.random(values.shape) > 0.1).astype(np.float32)
    fused_mlp.fused_mlp_forward_reference.calls = 0
    got = SyntheticRewardPredictorWrapper(T, spre, apre, net, None)(
        (torch.tensor(values), torch.tensor(presence)))
    assert fused_mlp.fused_mlp_forward_reference.calls == (name == "single_step")
    want = JaxWrapper(T, jspre, japre, jnet, jparams)((jnp.asarray(values),
                                                       jnp.asarray(presence)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    (sv, sp), (av, ap) = split_features((torch.tensor(values), torch.tensor(presence)), S, A)
    assert sv.shape == sp.shape == (T, S) and av.shape == ap.shape == (T, A)
    with pytest.raises(ValueError, match="seq_len"):
        SyntheticRewardPredictorWrapper(T + 1, spre, apre, net, None)(
            (torch.tensor(values), torch.tensor(presence)))
