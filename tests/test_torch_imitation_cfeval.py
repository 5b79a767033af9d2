"""Imitation and counterfactual evaluation against the JAX package: the BCQ
imitator's mask, behavioural cloning, the bandit reward net, Bayes by
backprop and its Monte-Carlo predictions, the serving wrapper, the
multi-stage trainer, the new types and parameters, and the state carriers.

Each trainer step starts from JAX's state carried across
(``interop.q_network_state_from_flax``, ``bayesian_mlp_state_from_flax``,
``opt_state_from_optax``); Bayes by backprop takes JAX's own weight noise
(``split(state.rng)``, then ``fold_in(r, layer)``; ``fold_in(rng, sample)``
then ``fold_in(., layer)`` for the predictions).

Tolerances: the losses and metrics rtol 1e-5, atol 1e-6 (one float32
forward in each library's order); the parameters after a step rtol 1e-4,
atol 1e-6 (one Adam step from one state); the imitator's mask exact; the
predictive mean and std rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import parameters as jparams
from reagent_tpu.core import types as jrlt
from reagent_tpu.models import FullyConnectedDQN as JaxDQN
from reagent_tpu.prediction import predictor_wrapper as jax_pw
from reagent_tpu.prediction.cfeval import BanditRewardNetPredictorWrapper as JaxRewardWrapper
from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
from reagent_tpu.training import imitator_training as jimit
from reagent_tpu.training.behavioral_cloning_trainer import (
    BehavioralCloningTrainer as JaxBCTrainer,
)
from reagent_tpu.training.cfeval import BanditRewardNetTrainer as JaxBanditTrainer
from reagent_tpu.training.cfeval import BayesByBackpropTrainer as JaxBBBTrainer
from reagent_tpu.training.cfeval.bayes_by_backprop_trainer import BayesianMLP as JaxBayesianMLP
from reagent_tpu.training.reward_network_trainer import LossFunction as JaxLoss
from reagent_tpu_torch.core import parameters
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.prediction import predictor_wrapper as pw
from reagent_tpu_torch.prediction.cfeval import BanditRewardNetPredictorWrapper
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training import functional, imitator_training
from reagent_tpu_torch.training.behavioral_cloning_trainer import BehavioralCloningTrainer
from reagent_tpu_torch.training.cfeval import BanditRewardNetTrainer, BayesByBackpropTrainer
from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import BayesianMLP
from reagent_tpu_torch.training.multi_stage_trainer import MultiStageTrainer
from reagent_tpu_torch.training.reward_network_trainer import LossFunction
from reagent_tpu_torch.utils import interop

METRIC = dict(rtol=1e-5, atol=1e-6)
PARAM = dict(rtol=1e-4, atol=1e-6)


def t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def host(tree):
    """JAX leaves as numpy copies (a jitted step donates its state)."""
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def dqn_pair(state_dim=4, action_dim=3, sizes=(16,), act="relu", seed=0):
    """A flax ``FullyConnectedDQN``, its variables, and the port's module."""
    jnet = JaxDQN(state_dim=state_dim, action_dim=action_dim, sizes=list(sizes),
                  activations=[act] * len(sizes))
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, state_dim)))
    net = FullyConnectedDQN(state_dim, action_dim, list(sizes), [act] * len(sizes))
    net.load_state_dict(interop.q_network_state_from_flax(host(variables)))
    return jnet, variables, net


def assert_q_params(got, want):
    jax.tree_util.tree_map(lambda a, b: close(a, b, **PARAM),
                           interop.flax_from_q_network_state(got), host(want))


# ------------------------------------------------------------- the imitator


@pytest.mark.parametrize("drop_threshold", [0.05, 0.3, 0.8])
def test_imitator_mask_is_exact(drop_threshold):
    """The (module, params) pair through ``functional.score`` and a callable,
    each against JAX's with the same weights: the same mask, entry for entry."""
    jnet, variables, net = dqn_pair(action_dim=5, sizes=(8,), act="leaky_relu")
    x = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32) * 3
    want = np.asarray(jimit.get_valid_actions_from_imitator(
        (jnet, variables), jnp.asarray(x), drop_threshold))
    assert 0 < want.mean() < 1 or drop_threshold == 0.05
    params = functional.params_of(net)
    got = imitator_training.get_valid_actions_from_imitator((net, params), t(x), drop_threshold)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    logits = jnet.apply(variables, jnp.asarray(x))
    want_fn = jimit.get_valid_actions_from_imitator(lambda f: logits, jnp.asarray(x),
                                                    drop_threshold)
    got_fn = imitator_training.get_valid_actions_from_imitator(
        lambda f: t(np.asarray(logits)), t(x), drop_threshold)
    np.testing.assert_array_equal(got_fn.numpy(), np.asarray(want_fn))


# ------------------------------------------------------ behavioural cloning


def bc_batch(seed, B=32, A=3, with_mask=False):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, 4)).astype(np.float32)
    labels = (obs[:, 0] > 0).astype(int) + (obs[:, 1] > 1)
    action = np.eye(A, dtype=np.float32)[labels]
    mask = None
    if with_mask:
        mask = (rng.uniform(size=(B, A)) > 0.3).astype(np.float32)
        mask[np.arange(B), rng.integers(0, A, B)] = 1.0
    jb = jrlt.BehavioralCloningModelInput(
        state=jrlt.FeatureData(float_features=jnp.asarray(obs)), action=jnp.asarray(action),
        possible_actions_mask=None if mask is None else jnp.asarray(mask))
    b = rlt.BehavioralCloningModelInput(
        state=rlt.FeatureData(float_features=t(obs)), action=t(action),
        possible_actions_mask=None if mask is None else t(mask))
    return jb, b


@pytest.mark.parametrize("with_mask", [False, True])
def test_behavioral_cloning_steps_from_jax_state(with_mask):
    """Three steps, each from JAX's state: loss and accuracy, then the
    parameters.  A masked logit is lowered by
    log(1e-20) = -46.05, as JAX adds the mask, so a batch whose logged
    action is sometimes masked still matches."""
    jnet, _, net = dqn_pair()
    jtrainer = JaxBCTrainer(jnet, optimizer={"Adam": {"lr": 1e-2}})
    trainer = BehavioralCloningTrainer(net, optimizer={"Adam": {"lr": 1e-2}}, device="cpu")
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    for i in range(3):
        jb, b = bc_batch(i, with_mask=with_mask)
        arrays = host(jstate)
        state = interop.behavioral_cloning_state_from_arrays(
            arrays.params, interop.opt_state_from_optax(arrays.opt_state), arrays.step)
        state, m = trainer.train_step(state, b)
        jstate, jm = jtrainer.train_step(jstate, jb)
        for k in ("loss", "accuracy"):
            close(m[k], jm[k], **METRIC)
        assert_q_params(state.params, jstate.params)
        assert int(state.step) == int(jstate.step)


def test_behavioral_cloning_mask_is_a_log_not_minus_inf():
    """A masked logged action: the loss is finite and carries the -46.05."""
    _, _, net = dqn_pair()
    trainer = BehavioralCloningTrainer(net, device="cpu")
    state = trainer.state_from_network()
    obs = torch.zeros(2, 4)
    b = rlt.BehavioralCloningModelInput(
        state=rlt.FeatureData(float_features=obs), action=torch.eye(3)[:2],
        possible_actions_mask=torch.tensor([[0.0, 1.0, 1.0], [1.0, 1.0, 1.0]]))
    _, m = trainer.train_step(state, b)
    assert 46.0 / 2 < float(m["loss"]) < 50.0 / 2 + 2


def test_behavioral_cloning_learns():
    """JAX's test on the port: 100 steps reach accuracy 0.9."""
    _, _, net = dqn_pair(action_dim=2)
    trainer = BehavioralCloningTrainer(net, optimizer={"Adam": {"lr": 1e-2}}, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    for i in range(100):
        rng = np.random.default_rng(i % 5)
        obs = rng.normal(size=(32, 4)).astype(np.float32)
        b = rlt.BehavioralCloningModelInput(state=rlt.FeatureData(float_features=t(obs)),
                                            action=torch.eye(2)[t(obs[:, 0] > 0, torch.long)])
        state, m = trainer.train_step(state, b)
    assert float(m["accuracy"]) > 0.9


# -------------------------------------------------------- bandit reward net


def bandit_batch(seed, B=64, A=3, action_prob=True):
    rng = np.random.default_rng(seed)
    actions = rng.integers(0, A, B)
    fields = dict(obs=rng.normal(size=(B, 4)).astype(np.float32),
                  action=np.eye(A, dtype=np.float32)[actions],
                  reward=(actions + rng.normal(size=B) * 0.1).astype(np.float32),
                  prob=rng.uniform(0.0, 0.9, (B, 1)).astype(np.float32) if action_prob else None)
    if action_prob:
        fields["prob"][:3] = 0.0  # clipped to 1e-6
    jb = jrlt.BanditRewardModelInput(
        state=jrlt.FeatureData(float_features=jnp.asarray(fields["obs"])),
        action=jnp.asarray(fields["action"]), reward=jnp.asarray(fields["reward"]),
        action_prob=None if fields["prob"] is None else jnp.asarray(fields["prob"]))
    b = rlt.BanditRewardModelInput(
        state=rlt.FeatureData(float_features=t(fields["obs"])), action=t(fields["action"]),
        reward=t(fields["reward"]),
        action_prob=None if fields["prob"] is None else t(fields["prob"]))
    return jb, b


@pytest.mark.parametrize("ips,loss,action_prob", [
    (False, "MSE", True), (True, "MSE", True), (True, "SmoothL1Loss", True),
    (True, "MSE", False)])
def test_bandit_reward_net_steps_from_jax_state(ips, loss, action_prob):
    """Three steps, each from JAX's state: loss and ``pred_reward_mean``,
    then the parameters; the IPS weight 1 / clip(action_prob, 1e-6) only
    where the batch carries ``action_prob``."""
    jnet, _, net = dqn_pair()
    jtrainer = JaxBanditTrainer(jnet, optimizer={"Adam": {"lr": 1e-2}},
                                loss_type=getattr(JaxLoss, loss),
                                weighted_by_inverse_propensity=ips)
    trainer = BanditRewardNetTrainer(net, optimizer={"Adam": {"lr": 1e-2}},
                                     loss_type=getattr(LossFunction, loss),
                                     weighted_by_inverse_propensity=ips, device="cpu")
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    for i in range(3):
        jb, b = bandit_batch(i, action_prob=action_prob)
        arrays = host(jstate)
        state = interop.bandit_reward_net_state_from_arrays(
            arrays.params, interop.opt_state_from_optax(arrays.opt_state), arrays.step)
        state, m = trainer.train_step(state, b)
        jstate, jm = jtrainer.train_step(jstate, jb)
        for k in ("loss", "pred_reward_mean"):
            close(m[k], jm[k], **METRIC)
        assert_q_params(state.params, jstate.params)


# -------------------------------------------------------- Bayes by backprop


def bbb_pair(in_dim=6, hidden=16):
    jnet = JaxBayesianMLP(in_dim=in_dim, hidden=hidden, out_dim=1)
    jtrainer = JaxBBBTrainer(jnet, optimizer={"Adam": {"lr": 1e-2}})
    net = BayesianMLP(in_dim, hidden, 1)
    trainer = BayesByBackpropTrainer(net, optimizer={"Adam": {"lr": 1e-2}}, device="cpu")
    return jnet, jtrainer, net, trainer


def jax_step_noise(jnet, rng):
    """The weight noise JAX's ``train_step`` draws from ``state.rng``."""
    _, r = jax.random.split(rng)
    dims = [(jnet.in_dim, jnet.hidden), (jnet.hidden, jnet.out_dim)]
    return [t(jax.random.normal(jax.random.fold_in(r, li), d)) for li, d in enumerate(dims)]


def jax_predict_noise(jnet, rng, samples):
    """The ``[S, din, dout]`` noise of JAX's ``predict_with_uncertainty``."""
    dims = [(jnet.in_dim, jnet.hidden), (jnet.hidden, jnet.out_dim)]
    return [torch.stack([t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(rng, s), li),
                                             d)) for s in range(samples)])
            for li, d in enumerate(dims)]


def bbb_state(arrays):
    return interop.bayes_by_backprop_state_from_arrays(
        arrays.params, interop.opt_state_from_optax(arrays.opt_state), arrays.step)


def test_bayes_by_backprop_steps_and_predictions_from_jax_state():
    """Three ELBO steps from JAX's state on JAX's weight noise (loss, nll,
    kl, the parameters), then the Monte-Carlo mean and population std over
    32 samples on JAX's noise, each sample through K3's plain version."""
    jnet, jtrainer, net, trainer = bbb_pair()
    jstate = jtrainer.init(jax.random.PRNGKey(0), jnp.zeros((1, 6)))
    for i in range(3):
        jb, b = bandit_batch(i, A=2, action_prob=False)
        arrays = host(jstate)
        eps = jax_step_noise(jnet, jstate.rng)
        state, m = trainer.train_step(bbb_state(arrays), b, eps)
        jstate, jm = jtrainer.train_step(jstate, jb)
        for k in ("loss", "nll", "kl"):
            close(m[k], jm[k], **METRIC)
        for k, v in interop.bayesian_mlp_state_from_flax(host(jstate.params)).items():
            close(state.params[k], v, **PARAM)
    x = np.random.default_rng(9).normal(size=(8, 6)).astype(np.float32)
    want_mean, want_std = jtrainer.predict_with_uncertainty(jstate, jnp.asarray(x))
    state = bbb_state(host(jstate))
    mean, std = trainer.predict_with_uncertainty(
        state, t(x), 32, jax_predict_noise(jnet, jstate.rng, 32))
    close(mean, want_mean, rtol=1e-5)
    close(std, want_std, rtol=1e-5)
    assert float(std.min()) > 0


def test_bayes_by_backprop_std_is_the_population_std():
    """``jnp.std`` divides by S, not S - 1: two samples of 0 and 2 give 1."""
    _, _, net, trainer = bbb_pair(in_dim=1, hidden=1)
    state = trainer.state_from_network()
    params = {k: torch.zeros_like(v) for k, v in state.params.items()}
    params["b1"] = torch.zeros(1)
    params["w0_rho"] = torch.full((1, 1), -100.0)
    params["w1_rho"] = torch.full((1, 1), 20.0)  # sigma ~ 20 on the second layer
    params["b0"] = torch.ones(1)  # relu(0 * x + 1) = 1 into the second layer
    eps = [torch.zeros(2, 1, 1), torch.tensor([[[0.0]], [[2.0 / 20.0]]])]
    mean, std = trainer.predict_with_uncertainty(state.replace(params=params),
                                                 torch.zeros(1, 1), 2, eps)
    close(mean, [[1.0]], rtol=1e-5)
    close(std, [[1.0]], rtol=1e-5)


def test_bayes_by_backprop_learns_and_draws_from_its_generator():
    """JAX's test on the port: 100 steps lower the nll; predictions without
    draws come from the trainer's generator, seeded by ``init``."""
    _, _, net, trainer = bbb_pair()
    _, b = bandit_batch(0, A=2, action_prob=False)
    b = b.replace(reward=b.action.argmax(1).to(torch.float32))
    state = trainer.init(torch.Generator().manual_seed(0))
    losses = []
    for _ in range(100):
        state, m = trainer.train_step(state, b)
        losses.append(float(m["nll"]))
    assert losses[-1] < losses[0]
    mean, std = trainer.predict_with_uncertainty(state, torch.zeros(3, 6))
    assert mean.shape == (3, 1) and bool((std >= 0).all())


# ---------------------------------------------------------- serving wrapper


def test_reward_net_predictor_wrapper_against_jax():
    jnet, variables, net = dqn_pair(state_dim=3, action_dim=2, sizes=(4,))
    norm = dict(feature_type="CONTINUOUS", mean=0.5, stddev=2.0)
    ours = BanditRewardNetPredictorWrapper(pw.DiscreteDqnWithPreprocessor(net, Preprocessor(
        {i: parameters.NormalizationParameters(**norm) for i in range(3)}, device="cpu")),
        ["a", "b"])
    theirs = JaxRewardWrapper(jax_pw.DiscreteDqnWithPreprocessor(jnet, variables, JaxPreprocessor(
        {i: jparams.NormalizationParameters(**norm) for i in range(3)})), ["a", "b"])
    values = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    presence = np.ones((5, 3), bool)
    preds, mask = ours(t(values), torch.tensor(presence))
    jpreds, jmask = theirs(jnp.asarray(values), jnp.asarray(presence))
    close(preds, jpreds, rtol=1e-6, atol=1e-6)
    assert mask.dtype == torch.uint8 and bool((mask == 1).all())
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    with pytest.raises(ValueError, match="Invalid shape"):
        BanditRewardNetPredictorWrapper(ours.reward_model_with_preprocessor, ["a", "b", "c"])(
            t(values), torch.tensor(presence))


# ------------------------------------------------------- multi-stage trainer


class _Stub:
    def __init__(self, name):
        self.name = name

    def init(self):
        return {"n": 0}

    def train_step(self, state, batch):
        return {"n": state["n"] + 1}, {"who": self.name}


def test_multi_stage_trainer():
    """JAX's test on the port, and its stage choice epoch by epoch beside
    JAX's (clamped to the last stage)."""
    from reagent_tpu.training.multi_stage_trainer import MultiStageTrainer as JaxMS

    ms = MultiStageTrainer([_Stub("a"), _Stub("b")], epochs=[2, 3])
    states = ms.init_all()
    assert ms.total_epochs == 5
    for epoch in range(5):
        states, m = ms.train_step(states, None, epoch)
        assert m["active_stage"] == int(epoch >= 2) and m["who"] == "ab"[int(epoch >= 2)]
    assert states[0]["n"] == 2 and states[1]["n"] == 3
    jms = JaxMS([_Stub("a"), _Stub("b"), _Stub("c")], epochs=[1, 0, 2])
    ms3 = MultiStageTrainer([_Stub("a"), _Stub("b"), _Stub("c")], epochs=[1, 0, 2])
    assert [ms3.stage_for_epoch(e) for e in range(6)] == [jms.stage_for_epoch(e)
                                                          for e in range(6)]
    with pytest.raises(ValueError):
        MultiStageTrainer([_Stub("a")], epochs=[1, 2])


# ------------------------------------------------------ types and parameters


def test_new_types_and_parameters_equal_jax():
    assert [(m.name, m.value) for m in parameters.ProblemDomain] == \
        [(m.name, m.value) for m in jparams.ProblemDomain]
    assert parameters.EvolutionParameters() == parameters.EvolutionParameters(
        **vars(jparams.EvolutionParameters()))
    assert vars(parameters.EvolutionParameters()) == vars(jparams.EvolutionParameters())
    assert vars(parameters.BaselineParameters(8, 2)) == vars(jparams.BaselineParameters(8, 2))
    for name in ("BanditRewardModelInput", "BehavioralCloningModelInput"):
        import dataclasses

        got = [(f.name, f.default) for f in dataclasses.fields(getattr(rlt, name))]
        want = [(f.name, f.default) for f in dataclasses.fields(getattr(jrlt, name))]
        assert got == want, name


# ------------------------------------------------------------ state carriers


def test_state_carriers_round_trip():
    """JAX's BC, bandit and BBB states through the carriers and back
    (``state_to_arrays``): every leaf bit for bit."""
    jnet, _, _ = dqn_pair()
    for jtrainer, carrier, to_flax in (
            (JaxBCTrainer(jnet), interop.behavioral_cloning_state_from_arrays,
             interop.flax_from_q_network_state),
            (JaxBanditTrainer(jnet), interop.bandit_reward_net_state_from_arrays,
             interop.flax_from_q_network_state)):
        arrays = host(jtrainer.train_step(
            jtrainer.init(jax.random.PRNGKey(1), jnp.zeros((1, 4))), bc_batch(0)[0]
            if carrier is interop.behavioral_cloning_state_from_arrays
            else bandit_batch(0)[0])[0])
        state = carrier(arrays.params, interop.opt_state_from_optax(arrays.opt_state),
                        arrays.step)
        back = interop.state_to_arrays(state)
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               to_flax(state.params), arrays.params)
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               to_flax(state.opt_state.mu), arrays.opt_state[0].mu)
        assert int(back["step"]) == int(arrays.step) == 1
    jnet, jtrainer, _, _ = bbb_pair()
    arrays = host(jtrainer.init(jax.random.PRNGKey(1), jnp.zeros((1, 6))))
    state = bbb_state(arrays)
    back = interop.state_to_arrays(state)
    for k, v in arrays.params["params"].items():
        np.testing.assert_array_equal(back["params"][k], v)
        np.testing.assert_array_equal(back["opt_state"]["nu"][k],
                                      arrays.opt_state[0].nu["params"][k])
    with pytest.raises(ValueError, match="unexpected leaves"):
        interop.bayesian_mlp_state_from_flax({"params": {"kernel": np.zeros(1)}})


def test_entry_points_default_to_the_card(monkeypatch):
    """The trainers default to ``"cuda"`` and raise without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: BehavioralCloningTrainer(FullyConnectedDQN(2, 2, [4], ["relu"])),
                 lambda: BanditRewardNetTrainer(FullyConnectedDQN(2, 2, [4], ["relu"])),
                 lambda: BayesByBackpropTrainer(BayesianMLP(2, 4, 1))):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            make()
