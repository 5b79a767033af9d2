"""The model-based family against the JAX package: Seq2Reward, its trainer
and the compress model, the CEM planner over an MDN-RNN ensemble and its
trainer, the managers, the world-model serving wrappers and the evaluators,
each from weights carried across (``interop.seq2reward_state_from_flax``,
``cem_ensemble_params_from_flax``, ``fcn_state_from_flax``,
``q_network_state_from_flax``, ``opt_state_from_optax``) and JAX's own
draws.

Tolerances: forwards rtol 1e-5, atol 1e-6 (float32, the LSTM's products in
each library's order); the trainers' losses rtol 1e-4 and parameters and
Adam moments rtol 5e-4, atol 5e-5 over 5 free steps (the Adam tolerance of
the other lockstep tests); CEM's returns rtol 1e-4 (four or more steps of
a world model fed back into itself); the planned actions equal (discrete) or
within rtol 1e-5 (continuous, the elites' float64 means), after asserting
that no decision is a near-tie: no first action's mean return within 1e-4
of the best, no elite boundary within 1e-4 relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import MDNRNNTrainerParameters as JaxMDNRNNParams
from reagent_tpu.core.parameters import NormalizationParameters as JaxNormParams
from reagent_tpu.core.parameters import Seq2RewardTrainerParameters as JaxS2RParams
from reagent_tpu.evaluation import world_model_evaluator as jev
from reagent_tpu.model_managers.model_based import CrossEntropyMethod as JaxCEMManager
from reagent_tpu.model_managers.world_model import Seq2RewardModel as JaxSeq2RewardModel
from reagent_tpu.model_managers.world_model import WorldModel as JaxWorldModel
from reagent_tpu.models.cem_planner import CEMPlannerNetwork as JaxCEMPlanner
from reagent_tpu.models.dqn import FullyConnectedDQN as JaxDQN
from reagent_tpu.models.fully_connected_network import FullyConnectedNetwork as JaxFCN
from reagent_tpu.models.mdn_rnn import MemoryNetwork as JaxMemoryNetwork
from reagent_tpu.models.mlp_scorer import MLPScorer as JaxMLPScorer
from reagent_tpu.models.seq2reward_model import Seq2RewardNetwork as JaxSeq2Reward
from reagent_tpu.models.seq2reward_model import gen_permutations as jax_gen_permutations
from reagent_tpu.models.seq2reward_model import get_Q as jax_get_Q
from reagent_tpu.net_builder.value import Seq2RewardNetBuilder as JaxSeq2RewardNetBuilder
from reagent_tpu.prediction import world_model_wrappers as jw
from reagent_tpu.preprocessing.preprocessor import Preprocessor as JaxPreprocessor
from reagent_tpu.training.cem_trainer import CEMTrainer as JaxCEMTrainer
from reagent_tpu.training.world_model import CompressModelTrainer as JaxCompressTrainer
from reagent_tpu.training.world_model import MDNRNNTrainer as JaxMDNRNNTrainer
from reagent_tpu.training.world_model import Seq2RewardTrainer as JaxSeq2RewardTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import (
    MDNRNNTrainerParameters,
    NormalizationParameters,
    Seq2RewardTrainerParameters,
)
from reagent_tpu_torch.core.registry import VALUE_NET_BUILDERS
from reagent_tpu_torch.evaluation import world_model_evaluator as ev
from reagent_tpu_torch.model_managers import CrossEntropyMethod, Seq2RewardModel, WorldModel
from reagent_tpu_torch.models.cem_planner import CEMPlannerNetwork, RolloutDraws
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
from reagent_tpu_torch.models.mlp_scorer import MLPScorer
from reagent_tpu_torch.models.seq2reward_model import Seq2RewardNetwork, gen_permutations, get_Q
from reagent_tpu_torch.ops import fused_mlp
from reagent_tpu_torch.prediction import world_model_wrappers as pw
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.cem_trainer import CEMTrainer
from reagent_tpu_torch.training.world_model import (
    CompressModelTrainer,
    CompressModelTrainerState,
    MDNRNNTrainer,
    MDNRNNTrainerState,
    Seq2RewardTrainer,
    Seq2RewardTrainerState,
)
from reagent_tpu_torch.utils.interop import (
    cem_ensemble_params_from_flax,
    fcn_state_from_flax,
    memory_network_state_from_flax,
    opt_state_from_optax,
    q_network_state_from_flax,
    seq2reward_state_from_flax,
)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
CEM_TOL = dict(rtol=1e-4, atol=1e-5)
T, B, S, A = 5, 8, 3, 2


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _t(x):
    return torch.tensor(np.asarray(x))


def _batch(seed, pkg, T=T, B=B, S=S, A=A, valid=True):
    """A [T, B] world-model batch from numpy: normal states, one-hot
    actions, normal rewards, a few terminals, valid steps in [1, T]."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        state=rng.normal(size=(T, B, S)).astype(np.float32),
        action=np.eye(A, dtype=np.float32)[rng.integers(0, A, (T, B))],
        next_state=rng.normal(size=(T, B, S)).astype(np.float32),
        reward=rng.normal(size=(T, B)).astype(np.float32),
        not_terminal=(rng.random((T, B)) > 0.1).astype(np.float32),
        valid_step=rng.integers(1, T + 1, (B, 1)).astype(np.int32))
    t, mod = (jnp.asarray, jrlt) if pkg == "jax" else (torch.tensor, rlt)
    return mod.MemoryNetworkInput(
        state=mod.FeatureData(t(arrays["state"])), action=mod.FeatureData(t(arrays["action"])),
        next_state=mod.FeatureData(t(arrays["next_state"])), reward=t(arrays["reward"]),
        not_terminal=t(arrays["not_terminal"]), time_diff=t(np.ones((T, B), np.float32)),
        step=None, valid_step=t(arrays["valid_step"]) if valid else None)


def _close_dicts(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol, err_msg=f"{what} {k}")


# ------------------------------------------------------------- Seq2Reward


def test_seq2reward_forward_and_get_q():
    """Two stacked layers with and without ``valid_reward_len``, the lexical
    permutations and ``get_Q``'s batch-major rows."""
    H, layers = 8, 2
    jb, b = _batch(layers, "jax"), _batch(layers, "torch")
    jnet = JaxSeq2Reward(S, A, H, layers)
    jparams = jnet.init(jax.random.PRNGKey(layers), jb.state, jb.action)
    net = Seq2RewardNetwork(S, A, H, layers)
    net.load_state_dict(seq2reward_state_from_flax(_np(jparams)))
    apply = jax.jit(jnet.apply)
    with torch.no_grad():
        for valid in (None, "valid"):
            want = apply(jparams, jb.state, jb.action,
                         None if valid is None else jb.valid_step.reshape(-1))
            got = net(b.state, b.action, None if valid is None else b.valid_step.reshape(-1))
            np.testing.assert_allclose(got.acc_reward.numpy(), np.asarray(want.acc_reward),
                                       **FWD_TOL)
        for seq_len in (1, 3):
            perms = gen_permutations(seq_len, A, "cpu")
            np.testing.assert_array_equal(perms.numpy(),
                                          np.asarray(jax_gen_permutations(seq_len, A)))
        state = np.random.default_rng(7).normal(size=(4, S)).astype(np.float32)
        got = get_Q(net, None, torch.tensor(state), perms)
        want = jax.jit(lambda p, x, q: jax_get_Q(jnet, p, x, q))(
            jparams, jnp.asarray(state), jnp.asarray(perms.numpy()))
        assert got.shape == (4, A)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _s2r_state(jstate):
    js = _np(jstate)
    return Seq2RewardTrainerState(
        params=seq2reward_state_from_flax(js.params),
        opt_state=opt_state_from_optax(js.opt_state),
        step_params=fcn_state_from_flax(js.step_params["params"]),
        step_opt_state=opt_state_from_optax(js.step_opt_state),
        step=torch.tensor(int(js.step), dtype=torch.int32))


def test_seq2reward_trainer_lockstep_with_jax():
    """5 steps from JAX's init on the same batches (gamma 0.9): both losses
    each step, then both nets' parameters and Adam moments."""
    kw = dict(learning_rate=0.01, multi_steps=T, gamma=0.9, step_predict_net_size=8)
    jtrainer = JaxSeq2RewardTrainer(JaxSeq2Reward(S, A, 8, 2), JaxS2RParams(**kw))
    jstate = jtrainer.init(jax.random.PRNGKey(3), _batch(0, "jax"))
    trainer = Seq2RewardTrainer(Seq2RewardNetwork(S, A, 8, 2),
                                Seq2RewardTrainerParameters(**kw), device="cpu")
    state = _s2r_state(jstate)
    for i in range(5):
        state, m = trainer.train_step(state, _batch(10 + i, "torch"))
        jstate, jm = jtrainer.train_step(jstate, _batch(10 + i, "jax"))
        for k in ("mse_loss", "step_entropy_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL,
                                       err_msg=f"step {i} {k}")
    want = _s2r_state(jstate)
    assert int(state.step) == int(want.step) == 5
    _close_dicts(state.params, want.params, PARAM_TOL, "params")
    _close_dicts(state.step_params, want.step_params, PARAM_TOL, "step params")
    for got, w in ((state.opt_state, want.opt_state),
                   (state.step_opt_state, want.step_opt_state)):
        _close_dicts(got.mu, w.mu, PARAM_TOL, "mu")
        _close_dicts(got.nu, w.nu, PARAM_TOL, "nu")


def test_compress_model_trainer_lockstep_with_jax():
    """5 steps of the compress model against the planning Q of one
    Seq2Reward network (3-step permutations), from JAX's init."""
    s2r = JaxSeq2Reward(S, A, 8, 1)
    s2r_params = s2r.init(jax.random.PRNGKey(0), _batch(0, "jax").state,
                          _batch(0, "jax").action)
    kw = dict(compress_model_learning_rate=0.01, multi_steps=3)
    jtrainer = JaxCompressTrainer(JaxDQN(state_dim=S, action_dim=A, sizes=[16],
                                         activations=["relu"]), s2r, JaxS2RParams(**kw))
    jstate = jtrainer.init(jax.random.PRNGKey(1), jnp.zeros((1, S)))
    net = Seq2RewardNetwork(S, A, 8, 1)
    net.load_state_dict(seq2reward_state_from_flax(_np(s2r_params)))
    trainer = CompressModelTrainer(FullyConnectedDQN(S, A, [16], ["relu"]), net,
                                   Seq2RewardTrainerParameters(**kw), device="cpu")
    js = _np(jstate)
    state = CompressModelTrainerState(
        params=q_network_state_from_flax(js.params), opt_state=opt_state_from_optax(js.opt_state),
        step=torch.tensor(0, dtype=torch.int32))
    for i in range(5):
        state, m = trainer.train_step(state, _batch(20 + i, "torch"))
        jstate, jm = jtrainer.train_step(jstate, _batch(20 + i, "jax"), seq2reward_params=s2r_params)
        np.testing.assert_allclose(float(m["mse_loss"]), float(jm["mse_loss"]), **LOSS_TOL)
    _close_dicts(state.params, q_network_state_from_flax(_np(jstate.params)), PARAM_TOL, "params")


def test_net_builder_and_managers_build_jax_widths():
    """``Seq2RewardNetBuilder``, ``WorldModel``, ``Seq2RewardModel`` and
    ``CrossEntropyMethod`` build the JAX package's networks: the same
    widths, depths and parameters."""
    net = VALUE_NET_BUILDERS.build({"Seq2RewardNetBuilder": {"action_dim": 3, "num_hiddens": 16}}
                                   ).build_value_network(None, state_dim=5)
    jnet = JaxSeq2RewardNetBuilder(action_dim=3, num_hiddens=16).build_value_network(None, 5)
    assert isinstance(net, Seq2RewardNetwork)
    assert (net.state_dim, net.action_dim, net.num_hiddens, net.num_hidden_layers) == (
        jnet.state_dim, jnet.action_dim, jnet.num_hiddens, jnet.num_hidden_layers)

    tp = dict(hidden_size=16, num_hidden_layers=1, num_gaussians=2, learning_rate=0.01, bogus=1)
    wm, jwm = (m(trainer_param=tp).build_trainer(None, state_dim=S, action_dim=A, **kw)
               for m, kw in ((WorldModel, dict(device="cpu")), (JaxWorldModel, {})))
    assert isinstance(wm, MDNRNNTrainer) and wm.params == MDNRNNTrainerParameters(
        **{k: v for k, v in tp.items() if k != "bogus"})
    assert jwm.memory_network.num_hiddens == wm.memory_network.num_hiddens == 16

    s2r_tp = dict(multi_steps=4, action_names=("a", "b"), learning_rate=0.02)
    s2r, js2r = (m(trainer_param=s2r_tp, net_builder={"num_hiddens": 12}).build_trainer(
        None, state_dim=S, **kw)
        for m, kw in ((Seq2RewardModel, dict(device="cpu")), (JaxSeq2RewardModel, {})))
    assert isinstance(s2r, Seq2RewardTrainer)
    assert (s2r.seq2reward_network.action_dim, s2r.seq2reward_network.num_hiddens,
            s2r.seq2reward_network.num_hidden_layers) == (
        js2r.seq2reward_network.action_dim, js2r.seq2reward_network.num_hiddens,
        js2r.seq2reward_network.num_hidden_layers) == (2, 12, 2)
    assert s2r.step_predict_network.sizes == [S, 64, 64, 4]

    cem_tp = dict(plan_horizon_length=4, num_world_models=2, cem_population_size=10,
                  cem_num_iterations=2, ensemble_population_size=1, num_elites=3,
                  mdnrnn=dict(hidden_size=8, num_hidden_layers=1, num_gaussians=1))
    cem = CrossEntropyMethod(trainer_param=cem_tp).build_trainer(
        None, state_dim=S, action_dim=A, device="cpu")
    jcem = JaxCEMManager(trainer_param=cem_tp).build_trainer(None, state_dim=S, action_dim=A)
    assert isinstance(cem, CEMTrainer) and len(cem.world_model_trainers) == 2
    assert dataclasses.asdict(cem.parameters) == dataclasses.asdict(jcem.parameters)
    planner = cem.cem_planner_network
    assert (planner.gamma, planner.terminal_effective, planner.plan_horizon_length) == (
        1.0, True, 4)
    with pytest.raises(ValueError, match="not set"):
        planner(rlt.FeatureData(torch.zeros(1, S)), torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- CEM


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_draws(rng, P, H, G, S_, n):
    member_rng, roll_rng = jax.random.split(rng)
    member = jax.random.randint(member_rng, (P,), 0, n)

    def per_solution(key):
        def step(k, _):
            k, r_mix, r_norm, r_term = jax.random.split(k, 4)
            return k, (jax.random.gumbel(r_mix, (G,)), jax.random.normal(r_norm, (S_,)),
                       jax.random.uniform(r_term, ()))
        return jax.lax.scan(step, key, None, length=H)[1]

    return (member, *jax.vmap(per_solution)(jax.random.split(roll_rng, P)))


def jax_rollout_draws(rng, P, H, G, S_, n):
    """The draws JAX's ``acc_rewards_of_all_solutions`` takes from ``rng``:
    each solution's member, then per solution and step the gumbels of
    ``categorical``, the normals and the bernoulli's uniform, from its keys
    split as the rollout splits them."""
    member, g, nrm, u = _jax_draws(rng, P, H, G, S_, n)
    return RolloutDraws(member=_t(member), gumbel=_t(np.asarray(g).transpose(1, 0, 2)),
                        normal=_t(np.asarray(nrm).transpose(1, 0, 2)), uniform=_t(np.asarray(u).T))


def _planners(n_members, G, discrete, H, P, iters=2, elites=4, **kw):
    jnet = JaxMemoryNetwork(S, A, 16, 1, G, kw.get("predict_delta", False))
    proto = (jrlt.FeatureData(jnp.zeros((1, 1, S))), jrlt.FeatureData(jnp.zeros((1, 1, A))))
    trees = [jnet.init(jax.random.PRNGKey(40 + i), *proto) for i in range(n_members)]
    cfg = dict(cem_num_iterations=iters, cem_population_size=P, ensemble_population_size=1,
               num_elites=elites, plan_horizon_length=H, state_dim=S, action_dim=A,
               discrete_action=discrete, **{k: v for k, v in kw.items() if k != "predict_delta"})
    if not discrete:
        cfg.update(action_upper_bounds=np.ones(A), action_lower_bounds=-np.ones(A))
    jplanner = JaxCEMPlanner(mem_net=jnet, mem_net_params_list=trees, **cfg)
    planner = CEMPlannerNetwork(
        mem_net=MemoryNetwork(S, A, 16, 1, G, kw.get("predict_delta", False)),
        mem_net_params_list=cem_ensemble_params_from_flax(_np(trees)), device="cpu", **cfg)
    return jplanner, planner


def _acc_close(jplanner, planner, P, H, G, seed):
    """Random solutions' returns against JAX's jitted rollout on its key, the
    port fed the same draws."""
    rng = np.random.default_rng(seed)
    init = rng.normal(size=(S,)).astype(np.float32)
    sol = rng.uniform(-1, 1, size=(P, H, A)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jplanner.acc_rewards_of_all_solutions(jnp.asarray(init),
                                                            jnp.asarray(sol), key))
    draws = jax_rollout_draws(key, P, H, G, S, 2)
    assert 0 < int(draws.member.sum()) < P  # both members simulate
    got = planner.acc_rewards_of_all_solutions(torch.tensor(init), torch.tensor(sol), draws)
    np.testing.assert_allclose(got.numpy(), want, **CEM_TOL)


def test_acc_rewards_sampled_two_members_from_jax_draws():
    """Two members, three gaussians, the terminal head effective, next
    states and not-terminal flags sampled: every solution's discounted
    return."""
    P, H, G = 32, 4, 3
    jplanner, planner = _planners(2, G, False, H, P, terminal_effective=True, gamma=0.9)
    _acc_close(jplanner, planner, P, H, G, 11)


def test_expected_returns_and_discrete_plan_from_jax_draws():
    """Two members in the expected mode (CartPole's: the mixture's mean next
    state, the survival probability, ``predict_delta``): every solution's
    return, then random shooting from JAX's sequences and draws picks the
    same first action."""
    P, H = 32, 4
    jplanner, planner = _planners(2, 1, True, H, P, terminal_effective=True, gamma=0.9,
                                  sample_next_state=False, sample_not_terminal=False,
                                  predict_delta=True)
    _acc_close(jplanner, planner, P, H, 1, 12)
    obs = np.random.default_rng(6).normal(size=(1, S)).astype(np.float32)
    key = jax.random.PRNGKey(100)
    best_j, onehot_j = jplanner(jrlt.FeatureData(jnp.asarray(obs)), key)
    r_seq, r_sim = jax.random.split(key)
    seqs = jax.random.randint(r_seq, (P, H), 0, A)
    noise = (_t(seqs), jax_rollout_draws(r_sim, P, H, 1, S, 2))
    acc = planner.acc_rewards_of_all_solutions(
        torch.tensor(obs[0]), torch.nn.functional.one_hot(_t(seqs).long(), A).float(),
        noise[1]).numpy()
    first = np.asarray(seqs)[:, 0]
    means = np.sort([acc[first == a].mean() for a in range(A)])
    assert means[-1] - means[-2] > 1e-4 * max(1.0, abs(means[-1])), "near-tie"
    best, onehot = planner(rlt.FeatureData(torch.tensor(obs)), noise=noise)
    assert best == int(best_j)
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(onehot_j))


def test_continuous_plan_from_jax_draws(monkeypatch):
    """CEM over 2 members on a LinDyna-shaped problem (sampled next states,
    no terminal head): JAX's truncated normals and rollout draws each
    iteration, the same rescaled action."""
    P, H, iters, elites = 32, 3, 3, 6
    jplanner, planner = _planners(2, 2, False, H, P, iters=iters, elites=elites,
                                  terminal_effective=False, gamma=1.0)
    obs = np.random.default_rng(8).normal(size=(1, S)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jplanner(jrlt.FeatureData(jnp.asarray(obs)), key))
    noise, rng = [], key
    for _ in range(iters):
        rng, r_samp, r_sim = jax.random.split(rng, 3)
        trunc = np.asarray(jax.random.truncated_normal(r_samp, -2.0, 2.0, (P, H * A)))
        noise.append((trunc, jax_rollout_draws(r_sim, P, H, 2, S, 2)))
    accs = []
    real = planner.acc_rewards_of_all_solutions

    def recording(*args, **kwargs):
        accs.append(real(*args, **kwargs).numpy())
        return torch.tensor(accs[-1])

    monkeypatch.setattr(planner, "acc_rewards_of_all_solutions", recording)
    got = planner(rlt.FeatureData(torch.tensor(obs)), noise=noise)
    for acc in accs:
        s = np.sort(acc)
        assert s[-elites] - s[-elites - 1] > 1e-4 * max(1.0, abs(s[-elites])), "near-tie"
    assert got.shape == (A,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.all(np.abs(got.numpy()) <= 1.0)


def test_cem_trainer_step_lockstep_with_jax():
    """Two members, each from JAX's init, one ``CEMTrainer`` step on one
    batch: each member's loss and parameters."""
    params = dict(hidden_size=8, num_hidden_layers=1, num_gaussians=2, learning_rate=0.01)
    jnet = JaxMemoryNetwork(S, A, 8, 1, 2)
    jtrainers = [JaxMDNRNNTrainer(jnet, JaxMDNRNNParams(**params)) for _ in range(2)]
    jcem = JaxCEMTrainer(None, jtrainers)
    jstates = jcem.init(jax.random.PRNGKey(0), _batch(0, "jax"))
    net = MemoryNetwork(S, A, 8, 1, 2)
    cem = CEMTrainer(None, [MDNRNNTrainer(net, MDNRNNTrainerParameters(**params), device="cpu")
                            for _ in range(2)])
    assert len(cem.init(torch.Generator().manual_seed(0))) == 2
    states = [MDNRNNTrainerState(params=memory_network_state_from_flax(_np(s.params)),
                                 opt_state=opt_state_from_optax(s.opt_state),
                                 step=torch.tensor(0, dtype=torch.int32)) for s in jstates]
    states, m = cem.train_step(states, _batch(30, "torch"))
    jstates, jm = jcem.train_step(jstates, _batch(30, "jax"))
    assert set(m) == set(jm) == {"wm0_loss", "wm1_loss"}
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL)
    for s, js in zip(states, jstates):
        _close_dicts(s.params, memory_network_state_from_flax(_np(js.params)), PARAM_TOL,
                     "member")


# ------------------------------------------------------------ wrappers


def _preprocessors(n):
    spec = {1000 + i: dict(feature_type="CONTINUOUS", mean=0.1 * i, stddev=1.0 + 0.5 * i)
            for i in range(n)}
    return (Preprocessor({k: NormalizationParameters(**v) for k, v in spec.items()}),
            JaxPreprocessor({k: JaxNormParams(**v) for k, v in spec.items()}))


def _raw(seed, rows, n):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(rows, n)).astype(np.float32)
    return v, (rng.random(v.shape) > 0.1).astype(np.float32)


def _both(pair):
    return tuple(torch.tensor(x) for x in pair), tuple(jnp.asarray(x) for x in pair)


def test_seq2reward_wrappers_match_jax():
    """The full planner over every 3-step sequence, and the short-sequence
    planner with its step model (one K3 launch: the plain version here)."""
    pre, jpre = _preprocessors(S)
    (v, p), (jv, jp) = _both(_raw(1, 6, S))
    jnet = JaxSeq2Reward(S, A, 8, 2)
    proto = (jrlt.FeatureData(jnp.zeros((2, 1, S))), jrlt.FeatureData(jnp.zeros((2, 1, A))))
    jparams = jnet.init(jax.random.PRNGKey(4), *proto)
    net = Seq2RewardNetwork(S, A, 8, 2)
    params = seq2reward_state_from_flax(_np(jparams))
    got = pw.Seq2RewardWithPreprocessor(net, params, pre, 3, A)(v, p)
    want = jw.Seq2RewardWithPreprocessor(jnet, jparams, jpre, 3, A)(jv, jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)

    jstep = JaxFCN(sizes=[S, 8, 8, 3], activations=["relu", "relu", "linear"])
    jstep_params = jstep.init(jax.random.PRNGKey(5), jnp.zeros((1, S)))
    step = FullyConnectedNetwork([S, 8, 8, 3], ["relu", "relu", "linear"])
    step_params = fcn_state_from_flax(_np(jstep_params)["params"])
    fused_mlp.fused_mlp_forward_reference.calls = 0
    got = pw.Seq2RewardPlanShortSeqWithPreprocessor(net, params, step, step_params, pre, 3, A)(
        v, p)
    assert fused_mlp.fused_mlp_forward_reference.calls == 1
    want = jw.Seq2RewardPlanShortSeqWithPreprocessor(jnet, jparams, jstep, jstep_params, jpre,
                                                     3, A)(jv, jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_compress_and_binary_difference_wrappers_through_k3():
    """The compress model's Q and the binary difference scorer's P(class 1),
    each one K3 call (its plain version on the CPU), against JAX's."""
    pre, jpre = _preprocessors(S)
    (v, p), (jv, jp) = _both(_raw(2, 7, S))
    for seed, a in ((0, A), (1, 2)):
        jnet = JaxDQN(state_dim=S, action_dim=a, sizes=[16, 8], activations=["relu", "tanh"])
        jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, S)))
        net = FullyConnectedDQN(S, a, [16, 8], ["relu", "tanh"])
        params = q_network_state_from_flax(_np(jparams))
        fused_mlp.fused_mlp_forward_reference.calls = 0
        if seed == 0:
            got = pw.CompressModelWithPreprocessor(net, params, pre)(v, p)
            want = jw.CompressModelWithPreprocessor(jnet, jparams, jpre)(jv, jp)
        else:
            got = pw.BinaryDifferenceScorerPredictorWrapper(
                pw.BinaryDifferenceScorerWithPreprocessor(net, params, pre))(v, p)
            want = jw.BinaryDifferenceScorerPredictorWrapper(
                jw.BinaryDifferenceScorerWithPreprocessor(jnet, jparams, jpre))(jv, jp)
        assert fused_mlp.fused_mlp_forward_reference.calls == 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    with pytest.raises(ValueError, match="2 logits"):
        pw.BinaryDifferenceScorerWithPreprocessor(FullyConnectedDQN(S, 3, [4], ["relu"]), None,
                                                  pre)(v, p)


def test_mdnrnn_and_learn_vm_slate_wrappers_match_jax():
    seq_len, G = 3, 2
    pre, jpre = _preprocessors(seq_len * S)
    (v, p), (jv, jp) = _both(_raw(3, 4, seq_len * S))
    act = np.eye(A, dtype=np.float32)[np.random.default_rng(3).integers(0, A, (seq_len, 4))]
    jnet = JaxMemoryNetwork(S, A, 8, 1, G)
    proto = (jrlt.FeatureData(jnp.zeros((1, 1, S))), jrlt.FeatureData(jnp.zeros((1, 1, A))))
    jparams = jnet.init(jax.random.PRNGKey(6), *proto)
    net = MemoryNetwork(S, A, 8, 1, G)
    got = pw.MDNRNNWithPreprocessor(net, memory_network_state_from_flax(_np(jparams)), pre,
                                    seq_len, A)(v, p, torch.tensor(act))
    want = jw.MDNRNNWithPreprocessor(jnet, jparams, jpre, seq_len, A)(jv, jp, jnp.asarray(act))
    for f in ("mus", "sigmas", "logpi", "reward", "not_terminal"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   **FWD_TOL, err_msg=f)

    C, CD = 5, 3
    spre, jspre = _preprocessors(S)
    cpre, jcpre = _preprocessors(CD)
    state_vp, jstate_vp = _both(_raw(4, 2, S))
    cv, cp = _raw(5, 2 * C, CD)
    cand_vp, jcand_vp = _both((cv.reshape(2, C, CD), cp.reshape(2, C, CD)))
    jmlp = JaxMLPScorer(input_dim=CD, sizes=[8], activations=["relu"])
    jmlp_params = jmlp.init(jax.random.PRNGKey(7), jrlt.FeatureData(
        float_features=jnp.zeros((1, S)),
        candidate_docs=jrlt.DocList(float_features=jnp.zeros((1, C, CD)))))
    mlp = MLPScorer(CD, [8], ["relu"])
    got = pw.LearnVMSlateWithPreprocessor(mlp, q_network_state_from_flax(_np(jmlp_params)),
                                          spre, cpre)(state_vp, cand_vp)
    want = jw.LearnVMSlateWithPreprocessor(jmlp, jmlp_params, jspre, jcpre)(jstate_vp, jcand_vp)
    assert got.shape == (2, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_score_runs_own_forward_for_activations_k3_lacks():
    """A dense net with a softplus or sigmoid layer is no K3 chain: ``score``
    runs its own forward (it raised in the plain version before)."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(3, S)).astype(np.float32))
    for act in ("softplus", "sigmoid"):
        net = FullyConnectedDQN(S, A, [8], [act])
        params = functional.params_of(net)
        assert not functional.takes_k3(net)
        fused_mlp.fused_mlp_forward_reference.calls = 0
        torch.testing.assert_close(functional.score(net, params, x), net(x).detach())
        assert fused_mlp.fused_mlp_forward_reference.calls == 0
    assert functional.takes_k3(FullyConnectedNetwork([S, 4, 2], ["tanh", "linear"]))


# ---------------------------------------------------------- evaluators


def _evaluator_batch(seed, pkg, discrete):
    """States with a one-hot block (features 0-1) and two scalars; actions
    one-hot (discrete) or normal; T * B even, so the medians average."""
    rng = np.random.default_rng(seed)
    Sd = 4
    state = rng.normal(size=(T, B, Sd)).astype(np.float32)
    state[..., :2] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))]
    action = (np.eye(A, dtype=np.float32)[rng.integers(0, A, (T, B))] if discrete
              else rng.normal(size=(T, B, A)).astype(np.float32))
    next_state = (0.5 * state + 2.0 * action[..., :1]).astype(np.float32)
    t, mod = (jnp.asarray, jrlt) if pkg == "jax" else (torch.tensor, rlt)
    return mod.MemoryNetworkInput(
        state=mod.FeatureData(t(state)), action=mod.FeatureData(t(action)),
        next_state=mod.FeatureData(t(next_state)), reward=t(np.zeros((T, B), np.float32)),
        not_terminal=t(np.ones((T, B), np.float32)), time_diff=None, step=None)


@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_world_model_evaluators_match_jax(discrete):
    """The losses, each feature's loss increase (modes, midpoint medians,
    forced discrete actions) and the action sensitivity on JAX's
    permutation."""
    Sd = 4
    params = dict(hidden_size=8, num_hidden_layers=1, num_gaussians=2)
    jtrainer = JaxMDNRNNTrainer(JaxMemoryNetwork(Sd, A, 8, 1, 2), JaxMDNRNNParams(**params))
    jb, b = _evaluator_batch(9, "jax", discrete), _evaluator_batch(9, "torch", discrete)
    jparams = jtrainer.init(jax.random.PRNGKey(8), jb).params
    jtrainer.get_loss = jax.jit(jtrainer.get_loss)  # the evaluators' many calls, compiled once
    trainer = MDNRNNTrainer(MemoryNetwork(Sd, A, 8, 1, 2), MDNRNNTrainerParameters(**params),
                            device="cpu")
    net_params = memory_network_state_from_flax(_np(jparams))

    got = ev.LossEvaluator(trainer, Sd).evaluate(net_params, b)
    want = jev.LossEvaluator(jtrainer, Sd).evaluate(jparams, jb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **LOSS_TOL, err_msg=k)

    kw = dict(discrete_action=discrete, state_feature_num=3, action_feature_num=A,
              sorted_action_feature_start_indices=[0, 1],
              sorted_state_feature_start_indices=[0, 2, 3])
    got = ev.FeatureImportanceEvaluator(trainer, **kw).evaluate(net_params, b)
    want = jev.FeatureImportanceEvaluator(jtrainer, **kw).evaluate(jparams, jb)
    np.testing.assert_allclose(got["feature_loss_increase"], want["feature_loss_increase"],
                               rtol=1e-4, atol=1e-5)

    kw = dict(state_feature_num=3, sorted_state_feature_start_indices=[0, 2, 3])
    _, r = jax.random.split(jax.random.PRNGKey(0))
    perm = _t(jax.random.permutation(r, B))
    got = ev.FeatureSensitivityEvaluator(trainer, **kw).evaluate(net_params, b, perm=perm)
    want = jev.FeatureSensitivityEvaluator(jtrainer, **kw).evaluate(jparams, jb)
    np.testing.assert_allclose(got["feature_sensitivity"], want["feature_sensitivity"],
                               **FWD_TOL)
    drawn = ev.FeatureSensitivityEvaluator(trainer, **kw).evaluate(net_params, b)
    assert drawn["feature_sensitivity"].shape == (3,)


def test_median_is_jax_midpoint_and_mode():
    x = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)
    np.testing.assert_allclose(ev.median_feature_value(torch.tensor(x)).numpy(),
                               np.asarray(jev._median_feature_value(jnp.asarray(x))), rtol=0,
                               atol=0)
    onehot = np.eye(3, dtype=np.float32)[[0, 2, 2, 1, 2, 0]]
    np.testing.assert_array_equal(ev.median_feature_value(torch.tensor(onehot)).numpy(),
                                  np.asarray(jev._median_feature_value(jnp.asarray(onehot))))


def test_entry_points_default_to_the_card():
    """Every new entry point defaults to ``device="cuda"`` and raises where
    there is no card, unless it is asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from reagent_tpu_torch.gym import model_based as mb
    from reagent_tpu_torch.model_managers import SyntheticReward
    from reagent_tpu_torch.training.reward_network_trainer import RewardNetTrainer

    net = Seq2RewardNetwork(S, A, 4, 1)
    for make in (
            lambda: Seq2RewardTrainer(net),
            lambda: CompressModelTrainer(FullyConnectedDQN(S, A, [4], ["relu"]), net),
            lambda: RewardNetTrainer(FullyConnectedDQN(S, 1, [4], ["relu"])),
            lambda: CEMPlannerNetwork(MemoryNetwork(S, A, 4, 1, 1), [None], 1, 4, 1, 2, 2, S, A,
                                      True, True, 1.0),
            lambda: WorldModel().build_trainer(None, state_dim=S, action_dim=A),
            lambda: Seq2RewardModel().build_trainer(None, state_dim=S, action_dim=A),
            lambda: SyntheticReward().build_trainer(None, state_dim=S, action_dim=A),
            lambda: gen_permutations(2, A),
            lambda: mb.cem_lindyna(1, wm_steps=1, eval_episodes=1)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


@pytest.mark.slow
@pytest.mark.parametrize("num_world_models", [1, 2])
def test_cem_lindyna_job_meets_the_bar_on_the_cpu(num_world_models):
    """The JAX test's LinDyna job at full depth (512 rollouts, 400 MDN-RNN
    steps a member, CEM 10 x 100, 5 episodes) over the -2.5 bar."""
    from reagent_tpu_torch.gym import model_based as mb

    r = mb.cem_lindyna(num_world_models, "cpu")
    assert r["mean_return"] >= r["bar"], r["returns"]


@pytest.mark.slow
def test_cem_cartpole_job_meets_the_bar_on_the_cpu():
    """The JAX test's CartPole job at full depth (200,000 transitions, 1,000
    MDN-RNN steps, horizon 10, 3 episodes of up to 200) over the 100 bar."""
    from reagent_tpu_torch.gym import model_based as mb

    r = mb.cem_cartpole("cpu")
    assert r["mean_return"] >= r["bar"], r["returns"]
