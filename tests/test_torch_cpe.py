"""CPE against the JAX package: BCQ's mask, the evaluation data page, the
DM/IPS/DR, seq-DR, WDR and MAGIC estimators, the ``Evaluator``, and
``DQNTrainer`` with its CPE heads and with BCQ in 5-step lockstep from
carried weights.  Inputs come from numpy seeds and go to both packages;
``np.random`` (the bootstraps' stream) is seeded alike before each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRLParameters
from reagent_tpu.evaluation import Evaluator as JaxEvaluator
from reagent_tpu.evaluation.doubly_robust_estimator import (
    DoublyRobustEstimator as JaxDoublyRobustEstimator,
)
from reagent_tpu.evaluation.evaluation_data_page import (
    EvaluationDataPage as JaxEvaluationDataPage,
)
from reagent_tpu.evaluation.evaluation_data_page import (
    compute_values_for_mdps as jax_compute_values_for_mdps,
)
from reagent_tpu.evaluation.jax_sequential_estimators import (
    JaxSequentialDoublyRobustEstimator,
    JaxWeightedSequentialDoublyRobustEstimator,
)
from reagent_tpu.evaluation.sequential_doubly_robust_estimator import (
    SequentialDoublyRobustEstimator as JaxSequentialOracle,
)
from reagent_tpu.evaluation.weighted_sequential_doubly_robust_estimator import (
    WeightedSequentialDoublyRobustEstimator as JaxWeightedOracle,
)
from reagent_tpu.models.bcq import bcq_mask_q_values as jax_bcq_mask_q_values
from reagent_tpu.net_builder import discrete_dqn as jax_dqn_builders
from reagent_tpu.training.dqn_trainer import DQNTrainer as JaxDQNTrainer
from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.evaluation import (
    CpeDetails,
    DoublyRobustEstimator,
    EvaluationDataPage,
    Evaluator,
    SequentialDoublyRobustEstimator,
    WeightedSequentialDoublyRobustEstimator,
)
from reagent_tpu_torch.evaluation.evaluation_data_page import compute_values_for_mdps
from reagent_tpu_torch.evaluation.torch_sequential_estimators import (
    TorchSequentialDoublyRobustEstimator,
    TorchWeightedSequentialDoublyRobustEstimator,
    pad_edp_trajectories,
)
from reagent_tpu_torch.models.bcq import BatchConstrainedDQN, bcq_mask_q_values
from reagent_tpu_torch.net_builder import discrete_dqn as dqn_builders
from reagent_tpu_torch.training.dqn_trainer import DQNTrainer
from reagent_tpu_torch.utils.interop import (
    dqn_state_from_arrays,
    opt_state_from_arrays,
    q_network_state_from_flax,
    state_to_arrays,
)

D, A, B = 5, 3, 32
SIZES, ACTS = [16, 8], ["leaky_relu", "relu"]
CPE_SIZES, CPE_ACTS = [12], ["relu"]
ACTIONS = ("a0", "a1", "a2")
# Tolerances against the JAX package.  Exact where both run the same numpy
# code on the same page (DM/IPS/DR, the oracles); float32 on two libraries
# with sums in another order otherwise.  On these pages the port's seq-DR,
# WDR and MAGIC come within 2.6e-7, 2.8e-7 and 1.6e-6 (relative) of JAX's
# batched estimators and of the float64 oracles, where JAX's own are held
# to the oracles at 2e-4 and 5e-4 (tests/test_jax_cpe.py).  MAGIC is held
# twice as loosely as WDR: its SLSQP may step otherwise on inputs that
# differ in the last bits.
PAGE_TOL = dict(rtol=1e-5, atol=1e-6)        # forwards, softmax, sums
DR_TOL = dict(rel=1e-5, abs=1e-6)             # DM/IPS/DR of such a page
SEQ_DR_TOL = dict(rel=1e-5, abs=1e-6)
WDR_TOL = dict(rel=1e-5, abs=1e-6)
MAGIC_TOL = dict(rel=2e-5, abs=2e-6)
STD_TOL = dict(rel=1e-4, abs=1e-6)            # bootstraps of float32 inputs


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ----------------------------------------------------------------------- BCQ


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.9])
def test_bcq_mask_q_values_matches_jax(threshold):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 6)).astype(np.float32)
    logits = (3 * rng.normal(size=(64, 6))).astype(np.float32)
    logits[0] = 0.0  # all equal: every action kept
    want = np.asarray(jax_bcq_mask_q_values(jnp.asarray(q), jnp.asarray(logits), threshold))
    got = bcq_mask_q_values(torch.tensor(q), torch.tensor(logits), threshold).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        BatchConstrainedDQN(threshold)(torch.tensor(q), torch.tensor(logits)).numpy(), want)
    assert (got[0] == q[0]).all()
    if threshold > 0:
        assert (got == np.float32(-3.4e38)).any()


# -------------------------------------------------------- trainers and pages


def _batches(seed, n, ones_mask=False):
    """Batches with terminal rows, some next actions impossible, rewards in
    [0, 1) and the logged action's propensity."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        mask = (rng.random((B, A)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        not_terminal = (rng.random((B, 1)) > 0.2).astype(np.float32)
        yield dict(
            s=rng.normal(size=(B, D)).astype(np.float32),
            ns=rng.normal(size=(B, D)).astype(np.float32),
            a=np.eye(A, dtype=np.float32)[rng.integers(0, A, B)],
            na=np.eye(A, dtype=np.float32)[rng.integers(0, A, B)],
            r=rng.uniform(0, 1, size=(B, 1)).astype(np.float32),
            nt=not_terminal,
            pam=np.ones((B, A), np.float32) if ones_mask else mask[::-1].copy(),
            mask=mask,
            mdp=np.repeat(np.arange(B // 4), 4).reshape(-1, 1)[::-1].copy(),
            seq=np.tile(np.arange(4), B // 4).reshape(-1, 1)[::-1].copy(),
            prop=rng.uniform(0.2, 0.9, size=(B, 1)).astype(np.float32),
        )


def _batch(mod, conv, b):
    return mod.DiscreteDqnInput(
        state=mod.FeatureData(float_features=conv(b["s"])),
        next_state=mod.FeatureData(float_features=conv(b["ns"])),
        action=conv(b["a"]), next_action=conv(b["na"]), reward=conv(b["r"]),
        time_diff=None, step=None, not_terminal=conv(b["nt"]),
        possible_actions_mask=conv(b["pam"]),
        possible_next_actions_mask=conv(b["mask"]),
        extras=mod.ExtraData(mdp_id=conv(b["mdp"]), sequence_number=conv(b["seq"]),
                             action_probability=conv(b["prop"])),
    )


def _adam(opt_state):
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return opt_state_from_arrays(count=np.asarray(leaf.count), mu=_np_tree(leaf.mu),
                                         nu=_np_tree(leaf.nu))
    raise AssertionError("no Adam state in the optax chain")


def _trainers(rl_kw, cpe=True, double_q=True, bcq=None):
    """(JAX trainer and its init state, the port's trainer and the state
    carried from it)."""
    def nets(mod):
        q = mod.FullyConnected(sizes=SIZES, activations=ACTS).build_q_network(
            None, A, state_dim=D)
        heads = [mod.FullyConnected(sizes=CPE_SIZES, activations=CPE_ACTS).build_q_network(
            None, A, state_dim=D) for _ in range(2)] if cpe else [None, None]
        return q, *heads

    optimizer = {"Adam": {"lr": 0.01}}
    jq, jr, jc = nets(jax_dqn_builders)
    jtrainer = JaxDQNTrainer(
        jq, rl=JaxRLParameters(**rl_kw), double_q_learning=double_q, bcq_drop_threshold=bcq,
        bcq_imitator=jq if bcq is not None else None, optimizer=optimizer,
        action_names=ACTIONS, reward_network=jr, q_network_cpe=jc)
    jstate = jtrainer.init(jax.random.PRNGKey(1), jnp.zeros((1, D)))
    q, r, c = nets(dqn_builders)
    trainer = DQNTrainer(
        q, rl=RLParameters(**rl_kw), double_q_learning=double_q, bcq_drop_threshold=bcq,
        bcq_imitator=q if bcq is not None else None, optimizer=optimizer,
        action_names=ACTIONS, reward_network=r, q_network_cpe=c, device="cpu")
    heads = {}
    if cpe:
        heads = dict(
            reward_params=_np_tree(jstate.reward_params),
            reward_opt_state=_adam(jstate.reward_opt_state),
            cpe_params=_np_tree(jstate.cpe_params),
            cpe_target_params=_np_tree(jstate.cpe_target_params),
            cpe_opt_state=_adam(jstate.cpe_opt_state))
    state = dqn_state_from_arrays(
        _np_tree(jstate.q_params), _np_tree(jstate.q_target_params), _adam(jstate.opt_state),
        np.asarray(jstate.step), **heads)
    return jtrainer, jstate, trainer, state


TREES = ("q_params", "q_target_params", "reward_params", "cpe_params", "cpe_target_params")


def _assert_trees_close(state, jstate, trees=TREES, rtol=1e-4, atol=1e-5):
    for name in trees:
        want = q_network_state_from_flax(_np_tree(getattr(jstate, name)))
        got = getattr(state, name)
        assert set(got) == set(want), name
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("mode", ["double_q", "single_q", "sarsa"])
def test_cpe_heads_lockstep_with_jax(mode):
    """5 steps with the reward and CPE Q heads from JAX's init: the three
    losses rtol 1e-5 atol 1e-6, all five parameter trees rtol 1e-4 atol
    1e-5 (as the QR-DQN lockstep), the optimizer moments the same."""
    rl_kw = dict(gamma=0.9, target_update_rate=0.1, maxq_learning=mode != "sarsa",
                 reward_boost={"a1": 0.25})
    jtrainer, jstate, trainer, state = _trainers(rl_kw, double_q=mode == "double_q")
    for b in _batches(4, 5):
        jstate, jm = jtrainer.train_step(jstate, _batch(jrlt, jnp.asarray, b))
        state, m = trainer.train_step(state, _batch(rlt, torch.tensor, b))
        assert {"td_loss", "reward_loss", "cpe_td_loss"} <= set(m) and set(m) == set(jm)
        for key in ("td_loss", "reward_loss", "cpe_td_loss", "reward_mean"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    _assert_trees_close(state, jstate)
    for name in ("opt_state", "reward_opt_state", "cpe_opt_state"):
        ours, theirs = getattr(state, name), _adam(getattr(jstate, name))
        assert int(ours.count) == int(theirs.count) == 5
        for k in ours.mu:
            np.testing.assert_allclose(ours.mu[k].numpy(), theirs.mu[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{name} {k}")
    # the CPE fields round-trip through the interop carriers
    arrays = state_to_arrays(state)
    assert arrays["cpe_opt_state"]["mu"].keys() == state.cpe_params.keys()
    np.testing.assert_array_equal(arrays["reward_params"]["net.layers.0.weight"],
                                  state.reward_params["net.layers.0.weight"].numpy())


def test_bcq_lockstep_with_jax():
    """BCQ at threshold 0.3: the imitator is applied with the q-network's
    parameters, as JAX's trainer does; 5 steps, tolerances as above."""
    rl_kw = dict(gamma=0.9, target_update_rate=0.1)
    jtrainer, jstate, trainer, state = _trainers(rl_kw, cpe=False, bcq=0.3)
    for b in _batches(6, 5):
        jstate, jm = jtrainer.train_step(jstate, _batch(jrlt, jnp.asarray, b))
        state, m = trainer.train_step(state, _batch(rlt, torch.tensor, b))
        np.testing.assert_allclose(float(m["td_loss"]), float(jm["td_loss"]),
                                   rtol=1e-5, atol=1e-6)
    _assert_trees_close(state, jstate, trees=("q_params", "q_target_params"))
    assert state.reward_params is None and state.cpe_opt_state is None


def test_bcq_drops_actions_from_the_target():
    """The imitator (the q-network's own logits) at threshold 1 keeps only
    its greedy action, so the single-Q target is the target net's value
    there; at threshold 0 every action stays and the target is the masked
    max, as without BCQ."""
    rl_kw = dict(gamma=0.9, target_update_rate=0.1)
    b = next(_batches(8, 1))
    b["mask"][:] = 1.0
    noise = np.random.default_rng(1)
    targets = {}
    for thr in (None, 0.0, 1.0):
        _, _, trainer, state = _trainers(rl_kw, cpe=False, double_q=False, bcq=thr)
        # a target net apart from the online one, the same for each threshold
        state.q_target_params = {
            k: v + torch.tensor(noise.normal(size=v.shape).astype(np.float32))
            for k, v in sorted(state.q_target_params.items())}
        noise = np.random.default_rng(1)
        targets[thr] = trainer._td_target(state, _batch(rlt, torch.tensor, b))[0]
    torch.testing.assert_close(targets[0.0], targets[None], rtol=0, atol=0)
    assert (targets[1.0] < targets[None]).any() and (targets[1.0] <= targets[None]).all()


def test_cpe_trainer_on_cuda_without_a_card_raises():
    net = dqn_builders.FullyConnected(sizes=SIZES, activations=ACTS).build_q_network(
        None, A, state_dim=D)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        DQNTrainer(net, reward_network=net, q_network_cpe=net, device="cuda")


def _pages(trainer, state, jtrainer, jstate, b):
    args = lambda conv: (b["mdp"], b["seq"], conv(b["s"]), conv(b["a"]),  # noqa: E731
                         conv(b["prop"]), conv(b["r"]), conv(b["pam"]))
    ours = EvaluationDataPage.create_from_tensors_dqn(trainer, state, *args(torch.tensor))
    theirs = JaxEvaluationDataPage.create_from_tensors_dqn(jtrainer, jstate, *args(jnp.asarray))
    return ours, theirs


def _assert_pages_close(ours, theirs):
    """Every field; the greedy action exactly wherever the top two Q-values
    are more than 1e-5 apart, and the flips elsewhere counted."""
    for name in theirs.__dataclass_fields__:
        want, got = getattr(theirs, name), getattr(ours, name)
        if want is None:
            assert got is None, name
            continue
        assert got.shape == want.shape, name
        if name == "eval_action_idxs":
            top2 = np.sort(theirs.optimal_q_values, axis=1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 1e-5
            np.testing.assert_array_equal(got[clear], want[clear])
            assert (got[~clear] != want[~clear]).sum() <= (~clear).sum()
        else:
            np.testing.assert_allclose(got, want, **PAGE_TOL, err_msg=name)


@pytest.mark.parametrize("cpe", [True, False], ids=["cpe_heads", "q_only"])
def test_create_from_tensors_dqn_matches_jax(cpe):
    """The page of a trained state, carried from JAX: Q, the CPE head's Q
    as ``model_values`` (else Q), the reward head's predictions (else
    zeros), the masked softmax at the config's temperature and argmax."""
    rl_kw = dict(gamma=0.9, target_update_rate=0.1, temperature=0.5)
    jtrainer, jstate, trainer, state = _trainers(rl_kw, cpe=cpe)
    for b in _batches(2, 2):
        jstate, _ = jtrainer.train_step(jstate, _batch(jrlt, jnp.asarray, b))
        state, _ = trainer.train_step(state, _batch(rlt, torch.tensor, b))
    b = next(_batches(3, 1))
    ours, theirs = _pages(trainer, state, jtrainer, jstate, b)
    _assert_pages_close(ours, theirs)
    if not cpe:
        assert (ours.model_rewards == 0).all()
        np.testing.assert_array_equal(ours.model_values, ours.optimal_q_values)
    # the typed-batch entry gives the same page
    via_batch = EvaluationDataPage.create_from_training_batch(
        _batch(rlt, torch.tensor, b), trainer, state)
    for name in ("model_propensities", "model_values", "model_rewards", "mdp_id"):
        np.testing.assert_array_equal(getattr(via_batch, name), getattr(ours, name))


def test_page_operations_match_jax():
    """append, sort, compute_values and compute_values_for_mdps on pages
    built from one carried state: sort and append exact, values rtol 1e-6."""
    jtrainer, jstate, trainer, state = _trainers(dict(gamma=0.9, target_update_rate=0.1))
    (o1, t1), (o2, t2) = (_pages(trainer, state, jtrainer, jstate, b) for b in _batches(5, 2))
    o2 = o2.replace(mdp_id=o2.mdp_id + 100)
    t2 = t2.replace(mdp_id=t2.mdp_id + 100)
    ours, theirs = o1.append(o2).sort(), t1.append(t2).sort()
    np.testing.assert_array_equal(ours.mdp_id, theirs.mdp_id)
    np.testing.assert_array_equal(ours.sequence_number, theirs.sequence_number)
    _assert_pages_close(ours, theirs)
    ours, theirs = ours.compute_values(0.9), theirs.compute_values(0.9)
    np.testing.assert_allclose(ours.logged_values, theirs.logged_values, rtol=1e-6)
    ours.validate()
    rng = np.random.default_rng(0)
    r = rng.uniform(0, 1, (40, 1)).astype(np.float32)
    mdp = np.repeat(np.arange(8), 5).reshape(-1, 1)
    seq = np.tile([0, 1, 3, 4, 7], 8).reshape(-1, 1)  # gaps: gamma ** (seq difference)
    np.testing.assert_array_equal(compute_values_for_mdps(r, mdp, seq, 0.8),
                                  jax_compute_values_for_mdps(r, mdp, seq, 0.8))


# ----------------------------------------------------------------- estimators


def make_edp(cls, seed=5, n_traj=30, num_actions=4, reward_low=0.0):
    """tests/test_jax_cpe.py's page: episodes of 3-14 steps, logged and
    target policies from random logits, rewards in [reward_low, 1)."""
    rng = np.random.default_rng(seed)
    rows = []
    for mdp in range(n_traj):
        T = int(rng.integers(3, 15))
        rows.extend((mdp, t) for t in range(T))
    n = len(rows)
    logits_b = rng.normal(size=(n, num_actions))
    logits_t = rng.normal(size=(n, num_actions))
    behavior = np.exp(logits_b) / np.exp(logits_b).sum(1, keepdims=True)
    target = (np.exp(logits_t) / np.exp(logits_t).sum(1, keepdims=True)).astype(np.float32)
    logged = np.array([rng.choice(num_actions, p=behavior[i]) for i in range(n)])
    mask = np.zeros((n, num_actions), np.float32)
    mask[np.arange(n), logged] = 1.0
    return cls(
        mdp_id=np.array([r[0] for r in rows], np.int64).reshape(n, 1),
        sequence_number=np.array([r[1] for r in rows], np.int64).reshape(n, 1),
        logged_propensities=behavior[np.arange(n), logged].reshape(n, 1).astype(np.float32),
        logged_rewards=rng.uniform(reward_low, 1.0, (n, 1)).astype(np.float32),
        action_mask=mask,
        model_propensities=target,
        model_rewards=rng.uniform(0.0, 1.0, (n, num_actions)).astype(np.float32),
        model_rewards_for_logged_action=rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32),
        model_values=rng.uniform(0.0, 4.0, (n, num_actions)).astype(np.float32),
        optimal_q_values=rng.normal(size=(n, num_actions)).astype(np.float32),
        eval_action_idxs=rng.integers(0, num_actions, n),
    )


def _estimate(fn, seed):
    np.random.seed(seed)
    return fn()


def _assert_estimate(got, want, tol, std_tol=STD_TOL):
    assert got.raw == pytest.approx(want.raw, **tol)
    assert got.normalized == pytest.approx(want.normalized, **tol)
    assert got.raw_std_error == pytest.approx(want.raw_std_error, **std_tol)
    assert got.normalized_std_error == pytest.approx(want.normalized_std_error, **std_tol)


def test_padding_matches_the_oracle_transform():
    edp = make_edp(EvaluationDataPage)
    padded = pad_edp_trajectories(edp, "cpu")
    want = WeightedSequentialDoublyRobustEstimator.transform_to_equal_length_trajectories(
        edp.mdp_id, edp.action_mask, edp.logged_rewards.reshape(-1),
        edp.logged_propensities.reshape(-1), edp.model_propensities, edp.model_values)
    for got, w in zip(padded, want):
        np.testing.assert_array_equal(got.numpy(), w.astype(np.float32))


@pytest.mark.parametrize("reward_low", [0.0, -2.0], ids=["uniform_0_1", "negative_mean"])
def test_dm_ips_dr_match_jax(reward_low):
    """The same numpy code on the same page: equal, bootstraps included;
    a negative mean reward takes the ``< 1e-6`` branch (normalized 0)."""
    edp = make_edp(EvaluationDataPage, reward_low=reward_low)
    jedp = make_edp(JaxEvaluationDataPage, reward_low=reward_low)
    got = _estimate(lambda: DoublyRobustEstimator().estimate(edp), 3)
    want = _estimate(lambda: JaxDoublyRobustEstimator().estimate(jedp), 3)
    assert got == want
    if reward_low < 0:
        assert all(e.normalized == 0.0 for e in got)


@pytest.mark.parametrize("reward_low", [0.0, -2.0], ids=["uniform_0_1", "negative_mean"])
def test_seq_dr_matches_jax_and_the_oracle(reward_low):
    gamma = 0.95
    edp = make_edp(EvaluationDataPage, reward_low=reward_low)
    jedp = make_edp(JaxEvaluationDataPage, reward_low=reward_low)
    got = _estimate(lambda: TorchSequentialDoublyRobustEstimator(gamma, "cpu").estimate(edp), 2)
    oracle = _estimate(lambda: SequentialDoublyRobustEstimator(gamma).estimate(edp), 2)
    jax_oracle = _estimate(lambda: JaxSequentialOracle(gamma).estimate(jedp), 2)
    jax_batched = _estimate(lambda: JaxSequentialDoublyRobustEstimator(gamma).estimate(jedp), 2)
    assert oracle == jax_oracle
    _assert_estimate(got, oracle, SEQ_DR_TOL)
    _assert_estimate(got, jax_batched, SEQ_DR_TOL)
    assert (got.normalized == 0.0) == (reward_low < 0)


@pytest.mark.parametrize("num_j_steps,self_norm", [(1, True), (1, False), (25, True), (25, False)])
def test_wdr_and_magic_match_jax_and_the_oracle(num_j_steps, self_norm):
    """WDR (1 j-step) and MAGIC (25) against the float64 numpy oracle and
    JAX's float32 batched estimator, at the tolerances above."""
    gamma = 0.9
    edp = make_edp(EvaluationDataPage)
    jedp = make_edp(JaxEvaluationDataPage)
    tol = WDR_TOL if num_j_steps == 1 else MAGIC_TOL

    def run(est, page):
        return _estimate(lambda: est.estimate(page, num_j_steps, self_norm), 4)

    got = run(TorchWeightedSequentialDoublyRobustEstimator(gamma, "cpu"), edp)
    oracle = run(WeightedSequentialDoublyRobustEstimator(gamma), edp)
    assert oracle == run(JaxWeightedOracle(gamma), jedp)
    _assert_estimate(got, oracle, tol)
    _assert_estimate(got, run(JaxWeightedSequentialDoublyRobustEstimator(gamma), jedp), tol)
    assert np.isfinite(got.raw) and got.normalized != 0.0


@pytest.mark.parametrize("num_j_steps", [1, 25])
def test_wdr_single_trajectory_page(num_j_steps):
    """One trajectory: MAGIC falls back to WDR, as JAX's does, and agrees
    with JAX's batched estimator."""
    edp = make_edp(EvaluationDataPage, n_traj=1)
    jedp = make_edp(JaxEvaluationDataPage, n_traj=1)
    got = TorchWeightedSequentialDoublyRobustEstimator(0.9, "cpu").estimate(edp, num_j_steps, True)
    want = JaxWeightedSequentialDoublyRobustEstimator(0.9).estimate(jedp, num_j_steps, True)
    _assert_estimate(got, want, WDR_TOL)


def _assert_details_close(got: CpeDetails, want, magic_tol=MAGIC_TOL):
    for name in want.reward_estimates._fields:
        g, w = getattr(got.reward_estimates, name), getattr(want.reward_estimates, name)
        tol = {"direct_method": DR_TOL, "inverse_propensity": DR_TOL,
               "doubly_robust": DR_TOL, "sequential_doubly_robust": SEQ_DR_TOL,
               "weighted_doubly_robust": WDR_TOL, "magic": magic_tol}[name]
        _assert_estimate(g, w, tol)
    assert got.metric_estimates == want.metric_estimates == {}
    for name in ("q_value_means", "q_value_stds", "action_distribution"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.keys() == w.keys(), name
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-6), (name, k)


def test_evaluator_matches_jax_field_by_field():
    """``evaluate_post_training`` on one page: every estimate of the set,
    the q-value means and stds and the action distribution; an observer of
    ``cpe_details`` sees the result."""
    names = ["a0", "a1", "a2", "a3"]
    edp = make_edp(EvaluationDataPage).sort().compute_values(0.9)
    jedp = make_edp(JaxEvaluationDataPage).sort().compute_values(0.9)

    class Seen:
        observing_keys = ["cpe_details"]
        values = []

        def update(self, key, value):
            self.values.append(value)

    evaluator = Evaluator(names, 0.9, device="cpu").add_observer(Seen())
    got = _estimate(lambda: evaluator.evaluate_post_training(edp), 7)
    want = _estimate(lambda: JaxEvaluator(names, 0.9).evaluate_post_training(jedp), 7)
    _assert_details_close(got, want)
    assert Seen.values == [got]
    # the numpy oracles' route gives the same set within the same bounds
    oracle = _estimate(lambda: Evaluator(names, 0.9, use_padded_sequential_estimators=False,
                                         device="cpu").evaluate_post_training(edp), 7)
    _assert_details_close(got, oracle)


def test_cuda_without_a_card_raises():
    edp = make_edp(EvaluationDataPage, n_traj=3)
    for make in (lambda: Evaluator(["a"], 0.9),
                 lambda: pad_edp_trajectories(edp),
                 lambda: TorchSequentialDoublyRobustEstimator(0.9),
                 lambda: TorchWeightedSequentialDoublyRobustEstimator(0.9)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
