"""The off-policy-estimation slice's nets against the JAX package on the CPU:
``NNTrainer`` (the reward model), ``NeuralDualDICE`` and the CartPole
harness, each from the same numpy-made inputs, JAX's init and JAX's own
draws (the port takes them as values where JAX splits a key).  On the CPU
the port's K3 forwards take K3's plain version."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.models import FullyConnectedDQN as JaxDQN
from reagent_tpu.ope.estimators.sequential_estimators import NeuralDualDICE as JaxDualDICE
from reagent_tpu.ope.test import cartpole as jax_cartpole
from reagent_tpu.ope.test.gridworld import GridWorld as JaxGridWorld
from reagent_tpu.ope.test.gridworld import generate_logs as jax_generate_logs
from reagent_tpu.ope.test.slate_benchmark import QueryCorpus as JaxCorpus
from reagent_tpu.ope.test.slate_benchmark import evaluate_slate_benchmark as jax_slate_benchmark
from reagent_tpu.ope.trainers import NNTrainer as JaxNNTrainer
from reagent_tpu.ope.trainers import TrainingData as JaxTrainingData
from reagent_tpu.ope.trainers.rl_tabular_trainers import DPTrainer as JaxDPTrainer
from reagent_tpu.ope.trainers.rl_tabular_trainers import DPValueFunction as JaxDPValue
from reagent_tpu.ope.trainers.rl_tabular_trainers import TabularPolicy as JaxTabularPolicy
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.ope.estimators.sequential_estimators import NeuralDualDICE
from reagent_tpu_torch.ope.test import cartpole
from reagent_tpu_torch.ope.test.slate_benchmark import QueryCorpus, evaluate_slate_benchmark
from reagent_tpu_torch.ope.trainers import NNTrainer, TrainingData
from reagent_tpu_torch.ops import fused_mlp
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.interop import (
    dualdice_net_state_from_flax,
    nn_trainer_params_from_arrays,
    q_network_state_from_flax,
)

CPU = "cpu"


def _regression(seed=2, n=400, d=10):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=d)
    w[d // 2:] = 0.0
    x = rng.normal(size=(n, d))
    y = x @ w + rng.normal(scale=0.05, size=n)
    xv = rng.normal(size=(n // 2, d))
    return x, y, xv, xv @ w


def _jax_nn_trainer_losses(monkeypatch, trainer, data, **kw):
    """Train JAX's ``NNTrainer``, recording each jitted step's loss (its
    third output) as it comes back."""
    losses = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        if not getattr(fn, "__qualname__", "").startswith("NNTrainer.train"):
            return jitted  # optax's own, imported while training

        def call(*a):
            out = jitted(*a)
            if isinstance(out, tuple) and len(out) == 3:
                losses.append(float(out[2]))
            return out

        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    trainer.train(data, **kw)
    monkeypatch.setattr(jax, "jit", real_jit)
    return np.array(losses)


def test_nn_trainer_lockstep_with_jax(monkeypatch):
    """30 iterations at hidden 64 from the same seed: the same init and
    minibatches (numpy's default_rng), the losses in lockstep (so the
    10-step plateau check reads the same values), the parameters and the
    predictions (K3's plain version here)."""
    x, y, xv, yv = _regression()
    jt = JaxNNTrainer(hidden_dim=64, hidden_layers=2, seed=3)
    jax_losses = _jax_nn_trainer_losses(monkeypatch, jt, JaxTrainingData(x, y, None, xv, yv),
                                        iterations=30, batch_size=128)
    pt = NNTrainer(hidden_dim=64, hidden_layers=2, seed=3, device=CPU)
    pt.train(TrainingData(x, y, None, xv, yv), iterations=30, batch_size=128)
    assert len(jax_losses) == len(pt.losses) == 30
    np.testing.assert_allclose(torch.stack(pt.losses).numpy(), jax_losses, rtol=1e-4)
    want = nn_trainer_params_from_arrays(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jt._params])
    assert set(pt.params) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(pt.params[k], v, rtol=5e-4, atol=5e-5, msg=k)
    calls = fused_mlp.fused_mlp_forward_reference.calls
    np.testing.assert_allclose(pt.predict(xv), jt.predict(xv), rtol=0, atol=1e-4)
    assert fused_mlp.fused_mlp_forward_reference.calls == calls + 1  # one K3 forward
    # JAX's trained parameters carried across predict as JAX's do
    pt.params = want
    np.testing.assert_allclose(pt.predict(xv), jt.predict(xv), rtol=0, atol=1e-5)


def test_nn_trainer_halves_the_lr_on_a_plateau():
    """A target the net cannot fit: the loss stops improving and the LR
    halves after 5 flat checks of 10 steps, as JAX's schedule does."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3))
    y = rng.normal(size=64)  # noise: nothing to learn past the mean
    pt = NNTrainer(hidden_dim=4, hidden_layers=1, learning_rate=1e-2, seed=0, device=CPU)
    pt.train(TrainingData(x, y), iterations=200, batch_size=64)
    assert pt.lr < 1e-2
    assert pt.lr in {1e-2 * 0.5 ** k for k in range(1, 5)}


def test_nn_trainer_refuses_a_degenerate_shape():
    with pytest.raises(ValueError, match="degenerate"):
        NNTrainer(device=CPU).train(TrainingData(np.zeros((4, 0)), np.zeros(4)))


def _gridworld_logs(episodes, gamma=0.9):
    world = JaxGridWorld(size=3)
    tgt = JaxTabularPolicy(world.num_actions, epsilon=0.1)
    JaxDPTrainer(world, tgt).train(gamma=gamma)
    log = JaxTabularPolicy(world.num_actions, epsilon=0.6)
    for s in world.states:
        log.update(s, int(np.argmax(tgt.action_dist(s))))
    value_fn = JaxDPValue(tgt, world, gamma)
    value_fn.evaluate()
    logs = jax_generate_logs(world, log, tgt, value_fn, num_episodes=episodes, max_steps=12,
                             gamma=gamma)
    logs.ground_truth_reward = value_fn.state_value((0, 0))
    return logs


class _DiceNet(fnn.Module):
    """The JAX estimator's net (sequential_estimators.py:268-277)."""

    out: int
    hidden: int

    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Dense(self.hidden)(x))
        h = fnn.relu(fnn.Dense(self.hidden)(h))
        return fnn.Dense(self.out)(h)


def _jax_dice_init_and_indices(logs, steps, batch, hidden=64):
    """JAX's init (PRNGKey(0), fold_in 1 for zeta) and each step's randint
    indices, derived from its keys as its ``evaluate`` derives them."""
    n_valid = int((logs.mask > 0).sum())
    s = jnp.asarray(logs.states.reshape(-1, logs.states.shape[2])[:1], jnp.float32)
    rng = jax.random.PRNGKey(0)
    net = _DiceNet(out=4, hidden=hidden)
    nu = jax.tree.map(np.asarray, net.init(rng, s))
    zeta = jax.tree.map(np.asarray, net.init(jax.random.fold_in(rng, 1), s))
    idx, i0 = [], []
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        idx.append(np.asarray(jax.random.randint(k, (batch,), 0, n_valid)))
        i0.append(np.asarray(jax.random.randint(jax.random.fold_in(k, 1), (batch,), 0,
                                                logs.actions.shape[0])))
    return (nu, zeta), (torch.tensor(np.stack(idx)), torch.tensor(np.stack(i0)))


def test_neural_dualdice_from_jax_init_and_indices():
    """5 steps from JAX's flax init (through the interop function) and its
    own randint indices: the estimate within rtol 1e-4; the zeta forward is
    one K3 forward (its plain version here)."""
    logs = _gridworld_logs(40)
    steps, batch = 5, 64
    (nu, zeta), indices = _jax_dice_init_and_indices(logs, steps, batch)
    want = JaxDualDICE(state_dim=6, num_actions=4, training_samples=steps,
                       batch_size=batch).evaluate(logs).estimated_reward
    est = NeuralDualDICE(state_dim=6, num_actions=4, training_samples=steps, batch_size=batch,
                         device=CPU)
    calls = fused_mlp.fused_mlp_forward_reference.calls
    got = est.evaluate(logs, params=(dualdice_net_state_from_flax(nu),
                                     dualdice_net_state_from_flax(zeta)), indices=indices)
    assert fused_mlp.fused_mlp_forward_reference.calls == calls + 1
    assert got.estimated_reward == pytest.approx(want, rel=1e-4)
    assert got.log_reward == pytest.approx(logs.log_value(), rel=1e-12)


def test_neural_dualdice_draws_its_own_and_checks_the_indices():
    """Without values the init and the indices come from a generator (seed 0
    by default, so two runs agree); indices for too few steps raise."""
    logs = _gridworld_logs(20)
    est = NeuralDualDICE(state_dim=6, num_actions=4, training_samples=3, batch_size=16,
                         device=CPU)
    a = est.evaluate(logs).estimated_reward
    b = est.evaluate(logs, generator=torch.Generator().manual_seed(0)).estimated_reward
    assert np.isfinite(a) and a == b
    with pytest.raises(ValueError, match="indices"):
        est.evaluate(logs, indices=(torch.zeros((2, 16), dtype=torch.int64),) * 2)


def _cartpole_nets(sizes, seed=0):
    jnet = JaxDQN(state_dim=4, action_dim=2, sizes=sizes, activations=["relu"] * len(sizes))
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4)))
    net = FullyConnectedDQN(4, 2, sizes, ["relu"] * len(sizes))
    net.load_state_dict(q_network_state_from_flax(jax.tree.map(np.asarray, variables)))
    return jnet, variables, net, functional.params_of(net)


def _jax_rollout_draws(rng, num_episodes, horizon):
    """The reset uniforms and categorical gumbels JAX's
    ``collect_trajectories`` draws from ``rng``."""
    def one(key):
        r_reset, r_steps = jax.random.split(key)
        g = jax.vmap(lambda k: jax.random.gumbel(k, (2,)))(jax.random.split(r_steps, horizon))
        return jax.random.uniform(r_reset, (4,)), g

    u, g = jax.vmap(one)(jax.random.split(rng, num_episodes))
    return cartpole.RolloutDraws(torch.tensor(np.asarray(u)), torch.tensor(np.asarray(g)))


def test_cartpole_rollout_from_jax_draws():
    """The batched rollout against JAX's vmapped scan on JAX's own draws:
    the states, actions, rewards, propensities and masks."""
    N, T = 8, 30
    jnet, variables, net, params = _cartpole_nets([32])
    env = jax_cartpole.CartPole(max_steps=T)
    rng = jax.random.PRNGKey(4)
    want = jax_cartpole.collect_trajectories(
        env, lambda o: jnet.apply(variables, o[None])[0], 1.5, N, T, rng)
    got = cartpole.collect_trajectories(
        cartpole.CartPole(max_steps=T, device=CPU),
        lambda o: functional.score(net, params, o), 1.5, N, T,
        draws=_jax_rollout_draws(rng, N, T))
    np.testing.assert_array_equal(got["actions"], want["actions"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["rewards"], want["rewards"])
    np.testing.assert_allclose(got["states"], want["states"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["propensities"], want["propensities"], rtol=1e-5, atol=1e-6)


def test_evaluate_cartpole_from_jax_draws():
    """The harness end to end: IPS and DR within rel 1e-4, MAGIC 2e-4, the
    ground truth exact; the Q-values of every logged state one K3 forward."""
    N, T, seed = 16, 40, 2
    jnet, variables, net, params = _cartpole_nets([32])
    kw = dict(num_episodes=N, horizon=T, behavior_temperature=1.5, target_temperature=0.5)
    want, want_gt = jax_cartpole.evaluate_cartpole(jnet.apply, variables, seed=seed, **kw)
    r_log, r_tgt = jax.random.split(jax.random.PRNGKey(seed))
    draws = (_jax_rollout_draws(r_log, N, T), _jax_rollout_draws(r_tgt, N, T))
    calls = fused_mlp.fused_mlp_forward_reference.calls
    got, gt = cartpole.evaluate_cartpole(net, params, draws=draws, device=CPU, **kw)
    # T act steps of each rollout and the logged states' Q-values
    assert fused_mlp.fused_mlp_forward_reference.calls == calls + 2 * T + 1
    assert gt == want_gt
    for name, rel in (("ips", 1e-4), ("dr", 1e-4), ("magic", 2e-4)):
        assert got[name].estimated_reward == pytest.approx(
            want[name].estimated_reward, rel=rel), name
        assert got[name].log_reward == pytest.approx(want[name].log_reward, rel=1e-6), name


def test_evaluate_cartpole_draws_its_own():
    """Without draws both rollouts come from a generator seeded by ``seed``:
    the same seed gives the same estimates; ``return_logs`` adds the logged
    rollout, the one ``collect_trajectories`` gives on the same draws."""
    _, _, net, params = _cartpole_nets([16])
    kw = dict(num_episodes=4, horizon=12, seed=1, device=CPU)
    a, gt_a = cartpole.evaluate_cartpole(net, params, **kw)
    b, gt_b, logs = cartpole.evaluate_cartpole(net, params, return_logs=True, **kw)
    assert gt_a == gt_b and a["ips"].estimated_reward == b["ips"].estimated_reward
    env = cartpole.CartPole(max_steps=12, device=CPU)
    want = cartpole.collect_trajectories(
        env, cartpole.q_scores(net, params), 2.0, 4, 12,
        generator=torch.Generator(CPU).manual_seed(1))
    assert logs.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(logs[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="draws or a generator"):
        cartpole.collect_trajectories(cartpole.CartPole(device=CPU), None, 1.0, 2, 3)


def test_slate_benchmark_with_nn_trainer_target_ranker():
    """The synthetic corpus with ``NNTrainer`` as the target ranker: its
    predictions one K3 forward, the estimates within rel 1e-4 of JAX's."""
    kw = dict(slate_size=3, num_samples_per_query=5, seed=1)
    want = jax_slate_benchmark(JaxCorpus.synthetic(num_queries=30, num_docs=8, seed=0),
                               tgt_trainer=JaxNNTrainer(hidden_dim=32, seed=0), **kw)
    calls = fused_mlp.fused_mlp_forward_reference.calls
    got = evaluate_slate_benchmark(QueryCorpus.synthetic(num_queries=30, num_docs=8, seed=0),
                                   tgt_trainer=NNTrainer(hidden_dim=32, seed=0, device=CPU),
                                   **kw)
    assert fused_mlp.fused_mlp_forward_reference.calls == calls + 1
    for name in ("ips", "pbm", "pseudo_inverse"):
        assert got[name].estimated_reward == pytest.approx(want[name].estimated_reward,
                                                           rel=1e-4), name
        assert got[name].ground_truth_reward == pytest.approx(
            want[name].ground_truth_reward, rel=1e-4), name


def _default_device_entry_points():
    _, _, net, params = _cartpole_nets([4])
    return {
        "NNTrainer": lambda: NNTrainer(hidden_dim=4),
        "NeuralDualDICE": lambda: NeuralDualDICE(state_dim=6, num_actions=4),
        "evaluate_cartpole": lambda: cartpole.evaluate_cartpole(net, params, num_episodes=2,
                                                                horizon=3),
    }


@pytest.mark.parametrize("name", ["NNTrainer", "NeuralDualDICE", "evaluate_cartpole"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Every OPE entry point that takes a device defaults to ``"cuda"``: with
    no card it raises and names ``device='cpu'``, never dropping to the CPU
    on its own (the card's side: ``test_torch_cuda_ope.py``)."""
    entry = _default_device_entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        entry()


@pytest.mark.slow
def test_neural_dualdice_against_jax_by_depth():
    """The gridworld job (300 episodes) from JAX's init and its randint
    indices at 800 to 2,000 steps, the port beside JAX's own ``evaluate``:
    within rtol 1e-4 at the JAX test's 800 steps; further on, the saddle
    point's free-running Adam swings both packages' estimates by more than
    the ground truth, and float32 order parts them.  Prints each depth's two
    estimates (run with ``-s``); JAX's own meets the bar at its default
    2,000 steps."""
    logs = _gridworld_logs(300)
    gt = logs.ground_truth_reward
    (nu, zeta), (idx, i0) = _jax_dice_init_and_indices(logs, 2000, 256)
    params = (dualdice_net_state_from_flax(nu), dualdice_net_state_from_flax(zeta))
    by_depth = {}
    for steps in range(800, 2001, 200):
        want = JaxDualDICE(state_dim=6, num_actions=4,
                           training_samples=steps).evaluate(logs).estimated_reward
        got = NeuralDualDICE(state_dim=6, num_actions=4, training_samples=steps,
                             device=CPU).evaluate(
            logs, params=params, indices=(idx[:steps], i0[:steps])).estimated_reward
        assert np.isfinite(want) and np.isfinite(got)
        by_depth[steps] = (want, got)
    print({"gt": gt, "steps: (jax, port)": by_depth})
    assert by_depth[800][1] == pytest.approx(by_depth[800][0], rel=1e-4)
    assert by_depth[2000][0] == pytest.approx(gt, abs=max(1.0, 0.8 * abs(gt)))


@pytest.mark.slow
def test_neural_dualdice_on_gridworld_at_full_depth():
    """The JAX test's job (800 steps on the gridworld's 300 episodes) in the
    port, from its own draws: finite and within max(1, 0.8 |gt|)."""
    logs = _gridworld_logs(300)
    gt = logs.ground_truth_reward
    res = NeuralDualDICE(state_dim=6, num_actions=4, training_samples=800,
                         device=CPU).evaluate(logs)
    assert np.isfinite(res.estimated_reward)
    assert res.estimated_reward == pytest.approx(gt, abs=max(1.0, 0.8 * abs(gt)))


@pytest.mark.slow
def test_cartpole_ope_close_to_truth_at_full_depth():
    """The JAX test's job (100 episodes x 50 steps, seed 2) in the port from
    JAX's init and draws: IPS within half the ground truth."""
    N, T, seed = 100, 50, 2
    _, _, net, params = _cartpole_nets([32])
    r_log, r_tgt = jax.random.split(jax.random.PRNGKey(seed))
    draws = (_jax_rollout_draws(r_log, N, T), _jax_rollout_draws(r_tgt, N, T))
    results, gt = cartpole.evaluate_cartpole(
        net, params, num_episodes=N, horizon=T, behavior_temperature=1.5,
        target_temperature=0.5, draws=draws, device=CPU)
    assert abs(results["ips"].estimated_reward - gt) < 0.5 * gt
    assert np.isfinite(results["magic"].estimated_reward)
