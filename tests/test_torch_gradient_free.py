"""Gradient-free training against the JAX package: ARS bit for bit from one
seed, the evolution pool fed JAX's parent and mutations, its state carried
from JAX's mid-run pool, the one-max demo pool, the local ES worker beside
JAX's over the 8-device mesh, and JAX's convergence tests on the port.

Tolerances: the rewards rtol 1e-6 (one vmapped float32 reduction in each
library's order); the parents after 5 iterations rtol 1e-5 (JAX's
mutations, float32 reward-weighted sums over the population, 5 Adam
steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.core.parameters import EvolutionParameters as JaxES
from reagent_tpu.parallel import make_mesh as jax_make_mesh
from reagent_tpu.training.gradient_free import ARSOptimizer as JaxARS
from reagent_tpu.training.gradient_free import EsWorker as JaxEsWorker
from reagent_tpu.training.gradient_free import EvolutionPool as JaxPool
from reagent_tpu.training.gradient_free.evolution_pool import OneMaxEvolutionPool as JaxOneMax
from reagent_tpu_torch.core.parameters import EvolutionParameters
from reagent_tpu_torch.training.gradient_free import (
    ARSOptimizer,
    EsWorker,
    EvolutionPool,
    OneMaxEvolutionPool,
)
from reagent_tpu_torch.utils import interop

REWARD = dict(rtol=1e-6, atol=1e-7)
PARENT = dict(rtol=1e-5, atol=1e-7)
SIZES = {"w": [3], "m": [2, 4]}
TARGET = {"w": np.array([1.0, -2.0, 0.5], np.float32),
          "m": np.arange(8, dtype=np.float32).reshape(2, 4) / 8}


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def host(tree):
    return {k: np.array(v) for k, v in tree.items()}


def tensors(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def jax_reward(ind):
    return -sum(jnp.sum((ind[k] - TARGET[k]) ** 2) for k in TARGET)


def port_reward(ind):
    return -sum(torch.sum((ind[k] - torch.from_numpy(TARGET[k])) ** 2) for k in TARGET)


# ---------------------------------------------------------------------- ARS


@pytest.mark.parametrize("rand_ars_params,b_top", [(False, None), (True, 3)])
def test_ars_bit_for_bit(rand_ars_params, b_top):
    """JAX's ARS test on both copies from one seed: the same perturbations
    and ``ars_params`` every iteration, bit for bit."""
    kw = dict(feature_dim=2, n_pert=8, alpha=0.5, noise=0.5, rand_ars_params=rand_ars_params,
              b_top=b_top, seed=3)
    ours, theirs = ARSOptimizer(**kw), JaxARS(**kw)
    target = np.array([2.0, -1.0])
    for _ in range(60):
        pairs, jpairs = ours.sample_perturbed_params(), theirs.sample_perturbed_params()
        for (p, n), (jp, jn) in zip(pairs, jpairs):
            np.testing.assert_array_equal(p, jp)
            np.testing.assert_array_equal(n, jn)
        rewards = np.array([-np.sum((x - target) ** 2) for pair in pairs for x in pair])
        ours.update_ars_params(rewards)
        theirs.update_ars_params(rewards)
        np.testing.assert_array_equal(ours.ars_params, theirs.ars_params)
    if b_top is None:
        np.testing.assert_allclose(ours.ars_params, target, atol=0.5)
    with pytest.raises(ValueError):
        ours.update_ars_params(rewards)  # no perturbations sampled


# ---------------------------------------------------------- evolution pool


def port_pool(jpool, cls=EvolutionPool, sizes=SIZES):
    return cls(seed=0, es_params=EvolutionParameters(**vars(jpool.es_params)),
               tensor_sizes=sizes, parent_tensors=tensors(jpool.parent_tensors),
               noise=tensors(jpool._noise), device="cpu")


def test_evolution_pool_five_iterations_from_jax_noise():
    """Five iterations from JAX's parent and each population's mutations:
    the rewards, then the parent after each Adam step."""
    es = JaxES(population_size=16, mutation_power=0.3, learning_rate=0.05)
    jpool = JaxPool(seed=0, es_params=es, tensor_sizes=SIZES)
    pool = port_pool(jpool)
    for it in range(5):
        for k in SIZES:
            close(pool.population_tensors[k], jpool.population_tensors[k], **PARENT)
        rewards = pool.compute_all_local_rewards(port_reward)
        jrewards = jpool.compute_all_local_rewards(jax_reward)
        close(rewards, jrewards, **REWARD)
        jpool.apply_global_reward(jrewards, it + 1)
        pool.apply_global_reward(rewards, it + 1, noise=tensors(jpool._noise))
        for k in SIZES:
            close(pool.parent_tensors[k], jpool.parent_tensors[k], **PARENT)
    close(pool.opt_state.count, jpool.opt_state[0].count)


def test_evolution_pool_skips_a_step_on_equal_rewards():
    """Rewards whose population std is at most 1e-6 leave the parent and
    the Adam state as they are, in both packages."""
    es = JaxES(population_size=8, mutation_power=0.1, learning_rate=0.05)
    jpool = JaxPool(seed=1, es_params=es, tensor_sizes={"w": [3]})
    pool = port_pool(jpool, sizes={"w": [3]})
    before = pool.parent_tensors["w"].clone()
    rewards = np.full(8, 2.5, np.float32)
    jpool.apply_global_reward(jnp.asarray(rewards), 1)
    pool.apply_global_reward(torch.tensor(rewards), 1, noise=tensors(jpool._noise))
    assert torch.equal(pool.parent_tensors["w"], before)
    assert int(pool.opt_state.count) == int(jpool.opt_state[0].count) == 0


class _Recorder:
    """An update rule that records the gradient and steps nothing."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def test_evolution_pool_std_is_the_population_std():
    """Two rewards 0 and 2 normalize to -1 and +1 (std 1, not sqrt(2)): the
    gradient is -(1 * 1 + (-1) * (-1)) / (2 * 1) = -1."""
    pool = EvolutionPool(0, EvolutionParameters(population_size=2, mutation_power=1.0,
                                                learning_rate=0.1), {"w": [1]},
                         parent_tensors={"w": torch.zeros(1)},
                         noise={"w": torch.tensor([[1.0], [-1.0]])}, device="cpu")
    pool.optimizer = _Recorder()
    pool.apply_global_reward(torch.tensor([2.0, 0.0]), 1)
    close(pool.optimizer.grads["w"], [-1.0], rtol=1e-6)


def test_evolution_pool_state_from_jax_mid_run():
    """JAX's pool after 3 iterations carried across
    (``evolution_pool_state_from_arrays``), then 2 more iterations beside it."""
    es = JaxES(population_size=16, mutation_power=0.2, learning_rate=0.03)
    jpool = JaxPool(seed=2, es_params=es, tensor_sizes=SIZES)
    for it in range(3):
        jpool.apply_global_reward(jpool.compute_all_local_rewards(jax_reward), it + 1)
    pool = EvolutionPool(9, EvolutionParameters(**vars(es)), SIZES, device="cpu")
    pool.load_state(interop.evolution_pool_state_from_arrays(
        host(jpool.parent_tensors), interop.opt_state_from_optax(jpool.opt_state),
        host(jpool._noise)))
    assert int(pool.opt_state.count) == 3
    for k in SIZES:
        np.testing.assert_array_equal(pool.state().noise[k].numpy(), np.asarray(jpool._noise[k]))
    for it in range(3, 5):
        rewards = pool.compute_all_local_rewards(port_reward)
        jpool.apply_global_reward(jpool.compute_all_local_rewards(jax_reward), it + 1)
        pool.apply_global_reward(rewards, it + 1, noise=tensors(jpool._noise))
    for k in SIZES:
        close(pool.parent_tensors[k], jpool.parent_tensors[k], **PARENT)


def test_one_max_pool_against_jax():
    """The demo pool's rewards and 5 iterations, fed JAX's mutations."""
    es = JaxES(population_size=32, mutation_power=0.1, learning_rate=0.05)
    jpool = JaxOneMax(seed=0, es_params=es, tensor_sizes={"data": [9]})
    pool = port_pool(jpool, OneMaxEvolutionPool, {"data": [9]})
    first = None
    for it in range(5):
        rewards, jrewards = pool.compute_rewards(), jpool.compute_rewards()
        close(rewards, jrewards, **REWARD)
        first = float(rewards.mean()) if first is None else first
        jpool.apply_global_reward(jrewards, it + 1)
        pool.apply_global_reward(rewards, it + 1, noise=tensors(jpool._noise))
    close(pool.parent_tensors["data"], jpool.parent_tensors["data"], **PARENT)
    assert float(pool.compute_rewards().mean()) > first


def test_es_worker_locally_against_jax_mesh():
    """The port's local worker (``group=None``) beside JAX's over its
    8-device mesh: the mean rewards and the parents, 3 epochs."""
    es = JaxES(population_size=8, mutation_power=0.3, learning_rate=0.05)
    jpool = JaxPool(seed=0, es_params=es, tensor_sizes={"w": [2]})
    pool = port_pool(jpool, sizes={"w": [2]})
    jworker = JaxEsWorker(jpool, es, jax_make_mesh(8))
    worker = EsWorker(pool, EvolutionParameters(**vars(es)))
    for it in range(3):
        want = jworker.run_epoch(lambda ind: -jnp.sum(ind["w"] ** 2), it)
        got = worker.run_epoch(lambda ind: -torch.sum(ind["w"] ** 2), it,
                               noise=tensors(jpool._noise))
        assert got == pytest.approx(want, rel=1e-6)
        close(pool.parent_tensors["w"], jpool.parent_tensors["w"], **PARENT)


def test_evolution_pool_optimizes_quadratic_on_the_port():
    """JAX's test on the port, from its own generator: 150 iterations reach
    the target within 0.4."""
    es = EvolutionParameters(population_size=64, mutation_power=0.3, learning_rate=0.05)
    pool = EvolutionPool(seed=0, es_params=es, tensor_sizes={"w": [3]}, device="cpu")
    target = torch.tensor([1.0, -2.0, 0.5])
    for it in range(150):
        pool.apply_global_reward(
            pool.compute_all_local_rewards(lambda ind: -torch.sum((ind["w"] - target) ** 2)),
            it + 1)
    close(pool.parent_tensors["w"], target, atol=0.4)


def test_pool_draws_repeat_from_one_seed():
    """Two pools from one seed draw the same parent and mutations (every
    rank of a worker group does)."""
    es = EvolutionParameters(population_size=4)
    a, b = (EvolutionPool(7, es, SIZES, device="cpu") for _ in range(2))
    for k in SIZES:
        assert torch.equal(a.population_tensors[k], b.population_tensors[k])
    a.apply_global_reward(torch.arange(4.0), 1)
    b.apply_global_reward(torch.arange(4.0), 1)
    for k in SIZES:
        assert torch.equal(a.population_tensors[k], b.population_tensors[k])


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        EvolutionPool(0, EvolutionParameters(population_size=2), {"w": [1]})
