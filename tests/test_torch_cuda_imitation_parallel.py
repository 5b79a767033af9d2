"""The imitation, counterfactual-evaluation, gradient-free and parallel slice
on the card: K3 on the imitator gate and on each Bayes-by-backprop sample,
held to its plain version (1e-5); the trainers' steps and the ES pool card
against CPU; the entry points' default device, the card (their refusal
where there is no card is ``test_entry_points_default_to_the_card`` in
``test_torch_imitation_cfeval.py`` and ``test_torch_gradient_free.py``); the
parallel package at world size 1 on NCCL.  Skipped without an NVIDIA card;
on the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_imitation_parallel.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

K3_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(loss=dict(rtol=1e-4, atol=1e-6), param=dict(rtol=5e-4, atol=5e-5))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain versions
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    from reagent_tpu_torch.ops import fused_mlp

    return fused_mlp.fused_mlp_forward.launches


def _dqn(card, sizes=(64, 32), gen=0):
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN

    return FullyConnectedDQN(16, 5, list(sizes), ["leaky_relu"] * len(sizes),
                             generator=torch.Generator().manual_seed(gen)).to(card)


@pytest.mark.parametrize("rows", [1, 300, 4096])
def test_imitator_gate_is_one_k3_launch(card, rows):
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.training import functional
    from reagent_tpu_torch.training.imitator_training import get_valid_actions_from_imitator

    net = _dqn(card)
    params = functional.params_of(net)
    x = torch.randn(rows, 16, generator=torch.Generator().manual_seed(1)).to(card)
    before = _launches()
    mask = get_valid_actions_from_imitator((net, params), x, 0.3)
    assert _launches() == before + 1
    logits = fused_mlp.fused_mlp_forward_reference(
        x, functional.k3_weights(params, "net", 3), net.activations)
    torch.testing.assert_close(functional.score(net, params, x), logits, **K3_TOL)
    probs = torch.softmax(logits, 1)
    filt = probs / probs.amax(1, keepdim=True)
    away = (filt - 0.3).abs() > 1e-4
    assert torch.equal(mask[away], (filt >= 0.3).float()[away])


def test_bayes_by_backprop_samples_are_k3_launches(card):
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.training.cfeval import BayesByBackpropTrainer
    from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import (
        ACTIVATIONS,
        BayesianMLP,
    )

    trainer = BayesByBackpropTrainer(BayesianMLP(24, 64, 1), device=card)
    state = trainer.init(torch.Generator().manual_seed(0))
    x = torch.randn(1000, 24, device=card)
    eps = [e.to(card) for e in trainer.net.draw_noise(torch.Generator().manual_seed(1), 8)]
    before = _launches()
    mean, std = trainer.predict_with_uncertainty(state, x, 8, eps)
    assert _launches() == before + 8
    preds = torch.stack([fused_mlp.fused_mlp_forward_reference(
        x, trainer.sampled_weights(state.params, eps, s), ACTIVATIONS) for s in range(8)])
    torch.testing.assert_close(mean, preds.mean(0), **K3_TOL)
    torch.testing.assert_close(std, preds.std(0, correction=0), **K3_TOL)
    before = _launches()
    trainer.predict_with_uncertainty(state, x, 4)  # drawn from the card's generator
    assert _launches() == before + 4


def _batch(label, seed, device, D=16, A=5, B=512):
    from reagent_tpu_torch.core import types as rlt

    rng = np.random.default_rng(seed)
    actions = rng.integers(0, A, B)
    state = rlt.FeatureData(float_features=torch.tensor(rng.normal(size=(B, D)),
                                                        dtype=torch.float32))
    action = torch.eye(A)[torch.tensor(actions)]
    if label == "bc":
        return rlt.BehavioralCloningModelInput(state=state, action=action).to(device)
    return rlt.BanditRewardModelInput(
        state=state, action=action, reward=torch.tensor(actions / A, dtype=torch.float32),
        action_prob=torch.tensor(rng.uniform(0.1, 1, (B, 1)), dtype=torch.float32)).to(device)


@pytest.mark.parametrize("label", ["bc", "bandit", "bbb"])
def test_trainer_steps_card_against_cpu(card, label):
    from reagent_tpu_torch.training.behavioral_cloning_trainer import BehavioralCloningTrainer
    from reagent_tpu_torch.training.cfeval import BanditRewardNetTrainer, BayesByBackpropTrainer
    from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import BayesianMLP
    from reagent_tpu_torch.utils.checkpointing import flatten_state

    def make(device):
        if label == "bc":
            return BehavioralCloningTrainer(_dqn("cpu"), device=device)
        if label == "bandit":
            return BanditRewardNetTrainer(_dqn("cpu"), weighted_by_inverse_propensity=True,
                                          device=device)
        return BayesByBackpropTrainer(BayesianMLP(21, 32, 1), device=device)

    trainers = {d: make(d) for d in ("cpu", card)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(3))
    states = {"cpu": first, card: _to(first, card)}
    for step in range(3):
        eps = (trainers["cpu"].net.draw_noise(torch.Generator().manual_seed(step))
               if label == "bbb" else None)
        metrics = {}
        for d, tr in trainers.items():
            b = _batch("bc" if label == "bc" else "bandit", step, d)
            args = () if eps is None else ([e.to(d) for e in eps],)
            states[d], m = tr.train_step(states[d], b, *args)
            metrics[d] = m
        for k, v in metrics["cpu"].items():
            torch.testing.assert_close(metrics[card][k].cpu(), v, **STEP_TOL["loss"])
    got, want = flatten_state(states[card]), flatten_state(states["cpu"])
    for k, v in want.items():
        torch.testing.assert_close(got[k].cpu(), v, **STEP_TOL["param"])


def _to(state, device):
    from reagent_tpu_torch.parallel.data_parallel import map_leaves

    return map_leaves(lambda x, _: x.to(device).clone(), state)


def test_evolution_pool_card_against_cpu_and_its_draws(card):
    from reagent_tpu_torch.core.parameters import EvolutionParameters
    from reagent_tpu_torch.training.gradient_free import OneMaxEvolutionPool

    es = EvolutionParameters(population_size=64)
    parent = {"data": torch.randn(101, generator=torch.Generator().manual_seed(0))}
    first = OneMaxEvolutionPool(1, es, {"data": [101]}, device="cpu").state().noise
    pools = {d: OneMaxEvolutionPool(0, es, {"data": [101]}, parent_tensors=parent, noise=first,
                                    device=d) for d in ("cpu", card)}
    for it in range(5):
        rewards = {d: p.compute_rewards() for d, p in pools.items()}
        torch.testing.assert_close(rewards[card].cpu(), rewards["cpu"], rtol=1e-5, atol=1e-6)
        noise = pools["cpu"].draw_noise()
        for d, p in pools.items():
            p.apply_global_reward(rewards[d], it + 1, noise=noise)
    torch.testing.assert_close(pools[card].parent_tensors["data"].cpu(),
                               pools["cpu"].parent_tensors["data"], **STEP_TOL["param"])
    a, b = (OneMaxEvolutionPool(5, es, {"data": [101]}, device=card) for _ in range(2))
    assert a.population_tensors["data"].is_cuda
    assert torch.equal(a.population_tensors["data"], b.population_tensors["data"])


def test_entry_points_default_to_the_card(card):
    from reagent_tpu_torch.core.parameters import EvolutionParameters
    from reagent_tpu_torch.training.behavioral_cloning_trainer import BehavioralCloningTrainer
    from reagent_tpu_torch.training.cfeval import BanditRewardNetTrainer, BayesByBackpropTrainer
    from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import BayesianMLP
    from reagent_tpu_torch.training.gradient_free import EvolutionPool

    assert BehavioralCloningTrainer(_dqn("cpu")).device.type == "cuda"
    assert BanditRewardNetTrainer(_dqn("cpu")).device.type == "cuda"
    assert BayesByBackpropTrainer(BayesianMLP(2, 4, 1)).device.type == "cuda"
    pool = EvolutionPool(0, EvolutionParameters(population_size=2), {"w": [1]})
    assert pool.parent_tensors["w"].is_cuda


def test_parallel_steps_at_world_size_one_on_nccl(card, tmp_path):
    """A one-rank NCCL group: the DP step of DQNTrainer and the MP step of a
    sparse DQN equal their plain steps bit for bit; the mesh's device is
    the card."""
    import torch.distributed as dist

    from reagent_tpu_torch import parallel
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.models.embedding_bag import SparseDQN
    from reagent_tpu_torch.training import DQNTrainer
    from reagent_tpu_torch.utils.checkpointing import flatten_state

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.sparse_dqn = SparseDQN(4, 2, (("page", 64, 8),), [32])

        def reset_parameters(self, generator):
            self.sparse_dqn.reset_parameters(generator)

        def forward(self, obs, training=False):
            ids = obs[:, 4:].long()
            return self.sparse_dqn(rlt.FeatureData(float_features=obs[:, :4], id_list_features={
                "page": rlt.IdListFeature(ids=ids, mask=torch.ones_like(ids, dtype=torch.bool))}))

    def batch(obs_dim, seed):
        g = torch.Generator().manual_seed(seed)
        obs = torch.randn(256, obs_dim, generator=g)
        if obs_dim == 9:
            obs[:, 4:] = torch.randint(0, 64, (256, 5), generator=g).float()
        act = torch.eye(2)[torch.randint(0, 2, (256,), generator=g)]
        return rlt.DiscreteDqnInput(
            state=rlt.FeatureData(obs), next_state=rlt.FeatureData(obs.flip(0)), action=act,
            next_action=act, reward=torch.randn(256, 1, generator=g), time_diff=None, step=None,
            not_terminal=torch.ones(256, 1), possible_actions_mask=torch.ones(256, 2),
            possible_next_actions_mask=torch.ones(256, 2)).to(card)

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh()
        assert mesh.device.type == "cuda" and mesh.shape == (1,)
        cases = ((FullyConnectedDQN(16, 2, [32], ["relu"]), 16, mesh,
                  parallel.make_data_parallel_train_step, parallel.replicate),
                 (Net(), 9, parallel.make_2d_mesh(), parallel.make_model_parallel_train_step,
                  parallel.shard_state))
        for net, obs_dim, m, make_step, place in cases:
            trainer = DQNTrainer(net, rl=RLParameters(gamma=0.9), device=card)
            first = trainer.init(torch.Generator().manual_seed(0))
            plain, par = _to(first, card), place(first, m)
            step = make_step(trainer, m)
            for i in range(3):
                b = batch(obs_dim, i)
                plain, _ = trainer.train_step(plain, b)
                par, _ = step(par, parallel.shard_batch(b, m))
            got, want = flatten_state(par), flatten_state(plain)
            for k, v in want.items():
                assert torch.equal(got[k], v), k
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("job", ["bc", "bandit", "bbb", "es"])
def test_jax_learning_bars_on_the_card(card, job):
    """The JAX package's learning tests (tests/test_misc_components.py) on
    the card: behavioural cloning's accuracy over 0.9 after 100 steps, the
    bandit reward net's loss to a fifth in 150, Bayes by backprop's nll
    falling in 100 (then 32 predictions, K3 once each), the evolution pool
    within 0.4 of JAX's quadratic in 150 iterations."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import EvolutionParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.behavioral_cloning_trainer import BehavioralCloningTrainer
    from reagent_tpu_torch.training.cfeval import BanditRewardNetTrainer, BayesByBackpropTrainer
    from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import BayesianMLP
    from reagent_tpu_torch.training.gradient_free import EvolutionPool

    gen, opt = torch.Generator().manual_seed(0), {"Adam": {"lr": 1e-2}}
    rng = np.random.default_rng(0)
    actions = rng.integers(0, 2, 64)
    bandit = rlt.BanditRewardModelInput(
        state=rlt.FeatureData(float_features=torch.tensor(rng.normal(size=(64, 4)),
                                                          dtype=torch.float32)),
        action=torch.eye(2)[torch.tensor(actions)],
        reward=torch.tensor(actions, dtype=torch.float32),
        action_prob=torch.full((64, 1), 0.5)).to(card)
    if job == "bc":
        trainer = BehavioralCloningTrainer(FullyConnectedDQN(4, 2, [16], ["relu"]), opt,
                                           device=card)
        state = trainer.init(gen)
        for i in range(100):
            obs = np.random.default_rng(i % 5).normal(size=(32, 4)).astype(np.float32)
            state, m = trainer.train_step(state, rlt.BehavioralCloningModelInput(
                state=rlt.FeatureData(float_features=torch.tensor(obs)),
                action=torch.eye(2)[torch.tensor((obs[:, 0] > 0).astype(int))]).to(card))
        assert float(m["accuracy"]) > 0.9
    elif job == "bandit":
        trainer = BanditRewardNetTrainer(FullyConnectedDQN(4, 2, [16], ["relu"]), opt,
                                         device=card)
        state, losses = trainer.init(gen), []
        for _ in range(150):
            state, m = trainer.train_step(state, bandit)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] * 0.2
    elif job == "bbb":
        trainer = BayesByBackpropTrainer(BayesianMLP(6, 16, 1), opt, device=card)
        state, nll = trainer.init(gen), []
        for _ in range(100):
            state, m = trainer.train_step(state, bandit)
            nll.append(float(m["nll"]))
        assert nll[-1] < nll[0]
        before = _launches()
        mean, std = trainer.predict_with_uncertainty(state, torch.zeros(3, 6, device=card))
        assert _launches() == before + 32
        assert mean.shape == (3, 1) and bool((std >= 0).all())
    else:
        es = EvolutionParameters(population_size=64, mutation_power=0.3, learning_rate=0.05)
        pool = EvolutionPool(0, es, {"w": [3]}, device=card)
        target = torch.tensor([1.0, -2.0, 0.5], device=card)
        for it in range(150):
            pool.apply_global_reward(pool.compute_all_local_rewards(
                lambda ind: -torch.sum((ind["w"] - target) ** 2)), it + 1)
        torch.testing.assert_close(pool.parent_tensors["w"], target, rtol=0, atol=0.4)
