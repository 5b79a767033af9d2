"""The bandit slice on the card: K3 at the deep-represent score shapes
against its plain version, and LinUCB, the deep-represent score, the MAB
loop and the replay evaluator against the CPU from one state and the same
draws.  Skipped without an NVIDIA card; on the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_bandits.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SUM = dict(rtol=1e-5, atol=1e-5)
PINV_TOL = 2e-3  # |card - CPU| over the CPU's largest entry (cuSOLVER against LAPACK)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain versions
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [128, 1024])
def test_k3_at_the_deep_represent_score(card, rows):
    """The trunk 6->16->4 (relu, relu), one launch, against the plain version."""
    from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.training import functional

    net = FullyConnectedNetwork([6, 16, 4], ["relu", "relu"]).to(card)
    params = functional.params_of(net)
    x = torch.randn(rows, 6, generator=torch.Generator().manual_seed(rows)).to(card)
    before = fused_mlp.fused_mlp_forward.launches
    y = functional.score(net, params, x)
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    torch.testing.assert_close(y, fused_mlp.fused_mlp_forward_reference(
        x, functional.k3_weights(params, "", 2), ["relu", "relu"]), rtol=1e-5, atol=1e-5)


def test_linucb_at_500_features_card_against_cpu(card):
    from reagent_tpu_torch.models import linear_regression as lr

    gen = torch.Generator().manual_seed(0)
    D = 500
    model = lr.LinearRegressionUCB(input_dim=D)
    states = {dev: model.init(dev) for dev in (card, "cpu")}
    for _ in range(25):
        x, y = torch.randn(4, D, generator=gen), torch.randn(4, generator=gen)
        for dev in states:
            states[dev] = model.update(states[dev], x.to(dev), y.to(dev))
    torch.testing.assert_close(states[card].avg_A.cpu(), states["cpu"].avg_A, **SUM)
    solved = {dev: model.calculate_coefs(states["cpu"].to(dev)) for dev in states}
    for k in ("inv_avg_A", "coefs"):
        got, want = getattr(solved[card], k).cpu(), getattr(solved["cpu"], k)
        assert (got - want).abs().max() <= PINV_TOL * want.abs().max()


def test_deep_represent_score_card_against_cpu(card):
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.models.deep_represent_linucb import DeepRepresentLinearRegressionUCB
    from reagent_tpu_torch.training.cb import DeepRepresentLinUCBTrainer

    trainers, states = {}, {}
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randn(32, 4, 6, generator=gen), torch.randint(0, 4, (32, 1), generator=gen))
               for _ in range(5)]
    for dev in (card, "cpu"):
        trainers[dev] = DeepRepresentLinUCBTrainer(
            DeepRepresentLinearRegressionUCB(input_dim=6, sizes=[16, 4], activations=["relu"] * 2),
            lr=3e-3, device=dev)
        states[dev] = trainers[dev].init(torch.Generator().manual_seed(2))
        for feats, action in batches:
            f, a = feats.to(dev), action.to(dev)
            states[dev], _ = trainers[dev].train_step(states[dev], rlt.CBInput(
                context_arm_features=f, action=a, reward=f.sum(-1).abs().gather(1, a)))
    evals = torch.randn(256, 4, 6, generator=gen)
    got = trainers[card].score(states[card], rlt.CBInput(context_arm_features=evals.to(card)))
    want = trainers["cpu"].score(states["cpu"], rlt.CBInput(context_arm_features=evals))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def test_mab_loop_card_against_cpu(card):
    """UCB1 for 400 steps on the same gumbels and uniforms: the same regrets."""
    from reagent_tpu_torch.mab import UCB1
    from reagent_tpu_torch.mab import simulation as sim

    gen = torch.Generator().manual_seed(3)
    u = torch.rand(400, 3, generator=gen)
    draws = {"gumbels": -torch.log(-torch.log(u.clamp(min=1e-30))),
             "uniforms": torch.rand(400, generator=gen)}
    regrets = {dev: sim.single_evaluation_bandit_algo(
        sim.BernoulliMAB(400, [0.2, 0.8, 0.5], device=dev), UCB1(n_arms=3),
        draws={k: v.to(dev) for k, v in draws.items()}) for dev in (card, "cpu")}
    np.testing.assert_allclose(regrets[card], regrets["cpu"], rtol=1e-12)


def test_policy_evaluator_card_against_cpu(card):
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.evaluation.cb import PolicyEvaluator

    pe = PolicyEvaluator()
    states = {dev: pe.init_state(dev) for dev in (card, "cpu")}
    gen = torch.Generator().manual_seed(4)
    for _ in range(20):
        batch = rlt.CBInput(context_arm_features=torch.randn(8, 3, 2, generator=gen),
                            action=torch.randint(0, 3, (8, 1), generator=gen),
                            reward=torch.rand(8, 1, generator=gen))
        model = torch.randint(0, 3, (8, 1), generator=gen)
        for dev in states:
            states[dev], _ = pe.ingest_batch(states[dev], batch.to(dev), model.to(dev))
    for dev in states:
        states[dev] = pe.aggregate_across_instances(states[dev])
    assert pe.metrics_dict(states[card]) == pytest.approx(pe.metrics_dict(states["cpu"]),
                                                          rel=1e-5)


def test_entry_points_default_to_the_card(card):
    """Each entry point called with its default device makes its tensors on
    the card."""
    from reagent_tpu_torch import mab
    from reagent_tpu_torch.evaluation.cb import PolicyEvaluator
    from reagent_tpu_torch.evaluation.cb import synthetic_contextual_bandit_data as syn
    from reagent_tpu_torch.mab import simulation as sim
    from reagent_tpu_torch.models import linear_regression as lr
    from reagent_tpu_torch.models.deep_represent_linucb import DeepRepresentLinearRegressionUCB
    from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
    from reagent_tpu_torch.training import cb

    deep = DeepRepresentLinearRegressionUCB(input_dim=3, sizes=[4], activations=["relu"])
    made = {
        "run_dynamic_bandit_env": syn.run_dynamic_bandit_env(2, 1, 2, 3, 1)[0].init_state().avg_A,
        "DynamicBanditEnv": syn.DynamicBanditEnv(2, 1, 2, 3).mf,
        "BernoulliMAB": sim.BernoulliMAB(5, [0.2, 0.8]).expected_rewards,
        "MABAlgo.init": mab.NormalGammaThompson(n_arms=2).init().extra["mus"],
        "gumbel": mab.mab_algorithm.gumbel((2,)),
        "DisjointLinearRegressionUCB.init": lr.DisjointLinearRegressionUCB(2, 3).init().A,
        "LinUCBTrainer.init": cb.LinUCBTrainer(lr.LinearRegressionUCB(3)).init().avg_b,
        "MABTrainer.init": cb.MABTrainer(mab.UCB1(n_arms=2)).init().total_n_obs_per_arm,
        "SupervisedTrainer": cb.SupervisedTrainer(
            FullyConnectedNetwork([3, 1], ["linear"])).init().step,
        "DeepRepresentLinUCBTrainer": cb.DeepRepresentLinUCBTrainer(deep).init(
            torch.Generator().manual_seed(0)).linucb.avg_A,
        "PolicyEvaluator.init_state": PolicyEvaluator().init_state().frac_accepted,
    }
    assert {k: v.device.type for k, v in made.items()} == {k: "cuda" for k in made}
