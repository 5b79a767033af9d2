"""The model-based slice on the card: K3 at the slice's serving shapes
against its plain version, Seq2Reward's forward and ``get_Q``, CEM's
returns from fed draws, the synthetic-reward nets and the serving wrappers
against the CPU.  Skipped without an NVIDIA card; on the machine with the
card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_model_based.py
"""

import numpy as np
import pytest
import torch

import reagent_tpu_torch.net_builder  # noqa: F401 — registers the builders

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain versions
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("rows,sizes", [(10, [4, 64, 64, 2]), (64, [4, 64, 64, 6]),
                                        (10, [6, 64, 32, 1]), (1000, [6, 64, 32, 1])])
def test_k3_at_the_model_based_shapes(card, rows, sizes):
    """The compress model's, the step model's and the single-step reward's
    MLPs (relu, relu, linear), one launch, against the plain version."""
    from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.training import functional

    net = FullyConnectedNetwork(sizes, ["relu", "relu", "linear"]).to(card)
    params = functional.params_of(net)
    x = torch.randn((rows, sizes[0]), generator=torch.Generator().manual_seed(rows)).to(card)
    before = fused_mlp.fused_mlp_forward.launches
    got = functional.score(net, params, x)
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    want = fused_mlp.fused_mlp_forward_reference(x, functional.k3_weights(params, "", 3),
                                                 net.activations)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_seq2reward_and_get_q_card_against_cpu(card):
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.models.seq2reward_model import (
        Seq2RewardNetwork,
        gen_permutations,
        get_Q,
    )

    net = Seq2RewardNetwork(4, 2, 64, 2)
    g = torch.Generator().manual_seed(1)
    state = torch.randn((6, 32, 4), generator=g)
    action = torch.nn.functional.one_hot(torch.randint(0, 2, (6, 32), generator=g), 2).float()
    valid = torch.randint(1, 7, (32,), generator=g)
    with torch.no_grad():
        want = net(rlt.FeatureData(state), rlt.FeatureData(action), valid).acc_reward
        q_want = get_Q(net, None, state[0], gen_permutations(6, 2, "cpu"))
        net.to(card)
        got = net(rlt.FeatureData(state.to(card)), rlt.FeatureData(action.to(card)),
                  valid.to(card)).acc_reward
        q_got = get_Q(net, None, state[0].to(card), gen_permutations(6, 2, card))
    torch.testing.assert_close(got.cpu(), want, **TOL)
    torch.testing.assert_close(q_got.cpu(), q_want, **TOL)


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "expected"])
def test_cem_returns_card_against_cpu(card, sampled):
    """Two members at the jobs' width (100 hidden x 2), the same draws on
    both devices."""
    from reagent_tpu_torch.models.cem_planner import CEMPlannerNetwork, RolloutDraws
    from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
    from reagent_tpu_torch.training import functional

    net = MemoryNetwork(4, 2, 100, 2, 2, predict_delta=not sampled)
    params = []
    for m in range(2):
        net.reset_parameters(torch.Generator().manual_seed(m))
        params.append(functional.params_of(net))
    kw = dict(cem_num_iterations=1, cem_population_size=100, ensemble_population_size=1,
              num_elites=10, plan_horizon_length=10, state_dim=4, action_dim=2,
              discrete_action=True, terminal_effective=True, gamma=0.99,
              sample_next_state=sampled, sample_not_terminal=sampled)
    planners = {d: CEMPlannerNetwork(net, params, device=d, **kw) for d in ("cpu", card)}
    g = torch.Generator().manual_seed(5)
    draws = planners["cpu"].draw_rollout(100, g)
    sol = torch.nn.functional.one_hot(torch.randint(0, 2, (100, 10), generator=g), 2).float()
    init = torch.randn(4, generator=g) * 0.05
    acc = {d: p.acc_rewards_of_all_solutions(init.to(d), sol.to(d), RolloutDraws(
        **{k: None if v is None else v.to(d) for k, v in vars(draws).items()}))
        for d, p in planners.items()}
    torch.testing.assert_close(acc[card].cpu(), acc["cpu"], **TOL)


@pytest.mark.parametrize("builder", [
    {"SingleStepSyntheticReward": {}}, {"NGramSyntheticReward": {}},
    {"NGramConvNetSyntheticReward": {}}, {"SequenceSyntheticReward": {}},
    {"TransformerSyntheticReward": {}},
    {"SparseArchSyntheticReward": {"embedding_configs": [["a", 500, 16], ["b", 300, 16]]}}],
    ids=lambda b: next(iter(b)))
def test_synthetic_reward_nets_card_against_cpu(card, builder):
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.registry import SYNTHETIC_REWARD_NET_BUILDERS

    net = SYNTHETIC_REWARD_NET_BUILDERS.build(builder).build_synthetic_reward_network(
        None, None, state_dim=4, action_dim=2)
    g = torch.Generator().manual_seed(3)
    T, B = 8, 32
    ids = {n: rlt.IdListFeature(ids=torch.randint(0, 10_000, (T, B, 4), generator=g),
                                mask=torch.rand((T, B, 4), generator=g) > 0.3)
           for n in ("a", "b")}
    batch = rlt.MemoryNetworkInput(
        state=rlt.FeatureData(torch.randn((T, B, 4), generator=g), id_list_features=ids),
        action=rlt.FeatureData(torch.randn((T, B, 2), generator=g)), next_state=None,
        reward=torch.zeros((T, B)), not_terminal=None, time_diff=None, step=None,
        valid_step=torch.randint(1, T + 1, (B, 1), generator=g))
    with torch.no_grad():
        want = net(batch)
        got = net.to(card)(batch.to(card))
    torch.testing.assert_close(got.output.cpu(), want.output, **TOL)
    torch.testing.assert_close(got.predicted_reward.cpu(), want.predicted_reward, **TOL)


def test_compress_wrapper_and_reward_wrapper_through_k3(card):
    """The compress model's Q and a single-step synthetic reward window on
    the card, one K3 launch each, against the CPU."""
    from reagent_tpu_torch.core.registry import SYNTHETIC_REWARD_NET_BUILDERS
    from reagent_tpu_torch.gym.model_based import identity_preprocessor
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.prediction.synthetic_reward import SyntheticRewardPredictorWrapper
    from reagent_tpu_torch.prediction.world_model_wrappers import CompressModelWithPreprocessor

    dqn = FullyConnectedDQN(4, 2, [64, 64], ["relu", "relu"])
    reward_net = SYNTHETIC_REWARD_NET_BUILDERS.build(
        {"SingleStepSyntheticReward": {}}).build_synthetic_reward_network(
        None, None, state_dim=4, action_dim=2)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((10, 4), generator=g)
    window = torch.randn((10, 6), generator=g)
    out = {}
    for d in ("cpu", card):
        q = CompressModelWithPreprocessor(dqn.to(d), None, identity_preprocessor(4, d))(
            x.to(d), torch.ones_like(x).to(d))
        r = SyntheticRewardPredictorWrapper(10, identity_preprocessor(4, d),
                                            identity_preprocessor(2, d), reward_net.to(d),
                                            None)((window.to(d), torch.ones_like(window).to(d)))
        out[d] = (q.cpu(), r.cpu())
    before = fused_mlp.fused_mlp_forward.launches
    CompressModelWithPreprocessor(dqn.to(card), None, identity_preprocessor(4, card))(
        x.to(card), torch.ones_like(x).to(card))
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    for got, want in zip(out[card], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(out[card][1].numpy()).all()
