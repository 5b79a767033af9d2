"""The ranking slice on the card: K3 at the slate-Q act and evaluation
shapes against its plain version, the stable top-k on tied scores, the
slate-Q scorer and trainer, and Seq2Slate's greedy rank and IPS step
against the CPU.  Skipped without an NVIDIA card; on the machine with the
card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_ranking.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain versions
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [10, 1280])
def test_k3_at_the_slate_q_shapes(card, rows):
    """The critic [41 -> 64 -> 64 -> 1] leaky_relu on one act step's 10
    candidate rows and an evaluation batch's, one launch, against the plain
    version on the same card."""
    from reagent_tpu_torch.gym.slate_q_recsim import make_q_net
    from reagent_tpu_torch.ops import fused_mlp

    net = make_q_net().to(card)
    weights = fused_mlp.mlp_weight_list(net)
    x = torch.randn((rows, 41), generator=torch.Generator().manual_seed(rows)).to(card)
    before = fused_mlp.fused_mlp_forward.launches
    got = fused_mlp.fused_mlp_forward(x, weights, net.net.activations)
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    want = fused_mlp.fused_mlp_forward_reference(x, weights, net.net.activations)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_stable_top_k_keeps_jax_order_on_ties(card):
    from reagent_tpu_torch.gym.policies.samplers import TopKSampler
    from reagent_tpu_torch.training.slate_q_trainer import stable_top_k

    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0] * 5, [5.0, 4.0, 5.0, 4.0, 1.0]],
                          device=card)
    want = [[1, 2, 4], [0, 1, 2], [0, 2, 1]]
    assert stable_top_k(scores, 3).tolist() == want
    assert TopKSampler(3).sample_action(scores).action.tolist() == want


def test_slate_q_scorer_and_trainer_card_against_cpu(card):
    """The scorer through K3 (one launch) and 3 trainer steps from one state,
    card against CPU."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.gym import slate_q_recsim as sq
    from reagent_tpu_torch.ops import fused_mlp

    rng = np.random.default_rng(0)
    trainers = {d: sq.make_trainer("maxq_topk", True, {}, d) for d in ("cpu", "cuda")}
    first = trainers["cpu"].init(torch.Generator().manual_seed(0))
    states = {"cpu": first, "cuda": trainers["cuda"].state_from_networks()}  # fresh moments
    states["cuda"].q_params = {k: v.to(card) for k, v in first.q_params.items()}
    states["cuda"].q_target_params = {k: v.to(card) for k, v in first.q_target_params.items()}
    user = torch.tensor(rng.normal(size=(4, 20)).astype(np.float32))
    docs = torch.tensor(rng.normal(size=(4, 10, 21)).astype(np.float32))
    value = torch.tensor(rng.normal(size=(4, 10)).astype(np.float32))
    scores = {}
    for d in ("cpu", "cuda"):
        st = rlt.FeatureData(user.to(d), candidate_docs=rlt.DocList(docs.to(d), value=value.to(d)))
        before = fused_mlp.fused_mlp_forward.launches
        scores[d] = sq.SlateQCollector(
            sq.RecSimInterestEvolution(device=d), trainers[d].q_network).score(
            states[d].q_params, st).cpu()
        assert fused_mlp.fused_mlp_forward.launches == before + (d == "cuda")
    torch.testing.assert_close(scores["cuda"], scores["cpu"], rtol=1e-5, atol=1e-6)
    env = sq.RecSimInterestEvolution(device="cpu")
    recs = sq.SlateQCollector(env, trainers["cpu"].q_network).collect(
        first.q_params, 1.0, 2, torch.Generator().manual_seed(1))
    batch = sq.batchify(env, recs)
    for i in range(3):
        idx = torch.arange(i * 16, i * 16 + 64) % batch.reward.shape[0]
        m = {}
        for d in ("cpu", "cuda"):
            states[d], m[d] = trainers[d].train_step(states[d], sq.subsample(batch, idx).to(d))
        torch.testing.assert_close(m["cuda"]["td_loss"].cpu(), m["cpu"]["td_loss"],
                                   rtol=1e-4, atol=1e-6)
    for k, v in states["cpu"].q_params.items():
        torch.testing.assert_close(states["cuda"].q_params[k].cpu(), v, rtol=5e-4, atol=5e-5)


def test_seq2slate_rank_and_step_card_against_cpu(card):
    """Greedy slates equal and per-sequence log-probabilities within 1e-5
    at a small width, and one IPS step's metrics, card against CPU."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.models.seq2slate import Seq2SlateOutputArch, Seq2SlateTransformerModel
    from reagent_tpu_torch.training.ranking import Seq2SlateTrainer

    def model():
        return Seq2SlateTransformerModel(8, 8, 2, 2, 32, 64, 10, 10,
                                         Seq2SlateOutputArch.AUTOREGRESSIVE)

    rng = np.random.default_rng(1)
    B, S = 16, 10
    state = torch.tensor(rng.normal(size=(B, 8)).astype(np.float32))
    src = torch.tensor(rng.normal(size=(B, S, 8)).astype(np.float32))
    out = {}
    trainers = {d: Seq2SlateTrainer(model(), policy_optimizer={"Adam": {"lr": 1e-3}}, device=d)
                for d in ("cpu", "cuda")}
    trainers["cpu"].init(torch.Generator().manual_seed(0))
    for d, tr in trainers.items():
        tr.seq2slate_net.load_state_dict(trainers["cpu"].seq2slate_net.state_dict())
        out[d] = tr.seq2slate_net("rank", state.to(d), src.to(d), greedy=True)
    assert torch.equal(out["cuda"].ranked_tgt_out_idx.cpu(), out["cpu"].ranked_tgt_out_idx)
    idx = out["cpu"].ranked_tgt_out_idx
    cand = torch.cat([torch.zeros((B, 2, 8)), src], dim=1)
    tgt_in = torch.cat([torch.ones((B, 1), dtype=torch.int64), idx[:, :-1]], dim=1)
    batch = rlt.PreprocessedRankingInput(
        state=rlt.FeatureData(state), src_seq=rlt.FeatureData(src),
        tgt_in_seq=rlt.FeatureData(cand[torch.arange(B)[:, None], tgt_in]),
        tgt_in_idx=tgt_in, tgt_out_idx=idx, tgt_out_probs=torch.full((B, 1), 1e-3),
        slate_reward=torch.tensor(rng.uniform(size=(B, 1)).astype(np.float32)))
    m = {}
    for d, tr in trainers.items():
        _, m[d] = tr.train_step(tr.state_from_networks(), batch.to(d))
    for k in m["cpu"]:
        torch.testing.assert_close(m["cuda"][k].cpu(), m["cpu"][k], rtol=1e-4, atol=1e-6)
