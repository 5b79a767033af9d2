"""The leaf utilities on the card: K3 at the Bayes-by-backprop surrogate's
shapes held to its plain version (rtol and atol 1e-5), one launch a
surrogate forward and a candidate ranking, the optimizers' tensors on the
card, ``StepTimer`` synchronising the card and ``trace`` naming a CUDA
kernel.  Skipped without an NVIDIA card; on the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_leaf.py
"""

import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

K3_TOL = dict(rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("rows,dim,hidden", [(2048, 128, 32), (200, 12, 32), (1, 7, 8),
                                             (8192, 128, 32)])
def test_surrogate_forward_is_one_k3_launch(card, rows, dim, hidden):
    from reagent_tpu_torch.lite import MLPBayesianByBackprop
    from reagent_tpu_torch.ops import fused_mlp

    net = MLPBayesianByBackprop(dim, hidden=hidden, seed=1, device=card)
    g = torch.Generator(device=card).manual_seed(2)
    noise = net.draw_noise(g)
    x = (torch.rand(rows, dim, generator=g, device=card) > 0.8).float()
    before = _launches()
    y = net.forward(net.params, x, noise)
    assert _launches() == before + 1 and y.shape == (rows,)
    plain = fused_mlp.fused_mlp_forward_reference(
        x, net.sampled_weights(net.params, noise), net.ACTIVATIONS).reshape(-1)
    torch.testing.assert_close(y, plain, **K3_TOL)
    torch.testing.assert_close(net.train_forward(net.params, x, noise), plain, **K3_TOL)


def test_bbb_optimizer_ranks_candidates_through_k3(card):
    from reagent_tpu_torch.lite import BayesianByBackpropOptimizer

    space = {f"p{i}": list(range(8)) for i in range(16)}
    target = torch.arange(16, device=card) % 8

    def obj(s):
        return sum((s[f"p{i}"] - target[i]).abs() for i in range(16)).float()

    opt = BayesianByBackpropOptimizer(space, obj, batch_size=64, train_steps=10, device=card)
    before = _launches()
    for _ in range(4):
        sampled, cost = opt.optimize_step()
    assert _launches() == before + 3  # the first step has no data to rank by
    assert all(v.device.type == "cuda" and v.dtype == torch.int64 for v in sampled.values())
    assert np.isfinite(cost).all() and opt.last_predictor_loss_mean is not None
    assert all(p.device.type == "cuda" for p in opt.net.params.values())


def test_logit_optimizers_keep_their_logits_on_the_card(card):
    from reagent_tpu_torch.lite import GumbelSoftmaxOptimizer, PolicyGradientOptimizer

    values = torch.tensor([0.0, 1.0, 2.0, 3.0], device=card)
    param = {"x": [0, 1, 2, 3]}
    pg = PolicyGradientOptimizer(param, lambda s: (values[s["x"]] - 2.0) ** 2, batch_size=128,
                                 learning_rate=0.2, device=card)
    gs = GumbelSoftmaxOptimizer(param, lambda s: (s["x"] @ values - 2.0) ** 2, batch_size=128,
                                anneal_rate=0.97, min_temperature=0.2, device=card)
    for _ in range(60):
        pg.optimize_step()
        gs.optimize_step()
    assert pg.logits["x"].device.type == "cuda" and gs.logits["x"].device.type == "cuda"
    assert float((pg.sample(200)["x"] == 2).float().mean()) > 0.8
    assert float((gs.sample(200, temperature=0.2)["x"] == 2).float().mean()) > 0.7


def test_frechet_card_equals_cpu(card):
    from reagent_tpu_torch.samplers import FrechetSort

    g = np.random.default_rng(0)
    scores = torch.tensor(g.uniform(0.1, 2.0, (1024, 20)).astype(np.float32))
    noise = torch.tensor(g.gumbel(size=(1024, 20)).astype(np.float32))
    sampler = FrechetSort(shape=2.0, topk=10)
    cpu = sampler.sample_action(scores, noise=noise)
    got = sampler.sample_action(scores.to(card), noise=noise.to(card))
    assert torch.equal(got.action.cpu(), cpu.action)
    torch.testing.assert_close(got.log_prob.cpu(), cpu.log_prob, rtol=1e-5, atol=1e-6)


def test_step_timer_and_trace_on_the_card(card, tmp_path):
    from reagent_tpu_torch.utils.profiling import StepTimer, annotate, trace

    timer, box = StepTimer(), {}
    x = torch.randn(2048, 2048, device=card)
    for _ in range(4):
        with timer.measure(box):
            box["y"] = x @ x
    # the timer waited for the product each time: no time is left on the queue
    assert torch.cuda.current_stream().query()
    assert len(timer.times) == 4 and timer.summary()["mean_s"] > 0
    with trace(str(tmp_path)):
        with annotate("card_region"):
            torch.relu(x @ x)
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "card_region" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)


def test_entry_points_default_to_the_card(card):
    from reagent_tpu_torch.lite import RandomSearchOptimizer

    opt = RandomSearchOptimizer({"x": [0, 1]}, lambda s: s["x"].float())
    assert opt.device.type == "cuda"
    assert opt.sample(3)["x"].device.type == "cuda"
