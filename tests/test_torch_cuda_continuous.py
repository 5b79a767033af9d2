"""The online continuous-control slice on the card: the prioritized
buffer's stratified draw, the act step's K3 launch
(``functional.actor_act``) and ``FullyConnectedNetwork``'s options, each
against the CPU.  Skipped without an NVIDIA card; on the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_continuous.py

The prioritized draw is a float32 cumsum of ``priority * is_valid`` and a
``searchsorted`` of each segment's query.  The card's cumsum adds in
another order than the CPU's, so where a query lands within an ulp of a
prefix sum the two may pick neighbouring indices.  So the card is held to
the CPU index for index on priorities whose prefix sums are exact in
float32 (small integers), and by the sampled distribution on arbitrary
priorities.
"""

import copy

import numpy as np
import pytest
import torch

from reagent_tpu_torch.models import actor
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
from reagent_tpu_torch.ops import fused_mlp
from reagent_tpu_torch.replay import PrioritizedReplayBuffer
from reagent_tpu_torch.training import functional

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain versions
    return torch.device("cuda")


def _filled(device, priorities):
    rb = PrioritizedReplayBuffer(replay_capacity=len(priorities), device=device)
    state = rb.init(observation=torch.zeros(3), action=torch.zeros(1), reward=torch.tensor(0.0),
                    terminal=torch.tensor(False))
    for t in range(len(priorities)):
        state = rb.add(state, observation=torch.full((3,), float(t)), action=torch.zeros(1),
                       reward=torch.tensor(float(t)), terminal=torch.tensor(t % 50 == 49))
    n = len(priorities)
    return rb, rb.set_priority(state, torch.arange(n), torch.tensor(priorities))


def test_prioritized_draw_is_the_cpus_on_exact_prefix_sums(card):
    prios = np.random.default_rng(0).integers(1, 8, 1000).astype(np.float32)
    u = torch.rand(512, generator=torch.Generator().manual_seed(1))
    got, want = {}, {}
    for dev, out in ((card, got), ("cpu", want)):
        rb, state = _filled(dev, prios)
        batch = rb.sample(state, batch_size=512, u=u.to(dev))
        out.update({k: v.cpu() for k, v in batch.items()})
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_prioritized_draw_follows_arbitrary_priorities_on_the_card(card):
    prios = np.random.default_rng(2).uniform(0.01, 5.0, 1000).astype(np.float32)
    rb, state = _filled(card, prios)
    g = torch.Generator(device=card).manual_seed(3)
    counts = torch.zeros(1000, device=card)
    for _ in range(400):
        idx = rb.sample_index_batch_prioritized(state, g, 1000).long()
        counts += torch.bincount(idx, minlength=1000)
    p = rb.sampling_probabilities(state, torch.arange(1000, device=card))
    # 400,000 draws: each index's share within 4 standard errors of its probability
    share = counts / counts.sum()
    assert torch.all((share - p).abs() <= 4 * torch.sqrt(p * (1 - p) / counts.sum()) + 1e-6)


@pytest.mark.parametrize("kind", ["gaussian", "gaussian_layer_norm", "td3"])
def test_act_step_launches_k3_once_and_matches_the_cpu(card, kind):
    g = torch.Generator().manual_seed(4)
    if kind == "td3":
        net = actor.FullyConnectedActor(3, 1, [64, 64], ["relu", "relu"],
                                        exploration_variance=0.2, generator=g)
    else:
        net = actor.GaussianFullyConnectedActor(3, 1, [64, 64], ["relu", "relu"],
                                                use_layer_norm=kind.endswith("norm"), generator=g)
    params = functional.params_of(net)
    obs = torch.randn(1, 3, generator=g)
    noise = torch.randn(1, 1, generator=g)
    want = functional.actor_act(net, params, obs, noise)
    card_net = net.to(card)
    before = fused_mlp.fused_mlp_forward.launches
    got = functional.actor_act(card_net, {k: v.to(card) for k, v in params.items()},
                               obs.to(card), noise.to(card))
    assert fused_mlp.fused_mlp_forward.launches == before + 1
    torch.testing.assert_close(got.action.cpu(), want.action, rtol=1e-5, atol=1e-5)


def test_fcn_options_card_against_cpu(card):
    net = FullyConnectedNetwork([16, 64, 64, 4], ["relu", "tanh", "linear"], use_batch_norm=True,
                                use_layer_norm=True, dropout_ratio=0.2, use_skip_connections=True,
                                generator=torch.Generator().manual_seed(5))
    x = torch.randn(300, 16, generator=torch.Generator().manual_seed(6))
    masks = [torch.rand(300, 64, generator=torch.Generator().manual_seed(7 + i)) > 0.2
             for i in range(2)]
    card_net = copy.deepcopy(net).to(card)
    want = net(x), net(x, training=True, dropout_masks=masks)
    got = card_net(x.to(card)), card_net(x.to(card), training=True,
                                         dropout_masks=[m.to(card) for m in masks])
    for a, b in zip(got, want):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=1e-5)
