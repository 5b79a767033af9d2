"""The world-model slice on the card, against the CPU: OpenGridworld,
PossibleActionsMaskTester and StringGame embedded by a MemoryNetwork
(``StateEmbedEnv``), and the MDN-RNN trainer.  Skipped without an NVIDIA
card; on the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_world_model.py
"""

import copy

import numpy as np
import pytest
import torch

from reagent_tpu_torch.gym import envs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain versions
    return torch.device("cuda")


def test_envs_on_the_card_match_the_cpu(card):
    """OpenGridworld, PossibleActionsMaskTester and StringGame embedded by a
    MemoryNetwork, on the card against the CPU from the same draws."""
    from reagent_tpu_torch.gym.envs import StateEmbedEnv
    from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork

    mn = MemoryNetwork(2, 2, 16, 1, 1)
    mn.reset_parameters(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in mn.named_parameters()}
    rng = np.random.default_rng(0)
    for make in (lambda d: envs.OpenGridworld(device=d),
                 lambda d: envs.PossibleActionsMaskTester(device=d),
                 lambda d: StateEmbedEnv(envs.StringGame(device=d), copy.deepcopy(mn).to(d),
                                         {k: v.to(d) for k, v in params.items()}, 6)):
        cpu, gpu = make("cpu"), make("cuda")
        draw = getattr(cpu, "reset_noise", None)
        kw = {} if draw is None else {"noise": draw(torch.Generator().manual_seed(1))}
        sc, oc = cpu.reset(**kw)
        sg, og = gpu.reset(**{k: v.cuda() for k, v in kw.items()})
        for _ in range(30):
            a = torch.tensor(int(rng.integers(0, cpu.action_dim)))
            draw = getattr(cpu, "step_noise", None)
            kw = {} if draw is None else {"noise": draw(torch.Generator().manual_seed(2))}
            sc, oc, rc, dc = cpu.step(sc, a, **kw)
            sg, og, rg, dg = gpu.step(sg, a.cuda(), **{k: v.cuda() for k, v in kw.items()})
            torch.testing.assert_close(og.cpu(), oc, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(rg.cpu(), rc, rtol=0, atol=1e-6)
            assert bool(dg) == bool(dc)
            if bool(dc):
                sc, oc = cpu.reset(**({} if draw is None else {"noise": torch.tensor(1)}))
                sg, og = gpu.reset(**({} if draw is None else {"noise": torch.tensor(1).cuda()}))


@pytest.mark.parametrize("fit_only_one_next_step", [False, True])
def test_mdnrnn_trainer_on_the_card_matches_the_cpu(card, fit_only_one_next_step):
    """5 steps from one state on the same batches: losses rtol 1e-4, every
    parameter and Adam moment rtol 5e-4, atol 5e-5."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import MDNRNNTrainerParameters
    from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
    from reagent_tpu_torch.training.world_model import MDNRNNTrainer
    from reagent_tpu_torch.utils.checkpointing import flatten_state

    params = MDNRNNTrainerParameters(learning_rate=0.01,
                                     fit_only_one_next_step=fit_only_one_next_step)
    trainers = {d: MDNRNNTrainer(MemoryNetwork(3, 2, 16, 2, 3), params, device=d)
                for d in ("cpu", "cuda")}
    first = trainers["cpu"].init(torch.Generator().manual_seed(0))
    trainers["cuda"].memory_network.load_state_dict(first.params)
    states = {"cpu": first, "cuda": trainers["cuda"].state_from_memory_network()}
    rng = np.random.default_rng(1)
    for _ in range(5):
        T, B = 5, 32
        cols = [rng.normal(size=(T, B, 3)), np.eye(2)[rng.integers(0, 2, (T, B))],
                rng.normal(size=(T, B, 3)), rng.normal(size=(T, B)),
                (rng.random((T, B)) > 0.1).astype(np.float64)]
        s, a, ns, r, nt = (torch.tensor(c, dtype=torch.float32) for c in cols)
        batch = rlt.MemoryNetworkInput(
            state=rlt.FeatureData(s), next_state=rlt.FeatureData(ns), action=rlt.FeatureData(a),
            reward=r, time_diff=torch.ones_like(r), step=None, not_terminal=nt)
        losses = {}
        for d, tr in trainers.items():
            states[d], losses[d] = tr.train_step(states[d], batch.to(d))
        for k, want in losses["cpu"].items():
            torch.testing.assert_close(losses["cuda"][k].cpu(), want, rtol=1e-4, atol=1e-6)
    got, want = flatten_state(states["cuda"]), flatten_state(states["cpu"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        torch.testing.assert_close(got[k].cpu(), w, rtol=5e-4, atol=5e-5, msg=k)
