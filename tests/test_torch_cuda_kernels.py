"""The CUDA kernels K1/K2 against their plain versions, on the card.

Skipped without an NVIDIA card.  On the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which that machine
does not need).  Shapes are ragged on purpose (no dimension a multiple of the
64-wide tiles) to cover the tile edges.
"""

import numpy as np
import pytest
import torch

from reagent_tpu_torch.ops import fused_dqn, fused_dqn_offline

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain version
    return torch.device("cuda")


def _inputs(device, B, D, widths, A, seed):
    rng = np.random.default_rng(seed)
    sizes = [D, *widths, A]
    W = [(rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32)
         for i, o in zip(sizes[:-1], sizes[1:])]
    b = [(rng.normal(size=(1, o)) * 0.1).astype(np.float32) for o in sizes[1:]]
    Wt = [(w * 0.9).astype(np.float32) for w in W]
    bt = [(x * 0.9).astype(np.float32) for x in b]
    zeros = [np.zeros_like(p) for p in W + b]
    mask = (rng.random((B, A)) > 0.3).astype(np.float32)
    mask[:, -1] = 1.0
    batch = [
        rng.normal(size=(B, D)), rng.normal(size=(B, D)),
        np.eye(A)[rng.integers(0, A, B)], rng.normal(size=(B, 1)),
        (rng.random((B, 1)) > 0.1), mask,
    ]
    put = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return [put(x) for x in batch], [put(p) for p in W + b + Wt + bt + zeros + zeros]


CASES = [
    ("K2", fused_dqn.fused_dqn_update, {}, 200),
    ("K1", fused_dqn_offline.fused_dqn_offline_update, {"block_size": 100}, 700),
]


@pytest.mark.parametrize("name,fn,extra,B", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh"])
def test_kernel_matches_plain_version(card, name, fn, extra, B, double_q, act):
    plain = (fused_dqn.fused_dqn_update_reference if name == "K2"
             else fused_dqn_offline.fused_dqn_offline_update_reference)
    batch, p_kern = _inputs(card, B, 13, [70, 33], 5, seed=4)
    p_plain = [p.clone() for p in p_kern]
    kw = dict(activations=[act, act, "linear"], gamma=0.9, tau=0.3,
              double_q_learning=double_q, **extra)
    launches = fn.launches
    for step in range(3):
        t = torch.tensor(float(step + 1), device=card)
        lr_t = (0.01 * torch.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)).float()
        eps_t = (1e-8 * torch.sqrt(1 - 0.999 ** t)).float()
        mk = fn(lr_t, eps_t, *batch, p_kern, **kw)
        mp = plain(lr_t, eps_t, *batch, p_plain, **kw)
        torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
    assert fn.launches == launches + 3
    for a, b in zip(p_kern, p_plain):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("name,fn,extra,B", CASES, ids=[c[0] for c in CASES])
def test_kernel_is_deterministic(card, name, fn, extra, B):
    """No atomics: two runs from the same state agree bit for bit."""
    kw = dict(activations=["leaky_relu", "leaky_relu", "linear"], gamma=0.9, tau=0.3,
              double_q_learning=True, **extra)
    runs = []
    for _ in range(2):
        batch, params = _inputs(card, B, 13, [70, 33], 5, seed=9)
        one = torch.ones((), device=card)
        m = fn(one * 1e-3, one * 1e-8, *batch, params, **kw)
        runs.append([m] + params)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_inputs(card):
    batch, params = _inputs(card, 64, 13, [70, 33], 5, seed=1)
    kw = dict(activations=["relu", "relu", "linear"], gamma=0.9, tau=0.3,
              double_q_learning=True)
    one = torch.ones((), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dqn.fused_dqn_update(one, one, batch[0].t().contiguous().t(), *batch[1:], params, **kw)
    with pytest.raises(TypeError, match="float32"):
        fused_dqn.fused_dqn_update(one, one, batch[0].double(), *batch[1:], params, **kw)
    with pytest.raises(ValueError, match="shape"):
        fused_dqn.fused_dqn_update(one, one, *batch[:3], batch[3][:10], *batch[4:], params, **kw)
    with pytest.raises(ValueError, match="linear output layer"):
        fused_dqn.fused_dqn_update(one, one, *batch, params,
                                   **{**kw, "activations": ["relu", "relu", "tanh"]})
