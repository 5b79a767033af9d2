"""The CUDA kernels K1 (float32 and with its bfloat16 options), K2 (tensor and
packed), K3, K4 and K5 (forward and backward) against their plain versions,
on the card.

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


# ------------------------------- K1's matmul_dtype / save_dtype options

K1_DTYPES = [
    (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, None),  # save_dtype follows matmul_dtype
]


def _dtype_id(d):
    return "none" if d is None else str(d).split(".")[-1]


def _k1_scalars(card, step, lr=0.01):
    t = torch.tensor(float(step + 1), device=card)
    return ((lr * torch.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)).float(),
            (1e-8 * torch.sqrt(1 - 0.999 ** t)).float())


@pytest.mark.parametrize("matmul_dtype,save_dtype", K1_DTYPES,
                         ids=[f"{_dtype_id(m)}-{_dtype_id(s)}" for m, s in K1_DTYPES])
@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("act", ["leaky_relu", "tanh"])
def test_k1_dtype_options_match_plain_version(card, matmul_dtype, save_dtype, double_q, act):
    """D=5, A=3 and a width of 24 are no multiple of the 16-wide MMA
    fragment, 70 none of the 64-wide tile, B=700 none of the 256-row chunk.
    Kernel and plain version multiply bfloat16 values exactly and sum in
    another order; a last-bit difference can flip the bfloat16 rounding of
    one saved activation (2^-8 relative there).  First update from zero
    moments: metrics rtol 2e-4, atol 2e-5; first moments rtol 1e-3, atol
    5e-6; parameters atol 2 * 3.2 * lr_t (Adam's first step from zero moments
    is lr_t * 0.1 / sqrt(0.001) * sign(g)).
    Two more updates: metrics rtol 1e-3, atol 1e-4."""
    fn = fused_dqn_offline.fused_dqn_offline_update
    plain = fused_dqn_offline.fused_dqn_offline_update_reference
    batch, p_kern = _inputs(card, 700, 5, [24, 70], 3, seed=4)
    p_plain = [p.clone() for p in p_kern]
    kw = dict(activations=[act, act, "linear"], gamma=0.9, tau=0.3, double_q_learning=double_q,
              block_size=100, matmul_dtype=matmul_dtype, save_dtype=save_dtype)
    launches, bf16_launches = fn.launches, fn.bf16_launches
    L = 3
    for step in range(3):
        lr_t, eps_t = _k1_scalars(card, step)
        mk = fn(lr_t, eps_t, *batch, p_kern, **kw)
        mp = plain(lr_t, eps_t, *batch, p_plain, **kw)
        if step == 0:
            torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
            for a, b in zip(p_kern[4 * L:6 * L], p_plain[4 * L:6 * L]):
                torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-6)
            for a, b in zip(p_kern[:4 * L], p_plain[:4 * L]):
                torch.testing.assert_close(a, b, rtol=0, atol=2 * float(lr_t) * 3.2)
        else:
            torch.testing.assert_close(mk, mp, rtol=1e-3, atol=1e-4)
    assert fn.launches == launches + 3 and fn.bf16_launches == bf16_launches + 3
    for a, b in zip(p_kern, p_plain):
        assert torch.isfinite(a).all()
        assert (a - b).abs().mean() < 1e-4


@pytest.mark.parametrize("matmul_dtype,save_dtype", K1_DTYPES[:3],
                         ids=[f"{_dtype_id(m)}-{_dtype_id(s)}" for m, s in K1_DTYPES[:3]])
def test_k1_dtype_options_are_deterministic(card, matmul_dtype, save_dtype):
    """No atomics, fixed-order sums: two runs agree bit for bit."""
    kw = dict(activations=["tanh", "leaky_relu", "linear"], gamma=0.9, tau=0.3,
              double_q_learning=True, block_size=100, matmul_dtype=matmul_dtype,
              save_dtype=save_dtype)
    runs = []
    for _ in range(2):
        batch, params = _inputs(card, 700, 5, [24, 70], 3, seed=9)
        lr_t, eps_t = _k1_scalars(card, 0)
        m = fused_dqn_offline.fused_dqn_offline_update(lr_t, eps_t, *batch, params, **kw)
        runs.append([m] + params)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_k1_dtype_options_reject_other_types(card):
    batch, params = _inputs(card, 64, 5, [24], 3, seed=1)
    one = torch.ones((), device=card)
    kw = dict(activations=["relu", "linear"], gamma=0.9, tau=0.3, double_q_learning=True,
              block_size=32)
    fn = fused_dqn_offline.fused_dqn_offline_update
    with pytest.raises(TypeError, match="matmul_dtype must be"):
        fn(one, one, *batch, params, matmul_dtype=torch.float16, **kw)
    with pytest.raises(TypeError, match="save_dtype must be"):
        fn(one, one, *batch, params, matmul_dtype=torch.bfloat16, save_dtype=torch.float16, **kw)
    with pytest.raises(TypeError, match="float32"):  # the batch itself stays float32
        fn(one, one, batch[0].bfloat16(), *batch[1:], params, matmul_dtype=torch.bfloat16, **kw)


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


# ------------------------------------------- K2 packed, K3, K4 (online slice)

from reagent_tpu_torch.ops import fused_mlp, nstep_replay  # noqa: E402

PACKED_COLS = (1, 0, 14, 15)  # action 0, observation 1-13, reward 14, terminal 15


def _packed_rows(device, B, D, A, seed):
    rng = np.random.default_rng(seed)
    rows = np.zeros((B, 16), np.float32)
    rows[:, 0] = rng.integers(0, A, B)
    rows[:, 1:1 + D] = rng.normal(size=(B, D))
    rows[:, 14] = rng.normal(size=B)
    rows[:, 15] = rng.random(B) < 0.1
    return torch.tensor(rows, device=device)


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh"])
def test_k2_packed_matches_plain_version(card, double_q, act):
    B = 200
    _, p_kern = _inputs(card, B, 13, [70, 33], 5, seed=6)
    p_plain = [p.clone() for p in p_kern]
    kw = dict(cols=PACKED_COLS, activations=[act, act, "linear"], gamma=0.9, tau=0.3,
              double_q_learning=double_q)
    fn = fused_dqn.fused_dqn_update_packed
    launches = fn.launches
    for step in range(3):
        rows = _packed_rows(card, B, 13, 5, seed=10 + step)
        next_rows = _packed_rows(card, B, 13, 5, seed=20 + step)
        t = torch.tensor(float(step + 1), device=card)
        lr_t = (0.01 * torch.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)).float()
        eps_t = (1e-8 * torch.sqrt(1 - 0.999 ** t)).float()
        mk = fn(lr_t, eps_t, rows, next_rows, p_kern, **kw)
        mp = fused_dqn.fused_dqn_update_packed_reference(
            lr_t, eps_t, rows, next_rows, p_plain, **kw)
        torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
    assert fn.launches == launches + 3
    for a, b in zip(p_kern, p_plain):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)


def _mlp(device, sizes, seed, transposed):
    rng = np.random.default_rng(seed)
    out = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        w = torch.tensor((rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32), device=device)
        b = torch.tensor((rng.normal(size=o) * 0.1).astype(np.float32), device=device)
        out.append((w.T if transposed else w.T.contiguous(), b))
    return out


@pytest.mark.parametrize("transposed", [True, False], ids=["out_in_view", "in_out"])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "linear"])
@pytest.mark.parametrize("B", [1, 37, 300])
def test_k3_matches_plain_version(card, transposed, act, B):
    """Ragged batches through both weight layouts; f32 sums in another order
    (rtol 1e-5, atol 1e-5)."""
    weights = _mlp(card, [13, 70, 33, 5], 2, transposed)
    x = torch.tensor(np.random.default_rng(B).normal(size=(B, 13)).astype(np.float32),
                     device=card)
    acts = [act, act, "linear"]
    launches = fused_mlp.fused_mlp_forward.launches
    y = fused_mlp.fused_mlp_forward(x, weights, acts)
    assert fused_mlp.fused_mlp_forward.launches == launches + 1
    torch.testing.assert_close(
        y, fused_mlp.fused_mlp_forward_reference(x, weights, acts), rtol=1e-5, atol=1e-5)


def test_k3_wide_layers_use_large_shared_memory(card):
    """maxw 600 at 16-row tiles needs 76.8 KB of shared memory (above the
    48 KB default)."""
    weights = _mlp(card, [8, 600, 40, 3], 3, True)
    x = torch.randn((50, 8), device=card, generator=torch.Generator(device=card).manual_seed(0))
    acts = ["tanh", "relu", "linear"]
    torch.testing.assert_close(
        fused_mlp.fused_mlp_forward(x, weights, acts),
        fused_mlp.fused_mlp_forward_reference(x, weights, acts), rtol=1e-5, atol=1e-5)


def _nstep_inputs(device, capacity, R, term_dtype, seed):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(capacity,) if R == 1 else (capacity, 2, R // 2)).astype(np.float32)
    terminals = rng.random(capacity) < 0.2
    idx = np.concatenate([rng.integers(0, capacity, 300),
                          [capacity - 1, capacity - 2, capacity, -1, 2 * capacity + 3]])
    return (torch.tensor(rewards, device=device),
            torch.tensor(terminals, device=device).to(term_dtype),
            torch.tensor(idx, dtype=torch.int64, device=device))


@pytest.mark.parametrize("term_dtype", [torch.bool, torch.uint8])
@pytest.mark.parametrize("R", [1, 6])
@pytest.mark.parametrize("horizon", [1, 3])
def test_k4_matches_plain_version(card, term_dtype, R, horizon):
    """Wrapping and out-of-range indices, terminals inside the window, vector
    rewards.  The kernel rounds each product and sum as the plain version
    does, in its order, so the two agree exactly."""
    rewards, terminals, idx = _nstep_inputs(card, 1000, R, term_dtype, seed=horizon)
    launches = nstep_replay.nstep_rewards.launches
    got = nstep_replay.nstep_rewards(rewards, terminals, idx, horizon, 0.9)
    assert nstep_replay.nstep_rewards.launches == launches + 1
    want = nstep_replay.nstep_rewards_reference(rewards, terminals, idx, horizon, 0.9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_online_kernels_are_deterministic(card):
    """Two runs of each kernel on the same inputs agree bit for bit."""
    runs = []
    for _ in range(2):
        _, params = _inputs(card, 64, 13, [70, 33], 5, seed=9)
        one = torch.ones((), device=card)
        m = fused_dqn.fused_dqn_update_packed(
            one * 1e-3, one * 1e-8, _packed_rows(card, 64, 13, 5, 1),
            _packed_rows(card, 64, 13, 5, 2), params, cols=PACKED_COLS,
            activations=["leaky_relu", "leaky_relu", "linear"], gamma=0.9, tau=0.3,
            double_q_learning=True)
        x = torch.ones((37, 13), device=card)
        y = fused_mlp.fused_mlp_forward(x, _mlp(card, [13, 70, 33, 5], 2, True),
                                        ["tanh", "tanh", "linear"])
        r = nstep_replay.nstep_rewards(*_nstep_inputs(card, 1000, 6, torch.bool, 4), 3, 0.9)
        runs.append([m, *params, y, *r])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_online_wrappers_reject_bad_inputs(card):
    _, params = _inputs(card, 64, 13, [70, 33], 5, seed=1)
    one = torch.ones((), device=card)
    rows = _packed_rows(card, 64, 13, 5, 0)
    kw = dict(cols=PACKED_COLS, activations=["relu", "relu", "linear"], gamma=0.9,
              tau=0.3, double_q_learning=True)
    k2p = fused_dqn.fused_dqn_update_packed
    with pytest.raises(ValueError, match="contiguous"):
        k2p(one, one, rows.t().contiguous().t(), rows, params, **kw)
    with pytest.raises(TypeError, match="float32"):
        k2p(one, one, rows.double(), rows.double(), params, **kw)
    with pytest.raises(ValueError, match="is on"):
        k2p(one, one, rows, rows, [p.cpu() for p in params], **kw)
    with pytest.raises(ValueError, match="cols"):
        k2p(one, one, rows, rows, params, **{**kw, "cols": (5, 0, 14, 15)})

    weights = _mlp(card, [13, 70, 5], 0, True)
    x = torch.ones((8, 13), device=card)
    with pytest.raises(TypeError, match="float32"):
        fused_mlp.fused_mlp_forward(x.double(), weights, ["relu", "linear"])
    with pytest.raises(ValueError, match="is on"):
        fused_mlp.fused_mlp_forward(x, [(w.cpu(), b.cpu()) for w, b in weights],
                                    ["relu", "linear"])
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.fused_mlp_forward(torch.ones((13, 8), device=card).t(), weights,
                                    ["relu", "linear"])

    rewards, terminals, idx = _nstep_inputs(card, 100, 1, torch.bool, 0)
    with pytest.raises(TypeError, match="bool or uint8"):
        nstep_replay.nstep_rewards(rewards, terminals.int(), idx, 3, 0.9)
    with pytest.raises(TypeError, match="int64"):
        nstep_replay.nstep_rewards(rewards, terminals, idx.int(), 3, 0.9)
    with pytest.raises(ValueError, match="is on"):
        nstep_replay.nstep_rewards(rewards, terminals, idx.cpu(), 3, 0.9)


# ------------------------------------------------------------------- K5


def _k5_inputs(device, B, N, dtype, seed, ties):
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(B, N)) * 2.0
    current = rng.normal(size=(B, N)) * 2.0
    if ties:
        # quarter-steps are exact in float32 and bfloat16: td lands on 0,
        # on +-0.5 and on +-1.0; every third target row is one value
        target, current = np.round(target * 4) / 4, np.round(current * 4) / 4
        target[::3] = 1.0
        current[0] = target[0]
    put = lambda a: torch.tensor(a, dtype=torch.float32, device=device).to(dtype)
    return put(target), put(current)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kappa", [1.0, 0.5])
@pytest.mark.parametrize("B,N", [(512, 11), (37, 51), (9, 201), (1, 1), (3, 32), (5, 33)])
def test_k5_matches_plain_version(card, B, N, kappa, dtype, ties):
    """Forward and backward against the plain version and its autograd, over
    block tails (B not a multiple of 8), warp tails (N not a multiple of 32)
    and ties.  float32 sums in another order, with fma contraction: rtol
    1e-5, atol 1e-6; a bfloat16 gradient is one more rounding to 8 bits."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    target, current = _k5_inputs(card, B, N, dtype, seed=B + N, ties=ties)
    c_kern = current.clone().requires_grad_(True)
    c_plain = current.clone().requires_grad_(True)
    fwd, bwd = qh.quantile_huber_loss.launches, qh.quantile_huber_loss.backward_launches
    weights = torch.linspace(-1.0, 2.0, B, device=card)
    per_kern = qh.quantile_huber_per_sample(target, c_kern, kappa)
    per_plain = qh.quantile_huber_per_sample_reference(target, c_plain, kappa)
    assert per_kern.dtype == torch.float32 and per_kern.shape == (B,)
    torch.testing.assert_close(per_kern, per_plain, rtol=1e-5, atol=1e-6)
    (per_kern * weights).sum().backward()
    (per_plain * weights).sum().backward()
    assert qh.quantile_huber_loss.launches == fwd + 1
    assert qh.quantile_huber_loss.backward_launches == bwd + 1
    assert c_kern.grad.dtype == dtype
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-5)
    torch.testing.assert_close(c_kern.grad, c_plain.grad, **tol)
    analytic = qh.quantile_huber_grad_reference(target, current, kappa, weights)
    torch.testing.assert_close(c_kern.grad, analytic, **tol)


def test_k5_mean_strided_rows_and_determinism(card):
    from reagent_tpu_torch.ops import quantile_huber as qh

    target, current = _k5_inputs(card, 300, 51, torch.float32, seed=7, ties=True)
    wide_t = torch.cat([target, target.flip(1)], dim=1)
    wide_c = torch.cat([current.flip(1), current], dim=1)
    c = wide_c[:, 51:].detach().requires_grad_(True)  # row stride 102
    assert not c.is_contiguous()
    loss = qh.quantile_huber_loss(wide_t[:, :51], c)
    (grad,) = torch.autograd.grad(loss, c)
    c_ref = current.clone().requires_grad_(True)
    want = qh.quantile_huber_loss_reference(target, c_ref)
    (want_grad,) = torch.autograd.grad(want, c_ref)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grad, want_grad, rtol=1e-5, atol=1e-7)
    again = qh.quantile_huber_loss(wide_t[:, :51], c)
    (grad_again,) = torch.autograd.grad(again, c)
    assert torch.equal(loss, again) and torch.equal(grad, grad_again)  # no atomics
    # an expanded target row (stride 0): a terminal sample's reward
    row = torch.full((1, 51), 1.0, device=card).expand(300, 51)
    torch.testing.assert_close(
        qh.quantile_huber_loss(row, current),
        qh.quantile_huber_loss_reference(row, current), rtol=1e-5, atol=1e-6)


def test_k5_gradcheck_against_plain_autograd(card):
    """The kernel's backward as the Jacobian-vector product of the plain
    version, row by row of the incoming gradient, and zero at td == 0."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    target, current = _k5_inputs(card, 6, 11, torch.float32, seed=3, ties=False)
    for b in range(6):
        onehot = torch.zeros(6, device=card)
        onehot[b] = 1.0
        c_kern = current.clone().requires_grad_(True)
        c_plain = current.clone().requires_grad_(True)
        (gk,) = torch.autograd.grad(
            qh.quantile_huber_per_sample(target, c_kern), c_kern, grad_outputs=onehot)
        (gp,) = torch.autograd.grad(
            qh.quantile_huber_per_sample_reference(target, c_plain), c_plain, grad_outputs=onehot)
        torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-7)
        assert not gk[torch.arange(6, device=card) != b].any()
    c = torch.full((4, 1), 0.75, device=card, requires_grad=True)
    (g,) = torch.autograd.grad(qh.quantile_huber_loss(torch.full((4, 1), 0.75, device=card), c), c)
    assert not g.any()


def test_k5_wrapper_rejects_bad_inputs(card):
    from reagent_tpu_torch.ops import quantile_huber as qh

    t = torch.zeros((4, 11), device=card)
    with pytest.raises(ValueError, match="no gradient"):
        qh.quantile_huber_loss(t.clone().requires_grad_(True), t)
    with pytest.raises(ValueError, match="atom stride 1"):
        qh.quantile_huber_loss(torch.zeros((11, 4), device=card).T, t)
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        qh.quantile_huber_loss(t.half(), t.half())
    with pytest.raises(ValueError, match="is on"):
        qh.quantile_huber_loss(t, t.cpu())
    with pytest.raises(ValueError, match="at most"):
        qh.quantile_huber_loss(torch.zeros((2, 2000), device=card), torch.zeros((2, 2000), device=card))


def test_argmax_takes_the_first_of_equal_maxima_on_the_card(card):
    """``get_max_q_values_with_target`` on the all-equal rows of an untrained
    net and on a fully masked row, against the CPU."""
    from reagent_tpu_torch.training.rl_trainer_base import get_max_q_values_with_target

    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 8)).astype(np.float32)
    q[::2] = 0.25
    q[1, [2, 5]] = 9.0
    mask = (rng.random((64, 8)) > 0.3).astype(np.float32)
    mask[:, 3] = 1.0
    mask[4] = 0.0
    for double_q in (True, False):
        want_q, want_i = get_max_q_values_with_target(
            torch.tensor(q), torch.tensor(q[::-1].copy()), torch.tensor(mask), double_q)
        got_q, got_i = get_max_q_values_with_target(
            torch.tensor(q, device=card), torch.tensor(q[::-1].copy(), device=card),
            torch.tensor(mask, device=card), double_q)
        assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_q.cpu(), want_q)
        assert int(want_i[4]) == 0
