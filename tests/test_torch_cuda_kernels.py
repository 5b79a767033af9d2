"""The CUDA kernels K1 (float32 and with its bfloat16 options), K2 (tensor and
packed, on its one-launch route and on the launch sequence), K3, K4 and K5
(forward and backward) against their plain versions, on the card; and the
trainer states' checkpoints and the reporter's one copy of a step's metrics
on the card.

Skipped without an NVIDIA card.  On the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which that machine
does not need).  The test shape is ragged on purpose (no dimension a
multiple of 4 or of the tiles) to cover the tile edges with one-float
loads; K1 also runs at the full offline width, at the DQN benchmark cell's
batch of 16,384 and 37 rows short of it (the ring kernel's tiles and
split-K chunks, and which route each product takes), and at a shape whose
widths are multiples of 4 but not of the 128-wide tile (the 16-byte loads'
ragged edges); K2 also runs at the online loop's CartPole shapes and at the full
offline width.
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


def _inputs(device, B, D, widths, A, seed, mid_training=False):
    """Batch and params8 from a numpy seed; Adam moments zero, or with
    ``mid_training`` those of a run some steps in (first moments ~1e-2,
    second moments 1e-4 above squares of that)."""
    rng = np.random.default_rng(seed)
    sizes = [D, *widths, A]
    W = [(rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32)
         for i, o in zip(sizes[:-1], sizes[1:])]
    b = [(rng.normal(size=(1, o)) * 0.1).astype(np.float32) for o in sizes[1:]]
    Wt = [(w * 0.9).astype(np.float32) for w in W]
    bt = [(x * 0.9).astype(np.float32) for x in b]
    zeros = [np.zeros_like(p) for p in W + b]
    m0 = v0 = zeros
    if mid_training:
        m0 = [rng.normal(size=p.shape) * 1e-2 for p in W + b]
        v0 = [(rng.normal(size=p.shape) * 1e-2) ** 2 + 1e-4 for p in W + b]
    mask = (rng.random((B, A)) > 0.3).astype(np.float32)
    mask[:, -1] = 1.0
    batch = [
        rng.normal(size=(B, D)), rng.normal(size=(B, D)),
        np.eye(A)[rng.integers(0, A, B)], rng.normal(size=(B, 1)),
        (rng.random((B, 1)) > 0.1), mask,
    ]
    put = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return [put(x) for x in batch], [put(p) for p in W + b + Wt + bt + m0 + v0]


TEST_SHAPE = (13, [70, 33], 5)  # D, hidden widths, A
CARTPOLE = (4, [128, 64], 2)
RAGGED4 = (132, [516, 260], 8)  # multiples of 4, none of the 128-wide tile
CELL = (128, [512, 256], 8)  # the DQN benchmark cell's widths (at B = 16,384 and 37 rows short)
# (id, wrapper, extra arguments, B, D, widths, A).  K2 runs as one launch
# wherever both nets' weights and a block's rows fit its shared memory: the
# test shape, the online loop's CartPole shapes, one row, and 513 rows (the
# last block short); the full offline width is too large and takes the
# launch sequence, as K1 always does.
CASES = [
    ("K2", fused_dqn.fused_dqn_update, {}, 200, *TEST_SHAPE),
    ("K2-cartpole", fused_dqn.fused_dqn_update, {}, 512, *CARTPOLE),
    ("K2-B1", fused_dqn.fused_dqn_update, {}, 1, *TEST_SHAPE),
    ("K2-B513", fused_dqn.fused_dqn_update, {}, 513, *CARTPOLE),
    ("K2-large", fused_dqn.fused_dqn_update, {}, 512, 128, [512, 256], 8),
    ("K1", fused_dqn_offline.fused_dqn_offline_update, {"block_size": 100}, 700, *TEST_SHAPE),
    ("K1-full", fused_dqn_offline.fused_dqn_offline_update, {"block_size": 512}, 4096,
     128, [512, 256], 8),
    ("K1-ragged", fused_dqn_offline.fused_dqn_offline_update, {"block_size": 200}, 1000,
     *RAGGED4),
    # fewer actions than the row kernel's 8 outputs a thread: W's rows past A
    # read as zero, the outputs stored one at a time
    ("K1-A5", fused_dqn_offline.fused_dqn_offline_update, {"block_size": 200}, 1000,
     *RAGGED4[:2], 5),
    ("K1-cell", fused_dqn_offline.fused_dqn_offline_update, {"block_size": 1024}, 16384,
     *CELL),
    ("K1-cell-ragged", fused_dqn_offline.fused_dqn_offline_update, {"block_size": 16347},
     16347, *CELL),
]
# The cases added for the one-launch route start from a mid-training Adam
# state.  From zero moments Adam's first step is lr * sign(g) for every
# entry, so an entry whose gradient is at float32 rounding level moves by
# +-lr in one of two correct float32 orders and not the other: at these
# shapes float32 and float64 plain versions part by up to 300x the params
# tolerance that way.  Mid-training moments keep every step linear in g
# (the two part by under 1% of it), so the same tolerances hold the kernel.
MID_TRAINING = ("K2-cartpole", "K2-B1", "K2-B513", "K2-large", "K1-full", "K1-ragged", "K1-A5",
                "K1-cell", "K1-cell-ragged")


def _step_scalars(card, name, step, lr=0.01):
    """lr_t and eps_t of Adam step ``step`` (10 steps on in a mid-training case)."""
    t = torch.tensor(float(step + 1 + (10 if name in MID_TRAINING else 0)), device=card)
    return ((lr * torch.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)).float(),
            (1e-8 * torch.sqrt(1 - 0.999 ** t)).float())


def _sequence_kernels(n_layers, bf16_products=False):
    """CUDA kernels of one update on the launch sequence, double-Q or not:
    per layer one forward launch for all (net, input) pairs and one
    weight-gradient launch (bias gradient in extra blocks), dh past the first
    layer, the TD rows, one Adam + polyak + metrics launch, and with bf16
    products one conversion launch first."""
    return 3 * n_layers + 1 + int(bf16_products)


def _kernels_per_update(name, double_q):
    """CUDA kernels one update launches: 1 on K2's one-launch route, else the
    launch sequence's (every case has three layers)."""
    if name.startswith("K2") and name != "K2-large":
        return 1
    return _sequence_kernels(3)


@pytest.mark.parametrize("name,fn,extra,B,D,widths,A", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh"])
def test_kernel_matches_plain_version(card, name, fn, extra, B, D, widths, A, double_q, act):
    plain = (fused_dqn.fused_dqn_update_reference if name.startswith("K2")
             else fused_dqn_offline.fused_dqn_offline_update_reference)
    batch, p_kern = _inputs(card, B, D, widths, A, seed=4, mid_training=name in MID_TRAINING)
    p_plain = [p.clone() for p in p_kern]
    kw = dict(activations=[act, act, "linear"], gamma=0.9, tau=0.3,
              double_q_learning=double_q, **extra)
    launches = fn.launches
    for step in range(3):
        lr_t, eps_t = _step_scalars(card, name, step)
        mk = fn(lr_t, eps_t, *batch, p_kern, **kw)
        mp = plain(lr_t, eps_t, *batch, p_plain, **kw)
        torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
    assert fn.launches == launches + 3
    assert fn.kernels_per_update == _kernels_per_update(name, double_q)
    for a, b in zip(p_kern, p_plain):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("name,fn,extra,B,D,widths,A", CASES, ids=[c[0] for c in CASES])
def test_kernel_is_deterministic(card, name, fn, extra, B, D, widths, A):
    """No atomics: two runs from the same state agree bit for bit, on both
    of K2's routes."""
    kw = dict(activations=["leaky_relu", "leaky_relu", "linear"], gamma=0.9, tau=0.3,
              double_q_learning=True, **extra)
    runs = []
    for _ in range(2):
        batch, params = _inputs(card, B, D, widths, A, seed=9)
        one = torch.ones((), device=card)
        m = fn(one * 1e-3, one * 1e-8, *batch, params, **kw)
        runs.append([m] + params)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("double_q", [True, False])
def test_k1_wide_products_take_the_ring_kernel(card, double_q):
    """At the DQN benchmark cell's shapes every wide product of an update
    (the forwards, weight gradients and dh of the 512- and 256-wide layers:
    6) takes the ring kernel, the last layer's forward (N = 8) the row kernel
    and its weight gradient the narrow tile; nothing takes the unaligned or
    bfloat16 routes."""
    batch, params = _inputs(card, 16384, *CELL, seed=3)
    kw = dict(activations=["leaky_relu", "leaky_relu", "linear"], gamma=0.99, tau=0.1,
              double_q_learning=double_q, block_size=1024)
    before = fused_dqn_offline.product_routes()
    fused_dqn_offline.fused_dqn_offline_update(*_k1_scalars(card, 0), *batch, params, **kw)
    after = fused_dqn_offline.product_routes()
    took = {route: after[route] - before[route] for route in fused_dqn_offline.PRODUCT_ROUTES}
    assert sum(n for route, n in took.items() if route.startswith("ring_")) == 6, took
    assert took["rows_64x8"] == 1 and took["narrow_64x16"] == 1, took
    assert took["typed_128x64"] == took["tensor_cores"] == 0, took


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
    assert fn.bf16_kernels_per_update == _sequence_kernels(L, matmul_dtype == torch.bfloat16)
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


def _first_moments_close(got, want):
    """First moments b1 * m + 0.1 * g after one update from one state: rtol
    1e-3, atol 5e-6, except in at most 16 rows of a weight's moment (elements
    of a bias's), up to 2e-4: a pre-activation within float32 rounding of 0
    that lands on the other side in the other summation order enters one
    row of dW at a hundredth (leaky_relu) or not at all."""
    diff = (got - want).abs()
    far = diff > 5e-6 + 1e-3 * want.abs()
    rows = int(far.any(dim=1).sum()) if got.shape[0] > 1 else int(far.sum())
    assert rows <= 16 and diff.max().item() <= 2e-4, (rows, diff.max().item())


@pytest.mark.parametrize("matmul_dtype,save_dtype", K1_DTYPES[:3],
                         ids=[f"{_dtype_id(m)}-{_dtype_id(s)}" for m, s in K1_DTYPES[:3]])
@pytest.mark.parametrize("double_q", [True, False])
def test_k1_dtype_options_at_16_byte_ragged_widths(card, matmul_dtype, save_dtype, double_q):
    """B=1000, D=132, widths 516, 260, A=8: rows of multiples of 4 floats
    (8 bfloat16s only for the padded bf16 copies), none of the 128-wide
    tile, the last 256-row chunk short.  Three updates, each held against
    the plain version from the kernel's own state (two bfloat16
    trajectories part by rounding flips without either being wrong, as
    chip_smoke.compare_k1_bf16 says): metrics rtol 2e-4, atol 2e-5; first
    moments as _first_moments_close; parameters and targets atol
    2 * 3.2 * lr_t with a mean abs difference under 1e-6."""
    fn = fused_dqn_offline.fused_dqn_offline_update
    plain = fused_dqn_offline.fused_dqn_offline_update_reference
    D, widths, A = RAGGED4
    batch, p_kern = _inputs(card, 1000, D, widths, A, seed=5)
    kw = dict(activations=["leaky_relu", "leaky_relu", "linear"], gamma=0.9, tau=0.3,
              double_q_learning=double_q, block_size=200, matmul_dtype=matmul_dtype,
              save_dtype=save_dtype)
    L = 3
    for step in range(3):
        p_plain = [p.clone() for p in p_kern]
        lr_t, eps_t = _k1_scalars(card, step, lr=1e-3)
        mk = fn(lr_t, eps_t, *batch, p_kern, **kw)
        mp = plain(lr_t, eps_t, *batch, p_plain, **kw)
        torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
        for a, b in zip(p_kern[4 * L:6 * L], p_plain[4 * L:6 * L]):
            _first_moments_close(a, b)
        for a, b in zip(p_kern[:4 * L], p_plain[:4 * L]):
            torch.testing.assert_close(a, b, rtol=0, atol=2 * 3.2 * float(lr_t))
            assert (a - b).abs().mean() < 1e-6
    assert fn.bf16_kernels_per_update == _sequence_kernels(L, matmul_dtype == torch.bfloat16)


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

def _packed_cols(D):
    """(observation, action, reward, terminal) columns of replay rows of width
    max(16, D + 3): action 0, observation from 1, reward and terminal last."""
    width = max(16, D + 3)
    return (1, 0, width - 2, width - 1)


PACKED_COLS = _packed_cols(13)  # action 0, observation 1-13, reward 14, terminal 15


def _packed_rows(device, B, D, A, seed):
    rng = np.random.default_rng(seed)
    obs_col, act_col, rew_col, term_col = _packed_cols(D)
    rows = np.zeros((B, term_col + 1), np.float32)
    rows[:, act_col] = rng.integers(0, A, B)
    rows[:, obs_col:obs_col + D] = rng.normal(size=(B, D))
    rows[:, rew_col] = rng.normal(size=B)
    rows[:, term_col] = rng.random(B) < 0.1
    return torch.tensor(rows, device=device)


PACKED_CASES = [(c[0], *c[3:]) for c in CASES if c[0].startswith("K2")]


@pytest.mark.parametrize("name,B,D,widths,A", PACKED_CASES, ids=[c[0] for c in PACKED_CASES])
@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh"])
def test_k2_packed_matches_plain_version(card, name, B, D, widths, A, double_q, act):
    _, p_kern = _inputs(card, B, D, widths, A, seed=6, mid_training=name in MID_TRAINING)
    p_plain = [p.clone() for p in p_kern]
    kw = dict(cols=_packed_cols(D), activations=[act, act, "linear"], gamma=0.9, tau=0.3,
              double_q_learning=double_q)
    fn = fused_dqn.fused_dqn_update_packed
    launches = fn.launches
    for step in range(3):
        rows = _packed_rows(card, B, D, A, seed=10 + step)
        next_rows = _packed_rows(card, B, D, A, seed=20 + step)
        lr_t, eps_t = _step_scalars(card, name, step)
        mk = fn(lr_t, eps_t, rows, next_rows, p_kern, **kw)
        mp = fused_dqn.fused_dqn_update_packed_reference(
            lr_t, eps_t, rows, next_rows, p_plain, **kw)
        torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
    assert fn.launches == launches + 3
    assert fn.kernels_per_update == _kernels_per_update(name, double_q)
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
    """maxw 600 needs more shared memory than the 48 KB a block gets by
    default: at 50 rows (one a block) the resident route holds the net in
    about 133 KB."""
    weights = _mlp(card, [8, 600, 40, 3], 3, True)
    x = torch.randn((50, 8), device=card, generator=torch.Generator(device=card).manual_seed(0))
    acts = ["tanh", "relu", "linear"]
    torch.testing.assert_close(
        fused_mlp.fused_mlp_forward(x, weights, acts),
        fused_mlp.fused_mlp_forward_reference(x, weights, acts), rtol=1e-5, atol=1e-5)


def _k3_matches(x, weights, acts):
    launches = fused_mlp.fused_mlp_forward.launches
    y = fused_mlp.fused_mlp_forward(x, weights, acts)
    assert fused_mlp.fused_mlp_forward.launches == launches + 1
    torch.testing.assert_close(
        y, fused_mlp.fused_mlp_forward_reference(x, weights, acts), rtol=1e-5, atol=1e-5)
    return y


@pytest.mark.parametrize("rows", [1, 20], ids=["act_step", "evaluate_policy"])
def test_k3_at_the_act_step_through_the_trainer(card, rows):
    """The main path's exact call: the CartPole net 4 -> 128 -> 64 -> 2 as
    FusedDQNTrainer.mlp_weights gives it (W^T views of [out, in]), on the
    resident route, and trainer.q_values the same."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

    net = FullyConnectedDQN(state_dim=4, action_dim=2, sizes=[128, 64],
                            activations=["leaky_relu", "leaky_relu"])
    trainer = FusedDQNTrainer(q_network=net, rl=RLParameters(gamma=0.99, target_update_rate=0.2),
                              optimizer={"Adam": {"lr": 0.01}}, device=card)
    state = trainer.init(torch.Generator().manual_seed(rows))
    weights = trainer.mlp_weights(state)
    assert fused_mlp.takes_resident_route(rows, weights)
    x = torch.tensor(np.random.default_rng(rows).normal(size=(rows, 4)).astype(np.float32),
                     device=card)
    y = _k3_matches(x, weights, trainer.activations)
    assert torch.equal(trainer.q_values(state, x), y)


def _widest_resident(D, A, tail, B):
    """The widest first hidden layer H of D -> H -> tail -> A (W^T views) that
    the resident route holds at B rows."""
    def views(sizes):  # the strides of _mlp(..., transposed=True), no data
        return [(torch.empty(o, i).T, torch.empty(o)) for i, o in zip(sizes[:-1], sizes[1:])]

    H = 64
    while fused_mlp.takes_resident_route(B, views([D, H + 1, tail, A])):
        H += 1
    return H


@pytest.mark.parametrize("side", ["inside", "past"])
def test_k3_at_the_edge_of_the_resident_budget(card, side):
    """A net just inside the shared memory the resident route may use, and
    one a column past it, which takes the streamed route: both agree with
    the plain version."""
    B = 37
    H = _widest_resident(32, 5, 64, B) + (side == "past")
    weights = _mlp(card, [32, H, 64, 5], 4, True)
    assert fused_mlp.takes_resident_route(B, weights) == (side == "inside")
    x = torch.tensor(np.random.default_rng(5).normal(size=(B, 32)).astype(np.float32),
                     device=card)
    _k3_matches(x, weights, ["tanh", "leaky_relu", "linear"])


@pytest.mark.parametrize("transposed", [True, False], ids=["out_in_view", "in_out"])
@pytest.mark.parametrize("B", [1, 20])
def test_k3_input_widths_not_a_multiple_of_4(card, transposed, B):
    """Every layer's input width odd or 2 mod 4: the 4-byte copies and the
    tails of the 16-byte reads, in both weight layouts."""
    weights = _mlp(card, [6, 130, 67, 2], 6, transposed)
    x = torch.tensor(np.random.default_rng(B).normal(size=(B, 6)).astype(np.float32),
                     device=card)
    _k3_matches(x, weights, ["leaky_relu", "relu", "linear"])


@pytest.mark.parametrize("rows,sizes,resident", [
    (512, [4, 128, 64, 2], True), (4096, [128, 512, 256, 8], False)],
    ids=["sample_config_resident", "full_width_streamed"])
def test_k3_at_the_evaluation_shapes(card, rows, sizes, resident):
    """The evaluation page's three forwards go through functional.score:
    one K3 launch each, on the route the net's size picks, no plain
    version; the page itself launches K3 three times."""
    from reagent_tpu_torch.evaluation import EvaluationDataPage
    from reagent_tpu_torch.net_builder.discrete_dqn import FullyConnected
    from reagent_tpu_torch.training.dqn_trainer import DQNTrainer

    build = FullyConnected(sizes=sizes[1:-1], activations=["leaky_relu"] * (len(sizes) - 2))
    nets = [build.build_q_network(None, sizes[-1], state_dim=sizes[0]) for _ in range(3)]
    trainer = DQNTrainer(nets[0], reward_network=nets[1], q_network_cpe=nets[2], device=card)
    state = trainer.init(torch.Generator().manual_seed(rows))
    rng = np.random.default_rng(rows)
    x = torch.tensor(rng.normal(size=(rows, sizes[0])).astype(np.float32), device=card)
    weights = [(state.q_params[f"net.layers.{i}.weight"].T, state.q_params[f"net.layers.{i}.bias"])
               for i in range(len(sizes) - 1)]
    assert fused_mlp.takes_resident_route(rows, weights) == resident
    plain = fused_mlp.fused_mlp_forward_reference.calls
    y = _k3_matches(x, weights, trainer.q_network.activations)
    assert torch.equal(trainer.q_values(state, x), y)
    actions = torch.tensor(np.eye(sizes[-1], dtype=np.float32)[rng.integers(0, sizes[-1], rows)],
                           device=card)
    launches = fused_mlp.fused_mlp_forward.launches
    calls = fused_mlp.fused_mlp_forward_reference.calls
    page = EvaluationDataPage.create_from_tensors_dqn(
        trainer, state, np.zeros((rows, 1)), np.zeros((rows, 1)), x, actions,
        torch.full((rows, 1), 0.5, device=card), torch.ones((rows, 1), device=card),
        torch.ones_like(actions))
    assert fused_mlp.fused_mlp_forward.launches == launches + 3
    assert fused_mlp.fused_mlp_forward_reference.calls == calls
    np.testing.assert_array_equal(page.optimal_q_values, y.cpu().numpy())
    assert fused_mlp.fused_mlp_forward_reference.calls == plain + 1  # _k3_matches' own


@pytest.mark.parametrize("rows", [1, 20], ids=["act_step", "evaluate_policy"])
@pytest.mark.parametrize("family", ["c51", "parametric"])
def test_k3_on_the_c51_and_parametric_paths(card, family, rows):
    """C51's ``q_values`` (the [rows, 102] logits through K3, E[Z] in torch)
    and the parametric scorer (the [2 * rows, 6] tiled rows through K3): one
    launch each, no plain version, equal to the modules' own forwards
    (E[Z] up to 200: atol 1e-4)."""
    from reagent_tpu_torch.gym.policies import parametric_dqn_scorer
    from reagent_tpu_torch.models.categorical_dqn import CategoricalDQN
    from reagent_tpu_torch.models.critic import FullyConnectedCritic
    from reagent_tpu_torch.training.c51_trainer import C51Trainer
    from reagent_tpu_torch.training.parametric_dqn_trainer import ParametricDQNTrainer

    acts = ["leaky_relu", "leaky_relu"]
    x = torch.tensor(np.random.default_rng(rows).normal(size=(rows, 4)).astype(np.float32),
                     device=card)
    if family == "c51":
        trainer = C51Trainer(CategoricalDQN(4, 2, 51, 0, 200, [128, 64], acts), device=card)
        state = trainer.init(torch.Generator().manual_seed(rows))
        score = lambda: trainer.q_values(state, x)  # noqa: E731
        own = trainer.export_q_network(state)(x)
    else:
        trainer = ParametricDQNTrainer(FullyConnectedCritic(4, 2, [128, 64], acts), device=card)
        state = trainer.init(torch.Generator().manual_seed(rows))
        score = lambda: parametric_dqn_scorer(2, trainer.q_network)(state.q_params, x)  # noqa: E731
        eye = torch.eye(2, device=card).repeat(rows, 1)
        own = trainer.export_q_network(state)(x.repeat_interleave(2, 0), eye).reshape(rows, 2)
    launches = fused_mlp.fused_mlp_forward.launches
    calls = fused_mlp.fused_mlp_forward_reference.calls
    y = score()
    assert fused_mlp.fused_mlp_forward.launches == launches + 1
    assert fused_mlp.fused_mlp_forward_reference.calls == calls
    assert y.shape == (rows, 2)
    torch.testing.assert_close(y, own.detach(), rtol=1e-5, atol=1e-4)


# The streamed route's tile edges: every net past the resident route's
# shared memory, out widths 500, 501 and 1, in widths 6, 10 and 137 (none a
# multiple of 4: the 4-byte copies of x), L of 1 and 6.
K3_STREAMED_NETS = {
    "6-500-501-1": [6, 500, 501, 1],
    "10-501-500-1": [10, 501, 500, 1],
    "137-500-1": [137, 500, 1],
    "L1-600-501": [600, 501],
    "L6-10-300-300-300-200-100-1": [10, 300, 300, 300, 200, 100, 1],
}
K3_ACTS = ["relu", "leaky_relu", "tanh", "linear"]


def _k3_streamed(x, weights, acts):
    """K3 on the streamed route against its plain version (f32 sums in
    another order: rtol 1e-5, atol 1e-5), one wrapper launch and one CUDA
    kernel a layer."""
    assert not fused_mlp.takes_resident_route(x.shape[0], weights)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        y = _k3_matches(x, weights, acts)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "mlp_layer_kernel" in e.name]
    assert len(kernels) == len(weights), [e.name for e in kernels]
    return y


@pytest.mark.parametrize("transposed", [True, False], ids=["out_in_view", "in_out"])
@pytest.mark.parametrize("net", list(K3_STREAMED_NETS))
@pytest.mark.parametrize("B", [1, 17, 33, 257, 4097])
def test_k3_streamed_route_at_its_tile_edges(card, B, net, transposed):
    """Batches on both sides of the row tiles (16, 32, 64, 128) and of the
    grid's switch between tile shapes, in both weight layouts, each
    activation in turn."""
    sizes = K3_STREAMED_NETS[net]
    i = list(K3_STREAMED_NETS).index(net) + B
    acts = [K3_ACTS[i % 4]] * (len(sizes) - 2) + [K3_ACTS[(i + 1) % 4]]
    weights = _mlp(card, sizes, i, transposed)
    x = torch.tensor(np.random.default_rng(B).normal(size=(B, sizes[0])).astype(np.float32),
                     device=card)
    _k3_streamed(x, weights, acts)


def _misaligned(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("transposed", [True, False], ids=["out_in_view", "in_out"])
@pytest.mark.parametrize("act", K3_ACTS)
@pytest.mark.parametrize("B", [17, 257])
def test_k3_streamed_route_on_views_not_16_byte_aligned(card, B, act, transposed):
    """Weights and x whose pointers are not 16-byte aligned take the 4-byte
    copies; results as the aligned ones' bit for bit (the order of every sum
    is fixed)."""
    sizes = [10, 501, 500, 1]
    weights = _mlp(card, sizes, 3, transposed)
    odd = [((_misaligned(w.T).T if transposed else _misaligned(w)), b) for w, b in weights]
    x = torch.tensor(np.random.default_rng(B).normal(size=(B, 10)).astype(np.float32),
                     device=card)
    acts = [act, act, "linear"]
    y = _k3_streamed(_misaligned(x), odd, acts)
    assert torch.equal(y, fused_mlp.fused_mlp_forward(x, weights, acts))


def _nstep_inputs(device, capacity, R, term_dtype, seed, p_terminal=0.2):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(capacity,) if R == 1 else (capacity, 2, R // 2)).astype(np.float32)
    terminals = rng.random(capacity) < p_terminal
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


def _k4_matches(rewards, terminals, idx, horizon):
    launches = nstep_replay.nstep_rewards.launches
    got = nstep_replay.nstep_rewards(rewards, terminals, idx, horizon, 0.9)
    assert nstep_replay.nstep_rewards.launches == launches + 1
    want = nstep_replay.nstep_rewards_reference(rewards, terminals, idx, horizon, 0.9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("R", [1, 6])
@pytest.mark.parametrize("capacity,horizon", [(3, 8), (1, 5), (5, 64)])
def test_k4_window_longer_than_the_capacity(card, R, capacity, horizon):
    """capacity < horizon: the window wraps the store more than once, and
    where no terminal stops it, steps is the horizon."""
    got = _k4_matches(*_nstep_inputs(card, capacity, R, torch.uint8, 11, p_terminal=0.1),
                      horizon)
    assert int(got[1].max()) <= horizon


@pytest.mark.parametrize("R", [1, 6])
def test_k4_at_the_maximum_horizon(card, R):
    """H = 64 (MAX_HORIZON) with few terminals, so many windows run to the
    horizon and some wrap the capacity."""
    from reagent_tpu_torch.ops import _build

    H = 64
    assert _build.load_library("nstep_replay").nstep_max_horizon() == H
    got = _k4_matches(*_nstep_inputs(card, 1000, R, torch.bool, 12, p_terminal=0.01), H)
    assert int((got[1] == H).sum()) > 0


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


K5_SHAPES = [(512, 11), (37, 51), (9, 201), (1, 1), (3, 32), (5, 33), (2, 64), (9, 65),
             (1, 256), (3, 257), (2, 1536)]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kappa", [1.0, 0.5])
@pytest.mark.parametrize("B,N", K5_SHAPES)
def test_k5_matches_plain_version(card, B, N, kappa, dtype, ties):
    """Forward and backward against the plain version and its autograd, over
    block tails (B not a multiple of 8), warp tails (N not a multiple of 32),
    each register block of atoms (N up to 256 in one walk, past it in blocks
    of 256), the 16-byte target loads' tails and ties.  float32 sums in
    another order, with fma contraction: rtol 1e-5, atol 1e-6; a bfloat16
    gradient is one more rounding to 8 bits.  One forward launch, on the
    gradient route, and one backward launch."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    target, current = _k5_inputs(card, B, N, dtype, seed=B + N, ties=ties)
    c_kern = current.clone().requires_grad_(True)
    c_plain = current.clone().requires_grad_(True)
    counts = _k5_counts(qh)
    weights = torch.linspace(-1.0, 2.0, B, device=card)
    per_kern = qh.quantile_huber_per_sample(target, c_kern, kappa)
    per_plain = qh.quantile_huber_per_sample_reference(target, c_plain, kappa)
    assert per_kern.dtype == torch.float32 and per_kern.shape == (B,)
    torch.testing.assert_close(per_kern, per_plain, rtol=1e-5, atol=1e-6)
    (per_kern * weights).sum().backward()
    (per_plain * weights).sum().backward()
    assert _k5_counts(qh) == tuple(n + 1 for n in counts)
    assert c_kern.grad.dtype == dtype
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-5)
    torch.testing.assert_close(c_kern.grad, c_plain.grad, **tol)
    analytic = qh.quantile_huber_grad_reference(target, current, kappa, weights)
    torch.testing.assert_close(c_kern.grad, analytic, **tol)


def _k5_counts(qh):
    """(forward launches, of them on the gradient route, backward launches)."""
    f = qh.quantile_huber_loss
    return f.launches, f.sums_launches, f.backward_launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,N", [(4096, 51), (512, 11), (37, 201), (1, 65), (3, 1536)])
def test_k5_each_kernel_matches_its_plain_twin(card, B, N, dtype):
    """The loss-only forward and the forward with gradient sums give the same
    losses bit for bit; the sums within rtol 1e-5, atol 1e-6 N^2 of the plain
    sums (the gradient's bound in the sums' units); the backward scales the
    kernel's own sums within rtol 1e-6 of the plain scaling in float32 (a
    division against PyTorch's product with the reciprocal), rtol 1.6e-2,
    atol 1e-5 in bfloat16 (one more rounding to 8 bits)."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    target, current = _k5_inputs(card, B, N, dtype, seed=N, ties=False)
    loss_only, none = qh._launch_forward(target, current, 0.5, sums=False)
    per, sums = qh._launch_forward(target, current, 0.5, sums=True)
    assert none is None and sums.dtype == torch.float32 and sums.shape == (B, N)
    assert torch.equal(loss_only, per)
    torch.testing.assert_close(per, qh.quantile_huber_per_sample_reference(target, current, 0.5),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sums, qh.quantile_huber_sums_reference(target, current, 0.5),
                               rtol=1e-5, atol=1e-6 * N * N)
    for gps in (torch.linspace(-1.0, 2.0, B, device=card),
                torch.full((1,), 0.25, device=card).expand(B)):  # a broadcast, stride 0
        grad = qh._launch_scale(sums, gps, dtype)
        assert grad.dtype == dtype and grad.shape == (B, N)
        tol = dict(rtol=1e-6, atol=0.0) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-5)
        torch.testing.assert_close(grad, qh.quantile_huber_scale_reference(sums, gps, dtype), **tol)


@pytest.mark.parametrize("why", ["no_grad", "inference_mode", "no_requires_grad"])
def test_k5_without_a_gradient_takes_the_loss_only_route(card, why):
    """No [B, N] buffer where no gradient will be taken: one allocation (the
    [B] losses), no launch on the gradient route, the same losses bit for bit
    as the gradient route's."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    B, N = 4096, 51
    target, current = _k5_inputs(card, B, N, torch.float32, seed=5, ties=False)
    want = qh.quantile_huber_per_sample(target, current.clone().requires_grad_(True)).detach()
    c = current.clone().requires_grad_(why != "no_requires_grad")
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_requires_grad": torch.enable_grad}[why]
    torch.cuda.synchronize()
    counts = _k5_counts(qh)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with ctx():
        assert not qh.takes_gradient_route(c)
        got = qh.quantile_huber_per_sample(target, c)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 1
    assert torch.cuda.max_memory_allocated() - base < B * N * 4
    assert _k5_counts(qh) == (counts[0] + 1, counts[1], counts[2])
    assert got.grad_fn is None and torch.equal(got, want)


def test_k5_launches_once_each_way_per_train_step(card):
    """A QRDQNTrainer step on the card: one forward launch, on the gradient
    route, and one backward launch."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.net_builder.quantile_dqn import QuantileFullyConnected
    from reagent_tpu_torch.ops import quantile_huber as qh
    from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer

    B, D, A, atoms = 64, 6, 3, 11
    net = QuantileFullyConnected(sizes=[16], activations=["relu"], num_atoms=atoms)
    trainer = QRDQNTrainer(net.build_q_network(None, A, state_dim=D), atoms,
                           rl=RLParameters(gamma=0.9, target_update_rate=0.05), device="cuda")
    state = trainer.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    put = lambda a: torch.tensor(a, dtype=torch.float32, device=card)
    action = put(np.eye(A)[rng.integers(0, A, B)])
    batch = rlt.DiscreteDqnInput(
        state=rlt.FeatureData(put(rng.normal(size=(B, D)))),
        next_state=rlt.FeatureData(put(rng.normal(size=(B, D)))), action=action,
        next_action=action, reward=put(rng.normal(size=(B, 1))), time_diff=None, step=None,
        not_terminal=put(np.ones((B, 1))), possible_actions_mask=put(np.ones((B, A))),
        possible_next_actions_mask=put(np.ones((B, A))))
    for _ in range(2):
        counts = _k5_counts(qh)
        state, metrics = trainer.train_step(state, batch)
        assert _k5_counts(qh) == tuple(n + 1 for n in counts)
        assert torch.isfinite(metrics["td_loss"])


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


# --------------------------------------- checkpoints and the reporter's copy


def _card_states(device):
    """Trained states of the three trainer kinds on the card: the unfused
    DQNTrainer with its CPE heads, QRDQNTrainer (K5), FusedDQNTrainer on K1
    and on K2, each after two steps on a seeded batch."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.net_builder.quantile_dqn import QuantileFullyConnected
    from reagent_tpu_torch.training.dqn_trainer import DQNTrainer
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer
    from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer

    D, A, B = 9, 3, 64
    rng = np.random.default_rng(3)
    put = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    batch = rlt.DiscreteDqnInput(
        state=rlt.FeatureData(put(rng.normal(size=(B, D)))),
        next_state=rlt.FeatureData(put(rng.normal(size=(B, D)))),
        action=put(np.eye(A)[rng.integers(0, A, B)]),
        next_action=put(np.eye(A)[rng.integers(0, A, B)]),
        reward=put(rng.normal(size=(B, 1))), time_diff=None, step=None,
        not_terminal=put(rng.random((B, 1)) > 0.1),
        possible_actions_mask=put(np.ones((B, A))), possible_next_actions_mask=put(np.ones((B, A))))
    net = lambda: FullyConnectedDQN(state_dim=D, action_dim=A, sizes=[16, 8],
                                    activations=["relu", "relu"])
    kw = dict(rl=RLParameters(gamma=0.9), optimizer={"Adam": {"lr": 0.01}}, device=device)
    trainers = {
        "unfused_cpe": DQNTrainer(net(), reward_network=net(), q_network_cpe=net(), **kw),
        "qrdqn": QRDQNTrainer(
            QuantileFullyConnected(sizes=[8], activations=["relu"], num_atoms=5)
            .build_q_network(None, A, state_dim=D), num_atoms=5, **kw),
        "fused_K1": FusedDQNTrainer(net(), minibatch_size=B, block_size=32, **kw),
        "fused_K2": FusedDQNTrainer(net(), minibatch_size=B, **kw),
    }
    for name, trainer in trainers.items():
        state = trainer.init(torch.Generator().manual_seed(0))
        for _ in range(2):
            state, _ = trainer.train_step(state, batch)
        yield name, trainer, state


def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    """Each state restored from its checkpoint on the card, into a fresh
    template: every tensor equal (``torch.equal``) and on the card, the step
    counter int32."""
    from reagent_tpu_torch.utils.checkpointing import (
        flatten_state,
        restore_checkpoint,
        save_checkpoint,
    )

    for name, trainer, state in _card_states(card):
        path = str(tmp_path / name)
        save_checkpoint(path, state)
        restored = restore_checkpoint(path, trainer.init(torch.Generator().manual_seed(1)))
        got, want = flatten_state(restored), flatten_state(state)
        assert got.keys() == want.keys() and len(want) > 8, name
        for key, w in want.items():
            assert got[key].device == w.device and got[key].device.type == "cuda", (name, key)
            assert torch.equal(got[key], w), (name, key)
        assert restored.step.dtype == torch.int32 and int(restored.step) == 2, name


def test_values_to_host_on_the_card(card, monkeypatch):
    """A step's metrics on the card come to the host through one copy, each
    array equal to its tensor, of its dtype and shape."""
    from reagent_tpu_torch.core.tracker import values_to_host

    values = {"loss": torch.tensor(0.5, device=card),
              "idx": torch.tensor([3, 0, 2**40], device=card),
              "q": torch.randn(64, 3, device=card), "mask": torch.rand(5, device=card) > 0.5,
              "half": torch.ones(3, device=card, dtype=torch.bfloat16), "none": None}
    calls = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *args, **kwargs):
        calls.append(self.device.type)
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    host = values_to_host(values)
    monkeypatch.undo()
    assert calls == ["cuda"] and host["none"] is None
    for key in ("loss", "idx", "q", "mask"):
        want = values[key].cpu().numpy()
        assert host[key].dtype == want.dtype and host[key].shape == want.shape, key
        np.testing.assert_array_equal(host[key], want)
    np.testing.assert_array_equal(host["half"], np.ones(3, np.float32))
