"""K5's plain versions and analytic gradient against the JAX package.

The plain PyTorch pairwise formulation is held to the Pallas kernel in
interpret mode and to ``quantile_huber_loss_xla``; the analytic gradient (the
formula the CUDA kernels implement: the gradient sums the forward writes,
then the backward's scaling, each with its plain twin) to ``jax.grad`` and
``jax.vjp`` of the XLA formulation and to autograd of the plain version, on
inputs that include ties (``td == 0``, ``|td| == kappa``, whole target rows
equal).  The route the wrapper takes on a CUDA tensor (gradient sums or the
loss alone) is decided here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.ops.quantile_huber import (
    quantile_huber_loss as jax_quantile_huber_loss,
    quantile_huber_loss_xla,
)
from reagent_tpu_torch.ops.quantile_huber import (
    quantile_huber_grad_reference,
    quantile_huber_loss,
    quantile_huber_loss_reference,
    quantile_huber_per_sample,
    quantile_huber_scale_reference,
    quantile_huber_sums_reference,
    takes_gradient_route,
)

SHAPES = [(64, 11), (37, 51), (8, 201)]  # 37 is no multiple of the TPU row block


def _inputs(B, N, seed, ties=False):
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(B, N)).astype(np.float32) * 2.0
    current = rng.normal(size=(B, N)).astype(np.float32) * 2.0
    if ties:
        # quarter-steps are exact in float32 and bfloat16, so td lands
        # exactly on 0, on +-0.5 and on +-1.0
        target = np.round(target * 4) / 4
        current = np.round(current * 4) / 4
        target[::3] = 1.0  # a terminal row: every target atom is the reward
        current[0] = target[0]
    return target, current


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kappa", [1.0, 0.5])
@pytest.mark.parametrize("B,N", SHAPES)
def test_plain_version_matches_pallas_and_xla(B, N, kappa, dtype):
    """float32 sums in another order: rtol 1e-5, atol 1e-6.  bfloat16 inputs
    are cast to float32 inside both, so the same bound holds."""
    target, current = _inputs(B, N, seed=B + N, ties=(N == 51))
    if dtype == "bfloat16":
        t_t, c_t = _bf16(target), _bf16(current)
        t_j = jnp.asarray(t_t.float().numpy()).astype(jnp.bfloat16)
        c_j = jnp.asarray(c_t.float().numpy()).astype(jnp.bfloat16)
    else:
        t_t, c_t = torch.tensor(target), torch.tensor(current)
        t_j, c_j = jnp.asarray(target), jnp.asarray(current)
    ours = quantile_huber_loss(t_t, c_t, kappa)
    assert ours.dtype == torch.float32 and ours.shape == ()
    pallas = jax_quantile_huber_loss(
        t_j, c_j, kappa=kappa, block_b=16, use_kernel=True, interpret=True)
    xla = quantile_huber_loss_xla(t_j.astype(jnp.float32), c_j.astype(jnp.float32), kappa)
    np.testing.assert_allclose(float(ours), float(pallas), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ours), float(xla), rtol=1e-5, atol=1e-6)
    # the wrapper on a CPU tensor is the plain version
    assert float(ours) == float(quantile_huber_loss_reference(t_t, c_t, kappa))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("kappa", [1.0, 0.5])
@pytest.mark.parametrize("B,N", SHAPES)
def test_analytic_gradient_matches_jax_grad_and_autograd(B, N, kappa, ties):
    """The backward kernel's formula, the plain version's autograd and
    ``jax.grad`` of the XLA formulation: rtol 1e-5, atol 1e-7 (each element
    is a float32 sum of N terms scaled by 1 / (B N^2))."""
    target, current = _inputs(B, N, seed=3 * B + N, ties=ties)
    want = np.asarray(jax.grad(
        lambda c: quantile_huber_loss_xla(jnp.asarray(target), c, kappa))(jnp.asarray(current)))
    c_t = torch.tensor(current, requires_grad=True)
    quantile_huber_loss(torch.tensor(target), c_t, kappa).backward()
    analytic = quantile_huber_grad_reference(
        torch.tensor(target), torch.tensor(current), kappa, torch.full((B,), 1.0 / B))
    np.testing.assert_allclose(c_t.grad.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(analytic.numpy(), want, rtol=1e-5, atol=1e-7)
    if ties:
        assert np.isfinite(want).all()
        # a row equal to its target pulls each atom only by the other atoms
        assert analytic.shape == (B, N)


def test_gradient_at_zero_td_is_zero():
    """One atom, td == 0: the quadratic branch's derivative, not kappa * sign(0)."""
    c = torch.tensor([[0.75]], requires_grad=True)
    t = torch.tensor([[0.75]])
    quantile_huber_loss(t, c).backward()
    assert float(c.grad) == 0.0
    assert float(quantile_huber_grad_reference(t, c.detach(), 1.0, torch.ones(1))) == 0.0
    want = jax.grad(lambda x: quantile_huber_loss_xla(jnp.asarray([[0.75]]), x))(
        jnp.asarray([[0.75]]))
    assert float(want[0, 0]) == 0.0


def test_per_sample_weights_the_incoming_gradient():
    target, current = _inputs(5, 11, seed=1)
    c = torch.tensor(current, requires_grad=True)
    w = torch.tensor([0.0, 1.0, -2.0, 0.5, 3.0])
    (quantile_huber_per_sample(torch.tensor(target), c) * w).sum().backward()
    analytic = quantile_huber_grad_reference(torch.tensor(target), c.detach(), 1.0, w)
    np.testing.assert_allclose(c.grad.numpy(), analytic.numpy(), rtol=1e-5, atol=1e-7)
    assert not c.grad[0].any()


def test_bfloat16_gradient_comes_back_in_bfloat16():
    target, current = _inputs(6, 11, seed=2)
    c = _bf16(current).requires_grad_(True)
    quantile_huber_loss(_bf16(target), c).backward()
    assert c.grad.dtype == torch.bfloat16
    analytic = quantile_huber_grad_reference(
        _bf16(target), c.detach(), 1.0, torch.full((6,), 1.0 / 6))
    assert analytic.dtype == torch.bfloat16
    # both round one float32 value to bfloat16 (8 bits of mantissa)
    np.testing.assert_allclose(
        c.grad.float().numpy(), analytic.float().numpy(), rtol=1e-2, atol=1e-6)


def test_strided_rows_and_checks():
    target, current = _inputs(6, 11, seed=4)
    wide = torch.tensor(np.concatenate([current, current], axis=1))
    got = quantile_huber_loss(torch.tensor(target), wide[:, :11])
    assert float(got) == float(quantile_huber_loss(torch.tensor(target), torch.tensor(current)))
    with pytest.raises(ValueError, match="no gradient"):
        quantile_huber_loss(torch.tensor(target, requires_grad=True), torch.tensor(current))
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        quantile_huber_loss(torch.tensor(target)[:, :5], torch.tensor(current))
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        quantile_huber_loss(torch.tensor(target), _bf16(current))
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        quantile_huber_loss(torch.tensor(target).double(), torch.tensor(current).double())


def _per_sample_xla(target, current, kappa):
    """Per-sample losses [B] of the XLA formulation: its mean over one row."""
    return jax.vmap(lambda t, c: quantile_huber_loss_xla(t[None], c[None], kappa))(
        jnp.asarray(target), current)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("kappa", [1.0, 0.5])
@pytest.mark.parametrize("B,N", SHAPES)
def test_split_gradient_references_match_jax_vjp(B, N, kappa, ties):
    """The forward's plain gradient sums and the backward's plain scaling
    against ``jax.vjp`` of the per-sample XLA formulation.  The sums are
    ``-N^2`` times the vjp of a ones cotangent: each a float32 sum of N terms
    within kappa, rtol 1e-5, atol 1e-6 N; the scaled sums are the vjp of a
    cotangent with both signs, one of them a zero, and a broadcast one:
    rtol 1e-5, atol 1e-7 (as the analytic gradient above)."""
    target, current = _inputs(B, N, seed=5 * B + N, ties=ties)
    _, vjp = jax.vjp(lambda c: _per_sample_xla(target, c, kappa), jnp.asarray(current))
    sums = quantile_huber_sums_reference(torch.tensor(target), torch.tensor(current), kappa)
    assert sums.dtype == torch.float32 and sums.shape == (B, N)
    (ones,) = vjp(jnp.ones((B,), jnp.float32))
    np.testing.assert_allclose(sums.numpy(), -np.asarray(ones) * N * N, rtol=1e-5, atol=1e-6 * N)
    gps = np.linspace(-1.0, 2.0, B).astype(np.float32)
    gps[0] = 0.0
    for g in (torch.tensor(gps), torch.full((1,), 0.25).expand(B)):
        (want,) = vjp(jnp.asarray(g.numpy()))
        got = quantile_huber_scale_reference(sums, g, torch.float32)
        assert got.dtype == torch.float32 and got.shape == (B, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert not quantile_huber_scale_reference(sums, torch.tensor(gps), torch.float32)[0].any()


@pytest.mark.parametrize("mode,requires_grad,want", [
    ("grad", True, True),
    ("grad", False, False),
    ("no_grad", True, False),
    ("inference_mode", True, False),
])
def test_gradient_route_only_where_autograd_will_ask(mode, requires_grad, want):
    """On a CUDA tensor the forward writes the [B, N] gradient sums only with
    grad mode on and ``current.requires_grad``; under ``torch.no_grad()``
    autograd's ``needs_input_grad`` would still read True, so the wrapper
    decides before it.  A CPU tensor takes the plain version on every route
    and launches nothing."""
    target, current = _inputs(4, 11, seed=6)
    c = torch.tensor(current, requires_grad=requires_grad)
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[mode]
    launches = (quantile_huber_loss.launches, quantile_huber_loss.sums_launches,
                quantile_huber_loss.backward_launches)
    calls = quantile_huber_loss_reference.calls
    with ctx():
        assert takes_gradient_route(c) is want
        per = quantile_huber_per_sample(torch.tensor(target), c)
    assert per.requires_grad is want
    assert quantile_huber_loss_reference.calls == calls + 1
    assert launches == (quantile_huber_loss.launches, quantile_huber_loss.sums_launches,
                        quantile_huber_loss.backward_launches)
