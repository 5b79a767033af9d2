"""K3's plain version held to the JAX package's Pallas kernel in interpret
mode at the widths of the nets that take the port's streamed route: the OPE
slice's NNTrainer (8 -> 500 -> 500 -> 1 and the MSLR sample's 10 -> 500 ->
500 -> 1), a Bayes-by-backprop sample (136 -> 512 -> 1 on contiguous
``[in, out]`` weights) and the full offline width of the imitator gate and
the evaluation (128 -> 512 -> 256 -> 8 on ``W^T`` views of ``[out, in]``).
A few rows each, from numpy seeds, one JAX compile a case.  The streamed
kernel itself runs on the card (``tests/test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reagent_tpu.ops.fused_mlp import fused_mlp_forward as jax_fused_mlp_forward
from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward, fused_mlp_forward_reference

RELU_NET = ["relu", "relu", "linear"]
GATE = ["leaky_relu", "leaky_relu", "linear"]
# id -> (rows, sizes, activations, W^T views of [out, in] (else [in, out]))
CASES = {
    "nntrainer-8-500-500-1": (5, [8, 500, 500, 1], RELU_NET, True),
    "mslr-10-500-500-1": (3, [10, 500, 500, 1], RELU_NET, True),
    "bbb-sample-136-512-1-in-out": (4, [136, 512, 1], ["relu", "linear"], False),
    "gate-128-512-256-8": (6, [128, 512, 256, 8], GATE, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k3_plain_version_matches_pallas_kernel_at_streamed_widths(case):
    """Float32 products of up to 512 terms summed in another order: rtol
    1e-5, atol 1e-5.  The CPU wrapper takes the plain version."""
    rows, sizes, acts, transposed = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    w_out_in = [(rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32)
                for i, o in zip(sizes[:-1], sizes[1:])]
    biases = [(rng.normal(size=o) * 0.1).astype(np.float32) for o in sizes[1:]]
    x = rng.normal(size=(rows, sizes[0])).astype(np.float32)
    want = jax_fused_mlp_forward(
        jnp.asarray(x), [(jnp.asarray(w.T), jnp.asarray(b)) for w, b in zip(w_out_in, biases)],
        acts, interpret=True)
    weights = [(torch.tensor(w).T if transposed else torch.tensor(np.ascontiguousarray(w.T)),
                torch.tensor(b)) for w, b in zip(w_out_in, biases)]
    got = fused_mlp_forward_reference(torch.tensor(x), weights, acts)
    assert got.shape == (rows, sizes[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    calls = fused_mlp_forward_reference.calls
    assert torch.equal(fused_mlp_forward(torch.tensor(x), weights, acts), got)
    assert fused_mlp_forward_reference.calls == calls + 1
