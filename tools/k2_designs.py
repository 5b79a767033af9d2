#!/usr/bin/env python3
"""Time K2 (the fused DQN update at the online shapes) as this checkout's
``fused_dqn.cu`` builds it against other copies of that source, on one
NVIDIA card.

    mkdir -p .chip_checkout
    git show HEAD~1:reagent_tpu_torch/ops/csrc/fused_dqn.cu > .chip_checkout/parent.cu
    python3 tools/k2_designs.py .chip_checkout/parent.cu

Builds every source (nvcc, sm_90a; ``-Xptxas -v`` for this checkout's
one-launch kernel), holds this checkout's K2 and K2-packed against their
plain versions at the CartPole shapes (``chip_smoke.compare_kernel`` and
``compare_k2_packed``), compares 5 updates through each library from one
state, then times K2 and K2-packed through each library in
turns (the others, this, this, the others in reverse; CUDA events, 3
warm-ups, median of 20) with the CUDA kernels per update and the wrapper's
host time per call, and profiles one update of each.  Another source must
keep the C interface of ``csrc/fused_dqn.cu``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def ptxas_report(src: Path, kernel: str) -> str:
    """What ``-Xptxas -v`` says of ``kernel``: registers, shared memory, spills."""
    from reagent_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), str(src)],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    keep = [i for i, line in enumerate(lines) if kernel in line]
    return "\n".join(lines[j] for i in keep for j in range(i, min(i + 3, len(lines))))


def use(lib) -> None:
    """Route the wrappers through ``lib``; its workspace sizes are its own."""
    from reagent_tpu_torch.ops import _build, fused_dqn

    _build._loaded["fused_dqn"] = lib
    fused_dqn._WORKSPACE_FLOATS.clear()


def same_updates(torch, lib_a, lib_b) -> str:
    """Max abs difference of the metrics and of params8 after 5 K2 updates
    (CartPole shapes, double-Q) through each library from one state."""
    kern, _, kw = cs.kernel_fns(cs.CARTPOLE, True)
    _, batch, params = cs.make_inputs(cs.CARTPOLE, 1234, torch, cs.DEVICE)
    runs = []
    for lib in (lib_a, lib_b):
        use(lib)
        p = [x.clone() for x in params]
        ms = [kern(*cs.step_scalars(torch, step, cs.CARTPOLE["lr"], cs.DEVICE), *batch, p, **kw)
              for step in range(5)]
        runs.append((torch.cat(ms), p))
    (m_a, p_a), (m_b, p_b) = runs
    dp = max((a - b).abs().max().item() for a, b in zip(p_a, p_b))
    return (f"metrics max abs {(m_a - m_b).abs().max().item():.3e}, params8 max abs {dp:.3e}"
            f" (bit for bit: {all(torch.equal(a, b) for a, b in zip(p_a, p_b))})")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_designs: needs an NVIDIA card", file=sys.stderr)
        return 2
    from reagent_tpu_torch.ops import _build, fused_dqn

    torch.backends.cuda.matmul.allow_tf32 = False
    card, name = cs.card_line(), torch.cuda.get_device_name(0)
    cs.log(card)
    this_src = _build.CSRC / "fused_dqn.cu"
    cs.log(ptxas_report(this_src, "k2_one_launch_kernel"))
    libs = {"this": _build.load_library("fused_dqn")}
    for path in argv:
        libs[path] = _build.bind(Path(path), "fused_dqn")

    cs.log("this checkout's K2 and K2-packed against their plain versions:")
    err = cs.compare_kernel("K2", cs.CARTPOLE, torch)
    err_p = cs.compare_k2_packed(torch)
    cs.log(f"  max abs K2 {err:.3e}, K2-packed {err_p:.3e}")

    for label in argv:
        cs.log(f"  this against {label}, 5 updates from one state: "
               + same_updates(torch, libs["this"], libs[label]))

    order = list(argv) + ["this", "this"] + list(reversed(argv))
    for label in order:
        use(libs[label])
        ms, plain_ms, b_ms, b_by, _, _ = cs.time_kernel(cs.CARTPOLE, torch, name)
        ms_p = cs.time_k2_packed(torch, name)[0]
        kern, _ = cs.k2_packed_call(torch)
        host_us = cs.host_us_per_call(torch, kern)
        cs.log(f"  {label}: K2 {ms:.4f} ms, K2-packed {ms_p:.4f} ms, "
               f"{fused_dqn.fused_dqn_update.kernels_per_update} CUDA kernels per update, "
               f"K2-packed wrapper {host_us:.1f} us of host time per call; plain "
               f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), on {card}")
    for label in libs:
        use(libs[label])
        cs.log(f"  {label}: device time by CUDA kernel (torch.profiler, mean of 5 updates):")
        cs.profile_update(cs.CARTPOLE, torch)
    use(libs["this"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
