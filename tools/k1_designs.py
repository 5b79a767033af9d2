#!/usr/bin/env python3
"""Time K1 (the fused DQN update at the full offline width, float32 and with
its bfloat16 options) as this checkout's ``fused_dqn.cu`` builds it against
other copies of that source, on one NVIDIA card.

    mkdir -p .chip_checkout
    git show HEAD~1:reagent_tpu_torch/ops/csrc/fused_dqn.cu > .chip_checkout/parent.cu
    python3 tools/k1_designs.py .chip_checkout/parent.cu

Prints ``-Xptxas -v`` for this checkout's GEMM kernels (registers, spills);
compares 5 updates from one state through each library bit for bit
(metrics and params8): K1 float32 double- and single-Q, K1 with each
(matmul, save) pair that has a bfloat16 side, K2's launch sequence
(``chip_smoke.K2_LARGE``) and K2's one launch (``chip_smoke.CARTPOLE``),
whose Adam step shares code; holds this checkout's K1 and K1-bf16 against
their plain versions (``chip_smoke.compare_kernel``, ``compare_k1_bf16``);
times K1 and K1-bf16 through each library in turns (the others, this,
this, the others in reverse; CUDA events, 3 warm-ups, median of 20) with
the CUDA kernels per update; and profiles one update of each by CUDA
kernel.  Another source must keep the C interface of ``csrc/fused_dqn.cu``.
Reuses ``tools/k2_designs.py``'s helpers.
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke as cs  # noqa: E402
from k2_designs import ptxas_report, use  # noqa: E402


def same_updates(torch, lib_a, lib_b, cfg, double_q, dtypes=None) -> bool:
    """Log the max abs difference of the metrics and of params8 after 5
    updates through each library from one state; True if bit for bit."""
    kern, _, kw = cs.kernel_fns(cfg, double_q, dtypes)
    _, batch, params = cs.make_inputs(cfg, 1234, torch, cs.DEVICE)
    runs = []
    for lib in (lib_a, lib_b):
        use(lib)
        p = [x.clone() for x in params]
        ms = [kern(*cs.step_scalars(torch, step, cfg["lr"], cs.DEVICE), *batch, p, **kw)
              for step in range(5)]
        runs.append((torch.cat(ms), p))
    (m_a, p_a), (m_b, p_b) = runs
    dp = max((a - b).abs().max().item() for a, b in zip(p_a, p_b))
    same = torch.equal(m_a, m_b) and all(torch.equal(a, b) for a, b in zip(p_a, p_b))
    cs.log(f"    double_q={double_q} dtypes={dtypes}: metrics max abs "
           f"{(m_a - m_b).abs().max().item():.3e}, params8 max abs {dp:.3e} (bit for bit: {same})")
    return same


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_designs: needs an NVIDIA card", file=sys.stderr)
        return 2
    from reagent_tpu_torch.ops import _build, fused_dqn_offline

    torch.backends.cuda.matmul.allow_tf32 = False
    card, name = cs.card_line(), torch.cuda.get_device_name(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cs.log(card)
    this_src = _build.CSRC / "fused_dqn.cu"
    cs.log(ptxas_report(this_src, "gemm_"))  # gemm_f32_kernel and mma_gemm_kernel
    libs = {"this": _build.load_library("fused_dqn")}
    for path in argv:
        libs[path] = _build.bind(Path(path), "fused_dqn")

    cases = [(cs.FULL, True, None), (cs.FULL, False, None),
             (cs.FULL, True, (bf16, bf16)), (cs.FULL, True, (bf16, f32)),
             (cs.FULL, True, (f32, bf16)), (cs.K2_LARGE, True, None),
             (cs.CARTPOLE, True, None)]
    for label in argv:
        cs.log(f"  this against {label}, 5 updates from one state (K1 at full width; "
               "then K2's launch sequence and K2's one launch):")
        for cfg, double_q, dtypes in cases:
            same_updates(torch, libs["this"], libs[label], cfg, double_q, dtypes)
    use(libs["this"])

    cs.log("this checkout's K1 and K1-bf16 against their plain versions:")
    err = cs.compare_kernel("K1", cs.FULL, torch, cs.LAUNCH_SEQUENCE)
    err_bf = cs.compare_k1_bf16(torch, (bf16, bf16), "K1-bf16")
    cs.log(f"  max abs K1 {err:.3e}, K1-bf16 {err_bf:.3e}")

    k1 = fused_dqn_offline.fused_dqn_offline_update
    order = list(argv) + ["this", "this"] + list(reversed(argv))
    for label in order:
        use(libs[label])
        ms, plain_ms, b_ms, b_by, _, _ = cs.time_kernel(cs.FULL, torch, name)
        ms_bf, _, b_bf, _, _, _ = cs.time_kernel(cs.FULL, torch, name, (bf16, bf16))
        cs.log(f"  {label}: K1 {ms:.4f} ms ({k1.kernels_per_update} CUDA kernels per update), "
               f"K1-bf16 {ms_bf:.4f} ms ({k1.bf16_kernels_per_update}); bounds {b_ms:.4f} ms "
               f"({b_by}), {b_bf:.4f} ms (bf16 tensor cores); plain f32 {plain_ms:.4f} ms, "
               f"on {card}")
    for label in libs:
        use(libs[label])
        for dtypes in (None, (bf16, bf16)):
            cs.log(f"  {label}, dtypes {dtypes}: device time by CUDA kernel "
                   "(torch.profiler, mean of 5 updates):")
            cs.profile_update(cs.FULL, torch, dtypes=dtypes)
    use(libs["this"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
