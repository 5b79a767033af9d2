#!/usr/bin/env python3
"""Time K1 (the fused DQN update at the full offline width, float32 and with
its bfloat16 options) as this checkout's ``fused_dqn.cu`` builds it against
other copies of that source, on one NVIDIA card.

    mkdir -p .chip_checkout
    git show HEAD~1:reagent_tpu_torch/ops/csrc/fused_dqn.cu > .chip_checkout/parent.cu
    python3 tools/k1_designs.py .chip_checkout/parent.cu

Prints ``-Xptxas -v`` for this checkout's product kernels (registers,
spills); compares 5 updates from one state through each library bit for bit
(metrics and params8) at B = 4,096 and at the DQN benchmark cell's 16,384:
K1 float32 double- and single-Q (leaky_relu; relu and tanh at 4,096), K1
with each (matmul, save) pair (those with float32 products at both
batches, those with bfloat16 products at 4,096), K2's launch sequence
(``chip_smoke.K2_LARGE``) and K2's one launch (``chip_smoke.CARTPOLE``),
whose Adam step shares code; holds this
checkout's K1 and K1-bf16 against their plain versions
(``chip_smoke.compare_kernel``, ``compare_k1_bf16``; exits 1 where any
comparison differs or a plain version's fails); counts the products
each tile route took in one update (``fused_dqn_offline.product_routes``);
times K1 at both batches, K1-bf16 and K2's launch sequence through each
library in turns (the others, this, this, the others in reverse; CUDA
events, 3 warm-ups, median of 20) with the CUDA kernels per update; and
profiles one update through each library at both batches by CUDA kernel,
with each kind of product's device time, TFLOP/s and share of the f32 peak
(forwards, weight gradients and dh, the wide and the narrow tiles apart).
Another source must keep the C interface of ``csrc/fused_dqn.cu``; an entry
it lacks is left unbound.  Reuses ``tools/k2_designs.py``'s helpers.
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke as cs  # noqa: E402
from k2_designs import bind, ptxas_report, use  # noqa: E402

BATCHES = (("B=4096", cs.FULL), ("B=16384", cs.K1_CELL))
NARROW = 64  # csrc/fused_dqn.cu: N at or below this takes the narrow tile or the row kernel
KINDS = ("forward", "forward narrow", "weight gradient", "weight gradient narrow", "dh",
         "dh narrow")
_PRODUCT = re.compile(r"(gemm_ring_kernel|gemm_f32_kernel)<([^>]*)>|gemm_rows_kernel")


def product_kind(kernel: str):
    """The kind of product a float32 product kernel's name says it ran, or
    None for any other kernel: the epilogue (its first template argument)
    and whether the tile is a narrow one (gemm_f32_kernel's BN of 16, or
    gemm_rows_kernel, a forward's)."""
    m = _PRODUCT.search(kernel)
    if m is None:
        return None
    if m.group(1) is None:
        return "forward narrow"
    args = [a.strip() for a in m.group(2).split(",")]
    kind = ("forward", "dh", "weight gradient")[int(args[0])]
    narrow = m.group(1) == "gemm_f32_kernel" and int(args[3]) <= 16
    return kind + (" narrow" if narrow else "")


def kind_flops(cfg, double_q=True):
    """``chip_smoke.layer_work``'s FLOPs of one float32 update by the kind
    of product the launch sequence makes of each: N <= 64 takes a narrow
    tile (the weight gradient of a layer with few outputs as h_prev^T . dz,
    N = out)."""
    out = defaultdict(float)
    for fan_in, n_out, fwd, wgrad, dh in cs.layer_work(cfg, double_q):
        out["forward" + (" narrow" if n_out <= NARROW else "")] += fwd
        gw_n = n_out if n_out <= NARROW and n_out < fan_in else fan_in
        out["weight gradient" + (" narrow" if gw_n <= NARROW else "")] += wgrad
        out["dh" + (" narrow" if fan_in <= NARROW else "")] += dh
    return out


def by_kind(torch, cfg, peak_f32, n=5):
    """Profile n double-Q float32 updates (torch.profiler), log the last
    update's launches in order, the device time by CUDA kernel and each kind
    of product's rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kern, _, kw = cs.kernel_fns(cfg, True)
    _, batch, params = cs.make_inputs(cfg, 5, torch, "cuda")
    lr_t, eps_t = cs.step_scalars(torch, 0, cfg["lr"], "cuda")
    kern(lr_t, eps_t, *batch, params, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            kern(lr_t, eps_t, *batch, params, **kw)
        torch.cuda.synchronize()
    kernels = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
    per = len(kernels) // n
    cs.log("    the last update's launches in order:")
    for ev in kernels[-per:]:
        m = _PRODUCT.search(ev.name)
        cs.log(f"      {ev.time_range.elapsed_us():9.2f} us  "
               f"{m.group(0) if m else ev.name.split('(')[0][-60:]}")
    rows, _ = cs.profiled_rows(prof, n)
    us_by = defaultdict(float)
    for us, count, key in rows:
        cs.log(f"    {us:9.2f} us  x{count:<5.1f} {key[:100]}")
        kind = product_kind(key)
        if kind is not None:
            us_by[kind] += us
    cs.log(f"    {sum(r[0] for r in rows):9.2f} us  device time per update (sum of kernels)")
    flops = kind_flops(cfg)
    for kind in KINDS:
        if flops[kind] or us_by[kind]:
            rate = flops[kind] / (us_by[kind] * 1e-6) if us_by[kind] else 0.0
            cs.log(f"    {kind:24s} {us_by[kind]:9.2f} us  {flops[kind] / 1e9:8.3f} GFLOP  "
                   f"{rate / 1e12:6.2f} TFLOP/s  {100 * rate / peak_f32:5.1f}% of the f32 peak")


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
    cs.log(f"    B={cfg['B']} {cfg['act']} double_q={double_q} dtypes={dtypes}: metrics max abs "
           f"{(m_a - m_b).abs().max().item():.3e}, params8 max abs {dp:.3e} (bit for bit: {same})")
    return same


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_designs: needs an NVIDIA card", file=sys.stderr)
        return 2
    from reagent_tpu_torch.ops import _build, fused_dqn, fused_dqn_offline

    torch.backends.cuda.matmul.allow_tf32 = False
    card, name = cs.card_line(), torch.cuda.get_device_name(0)
    bf16, f32 = torch.bfloat16, torch.float32
    peak_f32 = cs.peaks_for(name)[0]
    cs.log(card)
    this_src = _build.CSRC / "fused_dqn.cu"
    with ThreadPoolExecutor(max_workers=len(argv) + 2) as pool:  # every nvcc build at once
        report = pool.submit(ptxas_report, this_src, "gemm_")
        list(pool.map(_build._compile, [this_src, *map(Path, argv)]))
        cs.log(report.result())  # the ring, rows, f32 and mma product kernels
    libs = {"this": _build.load_library("fused_dqn")}
    for path in argv:
        libs[path] = bind(Path(path), "fused_dqn")

    cases = [(cfg, dq, None) for _, cfg in BATCHES for dq in (True, False)]
    cases += [(cfg, dq, (f32, bf16)) for _, cfg in BATCHES for dq in (True, False)]
    cases += [(dict(cs.FULL, act=act), True, None) for act in ("relu", "tanh")]
    cases += [(cs.FULL, True, (bf16, bf16)), (cs.FULL, True, (bf16, f32)),
              (cs.K2_LARGE, True, None), (cs.K2_LARGE, False, None), (cs.CARTPOLE, True, None)]
    differ = 0
    for label in argv:
        cs.log(f"  this against {label}, 5 updates from one state (K1 at B=4096 and 16384; "
               "then K2's launch sequence and K2's one launch):")
        for cfg, double_q, dtypes in cases:
            differ += not same_updates(torch, libs["this"], libs[label], cfg, double_q, dtypes)
    use(libs["this"])

    cs.log("this checkout's K1 and K1-bf16 against their plain versions:")
    for label, check in (
            ("K1", lambda: cs.compare_kernel("K1", cs.FULL, torch, cs.LAUNCH_SEQUENCE)),
            ("K1 at B=16384", lambda: cs.compare_kernel("K1 B=16384", cs.K1_CELL, torch,
                                                        cs.LAUNCH_SEQUENCE)),
            ("K1-bf16", lambda: cs.compare_k1_bf16(torch, (bf16, bf16), "K1-bf16"))):
        try:
            cs.log(f"  {label}: max abs {check():.3e}")
        except AssertionError as e:  # counted as a difference; the timings still run
            cs.log(f"  {label}: outside chip_smoke's tolerance: {str(e)[:300]}")
            differ += 1

    for label, cfg in BATCHES + (("K2 launch sequence B=512", cs.K2_LARGE),):
        kern, _, kw = cs.kernel_fns(cfg, True)
        _, batch, params = cs.make_inputs(cfg, 7, torch, "cuda")
        before = fused_dqn_offline.product_routes()
        kern(*cs.step_scalars(torch, 0, cfg["lr"], "cuda"), *batch, params, **kw)
        torch.cuda.synchronize()
        after = fused_dqn_offline.product_routes()
        cs.log(f"  products by tile route, one double-Q update at {label}: "
               f"{ {k: after[k] - before[k] for k in after if after[k] != before[k]} }")

    k1 = fused_dqn_offline.fused_dqn_offline_update
    for label, cfg in BATCHES:
        kern, plain, kw = cs.kernel_fns(cfg, True)
        _, batch, params = cs.make_inputs(cfg, 99, torch, "cuda")
        lr_t, eps_t = cs.step_scalars(torch, 0, cfg["lr"], "cuda")
        plain_ms = cs.time_ms(torch, lambda: plain(lr_t, eps_t, *batch, params, **kw))
        b_ms, b_by, flops, _ = cs.bound(cfg, True, name)
        cs.log(f"  K1 at {label}: plain version {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
               f"{flops / 1e9:.2f} GFLOP)")
    order = list(argv) + ["this", "this"] + list(reversed(argv))
    for label in order:
        use(libs[label])
        times = []
        for _, cfg in BATCHES + (("K2", cs.K2_LARGE),):
            kern, _, kw = cs.kernel_fns(cfg, True)
            _, batch, params = cs.make_inputs(cfg, 99, torch, "cuda")
            lr_t, eps_t = cs.step_scalars(torch, 0, cfg["lr"], "cuda")
            times.append(cs.time_ms(torch, lambda: kern(lr_t, eps_t, *batch, params, **kw)))
        ms_bf = cs.time_kernel(cs.FULL, torch, name, (bf16, bf16))[0]
        cs.log(f"  {label}: K1 {times[0]:.4f} ms at B=4096, {times[1]:.4f} ms at B=16384 "
               f"({k1.kernels_per_update} CUDA kernels per update); K2's launch sequence "
               f"{times[2]:.4f} ms ({fused_dqn.fused_dqn_update.kernels_per_update}); "
               f"K1-bf16 {ms_bf:.4f} ms ({k1.bf16_kernels_per_update}), on {card}")
    for label in libs:
        use(libs[label])
        for blabel, cfg in BATCHES:
            cs.log(f"  {label}, f32 at {blabel}: device time by CUDA kernel "
                   "(torch.profiler, mean of 5 updates), then by kind of product:")
            by_kind(torch, cfg, peak_f32)
        cs.log(f"  {label}, bf16 at B=4096: device time by CUDA kernel:")
        cs.profile_update(cs.FULL, torch, dtypes=(bf16, bf16))
    use(libs["this"])
    if differ:
        cs.log(f"k1_designs: {differ} comparisons differ or fail their plain version")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
