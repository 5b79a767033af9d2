#!/usr/bin/env python3
"""Compare K5 (the pairwise quantile-Huber loss and its gradient) as this
checkout's ``quantile_huber.cu`` builds it against other copies of that
source, on one NVIDIA card.

    mkdir -p .chip_checkout
    git show HEAD~1:reagent_tpu_torch/ops/csrc/quantile_huber.cu > .chip_checkout/quantile_huber.cu
    python3 tools/k5_designs.py .chip_checkout/quantile_huber.cu

Prints ``-Xptxas -v`` for every kernel of each source (registers, shared
memory, spills) and, from ``cuobjdump -sass``, the instructions of each
kernel's hottest loop per (target, current) pair at the main path's atom
counts.  Then holds this checkout's results against each other source's
bit for bit at every case (``cases``: the three ``chip_smoke.K5_SHAPES``,
N = 1, 32, 33, 64, 65, 256, 257 and 1536, B = 1 and 37 (no multiple of the
8 warps of a block), float32 and bfloat16, kappa 1 and 0.5, random inputs
and ``chip_smoke.k5_inputs(ties=True)``, strided rows, an expanded target
row and a broadcast incoming gradient): this checkout's loss-only forward
and its forward with gradient sums against the other's forward, and its
backward (the sums scaled) against the other's.  Another source either
recomputes the gradient from the inputs (``quantile_huber_backward``, as
the design before the gradient sums did) or has this checkout's entries.
Then times each library in turns (the others, this, this, the others in
reverse; CUDA events, 3 warm-ups, median of 20) at the three shapes: the
loss-only forward, the forward with sums, the backward, and the trainer's
pair (its forward and backward in one timed window), beside the queued
launch floor (an empty kernel) and the bounds of ``chip_smoke.k5_bounds``,
and reads the SM clock and power draw while each forward runs back to back
(``clock_under_load``: it says whether work was still queued when the
reading returned).  This checkout's library and the other's forward are
called through the package's wrappers.  Exits 1 if any result differs.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke as cs  # noqa: E402
from k2_designs import bind, ptxas_report  # noqa: E402

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# the entry of a source that recomputes the gradient from the inputs
RECOMPUTING_BACKWARD = {
    "quantile_huber_backward": (_I, [_P, _LL, _P, _LL, _I, _I, _I, _F, _P, _LL, _P, _P])}


def use(lib) -> None:
    """Route the K5 wrappers through ``lib``."""
    from reagent_tpu_torch.ops import _build

    _build._loaded["quantile_huber"] = lib


def has_sums(lib) -> bool:
    """Whether ``lib`` has the forward with gradient sums (and the scaling)."""
    return hasattr(lib, "quantile_huber_forward_sums")


def kernel_sass(src: Path) -> dict:
    """``{kernel name: [(address, opcode, operands), ...]}`` from
    ``cuobjdump -sass`` of ``src`` built as this package builds it."""
    from reagent_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", cubin, str(src)],
                       check=True, capture_output=True, text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                              text=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        instrs, labels = [], {}
        for line in block.splitlines():
            lab = re.match(r"^\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(instrs)
            ins = re.match(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                           line)
            if ins:
                instrs.append((int(ins.group(1), 16), ins.group(3), ins.group(4).strip()))
        out[block.split()[0]] = (instrs, labels)
    return out


def hot_loop(instrs, labels):
    """The innermost loop (a backward branch with no other inside it) that
    holds the most FFMA: its instructions."""
    addr_index = {a: i for i, (a, _, _) in enumerate(instrs)}
    loops = []
    for i, (_, op, rest) in enumerate(instrs):
        if not op.startswith("BRA"):
            continue
        t = re.search(r"(\.L_x_\d+)", rest)
        a = re.search(r"0x([0-9a-f]+)", rest)
        start = labels.get(t.group(1)) if t else addr_index.get(int(a.group(1), 16)) if a else None
        if start is not None and start <= i:
            loops.append((start, i))
    inner = [(s, e) for s, e in loops
             if not any(s <= s2 and e2 < e for s2, e2 in loops if (s2, e2) != (s, e))]
    if not inner:
        return []
    s, e = max(inner, key=lambda l: sum(op.startswith("FFMA") for _, op, _ in instrs[l[0]:l[1] + 1]))
    return instrs[s:e + 1]


def sass_per_pair(src: Path) -> str:
    """Each float32 kernel's hot loop (``hot_loop``) as instructions per
    pair: the loop's length over the targets it loads (4 a 16-byte shared
    load, 1 a 4-byte one) times the current atoms each serves (J, the
    template argument of this checkout's kernel; 1 in a kernel without it),
    for J = 1, 2 and 7 (N = 11, 51 and 201), with the loop's opcodes."""
    out = []
    for fname, (instrs, labels) in kernel_sass(src).items():
        m = re.search(r"Li(\d+)E", fname)
        J = int(m.group(1)) if m else 1
        if "bfloat16" in fname or J not in (1, 2, 7):
            continue
        body = hot_loop(instrs, labels)
        if not body:
            continue
        targets = sum(4 if op.startswith("LDS.128") else 1
                      for _, op, _ in body if op.startswith("LDS"))
        hist = Counter(op.split(".")[0] for _, op, _ in body)
        per_pair = len(body) / (targets * J) if targets else float("nan")
        out.append(f"  {fname}: loop of {len(body)} instructions, {targets} targets x {J} "
                   f"atoms: {per_pair:.2f} a pair; " + ", ".join(
                       f"{k} {v}" for k, v in hist.most_common()))
    return "\n".join(out)


def cases(torch):
    """(label, target, current, kappa, grad_per_sample) at every compared case."""
    out = []
    shapes = list(cs.K5_SHAPES) + [(37, n) for n in (1, 32, 33, 64, 65, 256, 257, 1536)]
    shapes += [(1, 51), (1, 201)]
    for B, N in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for ties in (False, True):
                for kappa in (1.0, 0.5):
                    t, c = cs.k5_inputs(torch, B, N, seed=B + N, dtype=dtype, ties=ties)
                    out.append((f"[{B}, {N}] {str(dtype)[6:]} {'ties' if ties else 'random'} "
                                f"kappa {kappa}", t, c, kappa,
                                torch.linspace(-1.0, 2.0, B, device=cs.DEVICE)))
    for dtype in (torch.float32, torch.bfloat16):
        t, c = cs.k5_inputs(torch, 300, 51, seed=7, dtype=dtype, ties=True)
        wide_t = torch.cat([t, t.flip(1)], dim=1)[:, :51]
        wide_c = torch.cat([c.flip(1), c], dim=1)[:, 51:]
        row = torch.full((1, 51), 1.0, device=cs.DEVICE, dtype=dtype).expand(300, 51)
        mean_grad = torch.full((1,), 1.0 / 300, device=cs.DEVICE).expand(300)
        name = str(dtype)[6:]
        out.append((f"[300, 51] {name} strided rows", wide_t, wide_c, 1.0, mean_grad))
        out.append((f"[300, 51] {name} expanded target row", row, c, 1.0, mean_grad))
    return out


def recomputed_gradient(torch, lib, t, c, kappa, gps):
    """The gradient through a source's ``quantile_huber_backward``, which
    recomputes it from the inputs (the design before the gradient sums)."""
    B, N = t.shape
    grad = torch.empty((B, N), dtype=c.dtype, device=cs.DEVICE)
    err = lib.quantile_huber_backward(
        t.data_ptr(), t.stride(0), c.data_ptr(), c.stride(0), int(c.dtype == torch.bfloat16),
        B, N, float(kappa), gps.data_ptr(), gps.stride(0), grad.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"backward failed: {lib.quantile_huber_error_string(err).decode()}")
    return grad


def run(torch, lib, t, c, kappa, gps):
    """(loss-only losses or None, losses of the route that feeds the
    gradient, gradient) through ``lib``: the package's wrappers, and the
    recomputing backward where ``lib`` has no gradient sums."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    use(lib)
    loss_only = qh._launch_forward(t, c, kappa, sums=False)[0]
    if has_sums(lib):
        per, sums = qh._launch_forward(t, c, kappa, sums=True)
        return loss_only, per, qh._launch_scale(sums, gps, c.dtype)
    return None, loss_only, recomputed_gradient(torch, lib, t, c, kappa, gps)


def same_results(torch, this, other) -> bool:
    """Every case through both libraries; True if all are bit for bit."""
    same_all = True
    for label, t, c, kappa, gps in cases(torch):
        a, b = run(torch, this, t, c, kappa, gps), run(torch, other, t, c, kappa, gps)
        torch.cuda.synchronize()
        same = [torch.equal(a[1], b[1]), torch.equal(a[2], b[2])]
        same += [torch.equal(x[0], x[1]) for x in (a, b) if x[0] is not None]
        same += [torch.equal(a[0], b[0])] if a[0] is not None and b[0] is not None else []
        cs.log(f"    {label}: losses max abs {(a[1] - b[1]).abs().max().item():.3e}, gradient "
               f"max abs {(a[2].float() - b[2].float()).abs().max().item():.3e} "
               f"(bit for bit, both routes: {all(same)})")
        same_all &= all(same)
    return same_all


def timings(torch, lib):
    """ms at each K5 shape: loss-only forward, forward with sums (where the
    library has it), backward, and the pair a train step runs."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    use(lib)
    parts = []
    for B, N in cs.K5_SHAPES:
        t, c = cs.k5_inputs(torch, B, N, seed=N)
        gps = torch.full((B,), 1.0 / B, device=cs.DEVICE)
        loss = cs.time_ms(torch, lambda: qh._launch_forward(t, c, 1.0, sums=False))
        if has_sums(lib):
            sums = qh._launch_forward(t, c, 1.0, sums=True)[1]
            fwd_sums = cs.time_ms(torch, lambda: qh._launch_forward(t, c, 1.0, sums=True))
            bwd = cs.time_ms(torch, lambda: qh._launch_scale(sums, gps, c.dtype))
            pair = cs.time_ms(torch, lambda: qh._launch_scale(
                qh._launch_forward(t, c, 1.0, sums=True)[1], gps, c.dtype))
        else:
            fwd_sums = float("nan")
            bwd = cs.time_ms(torch, lambda: recomputed_gradient(torch, lib, t, c, 1.0, gps))
            pair = cs.time_ms(torch, lambda: (qh._launch_forward(t, c, 1.0, sums=False),
                                              recomputed_gradient(torch, lib, t, c, 1.0, gps)))
        parts.append(f"[{B}, {N}] loss-only {loss:.4f}, with sums {fwd_sums:.4f}, backward "
                     f"{bwd:.4f}, pair {pair:.4f}")
    return "; ".join(parts)


def clock_under_load(torch, lib) -> str:
    """nvidia-smi's SM clock and power draw while the forward with sums (or
    the forward) at the largest K5 shape runs back to back: forwards are
    launched for half a second, then on until nvidia-smi has answered.  An
    event recorded after the last of them must still be pending then, so
    the device had work queued through the reading."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    use(lib)
    B, N = max(cs.K5_SHAPES, key=lambda s: s[0] * s[1] * s[1])
    t, c = cs.k5_inputs(torch, B, N, seed=N)
    sums = has_sums(lib)
    torch.cuda.synchronize()
    end = time.perf_counter() + 0.5
    while time.perf_counter() < end:
        qh._launch_forward(t, c, 1.0, sums=sums)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True)
    during = 0
    while smi.poll() is None:
        qh._launch_forward(t, c, 1.0, sums=sums)
        during += 1
    last = torch.cuda.Event()
    last.record()
    queued = not last.query()
    read = smi.communicate()[0].strip()
    torch.cuda.synchronize()
    return (f"SM clock, power draw under the forward at [{B}, {N}]: {read} ({during} forwards "
            f"launched while nvidia-smi ran; work still queued when it answered: {queued})")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k5_designs: needs an NVIDIA card", file=sys.stderr)
        return 2
    if not argv:
        print("k5_designs: name one or more other quantile_huber.cu sources", file=sys.stderr)
        return 2
    from reagent_tpu_torch.ops import _build

    card, name = cs.card_line(), torch.cuda.get_device_name(0)
    cs.log(card)
    sources = {"this": _build.CSRC / "quantile_huber.cu"}
    sources.update({path: Path(path) for path in argv})
    libs = {}
    for label, src in sources.items():
        cs.log(f"{label}: -Xptxas -v")
        cs.log(ptxas_report(src, "quantile_huber"))
        cs.log(f"{label}: cuobjdump -sass, the hottest loop of each float32 kernel")
        cs.log(sass_per_pair(src))
        libs[label] = bind(src, "quantile_huber", RECOMPUTING_BACKWARD)

    same_all = True
    for label in argv:
        cs.log(f"  this against {label}:")
        same_all &= same_results(torch, libs["this"], libs[label])

    for B, N in cs.K5_SHAPES:
        bounds = cs.k5_bounds(B, N, name)
        cs.log(f"  bounds at [{B}, {N}]: " + ", ".join(
            f"{k} {ms:.6f} ms ({by})" for k, (ms, by) in bounds.items()))
    for label in list(argv) + ["this", "this"] + list(reversed(argv)):
        floor = cs.time_ms(torch, lambda: torch.cuda._sleep(0))
        cs.log(f"  {label}: {timings(torch, libs[label])} ms; queued launch floor "
               f"{floor:.4f} ms, on {card}")
    for label in libs:
        cs.log(f"  {label}: {clock_under_load(torch, libs[label])}")
    use(libs["this"])
    cs.log(f"bit for bit against every other source at every case: {same_all}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
