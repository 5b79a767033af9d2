#!/usr/bin/env python3
"""Compare K3 (the fused MLP forward) and K4 (the n-step window sum) as this
checkout's ``fused_mlp.cu`` and ``nstep_replay.cu`` build them against other
copies of those sources, on one NVIDIA card.

    mkdir -p .chip_checkout
    git show HEAD~1:reagent_tpu_torch/ops/csrc/fused_mlp.cu > .chip_checkout/fused_mlp.cu
    git show HEAD~1:reagent_tpu_torch/ops/csrc/nstep_replay.cu > .chip_checkout/nstep_replay.cu
    python3 tools/k3_k4_designs.py .chip_checkout/fused_mlp.cu .chip_checkout/nstep_replay.cu

Each further pair of sources is one more design, named by its two paths
(a pair may name this checkout's own ``fused_mlp.cu`` to compare K4 alone).
Prints ``-Xptxas -v`` for every kernel of each source (registers, shared
memory, spills); holds this checkout's results against the other sources'
bit for bit at every shape ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py`` use (K3: the act step [1, 4],
evaluate_policy's [20, 4] and [64, 4] on the CartPole net, the full-width
``q_values`` nets 128 -> 512 -> 256 -> 8 and -> 408 on 64 rows, the ragged
test net at B 37 and 300 in both weight layouts with each activation, the
600-wide net, a net of input widths that are not multiples of 4, and the
streamed route's callers, ``STREAMED``; K4 at both ``chip_smoke.K4_SHAPES``
with R 1 and 6 and H 1, 3 and 64); then times all in turns (the others,
this, this, the others in reverse; CUDA events, 3 warm-ups, median of 20)
beside the queued launch floor, the plain versions and, at the streamed
shapes, one ``torch.addmm`` a layer (a yardstick the port never calls),
with each wrapper's host time per call (the least of 5 runs of
``chip_smoke.host_us_per_call``, 200 calls each) at the act step's [1, 4]
and the loops' K4 shape through each design's library; then each design's
device time by CUDA kernel (torch.profiler) at the streamed shapes.  Exits
1 if any result differs.  The other sources keep the C interfaces of
``csrc/fused_mlp.cu`` and ``csrc/nstep_replay.cu``, less the entries added
since (``bind``); a ``fused_mlp.cu`` without ``fused_mlp_workspace_floats``
(the route that staged the whole net in one launch) is called through
``OlderK3``.

``--anatomy`` also times, at the CartPole shapes, copies of this checkout's
``fused_mlp.cu`` with parts of the resident route's work taken out
(``ANATOMY``, written to ``.chip_checkout/``): the launch alone, no weight
loads, no sums, neither.  Their results are wrong by design and are not
compared; their times show what the kernel's time is made of.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke as cs  # noqa: E402
from k2_designs import bind, ptxas_report  # noqa: E402

ACTS = ("relu", "leaky_relu", "tanh", "linear")

# Edits of csrc/fused_mlp.cu's resident kernel: (anchor, replacement)
_LAUNCH_ONLY = ("  extern __shared__ __align__(16) float smem[];\n  const int row0",
                "  return;  // anatomy: the launch alone\n"
                "  extern __shared__ __align__(16) float smem[];\n  const int row0")
_NO_WEIGHTS = ("    copy_matrix_async(ly.w_vec, smem + ly.w_off,",
               "    if (0) copy_matrix_async(ly.w_vec, smem + ly.w_off,")
_NO_SUMS = ("  int r = (threadIdx.x * wk.magic) >> 16;\n  int n = threadIdx.x - r * out;",
            "  in = 0;  // anatomy: no sums\n"
            "  int r = (threadIdx.x * wk.magic) >> 16;\n  int n = threadIdx.x - r * out;")
ANATOMY = {
    "launch alone": [_LAUNCH_ONLY],
    "no weight loads, no sums": [_NO_WEIGHTS, _NO_SUMS],
    "no sums": [_NO_SUMS],
    "no weight loads": [_NO_WEIGHTS],
}


def anatomy_sources(src: Path):
    """Write ANATOMY's copies of ``src`` into .chip_checkout/; {label: path}."""
    text = src.read_text()
    out = {}
    (REPO / ".chip_checkout").mkdir(exist_ok=True)
    for label, edits in ANATOMY.items():
        t = text
        for anchor, new in edits:
            if t.count(anchor) != 1:
                raise RuntimeError(f"anatomy edit {label!r}: anchor not found once in {src}")
            t = t.replace(anchor, new)
        path = REPO / ".chip_checkout" / f"anatomy_{label.replace(', ', '_').replace(' ', '_')}.cu"
        path.write_text(t)
        out[f"anatomy: {label}"] = path
    return out


# The streamed route's callers: label -> (rows, sizes, activations, W^T views
# of [out, in] (else contiguous [in, out]))
RELU_NET = ["relu", "relu", "linear"]
GATE = ["leaky_relu", "leaky_relu", "linear"]
STREAMED = {
    "NNTrainer predict, MSLR [32, 10-500-500-1]": (32, [10, 500, 500, 1], RELU_NET, True),
    "NNTrainer predict [4000, 8-500-500-1]": (4000, [8, 500, 500, 1], RELU_NET, True),
    "gate and CPE [4096, 128-512-256-8]": (4096, [128, 512, 256, 8], GATE, True),
    "BBB sample [4096, 136-512-1] on [in, out]": (4096, [136, 512, 1], ["relu", "linear"], False),
    "[8192, 128-512-256-8]": (8192, [128, 512, 256, 8], GATE, True),
}
# fused_mlp_forward before the streamed route took a workspace
_OLD_FORWARD = (ctypes.c_int, [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
                               ctypes.POINTER(ctypes.c_longlong),
                               ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


class OlderK3:
    """A ``fused_mlp`` library whose ``fused_mlp_forward`` takes no workspace,
    behind this checkout's wrapper: it needs none, and its forward is called
    without the workspace pointer."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def fused_mlp_workspace_floats(*args):
        return 0

    def fused_mlp_forward(self, *args):
        return self._lib.fused_mlp_forward(*args[:10], args[11])


def bind_k3(src: Path):
    """``bind`` for a ``fused_mlp.cu`` of this checkout's interface or of the
    older one (``OlderK3``)."""
    from reagent_tpu_torch.ops import _build

    if hasattr(ctypes.CDLL(str(_build._compile(src))), "fused_mlp_workspace_floats"):
        return bind(src, "fused_mlp")
    return OlderK3(bind(src, "fused_mlp", {"fused_mlp_forward": _OLD_FORWARD}))


def addmm_fn(torch, x, weights, acts):
    """The same forward as one torch.addmm a layer: a yardstick only."""
    from reagent_tpu_torch.ops.fused_dqn import _act

    def run():
        h = x
        for (w, b), a in zip(weights, acts):
            h = _act(a, torch.addmm(b, h, w))
        return h
    return run


def use(libs) -> None:
    """Route the K3 and K4 wrappers through ``libs`` (fused_mlp, nstep_replay)."""
    from reagent_tpu_torch.ops import _build

    _build._loaded["fused_mlp"], _build._loaded["nstep_replay"] = libs


def mlp(torch, sizes, seed, transposed=True):
    """Random weights as K3 takes them: W^T views of [out, in] (the trainer's
    layout) or contiguous [in, out] (JAX's)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        w = torch.tensor((rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32),
                         device=cs.DEVICE)
        b = torch.tensor((rng.normal(size=o) * 0.1).astype(np.float32), device=cs.DEVICE)
        out.append((w.T if transposed else w.T.contiguous(), b))
    return out


def rows_of(torch, B, D, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(B, D)).astype(np.float32), device=cs.DEVICE)


def k3_cases(torch):
    """(label, x, weights, activations) at every compared shape."""
    cases = []
    for rows in (1, cs.EVAL_EPISODES, 64):
        x, w, a = cs.k3_inputs(torch, rows, 7)
        cases.append((f"CartPole [{rows}, 4]", x, w, a))
    for A in (8, 408):  # the device-resident loop's q_values, the QR-DQN one's
        sizes = [128, 512, 256, A]
        cases.append((f"q_values [64, {'-'.join(map(str, sizes))}]", rows_of(torch, 64, 128, 1),
                      mlp(torch, sizes, 2), ["leaky_relu"] * 2 + ["linear"]))
    for transposed in (True, False):
        for act in ACTS:
            for B in (37, 300):
                layout = "W^T view" if transposed else "[in, out]"
                cases.append((f"test net [{B}, 13-70-33-5] {layout} {act}", rows_of(torch, B, 13, B),
                              mlp(torch, [13, 70, 33, 5], 2, transposed), [act, act, "linear"]))
    cases.append(("600-wide [50, 8-600-40-3]", rows_of(torch, 50, 8, 0),
                  mlp(torch, [8, 600, 40, 3], 3), ["tanh", "relu", "linear"]))
    for transposed in (True, False):
        cases.append((f"ragged inputs [20, 6-130-67-2] {'W^T view' if transposed else '[in, out]'}",
                      rows_of(torch, 20, 6, 20), mlp(torch, [6, 130, 67, 2], 6, transposed),
                      ["leaky_relu", "relu", "linear"]))
    for i, (label, (rows, sizes, acts, transposed)) in enumerate(STREAMED.items()):
        cases.append((f"streamed: {label}", rows_of(torch, rows, sizes[0], 30 + i),
                      mlp(torch, sizes, 40 + i, transposed), acts))
    return cases


def k4_inputs(torch, capacity, B, R, seed):
    """chip_smoke's store (~5% terminals, some windows wrapping), with R
    reward columns ([capacity, 2, R // 2] when R > 1)."""
    rewards, terminals, idx = cs.k4_inputs(torch, capacity, B, seed)
    if R > 1:
        rng = np.random.default_rng(seed + 1)
        rewards = torch.tensor(rng.normal(size=(capacity, 2, R // 2)).astype(np.float32),
                               device=cs.DEVICE)
    return rewards, terminals, idx


def k4_cases(torch):
    cases = []
    for label, (capacity, B, _) in cs.K4_SHAPES.items():
        for R in (1, 6):
            for H in (1, 3, 64):
                cases.append((f"{label} capacity {capacity} B {B} R {R} H {H}",
                              k4_inputs(torch, capacity, B, R, H), H))
    return cases


def same_results(torch, libs_a, libs_b) -> bool:
    """Every K3 and K4 case through both library pairs; True if all are bit
    for bit.  Logs each case's max abs difference."""
    from reagent_tpu_torch.ops import fused_mlp, nstep_replay

    same_all = True
    for label, x, w, a in k3_cases(torch):
        use(libs_a)
        route = "resident" if fused_mlp.takes_resident_route(x.shape[0], w) else "streamed"
        ys = []
        for libs in (libs_a, libs_b):
            use(libs)
            ys.append(fused_mlp.fused_mlp_forward(x, w, a))
        same = torch.equal(*ys)
        cs.log(f"    K3 {label} ({route} route here): max abs "
               f"{(ys[0] - ys[1]).abs().max().item():.3e} (bit for bit: {same})")
        same_all &= same
    for label, inputs, H in k4_cases(torch):
        outs = []
        for libs in (libs_a, libs_b):
            use(libs)
            outs.append(nstep_replay.nstep_rewards(*inputs, H, 0.99))
        same = all(torch.equal(p, q) for p, q in zip(*outs))
        cs.log(f"    K4 {label}: reward max abs {(outs[0][0] - outs[1][0]).abs().max().item():.3e},"
               f" mean steps {outs[0][1].float().mean().item():.3f} (bit for bit: {same})")
        same_all &= same
    return same_all


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_k4_designs: needs an NVIDIA card", file=sys.stderr)
        return 2
    anatomy = "--anatomy" in argv
    argv = [a for a in argv if a != "--anatomy"]
    if len(argv) % 2:
        print("k3_k4_designs: give pairs of sources: FUSED_MLP.cu NSTEP_REPLAY.cu ...",
              file=sys.stderr)
        return 2
    from reagent_tpu_torch.ops import _build, fused_mlp, nstep_replay

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    sources = {"this": (_build.CSRC / "fused_mlp.cu", _build.CSRC / "nstep_replay.cu")}
    for i in range(0, len(argv), 2):
        sources[f"{argv[i]} + {argv[i + 1]}"] = (Path(argv[i]), Path(argv[i + 1]))
    libs = {}
    for label, (k3_src, k4_src) in sources.items():
        cs.log(f"{label}: -Xptxas -v")
        cs.log(ptxas_report(k3_src, "fused_mlp"))
        cs.log(ptxas_report(k4_src, "nstep"))
        libs[label] = (bind_k3(k3_src), bind(k4_src, "nstep_replay"))
    parts_of = {}
    if anatomy:
        for label, path in anatomy_sources(sources["this"][0]).items():
            parts_of[label] = (bind(path, "fused_mlp"), libs["this"][1])

    same_all = True
    for label in sources:
        if label != "this":
            cs.log(f"  this against {label}:")
            same_all &= same_results(torch, libs["this"], libs[label])

    k3_timed = [c for c in k3_cases(torch)
                if c[0].startswith(("CartPole", "q_values [64, 128-512-256-8]", "streamed"))]
    k4_timed = [(label, cs.k4_inputs(torch, capacity, B, H), H)
                for label, (capacity, B, H) in cs.K4_SHAPES.items()]
    order = [k for k in sources if k != "this"] + ["this", "this"] + \
        [k for k in reversed(sources) if k != "this"]
    order += list(parts_of) + ["this"] + list(reversed(parts_of))
    for label in order:
        use(libs.get(label) or parts_of[label])
        floor = cs.time_ms(torch, lambda: torch.cuda._sleep(0))
        parts = []
        for name, x, w, a in k3_timed:
            if label in parts_of and not name.startswith("CartPole"):
                continue
            parts.append(f"K3 {name} {cs.time_ms(torch, lambda: fused_mlp.fused_mlp_forward(x, w, a)):.4f}")
        for name, inputs, H in ([] if label in parts_of else k4_timed):
            ms = cs.time_ms(torch, lambda: nstep_replay.nstep_rewards(*inputs, H, 0.99))
            parts.append(f"K4 {name} {ms:.4f}")
        host = ""
        if label not in parts_of:
            _, x, w, a = k3_timed[0]
            _, inputs, H = k4_timed[0]
            k3_us = min(cs.host_us_per_call(torch, lambda: fused_mlp.fused_mlp_forward(x, w, a))
                        for _ in range(5))
            k4_us = min(cs.host_us_per_call(
                torch, lambda: nstep_replay.nstep_rewards(*inputs, H, 0.99)) for _ in range(5))
            host = (f"; wrapper host us a call: K3 {k3_timed[0][0]} {k3_us:.1f}, "
                    f"K4 {k4_timed[0][0]} {k4_us:.1f}")
        cs.log(f"  {label}: " + ", ".join(parts) + f" ms; queued launch floor {floor:.4f} ms"
               f"{host}, on {card}")
    plain = [f"K3 {name} {cs.time_ms(torch, lambda: fused_mlp.fused_mlp_forward_reference(x, w, a)):.4f}"
             for name, x, w, a in k3_timed]
    plain += [f"K4 {name} "
              f"{cs.time_ms(torch, lambda: nstep_replay.nstep_rewards_reference(*inputs, H, 0.99)):.4f}"
              for name, inputs, H in k4_timed]
    cs.log("  plain versions: " + ", ".join(plain) + f" ms, on {card}")
    addmm = [f"K3 {name} {cs.time_ms(torch, addmm_fn(torch, x, w, a)):.4f}"
             for name, x, w, a in k3_timed if not name.startswith("CartPole")]
    cs.log("  one torch.addmm a layer (a yardstick only): " + ", ".join(addmm) + f" ms, on {card}")
    for label in [k for k in sources if k == "this"] + [k for k in sources if k != "this"]:
        use(libs[label])
        for name, x, w, a in k3_timed:
            if name.startswith("streamed"):
                cs.log(f"  {label}: K3 {name} device time by CUDA kernel (torch.profiler, mean "
                       f"of 5 calls):")
                cs.profile_calls(torch, lambda: fused_mlp.fused_mlp_forward(x, w, a))
    use(libs["this"])
    cs.log(f"bit for bit against every other source at every shape: {same_all}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
