"""The trace's reduction and the per-layer readers, on a trace written by
hand: the busy union, the idle gaps and what the host was doing in them, the
kernels a CUDA source defines, the operations launched from inside a span,
and each reader's arithmetic."""

from pathlib import Path

import pytest

from portbench import devtrace, harness, spans, work
from portbench.devtrace import Interval, Trace
from portbench.tests import helpers

OPS = harness.ROOT / "reagent_tpu_torch" / "ops" / "csrc"
CFG = harness.load_json(harness.ROOT / "portbench" / "configs" / "dqn_full.json")
QR = harness.load_json(harness.ROOT / "portbench" / "configs" / "qrdqn_full_n200.json")
H100 = work.peaks_for("NVIDIA H100 80GB HBM3")
LOOP, AUTOGRAD = 1, 2  # host threads


def trace():
    """Two K1 kernels launched inside the update's span, a gather launched
    outside it, and a copy back."""
    device = [
        Interval("void (anonymous namespace)::gemm_f32_kernel<128, 64>(GemmArgs)", 100, 400, 11),
        Interval("(anonymous namespace)::td_rows_kernel(float const*)", 350, 450, 12),  # overlaps
        Interval("void at::native::index_elementwise_kernel<128, 4>(int)", 600, 700, 13),
        Interval("Memcpy DtoH (Device -> Pageable)", 900, 950, 14),
    ]
    host = [
        Interval("portbench.stretch", 0, 1000),
        Interval("portbench.call", 0, 800),
        Interval("aten::index", 460, 620),
        Interval("cudaLaunchKernel", 500, 560),
        Interval("portbench.read_losses", 800, 1000),
    ]
    launches = {11: (LOOP, 20), 12: (LOOP, 40), 13: (LOOP, 500), 14: (LOOP, 820)}
    return Trace(device, host, 0, 1000, launches, {"portbench.k1": [(LOOP, 10, 60)]})


def readings(t, cfg=CFG, steps=2, minibatch=16384, rate=800.0, found=None):
    """The same hand-written trace as the plain stretch and the spanned one."""
    return harness.Readings(cfg, {"minibatch": minibatch}, t, {"steps": steps},
                            {"steps": rate}, H100, harness.ROOT, t, {"steps": steps},
                            found or {})


def test_busy_union_and_idle_gaps():
    t = trace()
    assert devtrace.union_ns(t.device_ops) == 350 + 100 + 50
    assert t.busy_s == pytest.approx(500e-9) and t.window_s == pytest.approx(1000e-9)
    assert devtrace.idle_gaps(t) == [(0, 100), (450, 600), (700, 900), (950, 1000)]
    by = devtrace.gaps_by_host_activity(t)
    # gaps at 50, 525, 800, 975: innermost host op at each midpoint
    assert by == pytest.approx({"portbench.call": 100e-9, "cudaLaunchKernel": 150e-9,
                                "portbench.read_losses": 250e-9})


def test_kernel_names():
    assert devtrace.identifier(trace().device_ops[0].name) == "gemm_f32_kernel"
    assert devtrace.identifier(trace().device_ops[1].name) == "td_rows_kernel"
    assert devtrace.short_name(trace().device_ops[0].name) == "void gemm_f32_kernel<128, 64>"
    assert {"gemm_f32_kernel", "td_rows_kernel", "adam_polyak_kernel"} <= \
        devtrace.global_functions(OPS / "fused_dqn.cu")
    assert devtrace.global_functions(OPS / "quantile_huber.cu") == {
        "quantile_huber_kernel", "quantile_huber_scale_kernel"}
    assert [op.name[:20] for op in devtrace.ops_defined_in(trace(), OPS / "fused_dqn.cu")] == [
        trace().device_ops[0].name[:20], trace().device_ops[1].name[:20]]


def test_ops_under_a_span_go_by_the_launch_not_the_kernel():
    t = trace()
    # a kernel of another library launched inside the span counts; one of the
    # span's own source launched outside it does not
    t.device_ops.append(Interval("void cutlass::Kernel2<sm90_xmma_gemm>(Params)", 460, 480, 15))
    t.launches[15] = (LOOP, 55)
    t.launches[16] = (AUTOGRAD, 30)  # another thread at a time inside the span
    t.device_ops.append(Interval("void add_kernel(float*)", 480, 490, 16))
    under = devtrace.ops_under(t, "portbench.k1")
    assert [op.correlation for op in under] == [11, 12, 15]
    assert devtrace.all_inside(t, OPS / "fused_dqn.cu", under)
    t.launches[12] = (LOOP, 70)  # a K1 kernel launched after the span closed
    under = devtrace.ops_under(t, "portbench.k1")
    assert [op.correlation for op in under] == [11, 15]
    assert not devtrace.all_inside(t, OPS / "fused_dqn.cu", under)
    assert devtrace.ops_under(t, "portbench.nothing") == []


class Event:
    """A raw device event of the profiler (a torch that gives no activity type)."""

    def __init__(self, name, start, end, correlation=0):
        from torch.autograd import DeviceType

        self._name, self._start, self._end, self._corr = name, start, end, correlation
        self._device = DeviceType.CUDA

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr


class Profile:
    def __init__(self, events):
        kineto = type("Kineto", (), {"events": lambda self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": kineto})()


def test_a_device_stretch_lies_between_its_markers():
    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [Event("void gemm_f32_kernel<0>(Args)", 0, 50),  # before the stretch
              Event(spin, 90, 100), Event("void gemm_f32_kernel<0>(Args)", 130, 400, 7),
              Event("portbench.stretch", 100, 900),  # an annotation on the device's timeline
              Event("Memcpy DtoH (Device -> Pageable)", 600, 650, 8), Event(spin, 700, 705)]
    t = devtrace.from_device_profile(Profile(events))
    assert (t.start_ns, t.end_ns) == (100, 700)
    assert [op.correlation for op in t.device_ops] == [7, 8]
    assert t.busy_s == pytest.approx(320e-9) and t.host_ops == []
    with pytest.raises(RuntimeError):
        devtrace.from_device_profile(Profile(events[:3]))


def test_launches_are_known_by_name():
    for name, launch in (("cudaLaunchKernel", True), ("cuLaunchKernelEx", True),
                         ("cudaMemcpyAsync", True), ("aten::index", False),
                         ("portbench.k1", False), ("Activity Buffer Request", False),
                         ("cutlass::Kernel2", False), ("cuda", False)):
        assert bool(devtrace.LAUNCH_NAME.match(name)) is launch, name


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_readers():
    t = trace()
    r = readings(t)
    assert reader("launches_per_step").read(r) == 2.0
    assert reader("device_idle_pct").read(r) == pytest.approx(50.0)
    k1 = (300 + 100) * 1e-9 / 2  # the two kernels launched inside the span, per update
    bound, _ = work.fused_update_bound_s(CFG, 16384, H100)
    assert reader("k1_roofline").read(r) == pytest.approx(100 * bound / k1)
    assert reader("step_mfu_pct").read(r) == pytest.approx(
        100 * work.matmul_flops_per_step(CFG, 16384) * 800 / 67e12)


def test_readers_find_nothing_to_read():
    empty = readings(Trace([], [], 0, 1000))
    for name in ("launches_per_step", "device_idle_pct", "k1_roofline", "k5_roofline"):
        assert reader(name).read(empty) is None
    assert reader("k5_roofline").read(readings(trace(), cfg=QR)) is None  # no K5 span
    assert reader("step_mfu_pct").read(readings(trace(), rate=0.0)) is None
    unspanned = readings(trace())
    unspanned.spanned = None  # the cell's readers named no span: no second stretch
    assert reader("k1_roofline").read(unspanned) is None
    outside = trace()
    outside.spans = {}  # the update's span never opened: K1 ran, but not where it is looked for
    assert reader("k1_roofline").read(readings(outside)) is None


def k5_trace():
    fwd = Interval("void quantile_huber_kernel<float, 8, true>(float const*)", 0, 2000, 21)
    mean = Interval("void at::native::reduce_kernel<512, 1>(float*)", 2000, 2100, 22)
    bwd = Interval("void quantile_huber_scale_kernel<float>(float const*)", 2500, 3000, 23)
    launches = {21: (LOOP, 10), 22: (LOOP, 20), 23: (AUTOGRAD, 50)}
    return Trace([fwd, mean, bwd], [], 0, 4000, launches,
                 {"portbench.k5": [(LOOP, 5, 25), (AUTOGRAD, 45, 55)]})


def test_k5_roofline_counts_forward_and_backward_under_its_span():
    entries = reader("k5_roofline").SPANS["portbench.k5"]
    found = {e: True for e in entries}
    bound, _ = work.quantile_huber_bound_s(65536, 200, H100)
    r = readings(k5_trace(), cfg=QR, steps=1, minibatch=65536, found=found)
    assert reader("k5_roofline").read(r) == pytest.approx(100 * bound / 2600e-9)
    r.found = {entries[0]: True, entries[1]: False}  # the backward's entry was not found
    assert reader("k5_roofline").read(r) is None


def test_the_span_entries_are_found_and_put_back():
    import reagent_tpu_torch.ops.quantile_huber as qh
    import reagent_tpu_torch.training.qrdqn_trainer as qt

    entries = {"portbench.k5": reader("k5_roofline").SPANS["portbench.k5"]
               + ["reagent_tpu_torch.ops.quantile_huber:no_such_entry"]}

    class Program:
        class trainer:
            pass
    Program.trainer._update = staticmethod(lambda x: x + 1)
    entries["portbench.k1"] = reader("k1_roofline").SPANS["portbench.k1"]
    loss, backward = qt.quantile_huber_loss, qh._QuantileHuberPerSample.__dict__["backward"]
    with spans.opened(entries, Program) as found:
        assert found == {**{e: True for e in entries["portbench.k5"][:2]},
                         "reagent_tpu_torch.ops.quantile_huber:no_such_entry": False,
                         "program:trainer._update": True}
        assert qt.quantile_huber_loss is not loss
        assert isinstance(qh._QuantileHuberPerSample.__dict__["backward"], staticmethod)
        assert Program.trainer._update(1) == 2
    assert qt.quantile_huber_loss is loss
    assert qh._QuantileHuberPerSample.__dict__["backward"] is backward


def test_run_fails_without_a_card(tmp_path):
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          helpers.cells()[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=Path(tmp_path))
    assert out.returncode != 0 and out.stdout == ""

