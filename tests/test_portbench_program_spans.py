"""The benchmark's readers of the program's own spans
(``portbench/program_spans.py`` and the four metrics that use it) and of the
device's idle time inside a call's steps, on traces written by hand: which
device operations lie under a span, the host's own time inside one (CUDA's
calls left out), the idle gaps inside a call against those at its edges,
and nothing read where the program opened no span."""

import json

import pytest

from portbench import devtrace, harness, program_spans
from portbench.devtrace import Interval, Trace
from portbench.tests import helpers

LOOP, AUTOGRAD = 1, 2  # host threads
READERS = ("batch_us_per_step", "host_us_per_step", "k1_host_us_per_update",
           "optimizer_launches_per_step", "idle_in_steps_pct")
SPAN_READERS = READERS[:4]
DEVICE_READERS = ("batch_us_per_step", "optimizer_launches_per_step", "idle_in_steps_pct")


def trace():
    """Two steps on the loop's thread, each with its draw, gather, staging,
    K1 call, optimizer update and Polyak average, and the CUDA calls the
    loop's thread made (a launch that waits for room in the queue, a driver
    call inside a runtime call, a synchronisation that outlasts its step);
    the device's operations with the host call that launched each; the step
    spans drawn on the device's timeline too, as some versions of torch
    do."""
    host = [
        Interval("portbench.stretch", 0, 2000),
        Interval("reagent.loop.step", 100, 700),
        Interval("reagent.loop.sample", 100, 140),
        Interval("reagent.loop.gather", 140, 200),
        Interval("reagent.fused_dqn.stage", 200, 240),
        Interval("reagent.k1", 260, 400),
        Interval("reagent.optim.update", 420, 480),
        Interval("reagent.optim.soft_update", 500, 540),
        Interval("reagent.loop.step", 1000, 1400),
        Interval("reagent.loop.sample", 1000, 1020),
        Interval("reagent.loop.gather", 1020, 1060),
        Interval("reagent.fused_dqn.stage", 1060, 1080),
        Interval("reagent.k1", 1100, 1200),
        Interval("reagent.optim.update", 1220, 1260),
        Interval("reagent.optim.soft_update", 1280, 1300),
        Interval("portbench.read_losses", 1600, 2000),
        Interval("aten::index", 145, 190),  # host work, not CUDA's
        Interval("cudaLaunchKernel", 150, 155),
        Interval("cudaLaunchKernel", 300, 380),  # waits for room in the queue
        Interval("cudaLaunchKernel", 520, 530),
        Interval("cuLaunchKernel", 522, 528),  # the driver's call inside the runtime's
        Interval("cudaStreamSynchronize", 690, 720),  # 10 ns of it inside the first step
        Interval("cuLaunchKernelEx", 1150, 1170),
        Interval("cudaMemcpyAsync", 1700, 1750),  # outside every step
    ]
    device = [
        Interval("void at::native::distribution_elementwise_grid_stride_kernel", 150, 160, 1),
        Interval("void at::native::index_elementwise_kernel<128, 4>(int)", 160, 200, 2),
        Interval("void at::native::elementwise_kernel<128, 2>(int)", 200, 230, 3),
        Interval("void gemm_f32_kernel<0>(GemmArgs)", 300, 650, 4),
        Interval("void multi_tensor_apply_kernel(float*)", 650, 660, 5),
        Interval("void polyak_kernel(float*)", 660, 670, 6),
        Interval("void late_kernel(float*)", 670, 680, 7),
        Interval("Memcpy DtoH (Device -> Pageable)", 1800, 1810, 8),
        Interval("void at::native::distribution_elementwise_grid_stride_kernel", 1030, 1040, 11),
        Interval("void at::native::index_elementwise_kernel<128, 4>(int)", 1040, 1080, 12),
        Interval("void at::native::elementwise_kernel<128, 2>(int)", 1080, 1110, 13),
        Interval("void gemm_f32_kernel<0>(GemmArgs)", 1110, 1350, 14),
        Interval("void multi_tensor_apply_kernel(float*)", 1350, 1360, 15),
        Interval("void polyak_kernel(float*)", 1360, 1370, 16),
        Interval("reagent.loop.step", 100, 700),  # annotations on the device's timeline
        Interval("reagent.loop.step", 1000, 1400),
    ]
    launches = {1: (LOOP, 110), 2: (LOOP, 150), 3: (LOOP, 210), 4: (LOOP, 300),
                5: (AUTOGRAD, 450),  # another thread, inside the optimizer's span
                6: (LOOP, 520),
                7: (LOOP, 545),  # after the Polyak span closed, inside the step
                8: (LOOP, 1700),
                11: (LOOP, 1010), 12: (LOOP, 1030), 13: (LOOP, 1070), 14: (LOOP, 1150),
                15: (LOOP, 1230), 16: (LOOP, 1290)}
    return Trace(device, host, 0, 2000, launches, {})


def device_only():
    """A stretch of the device alone over two calls: each call's steps, then
    the copy of its losses to the host; idle 0-50 (before the first call),
    300-320 and 900-950 (inside a call), 610-700 (between the calls) and
    1000-1100 (after the last); a program span drawn on the timeline over
    the second gap inside a call."""
    ops = [
        Interval("void at::native::distribution_elementwise_grid_stride_kernel", 50, 60, 1),
        Interval("void gemm_f32_kernel<0>(GemmArgs)", 60, 300, 2),
        Interval("void gemm_f32_kernel<0>(GemmArgs)", 320, 600, 3),
        Interval("Memcpy DtoH (Device -> Pageable)", 600, 610, 4),
        Interval("void at::native::distribution_elementwise_grid_stride_kernel", 700, 710, 5),
        Interval("void gemm_f32_kernel<0>(GemmArgs)", 710, 900, 6),
        Interval("void gemm_f32_kernel<0>(GemmArgs)", 950, 990, 7),
        Interval("Memcpy DtoH (Device -> Pinned)", 990, 1000, 8),
        Interval("reagent.loop.step", 890, 960),
    ]
    return Trace(ops, [], 0, 1100)


def readings(t, steps=2, device=None):
    """``t`` as the stretch with the host recorded, ``device`` (by default
    ``device_only()``) as the stretch of the device alone."""
    device = device_only() if device is None else device
    return harness.Readings({}, {"minibatch": 16}, device, {"steps": steps},
                            {"steps": 1.0}, {}, harness.ROOT, t, {"steps": steps}, {})


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_each_reader_on_a_trace_written_by_hand():
    r = readings(trace())
    # the draws, gathers and copies of both steps: (10 + 40 + 30) ns twice, over 2 steps
    assert reader("batch_us_per_step").read(r) == pytest.approx(0.080)
    # steps of 600 and 400 ns less CUDA's calls inside them: 5 + 80 + 10 (the
    # driver's call inside the runtime's counted once) + 10, and 20
    assert reader("host_us_per_step").read(r) == pytest.approx((495 + 380) / 2 * 1e-3)
    # K1's wrapper: 140 and 100 ns less the launches' 80 and 20
    assert reader("k1_host_us_per_update").read(r) == pytest.approx(0.070)
    # operations 5, 6, 15 and 16; 7 was launched after the Polyak span closed
    assert reader("optimizer_launches_per_step").read(r) == 2.0
    # from the device-only stretch: 300-320 and 900-950 of its 1,100 ns
    assert reader("idle_in_steps_pct").read(r) == pytest.approx(100 * 70 / 1100)


def test_a_launch_from_another_thread_inside_the_span_counts():
    t = trace()
    under = program_spans.ops_under(t, ["reagent.optim.update"])
    assert [op.correlation for op in under] == [5, 15]
    t.launches[5] = (AUTOGRAD, 490)  # between the update and the Polyak average
    assert [op.correlation for op in program_spans.ops_under(t, ["reagent.optim.update"])] == [15]


def test_a_launch_after_the_span_closed_does_not_count():
    t = trace()
    polyak = program_spans.ops_under(t, ["reagent.optim.soft_update"])
    assert [op.correlation for op in polyak] == [6, 16]  # not 7
    t.launches[6] = (LOOP, 541)
    assert reader("optimizer_launches_per_step").read(readings(t)) == 1.5
    t.launches[7] = (LOOP, 540)  # the span's last instant is inside it
    assert reader("optimizer_launches_per_step").read(readings(t)) == 2.0


def test_a_program_span_on_the_device_timeline_is_not_an_operation():
    t = trace()
    assert len(program_spans.device_ops(t)) == len(t.device_ops) - 2
    assert all(not op.name.startswith("reagent.") for op in program_spans.device_ops(t))
    # taken as operations, the two annotations would fill every gap inside the steps
    assert devtrace.union_ns(t.device_ops) == 600 + 400 + 10
    # the annotation over 900-950 of the device-only stretch hides no idle time
    d = device_only()
    assert devtrace.union_ns(d.device_ops) == 790 + 50
    assert reader("idle_in_steps_pct").read(readings(t)) == pytest.approx(100 * 70 / 1100)
    t.device_ops = [op for op in t.device_ops if op.name.startswith("reagent.")]
    assert program_spans.ops_under(t, ["reagent.loop.step"]) is None  # no operation at all


def test_overlapping_spans_count_an_operation_once():
    t = trace()
    whole = program_spans.ops_under(t, ["reagent.loop.step"])
    nested = program_spans.ops_under(t, ["reagent.loop.step", "reagent.loop.gather",
                                         "reagent.k1"])
    assert [op.correlation for op in nested] == [op.correlation for op in whole]
    assert [op.correlation for op in whole] == [1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 14, 15, 16]


def test_the_idle_inside_and_at_the_edges_of_the_calls_add_up_to_the_idle_share():
    d = device_only()
    d.device_ops = program_spans.device_ops(d)  # as a device-only profile reads them
    r = readings(trace(), device=d)
    idle = reader("device_idle_pct").read(r)
    edges = 100 * (50 + 90 + 100) / 1100
    assert idle == pytest.approx(reader("idle_in_steps_pct").read(r) + edges)


def test_the_idle_inside_a_call_needs_no_program_span():
    """The share reads the device alone, so a program without the spans (an
    older checkout under this benchmark) reads the same."""
    r = readings(_without_program_spans())
    r.spanned = None
    assert reader("idle_in_steps_pct").read(r) == pytest.approx(100 * 70 / 1100)


def test_the_idle_inside_a_call_reads_nothing_without_the_read_of_the_losses():
    """Without a copy to the host the stretch shows no call's edge, and all
    of its idle time would be taken for the steps'."""
    d = device_only()
    d.device_ops = [op for op in d.device_ops if not op.name.startswith("Memcpy DtoH")]
    assert reader("idle_in_steps_pct").read(readings(trace(), device=d)) is None


def test_the_host_time_of_a_span_leaves_out_the_cuda_calls_only():
    t = trace()
    base = program_spans.own_host_us_per_interval(t, "reagent.loop.gather")
    assert base == pytest.approx((60 - 5 + 40) / 2 * 1e-3)  # aten::index stays in
    t.host_ops = [iv for iv in t.host_ops if not iv.name.startswith("cu")]
    assert program_spans.own_host_us_per_interval(t, "reagent.loop.gather") == pytest.approx(
        0.050)
    assert program_spans.own_host_us_per_interval(t, "reagent.k1") == pytest.approx(0.120)


def _without_program_spans():
    t = trace()
    t.host_ops = [iv for iv in t.host_ops if not iv.name.startswith("reagent.")]
    return t


@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_is_read_where_the_program_opens_no_span(name):
    """A program without the spans (an older checkout under this benchmark)
    reads nothing, and raises nothing."""
    assert reader(name).read(readings(_without_program_spans())) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_is_read_without_a_stretch_that_records_the_host(name):
    r = readings(trace())
    r.spanned = None
    assert reader(name).read(r) is None


@pytest.mark.parametrize("name", DEVICE_READERS)
def test_device_readers_read_nothing_from_a_stretch_without_device_operations(name):
    t = trace()
    t.device_ops = []  # stretches traced off the card
    off_card = Trace([], [], 0, 0)
    assert reader(name).read(readings(t, device=off_card)) is None
    if name != "idle_in_steps_pct":  # a share of the stretch's length, not a step's
        assert reader(name).read(readings(trace(), steps=0)) is None


def test_the_five_entries_and_their_cells():
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in manifest["per_layer"]}
    assert [m["name"] for m in manifest["per_layer"]][-5:] == list(READERS)
    for name in READERS:
        m = entries[name]
        assert m["moves"] == "train_samples_per_s"
        # host time inside a program span; device time or idle from the trace
        assert m["source"] == ("program_span" if "host" in name else "device_trace")
        assert m["better"] == "lower" and len(m["layer"]) <= 200
    assert entries["k1_host_us_per_update"]["workloads"] == ["dqn_full.table10m_b16384"]
    assert entries["optimizer_launches_per_step"]["workloads"] == [
        "qrdqn_full_n200.table10m_b65536"]
    for name in ("batch_us_per_step", "host_us_per_step", "idle_in_steps_pct"):
        assert "workloads" not in entries[name]
    # the harness gathers the benchmark's own spans from every reader of a cell
    for cell in helpers.cells():
        readers = [reader(m["name"]) for m in harness.load_cell(harness.ROOT, cell).per_layer]
        assert set(harness.span_targets(readers)) <= {"portbench.k1", "portbench.k5"}


def test_a_traced_run_on_the_cpu_reads_the_host_span(tmp_path):
    """A traced run of the DQN cell at a small size, off the card: the step
    span reaches its reader through the harness; K1's span marks the CUDA
    route only, and the readers of the device find no device operation."""
    cell = helpers.small(harness.load_cell(harness.ROOT, "dqn_full.table10m_b16384"))
    result = harness.measure(cell, 2**31 + 5, 0.2, True, device="cpu")
    assert result["correct"], result["check"]
    metrics = result["metrics"]
    assert metrics["host_us_per_step"]["value"] > 0
    assert metrics["host_us_per_step"]["unit"] == "us/step"
    assert not {"k1_host_us_per_update", *DEVICE_READERS} & set(metrics)
    json.dumps(result)
