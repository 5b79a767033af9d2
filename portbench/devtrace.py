"""The reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device operations with their intervals, the busy time (the union of
those intervals), the idle gaps named by what the host was doing, and which
device operations were launched from inside a span (``spans.py``).

The raw Kineto events are read directly (``prof.profiler.kineto_results``),
without building the profiler's operator tree, so a stretch of some hundred
thousand events reduces in seconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

SPAN_PREFIX = "portbench."  # the benchmark's own spans (record_function)
DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}
# the host records of the CUDA runtime's and driver's calls, known by their
# names (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync), since some
# versions of torch give no activity type; a device operation carries the
# correlation id of the call that launched it
LAUNCH_NAME = re.compile(r"^cu(da)?[A-Z]\w*$")


@dataclasses.dataclass
class Interval:
    name: str
    start_ns: int
    end_ns: int
    correlation: int = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Trace:
    """One profiled stretch: its device operations, the host's operations and
    spans on the thread that drives the loop, and the stretch's bounds;
    ``launches`` maps a correlation id to the thread and time of the host
    call that launched it, ``spans`` a benchmark span's name to its
    ``(thread, start, end)`` on every thread."""

    device_ops: List[Interval]
    host_ops: List[Interval]
    start_ns: int
    end_ns: int
    launches: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[Tuple[int, int, int]]] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def busy_s(self) -> float:
        return union_ns(self.device_ops) * 1e-9


def _activity(event) -> str:
    """The profiler's activity type of ``event``, or "" where this version of
    torch gives none."""
    fn = getattr(event, "activity_type", None)
    return fn() if fn is not None else ""


def from_profiler(prof, stretch_span: str) -> Trace:
    """The ``Trace`` of the span named ``stretch_span`` in a finished
    ``torch.profiler.profile`` of the host and the device: the device's
    operations (``device_ops``) and the host events of the thread that
    opened the span, the span itself among them."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    # the span on the host; some versions of torch draw it on the device's
    # timeline too, under the same name
    stretch = [e for e in events
               if e.name() == stretch_span and e.device_type() != DeviceType.CUDA]
    if len(stretch) != 1:
        raise RuntimeError(f"the trace holds {len(stretch)} spans named {stretch_span!r}")
    span = stretch[0]
    t0, t1 = span.start_ns(), span.start_ns() + span.duration_ns()
    thread = span.start_thread_id()
    host = []
    launches: Dict[int, Tuple[int, int]] = {}
    spans: Dict[str, List[Tuple[int, int, int]]] = defaultdict(list)
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        if LAUNCH_NAME.match(e.name()):
            launches[e.correlation_id()] = (e.start_thread_id(), start)
        elif e.name().startswith(SPAN_PREFIX):
            spans[e.name()].append((e.start_thread_id(), start, end))
        if e.start_thread_id() == thread:
            host.append(Interval(e.name(), start, end))
    # the stretch ends in a synchronisation, so its operations lie inside it;
    # clip what the two clocks' alignment puts a little outside
    device = [Interval(d.name, max(d.start_ns, t0), min(d.end_ns, t1), d.correlation)
              for d in device_ops(prof) if d.end_ns > t0 and d.start_ns < t1]
    return Trace(device, host, t0, t1, launches, dict(spans))


# the kernel of ``torch.cuda._sleep``, which bounds a device-only stretch
# (``mark``); the program never launches it
MARKER = "spin_kernel"


def mark(device) -> None:
    """A marker kernel on the device's timeline, a few microseconds long."""
    import torch

    with torch.cuda.device(device):
        torch.cuda._sleep(100)


def device_ops(prof) -> List[Interval]:
    """The device operations of a finished ``torch.profiler.profile``:
    kernels, copies and memsets (user annotations drawn on the device
    timeline are not operations)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        activity = _activity(e)
        if activity and activity not in DEVICE_ACTIVITIES:
            continue
        if not activity and e.name().startswith(SPAN_PREFIX):
            continue
        out.append(Interval(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
    return out


def from_device_profile(prof) -> Trace:
    """The ``Trace`` of a profile of the device alone (no host records, so no
    host cost of recording them): the operations between the end of the
    first marker kernel and the start of the last."""
    ops = device_ops(prof)
    markers = sorted((op for op in ops if identifier(op.name) == MARKER),
                     key=lambda op: op.start_ns)
    if len(markers) != 2:
        raise RuntimeError(f"the device's trace holds {len(markers)} marker kernels, not 2")
    t0, t1 = markers[0].end_ns, markers[1].start_ns
    inside = [Interval(op.name, max(op.start_ns, t0), min(op.end_ns, t1), op.correlation)
              for op in ops if identifier(op.name) != MARKER
              and op.end_ns > t0 and op.start_ns < t1]
    return Trace(inside, [], t0, t1)


def union_ns(intervals: Sequence[Interval]) -> int:
    """Length of the union of the intervals."""
    total, cur_start, cur_end = 0, None, None
    for iv in sorted(intervals, key=lambda x: x.start_ns):
        if cur_end is None or iv.start_ns > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = iv.start_ns, iv.end_ns
        else:
            cur_end = max(cur_end, iv.end_ns)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def idle_gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The stretch's stretches of time in which no device operation ran."""
    gaps, at = [], trace.start_ns
    for iv in sorted(trace.device_ops, key=lambda x: x.start_ns):
        if iv.start_ns > at:
            gaps.append((at, iv.start_ns))
        at = max(at, iv.end_ns)
    if trace.end_ns > at:
        gaps.append((at, trace.end_ns))
    return gaps


def gaps_by_host_activity(trace: Trace) -> Dict[str, float]:
    """Idle seconds, summed by the innermost host operation or span running
    at each gap's midpoint.  Operations of one thread nest, so one sweep in
    time with a stack of the open ones finds it."""
    host = sorted(trace.host_ops, key=lambda x: (x.start_ns, -x.end_ns))
    out: Dict[str, float] = defaultdict(float)
    stack: List[Interval] = []
    i = 0
    for a, b in idle_gaps(trace):
        t = (a + b) // 2
        while i < len(host) and host[i].start_ns <= t:
            while stack and stack[-1].end_ns < host[i].start_ns:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out[stack[-1].name if stack else "host outside any operation"] += (b - a) * 1e-9
    return dict(out)


ANONYMOUS = "(anonymous namespace)::"


def short_name(kernel_name: str) -> str:
    """A kernel's name without its argument list and anonymous namespaces
    (templates kept): ``void (anonymous namespace)::k<8>(Args)`` ->
    ``void k<8>``."""
    name = kernel_name.replace(ANONYMOUS, "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].strip()


def identifier(kernel_name: str) -> str:
    """The function's own name: no return type, namespace, template or
    arguments (``void ns::gemm<8>(Args)`` -> ``gemm``)."""
    name = short_name(kernel_name).split("<", 1)[0].split()
    return name[-1].split("::")[-1] if name else ""


def global_functions(source: Path) -> set:
    """The ``__global__`` functions a CUDA source defines."""
    text = source.read_text()
    names = set()
    for m in re.finditer(r"\b__global__\b", text):
        rest = text[m.end():]
        rest = re.sub(r"^\s*(?:static\s+|inline\s+)*void\s+", "", rest)
        if rest.startswith("__launch_bounds__"):
            depth, i = 0, len("__launch_bounds__")
            while i < len(rest):
                if rest[i] == "(":
                    depth += 1
                elif rest[i] == ")":
                    depth -= 1
                    if depth == 0:
                        i += 1
                        break
                i += 1
            rest = rest[i:]
        ident = re.match(r"\s*([A-Za-z_]\w*)", rest)
        if ident:
            names.add(ident.group(1))
    return names


def ops_defined_in(trace: Trace, source: Path) -> List[Interval]:
    """The device operations that are kernels the CUDA source defines."""
    names = global_functions(source)
    return [iv for iv in trace.device_ops if identifier(iv.name) in names]


def ops_under(trace: Trace, span: str) -> List[Interval]:
    """The device operations launched from inside the span named ``span``:
    their launch lies on one of the span's threads, between its start and
    end.  Whatever the operation is, a kernel of any source or library, a
    copy or a memset, it is counted."""
    by_thread: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for thread, start, end in trace.spans.get(span, []):
        by_thread[thread].append((start, end))
    for intervals in by_thread.values():
        intervals.sort()
    starts = {t: [a for a, _ in iv] for t, iv in by_thread.items()}
    out = []
    for op in trace.device_ops:
        launch = trace.launches.get(op.correlation)
        if launch is None or launch[0] not in by_thread:
            continue
        thread, at = launch
        i = bisect.bisect_right(starts[thread], at) - 1
        if i >= 0 and at <= by_thread[thread][i][1]:
            out.append(op)
    return out


def all_inside(trace: Trace, source: Path, under: List[Interval]) -> bool:
    """Whether every kernel of the stretch that ``source`` defines is among
    ``under``."""
    inside = {id(op) for op in under}
    return all(id(op) in inside for op in ops_defined_in(trace, source))


def top_device_ops(trace: Trace, n: int = 10) -> List[List]:
    """``[[name, seconds], ...]``: the device operations that took the most
    time over the stretch, summed by name."""
    total: Dict[str, float] = defaultdict(float)
    for iv in trace.device_ops:
        total[short_name(iv.name)[:120]] += iv.seconds
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def top_idle_gaps(trace: Trace, n: int = 10) -> List[List]:
    """``[[host activity, idle seconds], ...]``, largest first."""
    by = gaps_by_host_activity(trace)
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
