"""The program's own spans in the traced stretch that records the host
(``Readings.spanned``): the ``reagent.*`` regions that the program opens with
``reagent_tpu_torch.utils.profiling.annotate``, and the device operations
launched inside them.

- A span's intervals are the host events of its name on the thread that
  drives the loop (``Trace.host_ops``).
- A device operation is under a span when the CUDA call that launched it
  (``Trace.launches``, on any thread: autograd's backward launches from a
  thread of its own) started inside one of those intervals.
- An event on the device's timeline named like a program span is an
  annotation some versions of torch draw there, not an operation.
- The host's own time inside a span leaves out the CUDA runtime's and
  driver's calls on its thread (``devtrace.LAUNCH_NAME``): where the device
  paces the loop, the host waits inside its launches for room in the
  queue, and that wait is the device's pace, not host work.

Every function returns ``None`` where the span is absent (a program that
opens none, or a trace without the host), never 0.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from portbench import devtrace

PREFIX = "reagent."
STEP = "reagent.loop.step"


def intervals(trace: devtrace.Trace, names: Sequence[str]) -> List[Tuple[int, int]]:
    """The host intervals of the spans named ``names``, by start."""
    wanted = set(names)
    return sorted((iv.start_ns, iv.end_ns) for iv in trace.host_ops if iv.name in wanted)


def device_ops(trace: devtrace.Trace) -> List[devtrace.Interval]:
    """The stretch's device operations, without program spans drawn on the
    device's timeline."""
    return [op for op in trace.device_ops if not op.name.startswith(PREFIX)]


def _merged(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _inside(spans: List[Tuple[int, int]], starts: List[int], t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def ops_under(trace: devtrace.Trace, names: Sequence[str]) -> Optional[List[devtrace.Interval]]:
    """The device operations launched inside any span named ``names``;
    ``None`` where none of those spans was opened or the stretch holds no
    device operation."""
    ops = device_ops(trace)
    spans = _merged(intervals(trace, names))
    if not spans or not ops:
        return None
    starts = [a for a, _ in spans]
    return [op for op in ops if op.correlation in trace.launches
            and _inside(spans, starts, trace.launches[op.correlation][1])]


def _overlap_ns(calls: List[Tuple[int, int]], starts: List[int], a: int, b: int) -> int:
    """The time of the merged ``calls`` that lies inside ``[a, b]``."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0
    while i < len(calls) and calls[i][0] < b:
        total += max(0, min(b, calls[i][1]) - max(a, calls[i][0]))
        i += 1
    return total


def own_host_us_per_interval(trace: devtrace.Trace, name: str) -> Optional[float]:
    """The host's own mean time inside the span ``name``, in microseconds:
    each interval's length less the time the thread spent inside CUDA's
    calls during it."""
    spans = intervals(trace, [name])
    if not spans:
        return None
    calls = _merged(sorted((iv.start_ns, iv.end_ns) for iv in trace.host_ops
                           if devtrace.LAUNCH_NAME.match(iv.name)))
    starts = [a for a, _ in calls]
    own = sum(b - a - _overlap_ns(calls, starts, a, b) for a, b in spans)
    return own * 1e-3 / len(spans)


def steps(ctx) -> Optional[float]:
    """The steps the stretch with the host recorded completed, where it was
    traced."""
    if ctx.spanned is None or not ctx.spanned_work.get("steps"):
        return None
    return ctx.spanned_work["steps"]
