"""One run of one cell: set-up, the measured window, the traced stretch, and
the comparison with the reference.  What differs between kinds of work is
the cell's kind's (``kinds/<kind>.py``); this module is the same for all.

The run, in order:

1. set-up: the kind builds the inputs from the seed and the program from
   them, and its window's entry once; the entry's first call (the checked
   call) keeps what the comparison reads; a second call warms.
   ``setup_s`` ends here.
2. the window: further calls of the same entry, each followed by the read
   of its results, until ``seconds`` have passed; the work is counted over
   all the time from the first call's dispatch to the end of the last.
3. with ``trace``: ``profiled_calls`` more calls with the device alone
   under ``torch.profiler`` (the operations, the launches, the idle share),
   then as many with the host too and the spans that the cell's per-layer
   readers name opened around the program's entries (what the host did in
   the idle gaps; the operations under each span).
4. the peak device memory; the program and its state freed.
5. the kind's comparison with the plain reference.

Every per-name file (kind, adapter, reference, traffic, metric reader) is
read from the checkout whose ``BENCHMARK.json`` names the cell.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterator, List, Optional

import torch

from portbench import check, devtrace, spans, work

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
STRETCH = "portbench.stretch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "reagent_tpu")
MATMUL_PRECISION = {"float32": "highest", "bfloat16": "highest", "tfloat32": "high"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT


@dataclasses.dataclass
class Window:
    """What an end-to-end reader reads: the work the window completed by unit,
    its seconds, each call's seconds, and the run's set-up seconds."""

    work: Dict[str, float]
    seconds: float
    calls_s: List[float]
    setup_s: float


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the configuration and traffic mix, the
    stretch traced on the device alone and the work it completed by unit,
    the unprofiled window's work a second by unit, the card's peaks and the
    checkout; ``spanned`` is a second stretch traced on the host too, with
    the readers' spans open (kept apart, so that the host's cost of being
    recorded leaves the first one's idle share as it is), ``spanned_work``
    its work, and ``found`` per span entry whether it was found."""

    cfg: dict
    traffic: dict
    trace: devtrace.Trace
    profiled: Dict[str, float]
    per_s: Dict[str, float]
    peaks: Dict[str, float]
    root: Path
    spanned: Optional[devtrace.Trace] = None
    spanned_work: Dict[str, float] = dataclasses.field(default_factory=dict)
    found: Dict[str, bool] = dataclasses.field(default_factory=dict)


_modules: Dict[Path, ModuleType] = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module (names may hold dots), loaded
    once a process."""
    path = Path(path).resolve()
    if path in _modules:
        return _modules[path]
    tag = hashlib.sha256(str(path).encode()).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}_{tag}", path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _modules[path] = module
    return module


def loader(root: Path):
    """``load(folder, name)``: ``portbench/<folder>/<name>.py`` of ``root``."""
    return lambda folder, name: load_module(root / "portbench" / folder / f"{name}.py")


def for_cell(entries: List[dict], workload: str) -> List[dict]:
    return [m for m in entries if workload in m.get("workloads", [workload])]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, with its
    configuration file, its traffic file (``portbench/traffic/<name>.json``
    of ``root``) and the metrics it reports."""
    manifest = load_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=load_json(root / config["file"]),
        traffic=load_json(root / "portbench" / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=for_cell(manifest["end_to_end"], workload),
        per_layer=for_cell(manifest["per_layer"], workload),
        root=Path(root),
    )


@contextmanager
def matmul_precision(precision: str) -> Iterator[None]:
    """The program's float32 products at ``precision``: TF32 only where the
    precision is ``tfloat32`` (the configurations' control), full float32
    otherwise."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(MATMUL_PRECISION[precision])
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def add(total: Dict[str, float], work: Dict[str, float]) -> None:
    for k, v in work.items():
        total[k] = total.get(k, 0) + v


def kind_of(cell: Cell) -> ModuleType:
    return loader(cell.root)("kinds", cell.config["kind"])


def build(cell: Cell, seed: int, device, precision: str):
    """The kind's ``Run`` of ``cell``: inputs, program and the window's entry."""
    return kind_of(cell).Run(cell, seed, device, precision, loader(cell.root))


def run_window(run, seconds: float, device):
    """Calls of the run's entry until ``seconds`` have passed; returns the
    steps attempted, those that failed, the work completed, the seconds, and
    each call's seconds (its dispatch to the read of its results)."""
    attempted = failed = 0
    work_done: Dict[str, float] = {}
    start = time.perf_counter()
    ends = []
    while True:
        a, f, w = run.finish(run.call())
        attempted, failed = attempted + a, failed + f
        add(work_done, w)
        ends.append(time.perf_counter())
        if ends[-1] - start >= seconds:
            break
    synchronize(device)
    calls = [b - a for a, b in zip([start] + ends[:-1], ends)]
    return attempted, failed, work_done, time.perf_counter() - start, calls


def span_targets(readers: List[ModuleType]) -> Dict[str, List[str]]:
    targets: Dict[str, List[str]] = {}
    for reader in readers:
        for span, entries in getattr(reader, "SPANS", {}).items():
            targets.setdefault(span, [])
            targets[span] += [e for e in entries if e not in targets[span]]
    return targets


def profiler_started(activities, device) -> None:
    """The profiler's own first start-up, outside any stretch."""
    from torch.profiler import profile

    with profile(activities=activities):
        torch.ones(1, device=device).add_(1)
        synchronize(device)


def device_stretch(run, calls: int, device):
    """``calls`` more calls with the device alone profiled (no host records,
    so no host cost of recording them), between two marker kernels.  Returns
    the trace and the work completed; off the card, an empty trace."""
    from torch.profiler import ProfilerActivity, profile

    work_done: Dict[str, float] = {}
    if torch.device(device).type != "cuda":
        for _ in range(calls):
            add(work_done, run.finish(run.call())[2])
        return devtrace.Trace([], [], 0, 0), work_done
    profiler_started([ProfilerActivity.CUDA], device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        devtrace.mark(device)
        for _ in range(calls):
            add(work_done, run.finish(run.call())[2])
        devtrace.mark(device)
        synchronize(device)
    return devtrace.from_device_profile(prof), work_done


def host_stretch(run, calls: int, device, targets: Dict[str, List[str]]):
    """``calls`` more calls with the host and the device profiled, inside one
    span, with the readers' spans opened around the program's entries.
    Returns the trace, the work completed, and per entry whether it was
    found."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler_started(activities, device)
    work_done: Dict[str, float] = {}
    with spans.opened(targets, run.program) as found:
        with profile(activities=activities) as prof:
            with record_function(STRETCH):
                for _ in range(calls):
                    with record_function("portbench.call"):
                        pending = run.call()
                    with record_function("portbench.read_losses"):
                        add(work_done, run.finish(pending)[2])
                synchronize(device)
    return devtrace.from_profiler(prof, STRETCH), work_done, found


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def read_metrics(entries: List[dict], readers: List[ModuleType], ctx) -> Dict[str, dict]:
    out = {}
    for m, reader in zip(entries, readers):
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
            t0: Optional[float] = None, precision: Optional[str] = None) -> dict:
    """One run of ``cell``; returns the result's line as a dict, the compared
    numbers last (under ``check``).  ``t0``: the process's start on
    ``time.perf_counter``'s clock; ``precision``: the program's precision
    where it is not the configuration's (the control)."""
    t0 = time.perf_counter() if t0 is None else t0
    cfg, traffic = cell.config, cell.traffic
    precision = precision or cfg["precision"]
    load = loader(cell.root)
    if trace:
        readers = [load("metrics", m["name"]) for m in cell.per_layer]
        entries = cell.per_layer
    else:
        readers = [load("end_to_end", m["name"]) for m in cell.end_to_end]
        entries = cell.end_to_end
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    marks = {"entered": time.perf_counter()}
    with matmul_precision(precision):
        run = build(cell, seed, device, precision)
        synchronize(device)
        marks["built"] = time.perf_counter()
        run.checked()
        synchronize(device)
        marks["checked"] = time.perf_counter()
        run.finish(run.call())
        synchronize(device)
        marks["warm"] = time.perf_counter()
        setup_s = marks["warm"] - t0

        attempted, failed, work_done, window_s, calls_s = run_window(run, seconds, device)
        if trace:
            calls = int(traffic["profiled_calls"])
            stretch, profiled = device_stretch(run, calls, device)
            spanned, spanned_work, found = host_stretch(run, calls, device,
                                                        span_targets(readers))
        synchronize(device)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run.close()

    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        per_s = {k: v / window_s for k, v in work_done.items()}
        peaks = work.peaks_for(name) if on_card else {}
        ctx = Readings(cfg, traffic, stretch, profiled, per_s, peaks, cell.root, spanned,
                       spanned_work, found)
    else:
        ctx = Window(work_done, window_s, calls_s, setup_s)
    result["metrics"] = read_metrics(entries, readers, ctx)
    result["device"] = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1,
                        "memory_peak_bytes": int(memory_peak)}
    if on_card:
        result["device"]["power_limit"] = power_limit()
    if trace:
        result["device"].update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        result["breakdown"] = {"device_ops": devtrace.top_device_ops(stretch),
                               "idle_gaps": devtrace.top_idle_gaps(spanned)}
    result["window_calls"] = {"n": len(calls_s), "min_s": min(calls_s),
                              "median_s": statistics.median(calls_s), "max_s": max(calls_s)}
    # where set-up went: imports and the device's start-up before the harness
    # runs, the inputs, program and entry built, the checked call (its first
    # launches load the kernels' libraries, and build them on a checkout's
    # first run), the warm call
    result["setup_parts"] = {
        "before_harness_s": marks["entered"] - t0,
        "inputs_and_program_s": marks["built"] - marks["entered"],
        "checked_call_s": marks["checked"] - marks["built"],
        "warm_call_s": marks["warm"] - marks["checked"],
    }
    numbers = kind_of(cell).NUMBERS
    values = run.compare()
    result["correct"], result["check"] = check.judge(values, cfg.get("limits", {}), numbers)
    return result


def forbidden_modules() -> List[str]:
    """Top-level names of the loaded modules that are JAX's or the JAX
    package's, compared whole (``reagent_tpu_torch`` is not ``reagent_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def check_lines(result: dict) -> List[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in result["check"].items()]
