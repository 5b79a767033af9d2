"""The readings that the limits of ``correct`` are set from, for one cell, in
one process: the compared numbers of sound runs of the program over many
seeds (the lower reading is their largest), of the control (the program in
the configuration's ``control`` precision; the upper reading is its
smallest), and of each planted fault (``faults.py``).  No window is measured:
each reading is the set-up up to the checked call, and the comparison.

    python3 portbench/calibrate.py --workload dqn_full.table10m_b16384 \\
        --seeds 101 102 103 --control-seeds 201 202 203 --fault-seeds 301 302 303 \\
        --out chiprun_out/calibrate_dqn.json
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def reading(harness, cell, seed, device, precision, details=None):
    """The compared numbers of one seed: the checked call, then the
    reference once the program is freed."""
    with harness.matmul_precision(precision):
        run = harness.build(cell, seed, device, precision)
        run.checked()
    run.close()
    return run.compare(details)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)

    import torch

    from portbench import faults, harness

    torch.set_num_threads(1)
    cell = harness.load_cell(ROOT, args.workload)
    cfg = cell.config
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, None) for s in args.control_seeds]
    runs += [(f, s, f) for s in args.fault_seeds for f in faults.FAULTS]
    out = []
    for kind, seed, fault in runs:
        precision = cfg["control"] if kind == "control" else cfg["precision"]
        t, details = time.perf_counter(), {}
        if fault:
            with faults.planted(cfg, fault):
                values = reading(harness, cell, seed, args.device, precision, details)
        else:
            values = reading(harness, cell, seed, args.device, precision, details)
        row = {"kind": kind, "seed": seed, "precision": precision, "values": values,
               "seconds": time.perf_counter() - t,
               "details": {k: v for k, v in details.items() if k != "loss_by_step"},
               "loss_by_step_worst": max(details.get("loss_by_step", [0.0]))}
        print(json.dumps({k: row[k] for k in ("kind", "seed", "values", "seconds")}),
              flush=True)
        out.append(row)
    summary = {}
    for name in next(iter(out))["values"]:
        by = {k: [r["values"][name] for r in out if r["kind"] == k] for k in
              ("program", "control", *faults.FAULTS)}
        summary[name] = {"lower": max(by["program"]),
                         **{f"least_{k}": min(v) for k, v in by.items() if v and k != "program"}}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"workload": args.workload, "runs": out,
                                        "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
