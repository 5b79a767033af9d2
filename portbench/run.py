"""Run one cell of the benchmark of ``reagent_tpu_torch`` and print its result.

    python3 portbench/run.py --workload dqn_full.table_b16384 --seed 7 --seconds 10 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``check``: each compared number beside its limit);
the last lines of standard error repeat the compared numbers.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.  The run fails, and prints no result, where
no card is present, where the cell asks for more cards than there are, or
where JAX or the JAX package is loaded once the window has closed.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout's root, not this folder: import portbench, reagent_tpu_torch

# Kernel caches at fixed paths inside the checkout, so that only a checkout's
# first run builds.  The port's nvcc builds go to reagent_tpu_torch/_build/;
# these are for kernels a later change builds with Triton or torch's
# extension loader, since such a change may not edit this file.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    # the host thread that enqueues the loop is the only CPU work; idle
    # intra-op threads would only contend with it for the machine's cores
    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.measure(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                             t0=PROCESS_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
