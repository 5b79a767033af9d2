#!/usr/bin/env python3
"""Run the reference's sac_pendulum_e2e job on one NVIDIA card through the
port's ``reagent run`` with ``sac_pendulum_offline.yaml`` unchanged (80
epochs on 40,000 random Pendulum transitions, 30 greedy episodes of up to
1,000 steps against the -1000 bar).

    python3 tools/sac_pendulum_job.py          # the sample config unchanged
    python3 tools/sac_pendulum_job.py --cut    # chip_smoke.py's cut depth

It is ``chip_smoke.sac_job_phase``: it prints the card's name and power
limit, train steps/s, the host's decode against a train step, CUDA kernels
and device-to-host copies a step, the device's idle share, the greedy
episodes' seconds and their mean reward beside the bar, then one JSON line
of those numbers.  It holds no reward bar; it exits non-zero if a step of
the job fails.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sac_pendulum_job: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.card_line())
    with tempfile.TemporaryDirectory() as tmp:
        result = cs.sac_job_phase(torch, tmp, cut="--cut" in argv)
    cs.log(json.dumps({**result, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
