"""Build and run the C++ decision service (``serving/``) for the port.

The service is the repo's dependency-free C++ runtime: it loads plans
(``export_plan``'s JSON) and scores a DQN artifact (``manifest.json`` +
``weights.bin``, ``DiscreteDqnPredictorWrapper.save``) natively through an
``ActionValueScoring`` operator.  ``build_decision_service`` compiles it with
one g++ command, no cmake:

    g++ -std=c++17 -O2 -I serving/include serving/src/main.cpp -lpthread

into ``reagent_tpu_torch/_build/serving/`` (ignored by git) or a caller's
directory, under a name keyed by a hash of the sources and flags, so an
unchanged source is not rebuilt.  It never builds into ``serving/build/``,
the cmake tree whose binary ``tests/test_serving_integration.py`` looks for.
``decision_service`` starts the binary on a free localhost port and stops it
when the block ends; ``action_values`` asks it for every action's value of
each row.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import signal
import socket
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from reagent_tpu_torch.serving.client import DecisionServiceClient

SERVING = Path(__file__).resolve().parents[2] / "serving"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "serving"
CXX = "g++"
CXX_FLAGS = ["-std=c++17", "-O2"]
STARTUP_S = 10.0  # how long a started service may take to answer /health


def _sources():
    return [SERVING / "src" / "main.cpp"] + sorted((SERVING / "include").rglob("*.h"))


def binary_path(out_dir=None) -> Path:
    h = hashlib.sha256(b"".join(p.read_bytes() for p in _sources())
                       + " ".join(CXX_FLAGS).encode()).hexdigest()
    return Path(out_dir or BUILD_DIR) / f"reagent_serving_{h[:16]}"


def build_decision_service(out_dir=None) -> Path:
    """Compile the service (if this source has no binary yet) into
    ``out_dir`` (default ``reagent_tpu_torch/_build/serving/``); its path."""
    out = binary_path(out_dir)
    cmake_tree = (SERVING / "build").resolve()
    if out.parent.resolve() == cmake_tree or cmake_tree in out.parent.resolve().parents:
        raise ValueError(f"{out.parent} is serving/build, which the cmake build owns")
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found on PATH; it builds the C++ decision service")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-I", str(SERVING / "include"), str(SERVING / "src" / "main.cpp"),
             "-lpthread", "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed on serving/src/main.cpp (exit "
                               f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def decision_service(plans_dir: str, binary=None,
                     log: Optional[str] = None) -> Iterator[DecisionServiceClient]:
    """Serve ``plans_dir`` on a free localhost port for the block: a client
    of the healthy service; the process is stopped (SIGTERM, then SIGKILL)
    on the way out, whatever happens in the block."""
    binary = binary or build_decision_service()
    port = free_port()
    cmd = [str(binary), "--plans", str(plans_dir), "--port", str(port)]
    if log is not None:
        cmd += ["--log", log]
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        client = DecisionServiceClient(port=port)
        deadline = time.monotonic() + STARTUP_S
        while not client.healthy():
            if proc.poll() is not None:
                raise RuntimeError(f"the decision service exited with {proc.returncode}: "
                                   f"{proc.stderr.read().decode()[-2000:]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"the decision service was not healthy in {STARTUP_S} s")
            time.sleep(0.05)
        yield client
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        proc.stderr.close()


def action_values(client: DecisionServiceClient, plan_name: str, action_names: Sequence[str],
                  rows: Sequence[Dict[int, float]]) -> np.ndarray:
    """``[len(rows), A]`` float64: each row's raw context features (feature id
    -> value) scored by ``plan_name``, a plan whose root is
    ``ActionValueScoring`` choosing all A actions; the service returns each
    action's value as its ``propensity``."""
    out: List[List[float]] = []
    for row in rows:
        resp = client.request(plan_name, list(action_names),
                              input={"context_features": {str(k): float(v)
                                                          for k, v in row.items()}})
        scores = {a["name"]: a["propensity"] for a in resp["actions"]}
        if set(scores) != set(action_names):
            raise ValueError(f"the plan returned {sorted(scores)}, not {list(action_names)}")
        out.append([scores[a] for a in action_names])
    return np.asarray(out, np.float64)
