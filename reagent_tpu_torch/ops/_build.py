"""Build the port's CUDA sources with nvcc and load them through ctypes.

Every ``csrc/*.cu`` of this package compiles, on first use, into its own
shared library under ``reagent_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  The libraries have a plain C
interface (no PyTorch headers), which keeps a build to seconds.

Nothing here runs at import: the CPU tests import the ops modules on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_FP = ctypes.POINTER(ctypes.c_float)
_PP = ctypes.POINTER(ctypes.c_void_p)
_LL = ctypes.c_longlong
_LLP = ctypes.POINTER(ctypes.c_longlong)
_F = ctypes.c_float
# argtypes per source: every pointer and the stream as c_void_p
_SIGNATURES = {
    "fused_dqn": {
        "fused_dqn_workspace_floats": (_LL, [_I, _IP, _I, _I, _I]),
        "fused_dqn_error_string": (ctypes.c_char_p, [_I]),
        "fused_dqn_update": (
            _I, [_I, _IP, _IP, _I, _I, _FP, _PP] + [_P] * 10 + [_IP, _P]),
        "fused_dqn_offline_update": (
            _I, [_I, _IP, _IP, _I, _I, _FP, _PP] + [_P] * 10 + [_IP, _P]),
        "fused_dqn_offline_update_bf16": (
            _I, [_I, _IP, _IP, _I, _I, _I, _I, _FP, _PP] + [_P] * 10 + [_IP, _P]),
        "fused_dqn_update_packed": (
            _I, [_I, _IP, _IP, _I, _I, _FP, _PP, _P, _P, _I, _IP] + [_P] * 4 + [_IP, _P]),
        "k1_product_routes": (_I, [_IP]),
    },
    "fused_mlp": {
        "fused_mlp_error_string": (ctypes.c_char_p, [_I]),
        "fused_mlp_forward": (_I, [_I, _IP, _IP, _PP, _LLP, _PP, _P, _I, _I, _P, _P, _P]),
        "fused_mlp_resident": (_I, [_I, _IP, _LLP, _I, _I]),
        "fused_mlp_workspace_floats": (_LL, [_I, _IP, _LLP, _I, _I]),
    },
    "nstep_replay": {
        "nstep_error_string": (ctypes.c_char_p, [_I]),
        "nstep_max_horizon": (_I, []),
        "nstep_rewards": (_I, [_P, _I, _P, _P, _I, _LL, _I, _FP, _P, _P, _P, _P]),
    },
    "quantile_huber": {
        "quantile_huber_error_string": (ctypes.c_char_p, [_I]),
        "quantile_huber_max_atoms": (_I, []),
        "quantile_huber_forward": (_I, [_P, _LL, _P, _LL, _I, _I, _I, _F, _P, _P]),
        "quantile_huber_forward_sums": (_I, [_P, _LL, _P, _LL, _I, _I, _I, _F, _P, _P, _P]),
        "quantile_huber_scale": (_I, [_P, _I, _I, _I, _P, _LL, _P, _P]),
    },
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
            "kernels of reagent_tpu_torch are built on the machine with the card"
        )
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}_{h[:16]}.so"


def _compile(src: Path) -> Path:
    out = _lib_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> List[Path]:
    """Compile every source in ``csrc/`` (one nvcc each, all at once)."""
    sources = sorted(CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(_compile, sources))


def bind(src: Path, name: str) -> ctypes.CDLL:
    """Build (if needed) and load the source ``src`` with the C interface of
    ``csrc/<name>.cu``, argtypes set; not cached."""
    lib = ctypes.CDLL(str(_compile(src)))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def load_library(name: str = "fused_dqn") -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with argtypes set."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = bind(CSRC / f"{name}.cu", name)
    return lib
