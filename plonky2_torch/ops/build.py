"""Build and load the CUDA kernels of `plonky2_torch/csrc/`.

Each `*.cu` source compiles with nvcc into its own shared library with a
plain C interface, loaded through ctypes (pointers and the stream pass as
`c_void_p`). Libraries go to `plonky2_torch/build/<hash>/`, keyed on a hash
of every source and the flags, so the first call after a change rebuilds and
later calls load. All sources build at once, one nvcc process each.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("ntt", "poseidon")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None  # wall time of the last build, if one ran
ptxas_log: dict[str, str] = {}  # per source, ptxas's registers and spills, if it built here


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every missing library (all nvcc processes started together),
    then load them all. Raises with nvcc's output if a build fails."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        missing = [s for s in SOURCES if not (out_dir / f"lib{s}.so").exists()]
        if missing:
            t0 = time.perf_counter()
            nvcc = _nvcc()
            procs = {}
            for s in missing:
                tmp = out_dir / f"lib{s}.so.{os.getpid()}.tmp"
                cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{s}.cu")]
                procs[s] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            failures = []
            for s, (tmp, proc) in procs.items():
                output, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{s}.cu:\n{output.decode(errors='replace')}")
                    continue
                ptxas_log[s] = output.decode(errors="replace")
                os.replace(tmp, out_dir / f"lib{s}.so")
            if failures:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
            build_seconds = time.perf_counter() - t0
        for s in SOURCES:
            _libs[s] = _bind(s, ctypes.CDLL(str(out_dir / f"lib{s}.so")))
        return _libs


def library(name: str) -> ctypes.CDLL:
    libs = _libs if len(_libs) == len(SOURCES) else build_all()
    return libs[name]


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U64 = ctypes.c_uint64

_SIGNATURES = {
    "ntt": {
        "k2_ntt_rows": (_P, _P, _P, _P, _I, _I, _I, _I, _U64, _I, _P),
        "k3_ntt_four_step": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "poseidon": {
        "k4_tree": (_P, _P, _LL, _I, _I, _I, _I, _I, _P),
        "k5_permute": (_P, _P, _LL, _P),
        "k5_grind": (ctypes.POINTER(_U64), _I, _U64, _LL, _U64, _P, _P),
        "k5_grind_device": (_P, _P, _I, _U64, _P, _P),
    },
}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
