"""The port's host C++ runtime: build, load and wrap `src/plonky2_native.cc`.

The library holds the witness-plan executor (`iop/witness_plan.py`) and what
it needs: Goldilocks vector arithmetic, the Poseidon permutation and sponge,
and the PoseidonGate witness kernel; and keccak-f[1600], the permutation of
the Keccak config's host Merkle trees and transcript (`hash/keccak.py`).
Bound here: the executor, keccak-f, and the batch inverse, the permutation
and the PoseidonGate kernel, which the tests hold to their Python forms. It is compiled with g++ at first use,
not at import, into `plonky2_torch/build/native-<hash>/`, keyed on a hash of
the source and of the Poseidon tables, which are generated into the build
from the port's own constants (`hash/poseidon_constants.py`,
`hash/poseidon_fast_partial.py`). A failed build or load raises: nothing
falls back to the Python engine.

`verifier_binary()` builds the standalone verifier `src/verifier.cc`
(`plonky2_verify`, a second implementation of the verifier in C++) the same
way, into `plonky2_torch/build/verifier-<hash>/`, and raises where it
cannot.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "plonky2_native.cc"
VERIFIER_SRC = Path(__file__).resolve().parent / "src" / "verifier.cc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
VERIFIER_FLAGS = ("-O2", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _tables_inc() -> str:
    """The Poseidon constant tables as C++ (poseidon_tables.inc)."""
    from plonky2_torch.hash.poseidon_constants import (
        ALL_ROUND_CONSTANTS,
        MDS_MATRIX_CIRC,
        MDS_MATRIX_DIAG,
    )
    from plonky2_torch.hash.poseidon_fast_partial import (
        FAST_PARTIAL_FIRST_ROUND_CONSTANT,
        FAST_PARTIAL_ROUND_CONSTANTS,
        FAST_PARTIAL_ROUND_INITIAL_MATRIX,
        FAST_PARTIAL_ROUND_VS,
        FAST_PARTIAL_ROUND_W_HATS,
    )

    W = 12

    def u64s(vals):
        return ", ".join(f"0x{v:016x}ull" for v in vals)

    def matrix(rows):
        return "{" + ", ".join("{" + u64s(r) + "}" for r in rows) + "}"

    mds = [[MDS_MATRIX_CIRC[(i - r) % W] + (MDS_MATRIX_DIAG[r] if i == r else 0)
            for i in range(W)] for r in range(W)]
    return "\n".join([
        "// generated by plonky2_torch/native/__init__.py; do not edit",
        f"static const u64 PO_RC[{len(ALL_ROUND_CONSTANTS)}] = {{{u64s(ALL_ROUND_CONSTANTS)}}};",
        f"static const u64 PO_MDS[12][12] = {matrix(mds)};",
        f"static const u64 PO_FAST_FIRST[12] = {{{u64s(FAST_PARTIAL_FIRST_ROUND_CONSTANT)}}};",
        f"static const u64 PO_FAST_RC[22] = {{{u64s(FAST_PARTIAL_ROUND_CONSTANTS)}}};",
        f"static const u64 PO_FAST_INIT[11][11] = {matrix(FAST_PARTIAL_ROUND_INITIAL_MATRIX)};",
        f"static const u64 PO_FAST_W_HATS[22][11] = {matrix(FAST_PARTIAL_ROUND_W_HATS)};",
        f"static const u64 PO_FAST_VS[22][11] = {matrix(FAST_PARTIAL_ROUND_VS)};",
    ]) + "\n"


def _compile(src: Path, flags, kind: str, target: str, what: str) -> Path:
    """g++ `src` with the Poseidon tables into build/<kind>-<hash>/<target>,
    keyed on the source, the tables and the flags; written through a
    pid-named temporary file, so concurrent builders do not collide."""
    inc = _tables_inc()
    h = hashlib.sha256(src.read_bytes() + inc.encode() + " ".join(flags).encode())
    out_dir = BUILD_ROOT / f"{kind}-{h.hexdigest()[:16]}"
    out = out_dir / target
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    inc_path = out_dir / "poseidon_tables.inc"
    inc_tmp = out_dir / f"poseidon_tables.inc.{os.getpid()}.tmp"
    inc_tmp.write_text(inc)
    os.replace(inc_tmp, inc_path)
    tmp = out_dir / f"{target}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *flags, f"-I{out_dir}", str(src), "-o", str(tmp)],
                       check=True, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {what} cannot be built") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {what} failed:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


def _build() -> Path:
    return _compile(SRC, FLAGS, "native", "libplonky2_torch_native.so",
                    "the native witness executor")


def verifier_binary() -> str:
    """The path of the port's `plonky2_verify` binary (src/verifier.cc),
    built with g++ at first use. Raises where it cannot be built."""
    with _lock:
        return str(_compile(VERIFIER_SRC, VERIFIER_FLAGS, "verifier", "plonky2_verify",
                            "the native verifier"))


def library() -> ctypes.CDLL:
    """The loaded library, built first where missing. Raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.gl_batch_inverse.argtypes = [u64p, u64p, i64]
        lib.poseidon_permute.argtypes = [u64p, i64]
        lib.keccak_f1600.argtypes = [u64p, i64]
        lib.poseidon_gate_witness.argtypes = [u64p, u64p, u64p, i64]
        for fn in (lib.gl_batch_inverse, lib.poseidon_permute, lib.poseidon_gate_witness,
                   lib.keccak_f1600):
            fn.restype = None
        lib.witness_plan_run_mt.argtypes = [u64p, i32p, i64p, i64p, i64p, i64p, i64p, u64p,
                                            i64p, i64, i64]
        lib.witness_plan_run_mt.restype = i64
        _lib = lib
        return lib


def _p(a: np.ndarray, ctype=ctypes.c_uint64):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint64)


def batch_inverse(x):
    """Montgomery batch inversion; zeros map to zero."""
    xc = _c(x)
    out = np.empty(xc.shape, np.uint64)
    library().gl_batch_inverse(_p(xc), _p(out), xc.size)
    return out


def poseidon_permute(states) -> np.ndarray:
    """The permutation of [n, 12] (or [12]) u64 states, as a new array."""
    s = _c(states).copy()
    flat = s.reshape(-1, 12)
    library().poseidon_permute(_p(flat), flat.shape[0])
    return s


def keccak_f1600(states) -> np.ndarray:
    """keccak-f[1600] of [n, 25] u64 lane arrays, as a new array."""
    s = _c(states).copy()
    flat = s.reshape(-1, 25)
    library().keccak_f1600(_p(flat), flat.shape[0])
    return s


def poseidon_gate_witness(inputs, swaps) -> np.ndarray:
    """[n, 12] inputs and [n] swaps -> [n, 122] PoseidonGate wire values."""
    x, sw = _c(inputs), _c(swaps)
    out = np.empty((x.shape[0], 122), np.uint64)
    library().poseidon_gate_witness(_p(x), _p(sw), _p(out), x.shape[0])
    return out


def witness_plan_run_mt(values, plan, barriers, nthreads: int) -> int:
    """Run the ops between barriers[0] and barriers[-1] of a compiled plan
    in place on the representatives' values; the ops between two barriers
    form one level, and costly levels fan out over `nthreads` threads (the
    caller's among them). -1 on success, else the failing op's index."""
    return library().witness_plan_run_mt(
        _p(values), _p(plan.opcodes, ctypes.c_int32), _p(plan.in_off, ctypes.c_int64),
        _p(plan.out_off, ctypes.c_int64), _p(plan.aux_off, ctypes.c_int64),
        _p(plan.in_reps, ctypes.c_int64), _p(plan.out_reps, ctypes.c_int64), _p(plan.aux),
        _p(barriers, ctypes.c_int64), len(barriers), nthreads)
