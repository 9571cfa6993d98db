#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (plonky2_torch) on one CUDA card.

    python3 chip_smoke.py

In order: prints the card's name and power limit; builds the CUDA kernels
from `plonky2_torch/csrc/` (timed); holds each kernel K2-K5 against its
plain PyTorch version on the same card input at the main path's full shapes
(exact equality) and times both with CUDA events; runs `commit_and_open` at
the bench_recursion middle-circuit shapes (degree 2^13, oracles of
85/135/20/16 polynomials) with every launch count set to 0 just before and
read just after, and requires each kernel to have launched; runs
`commit_and_open` at degree 2^10 on the card and on the CPU (plain
versions) and requires identical proof bytes. The line before the last is
the `kernels` JSON object, the last line the ok JSON object. Any failed
check exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks used for the bounds. HBM: 3.35 TB/s (NVIDIA data sheet).
# Integer work: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# One Goldilocks multiply needs at least the four 32x32 partial products
# of its 64x64 -> 128-bit product.
OPS_PER_MODMUL = 4
# One Poseidon permutation: 8*12 + 22 S-boxes of 4 multiplies each, and
# 30 MDS layers of 144 constant multiply-adds on two 32-bit halves.
OPS_PER_PERMUTATION = (8 * 12 + 22) * 4 * OPS_PER_MODMUL + 30 * 144 * 2
SEED = 2026


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, warmup: int) -> float:
    """Median of `reps` runs, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(a, b) -> tuple[int, float]:
    """(mismatching elements, max |a - b| over u64 values)."""
    import numpy as np

    from plonky2_torch.field import goldilocks as g

    if a is None or b is None or not hasattr(a, "shape"):
        return (0, 0.0) if a == b else (1, float("inf"))
    if a.shape != b.shape:
        return a.numel() or 1, float("inf")
    x, y = g.to_numpy(a), g.to_numpy(b)
    bad = x != y
    if not bad.any():
        return 0, 0.0
    diff = max(abs(int(u) - int(v)) for u, v in zip(x[bad][:4096], y[bad][:4096]))
    return int(bad.sum()), float(diff)


def profile_line(torch, run, wall_s: float) -> None:
    """One run under the CUDA profiler (kernels only, no CPU-op recording):
    the kernels' summed device time against the unprofiled wall time, the
    number of kernel launches, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    if device_ms == 0:
        print("profile: device time not measured (the profiler saw no kernels)")
        return
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    tops = ", ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
    print(f"profile: kernels busy the device {device_ms:.3f} ms of the {wall_s * 1e3:.1f} ms "
          f"unprofiled wall ({device_ms / (wall_s * 1e3):.1%}); "
          f"{sum(e.count for e in kernels)} kernel launches; top device time: {tops}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np

        from plonky2_torch import ops
        from plonky2_torch.examples import commit_and_open as co
        from plonky2_torch.field import goldilocks as g
        from plonky2_torch.field import ntt
        from plonky2_torch.field import scalar as fs
        from plonky2_torch.ops import build
        from plonky2_torch.ops import ntt as kn
        from plonky2_torch.ops import poseidon as kp
    except ImportError as e:
        return fail(f"the port cannot be imported here ({e})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        return fail("nvidia-smi gave no card name and power limit")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds} s)")

    rng = np.random.default_rng(SEED)

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    results = {}
    failures = []

    def check(kernel, pairs, timed, n_bytes, n_ops):
        """pairs: (label, kernel call, plain call) on the same inputs;
        timed: the (kernel, plain) pair timed at the main path's shape."""
        mism, err = 0, 0.0
        for label, run_k, run_p in pairs:
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            m, e = compare(got, want)
            print(f"{kernel.kid} {label}: {m} mismatches")
            mism += m
            err = max(err, e)
        if mism:
            failures.append(f"{kernel.kid} disagrees with its plain version")
        ms = time_ms(torch, timed[0], reps=20, warmup=3)
        plain_ms = time_ms(torch, timed[1], reps=3, warmup=1)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        print(f"{kernel.kid} {kernel.name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {b_ms:.4f} ms ({b_by})")
        results[kernel.kid] = dict(mismatches=mism, max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # K2 at the main path's shapes: the 135-poly coset LDE (2^13 -> 2^16,
    # 8 cosets, fused scale + interleaved write), the iFFT, the zero tail
    gen = fs.MULTIPLICATIVE_GROUP_GENERATOR
    x = rand((135, 1 << 13))
    table = ntt._lde_coset_scale_table(gen, 13, 3, str(dev))
    small = rand((2, 1 << 5))
    tail = ntt.shift_powers(gen, 32, dev).reshape(1, 32)
    lde = (lambda: kn.ntt_rows(x, scale=table, fan=8),
           lambda: kn.ntt_rows_plain(x, scale=table, fan=8))
    rows = 135 * 8
    check(ops.K2, [("LDE [135, 2^13] x8", *lde),
                   ("iFFT [135, 2^13]", lambda: kn.ntt_rows(x, inverse=True),
                    lambda: kn.ntt_rows_plain(x, inverse=True)),
                   ("zero-tail LDE [2, 2^5] x8",
                    lambda: kn.ntt_rows(small, scale=tail, repeat_bits=3),
                    lambda: kn.ntt_rows_plain(small, scale=tail, repeat_bits=3))],
          lde, n_bytes=8 * (x.numel() + table.numel() + rows * (1 << 13)),
          n_ops=OPS_PER_MODMUL * rows * ((1 << 12) * 13 + (1 << 13)))

    # K3: the 2^16-point coset iFFT of prove_openings (q0, q1 together)
    y = rand((2, 1 << 16))
    inv = (lambda: kn.ntt_four_step(y, inverse=True),
           lambda: kn.ntt_four_step_plain(y, inverse=True))
    check(ops.K3, [("inverse [2, 2^16]", *inv),
                   ("forward [2, 2^16]", lambda: kn.ntt_four_step(y),
                    lambda: kn.ntt_four_step_plain(y))],
          inv, n_bytes=8 * (2 * y.numel() + (1 << 16)),
          n_ops=OPS_PER_MODMUL * 2 * ((1 << 15) * 16 + (1 << 16)))

    # K4: the 135-wide leaf sponge over 2^16 leaves, a Merkle level, fold leaves
    cols = rand((135, 1 << 16))
    level = rand((8, 1 << 15))
    fold = rand((32, 1 << 12))
    leaf = (lambda: kp.sponge(cols), lambda: kp.sponge_plain(cols))
    check(ops.K4, [("width 135 x 2^16", *leaf),
                   ("width 8 x 2^15", lambda: kp.sponge(level), lambda: kp.sponge_plain(level)),
                   ("width 32 x 2^12", lambda: kp.sponge(fold), lambda: kp.sponge_plain(fold))],
          leaf, n_bytes=8 * (cols.numel() + 4 * (1 << 16)),
          n_ops=OPS_PER_PERMUTATION * 17 * (1 << 16))

    # K5: one PoW grind chunk of 2^17 candidates at 16 bits, and a permutation
    inter = rand((12,))
    states = rand((12, 1 << 17))
    chunk = 1 << 17
    thr = 1 << (64 - 16)
    grind = (lambda: kp.grind_chunk(inter, 5, 0, chunk, thr),
             lambda: kp.grind_chunk_plain(inter, 5, 0, chunk, thr))
    check(ops.K5, [("grind 2^17 at 16 bits", *grind),
                   ("permute [12, 2^17]", lambda: kp.permute(states),
                    lambda: kp.permute_plain(states))],
          grind, n_bytes=8 * 13, n_ops=OPS_PER_PERMUTATION * chunk)

    # the main path at the middle-circuit shapes
    config = co.middle_fri_config()
    inputs = co.random_inputs(co.MIDDLE_DEGREE_BITS, co.MIDDLE_COUNTS, seed=SEED)
    t0 = time.perf_counter()
    first = co.commit_and_open(inputs, config, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    proof = co.commit_and_open(inputs, config, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.kid: k.launches for k in ops.KERNELS}
    print(f"commit_and_open middle (2^13; 85/135/20/16): {wall_s:.3f} s "
          f"(first call {first_s:.3f} s), {len(proof)} proof bytes, "
          f"sha256 {hashlib.sha256(proof).hexdigest()}, launches {launches}")
    if proof != first:
        failures.append("two middle-shape runs gave different proof bytes")
    for kid, n in launches.items():
        if n == 0:
            failures.append(f"{kid} was not launched on the main path")
    profile_line(torch, lambda: co.commit_and_open(inputs, config, device=dev), wall_s)

    # kernels vs plain versions end to end at degree 2^10
    small_inputs = co.random_inputs(10, co.MIDDLE_COUNTS, seed=SEED + 1)
    on_card = co.commit_and_open(small_inputs, config, device=dev)
    t0 = time.perf_counter()
    on_cpu = co.commit_and_open(small_inputs, config, device="cpu")
    cpu_s = time.perf_counter() - t0
    h_card = hashlib.sha256(on_card).hexdigest()
    h_cpu = hashlib.sha256(on_cpu).hexdigest()
    print(f"degree 2^10: card sha256 {h_card}, cpu sha256 {h_cpu} (cpu run {cpu_s:.1f} s)")
    if on_card != on_cpu:
        failures.append("degree-2^10 proof bytes differ between the card and the CPU")

    if failures:
        for f in failures:
            print(f"chip_smoke: {f}", file=sys.stderr)
        return 1

    kernels = []
    for k in ops.KERNELS:
        r = results[k.kid]
        kernels.append({"name": f"{k.kid} {k.name}", "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": launches[k.kid],
                        "max_abs_err": r["max_abs_err"], "mismatches": r["mismatches"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels, "card": card,
                      "commit_and_open_middle_s": wall_s}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
