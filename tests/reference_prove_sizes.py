"""The bench_recursion chain at inner 2^18, made by the reference on the CPU.

Runs the reference's `examples/bench_recursion.py` chain at an inner
circuit of 2^(size - 1) + 1 noop gates (degree 2^18) under
`standard_recursion_config()`, in chip_smoke's order: the three circuits
are built first (the inner one, the middle one over the inner common
data, the outer one over the middle common data), then each layer is
proved, the rng seeded to 2026 before each prove. The middle circuit
verifies a proof of degree 2^18, whose query index has 21 bits, so its
`exp_from_bits` takes an ExponentiationGate row. Prints, as soon as each
is known, the sha256 of

  each layer's verifier data (`verifier_data_to_bytes`)
      chip_smoke's SIZES_VERIFIER_SHA256S
  each layer's proof (`proof_to_bytes`)
      chip_smoke's SIZES_PROOF_SHA256S

and the middle circuit's count of ExponentiationGate rows, then runs the
reference's `plonky2_verify` on the outer proof. The times printed are the
reference's on this host's CPU, not device times. On an 8-core x86 CPU,
beside another reference run, it took ~26 min (the builds 396, 40 and
33 s, the proves 648, 289 and 168 s) and a peak of 16.1 GiB. Not
collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_sizes.py [--size 18] [--out DIR]

`--out DIR` writes each layer's verifier data and proof into DIR.
"""

import argparse
import hashlib
import os
import resource
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)

from plonky2_tpu import native as jnative  # noqa: E402
from plonky2_tpu.examples.bench_recursion import _num_dummy_gates  # noqa: E402
from plonky2_tpu.gates.simple_gates import NoopGate  # noqa: E402
from plonky2_tpu.iop.witness import PartialWitness  # noqa: E402
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder  # noqa: E402
from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes  # noqa: E402
from plonky2_tpu.plonk.config import CircuitConfig  # noqa: E402
from plonky2_tpu.plonk.serialization import proof_to_bytes  # noqa: E402
from plonky2_tpu.recursion import recursive_verifier as rv  # noqa: E402
from plonky2_tpu.util import export_cache  # noqa: E402
from plonky2_tpu.util import rng  # noqa: E402

SEED = 2026
LAYERS = ("inner", "middle", "outer")


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def rss() -> str:
    return f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB"


def build_inner(config, size):
    builder = CircuitBuilder(config)
    for _ in range(_num_dummy_gates(size)):
        builder.add_gate(NoopGate(), [])
    return builder.build(), None, builder


def build_recursion(config, inner_common):
    """(data, (proof targets, verifier-data targets)) of the layer that
    verifies a proof of `inner_common`'s circuit (bench_recursion's
    `recursive_proof` without its prove)."""
    builder = CircuitBuilder(config)
    pt = rv.add_virtual_proof_with_pis(builder, inner_common)
    vdt = rv.add_virtual_verifier_data(builder, inner_common.config.fri_config.cap_height)
    rv.verify_proof(builder, pt, vdt, inner_common)
    builder.register_public_inputs(pt.public_inputs)
    return builder.build(), (pt, vdt), builder


def run(size: int, config, label: str, out_dir=None) -> int:
    """Builds, then proves, the chain's layers; returns the exit code."""
    export_cache._ENABLED = False
    datas, targets, proofs = [], [], []
    for name in LAYERS:
        t = time.perf_counter()
        if name == "inner":
            data, tg, builder = build_inner(config, size)
        else:
            data, tg, builder = build_recursion(config, datas[-1].common)
        datas.append(data)
        targets.append(tg)
        vd = verifier_data_to_bytes(data.verifier_only, data.common)
        exp_rows = sum(1 for gi in builder.gate_instances
                       if gi.gate.id().startswith("ExponentiationGate"))
        print(f"{label} {name}: reference build (cpu) {time.perf_counter() - t:.1f} s, "
              f"degree 2^{data.common.degree_bits}, {len(builder.gate_instances)} rows, "
              f"{exp_rows} ExponentiationGate rows; verifier data {len(vd)} bytes, "
              f"sha256 {sha(vd)}; peak RSS {rss()}", flush=True)
        if out_dir:
            with open(os.path.join(out_dir, f"{label}_{name}.verifier.bin"), "wb") as f:
                f.write(vd)
    for i, name in enumerate(LAYERS):
        data = datas[i]
        pw = PartialWitness()
        if i:
            pt, vdt = targets[i]
            rv.set_proof_with_pis_target(pw, pt, proofs[-1])
            rv.set_verifier_data_target(pw, vdt, datas[i - 1].verifier_only)
        t = time.perf_counter()
        rng.seed(SEED)
        try:
            proof = data.prove(pw)
        finally:
            rng.seed(None)
        prove_s = time.perf_counter() - t
        t = time.perf_counter()
        data.verify(proof)
        proofs.append(proof)
        pb = proof_to_bytes(proof)
        print(f"{label} {name}: reference prove (cpu) {prove_s:.1f} s, verify "
              f"{time.perf_counter() - t:.1f} s, {len(pb)} bytes, sha256 {sha(pb)}; "
              f"peak RSS {rss()}", flush=True)
        if out_dir:
            with open(os.path.join(out_dir, f"{label}_{name}.proof.bin"), "wb") as f:
                f.write(pb)
    data = datas[-1]
    with tempfile.TemporaryDirectory() as d:
        vd_path, pf_path = os.path.join(d, "verifier.bin"), os.path.join(d, "proof.bin")
        with open(vd_path, "wb") as f:
            f.write(verifier_data_to_bytes(data.verifier_only, data.common))
        with open(pf_path, "wb") as f:
            f.write(proof_to_bytes(proofs[-1]))
        run_ = subprocess.run([jnative.verifier_binary(), vd_path, pf_path],
                              capture_output=True, text=True, timeout=600)
    print(f"{label} {LAYERS[-1]}: the reference's plonky2_verify: exit {run_.returncode} "
          f"{run_.stdout.strip()} {run_.stderr.strip()}", flush=True)
    return run_.returncode


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=18)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    return run(args.size, CircuitConfig.standard_recursion_config(), f"sizes{args.size}",
               args.out)


if __name__ == "__main__":
    sys.exit(main())
