"""The bench_recursion chains over the two lookup inner circuits, made by the
reference on the CPU.

For `--lookup-type` 1 (the inner circuit of the reference's
`dummy_lookup_proof`: one lookup into the TIP5 table, its input a public
input) and 2 (`dummy_many_rows_proof`: 515 lookups on the TIP5 table),
each padded with noop gates to 2^(size - 1) + 1 rows as the reference's
`run_chain(size, lookup_type=...)` pads it, runs chip_smoke's order: the
three circuits are built first (the inner one, the middle one over the
inner common data, the outer one over the middle common data), then each
layer is proved, the rng seeded to 2026 before each prove, the inner
layer's lookup input set to 2. Prints, as soon as each is known, the
sha256 of

  each layer's verifier data (`verifier_data_to_bytes`)
      chip_smoke's LOOKUP_VERIFIER_SHA256S[lookup type]
  each layer's proof (`proof_to_bytes`)
      chip_smoke's LOOKUP_PROOF_SHA256S[lookup type]

then runs the reference's `plonky2_verify` on each chain's outer proof.
The times printed are the reference's on this host's CPU, not device
times. On an 8-core x86 CPU, the two chains run as two processes side by
side, each took ~11 min (the builds 34, 27 and 11 s, the proves 280, 214
to 226 and 69 to 78 s) and a peak of 5.8 GiB. Not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_lookups.py [--size 14]
        [--lookup-type 1|2 ...] [--out DIR]

`--out DIR` writes each layer's verifier data and proof into DIR.
`lookup_circuit` builds either inner circuit on a builder of either
package (`tests/torch_make_data.py --lookups` and the port's tests use it).
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

SEED = 2026
LAYERS = ("inner", "middle", "outer")
INITIAL_A = 2  # the reference's dummy_lookup_proof / dummy_many_rows_proof input


def num_dummy_gates(log2_size: int) -> int:
    return 0 if log2_size == 1 else (1 if log2_size == 2 else (1 << (log2_size - 1)) + 1)


def lookup_circuit(builder_cls, noop_cls, tip5_table, config, lookup_type: int,
                   size=None):
    """(builder, lookup input target) of the reference's lookup inner
    circuit of `lookup_type` (bench_recursion.rs:107-200) on a builder of
    either package, padded with noops to num_dummy_gates(size) rows where
    `size` is given; set the input to INITIAL_A."""
    builder = builder_cls(config)
    tip5 = builder.add_lookup_table_from_table(list(range(256)), list(tip5_table))
    initial_a = builder.add_virtual_target()
    if lookup_type == 1:
        builder.add_lookup_from_index(initial_a, tip5)
        builder.register_public_input(initial_a)
    elif lookup_type == 2:
        output = builder.add_lookup_from_index(initial_a, tip5)
        for _ in range(514):
            builder.add_lookup_from_index(output, 0)
    else:
        raise ValueError(f"lookup type {lookup_type} is not 1 or 2")
    if size is not None:
        target = num_dummy_gates(size)
        if target < builder.num_gates():
            raise ValueError("size too small to support lookups")
        for _ in range(builder.num_gates(), target):
            builder.add_gate(noop_cls(), [])
    return builder, initial_a


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def rss() -> str:
    return f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB"


def run(size: int, lookup_type: int, out_dir=None) -> int:
    """Builds, then proves, one chain's layers; returns plonky2_verify's
    exit code on the outer proof."""
    from plonky2_tpu import native as jnative
    from plonky2_tpu.gadgets.lookup import TIP5_TABLE
    from plonky2_tpu.gates.simple_gates import NoopGate
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.recursion import recursive_verifier as rv
    from plonky2_tpu.util import export_cache, rng

    export_cache._ENABLED = False
    config = CircuitConfig.standard_recursion_config()
    label = f"lookup{lookup_type}_{size}"
    datas, targets, proofs = [], [], []
    for name in LAYERS:
        t = time.perf_counter()
        if name == "inner":
            builder, initial_a = lookup_circuit(CircuitBuilder, NoopGate, TIP5_TABLE, config,
                                                lookup_type, size)
            tg = initial_a
        else:
            builder = CircuitBuilder(config)
            inner_common = datas[-1].common
            pt = rv.add_virtual_proof_with_pis(builder, inner_common)
            vdt = rv.add_virtual_verifier_data(builder, inner_common.config.fri_config.cap_height)
            rv.verify_proof(builder, pt, vdt, inner_common)
            builder.register_public_inputs(pt.public_inputs)
            tg = (pt, vdt)
        data = builder.build()
        datas.append(data)
        targets.append(tg)
        vd = verifier_data_to_bytes(data.verifier_only, data.common)
        print(f"{label} {name}: reference build (cpu) {time.perf_counter() - t:.1f} s, "
              f"degree 2^{data.common.degree_bits}, {len(builder.gate_instances)} rows, "
              f"{data.common.num_lookup_polys} lookup polys a challenge, "
              f"{len(data.common.luts)} LUTs; verifier data {len(vd)} bytes, "
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
        else:
            pw.set_target(targets[0], INITIAL_A)
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
    p.add_argument("--size", type=int, default=14)
    p.add_argument("--lookup-type", type=int, nargs="+", default=[1, 2])
    p.add_argument("--out", default=None)
    args = p.parse_args()
    import conftest  # noqa: F401  (JAX on the CPU, x64)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    rc = 0
    for lookup_type in args.lookup_type:
        rc |= run(args.size, lookup_type, args.out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
