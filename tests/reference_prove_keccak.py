"""The Keccak wrap of the headline proof, made by the reference on the CPU.

Makes the headline's middle proof as `tests/reference_prove_middle.py`
does (bench.py's warm-start work: the inner proof and verifier data of
`bench_cache/inner14.*.bin` in the proof targets rebuilt on a fresh
builder, `bench_cache/middle14.circuit.bin` proved from them with the rng
seeded to 2026), then builds the wrap: the bench_recursion outer layer
(`examples/bench_recursion.py:recursive_proof`) on a builder under
`keccak_goldilocks_config()`, so its Merkle caps and transcript are Keccak
and its in-circuit verifier checks the Poseidon middle proof. It proves the
wrap from the middle proof (the rng seeded to 2026), verifies it, compresses
it and the middle proof, and prints the sha256 of

  the middle proof                 chip_smoke's HEADLINE_PROOF_SHA256
  the middle proof, compressed     KECCAK_HEADLINE_COMPRESSED_SHA256
  the wrap's verifier data         KECCAK_WRAP_VERIFIER_SHA256
  the wrap's proof                 KECCAK_WRAP_PROOF_SHA256
  the wrap's proof, compressed     KECCAK_WRAP_COMPRESSED_SHA256

then runs the reference's `plonky2_verify --keccak` on the wrap's proof.
Not collected by pytest. On a 4-core x86 CPU it took 7.5 min (the
middle prove and its compression 286 s, the wrap's build 17 s and its
prove 120 s) and a peak of 2.8 GiB.

    JAX_PLATFORMS=cpu python tests/reference_prove_keccak.py [--out DIR] [--port DIR]

`--out DIR` also writes the middle proof, the wrap's verifier data, proof
and compressed proof, and the middle proof compressed, as files in DIR.
`--port DIR` runs the port alone, on the CPU, against the files that
`--out DIR` wrote: it builds the wrap over the middle proof read from DIR,
proves it under seed 2026, compresses both proofs and holds every byte to
the reference's (~1 min: the plain 2^16-point LDEs and quotient on the
CPU, the Keccak trees on the native keccak-f).
"""

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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = {"middle": "middle.proof.bin", "middle_compressed": "middle.compressed.bin",
         "wrap_vd": "wrap.verifier.bin", "wrap": "wrap.proof.bin",
         "wrap_compressed": "wrap.compressed.bin"}


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def rss() -> str:
    return f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB"


def reference(out_dir) -> int:
    import conftest  # noqa: F401  (JAX on the CPU, x64)

    from plonky2_tpu import native as jnative
    from plonky2_tpu.fri import prover as jfp
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import (
        verifier_data_from_bytes,
        verifier_data_to_bytes,
    )
    from plonky2_tpu.plonk.config import CircuitConfig, keccak_goldilocks_config
    from plonky2_tpu.plonk.prover_serialization import circuit_data_from_bytes
    from plonky2_tpu.plonk.serialization import (
        compressed_proof_to_bytes,
        proof_from_bytes,
        proof_to_bytes,
    )
    from plonky2_tpu.recursion import recursive_verifier as rv
    from plonky2_tpu.util import export_cache
    from plonky2_tpu.util import rng

    export_cache._ENABLED = False
    out = {}
    t = time.perf_counter()
    middle_data = circuit_data_from_bytes(_read("bench_cache", "middle14.circuit.bin"))
    inner_vd, inner_common = verifier_data_from_bytes(_read("bench_cache",
                                                            "inner14.verifier.bin"))
    inner_proof = proof_from_bytes(_read("bench_cache", "inner14.proof.bin"), inner_common)
    b = CircuitBuilder(CircuitConfig.standard_recursion_config())
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, rv.add_virtual_proof_with_pis(b, inner_common),
                                 inner_proof)
    rv.set_verifier_data_target(pw, rv.add_virtual_verifier_data(
        b, inner_common.config.fri_config.cap_height), inner_vd)
    rng.seed(SEED)
    try:
        with jfp.force_host_path():
            middle = middle_data.prove(pw)
    finally:
        rng.seed(None)
    out["middle"] = proof_to_bytes(middle)
    out["middle_compressed"] = compressed_proof_to_bytes(middle_data.compress(middle),
                                                         middle_data.common)
    print(f"middle (the headline proof): reference read, prove and compress (cpu): "
          f"{time.perf_counter() - t:.1f} s, sha256 {sha(out['middle'])}; compressed "
          f"{len(out['middle_compressed'])} of {len(out['middle'])} bytes, sha256 "
          f"{sha(out['middle_compressed'])}; peak RSS {rss()}", flush=True)

    t = time.perf_counter()
    wb = CircuitBuilder(CircuitConfig.standard_recursion_config(), gc=keccak_goldilocks_config())
    pt = rv.add_virtual_proof_with_pis(wb, middle_data.common)
    vdt = rv.add_virtual_verifier_data(wb, middle_data.common.config.fri_config.cap_height)
    rv.verify_proof(wb, pt, vdt, middle_data.common)
    wb.register_public_inputs(pt.public_inputs)
    wrap = wb.build()
    out["wrap_vd"] = verifier_data_to_bytes(wrap.verifier_only, wrap.common)
    print(f"wrap: reference build (cpu): {time.perf_counter() - t:.1f} s, degree "
          f"2^{wrap.common.degree_bits}, verifier data sha256 {sha(out['wrap_vd'])}",
          flush=True)
    wpw = PartialWitness()
    rv.set_proof_with_pis_target(wpw, pt, middle)
    rv.set_verifier_data_target(wpw, vdt, middle_data.verifier_only)
    t = time.perf_counter()
    rng.seed(SEED)
    try:
        proof = wrap.prove(wpw)
    finally:
        rng.seed(None)
    prove_s = time.perf_counter() - t
    t = time.perf_counter()
    wrap.verify(proof)
    verify_s = time.perf_counter() - t
    out["wrap"] = proof_to_bytes(proof)
    compressed = wrap.compress(proof)
    wrap.verify_compressed(compressed)
    out["wrap_compressed"] = compressed_proof_to_bytes(compressed, wrap.common)
    print(f"wrap: reference prove (cpu) {prove_s:.1f} s, verify {verify_s:.1f} s, "
          f"{len(out['wrap'])} bytes, sha256 {sha(out['wrap'])}; compressed "
          f"{len(out['wrap_compressed'])} bytes, sha256 {sha(out['wrap_compressed'])}; "
          f"peak RSS {rss()}", flush=True)

    with tempfile.TemporaryDirectory() as d:
        vd_path, pf_path = os.path.join(d, "wrap.verifier.bin"), os.path.join(d, "wrap.bin")
        for path, key in ((vd_path, "wrap_vd"), (pf_path, "wrap")):
            with open(path, "wb") as f:
                f.write(out[key])
        run = subprocess.run([jnative.verifier_binary(), "--keccak", vd_path, pf_path],
                             capture_output=True, text=True, timeout=600)
    print(f"wrap: the reference's plonky2_verify --keccak: exit {run.returncode} "
          f"{run.stdout.strip()} {run.stderr.strip()}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for key, name in NAMES.items():
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(out[key])
    for key in NAMES:
        print(f"{key}: sha256 {sha(out[key])}")
    return 0 if run.returncode == 0 else 1


def port(ref_dir) -> int:
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.compressed import compress, decompress, verify_compressed
    from plonky2_torch.plonk.config import CircuitConfig, keccak_goldilocks_config
    from plonky2_torch.plonk.prover_serialization import read_circuit_data
    from plonky2_torch.plonk.serialization import (
        compressed_proof_from_bytes,
        compressed_proof_to_bytes,
        proof_from_bytes,
        proof_to_bytes,
    )
    from plonky2_torch.recursion import recursive_verifier as rv
    from plonky2_torch.util import TimingTree
    from plonky2_torch.util import rng

    ref = {}
    for key, name in NAMES.items():
        with open(os.path.join(ref_dir, name), "rb") as f:
            ref[key] = f.read()
    prover_only, common, verifier_only = read_circuit_data(_read("bench_cache",
                                                                 "middle14.circuit.bin"))
    middle = proof_from_bytes(ref["middle"], common)
    got = {"middle": proof_to_bytes(middle)}
    cm = compress(middle, verifier_only, common)
    got["middle_compressed"] = compressed_proof_to_bytes(cm, common)
    back = decompress(compressed_proof_from_bytes(got["middle_compressed"], common),
                      verifier_only, common)
    ok = proof_to_bytes(back) == ref["middle"]
    t = time.perf_counter()
    timing = TimingTree("build")
    wb = CircuitBuilder(CircuitConfig.standard_recursion_config(), gc=keccak_goldilocks_config())
    pt = rv.add_virtual_proof_with_pis(wb, common)
    vdt = rv.add_virtual_verifier_data(wb, common.config.fri_config.cap_height)
    rv.verify_proof(wb, pt, vdt, common)
    wb.register_public_inputs(pt.public_inputs)
    wrap = wb.build(device="cpu", timing=timing)
    got["wrap_vd"] = verifier_data_to_bytes(wrap.verifier_only, wrap.common)
    print(f"wrap: port build (cpu): {time.perf_counter() - t:.1f} s, "
          f"{ {k: round(v, 2) for k, v in timing.split().items()} }", flush=True)
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, pt, middle)
    rv.set_verifier_data_target(pw, vdt, verifier_only)
    timing = TimingTree("prove")
    t = time.perf_counter()
    rng.seed(SEED)
    try:
        proof = wrap.prove(pw, device="cpu", timing=timing)
    finally:
        rng.seed(None)
    print(f"wrap: port prove (cpu): {time.perf_counter() - t:.1f} s, "
          f"{ {k: round(v, 2) for k, v in timing.split().items()} }; peak RSS {rss()}",
          flush=True)
    wrap.verify(proof)
    got["wrap"] = proof_to_bytes(proof)
    cw = compress(proof, wrap.verifier_only, wrap.common)
    verify_compressed(cw, wrap.verifier_only, wrap.common)
    got["wrap_compressed"] = compressed_proof_to_bytes(cw, wrap.common)
    for key in NAMES:
        same = got[key] == ref[key]
        ok = ok and same
        print(f"{key}: port sha256 {sha(got[key])}, the reference's: {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--port"] and len(args) == 2:
        sys.exit(port(args[1]))
    if args and (args[0] != "--out" or len(args) != 2):
        sys.exit("usage: reference_prove_keccak.py [--out DIR | --port DIR]")
    sys.exit(reference(args[1] if args else None))
