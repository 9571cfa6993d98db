"""The middle-circuit prove of the port against the reference on the CPU.

Reads the bench_recursion middle circuit (`bench_cache/middle14.circuit.bin`,
degree 2^13, 135 wires, 12 gates) and proves it twice over, each time
through the port's plain path on the fused transcript (the default) and on
the host transcript (`force_host_path()`), and through the reference
package's host-transcript path:

  random witness  the witness, public inputs and hash drawn by the port's
                  `random_witness(common, 2026)` (chip_smoke's
                  MIDDLE_PROVE_SHA256)
  headline        bench.py's warm-start work: the inner proof and verifier
                  data (`bench_cache/inner14.*.bin`) fill the proof and
                  verifier-data targets rebuilt on a fresh builder, and the
                  prove runs from that PartialWitness with the rng seeded to
                  2026, witness generation included; the port's witness on
                  both engines (chip_smoke's HEADLINE_WITNESS_SHA256 and
                  HEADLINE_PROOF_SHA256)

Prints each full witness's and proof's sha256, the port's phase splits and
the read times, and runs the reference's `plonky2_verify` binary on the
port's headline proof. Takes several minutes and a few GB of memory; not
collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_middle.py
    JAX_PLATFORMS=cpu python tests/reference_prove_middle.py --inner14

`--inner14` runs the reference alone on the chain that chip_smoke's build
phase runs on the card: it builds the bench_recursion inner circuit at
2^14 (`dummy_proof(config, 14)`, the rng seeded to 2026 before it), prints
its verifier bytes' sha256 (which must be `bench_cache/inner14.verifier.bin`'s)
and its proof's, has the port's verifier check that proof, then proves the
middle circuit from it (the rng seeded to 2026 again) and prints that
proof's sha256: chip_smoke's INNER14_PROOF_SHA256 and
MIDDLE_OVER_INNER14_SHA256. It then builds the reference's outer circuit
over the middle circuit, proves it from that middle proof (the rng seeded
to 2026 again) and prints its sha256: chip_smoke's
OUTER_OVER_INNER14_SHA256.

`--chain4` runs the port alone, on the CPU, on the chain of
`tools/generate_fixtures.py`: `bench_recursion.chain(4, device="cpu")` under the
seed 2026, the middle and outer circuits built by the port's in-circuit
verifier, and holds the outer proof and verifier data to
`fixtures/bench_recursion.proof.bin` and `.verifier.bin` (several minutes,
most of it the plain constants-sigmas commitments).

    JAX_PLATFORMS=cpu python tests/reference_prove_middle.py --chain4
"""

import contextlib
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
import numpy as np  # noqa: E402

from plonky2_tpu import native as jnative  # noqa: E402
from plonky2_tpu.fri import prover as jfp  # noqa: E402
from plonky2_tpu.iop.witness import PartialWitness as JPartialWitness  # noqa: E402
from plonky2_tpu.plonk import prover as jp  # noqa: E402
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder  # noqa: E402
from plonky2_tpu.plonk.circuit_serialization import (  # noqa: E402
    verifier_data_from_bytes as j_verifier_data_from_bytes,
    verifier_data_to_bytes as j_verifier_data_to_bytes,
)
from plonky2_tpu.plonk.config import CircuitConfig  # noqa: E402
from plonky2_tpu.plonk.prover_serialization import circuit_data_from_bytes  # noqa: E402
from plonky2_tpu.plonk.serialization import proof_from_bytes as j_proof_from_bytes  # noqa: E402
from plonky2_tpu.plonk.serialization import proof_to_bytes as j_proof_to_bytes  # noqa: E402
from plonky2_tpu.recursion import recursive_verifier as jrv  # noqa: E402
from plonky2_tpu.util import export_cache  # noqa: E402
from plonky2_tpu.util import rng as jrng  # noqa: E402
from plonky2_torch.fri import prover as tfp  # noqa: E402
from plonky2_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_torch.plonk import prover as tp  # noqa: E402
from plonky2_torch.plonk.circuit_builder import CircuitBuilder  # noqa: E402
from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes  # noqa: E402
from plonky2_torch.plonk.prover_serialization import read_circuit_data  # noqa: E402
from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes  # noqa: E402
from plonky2_torch.recursion import recursive_verifier as trv  # noqa: E402
from plonky2_torch.util import TimingTree  # noqa: E402
from plonky2_torch.util import rng as trng  # noqa: E402

SEED = 2026  # the seed chip_smoke.py draws the middle witness from
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, "bench_cache", *parts), "rb") as f:
        return f.read()


def sha(b) -> str:
    return hashlib.sha256(b if isinstance(b, bytes) else
                          np.ascontiguousarray(b, dtype=np.uint64).tobytes()).hexdigest()


def port_proves(prover_only, common, label, prepared=None, inputs=None):
    """The port's plain-path proves on both transcripts; each re-seeds the
    rng, so a prove from `inputs` draws the same witness."""
    out = []
    for path in ("fused", "host"):
        timing = TimingTree("prove")
        t = time.perf_counter()
        trng.seed(SEED)
        try:
            with tfp.force_host_path() if path == "host" else contextlib.nullcontext():
                port = proof_to_bytes(tp.prove(prover_only, common, inputs, device="cpu",
                                               timing=timing, _prepared=prepared))
        finally:
            trng.seed(None)
        assert tp._LAST_TRANSCRIPT == path
        out.append(port)
        print(f"{label}: port (plain, cpu, {path} transcript): {time.perf_counter() - t:.1f} s, "
              f"{len(port)} bytes, sha256 {sha(port)}; phases "
              f"{ {k: round(v, 3) for k, v in timing.split().items()} }; peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB",
              flush=True)
    return out


def main() -> int:
    blob = _read("middle14.circuit.bin")
    t = time.perf_counter()
    prover_only, common, verifier_only = read_circuit_data(blob)
    print(f"port reader (generators included): {time.perf_counter() - t:.2f} s", flush=True)
    cap = prover_only.commitment(common, "cpu").merkle_tree.cap
    print("constants-sigmas cap equals the file's verifier cap:",
          cap == verifier_only.constants_sigmas_cap, flush=True)
    ok = cap == verifier_only.constants_sigmas_cap

    # the headline's inputs: the inner proof in the rebuilt targets
    t = time.perf_counter()
    inner_vo, inner_common = verifier_data_from_bytes(_read("inner14.verifier.bin"))
    inner_proof = proof_from_bytes(_read("inner14.proof.bin"), inner_common)
    b = CircuitBuilder()
    pt = trv.add_virtual_proof_with_pis(b, inner_common)
    vdt = trv.add_virtual_verifier_data(b, inner_common.config.fri_config.cap_height)
    pw = PartialWitness()
    trv.set_proof_with_pis_target(pw, pt, inner_proof)
    trv.set_verifier_data_target(pw, vdt, inner_vo)
    print(f"port: inner proof read and {len(pw.target_values)} targets filled in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    witnesses = {}
    for engine in ("native", "python", "native"):
        timing = TimingTree("prepare")
        t = time.perf_counter()
        trng.seed(SEED)
        try:
            w, pis, pi_hash = tp.prepare_witness(prover_only, common, pw, timing, engine=engine)
        finally:
            trng.seed(None)
        witnesses[engine] = sha(w)
        print(f"headline: port prepare_witness ({engine} engine): "
              f"{time.perf_counter() - t:.3f} s, phases "
              f"{ {k: round(v, 4) for k, v in timing.split().items()} }; full witness sha256 "
              f"{sha(w)}", flush=True)
    headline = port_proves(prover_only, common, "headline", inputs=pw)
    witness, public_inputs, pi_hash = tp.random_witness(common, SEED)
    ports = port_proves(prover_only, common, "random witness",
                        prepared=(witness, public_inputs, pi_hash))

    export_cache._ENABLED = False
    t = time.perf_counter()
    data = circuit_data_from_bytes(blob)
    print(f"reference reader (commitment included): {time.perf_counter() - t:.1f} s",
          flush=True)
    jvd, jic = j_verifier_data_from_bytes(_read("inner14.verifier.bin"))
    jproof = j_proof_from_bytes(_read("inner14.proof.bin"), jic)
    jb = JBuilder(CircuitConfig.standard_recursion_config())
    jpw = JPartialWitness()
    jrv.set_proof_with_pis_target(jpw, jrv.add_virtual_proof_with_pis(jb, jic), jproof)
    jrv.set_verifier_data_target(jpw, jrv.add_virtual_verifier_data(
        jb, jic.config.fri_config.cap_height), jvd)
    jrng.seed(SEED)
    try:
        jw, _, _ = jp.prepare_witness(data.prover_only, data.common, jpw)
    finally:
        jrng.seed(None)
    print(f"headline: reference full witness sha256 {sha(jw)}", flush=True)
    t = time.perf_counter()
    jrng.seed(SEED)
    try:
        with jfp.force_host_path():
            ref_headline = j_proof_to_bytes(data.prove(jpw))
    finally:
        jrng.seed(None)
    print(f"headline: reference data.prove(pw) (host path, cpu): "
          f"{time.perf_counter() - t:.1f} s, {len(ref_headline)} bytes, sha256 "
          f"{sha(ref_headline)}", flush=True)
    t = time.perf_counter()
    with jfp.force_host_path():
        proof = jp.prove(data.prover_only, data.common, None,
                         _prepared=(witness, public_inputs, pi_hash))
    ref = j_proof_to_bytes(proof)
    print(f"random witness: reference (host path, cpu): {time.perf_counter() - t:.1f} s, "
          f"{len(ref)} bytes, sha256 {sha(ref)}", flush=True)

    verifier = jnative.verifier_binary()
    with tempfile.TemporaryDirectory() as d:
        vd_path, pf_path = os.path.join(d, "middle.verifier.bin"), os.path.join(d, "proof.bin")
        with open(vd_path, "wb") as f:
            f.write(j_verifier_data_to_bytes(data.verifier_only, data.common))
        with open(pf_path, "wb") as f:
            f.write(headline[0])
        run = subprocess.run([verifier, vd_path, pf_path], capture_output=True, text=True,
                             timeout=600)
    print(f"headline: the reference's plonky2_verify on the port's proof: exit "
          f"{run.returncode} {run.stdout.strip()} {run.stderr.strip()}", flush=True)

    same_witness = len(set(witnesses.values())) == 1 and witnesses["native"] == sha(jw)
    same = (all(p == ref for p in ports) and all(p == ref_headline for p in headline))
    print(f"witnesses {'identical' if same_witness else 'DIFFERENT'}; "
          f"proofs {'identical' if same else 'DIFFERENT'}; verifier "
          f"{'accepts' if run.returncode == 0 else 'REJECTS'}")
    return 0 if ok and same and same_witness and run.returncode == 0 else 1


def inner14() -> int:
    from plonky2_tpu.examples.bench_recursion import dummy_proof
    from plonky2_torch.plonk.verifier import verify as port_verify

    export_cache._ENABLED = False
    t = time.perf_counter()
    jrng.seed(SEED)
    try:
        jproof, jvd, jic = dummy_proof(CircuitConfig.standard_recursion_config(), 14)
    finally:
        jrng.seed(None)
    vd_bytes = j_verifier_data_to_bytes(jvd, jic)
    proof_bytes = j_proof_to_bytes(jproof)
    same_vd = vd_bytes == _read("inner14.verifier.bin")
    print(f"inner14: reference dummy_proof(config, 14) (build, prove, verify; cpu): "
          f"{time.perf_counter() - t:.1f} s; verifier data sha256 {sha(vd_bytes)} "
          f"(= bench_cache/inner14.verifier.bin: {same_vd}); proof {len(proof_bytes)} bytes, "
          f"sha256 {sha(proof_bytes)}; peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB", flush=True)
    t = time.perf_counter()
    inner_vo, inner_common = verifier_data_from_bytes(vd_bytes)
    port_verify(proof_from_bytes(proof_bytes, inner_common), inner_vo, inner_common)
    print(f"inner14: the port's verifier accepts it ({time.perf_counter() - t:.1f} s)",
          flush=True)

    data = circuit_data_from_bytes(_read("middle14.circuit.bin"))
    jb = JBuilder(CircuitConfig.standard_recursion_config())
    jpw = JPartialWitness()
    jrv.set_proof_with_pis_target(jpw, jrv.add_virtual_proof_with_pis(jb, jic), jproof)
    jrv.set_verifier_data_target(jpw, jrv.add_virtual_verifier_data(
        jb, jic.config.fri_config.cap_height), jvd)
    t = time.perf_counter()
    jrng.seed(SEED)
    try:
        with jfp.force_host_path():
            middle = data.prove(jpw)
    finally:
        jrng.seed(None)
    data.verify(middle)
    middle_bytes = j_proof_to_bytes(middle)
    print(f"middle over inner14: reference data.prove(pw) (host path, cpu) and verify: "
          f"{time.perf_counter() - t:.1f} s, {len(middle_bytes)} bytes, sha256 "
          f"{sha(middle_bytes)}", flush=True)

    # the outer circuit, built by the reference over the middle circuit and
    # proved from that middle proof
    t = time.perf_counter()
    ob = JBuilder(CircuitConfig.standard_recursion_config())
    opt = jrv.add_virtual_proof_with_pis(ob, data.common)
    ovdt = jrv.add_virtual_verifier_data(ob, data.common.config.fri_config.cap_height)
    jrv.verify_proof(ob, opt, ovdt, data.common)
    ob.register_public_inputs(opt.public_inputs)
    outer_data = ob.build()
    outer_vd = j_verifier_data_to_bytes(outer_data.verifier_only, outer_data.common)
    print(f"outer over middle: reference build (cpu): {time.perf_counter() - t:.1f} s, "
          f"degree 2^{outer_data.common.degree_bits}, {ob.num_gates()} rows, verifier data "
          f"sha256 {sha(outer_vd)}", flush=True)
    opw = JPartialWitness()
    jrv.set_proof_with_pis_target(opw, opt, middle)
    jrv.set_verifier_data_target(opw, ovdt, data.verifier_only)
    t = time.perf_counter()
    jrng.seed(SEED)
    try:
        with jfp.force_host_path():
            outer = outer_data.prove(opw)
    finally:
        jrng.seed(None)
    outer_data.verify(outer)
    outer_bytes = j_proof_to_bytes(outer)
    print(f"outer over middle: reference data.prove(pw) (host path, cpu) and verify: "
          f"{time.perf_counter() - t:.1f} s, {len(outer_bytes)} bytes, sha256 "
          f"{sha(outer_bytes)}", flush=True)
    return 0 if same_vd else 1


def chain4() -> int:
    from plonky2_torch.examples.bench_recursion import chain
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes

    t = time.perf_counter()
    trng.seed(SEED)
    try:
        layers = chain(4, device="cpu")
    finally:
        trng.seed(None)
    proof, data = layers[-1].proof, layers[-1].data
    proof_bytes = proof_to_bytes(proof)
    vd_bytes = verifier_data_to_bytes(data.verifier_only, data.common)
    with open(os.path.join(ROOT, "fixtures", "bench_recursion.proof.bin"), "rb") as f:
        same_proof = proof_bytes == f.read()
    with open(os.path.join(ROOT, "fixtures", "bench_recursion.verifier.bin"), "rb") as f:
        same_vd = vd_bytes == f.read()
    print(f"chain4: the port's bench_recursion.chain(4, device='cpu') under seed {SEED}: "
          f"{time.perf_counter() - t:.1f} s, "
          f"{[(round(x.build_s, 2), round(x.prove_s, 2)) for x in layers]} (each layer's "
          f"build and prove s); degrees {[x.data.common.degree_bits for x in layers]}; outer "
          f"proof sha256 "
          f"{sha(proof_bytes)} (= fixtures/bench_recursion.proof.bin: {same_proof}); verifier "
          f"data sha256 {sha(vd_bytes)} (= fixtures/bench_recursion.verifier.bin: {same_vd})",
          flush=True)
    return 0 if same_proof and same_vd else 1


if __name__ == "__main__":
    if sys.argv[1:] == ["--inner14"]:
        sys.exit(inner14())
    if sys.argv[1:] == ["--chain4"]:
        sys.exit(chain4())
    if len(sys.argv) != 1:
        sys.exit("usage: reference_prove_middle.py [--inner14 | --chain4]")
    sys.exit(main())
