"""The middle-circuit prove of the port against the reference on the CPU.

Reads the bench_recursion middle circuit (`bench_cache/middle14.circuit.bin`,
degree 2^13, 135 wires, 12 gates), draws the witness, public inputs and
their hash with the port's `random_witness(common, 2026)`, and proves it
three times: through the port's plain path on the fused transcript (the
default) and on the host transcript (`force_host_path()`), and through the
reference package's host-transcript path. Prints each proof's sha256
(`chip_smoke.py` pins it for the proves on the card), the port's phase
splits and the read times. Takes several minutes and a few GB of memory;
not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_middle.py
"""

import contextlib
import hashlib
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)
from plonky2_tpu.fri import prover as jfp  # noqa: E402
from plonky2_tpu.plonk import prover as jp  # noqa: E402
from plonky2_tpu.plonk.prover_serialization import circuit_data_from_bytes  # noqa: E402
from plonky2_tpu.plonk.serialization import proof_to_bytes as j_proof_to_bytes  # noqa: E402
from plonky2_tpu.util import export_cache  # noqa: E402
from plonky2_torch.fri import prover as tfp  # noqa: E402
from plonky2_torch.plonk import prover as tp  # noqa: E402
from plonky2_torch.plonk.prover_serialization import read_circuit_data  # noqa: E402
from plonky2_torch.plonk.serialization import proof_to_bytes  # noqa: E402
from plonky2_torch.util import TimingTree  # noqa: E402

SEED = 2026  # the seed chip_smoke.py draws the middle witness from
MIDDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "bench_cache", "middle14.circuit.bin")


def main() -> int:
    with open(MIDDLE, "rb") as f:
        blob = f.read()
    t = time.perf_counter()
    prover_only, common, verifier_only = read_circuit_data(blob)
    print(f"port reader: {time.perf_counter() - t:.2f} s", flush=True)
    witness, public_inputs, pi_hash = tp.random_witness(common, SEED)
    ports = []
    for path in ("fused", "host"):
        timing = TimingTree("prove")
        t = time.perf_counter()
        with tfp.force_host_path() if path == "host" else contextlib.nullcontext():
            port = proof_to_bytes(tp.prove(prover_only, common, witness, public_inputs,
                                           pi_hash, device="cpu", timing=timing))
        assert tp._LAST_TRANSCRIPT == path
        ports.append(port)
        print(f"port (plain, cpu, {path} transcript): {time.perf_counter() - t:.1f} s, "
              f"{len(port)} bytes, sha256 {hashlib.sha256(port).hexdigest()}; phases "
              f"{ {k: round(v, 2) for k, v in timing.split().items()} }; peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB",
              flush=True)
    cap = prover_only.commitment(common, "cpu").merkle_tree.cap
    print("constants-sigmas cap equals the file's verifier cap:",
          cap == verifier_only.constants_sigmas_cap, flush=True)

    export_cache._ENABLED = False
    t = time.perf_counter()
    data = circuit_data_from_bytes(blob)
    print(f"reference reader (commitment included): {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    with jfp.force_host_path():
        proof = jp.prove(data.prover_only, data.common, None,
                         _prepared=(witness, public_inputs, pi_hash))
    ref = j_proof_to_bytes(proof)
    print(f"reference (host path, cpu): {time.perf_counter() - t:.1f} s, {len(ref)} bytes, "
          f"sha256 {hashlib.sha256(ref).hexdigest()}")
    same = all(p == ref for p in ports)
    print("identical" if same else "DIFFERENT")
    return 0 if same and cap == verifier_only.constants_sigmas_cap else 1


if __name__ == "__main__":
    sys.exit(main())
