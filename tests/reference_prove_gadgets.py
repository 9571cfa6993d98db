"""The gadgets circuit of chip_smoke's `gadgets` phase, made by the reference.

Builds `plonky2_torch/examples/gadgets.py`'s circuit (its CIRCUIT_CASES on
one builder at `standard_recursion_config`) with the reference package's
builder, proves it on the CPU with the rng seeded to 2026, verifies it
with the reference's verifier and its `plonky2_verify`, and prints the
sha256 of

  the verifier data     chip_smoke's GADGETS_VERIFIER_SHA256
  the proof             GADGETS_PROOF_SHA256

`tests/torch_make_data.py --gadgets` writes the same bytes to
`plonky2_torch/data/gadgets.{verifier,proof}.bin`. With `--port` the port
then builds and proves the same circuit on the CPU (its plain kernels,
~1 min) and the script holds its bytes to the reference's. Not collected
by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_gadgets.py [--port]
"""

import hashlib
import os
import subprocess
import sys
import tempfile
import time
import types

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 2026


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def reference_gadgets() -> tuple[bytes, bytes]:
    """(verifier bytes, proof bytes) of the reference's build and prove."""
    import conftest  # noqa: F401  (JAX on the CPU, x64)

    from plonky2_tpu import native as jnative
    from plonky2_tpu.gadgets import algebra_gadgets as jag
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.recursion.recursive_verifier import VerifierCircuitTarget
    from plonky2_tpu.util import rng
    from plonky2_torch.examples import gadgets as eg

    kinds = types.SimpleNamespace(
        PolynomialCoeffsExtTarget=jag.PolynomialCoeffsExtTarget,
        PolynomialCoeffsExtAlgebraTarget=jag.PolynomialCoeffsExtAlgebraTarget,
        VerifierCircuitTarget=VerifierCircuitTarget)
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    inputs = eg.add_cases(builder, kinds)
    t0 = time.perf_counter()
    data = builder.build()
    print(f"reference build: 2^{data.common.degree_bits} rows, "
          f"{time.perf_counter() - t0:.1f} s")
    pw = PartialWitness()
    for t, v in inputs:
        pw.set_target(t, v)
    rng.seed(SEED)
    try:
        t0 = time.perf_counter()
        proof = data.prove(pw)
    finally:
        rng.seed(None)
    print(f"reference prove: {time.perf_counter() - t0:.1f} s")
    data.verify(proof)
    vd = verifier_data_to_bytes(data.verifier_only, data.common)
    pf = proof_to_bytes(proof)
    with tempfile.TemporaryDirectory() as d:
        vd_path, pf_path = os.path.join(d, "vd.bin"), os.path.join(d, "pf.bin")
        for path, blob in ((vd_path, vd), (pf_path, pf)):
            with open(path, "wb") as f:
                f.write(blob)
        run = subprocess.run([jnative.verifier_binary(), vd_path, pf_path],
                             capture_output=True, text=True, timeout=300)
        print(f"reference plonky2_verify: rc {run.returncode} {run.stdout.strip()}")
        if run.returncode:
            raise SystemExit(f"plonky2_verify refused the proof: {run.stderr}")
    return vd, pf


def port_gadgets() -> tuple[bytes, bytes]:
    """The port's CPU build and prove of the same circuit."""
    from plonky2_torch.examples import gadgets as eg
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import rng

    data, pw = eg.circuit("cpu")
    rng.seed(SEED)
    try:
        proof = data.prove(pw, device="cpu")
    finally:
        rng.seed(None)
    data.verify(proof)
    return verifier_data_to_bytes(data.verifier_only, data.common), proof_to_bytes(proof)


def main() -> int:
    vd, pf = reference_gadgets()
    print(f"GADGETS_VERIFIER_SHA256 = {sha(vd)}  ({len(vd)} bytes)")
    print(f"GADGETS_PROOF_SHA256 = {sha(pf)}  ({len(pf)} bytes)")
    if "--port" in sys.argv[1:]:
        t0 = time.perf_counter()
        pvd, ppf = port_gadgets()
        print(f"port (cpu) {time.perf_counter() - t0:.1f} s: verifier data equal {pvd == vd}, "
              f"proof equal {ppf == pf}")
        if (pvd, ppf) != (vd, pf):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
