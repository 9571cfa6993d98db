"""The IVC hash chain of chip_smoke's `cyclic` phase, made by the reference.

Runs `tests/validation_cyclic.py`'s flow with the reference package on the
CPU, with the prover rng seeded to 2026 at each step that draws from it:

  fixpoint  the common data for recursion: an empty circuit, a circuit
            verifying its proof (degree 2^11), and one verifying that
            (degree 2^13; the flow's padding to 2^12 adds nothing)
  cyclic    the hash-chain circuit (public inputs: the initial hash, the
            chain tip, the counter, then its own verification key) that
            verifies a proof of itself or a dummy proof, the rng seeded
            before its construction (the build proves a dummy circuit)
  base      `cyclic_base_proof` and the base case's prove, the rng seeded
            before them
  layer k   the self-verifying layers 1 and 2, the rng seeded before each

and prints the sha256 of the fixpoint's verifier bytes
(`verifier_data_to_bytes`), of the cyclic circuit's, and of each proof
(`proof_to_bytes`): chip_smoke's CYCLIC_FIXPOINT_VERIFIER_SHA256,
CYCLIC_VERIFIER_SHA256 and CYCLIC_PROOF_SHA256S. Each proof is checked by
`check_cyclic_proof_verifier_data` and the reference's verifier, its
counter and its chain tip against `hash_no_pad`. The times printed are
the reference's on this host's CPU, not device times. Takes ~15 minutes
and a few GB of memory; not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_cyclic.py
    JAX_PLATFORMS=cpu python tests/reference_prove_cyclic.py --port

With `--port` the port also builds the fixpoint on the CPU (its plain
kernels; a few minutes, most of it the plain constants-sigmas
commitment of the 2^13 circuit) and holds its verifier bytes to the
reference's.
"""

import argparse
import hashlib
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)

from plonky2_tpu.gates.simple_gates import NoopGate  # noqa: E402
from plonky2_tpu.hash import poseidon as ps  # noqa: E402
from plonky2_tpu.iop.witness import PartialWitness  # noqa: E402
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder  # noqa: E402
from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes  # noqa: E402
from plonky2_tpu.plonk.config import CircuitConfig  # noqa: E402
from plonky2_tpu.plonk.serialization import proof_to_bytes  # noqa: E402
from plonky2_tpu.recursion.cyclic_recursion import (  # noqa: E402
    add_verifier_data_public_inputs,
    check_cyclic_proof_verifier_data,
    conditionally_verify_cyclic_proof_or_dummy,
)
from plonky2_tpu.recursion.dummy_circuit import cyclic_base_proof  # noqa: E402
from plonky2_tpu.recursion.recursive_verifier import (  # noqa: E402
    add_virtual_proof_with_pis,
    add_virtual_verifier_data,
    set_proof_with_pis_target,
    set_verifier_data_target,
    verify_proof,
)
from plonky2_tpu.util import rng  # noqa: E402

SEED = 2026
INITIAL = [0, 1, 2, 3]
LAYERS = 2


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def seeded(run):
    rng.seed(SEED)
    try:
        return run()
    finally:
        rng.seed(None)


def fixpoint():
    """validation_cyclic's common_data_for_recursion, returning the
    level-1 circuit's data (the function there returns its common data)."""
    config = CircuitConfig.standard_recursion_config()
    data = CircuitBuilder(config).build()
    for level in range(2):
        builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
        pt = add_virtual_proof_with_pis(builder, data.common)
        vdt = add_virtual_verifier_data(builder, config.fri_config.cap_height)
        verify_proof(builder, pt, vdt, data.common)
        if level == 1:
            while builder.num_gates() < (1 << 12):
                builder.add_gate(NoopGate(), [])
        data = builder.build()
    return data


def cyclic_circuit(common_data):
    """validation_cyclic.main's circuit: (data, condition, inner proof
    targets, verifier-data targets)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    one = builder.one()
    initial_hash = builder.add_virtual_hash()
    builder.register_public_inputs(initial_hash)
    current_hash_in = builder.add_virtual_hash()
    current_hash_out = builder.hash_n_to_hash_no_pad(list(current_hash_in))
    builder.register_public_inputs(current_hash_out)
    counter = builder.add_virtual_public_input()
    verifier_data_target = add_verifier_data_public_inputs(builder)
    common_data.num_public_inputs = builder.num_public_inputs()
    condition = builder.add_virtual_bool_target_safe()
    inner = add_virtual_proof_with_pis(builder, common_data)
    inner_pis = inner.public_inputs
    builder.connect_hashes(initial_hash, inner_pis[0:4])
    actual_hash_in = builder.select_hash(condition, inner_pis[4:8], initial_hash)
    builder.connect_hashes(current_hash_in, actual_hash_in)
    builder.connect(counter, builder.mul_add(condition.target, inner_pis[8], one))
    conditionally_verify_cyclic_proof_or_dummy(builder, condition, inner, common_data)
    return builder.build(), condition, inner, verifier_data_target


def port_fixpoint() -> bytes:
    from plonky2_torch.examples.cyclic_recursion import common_data_for_recursion as port_cdr
    from plonky2_torch.plonk.circuit_serialization import (
        verifier_data_to_bytes as port_verifier_data_to_bytes,
    )

    data = port_cdr(device="cpu")
    return port_verifier_data_to_bytes(data.verifier_only, data.common)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", action="store_true",
                   help="also build the fixpoint with the port on the CPU")
    args = p.parse_args()
    t0 = time.perf_counter()
    fix = fixpoint()
    common_data = fix.common
    fix_bytes = verifier_data_to_bytes(fix.verifier_only, common_data)
    print(f"fixpoint (degree 2^{common_data.degree_bits}, {len(common_data.gates)} gates): "
          f"verifier bytes {len(fix_bytes)}, sha256 {sha(fix_bytes)}; "
          f"{time.perf_counter() - t0:.1f} s on this host's CPU", flush=True)
    if args.port:
        t = time.perf_counter()
        port_bytes = port_fixpoint()
        print(f"port fixpoint on the CPU: sha256 {sha(port_bytes)}, equal to the reference's: "
              f"{port_bytes == fix_bytes}; {time.perf_counter() - t:.1f} s", flush=True)
        if port_bytes != fix_bytes:
            return 1

    t = time.perf_counter()
    data, condition, inner, vdt = seeded(lambda: cyclic_circuit(common_data))
    cyclic_bytes = verifier_data_to_bytes(data.verifier_only, data.common)
    print(f"cyclic circuit (degree 2^{data.common.degree_bits}, "
          f"{data.common.num_public_inputs} public inputs, {len(data.prover_only.generators)} "
          f"generators): verifier sha256 {sha(cyclic_bytes)}; built in "
          f"{time.perf_counter() - t:.1f} s on this host's CPU (a dummy build and prove "
          f"included)", flush=True)

    proofs = []
    for layer in range(LAYERS + 1):
        t = time.perf_counter()
        pw = PartialWitness()
        pw.set_bool_target(condition, layer > 0)
        if layer == 0:
            def run():
                base = cyclic_base_proof(common_data, data.verifier_only, dict(enumerate(INITIAL)))
                set_proof_with_pis_target(pw, inner, base)
                set_verifier_data_target(pw, vdt, data.verifier_only)
                return data.prove(pw)
        else:
            set_proof_with_pis_target(pw, inner, proofs[-1])
            set_verifier_data_target(pw, vdt, data.verifier_only)

            def run():
                return data.prove(pw)
        proof = seeded(run)
        prove_s = time.perf_counter() - t
        t = time.perf_counter()
        check_cyclic_proof_verifier_data(proof, data.verifier_only, data.common)
        data.verify(proof)
        verify_s = time.perf_counter() - t
        h = INITIAL
        for _ in range(layer + 1):
            h = ps.hash_no_pad(h)
        assert proof.public_inputs[8] == layer + 1, proof.public_inputs[8]
        assert proof.public_inputs[4:8] == h, "hash chain mismatch"
        blob = proof_to_bytes(proof)
        print(f"{'base' if layer == 0 else f'layer {layer}'}: counter "
              f"{proof.public_inputs[8]}, tip {proof.public_inputs[4:8]}; proof "
              f"{len(blob)} bytes, sha256 {sha(blob)}; prove {prove_s:.1f} s, verify "
              f"{verify_s:.1f} s on this host's CPU", flush=True)
        proofs.append(proof)
    print(f"reference IVC chain: {time.perf_counter() - t0:.1f} s on this host's CPU, peak "
          f"resident {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GB",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
