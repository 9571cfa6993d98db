"""STARK -> SNARK recursion at chip_smoke's `stark_recursion` sizes, made by the
reference on the CPU.

Fixed degree: the 2^20-row FibonacciStark and LookupTestStark proofs of
`tests/reference_prove_stark.py` (StarkConfig.standard_fast_config(); their
sha256s are chip_smoke's FIB20_PROOF_SHA256 and LOOKUP20_PROOF_SHA256), each
verified in a circuit under `standard_recursion_config()`
(`add_virtual_stark_proof_with_pis`, `verify_stark_proof_circuit`, the
public inputs registered), as tests/test_stark_recursion.py does at 2^5.
Variable degree: one circuit (`with_degree_target=True`, max degree bits
18, `min_degree_bits_to_support` 12, standard_fast_config at its 84
queries, the public inputs registered) proves FibonacciStark proofs of 2^14
and 2^17 rows made with `verifier_circuit_fri_params = fri_params(18)`,
each first accepted by `verify_stark_proof` under the same parameters.
Every wrap is proved with the rng seeded to 2026, verified, and run through
the reference's `plonky2_verify`. Prints the sha256 of

  each wrap circuit's verifier data   chip_smoke's STARK_WRAP_VERIFIER_SHA256S
  each wrap proof (`proof_to_bytes`)  STARK_WRAP_PROOF_SHA256S
  the two variable-degree STARK proofs (`stark_proof_to_bytes`)
                                      STARK_VAR_PROOF_SHA256S

The times printed are the reference's on this host's CPU, not device
times. Not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_stark_recursion.py [--out DIR]
        [--fixed-log 20] [--var 18 12 14 17] [--queries 84]

`fixed_wrap` and `variable_wrap` run any size (`tests/torch_make_data.py
--stark-recursion` uses them at the CPU tests' sizes).
"""

import argparse
import dataclasses
import hashlib
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 2026


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def rss() -> str:
    return f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB"


def stark_config(queries=None):
    """standard_fast_config, with `queries` FRI queries where given."""
    from plonky2_tpu.starky.config import StarkConfig

    config = StarkConfig.standard_fast_config()
    if queries is None:
        return config
    return dataclasses.replace(config, fri_config=dataclasses.replace(
        config.fri_config, num_query_rounds=queries))


def case(name: str, log_rows: int):
    """(reference stark, trace, public inputs) of FibonacciStark (public
    inputs [0, 1, fibonacci(n - 1, 0, 1)]) or LookupTestStark."""
    from plonky2_tpu.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_tpu.starky.test_starks import LookupTestStark

    n = 1 << log_rows
    if name == "fibonacci":
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        return stark, stark.generate_trace(pis[0], pis[1]), pis
    stark = LookupTestStark(n)
    return stark, stark.generate_trace(), []


def _prove_wrap(data, pt, stark_proof, degree_bits=None):
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.starky.recursive_verifier import set_stark_proof_with_pis_target
    from plonky2_tpu.util import rng

    pw = PartialWitness()
    set_stark_proof_with_pis_target(pw, pt, stark_proof, pis_degree_bits=degree_bits)
    rng.seed(SEED)
    try:
        proof = data.prove(pw)
    finally:
        rng.seed(None)
    data.verify(proof)
    return proof


def fixed_wrap(name: str, log_rows: int, config, verbose: bool = True) -> dict:
    """The reference's STARK proof of `name` at 2^log_rows rows and its
    fixed-degree wrap: stark proof, wrap verifier data and wrap proof bytes."""
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.starky.prover import prove
    from plonky2_tpu.starky.recursive_verifier import (
        add_virtual_stark_proof_with_pis,
        verify_stark_proof_circuit,
    )
    from plonky2_tpu.starky.serialization import stark_proof_to_bytes
    from plonky2_tpu.starky.verifier import verify_stark_proof
    from plonky2_tpu.util import export_cache

    export_cache._ENABLED = False
    say = print if verbose else (lambda *a, **k: None)
    stark, trace, pis = case(name, log_rows)
    t = time.perf_counter()
    stark_proof = prove(stark, config, trace, pis)
    verify_stark_proof(stark, stark_proof, config)
    out = {"stark_proof": stark_proof_to_bytes(stark_proof, config)}
    say(f"{name} 2^{log_rows}: reference STARK prove + verify (cpu) "
        f"{time.perf_counter() - t:.1f} s, sha256 {sha(out['stark_proof'])}", flush=True)
    t = time.perf_counter()
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    pt = add_virtual_stark_proof_with_pis(builder, stark, config, log_rows)
    verify_stark_proof_circuit(builder, stark, pt, config, log_rows)
    builder.register_public_inputs(pt.public_inputs)
    data = builder.build()
    out["verifier"] = verifier_data_to_bytes(data.verifier_only, data.common)
    say(f"{name} 2^{log_rows} wrap: reference build (cpu) {time.perf_counter() - t:.1f} s, "
        f"degree 2^{data.common.degree_bits}, {len(builder.gate_instances)} rows; verifier "
        f"data sha256 {sha(out['verifier'])}; peak RSS {rss()}", flush=True)
    t = time.perf_counter()
    proof = _prove_wrap(data, pt, stark_proof)
    assert proof.public_inputs == list(pis)
    out["proof"] = proof_to_bytes(proof)
    say(f"{name} 2^{log_rows} wrap: reference prove + verify (cpu) "
        f"{time.perf_counter() - t:.1f} s, {len(out['proof'])} bytes, sha256 "
        f"{sha(out['proof'])}; peak RSS {rss()}", flush=True)
    return out


def variable_wrap(max_bits: int, min_bits: int, log_rows: list, config,
                  verbose: bool = True) -> dict:
    """The reference's variable-degree wrap circuit over FibonacciStark
    (max_bits, min_bits) and its proofs of the FibonacciStark proofs at each
    of `log_rows`, made with verifier_circuit_fri_params = fri_params(max_bits)."""
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.starky.fibonacci_stark import FibonacciStark
    from plonky2_tpu.starky.prover import prove
    from plonky2_tpu.starky.recursive_verifier import (
        add_virtual_stark_proof_with_pis,
        verify_stark_proof_circuit,
    )
    from plonky2_tpu.starky.serialization import stark_proof_to_bytes
    from plonky2_tpu.starky.verifier import verify_stark_proof
    from plonky2_tpu.util import export_cache

    export_cache._ENABLED = False
    say = print if verbose else (lambda *a, **k: None)
    vc = config.fri_params(max_bits)
    t = time.perf_counter()
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    pt = add_virtual_stark_proof_with_pis(builder, FibonacciStark(1 << max_bits), config,
                                          max_bits, with_degree_target=True)
    verify_stark_proof_circuit(builder, FibonacciStark(1 << max_bits), pt, config, max_bits,
                               min_degree_bits_to_support=min_bits)
    builder.register_public_inputs(pt.public_inputs)
    data = builder.build()
    out = {"verifier": verifier_data_to_bytes(data.verifier_only, data.common),
           "stark_proofs": [], "proofs": []}
    say(f"variable-degree wrap (max 2^{max_bits}, min 2^{min_bits}): reference build (cpu) "
        f"{time.perf_counter() - t:.1f} s, degree 2^{data.common.degree_bits}, "
        f"{len(builder.gate_instances)} rows; verifier data sha256 {sha(out['verifier'])}; "
        f"peak RSS {rss()}", flush=True)
    for lg in log_rows:
        stark, trace, pis = case("fibonacci", lg)
        t = time.perf_counter()
        stark_proof = prove(stark, config, trace, pis, verifier_circuit_fri_params=vc)
        verify_stark_proof(stark, stark_proof, config, verifier_circuit_fri_params=vc)
        sb = stark_proof_to_bytes(stark_proof, config)
        out["stark_proofs"].append(sb)
        say(f"fibonacci 2^{lg} under fri_params({max_bits}): reference STARK prove + verify "
            f"(cpu) {time.perf_counter() - t:.1f} s, sha256 {sha(sb)}", flush=True)
        t = time.perf_counter()
        proof = _prove_wrap(data, pt, stark_proof, lg)
        assert proof.public_inputs == list(pis)
        pb = proof_to_bytes(proof)
        out["proofs"].append(pb)
        say(f"variable-degree wrap of 2^{lg}: reference prove + verify (cpu) "
            f"{time.perf_counter() - t:.1f} s, {len(pb)} bytes, sha256 {sha(pb)}, public "
            f"inputs {proof.public_inputs}; peak RSS {rss()}", flush=True)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--fixed-log", type=int, default=20)
    p.add_argument("--var", type=int, nargs=4, default=[18, 12, 14, 17],
                   metavar=("MAX", "MIN", "LOG_A", "LOG_B"))
    p.add_argument("--queries", type=int, default=None)
    p.add_argument("--skip-fixed", action="store_true")
    args = p.parse_args()
    import conftest  # noqa: F401  (JAX on the CPU, x64)
    from reference_prove_batch_fri import plonky2_verify

    config = stark_config(args.queries)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    def save(name, blob):
        if args.out:
            with open(os.path.join(args.out, name), "wb") as f:
                f.write(blob)

    rc = 0

    def native(label, verifier, proof):
        nonlocal rc
        run_ = plonky2_verify(verifier, proof)
        print(f"{label}: the reference's plonky2_verify: exit {run_.returncode} "
              f"{run_.stdout.strip()} {run_.stderr.strip()}", flush=True)
        rc |= run_.returncode

    if not args.skip_fixed:
        for name in ("fibonacci", "lookup"):
            out = fixed_wrap(name, args.fixed_log, config)
            label = f"stark_wrap_{name}{args.fixed_log}"
            save(f"{label}.stark_proof.bin", out["stark_proof"])
            save(f"{label}.verifier.bin", out["verifier"])
            save(f"{label}.proof.bin", out["proof"])
            native(label, out["verifier"], out["proof"])
    mx, mn, a, b = args.var
    out = variable_wrap(mx, mn, [a, b], config)
    save(f"stark_wrap_var{mx}_{mn}.verifier.bin", out["verifier"])
    for lg, sb, pb in zip((a, b), out["stark_proofs"], out["proofs"]):
        save(f"stark_var{lg}.stark_proof.bin", sb)
        save(f"stark_wrap_var{mx}_{mn}_{lg}.proof.bin", pb)
        native(f"variable-degree wrap of 2^{lg}", out["verifier"], pb)
    return rc


if __name__ == "__main__":
    sys.exit(main())
