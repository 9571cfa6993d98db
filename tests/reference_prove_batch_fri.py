"""Batch FRI at chip_smoke's `batch_fri` size, made by the reference on the CPU.

Three degree groups of 2^20, 2^16 and 2^12 coefficients (16, 8 and 4
polynomials, drawn by `numpy.random.default_rng(2026)` in that order) are
committed in one `BatchFriOracle` under `StarkConfig.standard_fast_config()`'s
FRI config (rate 1, cap height 4, 16 PoW bits, ConstantArityBits(4, 5), 84
queries; FriParams at degree bits 20, no hiding) and opened in one batch-FRI
proof: the transcript of tests/test_batch_fri.py (observe the cap, draw α,
each group's `_batch_quotient` at (5, 7), (11, 13), (17, 19)), proved on the
fused and on the host path (both must agree, challenger states included),
verified by `verify_batch_fri_proof` (a tampered opening refused), then
verified in a circuit under `standard_recursion_config()`
(`verify_batch_fri_proof_circuit`, the openings as constants, the transcript
replayed by a `RecursiveChallenger`), which is proved (the rng seeded to
2026) and verified, also by the reference's `plonky2_verify`. Prints the
sha256 of

  the batch-FRI proof (`Writer.write_fri_proof`)   chip_smoke's BATCH_FRI_PROOF_SHA256
  the circuit's verifier data                      BATCH_FRI_VERIFIER_SHA256
  the circuit's proof (`proof_to_bytes`)           BATCH_FRI_CIRCUIT_PROOF_SHA256

The times printed are the reference's on this host's CPU, not device
times. Not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_batch_fri.py [--out DIR]

`reference_case` runs any size (`tests/torch_make_data.py --batch-fri` uses
it at the CPU tests' size).
"""

import argparse
import hashlib
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 2026
BITS = (20, 16, 12)
COUNTS = (16, 8, 4)
POINTS = ((5, 7), (11, 13), (17, 19))


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def rss() -> str:
    return f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB"


def random_groups(bits, counts, seed: int) -> list:
    """The groups' coefficients [count, 2^bits] u64, largest first."""
    rng = np.random.default_rng(seed)
    P = (1 << 64) - (1 << 32) + 1
    return [rng.integers(0, P, size=(c, 1 << b), dtype=np.uint64) for b, c in zip(bits, counts)]


def reference_case(groups, params, points, circuit: bool = True, verbose: bool = True) -> dict:
    """The reference's batch-FRI proof of `groups` under `params`, on both
    transcript paths, verified; with `circuit`, its in-circuit verifier
    built, proved and verified. Returns the bytes and the challenger state."""
    import jax.numpy as jnp

    from plonky2_tpu.field import goldilocks as g
    from plonky2_tpu.field import scalar as fs
    from plonky2_tpu.fri import prover as fp
    from plonky2_tpu.fri.batch_fri import (
        BatchFriOracle,
        batch_fri_proof,
        verify_batch_fri_proof,
        verify_batch_fri_proof_circuit,
    )
    from plonky2_tpu.fri.oracle import _batch_quotient
    from plonky2_tpu.fri.recursive_verifier import (
        FriChallengesTarget,
        add_virtual_cap,
        add_virtual_fri_proof,
        set_cap_target,
        set_fri_proof_target,
    )
    from plonky2_tpu.fri.structure import (
        FriBatchInfo,
        FriInstanceInfo,
        FriOpeningBatch,
        FriOpenings,
        FriOracleInfo,
        FriPolynomialInfo,
    )
    from plonky2_tpu.fri.verifier import fri_challenges
    from plonky2_tpu.iop.challenger import Challenger
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.prover import _eval_polys_at
    from plonky2_tpu.plonk.serialization import Writer, proof_to_bytes
    from plonky2_tpu.recursion.recursive_challenger import RecursiveChallenger
    from plonky2_tpu.util import export_cache, rng

    export_cache._ENABLED = False
    say = print if verbose else (lambda *a, **k: None)
    out = {}
    rate_bits, cap_height = params.config.rate_bits, params.config.cap_height
    bits = [int(gr.shape[1]).bit_length() - 1 for gr in groups]
    k = len(groups)

    t = time.perf_counter()
    oracle = BatchFriOracle(groups, rate_bits, cap_height)
    cap = oracle.batch_merkle_tree.cap
    say(f"reference BatchFriOracle (cpu): {time.perf_counter() - t:.1f} s; peak RSS {rss()}",
        flush=True)

    def prove():
        challenger = Challenger()
        challenger.observe_cap(cap)
        alpha = challenger.get_extension_challenge(2)
        comps = [_batch_quotient(jnp.asarray(groups[i]), g.to_field(list(alpha)),
                                 g.to_field(list(points[i])), rate_bits) for i in range(k)]
        proof = batch_fri_proof([oracle.batch_merkle_tree], comps, challenger, params)
        state = (list(challenger.sponge_state), list(challenger.input_buffer),
                 list(challenger.output_buffer))
        return proof, state, fp._LAST_PATH

    def fri_bytes(proof) -> bytes:
        w = Writer()
        w.write_fri_proof(proof)
        return bytes(w.buf)

    t = time.perf_counter()
    proof, state, path = prove()
    say(f"reference batch FRI prove, {path} path (cpu): {time.perf_counter() - t:.1f} s",
        flush=True)
    t = time.perf_counter()
    with fp.force_host_path():
        host_proof, host_state, host_path = prove()
    say(f"reference batch FRI prove, {host_path} path (cpu): {time.perf_counter() - t:.1f} s",
        flush=True)
    out["proof"], out["state"] = fri_bytes(proof), state
    out["paths_agree"] = fri_bytes(host_proof) == out["proof"] and host_state == state
    say(f"batch FRI proof: {len(out['proof'])} bytes, sha256 {sha(out['proof'])}; the two "
        f"paths agree (proof and challenger state): {out['paths_agree']}", flush=True)

    values = []
    for i in range(k):
        e0, e1 = _eval_polys_at(jnp.asarray(groups[i]),
                                jnp.asarray(np.asarray(points[i], dtype=np.uint64)))
        values.append([(int(a), int(b)) for a, b in zip(np.asarray(e0), np.asarray(e1))])
    instances = [FriInstanceInfo(
        oracles=[FriOracleInfo(groups[i].shape[0], False)],
        batches=[FriBatchInfo(point=points[i], polynomials=FriPolynomialInfo.from_range(
            0, range(groups[i].shape[0])))]) for i in range(k)]
    openings = [FriOpenings(batches=[FriOpeningBatch(values=list(values[i]))]) for i in range(k)]
    heights = [[b + rate_bits for b in bits]]
    v = Challenger()
    v.observe_cap(cap)
    challenges = fri_challenges(v, proof.commit_phase_merkle_caps, proof.final_poly,
                                proof.pow_witness, params.degree_bits, params.config)
    t = time.perf_counter()
    verify_batch_fri_proof(bits, instances, openings, challenges, [cap], heights, proof, params)
    say(f"reference verify_batch_fri_proof (cpu): {time.perf_counter() - t:.1f} s, accepted",
        flush=True)
    bad = [FriOpenings(batches=[FriOpeningBatch(values=list(values[i]))]) for i in range(k)]
    v0 = bad[0].batches[0].values[0]
    bad[0].batches[0].values[0] = (fs.add(v0[0], 1), v0[1])
    try:
        verify_batch_fri_proof(bits, instances, bad, challenges, [cap], heights, proof, params)
        out["tampered_refused"] = False
    except Exception:
        out["tampered_refused"] = True
    say(f"a tampered opening refused: {out['tampered_refused']}", flush=True)
    if not circuit:
        return out

    t = time.perf_counter()
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    cap_t = add_virtual_cap(builder, cap_height)
    proof_t = add_virtual_fri_proof(builder, [sum(gr.shape[0] for gr in groups)], params)
    ch = RecursiveChallenger(builder)
    ch.observe_cap(cap_t)
    alpha_t = ch.get_extension_challenge()
    betas_t = []
    for cap_step in proof_t.commit_phase_merkle_caps:
        ch.observe_cap(cap_step)
        betas_t.append(ch.get_extension_challenge())
    ch.observe_extension_elements(proof_t.final_poly)
    ch.observe_element(proof_t.pow_witness)
    pow_response_t = ch.get_challenge()
    query_indices_t = ch.get_n_challenges(params.config.num_query_rounds)
    challenges_t = FriChallengesTarget(fri_alpha=alpha_t, fri_betas=betas_t,
                                       fri_pow_response=pow_response_t,
                                       fri_query_indices=query_indices_t)
    instances_t = [FriInstanceInfo(
        oracles=[FriOracleInfo(groups[i].shape[0], False)],
        batches=[FriBatchInfo(point=builder.constant_extension(points[i]),
                              polynomials=FriPolynomialInfo.from_range(
                                  0, range(groups[i].shape[0])))]) for i in range(k)]
    openings_t = [FriOpenings(batches=[FriOpeningBatch(values=[
        builder.constant_extension(val) for val in values[i]])]) for i in range(k)]
    verify_batch_fri_proof_circuit(builder, bits, instances_t, openings_t, challenges_t,
                                   [cap_t], heights, proof_t, params)
    data = builder.build()
    out["verifier"] = verifier_data_to_bytes(data.verifier_only, data.common)
    say(f"reference batch-FRI verifier circuit build (cpu): {time.perf_counter() - t:.1f} s, "
        f"degree 2^{data.common.degree_bits}, {len(builder.gate_instances)} rows; verifier "
        f"data {len(out['verifier'])} bytes, sha256 {sha(out['verifier'])}; peak RSS {rss()}",
        flush=True)
    pw = PartialWitness()
    set_cap_target(pw, cap_t, cap)
    set_fri_proof_target(pw, proof_t, proof)
    t = time.perf_counter()
    rng.seed(SEED)
    try:
        circuit_proof = data.prove(pw)
    finally:
        rng.seed(None)
    prove_s = time.perf_counter() - t
    data.verify(circuit_proof)
    out["circuit_proof"] = proof_to_bytes(circuit_proof)
    say(f"reference batch-FRI verifier circuit prove (cpu): {prove_s:.1f} s, "
        f"{len(out['circuit_proof'])} bytes, sha256 {sha(out['circuit_proof'])}, verified; "
        f"peak RSS {rss()}", flush=True)
    out["data"] = data
    return out


def plonky2_verify(verifier: bytes, proof: bytes) -> subprocess.CompletedProcess:
    """The reference's native verifier on (verifier data, proof) bytes."""
    from plonky2_tpu import native as jnative

    with tempfile.TemporaryDirectory() as d:
        vd_path, pf_path = os.path.join(d, "verifier.bin"), os.path.join(d, "proof.bin")
        with open(vd_path, "wb") as f:
            f.write(verifier)
        with open(pf_path, "wb") as f:
            f.write(proof)
        return subprocess.run([jnative.verifier_binary(), vd_path, pf_path],
                              capture_output=True, text=True, timeout=600)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args()
    import conftest  # noqa: F401  (JAX on the CPU, x64)

    from plonky2_tpu.starky.config import StarkConfig

    fri_config = StarkConfig.standard_fast_config().fri_config
    params = fri_config.fri_params(BITS[0], False)
    print(f"batch FRI: degree bits {BITS}, polynomials {COUNTS}, arities "
          f"{params.reduction_arity_bits}, final polynomial {params.final_poly_len()} "
          f"coefficients", flush=True)
    groups = random_groups(BITS, COUNTS, SEED)
    out = reference_case(groups, params, POINTS)
    run_ = plonky2_verify(out["verifier"], out["circuit_proof"])
    print(f"the reference's plonky2_verify on the circuit's proof: exit {run_.returncode} "
          f"{run_.stdout.strip()} {run_.stderr.strip()}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for name in ("proof", "verifier", "circuit_proof"):
            with open(os.path.join(args.out, f"batch_fri.{name}.bin"), "wb") as f:
                f.write(out[name])
    ok = out["paths_agree"] and out["tampered_refused"] and run_.returncode == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
