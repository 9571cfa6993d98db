"""Cross-table lookups at chip_smoke's `ctl` sizes, made by the reference on
the CPU, and the reference's twins of the port's three tables.

The system is `plonky2_torch/examples/multi_table.py`'s: CpuTable (35
columns, 2^20 rows, a logUp range check, three (address, value) pairs sent
to memory and a (key, word) pair sent to the store), MemoryTable (2^18)
and StoreTable (2^16), linked by two CTLs. The classes below are its twins
written against the reference's `Stark`, `Column`, `Filter` and
`CrossTableLookup`; `tests/test_torch_ctl.py` holds them to the port's.
The traces come from the port's numpy generator
(`multi_table.generate_traces(log_rows, seed=2026)`): the same inputs on
both sides.

Under `StarkConfig.standard_fast_config()` (84 queries unless --queries),
this runs the reference's `check_ctls`, `prove_multi_table` and
`verify_multi_table` (with --mismatch, proves the system again with table
1's values shifted by 1 and checks that `verify_multi_table` rejects it),
then builds
one circuit under `standard_recursion_config()` that verifies the three
proofs and the CTL sums (`verify_multi_table_circuit`, every table's
public inputs registered), proves it with the rng seeded to 2026, verifies
it and runs the reference's `plonky2_verify` on it. Prints the sha256 of

  each table's proof (`stark_proof_to_bytes`)   chip_smoke's CTL_PROOF_SHA256S
  the circuit's verifier data                   CTL_WRAP_VERIFIER_SHA256
  the circuit's proof (`proof_to_bytes`)        CTL_WRAP_PROOF_SHA256

The times printed are the reference's on this host's CPU, not device
times. Not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_ctl.py [--out DIR]
        [--logs 20 18 16] [--queries 84] [--skip-wrap] [--mismatch]

`run` takes any size (`tests/torch_make_data.py --ctl` uses it at the CPU
tests' sizes); `run_with_standalone` proves the three tables beside a
fourth outside every CTL (`standalone_table`).
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


def stark_config(queries=None, pow_bits=None, package_config=None):
    """standard_fast_config of `package_config` (the reference's StarkConfig
    by default), with `queries` FRI queries and `pow_bits` proof-of-work
    bits where given."""
    if package_config is None:
        from plonky2_tpu.starky.config import StarkConfig as package_config

    config = package_config.standard_fast_config()
    fri = config.fri_config
    if queries is not None:
        fri = dataclasses.replace(fri, num_query_rounds=queries)
    if pow_bits is not None:
        fri = dataclasses.replace(fri, proof_of_work_bits=pow_bits)
    return dataclasses.replace(config, fri_config=fri)


def twins():
    """(starks, ctls): the reference's twins of multi_table.system()."""
    from plonky2_tpu.starky.cross_table_lookup import CrossTableLookup, TableWithColumns
    from plonky2_tpu.starky.lookup import Column, Filter, Lookup
    from plonky2_tpu.starky.stark import Stark

    def boolean(ops, x, consumer):
        consumer.constraint(ops.mul(x, ops.sub(x, ops.one())))

    def transition(ops, local, nxt, u, d, consumer):
        prod = ops.mul(ops.mul(local[u], local[u + 1]), local[u + 2])
        consumer.constraint_transition(ops.sub(nxt[d], ops.add(prod, local[u + 3])))

    class CpuTable(Stark):
        COLUMNS = 35
        PUBLIC_INPUTS = 1

        def eval(self, ops, frame, consumer):
            local, nxt = frame.get_local_values(), frame.get_next_values()
            pis = frame.get_public_inputs()
            total = ops.zero()
            for s in range(4):
                boolean(ops, local[s], consumer)
                total = ops.add(total, local[s])
            boolean(ops, total, consumer)
            for j in range(4):
                transition(ops, local, nxt, 15 + 4 * j, 31 + j, consumer)
            consumer.constraint_first_row(ops.sub(local[31], pis[0]))

        def constraint_degree(self):
            return 3

        def requires_ctls(self):
            return True

        def lookups(self):
            return [Lookup(columns=[Column.single(12)], table_column=Column.single(13),
                           frequencies_column=Column.single(14),
                           filter_columns=[Filter.default()])]

    class MemoryTable(Stark):
        COLUMNS = 11
        PUBLIC_INPUTS = 0

        def eval(self, ops, frame, consumer):
            local, nxt = frame.get_local_values(), frame.get_next_values()
            boolean(ops, local[0], consumer)
            boolean(ops, local[3], consumer)
            transition(ops, local, nxt, 6, 10, consumer)

        def constraint_degree(self):
            return 3

        def requires_ctls(self):
            return True

    class StoreTable(MemoryTable):
        pass  # the same constraints on its own columns (SEND 0, FILTER 3)

    def group(table, columns, selector):
        return TableWithColumns(table, Column.singles(columns),
                                Filter.new_simple(Column.single(selector)))

    ctl0 = CrossTableLookup(
        looking_tables=[group(0, (4, 5), 0), group(0, (6, 7), 1), group(0, (8, 9), 2),
                        group(2, (1, 2), 0)],
        looked_table=group(1, (1, 2), 0))
    ctl1 = CrossTableLookup(
        looking_tables=[group(0, (10, 11), 3), group(1, (4, 5), 3)],
        looked_table=group(2, (4, 5), 3))
    return [CpuTable(), MemoryTable(), StoreTable()], [ctl0, ctl1]


def traces(log_rows, seed: int = SEED):
    from plonky2_torch.examples.multi_table import generate_traces

    return generate_traces(tuple(log_rows), seed)


def standalone_table(log_rows: int, fibonacci_stark_cls=None):
    """(stark, trace, public inputs) of a Fibonacci table of 2^log_rows rows
    with neither a logUp lookup nor a CTL, to prove beside the three:
    `fibonacci_stark_cls` is a package's FibonacciStark (the reference's by
    default); the trace is the port's."""
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci

    if fibonacci_stark_cls is None:
        from plonky2_tpu.starky.fibonacci_stark import FibonacciStark as fibonacci_stark_cls

    n = 1 << log_rows
    return (fibonacci_stark_cls(n), FibonacciStark(n).generate_trace(0, 1),
            [0, 1, fibonacci(n - 1, 0, 1)])


def run_with_standalone(log_rows, standalone_log_rows: int, config) -> list[bytes]:
    """The reference's proofs of the three tables at `log_rows` and the
    standalone table as a fourth, under one transcript, verified."""
    from plonky2_tpu.starky.cross_table_lookup import prove_multi_table, verify_multi_table
    from plonky2_tpu.starky.serialization import stark_proof_to_bytes
    from plonky2_tpu.util import export_cache

    export_cache._ENABLED = False
    starks, ctls = twins()
    tr, pis = traces(log_rows)
    stark, trace, table_pis = standalone_table(standalone_log_rows)
    starks, tr, pis = starks + [stark], tr + [trace], pis + [table_pis]
    proofs, _ = prove_multi_table(starks, config, tr, pis, ctls)
    verify_multi_table(starks, config, proofs, ctls)
    return [stark_proof_to_bytes(p, config) for p in proofs]


def _verifier_rejects(starks, config, tr, pis, ctls) -> str:
    """The reference's verify_multi_table verdict on its proofs of `tr`:
    "" where it accepts, else the exception's type and message."""
    from plonky2_tpu.starky.cross_table_lookup import prove_multi_table, verify_multi_table

    proofs, _ = prove_multi_table(starks, config, tr, pis, ctls)
    try:
        verify_multi_table(starks, config, proofs, ctls)
    except Exception as e:  # the reference's verdict, whatever its type
        return f"{type(e).__name__}: {e}"
    return ""


def run(log_rows, config, wrap: bool = True, mismatch: bool = True,
        verbose: bool = True) -> dict:
    """The reference's multi-table proofs of the system at `log_rows` and,
    with `wrap`, its verifier circuit over them: {"proofs": [bytes],
    "challenges": the CTL challenge pairs, "verifier": bytes, "proof":
    bytes}. With `mismatch`,
    "rejected": the verdict on table 1 shifted by 1, proved with new Stark
    objects, and "rejected_same_objects": with the first prove's objects,
    whose cached quotient closure keeps the first transcript's CTL
    challenges (ROADMAP section 3), and "reproved_same_objects": the
    verdict on an honest system from seed + 1 proved with those objects."""
    from plonky2_tpu.starky.cross_table_lookup import (
        check_ctls,
        prove_multi_table,
        verify_multi_table,
    )
    from plonky2_tpu.starky.serialization import stark_proof_to_bytes
    from plonky2_tpu.util import export_cache

    export_cache._ENABLED = False
    say = print if verbose else (lambda *a, **k: None)
    starks, ctls = twins()
    tr, pis = traces(log_rows)
    t = time.perf_counter()
    check_ctls(tr, ctls)
    proofs, chals = prove_multi_table(starks, config, tr, pis, ctls)
    prove_s = time.perf_counter() - t
    t = time.perf_counter()
    verify_multi_table(starks, config, proofs, ctls)
    out = {"proofs": [stark_proof_to_bytes(p, config) for p in proofs],
           "challenges": [(c.beta, c.gamma) for c in chals.challenges]}
    say(f"tables 2^{tuple(log_rows)}: reference check_ctls + prove (cpu) {prove_s:.1f} s, "
        f"verify {time.perf_counter() - t:.1f} s; proof sha256s "
        f"{[sha(b) for b in out['proofs']]}; peak RSS {rss()}", flush=True)
    if mismatch:
        from plonky2_torch.examples.multi_table import shifted_memory

        fresh, _ = twins()
        out["rejected"] = _verifier_rejects(fresh, config, shifted_memory(tr), pis, ctls)
        out["rejected_same_objects"] = _verifier_rejects(starks, config, shifted_memory(tr),
                                                         pis, ctls)
        tr2, pis2 = traces(log_rows, SEED + 1)
        out["reproved_same_objects"] = _verifier_rejects(starks, config, tr2, pis2, ctls)
        say(f"table 1 shifted by 1: the reference's verify_multi_table raises "
            f"{out['rejected'] or 'nothing'}; with the first prove's Stark objects "
            f"{out['rejected_same_objects'] or 'nothing'}; the honest system of seed "
            f"{SEED + 1} with them: {out['reproved_same_objects'] or 'accepted'}", flush=True)
    if wrap:
        out.update(wrap_circuit(starks, config, proofs, ctls, say))
    return out


def wrap_circuit(starks, config, proofs, ctls, say=print) -> dict:
    """The reference's circuit over the multi-table proofs: its verifier
    data and its proof (rng seeded to SEED), verified."""
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.starky.cross_table_lookup import ctl_shape_data, verify_multi_table_circuit
    from plonky2_tpu.starky.lookup import GrandProductChallenge, GrandProductChallengeSet
    from plonky2_tpu.starky.recursive_verifier import (
        add_virtual_stark_proof_with_pis,
        set_stark_proof_with_pis_target,
    )
    from plonky2_tpu.util import rng

    degree_bits = [p.proof.recover_degree_bits(config) for p in proofs]
    dummy = GrandProductChallengeSet(challenges=[
        GrandProductChallenge(0, 0) for _ in range(config.num_challenges)])
    desc = ctl_shape_data(len(starks), ctls, dummy, max(s.constraint_degree() for s in starks))
    t = time.perf_counter()
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    pts = [add_virtual_stark_proof_with_pis(
        builder, stark, config, bits,
        num_ctl_helper_zs=sum(len(z.helper_columns) for z in d.zs_columns) + len(d.zs_columns),
        num_ctl_zs=len(d.zs_columns)) for stark, bits, d in zip(starks, degree_bits, desc)]
    verify_multi_table_circuit(builder, starks, config, pts, ctls, degree_bits)
    for pt in pts:
        builder.register_public_inputs(pt.public_inputs)
    data = builder.build()
    out = {"verifier": verifier_data_to_bytes(data.verifier_only, data.common)}
    say(f"multi-table circuit over 2^{tuple(degree_bits)}: reference build (cpu) "
        f"{time.perf_counter() - t:.1f} s, degree 2^{data.common.degree_bits}, "
        f"{len(builder.gate_instances)} rows; verifier data sha256 {sha(out['verifier'])}; "
        f"peak RSS {rss()}", flush=True)
    t = time.perf_counter()
    pw = PartialWitness()
    for pt, proof in zip(pts, proofs):
        set_stark_proof_with_pis_target(pw, pt, proof)
    rng.seed(SEED)
    try:
        proof = data.prove(pw)
    finally:
        rng.seed(None)
    data.verify(proof)
    out["proof"] = proof_to_bytes(proof)
    say(f"multi-table circuit: reference prove + verify (cpu) {time.perf_counter() - t:.1f} s, "
        f"{len(out['proof'])} bytes, sha256 {sha(out['proof'])}, public inputs "
        f"{proof.public_inputs}; peak RSS {rss()}", flush=True)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--logs", type=int, nargs=3, default=[20, 18, 16])
    p.add_argument("--queries", type=int, default=None)
    p.add_argument("--skip-wrap", action="store_true")
    p.add_argument("--mismatch", action="store_true")
    args = p.parse_args()
    import conftest  # noqa: F401  (JAX on the CPU, x64)

    config = stark_config(args.queries)
    out = run(args.logs, config, wrap=not args.skip_wrap, mismatch=args.mismatch)
    rc = 1 if args.mismatch and not out["rejected"] else 0
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = "_".join(map(str, args.logs))
        for i, b in enumerate(out["proofs"]):
            with open(os.path.join(args.out, f"ctl_{tag}.table{i}.stark_proof.bin"), "wb") as f:
                f.write(b)
        for key in ("verifier", "proof"):
            if key in out:
                with open(os.path.join(args.out, f"ctl_wrap.{key}.bin"), "wb") as f:
                    f.write(out[key])
    if "proof" in out:
        from reference_prove_batch_fri import plonky2_verify

        res = plonky2_verify(out["verifier"], out["proof"])
        print(f"multi-table circuit: the reference's plonky2_verify: exit {res.returncode} "
              f"{res.stdout.strip()} {res.stderr.strip()}", flush=True)
        rc |= res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
