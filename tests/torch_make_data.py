"""Write the port's committed circuit data from the reference package.

    JAX_PLATFORMS=cpu python tests/torch_make_data.py

Builds the factorial circuit (100!, standard recursion config) with the
reference under the pinned seed 2026, as `fixtures/factorial.proof.bin`
was made, and writes
  plonky2_torch/data/factorial.prover.bin   the reference's prover_data_to_bytes
  plonky2_torch/data/factorial.witness.npz  witness [num_wires, degree] u64,
                                            public inputs, public-inputs hash
  plonky2_torch/data/factorial.inputs.npz   the PartialWitness it is made from
and builds the fibonacci and range_check examples, as
`tools/generate_fixtures.py` does, to
  plonky2_torch/data/{fibonacci,range_check}.prover.bin, .inputs.npz
so that the port proves these circuits from their inputs without the
reference (inputs: `plonky2_torch.iop.witness.read_partial_witness`), and
builds and proves the bench_recursion fixture chain's inner circuit
(`dummy_proof(config, 4)` under seed 2026, as `tools/generate_fixtures.py`
does) to
  plonky2_torch/data/inner4.verifier.bin    verifier_data_to_bytes
  plonky2_torch/data/inner4.proof.bin       proof_to_bytes
so that a test holds the port's build and prove of it to the reference's
without a reference build (~25 s), and proves three Starky statements under
`StarkConfig.standard_fast_config()` to
  plonky2_torch/data/starky_fibonacci7.proof.bin  FibonacciStark(2^7), public
                                                   inputs [0, 1, fibonacci(127, 0, 1)]
                                                   (one FRI fold step)
  plonky2_torch/data/starky_lookup{5,7}.proof.bin LookupTestStark(2^5), (2^7),
                                                   its own generate_trace()
(stark_proof_to_bytes; ~90 s for the first, most of it compiling), so that
a test holds the port's Starky proves to the reference's without calling the
reference prover. `--starky` writes these three alone. `--cyclic` writes
the data of the dummy circuits and of cyclic recursion (~5 min, most of it
the fixpoint's 2^13 build and the dummy prove over it; 0.23 MB in all):
  plonky2_torch/data/dummy_factorial.verifier.bin  the reference's
                                                   dummy_circuit over
                                                   factorial's common data
  plonky2_torch/data/dummy_factorial.proof.bin     its dummy_proof with
                                                   public input 0 = 42
                                                   (seed 2026)
  plonky2_torch/data/cyclic_fixpoint.verifier.bin  the level-1 circuit of
                                                   tests/validation_cyclic.py's
                                                   common_data_for_recursion
  plonky2_torch/data/cyclic_dummy.verifier.bin     the dummy circuit over the
  plonky2_torch/data/cyclic_dummy.proof.bin        fixpoint's common data with
                                                   the hash chain's 77 public
                                                   inputs, and its proof (seed
                                                   2026): the proof that the
                                                   cyclic circuit's build makes
so that `tests/test_torch_cyclic.py` holds the port's dummy circuit and its
cyclic circuit to the reference's without a reference build or prove.
`--keccak` writes the Keccak wrap over the 2^4 inner circuit (the
bench_recursion outer layer over `inner4.verifier.bin`'s common data,
built under `keccak_goldilocks_config()`; ~10 s):
  plonky2_torch/data/keccak_wrap4.verifier.bin     verifier_data_to_bytes
so that `tests/test_torch_keccak.py` holds the port's Keccak build of it to
the reference's without a reference build. `--zk` writes the small
zero-knowledge circuit (`zk_factorial`: the factorial of
tests/test_plonk_e2e.py:63, 2..29, under `standard_recursion_zk_config()`
with 2 FRI queries, degree 2^9 after its blinding rows; ~8 min):
  plonky2_torch/data/zk_factorial.verifier.bin       verifier_data_to_bytes
  plonky2_torch/data/zk_factorial.proof.bin          its proof (seed 2026)
  plonky2_torch/data/zk_factorial.prover.bin.xz      prover_data_to_bytes, xz
                                                     (2.5 MB raw, 0.47 MB so)
  plonky2_torch/data/zk_keccak_factorial.verifier.bin  the same circuit under
  plonky2_torch/data/zk_keccak_factorial.proof.bin     keccak_goldilocks_config()
and `--inner18` the bench_recursion inner circuit at 2^18 (~7 min):
  plonky2_torch/data/inner18.verifier.bin  verifier_data_to_bytes (its
                                           build alone, no prove)
so that `tests/test_torch_zk.py` and `tests/test_torch_exponentiation.py`
hold the port's zk builds and proves and its recursion circuit over a 2^18
inner circuit to the reference's. `--lookups` writes the lookup circuits
(~10 min, most of it compiling the reference's proves):
  plonky2_torch/data/lookup515.{verifier,proof,prover}.bin
      the body of the reference's dummy_many_rows_proof (515 lookups on
      the TIP5 table, input 2, no noop padding: degree 2^5), its proof
      (seed 2026, the host transcript: no FRI fold at 2^5) and its
      prover_data_to_bytes
  plonky2_torch/data/lookup_two_tables.{verifier,proof,prover}.bin
      tests/test_lookups.py:29's circuit (five TIP5 lookups, three into a
      second LUT of eight pairs), likewise
  plonky2_torch/data/lookup1_6.{verifier,proof}.bin
      the one-lookup inner circuit of dummy_lookup_proof padded to 2^6,
      the smallest degree whose prove takes the fused transcript
  plonky2_torch/data/lookup{1,2}_14.verifier.bin
      the two lookup inner circuits of the chain at 2^14 (builds alone)
so that `tests/test_torch_lookups.py` holds the port's lookup builds,
proves and serialization to the reference's. Not collected by pytest;
`tests/test_torch_plonk.py`, `tests/test_torch_witness.py`,
`tests/test_torch_builder.py`, `tests/test_torch_starky.py`,
`tests/test_torch_cyclic.py`, `tests/test_torch_keccak.py`,
`tests/test_torch_zk.py` and `tests/test_torch_exponentiation.py` hold the
files equal to what this makes.

    JAX_PLATFORMS=cpu python tests/torch_make_data.py --cyclic
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --keccak
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --zk
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --inner18
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --lookups
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --batch-fri
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --stark-recursion
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --ctl

`--batch-fri` (~8 min, most of it compiling) writes
  plonky2_torch/data/batch_merkle.npz
      the reference's BatchMerkleTree over tests/test_batch_fri.py:25's
      matrices (cap height 2): its cap, `values` and `open_batch` at
      BATCH_MERKLE_INDICES, and `open_batch_many` there
  plonky2_torch/data/batch_fri_9_7.npz, .verifier.bin, .circuit_proof.bin
      the batch-FRI proof of groups of degree 2^9 and 2^7 (3 and 2
      polynomials, numpy seed 2, points (5, 7) and (11, 13)) under
      `batch_fri_small_params`, the challenger state after it, and its
      verifier circuit under standard_recursion_config() and that
      circuit's proof (rng seed 2026)
  plonky2_torch/data/fri_unified.npz
      `fri_proof` in the unified shape on tests/test_fri_path_matrix.py:299's
      case (max_num_query_steps one above its steps), and with two dummy
      steps and zero final coefficients, with the challenger states
and `--stark-recursion` (~12 min) the STARK wraps of
`write_stark_recursion_data` (plonky2_torch/data/stark_wrap_*,
stark_var10_*), so that `tests/test_torch_batch_fri.py` and
`tests/test_torch_stark_recursion.py` hold the port to the reference
without running it. `tests/reference_prove_batch_fri.py` and
`tests/reference_prove_stark_recursion.py` run the same at chip_smoke's
sizes. `--ctl` (~15 min) writes the cross-table lookups of
`plonky2_torch/examples/multi_table.py` at CTL_LOG_ROWS (`write_ctl_data`:
plonky2_torch/data/ctl_table{0,1,2}.stark_proof.bin, ctl_wrap.{verifier,
proof}.bin, ctl.npz, and ctl4_table{0,1,2,3}.stark_proof.bin with a fourth
table outside every CTL) for `tests/test_torch_ctl.py` and
`tests/test_torch_ctl_prove.py`; `tests/reference_prove_ctl.py` runs it at
chip_smoke's sizes. `--stark-keccak` (~1 min) proves FibonacciStark and
LookupTestStark at 2^5 under `KeccakHasher` (standard_fast_config) and
writes their field-by-field walks (tests/torch_proof_walk.py: the digest
and each field's sha256), with no byte format for such proofs, to
  plonky2_torch/data/stark_keccak.json
for `tests/test_torch_starky_keccak.py`; `tests/reference_prove_stark_keccak.py`
runs it at chip_smoke's 2^20. `--gadgets` (~2 min) builds the gadgets
circuit of `plonky2_torch/examples/gadgets.py` with the reference's builder
and proves it (rng seed 2026; `tests/reference_prove_gadgets.py`):
  plonky2_torch/data/gadgets.verifier.bin   verifier_data_to_bytes
  plonky2_torch/data/gadgets.proof.bin      proof_to_bytes
for the card's test in `tests/test_torch_cuda.py`. `--parallel` proves
tests/torch_parallel_ranks.py's circuits with the reference (rng seed 2026):
  plonky2_torch/data/low_degree_rate{1,3,4}_qdf{2,2,8}.proof.bin
      the low-degree circuit at each of its PLONK_CONFIGS
  plonky2_torch/data/prove_many_factorial{1,2,3}.proof.bin
      prove_many's factorial circuit (8 PoW bits) proved sequentially at
      each of its inputs
for `tests/test_torch_parallel.py`.

    JAX_PLATFORMS=cpu python tests/torch_make_data.py --stark-keccak
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --gadgets
    JAX_PLATFORMS=cpu python tests/torch_make_data.py --parallel
"""

import lzma
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "plonky2_torch", "data")
SEED = 2026  # tools/generate_fixtures.py


def inputs_arrays(pw) -> dict:
    """A reference PartialWitness as the arrays `read_partial_witness` reads."""
    from plonky2_tpu.iop.target import Wire

    items = list(pw.target_values.items())
    return {"is_wire": np.array([isinstance(t, Wire) for t, _ in items], dtype=bool),
            "a": np.array([t.row if isinstance(t, Wire) else t.index for t, _ in items],
                          dtype=np.int64),
            "b": np.array([t.column if isinstance(t, Wire) else 0 for t, _ in items],
                          dtype=np.int64),
            "value": np.array([v for _, v in items], dtype=np.uint64)}


def example_data(name: str):
    """(prover bytes, CircuitData, inputs PartialWitness) of a reference
    example circuit, its inputs as its `build_and_prove` sets them."""
    import importlib

    from plonky2_tpu.iop import witness as jw
    from plonky2_tpu.plonk.circuit_data import CircuitData
    from plonky2_tpu.plonk.prover_serialization import prover_data_to_bytes

    captured = {}
    real_prove = CircuitData.prove

    def capture(data, pw, *a, **k):  # the example builds, then proves its inputs
        captured["data"], captured["pw"] = data, pw

    module = importlib.import_module(f"plonky2_tpu.examples.{name}")
    CircuitData.prove = capture
    try:
        module.build_and_prove()
    finally:
        CircuitData.prove = real_prove
    data, pw = captured["data"], captured["pw"]
    assert isinstance(pw, jw.PartialWitness)
    return prover_data_to_bytes(data.prover_only, data.common), data, pw


def factorial_data():
    """(prover bytes, witness, public inputs, public-inputs hash, inputs) of
    the factorial circuit, made by the reference under the pinned seed."""
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.prover import prepare_witness
    from plonky2_tpu.plonk.prover_serialization import prover_data_to_bytes
    from plonky2_tpu.util import rng

    rng.seed(SEED)
    try:  # plonky2_tpu/examples/factorial.py's circuit and witness
        builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
        initial = builder.add_virtual_target()
        cur = initial
        for i in range(2, 101):
            cur = builder.mul(cur, builder.constant(i))
        builder.register_public_input(initial)
        builder.register_public_input(cur)
        data = builder.build()
        pw = PartialWitness()
        pw.set_target(initial, 1)
        witness, public_inputs, pi_hash = prepare_witness(data.prover_only, data.common, pw)
    finally:
        rng.seed(None)
    return (prover_data_to_bytes(data.prover_only, data.common), data,
            np.asarray(witness, dtype=np.uint64), list(public_inputs), list(pi_hash), pw)


def inner_data(log2_size: int = 4) -> tuple[bytes, bytes]:
    """(verifier bytes, proof bytes) of the reference's bench_recursion
    inner circuit at 2^log2_size, proved under the pinned seed."""
    from plonky2_tpu.examples.bench_recursion import dummy_proof
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.util import rng

    rng.seed(SEED)
    try:
        proof, verifier_only, common = dummy_proof(CircuitConfig.standard_recursion_config(),
                                                   log2_size)
    finally:
        rng.seed(None)
    return verifier_data_to_bytes(verifier_only, common), proof_to_bytes(proof)


STARKY_CASES = (("fibonacci", 7), ("lookup", 5), ("lookup", 7))


def starky_data(name: str, log_rows: int) -> bytes:
    """The reference's proof bytes of FibonacciStark or LookupTestStark at
    2^log_rows rows."""
    from plonky2_tpu.starky.config import StarkConfig
    from plonky2_tpu.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_tpu.starky.prover import prove
    from plonky2_tpu.starky.serialization import stark_proof_to_bytes
    from plonky2_tpu.starky.test_starks import LookupTestStark
    from plonky2_tpu.starky.verifier import verify_stark_proof

    n = 1 << log_rows
    config = StarkConfig.standard_fast_config()
    if name == "fibonacci":
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        trace = stark.generate_trace(pis[0], pis[1])
    else:
        stark = LookupTestStark(n)
        pis = []
        trace = stark.generate_trace()
    proof = prove(stark, config, trace, pis)
    verify_stark_proof(stark, proof, config)
    return stark_proof_to_bytes(proof, config)


def write_starky_data() -> None:
    os.makedirs(DATA, exist_ok=True)
    for name, log_rows in STARKY_CASES:
        blob = starky_data(name, log_rows)
        with open(os.path.join(DATA, f"starky_{name}{log_rows}.proof.bin"), "wb") as f:
            f.write(blob)
        print(f"wrote starky_{name}{log_rows}: proof {len(blob)} bytes")


STARK_KECCAK_LOG_ROWS = 5  # tests/test_starky.py:test_fibonacci_stark_keccak_hasher


def stark_keccak_proof(name: str, log_rows: int):
    """The reference's proof of FibonacciStark or LookupTestStark at
    2^log_rows rows under KeccakHasher (standard_fast_config), verified by
    its Keccak verifier."""
    from plonky2_tpu.hash.hashers import KeccakHasher
    from plonky2_tpu.starky.config import StarkConfig
    from plonky2_tpu.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_tpu.starky.prover import prove
    from plonky2_tpu.starky.test_starks import LookupTestStark
    from plonky2_tpu.starky.verifier import verify_stark_proof

    n = 1 << log_rows
    config = StarkConfig.standard_fast_config()
    if name == "fibonacci":
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        trace = stark.generate_trace(pis[0], pis[1])
    else:
        stark = LookupTestStark(n)
        pis = []
        trace = stark.generate_trace()
    proof = prove(stark, config, trace, pis, hasher=KeccakHasher)
    verify_stark_proof(stark, proof, config, hasher=KeccakHasher)
    return proof


def write_stark_keccak_data() -> None:
    import json

    from torch_proof_walk import digest, field_digests

    out = {}
    for name in ("fibonacci", "lookup"):
        proof = stark_keccak_proof(name, STARK_KECCAK_LOG_ROWS)
        out[f"{name}{STARK_KECCAK_LOG_ROWS}"] = {"digest": digest(proof),
                                                 "fields": field_digests(proof)}
        print(f"{name} 2^{STARK_KECCAK_LOG_ROWS} Keccak: digest {digest(proof)}")
    with open(os.path.join(DATA, "stark_keccak.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def write_gadgets_data() -> None:
    import reference_prove_gadgets

    verifier_bytes, proof_bytes = reference_prove_gadgets.reference_gadgets()
    for suffix, blob in (("verifier", verifier_bytes), ("proof", proof_bytes)):
        with open(os.path.join(DATA, f"gadgets.{suffix}.bin"), "wb") as f:
            f.write(blob)
    print(f"wrote gadgets: verifier data {len(verifier_bytes)} bytes, proof "
          f"{len(proof_bytes)} bytes")


def write_cyclic_data() -> None:
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.recursion.dummy_circuit import dummy_circuit, dummy_proof
    from plonky2_tpu.util import rng
    from reference_prove_cyclic import fixpoint

    def seeded(run):
        rng.seed(SEED)
        try:
            return run()
        finally:
            rng.seed(None)

    def dummy(common, nonzero):
        circuit = dummy_circuit(common)
        proof = seeded(lambda: dummy_proof(circuit, nonzero))
        circuit.verify(proof)
        return {"verifier": verifier_data_to_bytes(circuit.verifier_only, circuit.common),
                "proof": proof_to_bytes(proof)}

    files = {f"dummy_factorial.{k}.bin": v
             for k, v in dummy(factorial_data()[1].common, {0: 42}).items()}
    fix = fixpoint()
    common = fix.common
    files["cyclic_fixpoint.verifier.bin"] = verifier_data_to_bytes(fix.verifier_only, common)
    # the hash chain's public inputs: initial hash, tip, counter, then the key
    common.num_public_inputs = 9 + 4 + 4 * (1 << common.config.fri_config.cap_height)
    files.update({f"cyclic_dummy.{k}.bin": v for k, v in dummy(common, {}).items()})
    os.makedirs(DATA, exist_ok=True)
    for name, blob in files.items():
        with open(os.path.join(DATA, name), "wb") as f:
            f.write(blob)
        print(f"wrote {name}: {len(blob)} bytes")


def write_keccak_data() -> None:
    """The reference's Keccak wrap over the 2^4 inner circuit: the
    bench_recursion outer layer over `inner4.verifier.bin`'s common data,
    built under `keccak_goldilocks_config()`; its verifier bytes."""
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import (
        verifier_data_from_bytes,
        verifier_data_to_bytes,
    )
    from plonky2_tpu.plonk.config import CircuitConfig, keccak_goldilocks_config
    from plonky2_tpu.recursion import recursive_verifier as rv

    with open(os.path.join(DATA, "inner4.verifier.bin"), "rb") as f:
        _, inner_common = verifier_data_from_bytes(f.read())
    b = CircuitBuilder(CircuitConfig.standard_recursion_config(), gc=keccak_goldilocks_config())
    pt = rv.add_virtual_proof_with_pis(b, inner_common)
    vdt = rv.add_virtual_verifier_data(b, inner_common.config.fri_config.cap_height)
    rv.verify_proof(b, pt, vdt, inner_common)
    b.register_public_inputs(pt.public_inputs)
    data = b.build()
    blob = verifier_data_to_bytes(data.verifier_only, data.common)
    with open(os.path.join(DATA, "keccak_wrap4.verifier.bin"), "wb") as f:
        f.write(blob)
    print(f"wrote keccak_wrap4.verifier.bin: {len(blob)} bytes (degree "
          f"2^{data.common.degree_bits})")


ZK_QUERIES = 1  # the zk tests' config: degree 2^8 with its blinding rows


def zk_factorial_circuit(config_module, builder_module, gc=None, queries=ZK_QUERIES):
    """(builder, initial target) of the small zk circuit on a builder of
    the given package: tests/test_plonk_e2e.py:63's factorial, 2..29,
    under the zk config with `queries` FRI queries."""
    import dataclasses

    config = config_module.CircuitConfig.standard_recursion_zk_config()
    config = dataclasses.replace(config, fri_config=dataclasses.replace(
        config.fri_config, num_query_rounds=queries))
    b = builder_module.CircuitBuilder(config, gc=gc) if gc else builder_module.CircuitBuilder(
        config)
    initial = b.add_virtual_target()
    cur = initial
    for i in range(2, 30):
        cur = b.mul(cur, b.constant(i))
    b.register_public_input(initial)
    b.register_public_input(cur)
    return b, initial


def write_zk_data() -> None:
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk import circuit_builder, config
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.prover_serialization import prover_data_to_bytes
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.util import rng

    files = {}
    for name, gc in (("zk_factorial", None), ("zk_keccak_factorial",
                                              config.keccak_goldilocks_config())):
        b, initial = zk_factorial_circuit(config, circuit_builder, gc)
        data = b.build()
        pw = PartialWitness()
        pw.set_target(initial, 1)
        rng.seed(SEED)
        try:
            proof = data.prove(pw)
        finally:
            rng.seed(None)
        data.verify(proof)
        files[f"{name}.verifier.bin"] = verifier_data_to_bytes(data.verifier_only, data.common)
        files[f"{name}.proof.bin"] = proof_to_bytes(proof)
        if gc is None:
            files[f"{name}.prover.bin.xz"] = lzma.compress(
                prover_data_to_bytes(data.prover_only, data.common))
    os.makedirs(DATA, exist_ok=True)
    for name, blob in files.items():
        with open(os.path.join(DATA, name), "wb") as f:
            f.write(blob)
        print(f"wrote {name}: {len(blob)} bytes")


def write_inner18_data() -> None:
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from reference_prove_sizes import build_inner

    data = build_inner(CircuitConfig.standard_recursion_config(), 18)[0]
    blob = verifier_data_to_bytes(data.verifier_only, data.common)
    with open(os.path.join(DATA, "inner18.verifier.bin"), "wb") as f:
        f.write(blob)
    print(f"wrote inner18.verifier.bin: {len(blob)} bytes")


def two_tables_circuit(builder_cls, tables, config):
    """tests/test_lookups.py:29's circuit on a builder of either package
    (`tables`: that package's gadgets/lookup module): lookups of constants
    into the TIP5 table and into a table of SMALLER_TABLE's eight pairs,
    the outputs public."""
    b = builder_cls(config)
    tip5 = b.add_lookup_table_from_table(list(range(256)), list(tables.TIP5_TABLE))
    small = b.add_lookup_table_from_pairs(list(zip([2, 4, 6, 8, 10, 12, 14, 16],
                                                   tables.SMALLER_TABLE)))
    outs = [b.add_lookup_from_index(b.constant(v), tip5) for v in (0, 5, 17, 255, 17)]
    outs += [b.add_lookup_from_index(b.constant(v), small) for v in (2, 10, 16)]
    b.register_public_inputs(outs)
    return b


def lookup_circuits(builder_cls, noop_cls, tables, config) -> dict:
    """name -> (builder, the lookup input target or None) of the
    `--lookups` circuits on a builder of either package."""
    from reference_prove_lookups import lookup_circuit

    def inner(lookup_type, size):
        return lookup_circuit(builder_cls, noop_cls, tables.TIP5_TABLE, config, lookup_type,
                              size)

    return {"lookup515": inner(2, None),
            "lookup_two_tables": (two_tables_circuit(builder_cls, tables, config), None),
            "lookup1_6": inner(1, 6), "lookup1_14": inner(1, 14), "lookup2_14": inner(2, 14)}


def write_lookup_data() -> None:
    from plonky2_tpu.gadgets import lookup as tables
    from plonky2_tpu.gates.simple_gates import NoopGate
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.prover_serialization import prover_data_to_bytes
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.util import rng
    from reference_prove_lookups import INITIAL_A

    files = {}
    circuits = lookup_circuits(CircuitBuilder, NoopGate, tables,
                               CircuitConfig.standard_recursion_config())
    for name, (builder, initial) in circuits.items():
        data = builder.build()
        files[f"{name}.verifier.bin"] = verifier_data_to_bytes(data.verifier_only, data.common)
        if name.endswith("_14"):
            continue
        pw = PartialWitness()
        if initial is not None:
            pw.set_target(initial, INITIAL_A)
        rng.seed(SEED)
        try:
            proof = data.prove(pw)
        finally:
            rng.seed(None)
        data.verify(proof)
        files[f"{name}.proof.bin"] = proof_to_bytes(proof)
        if name != "lookup1_6":
            files[f"{name}.prover.bin"] = prover_data_to_bytes(data.prover_only, data.common)
    os.makedirs(DATA, exist_ok=True)
    for name, blob in files.items():
        with open(os.path.join(DATA, name), "wb") as f:
            f.write(blob)
        print(f"wrote {name}: {len(blob)} bytes", flush=True)


BATCH_MERKLE_INDICES = (0, 3, 40, 63)


def batch_fri_small_params(fri_config_module):
    """The CPU tests' batch-FRI params: tests/test_batch_fri.py's (rate 3,
    cap height 2, 8 PoW bits, arities 1 x 4, degree bits 9) at 8 queries."""
    arities = (1,) * 4
    return fri_config_module.FriParams(
        config=fri_config_module.FriConfig(
            rate_bits=3, cap_height=2, proof_of_work_bits=8,
            reduction_strategy=fri_config_module.FriReductionStrategy.Fixed(arities),
            num_query_rounds=8),
        hiding=False, degree_bits=9, reduction_arity_bits=arities)


def unified_shape_case(rng_seed: int = 0):
    """tests/test_fri_path_matrix.py:299's FRI case: (config, degree bits,
    coefficients (c0, c1) [16] u64, the initial tree's leaves [32, 4] u64)."""
    n = 1 << 4
    r = np.random.default_rng(rng_seed)
    P = (1 << 64) - (1 << 32) + 1
    c0, c1 = r.integers(0, P, n, dtype=np.uint64), r.integers(0, P, n, dtype=np.uint64)
    return 4, (c0, c1), r.integers(0, P, (n * 2, 4), dtype=np.uint64)


def _state(challenger) -> dict:
    return {"sponge": np.asarray(challenger.sponge_state, dtype=np.uint64),
            "inputs": np.asarray(challenger.input_buffer, dtype=np.uint64),
            "outputs": np.asarray(challenger.output_buffer, dtype=np.uint64)}


def write_batch_fri_data() -> None:
    """The reference's BatchMerkleTree over tests/test_batch_fri.py:25's
    matrices, its batch-FRI proof and in-circuit verifier at the CPU tests'
    size, and its unified-shape fri_proof."""
    import jax.numpy as jnp

    import reference_prove_batch_fri as rbf
    from plonky2_tpu.fri import config as jfc
    from plonky2_tpu.fri import prover as jfp
    from plonky2_tpu.hash.merkle import BatchMerkleTree, MerkleTree
    from plonky2_tpu.iop.challenger import Challenger

    os.makedirs(DATA, exist_ok=True)
    rng = np.random.default_rng(1)
    mats = [rng.integers(0, 1 << 63, size=(64, 5), dtype=np.uint64),
            rng.integers(0, 1 << 63, size=(16, 7), dtype=np.uint64)]
    tree = BatchMerkleTree(mats, cap_height=2)
    opens = tree.open_batch_many(list(BATCH_MERKLE_INDICES))
    np.savez(os.path.join(DATA, "batch_merkle.npz"),
             cap=np.asarray(tree.cap, dtype=np.uint64),
             values=np.asarray([[v for row in tree.values(i) for v in row]
                                for i in BATCH_MERKLE_INDICES], dtype=np.uint64),
             siblings=np.asarray([tree.open_batch(i).siblings for i in BATCH_MERKLE_INDICES],
                                 dtype=np.uint64),
             many_values=np.asarray([v for v, _ in opens], dtype=np.uint64),
             many_siblings=np.asarray([p.siblings for _, p in opens], dtype=np.uint64))
    print("wrote batch_merkle.npz", flush=True)

    out = rbf.reference_case(rbf.random_groups((9, 7), (3, 2), 2),
                             batch_fri_small_params(jfc), rbf.POINTS[:2])
    sponge, inputs, outputs = out["state"]
    np.savez(os.path.join(DATA, "batch_fri_9_7.npz"),
             proof=np.frombuffer(out["proof"], dtype=np.uint8),
             sponge=np.asarray(sponge, dtype=np.uint64),
             inputs=np.asarray(inputs, dtype=np.uint64),
             outputs=np.asarray(outputs, dtype=np.uint64))
    for name in ("verifier", "circuit_proof"):
        with open(os.path.join(DATA, f"batch_fri_9_7.{name}.bin"), "wb") as f:
            f.write(out[name])
    print("wrote batch_fri_9_7.*", flush=True)

    from plonky2_tpu.plonk.serialization import Writer

    degree_bits, (c0, c1), leaves = unified_shape_case()
    config = jfc.FriConfig(rate_bits=1, cap_height=0, proof_of_work_bits=1,
                           reduction_strategy=jfc.FriReductionStrategy.ConstantArityBits(1, 2),
                           num_query_rounds=2)
    params = config.fri_params(degree_bits, False)
    cases = {"steps": {"max_num_query_steps": len(params.reduction_arity_bits) + 1},
             "steps_coeffs": {"max_num_query_steps": len(params.reduction_arity_bits) + 2,
                              "final_poly_coeff_len": 2 * params.final_poly_len() + 3}}
    arrays = {}
    for name, kwargs in cases.items():
        challenger = Challenger()
        challenger.observe_element(1)
        proof = jfp.fri_proof([MerkleTree(leaves, 0)], (jnp.asarray(c0), jnp.asarray(c1)),
                              challenger, params, **kwargs)
        w = Writer()
        w.write_fri_proof(proof)
        arrays[f"{name}_proof"] = np.frombuffer(bytes(w.buf), dtype=np.uint8)
        arrays.update({f"{name}_{k}": v for k, v in _state(challenger).items()})
    np.savez(os.path.join(DATA, "fri_unified.npz"), **arrays)
    print("wrote fri_unified.npz", flush=True)


STARK_WRAP_QUERIES = 1  # the CPU tests' inner STARK config: standard_fast_config at 1 query


def write_stark_recursion_data() -> None:
    """The reference's STARK wraps at the CPU tests' size (the inner STARK
    config at STARK_WRAP_QUERIES queries, the outer standard_recursion_config):
    the fixed-degree wraps of FibonacciStark and LookupTestStark at 2^5,
    the variable-degree circuit (max 10, min 4) and its wraps of the 2^5
    and 2^7 FibonacciStark proofs made under fri_params(10)."""
    import reference_prove_stark_recursion as rsr

    os.makedirs(DATA, exist_ok=True)
    config = rsr.stark_config(STARK_WRAP_QUERIES)

    def write(name, blob):
        with open(os.path.join(DATA, name), "wb") as f:
            f.write(blob)
        print(f"wrote {name}: {len(blob)} bytes", flush=True)

    for name in ("fibonacci", "lookup"):
        out = rsr.fixed_wrap(name, 5, config)
        write(f"stark_wrap_{name}5.verifier.bin", out["verifier"])
        write(f"stark_wrap_{name}5.proof.bin", out["proof"])
    out = rsr.variable_wrap(10, 4, [5, 7], config)
    write("stark_wrap_var10_4.verifier.bin", out["verifier"])
    for lg, sb, pb in zip((5, 7), out["stark_proofs"], out["proofs"]):
        write(f"stark_var10_{lg}.stark_proof.bin", sb)
        write(f"stark_wrap_var10_4_{lg}.proof.bin", pb)


CTL_LOG_ROWS = (8, 7, 6)  # the CPU tests' sizes of examples/multi_table.py's tables
CTL_QUERIES, CTL_POW_BITS = 1, 8  # their config: standard_fast_config otherwise
CTL_STANDALONE_LOG_ROWS = 5  # a fourth table outside every CTL, beside the three


def write_ctl_data() -> None:
    """The reference's multi-table proofs of examples/multi_table.py's
    system at CTL_LOG_ROWS under reference_prove_ctl.stark_config(CTL_QUERIES,
    CTL_POW_BITS), its verdicts on table 1 shifted by 1 (new Stark objects,
    and the first prove's), and the circuit that verifies the three proofs
    (`verify_multi_table_circuit` under standard_recursion_config()) with
    its proof (rng seed 2026); then the four proofs of the three tables
    beside a Fibonacci table of 2^CTL_STANDALONE_LOG_ROWS rows outside every
    CTL (ctl4_table{0,1,2,3}.stark_proof.bin)."""
    import reference_prove_ctl as rpc

    os.makedirs(DATA, exist_ok=True)
    out = rpc.run(CTL_LOG_ROWS, rpc.stark_config(CTL_QUERIES, CTL_POW_BITS))

    def write(name, blob):
        with open(os.path.join(DATA, name), "wb") as f:
            f.write(blob)
        print(f"wrote {name}: {len(blob)} bytes", flush=True)

    for i, blob in enumerate(out["proofs"]):
        write(f"ctl_table{i}.stark_proof.bin", blob)
    write("ctl_wrap.verifier.bin", out["verifier"])
    write("ctl_wrap.proof.bin", out["proof"])
    np.savez(os.path.join(DATA, "ctl.npz"),
             challenges=np.asarray(out["challenges"], dtype=np.uint64),
             **{k: np.asarray(out[k]) for k in ("rejected", "rejected_same_objects",
                                                "reproved_same_objects")})
    print("wrote ctl.npz", flush=True)
    config = rpc.stark_config(CTL_QUERIES, CTL_POW_BITS)
    blobs = rpc.run_with_standalone(CTL_LOG_ROWS, CTL_STANDALONE_LOG_ROWS, config)
    for i, blob in enumerate(blobs):
        write(f"ctl4_table{i}.stark_proof.bin", blob)


def write_parallel_data() -> None:
    """The reference's proofs of tests/torch_parallel_ranks.py's circuits
    (rng seed 2026): the low-degree circuit at each of its PLONK_CONFIGS, and
    prove_many's factorial circuit proved sequentially at each input."""
    import torch_parallel_ranks as ranks
    from plonky2_tpu.plonk.serialization import proof_to_bytes
    from plonky2_tpu.util import rng

    proofs = []
    for rate_bits, qdf in ranks.PLONK_CONFIGS:
        builder, pw = ranks.low_degree_circuit(rate_bits, qdf, "plonky2_tpu")
        data = builder.build()
        rng.seed(SEED)
        proofs.append(data.prove(pw))
    builder, inputs = ranks.prove_many_circuit("plonky2_tpu")
    data = builder.build()
    rng.seed(SEED)
    proofs += [data.prove(pw) for pw in inputs]
    rng.seed(None)
    for name, proof in zip(ranks.reference_proof_names(), proofs):
        blob = proof_to_bytes(proof)
        with open(os.path.join(DATA, name), "wb") as f:
            f.write(blob)
        print(f"wrote {name}: {len(blob)} bytes", flush=True)


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    import conftest  # noqa: F401  (JAX on the CPU, x64)

    if sys.argv[1:] == ["--starky"]:
        write_starky_data()
        return 0
    if sys.argv[1:] == ["--cyclic"]:
        write_cyclic_data()
        return 0
    if sys.argv[1:] == ["--keccak"]:
        write_keccak_data()
        return 0
    if sys.argv[1:] == ["--zk"]:
        write_zk_data()
        return 0
    if sys.argv[1:] == ["--inner18"]:
        write_inner18_data()
        return 0
    if sys.argv[1:] == ["--lookups"]:
        write_lookup_data()
        return 0
    if sys.argv[1:] == ["--batch-fri"]:
        write_batch_fri_data()
        return 0
    if sys.argv[1:] == ["--stark-recursion"]:
        write_stark_recursion_data()
        return 0
    if sys.argv[1:] == ["--ctl"]:
        write_ctl_data()
        return 0
    if sys.argv[1:] == ["--stark-keccak"]:
        write_stark_keccak_data()
        return 0
    if sys.argv[1:] == ["--gadgets"]:
        write_gadgets_data()
        return 0
    if sys.argv[1:] == ["--parallel"]:
        write_parallel_data()
        return 0

    prover_bytes, _, witness, public_inputs, pi_hash, pw = factorial_data()
    os.makedirs(DATA, exist_ok=True)
    with open(os.path.join(DATA, "factorial.prover.bin"), "wb") as f:
        f.write(prover_bytes)
    np.savez(os.path.join(DATA, "factorial.witness.npz"), witness=witness,
             public_inputs=np.asarray(public_inputs, dtype=np.uint64),
             public_inputs_hash=np.asarray(pi_hash, dtype=np.uint64))
    np.savez(os.path.join(DATA, "factorial.inputs.npz"), **inputs_arrays(pw))
    print(f"wrote {DATA}: factorial prover data {len(prover_bytes)} bytes, "
          f"witness {witness.shape}, {len(pw.target_values)} inputs")
    for name in ("fibonacci", "range_check"):
        prover_bytes, _, pw = example_data(name)
        with open(os.path.join(DATA, f"{name}.prover.bin"), "wb") as f:
            f.write(prover_bytes)
        np.savez(os.path.join(DATA, f"{name}.inputs.npz"), **inputs_arrays(pw))
        print(f"wrote {name}: prover data {len(prover_bytes)} bytes, "
              f"{len(pw.target_values)} inputs")
    verifier_bytes, proof_bytes = inner_data(4)
    for suffix, blob in (("verifier", verifier_bytes), ("proof", proof_bytes)):
        with open(os.path.join(DATA, f"inner4.{suffix}.bin"), "wb") as f:
            f.write(blob)
    print(f"wrote inner4: verifier data {len(verifier_bytes)} bytes, proof "
          f"{len(proof_bytes)} bytes")
    write_starky_data()
    write_cyclic_data()
    write_keccak_data()
    write_zk_data()
    write_inner18_data()
    write_lookup_data()
    write_batch_fri_data()
    write_stark_recursion_data()
    write_ctl_data()
    write_stark_keccak_data()
    write_gadgets_data()
    write_parallel_data()
    return 0


if __name__ == "__main__":
    sys.exit(main())
