"""The zero-knowledge config in the port against the reference package, on
the CPU.

The builder's blinding counts equal the reference's over degrees 2^3..2^20
and 1, 2 and 28 FRI queries. Salted commitments (the wires', Zs' and
quotient's oracles under zero knowledge) equal the reference's caps and
openings under the same rng seed, with the salt as rows of the natural
tree's columns (Poseidon) and as columns of the row leaves (Keccak). The
small zk circuit (`zk_factorial`: tests/test_plonk_e2e.py:63's factorial
under `standard_recursion_zk_config()` with 1 FRI query, degree 2^8 with
its blinding rows): the reference's prover data of it reads and writes
back to its bytes; under `KeccakGoldilocksConfig` the port builds and
proves it (the host transcript) to the reference's bytes
(`plonky2_torch/data/zk_factorial.*` and `zk_keccak_factorial.*.bin`, from
`tests/torch_make_data.py --zk`; `tests/test_torch_zk_prove.py` proves it
under Poseidon); the in-circuit verifier over its common data (salted
leaves) has the reference's builder state; and `prove_many` under zero
knowledge keeps the single-stream pipeline, so its proofs equal
sequential proves. The Keccak zk proof compresses to the reference's
bytes and back. Every comparison is exact.
"""

import dataclasses
import lzma
import os
import sys

import numpy as np
import pytest
import torch

from plonky2_tpu.fri import oracle as joracle
from plonky2_tpu.hash.hashers import KeccakHasher as JKeccak
from plonky2_tpu.plonk import circuit_builder as jcb
from plonky2_tpu.plonk import circuit_serialization as jcs
from plonky2_tpu.plonk import compressed as jc
from plonky2_tpu.plonk import serialization as jser
from plonky2_tpu.plonk.config import CircuitConfig as JConfig
from plonky2_tpu.plonk.config import keccak_goldilocks_config as j_keccak
from plonky2_tpu.recursion import recursive_verifier as jrv
from plonky2_tpu.util import rng as jrng
from plonky2_torch.fri import oracle as toracle
from plonky2_torch.gates import ops as tops
from plonky2_torch.hash.hashers import KeccakHasher
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk import circuit_builder as tcb
from plonky2_torch.plonk import compressed as tc
from plonky2_torch.plonk import config as tconfig
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk import prover_serialization as tps
from plonky2_torch.plonk.circuit_serialization import (
    verifier_data_from_bytes,
    verifier_data_to_bytes,
)
from plonky2_torch.plonk.serialization import (
    compressed_proof_from_bytes,
    compressed_proof_to_bytes,
    proof_from_bytes,
    proof_to_bytes,
)
from plonky2_torch.recursion import recursive_verifier as trv
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_recursion import _both, no_commitment  # noqa: E402,F401  (a fixture)
from torch_make_data import zk_factorial_circuit  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026


def _data(name: str) -> bytes:
    with open(os.path.join(ROOT, "plonky2_torch", "data", name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded(run):
    trng.seed(SEED)
    try:
        return run()
    finally:
        trng.seed(None)


@pytest.mark.parametrize("queries", [1, 2, 28])
def test_blinding_counts_equal_reference(queries):
    def config(pkg):
        c = pkg.standard_recursion_zk_config()
        return dataclasses.replace(c, fri_config=dataclasses.replace(
            c.fri_config, num_query_rounds=queries))

    tb = tcb.CircuitBuilder(config(tconfig.CircuitConfig))
    jb = jcb.CircuitBuilder(config(JConfig))
    for k in range(3, 21):
        assert tb._num_blinding_gates(1 << k) == jb._num_blinding_gates(1 << k), k
        for n in ((1 << k) - 1, 1 << k, (1 << k) + 1):
            tb.gate_instances = jb.gate_instances = [None] * n
            assert tb._blinding_counts() == jb._blinding_counts(), (k, n)


@pytest.mark.parametrize("keccak", [False, True], ids=["poseidon", "keccak"])
def test_salted_commitments_equal_reference(keccak):
    """A blinding batch of 3 polynomials of 2^5 values at rate 3, each
    package's salt drawn from its rng under one seed: the same cap, the
    same leaves (salted) and paths, and the values without the salt."""
    values = np.random.default_rng(SEED).integers(0, 2**64 - 2**32 + 1, size=(3, 32),
                                                  dtype=np.uint64)
    trng.seed(SEED)
    jrng.seed(SEED)
    try:
        t = toracle.PolynomialBatch.from_values(values, 3, True, 2, device="cpu",
                                                hasher=KeccakHasher if keccak else None)
        j = joracle.PolynomialBatch.from_values(values, 3, True, 2,
                                                hasher=JKeccak if keccak else None)
    finally:
        trng.seed(None)
        jrng.seed(None)
    assert t.merkle_tree.cap == j.merkle_tree.cap
    indices = [0, 5, 100, 255]
    for i, (tl, tpf) in zip(indices, t.merkle_tree.open_many(indices)):
        jl, jpf = j.merkle_tree.leaf(i), j.merkle_tree.prove(i)
        assert [int(v) for v in tl] == [int(v) for v in jl] and len(tl) == 3 + 4
        assert tpf.siblings == jpf.siblings
    for i in indices:
        assert t.get_lde_values(i) == [int(v) for v in j.get_lde_values(i)]


def test_zk_prover_data_is_written_to_the_reference_bytes():
    """The reference's prover data of the small zk circuit (its blinding
    rows' random-value and copy generators among them) read and written
    back to the same bytes, a blinding batch flag included."""
    blob = lzma.decompress(_data("zk_factorial.prover.bin.xz"))
    prover_only, common = tps.read_prover_data(blob)
    assert common.config.zero_knowledge and common.fri_params.hiding
    assert tps.prover_data_to_bytes(prover_only, common) == blob
    assert sum(type(g).__name__ == "RandomValueGenerator" for g in prover_only.generators) > 0
    salted = dataclasses.replace(prover_only, constants_sigmas_blinding=True)
    again, _ = tps.read_prover_data(tps.prover_data_to_bytes(salted, common))
    assert again.constants_sigmas_blinding


@pytest.fixture(scope="module")
def keccak_zk():
    """The small zk circuit under KeccakGoldilocksConfig, built by the port,
    and two sequential proves under seed 2026: (CircuitData, inputs,
    [proof bytes, proof bytes])."""
    b, initial = zk_factorial_circuit(tconfig, tcb, tconfig.keccak_goldilocks_config())
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_target(initial, 1)
    proofs = seeded(lambda: [proof_to_bytes(data.prove(pw, device="cpu")) for _ in range(2)])
    assert tp._LAST_TRANSCRIPT == "host"
    return data, pw, proofs


def test_keccak_zk_factorial_proves_to_the_reference_bytes(keccak_zk):
    """The salt appended to each row leaf, drawn as an [N, 4] matrix."""
    data, _, proofs = keccak_zk
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _data(
        "zk_keccak_factorial.verifier.bin")
    assert proofs[0] == _data("zk_keccak_factorial.proof.bin")
    data.verify(proof_from_bytes(proofs[0], data.common))


def test_zk_proof_compresses_to_the_reference_bytes_and_back():
    """The Keccak zk proof (salted leaves in its initial openings)
    compressed by both packages to the same bytes, accepted by
    verify_compressed and decompressed to its bytes."""
    blob, proof_blob = _data("zk_keccak_factorial.verifier.bin"), _data(
        "zk_keccak_factorial.proof.bin")
    vo, common = verifier_data_from_bytes(blob, tconfig.keccak_goldilocks_config())
    jvo, jcommon = jcs.verifier_data_from_bytes(blob, j_keccak())
    got = compressed_proof_to_bytes(tc.compress(proof_from_bytes(proof_blob, common), vo,
                                                common), common)
    want = jser.compressed_proof_to_bytes(
        jc.compress(jser.proof_from_bytes(proof_blob, jcommon), jvo, jcommon), jcommon)
    assert got == want
    read = compressed_proof_from_bytes(got, common)
    tc.verify_compressed(read, vo, common)
    assert proof_to_bytes(tc.decompress(read, vo, common)) == proof_blob


def test_in_circuit_verifier_over_zk_common_data_equals_reference(no_commitment):
    """Targets for the salted leaves (135 + 4, 20 + 4, 16 + 4 felts) and the
    FRI check that strips the salt: the reference's builder state."""
    blob = _data("zk_factorial.verifier.bin")
    t_common, j_common = verifier_data_from_bytes(blob)[1], jcs.verifier_data_from_bytes(blob)[1]

    def make(b, ops):
        rv, common = (trv, t_common) if ops is tops else (jrv, j_common)
        pt = rv.add_virtual_proof_with_pis(b, common)
        vdt = rv.add_virtual_verifier_data(b, common.config.fri_config.cap_height)
        rv.verify_proof(b, pt, vdt, common)
        return [len(leaf) for leaf, _ in
                pt.proof.opening_proof.query_round_proofs[0].initial_trees_proof.evals_proofs]

    _, _, got, _ = _both(make)
    assert got[1:] == [139, 24, 20]


def test_prove_many_under_zk_keeps_the_rng_order(keccak_zk):
    """Two proofs at threads 2: the single-stream pipeline, each proof's
    witness and salts drawn in proof order, so the proofs equal the two
    sequential proves."""
    data, pw, want = keccak_zk
    assert want[0] != want[1]
    got = seeded(lambda: tp.prove_many(data.prover_only, data.common, [pw, pw], device="cpu",
                                       threads=2))
    assert tp._LAST_PROVE_MANY_MODE == "single-stream"
    assert [proof_to_bytes(p) for p in got] == want
