"""The port's compressed proofs and circuit-data writer against the
reference package, on the CPU.

Compressed proofs: `fixtures/factorial.proof.bin` compresses to
`fixtures/factorial.compressed.bin`, which decompresses to the proof's
bytes and passes `verify_compressed`; `keccak_factorial`'s proof compresses
to the reference's bytes and back; tampered compressed proofs (a Merkle
sibling, an opened value, the PoW witness) are rejected as the
reference rejects them, with the same exception and message; the Merkle
path compression equals the reference's on random paths. The writer:
factorial's prover data written by the port equals
`plonky2_torch/data/factorial.prover.bin`, fibonacci's and range_check's
round-trip write -> read -> write, square_root's raises the reference's
ValueError without a registry and round-trips with one, and a circuit's
DummyProof, Equality and Inverse generators are written to the reference's
bytes and read back through their tags; and the Keccak wrap over the 2^4
inner circuit (the bench_recursion outer layer under
`KeccakGoldilocksConfig`) builds to the reference's verifier bytes
(`plonky2_torch/data/keccak_wrap4.verifier.bin`, from
`tests/torch_make_data.py --keccak`). Inputs are drawn with numpy from
seeds; every comparison is exact.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from plonky2_tpu.examples import square_root as jsq
from plonky2_tpu.gadgets import inverse as jinv
from plonky2_tpu.hash import merkle as jm
from plonky2_tpu.plonk import circuit_builder as jcb
from plonky2_tpu.plonk import circuit_serialization as jcs
from plonky2_tpu.plonk import compressed as jc
from plonky2_tpu.plonk import prover_serialization as jps
from plonky2_tpu.plonk import serialization as jser
from plonky2_tpu.plonk.config import keccak_goldilocks_config as j_keccak
from plonky2_tpu.recursion import dummy_circuit as jdc
from plonky2_torch.examples import square_root
from plonky2_torch.field import scalar as fs
from plonky2_torch.gadgets import inverse as tinv
from plonky2_torch.hash.merkle import MerkleProof
from plonky2_torch.iop.target import VirtualTarget
from plonky2_torch.plonk import circuit_builder as tcb
from plonky2_torch.plonk import compressed as tc
from plonky2_torch.plonk import prover_serialization as tps
from plonky2_torch.plonk.circuit_serialization import (
    verifier_data_from_bytes,
    verifier_data_to_bytes,
)
from plonky2_torch.plonk.config import CircuitConfig, keccak_goldilocks_config
from plonky2_torch.plonk.serialization import (
    compressed_proof_from_bytes,
    compressed_proof_to_bytes,
    proof_from_bytes,
    proof_to_bytes,
)
from plonky2_torch.recursion import dummy_circuit as tdc
from plonky2_torch.recursion import recursive_verifier as rv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cyclic import _dummy_both, _gen  # noqa: E402
from test_torch_recursion import CONFIG, J_CONFIG  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fixture(name: str, keccak: bool):
    """(port (verifier-only, common), reference's, proof bytes) of a fixture."""
    blob = _read("fixtures", f"{name}.verifier.bin")
    port = verifier_data_from_bytes(blob, keccak_goldilocks_config() if keccak else None)
    ref = jcs.verifier_data_from_bytes(blob, j_keccak() if keccak else None)
    return port, ref, _read("fixtures", f"{name}.proof.bin")


def test_factorial_compresses_to_the_fixture_and_back(monkeypatch):
    """verify_compressed accepts the fixture, and the proof it decompressed
    (recorded on the way) is `factorial.proof.bin`'s bytes (~7 s: the
    Poseidon paths on the host, twice)."""
    (vo, common), _, blob = _fixture("factorial", False)
    want = _read("fixtures", "factorial.compressed.bin")
    compressed = tc.compress(proof_from_bytes(blob, common), vo, common)
    assert compressed_proof_to_bytes(compressed, common) == want
    read = compressed_proof_from_bytes(want, common)
    assert compressed_proof_to_bytes(read, common) == want
    decompressed, decompress = [], tc.decompress
    monkeypatch.setattr(tc, "decompress",
                        lambda *a: decompressed.append(decompress(*a)) or decompressed[-1])
    tc.verify_compressed(read, vo, common)
    assert [proof_to_bytes(p) for p in decompressed] == [blob]


def test_keccak_factorial_compresses_to_the_reference_bytes_and_back():
    (vo, common), (jvo, jcommon), blob = _fixture("keccak_factorial", True)
    compressed = compressed_proof_to_bytes(tc.compress(proof_from_bytes(blob, common), vo, common),
                                           common)
    want = jser.compressed_proof_to_bytes(
        jc.compress(jser.proof_from_bytes(blob, jcommon), jvo, jcommon), jcommon)
    assert compressed == want
    read = compressed_proof_from_bytes(compressed, common)
    tc.verify_compressed(read, vo, common)
    assert proof_to_bytes(tc.decompress(read, vo, common)) == blob


def _sibling(p):
    p.opening_proof.query_round_proofs.initial_trees_proofs[
        p.opening_proof.query_round_proofs.indices[2]].evals_proofs[1][1].siblings[0] = bytes(25)


def _leaf_value(p):
    rounds = p.opening_proof.query_round_proofs
    leaf = rounds.initial_trees_proofs[rounds.indices[0]].evals_proofs[2][0]
    leaf[3] = (leaf[3] + 1) % fs.P


def _pow_witness(p):
    p.opening_proof.pow_witness += 1


@pytest.mark.parametrize("tamper", [_sibling, _leaf_value, _pow_witness])
def test_tampered_compressed_proof_is_rejected_as_the_reference_rejects_it(tamper):
    (vo, common), (jvo, jcommon), blob = _fixture("keccak_factorial", True)
    compressed = compressed_proof_to_bytes(tc.compress(proof_from_bytes(blob, common), vo, common),
                                           common)
    outcomes = []
    for read, verify_compressed, v, c in (
            (compressed_proof_from_bytes, tc.verify_compressed, vo, common),
            (jser.compressed_proof_from_bytes, jc.verify_compressed, jvo, jcommon)):
        cpwp = read(compressed, c)
        tamper(cpwp.proof)
        with pytest.raises(Exception) as e:
            verify_compressed(cpwp, v, c)
        outcomes.append((e.type.__name__, str(e.value)))
    assert outcomes[0] == outcomes[1]


def test_merkle_path_compression_equals_reference():
    r = np.random.default_rng(9)
    height, cap_height = 8, 2
    indices = [int(i) for i in r.integers(0, 1 << height, size=20)]
    proofs = [MerkleProof([[int(v) for v in r.integers(0, fs.P, size=4, dtype=np.uint64)]
                           for _ in range(height - cap_height)]) for _ in indices]
    got = tc.compress_merkle_proofs(cap_height, indices, proofs)
    want = jc.compress_merkle_proofs(cap_height, indices,
                                     [jm.MerkleProof(list(p.siblings)) for p in proofs])
    assert [p.siblings for p in got] == [p.siblings for p in want]


def test_factorial_prover_data_is_written_to_the_reference_bytes():
    blob = _read("plonky2_torch", "data", "factorial.prover.bin")
    prover_only, common = tps.read_prover_data(blob)
    assert tps.prover_data_to_bytes(prover_only, common) == blob


@pytest.mark.parametrize("name", ["fibonacci", "range_check"])
def test_prover_data_round_trips(name):
    blob = _read("plonky2_torch", "data", f"{name}.prover.bin")
    prover_only, common = tps.read_prover_data(blob)
    again, _ = tps.read_prover_data(tps.prover_data_to_bytes(prover_only, common))
    assert tps.prover_data_to_bytes(again, common) == blob
    assert ([_gen(g) for g in again.generators] == [_gen(g) for g in prover_only.generators])


def test_square_root_needs_a_registry():
    """Without a registry the reference's ValueError; with one, a
    write -> read -> write round trip."""
    builder = tcb.CircuitBuilder(CircuitConfig.standard_recursion_config())
    x = builder.add_virtual_target()
    x_squared = builder.square(x)
    builder.register_public_input(x_squared)
    builder.add_simple_generator(square_root.SquareRootGenerator(x, x_squared))
    data = builder.build(device="cpu")
    with pytest.raises(ValueError) as got:
        tps.prover_data_to_bytes(data.prover_only, data.common)
    with pytest.raises(ValueError) as want:
        jps.write_generator(jps.ProverWriter(), jsq.SquareRootGenerator(x, x_squared), None)
    assert str(got.value) == str(want.value)
    registry = square_root.registry()
    blob = tps.prover_data_to_bytes(data.prover_only, data.common, registry)
    prover_only, common = tps.read_prover_data(blob, registry)
    assert tps.prover_data_to_bytes(prover_only, common, registry) == blob
    assert [_gen(g) for g in prover_only.generators] == [_gen(g)
                                                          for g in data.prover_only.generators]


def test_dummy_proof_equality_and_inverse_generators_round_trip_to_the_reference_bytes(
        monkeypatch):
    """Both packages' builders with a dummy proof of factorial's shape (the
    committed `dummy_factorial.*.bin` in place of a build and prove),
    is_equal and add_inverse: their generators written by each package are
    the same bytes, and the port reads them back through tags 6, 7 and 24
    to the same generators and bytes."""
    t_common, j_common = _dummy_both(monkeypatch, "dummy_factorial.verifier.bin",
                                     "dummy_factorial.proof.bin")
    blobs = {}
    for pkg, b in (("port", tcb.CircuitBuilder(CONFIG)), ("ref", jcb.CircuitBuilder(J_CONFIG))):
        if pkg == "port":
            tdc.dummy_proof_and_vk(b, t_common, device="cpu")
            tinv.add_inverse(b, b.add_virtual_target())
        else:
            jdc.dummy_proof_and_vk(b, j_common)
            jinv.add_inverse(b, b.add_virtual_target())
        x, y = b.add_virtual_targets(2)
        b.is_equal(x, y)
        names = [type(g).__name__ for g in b.generators]
        assert {"DummyProofGenerator", "EqualityGenerator", "InverseGenerator"} <= set(names)
        if pkg == "port":
            w = tps.ProverWriter()
            for g in b.generators:
                tps.write_generator(w, g)
            port_gens = b.generators
        else:
            w = jps.ProverWriter()
            for g in b.generators:
                jps.write_generator(w, g, None)
        blobs[pkg] = bytes(w.buf)
    assert blobs["port"] == blobs["ref"]
    r = tps.Reader(blobs["port"])
    read = [r.generator() for _ in port_gens]
    r.finish()
    assert [_gen(g) for g in read] == [_gen(g) for g in port_gens]
    w = tps.ProverWriter()
    for g in read:
        tps.write_generator(w, g)
    assert bytes(w.buf) == blobs["port"]
    assert dataclasses.is_dataclass(read[0].proof_with_pis_target)
    assert isinstance(read[-1].x, VirtualTarget)


def test_keccak_wrap_over_the_2_4_inner_circuit_builds_to_the_reference_bytes():
    """The bench_recursion outer layer over the 2^4 inner circuit's common
    data, on a builder under the Keccak config (degree 2^11, ~3 s)."""
    _, inner_common = verifier_data_from_bytes(_read("plonky2_torch", "data",
                                                     "inner4.verifier.bin"))
    b = tcb.CircuitBuilder(CircuitConfig.standard_recursion_config(),
                           gc=keccak_goldilocks_config())
    pt = rv.add_virtual_proof_with_pis(b, inner_common)
    vdt = rv.add_virtual_verifier_data(b, inner_common.config.fri_config.cap_height)
    rv.verify_proof(b, pt, vdt, inner_common)
    b.register_public_inputs(pt.public_inputs)
    data = b.build(device="cpu")
    assert isinstance(data.verifier_only.circuit_digest, bytes)
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "plonky2_torch", "data", "keccak_wrap4.verifier.bin")
