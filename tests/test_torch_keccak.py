"""The port's Keccak config against the reference package, on the CPU.

Keccak-256's known answers on both engines; keccak-f on the native engine,
its numpy twin and the reference's `keccak_f_np`; every `KeccakHasher`
method (leaves under and over a digest's 25 bytes); the host Merkle trees'
caps and openings; a Keccak transcript; the commitment oracle's Keccak path
and its LDE values; the host grind at 8 bits, and at 0 bits, where the port
takes witness 0 and the reference raises. Then the Keccak config end to
end: the port builds and proves `keccak_factorial` on the CPU to
`fixtures/keccak_factorial.{verifier,proof}.bin`, its verifier accepts the
fixture, the reference's `plonky2_verify --keccak` accepts the port's
proof, and the Keccak wrap over the 2^4 inner circuit builds to the
reference's verifier bytes (`plonky2_torch/data/keccak_wrap4.verifier.bin`,
from `tests/torch_make_data.py --keccak`). Inputs are drawn with numpy from
seeds; every comparison is exact.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from plonky2_tpu import native as jnative
from plonky2_tpu.fri import prover as jfp
from plonky2_tpu.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu.fri.oracle import PolynomialBatch as JBatch
from plonky2_tpu.hash import hashers as jh
from plonky2_tpu.hash import keccak as jk
from plonky2_tpu.hash import merkle as jm
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.util import export_cache
from plonky2_torch import convert
from plonky2_torch import native
from plonky2_torch.examples import factorial
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri import prover as tfp
from plonky2_torch.fri.oracle import PolynomialBatch
from plonky2_torch.hash import hashers as th
from plonky2_torch.hash import keccak as tk
from plonky2_torch.hash import merkle as tm
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.circuit_serialization import (
    verifier_data_from_bytes,
    verifier_data_to_bytes,
)
from plonky2_torch.plonk.config import keccak_goldilocks_config
from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
from plonky2_torch.plonk.verifier import verify
from plonky2_torch.util import rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026  # tools/generate_fixtures.py


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _felts(rng_, n):
    return [int(v) for v in rng_.integers(0, fs.P, size=n, dtype=np.uint64)]


@pytest.mark.parametrize("engine", tk.ENGINES)
def test_keccak256_known_answers(engine):
    assert tk.keccak256(b"", engine).hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert tk.keccak256(b"abc", engine).hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")


def test_keccak_f_native_numpy_and_reference_agree():
    states = np.random.default_rng(1).integers(0, 1 << 64, size=(64, 25), dtype=np.uint64)
    want = jk.keccak_f_np(states.copy())
    np.testing.assert_array_equal(tk.keccak_f(states, "native"), want)
    np.testing.assert_array_equal(tk.keccak_f(states, "numpy"), want)
    np.testing.assert_array_equal(native.keccak_f1600(states), want)


def test_keccak_engine_is_chosen_and_never_falls_back(monkeypatch):
    with pytest.raises(ValueError, match="unknown keccak engine"):
        tk.keccak_f(np.zeros((1, 25), np.uint64), "cuda")

    def broken():
        raise RuntimeError("building the native witness executor failed")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", broken)
    with pytest.raises(RuntimeError, match="failed"):
        tk.keccak256(b"abc", "native")
    assert tk.keccak256(b"abc", "numpy") == jk.keccak256(b"abc")


@pytest.mark.parametrize("n", [0, 1, 3, 4, 17, 40])
def test_keccak_hasher_equals_reference(n):
    r = np.random.default_rng(n)
    x = _felts(r, n)
    K, J = th.KeccakHasher, jh.KeccakHasher
    assert (K.HASH_SIZE, K.algebraic, K.name) == (J.HASH_SIZE, J.algebraic, J.name)
    assert K.hash_no_pad(x) == J.hash_no_pad(x)
    assert K.hash_pad(x) == J.hash_pad(x)
    assert K.hash_or_noop(x) == J.hash_or_noop(x)  # n <= 3: the bytes themselves
    a, b = K.hash_no_pad(x + [1]), K.hash_no_pad(x + [2])
    assert K.two_to_one(a, b) == J.two_to_one(a, b)
    assert K.digest_to_felts(a) == J.digest_to_felts(a)
    state = _felts(r, 12)
    assert K.permute(state) == J.permute(state)
    assert th.PoseidonHasher.hash_pad(x) == jh.PoseidonHasher.hash_pad(x)
    for width in (1, 3, 4, 135):  # leaves of 8 to 24 bytes stay as they are
        leaves = r.integers(0, fs.P, size=(8, width), dtype=np.uint64)
        np.testing.assert_array_equal(K.hash_leaves_batch(leaves), J.hash_leaves_batch(leaves))
    digests = r.integers(0, 256, size=(8, 25), dtype=np.uint8)
    np.testing.assert_array_equal(K.compress_batch(digests), J.compress_batch(digests))


def test_poseidon_hasher_attributes_equal_reference():
    P, J = th.PoseidonHasher, jh.PoseidonHasher
    assert (P.HASH_SIZE, P.algebraic, P.name) == (J.HASH_SIZE, J.algebraic, J.name)


@pytest.mark.parametrize("n,width,cap_height", [(32, 7, 2), (64, 135, 4)])
def test_keccak_merkle_tree_equals_reference(n, width, cap_height):
    leaves = np.random.default_rng(width).integers(0, fs.P, size=(n, width), dtype=np.uint64)
    tree = tm.make_merkle_tree(torch.from_numpy(leaves.view(np.int64)), cap_height,
                               th.KeccakHasher)
    ref = jm.KeccakMerkleTree(leaves, cap_height)
    assert isinstance(tree, tm.KeccakMerkleTree)
    assert tree.cap == ref.cap
    indices = [0, 5, n - 1, 5]
    for i, (leaf, proof) in zip(indices, tree.open_many(indices)):
        assert leaf == ref.leaf(i) == tree.leaf(i)
        assert proof.siblings == ref.prove(i).siblings == tree.prove(i).siblings
        tm.verify_merkle_proof_to_cap(leaf, i, tree.cap, proof, th.KeccakHasher)
    leaf, proof = tree.open_many([1])[0]
    with pytest.raises(ValueError, match="Merkle proof invalid"):
        tm.verify_merkle_proof_to_cap(ref.leaf(0), 1, tree.cap, proof, th.KeccakHasher)
    proof.siblings[0] = bytes(25)
    with pytest.raises(ValueError, match="Merkle proof invalid"):
        tm.verify_merkle_proof_to_cap(leaf, 1, tree.cap, proof, th.KeccakHasher)


def test_keccak_challenger_equals_reference():
    r = np.random.default_rng(7)
    first, second = _felts(r, 5), _felts(r, 11)
    digest = th.KeccakHasher.hash_no_pad([1, 2, 3])
    cap = [digest, th.KeccakHasher.two_to_one(digest, digest)]
    draws = []
    for c in (Challenger(th.KeccakHasher), JChallenger(jh.KeccakHasher)):
        c.observe_elements(first)
        c.observe_hash(digest)
        c.observe_cap(cap)
        out = c.get_n_challenges(3) + list(c.get_extension_challenge(2))
        c.observe_elements(second)
        draws.append(out + c.get_n_challenges(14) + c.compact())
    assert draws[0] == draws[1]


def test_keccak_commitment_equals_reference(monkeypatch):
    """The oracle's Keccak path: the reference's bit-reversed row leaves,
    cap and openings, and its LDE values at the same points."""
    monkeypatch.setattr(export_cache, "_ENABLED", False)
    values = np.random.default_rng(5).integers(0, fs.P, size=(6, 32), dtype=np.uint64)
    port = PolynomialBatch.from_values(values, 2, False, 2, device="cpu",
                                       hasher=th.KeccakHasher)
    ref = JBatch.from_values(values, 2, False, 2, hasher=jh.KeccakHasher)
    assert isinstance(port.merkle_tree, tm.KeccakMerkleTree)
    np.testing.assert_array_equal(port.merkle_tree.leaves, np.asarray(ref.merkle_tree.leaves))
    assert port.merkle_tree.cap == ref.merkle_tree.cap
    for index, step in ((0, 1), (3, 1), (5, 4), (127, 1)):
        assert port.get_lde_values(index, step) == ref.get_lde_values(index, step)
    poseidon = PolynomialBatch.from_values(values, 2, False, 2, device="cpu")
    assert poseidon.get_lde_values(5, 4) == port.get_lde_values(5, 4)
    opened = tm.open_many_packed([port.merkle_tree, poseidon.merkle_tree], [[7, 9], [7]])
    assert [leaf for leaf, _ in opened[0]] == [ref.merkle_tree.leaf(i) for i in (7, 9)]
    assert opened[0][1][1].siblings == ref.merkle_tree.prove(9).siblings
    assert opened[1][0][0] == ref.merkle_tree.leaf(7)


def _grind_config(bits: int) -> FriConfig:
    return FriConfig(rate_bits=3, cap_height=0, proof_of_work_bits=bits,
                     reduction_strategy=FriReductionStrategy.Fixed([]), num_query_rounds=1)


def test_host_grind_equals_reference_at_8_bits():
    config = _grind_config(8)
    port, ref = Challenger(th.KeccakHasher), JChallenger(jh.KeccakHasher)
    for c in (port, ref):
        c.observe_elements([11, 22, 33])
    witness = tfp.fri_proof_of_work(port, convert.fri_config(config), "cpu")
    assert witness == jfp.fri_proof_of_work(ref, config)
    assert port.sponge_state == ref.sponge_state
    assert port.output_buffer == ref.output_buffer


def test_zero_pow_bits_host_grind_takes_witness_zero_where_the_reference_raises():
    """At 0 bits every witness passes and the port takes the lowest, 0;
    the reference's np.uint64(1 << 64) raises OverflowError (ROADMAP
    section 3)."""
    config = _grind_config(0)
    port, ref = Challenger(th.KeccakHasher), JChallenger(jh.KeccakHasher)
    for c in (port, ref):
        c.observe_elements([11, 22, 33])
    assert tfp.fri_proof_of_work(port, convert.fri_config(config), "cpu") == 0
    with pytest.raises(OverflowError):
        jfp.fri_proof_of_work(ref, config)


@pytest.fixture(scope="module")
def keccak_factorial():
    """(CircuitData, proof bytes) of keccak_factorial, built and proved on
    the CPU under the fixtures' seed, with the paths the prove took."""
    rng.seed(SEED)
    try:
        data, proof = factorial.keccak_build_and_prove(device="cpu")
    finally:
        rng.seed(None)
    return data, proof_to_bytes(proof), (tp._LAST_TRANSCRIPT, tfp._LAST_PATH)


def test_keccak_factorial_builds_and_proves_to_the_fixture(keccak_factorial):
    """A Keccak prove takes the host transcript (the reference's route),
    and the paths say so."""
    data, proof, paths = keccak_factorial
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "fixtures", "keccak_factorial.verifier.bin")
    assert proof == _read("fixtures", "keccak_factorial.proof.bin")
    assert paths == ("host", "host")
    assert data.common.generic_config().name == "KeccakGoldilocksConfig"


def test_port_verifies_the_keccak_fixture_and_rejects_a_tampered_one():
    vo, common = verifier_data_from_bytes(_read("fixtures", "keccak_factorial.verifier.bin"),
                                          keccak_goldilocks_config())
    blob = _read("fixtures", "keccak_factorial.proof.bin")
    proof = proof_from_bytes(blob, common)
    verify(proof, vo, common)
    assert proof_to_bytes(proof) == blob
    proof.proof.opening_proof.query_round_proofs[3].initial_trees_proof.evals_proofs[
        1][1].siblings[2] = bytes(25)
    with pytest.raises(ValueError, match="Merkle proof invalid"):
        verify(proof, vo, common)


def test_reference_cpp_verifier_accepts_the_ports_keccak_proof(keccak_factorial, tmp_path,
                                                                monkeypatch):
    """The binary is built into this test's own cache directory (~10 s), so
    that no other test process builds into the same file at once."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    verifier = jnative.verifier_binary()
    if verifier is None:
        pytest.fail("the reference's plonky2_verify did not build")
    data, proof, _ = keccak_factorial
    vd, pf = tmp_path / "vd.bin", tmp_path / "proof.bin"
    vd.write_bytes(verifier_data_to_bytes(data.verifier_only, data.common))
    pf.write_bytes(proof)
    run = subprocess.run([verifier, "--keccak", str(vd), str(pf)], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "OK"
