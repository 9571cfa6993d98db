"""The port's batch FRI against the reference package, on the CPU.

`BatchMerkleTree` over tests/test_batch_fri.py:25's matrices has the
reference's cap, values and openings (`plonky2_torch/data/batch_merkle.npz`),
and its paths pass `verify_batch_merkle_proof_to_cap` while a tampered leaf
does not. The batch-FRI proof of two degree groups (2^9 and 2^7, arities
1 x 4, the reference test's size at 8 queries) is the reference's on the
fused and on the host transcript path, challenger states included
(`batch_fri_9_7.npz`); the host verifier accepts it and refuses tampered
openings; its verifier circuit has the reference's builder state, verifier
bytes and proof (`batch_fri_9_7.{verifier,circuit_proof}.bin`), and
verifies. The batch-Merkle and variable-height Merkle gadgets leave the
reference's builder state and witness. The committed
files are written by `tests/torch_make_data.py --batch-fri`; every
comparison is exact.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from plonky2_tpu.fri import config as jfc
from plonky2_torch.examples import batch_fri as bf
from plonky2_torch.field import goldilocks as gl
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri import config as tfc
from plonky2_torch.fri import prover as fp
from plonky2_torch.fri.batch_fri import verify_batch_fri_proof_circuit
from plonky2_torch.hash import merkle
from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.plonk.serialization import proof_to_bytes
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_recursion import (  # noqa: E402,F401  (no_commitment is a fixture)
    _both,
    _flat,
    _random,
    _witness,
    no_commitment,
)
from torch_make_data import BATCH_MERKLE_INDICES, batch_fri_small_params  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "plonky2_torch", "data")
SEED = 2026
PARAMS = batch_fri_small_params(tfc)


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _npz(name: str) -> dict:
    with np.load(os.path.join(DATA, name)) as z:
        return {k: z[k] for k in z.files}


def _state(challenger) -> tuple:
    return (list(challenger.sponge_state), list(challenger.input_buffer),
            list(challenger.output_buffer))


def _want_state(z: dict, prefix: str = "") -> tuple:
    return tuple([int(v) for v in z[prefix + k]] for k in ("sponge", "inputs", "outputs"))


def _ints(rows) -> list:
    return [[int(v) for v in row] for row in rows]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the batch Merkle tree ---------------------------------------------------------

def test_batch_merkle_tree_equals_reference():
    rng = np.random.default_rng(1)
    mats = [rng.integers(0, 1 << 63, size=(64, 5), dtype=np.uint64),
            rng.integers(0, 1 << 63, size=(16, 7), dtype=np.uint64)]
    tree = merkle.BatchMerkleTree([gl.tensor(m, "cpu") for m in mats], 2)
    want = _npz("batch_merkle.npz")
    assert tree.cap == _ints(want["cap"])
    assert tree.leaf_heights == [6, 4]
    indices = list(BATCH_MERKLE_INDICES)
    many = tree.open_batch_many(indices)
    for k, i in enumerate(indices):
        values = tree.values(i)
        assert [v for row in values for v in row] == [int(v) for v in want["values"][k]]
        proof = tree.open_batch(i)
        assert proof.siblings == _ints(want["siblings"][k])
        assert many[k][0] == [int(v) for v in want["many_values"][k]]
        assert many[k][1].siblings == _ints(want["many_siblings"][k])
        merkle.verify_batch_merkle_proof_to_cap(values, tree.leaf_heights, i, tree.cap, proof)
    values = tree.values(0)
    values[1] = [fs.add(values[1][0], 1)] + values[1][1:]
    with pytest.raises(ValueError):
        merkle.verify_batch_merkle_proof_to_cap(values, tree.leaf_heights, 0, tree.cap,
                                                tree.open_batch(0))
    with pytest.raises(ValueError):
        merkle.BatchMerkleTree([gl.tensor(m, "cpu") for m in mats[::-1]], 2)


# -- batch FRI ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_runs():
    """The small case proved on both transcript paths from one oracle."""
    groups = bf.random_groups((9, 7), (3, 2), 2)
    oracle = bf.commit(groups, PARAMS, "cpu")
    fused = bf.prove(groups, PARAMS, oracle=oracle)
    fused_path = fp._LAST_PATH
    with fp.force_host_path():
        host = bf.prove(groups, PARAMS, oracle=oracle)
        host_path = fp._LAST_PATH
    return {"fused": (fused, fused_path), "host": (host, host_path)}


@pytest.mark.parametrize("path", ["fused", "host"])
def test_batch_fri_proof_equals_reference(small_runs, path):
    run, took = small_runs[path]
    assert took == f"batch_{path}"
    want = _npz("batch_fri_9_7.npz")
    assert bf.proof_bytes(run.proof) == want["proof"].tobytes()
    assert _state(run.challenger) == _want_state(want)


def test_batch_fri_verifier_accepts_and_refuses_tampered(small_runs):
    run = small_runs["fused"][0]
    values = bf.openings(run)
    bf.verify(run, PARAMS, values)
    bad = [list(v) for v in values]
    bad[1][0] = (fs.add(bad[1][0][0], 1), bad[1][0][1])
    with pytest.raises(ValueError):
        bf.verify(run, PARAMS, bad)
    step = run.proof.query_round_proofs[0].steps[2]
    kept = step.evals[0]
    step.evals[0] = (fs.add(kept[0], 1), kept[1])
    try:
        with pytest.raises(ValueError):
            bf.verify(run, PARAMS, values)
    finally:
        step.evals[0] = kept


def test_batch_fri_circuit_equals_reference(small_runs, no_commitment):
    """The verifier circuit's builder state is the reference's."""
    from plonky2_tpu.fri import batch_fri as jbf
    from plonky2_tpu.fri import recursive_verifier as jrv
    from plonky2_tpu.fri import structure as jst
    from plonky2_torch.fri import recursive_verifier as trv
    from plonky2_torch.fri import structure as tst

    run = small_runs["fused"][0]
    values = bf.openings(run)

    def make(b, ops):
        port = ops.__name__.startswith("plonky2_torch")
        rv, st = (trv, tst) if port else (jrv, jst)
        params = PARAMS if port else batch_fri_small_params(jfc)
        cap_t = rv.add_virtual_cap(b, 2)
        proof_t = rv.add_virtual_fri_proof(b, [5], params)
        challenges_t = rv.FriChallengesTarget(
            fri_alpha=b.add_virtual_extension_target(),
            fri_betas=b.add_virtual_extension_targets(4),
            fri_pow_response=b.add_virtual_target(),
            fri_query_indices=b.add_virtual_targets(8))
        instances = [st.FriInstanceInfo(
            oracles=[st.FriOracleInfo(c, False)],
            batches=[st.FriBatchInfo(point=b.constant_extension(z),
                                     polynomials=st.FriPolynomialInfo.from_range(0, range(c)))])
            for c, z in zip((3, 2), bf.POINTS)]
        openings = [st.FriOpenings(batches=[st.FriOpeningBatch(
            values=[b.constant_extension(v) for v in vals])]) for vals in values]
        verify = verify_batch_fri_proof_circuit if port else jbf.verify_batch_fri_proof_circuit
        verify(b, [9, 7], instances, openings, challenges_t, [cap_t], [[12, 10]], proof_t,
               params)
        return [cap_t, proof_t.final_poly]

    _both(make)


def test_batch_fri_circuit_proves_to_reference(small_runs):
    run = small_runs["fused"][0]
    data, targets = bf.circuit(run, PARAMS, CircuitConfig.standard_recursion_config(),
                               device="cpu")
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "batch_fri_9_7.verifier.bin")
    trng.seed(SEED)
    try:
        with fp.force_host_path():
            proof = data.prove(bf.circuit_inputs(targets, run), device="cpu")
    finally:
        trng.seed(None)
    assert proof_to_bytes(proof) == _read("batch_fri_9_7.circuit_proof.bin")
    data.verify(proof)


# -- the Merkle gadgets of batch FRI and of variable degrees ---------------------------

def test_batch_merkle_gadget_equals_reference(no_commitment):
    """A real batch path (matrices 2^6 x 5 and 2^4 x 7, cap height 2)
    checked by both circuits on the same witness."""
    rng = np.random.default_rng(SEED)
    mats = [rng.integers(0, fs.P, size=(64, 5), dtype=np.uint64),
            rng.integers(0, fs.P, size=(16, 7), dtype=np.uint64)]
    tree = merkle.BatchMerkleTree([gl.tensor(m, "cpu") for m in mats], 2)
    index = 45
    rows, proof = tree.open_batch_many([index])[0]

    def make(b, ops):
        x = b.add_virtual_target()
        leaves_t = [b.add_virtual_targets(5), b.add_virtual_targets(7)]
        cap_t = [b.add_virtual_targets(4) for _ in range(4)]
        sibs = [b.add_virtual_targets(4) for _ in range(4)]
        bits = b.low_bits(x, 6, 64)
        cap_index = b.le_sum(bits[4:])
        b.verify_batch_merkle_proof_to_cap_with_cap_index(
            leaves_t, [6, 4], bits, cap_index, cap_t, types.SimpleNamespace(siblings=sibs))
        return [x, leaves_t, cap_t, sibs]

    tb, jb, got, want = _both(make)
    values = [index] + rows + [v for d in tree.cap for v in d] + [
        v for s in proof.siblings for v in s]
    inputs = {t.index: v for t, v in zip(_flat(got), values)}
    _witness(tb, jb, got, want, inputs)


@pytest.mark.parametrize("condition", [0, 1])
def test_cap_indices_gadget_equals_reference(condition, no_commitment):
    """A path of a 2^5-leaf tree checked by the variable-height gadget
    (heights 2^3..2^6) under a condition, and conditional_assert_eq(_ext)."""
    leaves = np.random.default_rng(SEED).integers(0, fs.P, size=(32, 7), dtype=np.uint64)
    tree = merkle.MerkleTree(gl.tensor(leaves, "cpu"), 2)
    index = 21
    leaf, proof = tree.open_many([index])[0]

    def make(b, ops):
        x, n_index, cond = b.add_virtual_targets(3)
        leaf_t = b.add_virtual_targets(7)
        cap_t = [b.add_virtual_targets(4) for _ in range(4)]
        sibs = [b.add_virtual_targets(4) for _ in range(4)]
        bits = b.low_bits(x, 6, 64)
        cap_indices = [b.le_sum(bits[n - 2:n]) for n in range(3, 7)]
        cap_index = b.random_access(n_index, cap_indices)
        b.verify_merkle_proof_to_cap_with_cap_indices(
            cond, leaf_t, bits, 3, 6, n_index, cap_index, cap_t,
            types.SimpleNamespace(siblings=sibs))
        e = b.add_virtual_extension_targets(2)
        b.conditional_assert_eq(cond, x, x)
        b.conditional_assert_eq_ext(cond, e[0], e[1])
        return [x, n_index, cond, leaf_t, cap_t, sibs, e]

    tb, jb, got, want = _both(make)
    ext = _random(4)
    ext = ext[:2] + (ext[:2] if condition else ext[2:])
    # the tree is 2^5 tall: its 3 siblings, then the tallest path's 4th slot zero
    values = [index, 5 - 3, condition] + leaf + [v for d in tree.cap for v in d] + [
        v for s in proof.siblings for v in s] + [0] * 4 + ext
    _witness(tb, jb, got, want, {t.index: v for t, v in zip(_flat(got), values)})
