"""The port's host Poseidon on its native library, on the CPU.

`hash/poseidon.py` `permute` runs the native `poseidon_permute`; its Python
loop stays as `permute_py`, the tested twin. On a few hundred numpy-seeded
states the native permutation equals the twin and the reference's
`permute_py`; the host sponges, `two_to_one` and a host Merkle check give
the reference's values; a library that cannot be built or loaded makes
`permute` raise rather than fall back; and the host verifier of the
committed three-table CTL proofs, which runs its transcript and Merkle
checks on this permutation, finishes well under a second. Exact equality.
"""

import os
import sys
import time

import numpy as np
import pytest

from plonky2_tpu.hash import poseidon as jp
from plonky2_torch import native
from plonky2_torch.examples import multi_table as mt
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.field import scalar as fs
from plonky2_torch.hash import merkle as tm
from plonky2_torch.hash import poseidon as tp
from plonky2_torch.starky import cross_table_lookup as tctl
from plonky2_torch.starky import serialization as tser
from plonky2_torch.starky.config import StarkConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import reference_prove_ctl as rpc  # noqa: E402
from torch_make_data import CTL_POW_BITS, CTL_QUERIES  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "plonky2_torch", "data")


def _states(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, fs.P, size=(n, 12), dtype=np.uint64)


def test_native_permute_equals_its_twin_and_the_reference():
    states = _states(1, 300)
    states[0] = 0
    states[1] = fs.P - 1
    for s in states.tolist():
        got = tp.permute(s)
        assert got == tp.permute_py(s) == jp.permute_py(s)
        assert all(type(v) is int for v in got)


def test_native_permute_of_a_batch_equals_one_by_one():
    states = _states(2, 64)
    batch = native.poseidon_permute(states)
    assert batch.tolist() == [tp.permute_py(s) for s in states.tolist()]


@pytest.mark.parametrize("n_inputs", [0, 1, 4, 8, 9, 21, 135])
def test_host_sponges_equal_reference(n_inputs):
    xs = [int(v) for v in _states(3, 12).ravel()[:n_inputs]]
    assert tp.hash_no_pad(xs) == jp.hash_no_pad(xs)
    assert tp.hash_n_to_m_no_pad(xs, 11) == jp.hash_n_to_m_no_pad(xs, 11)
    assert tp.hash_or_noop(xs) == jp.hash_or_noop(xs)


def test_two_to_one_equals_reference():
    for s in _states(4, 20).tolist():
        assert tp.two_to_one(s[:4], s[4:8]) == jp.two_to_one(s[:4], s[4:8])
        assert tp.two_to_one(s[:4], s[4:8]) == tp.hash_no_pad(s[:8])


def test_host_merkle_check_accepts_and_rejects():
    leaves = np.random.default_rng(5).integers(0, fs.P, size=(1 << 6, 13), dtype=np.uint64)
    tree = tm.MerkleTree(tg.tensor(leaves, "cpu"), cap_height=2)
    for i, (leaf, proof) in zip((0, 17, 63), tree.open_many([0, 17, 63])):
        assert leaf == [int(v) for v in leaves[i]]
        tm.verify_merkle_proof_to_cap(leaf, i, tree.cap, proof)
        with pytest.raises(ValueError):
            tm.verify_merkle_proof_to_cap([(leaf[0] + 1) % fs.P] + leaf[1:], i, tree.cap, proof)


def test_permute_raises_where_the_library_cannot_load(monkeypatch):
    """No silent fallback to the Python loop."""
    def fail():
        raise RuntimeError("building the native witness executor failed")

    monkeypatch.setattr(native, "library", fail)
    with pytest.raises(RuntimeError, match="native"):
        tp.permute([0] * 12)
    with pytest.raises(RuntimeError, match="native"):
        tp.hash_no_pad([1, 2, 3, 4, 5])
    with pytest.raises(RuntimeError, match="native"):
        tp.two_to_one([1, 2, 3, 4], [5, 6, 7, 8])


def test_verify_multi_table_on_the_committed_proofs_is_fast(monkeypatch):
    """Well under a second, and never through the Python twin, which
    takes about ten times as long here."""
    def twin(state):
        raise AssertionError("the host verifier ran the Python permutation")

    monkeypatch.setattr(tp, "permute_py", twin)
    config = rpc.stark_config(CTL_QUERIES, CTL_POW_BITS, StarkConfig)
    starks, ctls = mt.system()
    proofs = []
    for i in range(3):
        with open(os.path.join(DATA, f"ctl_table{i}.stark_proof.bin"), "rb") as f:
            proofs.append(tser.stark_proof_from_bytes(f.read(), config))
    tp.permute([0] * 12)  # the library loaded
    t0 = time.perf_counter()
    tctl.verify_multi_table(starks, config, proofs, ctls)
    assert time.perf_counter() - t0 < 0.5
