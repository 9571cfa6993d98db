"""The port's Keccak-hashed Starky against the reference package, on the CPU.

FibonacciStark(2^5) (tests/test_starky.py:test_fibonacci_stark_keccak_hasher's
case) and LookupTestStark(2^5), proved by the port under `KeccakHasher` and
`StarkConfig.standard_fast_config()`: the LDEs stay on the port's tensors,
the trees and the grind run on the host (`KeccakMerkleTree`,
`_fri_proof_of_work_host`) and FRI takes the host path. Each proof equals
the reference's field by field: the reference writes no bytes for such a
proof, so `plonky2_torch/data/stark_keccak.json` (tests/torch_make_data.py
--stark-keccak) holds the sha256 of each field of its walk
(tests/torch_proof_walk.py). The port's Keccak verifier accepts each proof;
a Poseidon verifier and a tampered opening are rejected, as the reference
rejects them.
"""

import copy
import json
import os
import sys

import pytest
import torch

from plonky2_torch.fri import prover as tfp
from plonky2_torch.hash import merkle as tm
from plonky2_torch.hash.hashers import KeccakHasher
from plonky2_torch.starky.config import StarkConfig
from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
from plonky2_torch.starky.prover import prove
from plonky2_torch.starky.test_starks import LookupTestStark
from plonky2_torch.starky.verifier import verify_stark_proof

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_make_data import STARK_KECCAK_LOG_ROWS  # noqa: E402
from torch_proof_walk import digest, field_digests  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = StarkConfig.standard_fast_config()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    with open(os.path.join(ROOT, "plonky2_torch", "data", "stark_keccak.json")) as f:
        return json.load(f)


def _case(name: str, log_rows: int):
    n = 1 << log_rows
    if name == "fibonacci":
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        return stark, stark.generate_trace(pis[0], pis[1]), pis
    stark = LookupTestStark(n)
    return stark, stark.generate_trace(), []


@pytest.fixture(scope="module")
def proofs():
    """{name: (stark, proof, FRI path, host trees made)} of the port's CPU
    proves."""
    out = {}
    for name in ("fibonacci", "lookup"):
        stark, trace, pis = _case(name, STARK_KECCAK_LOG_ROWS)
        tm.reset_host_trees()
        proof = prove(stark, CONFIG, trace, pis, device="cpu", hasher=KeccakHasher)
        out[name] = (stark, proof, tfp._LAST_PATH, tm.HOST_TREES["trees"])
    return out


@pytest.mark.parametrize("name", ["fibonacci", "lookup"])
def test_proof_equals_reference_field_by_field(name, proofs, reference):
    _, proof, path, trees = proofs[name]
    want = reference[f"{name}{STARK_KECCAK_LOG_ROWS}"]
    assert field_digests(proof) == want["fields"]
    assert digest(proof) == want["digest"]
    assert path == "host"
    assert trees > 0
    assert all(isinstance(d, bytes) and len(d) == KeccakHasher.HASH_SIZE
               for d in proof.proof.trace_cap)


@pytest.mark.parametrize("name", ["fibonacci", "lookup"])
def test_keccak_verifier_accepts_and_poseidon_verifier_rejects(name, proofs):
    stark, proof, _, _ = proofs[name]
    verify_stark_proof(stark, proof, CONFIG, hasher=KeccakHasher)
    with pytest.raises(Exception):
        verify_stark_proof(stark, proof, CONFIG)


@pytest.mark.parametrize("name", ["fibonacci", "lookup"])
def test_tampered_opening_rejected(name, proofs):
    stark, proof, _, _ = proofs[name]
    bad = copy.deepcopy(proof)
    v = bad.proof.openings.local_values[0]
    bad.proof.openings.local_values[0] = ((v[0] + 1) % ((1 << 64) - (1 << 32) + 1), v[1])
    with pytest.raises(ValueError):
        verify_stark_proof(stark, bad, CONFIG, hasher=KeccakHasher)
    bad = copy.deepcopy(proof)
    cap = bad.proof.trace_cap
    cap[0] = bytes([cap[0][0] ^ 1]) + cap[0][1:]
    with pytest.raises(ValueError):
        verify_stark_proof(stark, bad, CONFIG, hasher=KeccakHasher)
