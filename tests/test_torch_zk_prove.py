"""A zero-knowledge prove of the port on the CPU against the reference's.

The small zk circuit (`zk_factorial`: tests/test_plonk_e2e.py:63's
factorial, 2..29, under `standard_recursion_zk_config()` with 1 FRI query:
degree 2^8 with its 65 blinding rows and 67 blinded Z pairs) built by the
port and proved under seed 2026 on the fused transcript: its verifier
bytes, its proof and its prover data are the reference's
(`plonky2_torch/data/zk_factorial.*`, from `tests/torch_make_data.py
--zk`); the proof reads back to its bytes with salted leaves, and the
port's verifier and the reference's `plonky2_verify` accept it. Every
comparison is exact.
"""

import lzma
import os
import subprocess
import sys

import pytest
import torch

from plonky2_tpu import native as jnative
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk import circuit_builder as tcb
from plonky2_torch.plonk import config as tconfig
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk import prover_serialization as tps
from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_make_data import zk_factorial_circuit  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026


def _data(name: str) -> bytes:
    with open(os.path.join(ROOT, "plonky2_torch", "data", name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def zk_factorial():
    """The port's build and prove (seed 2026, the fused path) of the small
    zk circuit on the CPU at one intra-op thread: (CircuitData, proof
    bytes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        b, initial = zk_factorial_circuit(tconfig, tcb)
        data = b.build(device="cpu")
        pw = PartialWitness()
        pw.set_target(initial, 1)
        trng.seed(SEED)
        try:
            proof = data.prove(pw, device="cpu")
        finally:
            trng.seed(None)
        assert tp._LAST_TRANSCRIPT == "fused"
    finally:
        torch.set_num_threads(threads)
    return data, proof_to_bytes(proof)


def test_zk_factorial_builds_and_proves_to_the_reference_bytes(zk_factorial):
    data, proof = zk_factorial
    assert data.common.degree_bits == 8 and data.common.fri_params.hiding
    assert data.build_info["blinding"] == (65, 67)
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _data(
        "zk_factorial.verifier.bin")
    assert proof == _data("zk_factorial.proof.bin")
    assert tps.prover_data_to_bytes(data.prover_only, data.common) == lzma.decompress(
        _data("zk_factorial.prover.bin.xz"))


def test_zk_proof_round_trips_and_the_port_verifier_accepts_it(zk_factorial):
    """The salted leaves are 135 + 4, 20 + 4 and 16 + 4 felts wide."""
    data, proof = zk_factorial
    read = proof_from_bytes(proof, data.common)
    assert proof_to_bytes(read) == proof
    first = read.proof.opening_proof.query_round_proofs[0].initial_trees_proof
    assert [len(v) for v, _ in first.evals_proofs][1:] == [139, 24, 20]
    data.verify(read)


def test_reference_plonky2_verify_accepts_the_zk_proof(zk_factorial, tmp_path, monkeypatch):
    """The reference's native verifier, built into this test's own cache
    directory, on the port's proof."""
    data, proof = zk_factorial
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    verifier = jnative.verifier_binary()
    if verifier is None:
        pytest.fail("the reference's plonky2_verify did not build")
    vd, pf = tmp_path / "vd.bin", tmp_path / "proof.bin"
    vd.write_bytes(verifier_data_to_bytes(data.verifier_only, data.common))
    pf.write_bytes(proof)
    run = subprocess.run([verifier, str(vd), str(pf)], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "OK"
