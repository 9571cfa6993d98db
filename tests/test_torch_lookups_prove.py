"""The port's proves of lookup circuits on the CPU against the reference's.

The 515-lookup circuit (degree 2^5), the two-LUT circuit and the
one-lookup inner circuit padded to 2^6, built by the port
(`tests/test_torch_lookups.py`) and proved under seed 2026 at one intra-op
thread: the proofs are the reference's (`plonky2_torch/data/lookup*.proof.bin`,
from `tests/torch_make_data.py --lookups`), at 2^5 on the host transcript
(no FRI fold), at 2^6 on the fused transcript and again on the host one to
the same bytes; the port's verifier and the reference's `plonky2_verify`
accept each, and the port's verifier refuses a tampered lookup opening, as
tests/test_lookups.py:58 has the reference refuse it. Every comparison is
exact.
"""

import copy
import os
import subprocess
import sys

import pytest
import torch

from plonky2_tpu import native as jnative
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri import prover as tfp
from plonky2_torch.iop import witness as tw
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from reference_prove_lookups import INITIAL_A  # noqa: E402
from test_torch_lookups import PROVED, SEED, _data, built  # noqa: E402,F401  (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prove(data, initial) -> bytes:
    pw = tw.PartialWitness()
    if initial is not None:
        pw.set_target(initial, INITIAL_A)
    trng.seed(SEED)
    try:
        return proof_to_bytes(data.prove(pw, device="cpu"))
    finally:
        trng.seed(None)


@pytest.fixture(scope="module")
def proved(built):
    """name -> the port's proof bytes (seed 2026) and the transcript taken."""
    out = {}
    for name, (data, initial) in built.items():
        out[name] = (_prove(data, initial), tp._LAST_TRANSCRIPT)
    return out


@pytest.mark.parametrize("name", PROVED)
def test_proves_equal_reference_and_verify(name, built, proved, tmp_path):
    """The port's proof is the reference's, the port's verifier accepts it
    and so does the reference's plonky2_verify."""
    data, _ = built[name]
    proof, path = proved[name]
    assert path == ("fused" if name == "lookup1_6" else "host")
    assert proof == _data(f"{name}.proof.bin")
    data.verify(proof_from_bytes(proof, data.common))
    verifier = jnative.verifier_binary()
    if verifier is None:
        pytest.fail("the reference's plonky2_verify did not build")
    (tmp_path / "vd.bin").write_bytes(_data(f"{name}.verifier.bin"))
    (tmp_path / "proof.bin").write_bytes(proof)
    run = subprocess.run([verifier, str(tmp_path / "vd.bin"), str(tmp_path / "proof.bin")],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def test_host_path_gives_the_fused_proof(built, proved):
    data, initial = built["lookup1_6"]
    with tfp.force_host_path():
        assert _prove(data, initial) == proved["lookup1_6"][0]
        assert tp._LAST_TRANSCRIPT == "host"


def test_tampered_lookup_opening_is_refused(built, proved):
    """As tests/test_lookups.py:58 has the reference refuse it."""
    data, _ = built["lookup515"]
    proof = proof_from_bytes(proved["lookup515"][0], data.common)
    for field in ("lookup_zs", "lookup_zs_next"):
        bad = copy.deepcopy(proof)
        values = getattr(bad.proof.openings, field)
        values[0] = (fs.add(values[0][0], 1), values[0][1])
        with pytest.raises(ValueError):
            data.verify(bad)
