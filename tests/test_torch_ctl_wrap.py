"""The circuit that verifies a multi-table proof, against the reference's
bytes, on the CPU.

`examples/multi_table.py` `wrap_circuit` builds one Plonky2 circuit under
`standard_recursion_config()` that verifies the three tables' STARK proofs
at tests/torch_make_data.py's CTL_LOG_ROWS and the CTL sums
(`verify_multi_table_circuit`), every table's public inputs registered. It
is built to the reference's verifier data and proved, from the reference's
three proofs (`plonky2_torch/data/ctl_table*.stark_proof.bin`, which
`tests/test_torch_ctl_prove.py` holds the port's proves to) with the rng
seeded to 2026, to the reference's proof (`ctl_wrap.*.bin`, from
`tests/torch_make_data.py --ctl`), which the port's verifier accepts and,
with a tampered opening, rejects.
"""

import os
import sys

import pytest
import torch

from plonky2_torch.examples import multi_table as mt
from plonky2_torch.field import scalar as fs
from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.plonk.serialization import proof_to_bytes
from plonky2_torch.starky.config import StarkConfig
from plonky2_torch.starky.serialization import stark_proof_from_bytes
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import reference_prove_ctl as rpc  # noqa: E402
from torch_make_data import CTL_LOG_ROWS, CTL_POW_BITS, CTL_QUERIES  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "plonky2_torch", "data")
CONFIG = rpc.stark_config(CTL_QUERIES, CTL_POW_BITS, StarkConfig)
SEED = 2026


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def circuit():
    starks, ctls = mt.system()
    return mt.wrap_circuit(starks, CONFIG, list(CTL_LOG_ROWS), ctls,
                           CircuitConfig.standard_recursion_config(), device="cpu")


def test_multi_table_circuit_equals_reference(circuit):
    data, _ = circuit
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "ctl_wrap.verifier.bin")


def test_multi_table_circuit_proves_to_reference(circuit):
    data, pts = circuit
    proofs = [stark_proof_from_bytes(_read(f"ctl_table{i}.stark_proof.bin"), CONFIG)
              for i in range(3)]
    trng.seed(SEED)
    try:
        proof = data.prove(mt.wrap_inputs(pts, proofs), device="cpu")
    finally:
        trng.seed(None)
    assert proof_to_bytes(proof) == _read("ctl_wrap.proof.bin")
    assert proof.public_inputs == [v for p in proofs for v in p.public_inputs]
    data.verify(proof)
    w0 = proof.proof.openings.wires[0]
    proof.proof.openings.wires[0] = ((w0[0] + 1) % fs.P, w0[1])
    with pytest.raises(ValueError):
        data.verify(proof)
