"""The port's variable-degree STARK recursion proved on the CPU, against the
reference package's bytes.

One circuit (`examples/stark_recursion.py` `wrap_circuit`, max degree
2^10, `min_degree_bits_to_support` 2^4, the inner StarkConfig at
STARK_WRAP_QUERIES FRI queries as the reference's
tests/test_stark_recursion.py has it, the outer
standard_recursion_config()) has the reference's verifier bytes and proves
the FibonacciStark proofs of 2^5 and 2^7 rows made under
`verifier_circuit_fri_params = fri_params(10)`, each the reference's
bytes and accepted by the port's host verifier under those params only,
to the reference's wrap proofs (`plonky2_torch/data/stark_var10_*`,
`stark_wrap_var10_4*`, written by `tests/torch_make_data.py
--stark-recursion`), which expose the STARK's public inputs and verify.
Kept apart from tests/test_torch_stark_recursion.py so that each file
runs in well under a minute on one CPU thread.
"""

import os
import sys

import pytest
import torch

from plonky2_torch.examples import stark_recursion as sr
from plonky2_torch.fri import prover as fp
from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
from plonky2_torch.plonk.serialization import proof_to_bytes
from plonky2_torch.starky.fibonacci_stark import FibonacciStark
from plonky2_torch.starky.prover import prove
from plonky2_torch.starky.serialization import stark_proof_to_bytes
from plonky2_torch.starky.verifier import verify_stark_proof

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_stark_recursion import OUTER, SMALL, _case, _read, _seeded  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variable_circuit():
    return sr.wrap_circuit(FibonacciStark(1 << 10), SMALL, 10, OUTER, min_degree_bits=4,
                           device="cpu")


def test_variable_wrap_circuit_equals_reference(variable_circuit):
    data, _ = variable_circuit
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "stark_wrap_var10_4.verifier.bin")


@pytest.mark.parametrize("log_rows", [5, 7])
def test_variable_wrap_proves_to_reference(variable_circuit, log_rows):
    """The 2^7 wrap on the fused transcript, the 2^5 one on the host
    transcript (the same bytes either way); the 2^7 proof verified."""
    data, pt = variable_circuit
    vc = SMALL.fri_params(10)
    stark, trace, pis = _case("fibonacci", log_rows)
    stark_proof = prove(stark, SMALL, trace, pis, device="cpu", verifier_circuit_fri_params=vc)
    assert stark_proof_to_bytes(stark_proof, SMALL) == _read(
        f"stark_var10_{log_rows}.stark_proof.bin")
    verify_stark_proof(stark, stark_proof, SMALL, verifier_circuit_fri_params=vc)
    with pytest.raises(ValueError):  # its transcript is not the plain one
        verify_stark_proof(stark, stark_proof, SMALL)
    inputs = sr.wrap_inputs(pt, stark_proof, log_rows)
    if log_rows == 7:
        proof = _seeded(lambda: data.prove(inputs, device="cpu"))
        assert fp._LAST_PATH == "fused"
    else:
        with fp.force_host_path():
            proof = _seeded(lambda: data.prove(inputs, device="cpu"))
    assert proof_to_bytes(proof) == _read(f"stark_wrap_var10_4_{log_rows}.proof.bin")
    assert proof.public_inputs == pis
    if log_rows == 7:
        data.verify(proof)
