"""The port's multi-table prove and its verifier circuit against the
reference's bytes, on the CPU.

`prove_multi_table` proves `plonky2_torch/examples/multi_table.py`'s three
tables at tests/torch_make_data.py's CTL_LOG_ROWS (2^8, 2^7, 2^6; the
table of 2^6 rows has no FRI fold step, so its FRI runs the host
transcript, the others the fused one) to the reference's proof bytes
(`plonky2_torch/data/ctl_table*.stark_proof.bin`), on the default path and
under `force_host_path()`: the shared transcript leaves each table's FRI in
the state the next table's rounds start from, on both. The port's verifier
accepts them; with table 1's values shifted by 1 it rejects the proofs as
the reference does with new Stark objects (`ctl.npz`: the reference's
quotient closure cache keeps the first prove's CTL challenges, so its
rejection with the first prove's objects, and of an honest second system,
names the quotient, ROADMAP section 3). A fourth table with neither logUp
nor a CTL, proved beside the three, commits no auxiliary polynomials, and
all four proofs are the reference's (`ctl4_table*.stark_proof.bin`).
`tests/test_torch_ctl_wrap.py`
builds and proves the circuit that verifies the three proofs.
"""

import os
import sys

import numpy as np
import pytest
import torch

from plonky2_torch.examples import multi_table as mt
from plonky2_torch.fri import oracle as toracle
from plonky2_torch.fri import prover as fp
from plonky2_torch.starky import cross_table_lookup as tctl
from plonky2_torch.starky.config import StarkConfig
from plonky2_torch.starky.fibonacci_stark import FibonacciStark
from plonky2_torch.starky.serialization import stark_proof_to_bytes

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import reference_prove_ctl as rpc  # noqa: E402
from torch_make_data import (  # noqa: E402
    CTL_LOG_ROWS,
    CTL_POW_BITS,
    CTL_QUERIES,
    CTL_STANDALONE_LOG_ROWS,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "plonky2_torch", "data")
CONFIG = rpc.stark_config(CTL_QUERIES, CTL_POW_BITS, StarkConfig)


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
def system():
    starks, ctls = mt.system()
    traces, pis = mt.generate_traces(CTL_LOG_ROWS)
    return starks, ctls, traces, pis


@pytest.fixture(scope="module")
def proofs(system):
    """The port's proofs on the default path, with the FRI paths taken."""
    starks, ctls, traces, pis = system
    paths = []
    real = toracle.fri_proof

    def recording(*a, **k):
        out = real(*a, **k)
        paths.append(fp._LAST_PATH)
        return out

    toracle.fri_proof = recording
    try:
        out, _ = tctl.prove_multi_table(starks, CONFIG, traces, pis, ctls, device="cpu")
    finally:
        toracle.fri_proof = real
    return out, paths


@pytest.mark.parametrize("path", ["default", "host"])
def test_tables_prove_to_reference(system, proofs, path):
    starks, ctls, traces, pis = system
    if path == "default":
        got, paths = proofs
        assert paths == ["fused", "fused", "host"]
    else:
        with fp.force_host_path():
            got, _ = tctl.prove_multi_table(starks, CONFIG, traces, pis, ctls, device="cpu")
        assert fp._LAST_PATH == "host"
    for i, proof in enumerate(got):
        assert stark_proof_to_bytes(proof, CONFIG) == _read(f"ctl_table{i}.stark_proof.bin")
    assert got[0].public_inputs == pis[0]
    tctl.verify_multi_table(starks, CONFIG, got, ctls)


def test_shifted_memory_rejected_as_reference(system):
    """The same Stark objects as the honest prove: the port keeps no
    transcript value between proves, so its verdict is the CTL sum's."""
    starks, ctls, traces, pis = system
    want = np.load(os.path.join(DATA, "ctl.npz"))
    bad, _ = tctl.prove_multi_table(starks, CONFIG, mt.shifted_memory(traces), pis, ctls,
                                    device="cpu")
    with pytest.raises(ValueError) as e:
        tctl.verify_multi_table(starks, CONFIG, bad, ctls)
    assert f"ValueError: {e.value}" == str(want["rejected"])
    assert "quotient" in str(want["rejected_same_objects"])
    assert "quotient" in str(want["reproved_same_objects"])


def test_table_outside_every_ctl_proves_to_reference(system):
    """A Fibonacci table outside every CTL, and without logUp, as a fourth
    table: no auxiliary commitment and no ctl_zs_first; the transcript of
    all four is the reference's."""
    starks, ctls, traces, pis = system
    stark, trace, table_pis = rpc.standalone_table(CTL_STANDALONE_LOG_ROWS, FibonacciStark)
    starks, traces, pis = starks + [stark], traces + [trace], pis + [table_pis]
    got, _ = tctl.prove_multi_table(starks, CONFIG, traces, pis, ctls, device="cpu")
    assert got[3].proof.auxiliary_polys_cap is None
    assert got[3].proof.openings.ctl_zs_first is None
    for i, proof in enumerate(got):
        assert stark_proof_to_bytes(proof, CONFIG) == _read(f"ctl4_table{i}.stark_proof.bin")
    tctl.verify_multi_table(starks, CONFIG, got, ctls)
