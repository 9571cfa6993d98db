"""The port's STARK -> SNARK recursion against the reference package, on the CPU.

The fixed-degree circuits verifying FibonacciStark and LookupTestStark
proofs of 2^5 rows (StarkConfig.standard_fast_config(), the reference's
tests/test_stark_recursion.py) and the variable-degree circuit (max 2^10,
min 2^4) leave the reference's builder state: gate rows and constants,
copy constraints, generators, constants and virtual targets (built under
`no_commitment`). At the inner config's 1 FRI query (the reference test's
variable-degree size; 84 queries make a 2^11 circuit, a minute to prove on
this CPU) the port builds the fixed-degree circuits to the reference's
verifier bytes (`plonky2_torch/data/stark_wrap_*`, written by
`tests/torch_make_data.py --stark-recursion`), proves the FibonacciStark
wrap to the reference's proof bytes, which verify and expose the STARK's
public inputs, and its verifier accepts the reference's LookupTestStark
wrap. `tests/test_torch_stark_recursion_prove.py` proves the
variable-degree circuit. `fri_proof` in the unified shape of such proofs
equals the reference's on both transcript paths (tests/test_fri_path_matrix.py:299's
case and one with zero final coefficients; `plonky2_torch/data/fri_unified.npz`,
from `tests/torch_make_data.py --batch-fri`), and `fri_challenges` pads as
the reference's does. Every comparison is exact.
"""

import dataclasses
import os
import sys

import pytest
import torch

from plonky2_tpu.fri import verifier as jfv
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.starky import fibonacci_stark as jfib
from plonky2_tpu.starky import recursive_verifier as jsrv
from plonky2_tpu.starky import test_starks as jtest_starks
from plonky2_tpu.starky.config import StarkConfig as JStarkConfig
from plonky2_torch.examples import batch_fri as bf
from plonky2_torch.examples import stark_recursion as sr
from plonky2_torch.field import goldilocks as gl
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri import config as tfc
from plonky2_torch.fri import prover as fp
from plonky2_torch.fri import verifier as tfv
from plonky2_torch.hash import merkle
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.plonk.serialization import proof_to_bytes
from plonky2_torch.starky import recursive_verifier as tsrv
from plonky2_torch.starky.config import StarkConfig
from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
from plonky2_torch.starky.prover import prove
from plonky2_torch.starky.test_starks import LookupTestStark
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_batch_fri import _npz, _state, _want_state  # noqa: E402
from test_torch_recursion import _both, no_commitment  # noqa: E402,F401
from torch_make_data import STARK_WRAP_QUERIES, unified_shape_case  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "plonky2_torch", "data")
SEED = 2026
OUTER = CircuitConfig.standard_recursion_config()


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _config(package_config, queries=None):
    config = package_config.standard_fast_config()
    if queries is None:
        return config
    return dataclasses.replace(config, fri_config=dataclasses.replace(
        config.fri_config, num_query_rounds=queries))


SMALL = _config(StarkConfig, STARK_WRAP_QUERIES)


def _stark(name: str, n: int, port: bool = True):
    if name == "fibonacci":
        return (FibonacciStark if port else jfib.FibonacciStark)(n)
    return (LookupTestStark if port else jtest_starks.LookupTestStark)(n)


def _case(name: str, log_rows: int):
    n = 1 << log_rows
    stark = _stark(name, n)
    if name == "fibonacci":
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        return stark, stark.generate_trace(pis[0], pis[1]), pis
    return stark, stark.generate_trace(), []


def _seeded(run):
    trng.seed(SEED)
    try:
        return run()
    finally:
        trng.seed(None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the builder state ------------------------------------------------------------------

@pytest.mark.parametrize("variable", [False, True], ids=["fixed", "variable"])
@pytest.mark.parametrize("name", ["fibonacci", "lookup"])
def test_wrap_circuit_builder_state_equals_reference(name, variable, no_commitment):
    """The fixed form at 84 queries (the reference test's), the variable
    form at (max 10, min 4) and STARK_WRAP_QUERIES (the reference test's)."""
    degree_bits = 10 if variable else 5

    def make(b, ops):
        port = ops.__name__.startswith("plonky2_torch")
        srv = tsrv if port else jsrv
        config = _config(StarkConfig if port else JStarkConfig,
                         STARK_WRAP_QUERIES if variable else None)
        stark = _stark(name, 1 << degree_bits, port)
        pt = srv.add_virtual_stark_proof_with_pis(b, stark, config, degree_bits,
                                                  with_degree_target=variable)
        srv.verify_stark_proof_circuit(b, stark, pt, config, degree_bits,
                                       min_degree_bits_to_support=4 if variable else None)
        b.register_public_inputs(pt.public_inputs)
        return [pt.public_inputs, pt.proof.trace_cap, pt.proof.degree_bits or []]

    _both(make)


def test_circuit_ops_from_base_target_equals_reference(no_commitment):
    def make(b, ops):
        t = b.add_virtual_target()
        return [t, ops.CircuitOps(b).from_base_target(t)]

    _both(make)


# -- builds and proves to the reference's bytes ---------------------------------------------

def test_fixed_wrap_proves_to_reference():
    """The FibonacciStark wrap, proved on the fused transcript."""
    stark, trace, pis = _case("fibonacci", 5)
    stark_proof = prove(stark, SMALL, trace, pis, device="cpu")
    data, pt = sr.wrap_circuit(stark, SMALL, 5, OUTER, device="cpu")
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "stark_wrap_fibonacci5.verifier.bin")
    proof = _seeded(lambda: data.prove(sr.wrap_inputs(pt, stark_proof), device="cpu"))
    assert fp._LAST_PATH == "fused"
    assert proof_to_bytes(proof) == _read("stark_wrap_fibonacci5.proof.bin")
    assert proof.public_inputs == pis
    data.verify(proof)


def test_lookup_wrap_builds_to_reference():
    """The LookupTestStark wrap: the reference's verifier bytes, and the
    port's verifier accepts the reference's proof and refuses it with a
    tampered opening (its prove runs on the card, chip_smoke's
    `stark_recursion` phase; tests/test_torch_stark_recursion_prove.py
    proves the variable-degree circuit on the CPU)."""
    from plonky2_torch.plonk.serialization import proof_from_bytes

    data, _ = sr.wrap_circuit(_stark("lookup", 1 << 5), SMALL, 5, OUTER, device="cpu")
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "stark_wrap_lookup5.verifier.bin")
    proof = proof_from_bytes(_read("stark_wrap_lookup5.proof.bin"), data.common)
    data.verify(proof)
    w0 = proof.proof.openings.wires[0]
    proof.proof.openings.wires[0] = ((w0[0] + 1) % fs.P, w0[1])
    with pytest.raises(ValueError):
        data.verify(proof)


# -- the unified shape ---------------------------------------------------------------

def _unified(name: str):
    degree_bits, (c0, c1), leaves = unified_shape_case()
    config = tfc.FriConfig(rate_bits=1, cap_height=0, proof_of_work_bits=1,
                           reduction_strategy=tfc.FriReductionStrategy.ConstantArityBits(1, 2),
                           num_query_rounds=2)
    params = config.fri_params(degree_bits, False)
    steps = len(params.reduction_arity_bits)
    kwargs = ({"max_num_query_steps": steps + 1} if name == "steps" else
              {"max_num_query_steps": steps + 2,
               "final_poly_coeff_len": 2 * params.final_poly_len() + 3})
    coeffs = (gl.tensor(c0, "cpu"), gl.tensor(c1, "cpu"))
    return params, coeffs, merkle.MerkleTree(gl.tensor(leaves, "cpu"), 0), kwargs


@pytest.mark.parametrize("path", ["fused", "host"])
@pytest.mark.parametrize("name", ["steps", "steps_coeffs"])
def test_unified_shape_fri_proof_equals_reference(name, path):
    params, coeffs, tree, kwargs = _unified(name)
    challenger = Challenger()
    challenger.observe_element(1)
    if path == "host":
        with fp.force_host_path():
            proof = fp.fri_proof([tree], coeffs, challenger, params, **kwargs)
    else:
        proof = fp.fri_proof([tree], coeffs, challenger, params, **kwargs)
    assert fp._LAST_PATH == path
    want = _npz("fri_unified.npz")
    assert bf.proof_bytes(proof) == want[f"{name}_proof"].tobytes()
    assert _state(challenger) == _want_state(want, f"{name}_")


@pytest.mark.parametrize("name", ["steps", "steps_coeffs"])
def test_fri_challenges_pad_as_reference(name):
    """The verifier's replay of a unified-shape proof: the port's and the
    reference's challenges and challenger states agree, and the padded
    replay ends where the prover's transcript did."""
    params, coeffs, tree, kwargs = _unified(name)
    challenger = Challenger()
    challenger.observe_element(1)
    proof = fp.fri_proof([tree], coeffs, challenger, params, **kwargs)
    out = []
    for ch_cls, fri in ((Challenger, tfv), (JChallenger, jfv)):
        ch = ch_cls()
        ch.observe_element(1)
        ch.observe_cap(tree.cap)
        ch.get_extension_challenge(2)  # where the prover's alpha would be
        out.append((fri.fri_challenges(ch, proof.commit_phase_merkle_caps, proof.final_poly,
                                       proof.pow_witness, params.degree_bits, params.config,
                                       **kwargs), _state(ch)))
    (got, got_state), (want, want_state) = out
    assert (got.fri_betas, got.fri_pow_response, got.fri_query_indices) == (
        want.fri_betas, want.fri_pow_response, want.fri_query_indices)
    assert got_state == want_state
    unpadded = Challenger()
    unpadded.observe_element(1)
    unpadded.observe_cap(tree.cap)
    unpadded.get_extension_challenge(2)
    plain = tfv.fri_challenges(unpadded, proof.commit_phase_merkle_caps, proof.final_poly,
                               proof.pow_witness, params.degree_bits, params.config)
    assert plain.fri_query_indices != got.fri_query_indices


def test_recursive_verifier_refuses_what_is_not_ported(no_commitment):
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder

    stark = FibonacciStark(1 << 5)
    b = CircuitBuilder(OUTER)
    # a table of a multi-table proof: its CTL helper and Z column in the
    # auxiliary oracle, its Z opened at 1, which only a builder lifts
    ctl_pt = tsrv.add_virtual_stark_proof_with_pis(b, stark, SMALL, 5, num_ctl_helper_zs=1,
                                                   num_ctl_zs=1)
    assert len(ctl_pt.proof.openings.auxiliary_polys) == 1
    assert len(ctl_pt.proof.openings.ctl_zs_first) == 1
    with pytest.raises(ValueError):
        ctl_pt.proof.openings.to_fri_openings()
    assert len(ctl_pt.proof.openings.to_fri_openings(b).batches) == 3
    pt = tsrv.add_virtual_stark_proof_with_pis(b, stark, SMALL, 5)
    with pytest.raises(ValueError):  # a variable degree needs the degree target
        tsrv.verify_stark_proof_circuit(b, stark, pt, SMALL, 5, min_degree_bits_to_support=4)
