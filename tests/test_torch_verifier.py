"""The port's verifier against the reference package, on the CPU.

The port's `verify` accepts every Poseidon fixture proof
(`fixtures/{factorial,fibonacci,range_check,square_root,bench_recursion}`,
the last the recursion chain's outer proof) and
`bench_cache/inner14.proof.bin`. On tampered copies of factorial's proof
(an opening, a Merkle sibling, the PoW witness, a public input, the final
polynomial, a missing opening) it raises what the reference's
`plonk/verifier.py` `verify` raises: the same exception class and message.
Every gate's `eval_unfiltered` on `HostExtOps` (the verifier's form at ζ)
equals the reference's at seeded random points, and the builder takes the
Keccak config by its name and refuses a name it has no config for.
"""

import copy
import os

import numpy as np
import pytest

from plonky2_tpu.field import scalar as fs
from plonky2_tpu.gates import ops as jops
from plonky2_tpu.gates.arithmetic_base import ArithmeticGate
from plonky2_tpu.gates.arithmetic_extension import ArithmeticExtensionGate, MulExtensionGate
from plonky2_tpu.gates.base_sum import BaseSumGate
from plonky2_tpu.gates.coset_interpolation import CosetInterpolationGate
from plonky2_tpu.gates.poseidon_gate import PoseidonGate
from plonky2_tpu.gates.random_access import RandomAccessGate
from plonky2_tpu.gates.reducing import ReducingExtensionGate, ReducingGate
from plonky2_tpu.gates.simple_gates import ConstantGate, NoopGate, PublicInputGate
from plonky2_tpu.plonk import verifier as jverifier
from plonky2_tpu.plonk.circuit_serialization import verifier_data_from_bytes as j_vd_from_bytes
from plonky2_tpu.plonk.serialization import proof_from_bytes as j_proof_from_bytes
from plonky2_torch import convert
from plonky2_torch.gates import ops as tops
from plonky2_torch.plonk import verifier as tverifier
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes
from plonky2_torch.plonk.serialization import proof_from_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = {name: ("fixtures", name)
            for name in ("factorial", "fibonacci", "range_check", "square_root",
                         "bench_recursion")}
FIXTURES["inner14"] = ("bench_cache", "inner14")


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


def _port(name):
    folder, stem = FIXTURES[name]
    vo, common = verifier_data_from_bytes(_read(folder, f"{stem}.verifier.bin"))
    return proof_from_bytes(_read(folder, f"{stem}.proof.bin"), common), vo, common


@pytest.mark.parametrize("name", list(FIXTURES))
def test_verify_accepts_the_reference_proof(name):
    proof, vo, common = _port(name)
    tverifier.verify(proof, vo, common)


def _bump(x: int) -> int:
    return (x + 1) % fs.P


def _tamper_opening(pwp):
    o = pwp.proof.openings
    o.wires[3] = (_bump(o.wires[3][0]), o.wires[3][1])


def _tamper_sibling(pwp):
    proof = pwp.proof.opening_proof.query_round_proofs[5].initial_trees_proof.evals_proofs[1][1]
    proof.siblings[2] = [_bump(proof.siblings[2][0])] + list(proof.siblings[2][1:])


def _tamper_pow_witness(pwp):
    pwp.proof.opening_proof.pow_witness = _bump(pwp.proof.opening_proof.pow_witness)


def _tamper_public_input(pwp):
    pwp.public_inputs[1] = _bump(pwp.public_inputs[1])


def _tamper_final_poly(pwp):
    fp = pwp.proof.opening_proof.final_poly
    fp[0] = (fp[0][0], _bump(fp[0][1]))


def _tamper_shape(pwp):
    pwp.proof.openings.plonk_sigmas.pop()


TAMPERS = {"opening": _tamper_opening, "merkle sibling": _tamper_sibling,
           "pow witness": _tamper_pow_witness, "public input": _tamper_public_input,
           "final poly": _tamper_final_poly, "shape": _tamper_shape}


def _verdict(verify, proof, vo, common):
    try:
        verify(proof, vo, common)
    except Exception as e:  # noqa: BLE001 (the verdict is the exception)
        return type(e).__name__, str(e)
    return "accepted", ""


@pytest.fixture(scope="module")
def factorial_pair():
    blob_vd = _read("fixtures", "factorial.verifier.bin")
    blob_proof = _read("fixtures", "factorial.proof.bin")
    jvo, jcommon = j_vd_from_bytes(blob_vd)
    vo, common = verifier_data_from_bytes(blob_vd)
    return ((j_proof_from_bytes(blob_proof, jcommon), jvo, jcommon),
            (proof_from_bytes(blob_proof, common), vo, common))


@pytest.mark.parametrize("kind", list(TAMPERS))
def test_tampered_proof_is_rejected_where_the_reference_rejects_it(kind, factorial_pair):
    (jproof, jvo, jcommon), (proof, vo, common) = factorial_pair
    jproof, proof = copy.deepcopy(jproof), copy.deepcopy(proof)
    TAMPERS[kind](jproof)
    TAMPERS[kind](proof)
    want = _verdict(jverifier.verify, jproof, jvo, jcommon)
    assert want[0] == "ValueError", want
    assert _verdict(tverifier.verify, proof, vo, common) == want


# every gate the port has, at the parameters its circuits use
GATES = [
    (NoopGate(), 0), (ConstantGate(2), 2), (PublicInputGate(), 0), (ArithmeticGate(20), 2),
    (ArithmeticExtensionGate(10), 2), (MulExtensionGate(13), 1), (BaseSumGate(63, 2), 0),
    (BaseSumGate(32, 4), 0), (ReducingGate(43), 0), (ReducingExtensionGate(32), 0),
    (RandomAccessGate(4, 4, 2), 2), (RandomAccessGate(2, 10, 0), 0),
    (CosetInterpolationGate(4, 6), 0), (PoseidonGate(), 0),
]


@pytest.mark.parametrize("gate,num_constants", GATES, ids=[g.id()[:40] for g, _ in GATES])
def test_host_ext_gate_evaluation_equals_the_reference(gate, num_constants):
    r = np.random.default_rng(sum(gate.id().encode()))

    def ext(n):
        return [tuple(int(v) for v in r.integers(0, fs.P, size=2, dtype=np.uint64))
                for _ in range(n)]

    wires, constants, pi = ext(135), ext(num_constants), ext(4)
    want = gate.eval_unfiltered(jops.HostExtOps(), jops.EvaluationVars(constants, wires, pi))
    port = convert.gate_from_reference(gate)
    got = port.eval_unfiltered(tops.HostExtOps(), tops.EvaluationVars(constants, wires, pi))
    assert len(want) == gate.num_constraints()
    assert got == [tuple(int(c) for c in v) for v in want]


def test_keccak_config_is_refused_by_name():
    """The configs go by name: the reference's Keccak config object is the
    port's KeccakGoldilocksConfig (ROADMAP item 11, tests/test_torch_keccak.py),
    and a name the port has no config for is refused by name."""
    from plonky2_tpu.plonk.config import keccak_goldilocks_config

    from plonky2_torch.hash.hashers import KeccakHasher, PoseidonHasher

    gc = CircuitBuilder(gc=keccak_goldilocks_config()).gc
    assert (gc.name, gc.hasher, gc.inner_hasher) == ("KeccakGoldilocksConfig", KeccakHasher,
                                                     PoseidonHasher)
    with pytest.raises(NotImplementedError, match="Keccak256GoldilocksConfig is not ported"):
        CircuitBuilder(gc="Keccak256GoldilocksConfig")
