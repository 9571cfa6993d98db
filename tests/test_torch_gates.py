"""Every gate of the bench_recursion middle circuit: the port's device
evaluation equals the reference package's `eval_unfiltered_device` exactly
(field values and constraint order) on random wires, gate constants and
public-inputs hash drawn from a numpy seed, at Q = 8 points; and the
port's tensorized form equals its own generic ops-protocol form."""

import numpy as np
import jax.numpy as jnp
import pytest

from plonky2_tpu.field import scalar as fs
from plonky2_tpu.gates.arithmetic_base import ArithmeticGate
from plonky2_tpu.gates.arithmetic_extension import ArithmeticExtensionGate, MulExtensionGate
from plonky2_tpu.gates.base_sum import BaseSumGate
from plonky2_tpu.gates.coset_interpolation import CosetInterpolationGate
from plonky2_tpu.gates.poseidon_gate import PoseidonGate
from plonky2_tpu.gates.random_access import RandomAccessGate
from plonky2_tpu.gates.reducing import ReducingExtensionGate, ReducingGate
from plonky2_tpu.gates.simple_gates import ConstantGate, NoopGate, PublicInputGate
from plonky2_torch import convert
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.gates.gate import Gate as TGate

Q = 8

# (gate, number of gate constants): the cases of tests/test_gate_device_eval.py
# for the middle circuit's gates, and its three simple gates
CASES = [
    (ArithmeticGate(20), 2),
    (ArithmeticExtensionGate(10), 2),
    (MulExtensionGate(13), 1),
    (BaseSumGate(63, 2), 0),
    (BaseSumGate(32, 4), 0),
    (ReducingGate(43), 0),
    (ReducingGate(1), 0),
    (ReducingExtensionGate(32), 0),
    (ReducingExtensionGate(1), 0),
    (RandomAccessGate(4, 4, 2), 2),
    (RandomAccessGate(2, 10, 0), 0),
    (CosetInterpolationGate(4, 6), 0),
    (PoseidonGate(), 0),
    (NoopGate(), 0),
    (ConstantGate(2), 2),
    (PublicInputGate(), 0),
]


def _inputs(gate, num_constants):
    rng = np.random.default_rng(sum(gate.id().encode()))
    wires = rng.integers(0, fs.P, size=(135, Q), dtype=np.uint64)
    consts = rng.integers(0, fs.P, size=(max(num_constants, 1), Q), dtype=np.uint64)
    pi = rng.integers(0, fs.P, size=(4,), dtype=np.uint64)
    return wires, consts, pi


def _port_eval(gate, wires, consts, pi, generic=False):
    port = convert.gate_from_reference(gate)
    assert port.id() == gate.id()
    args = (tg.tensor(wires, "cpu"), tg.tensor(consts, "cpu"), tg.tensor(pi, "cpu"))
    if generic:
        return tg.to_numpy(TGate.eval_unfiltered_device(port, *args))
    return tg.to_numpy(port.eval_unfiltered_device(*args))


@pytest.mark.parametrize("gate,nc", CASES, ids=[c[0].id() for c in CASES])
def test_gate_device_eval_equals_reference(gate, nc):
    wires, consts, pi = _inputs(gate, nc)
    want = np.asarray(gate.eval_unfiltered_device(jnp.asarray(wires), jnp.asarray(consts),
                                                  jnp.asarray(pi)))
    got = _port_eval(gate, wires, consts, pi)
    assert got.shape == want.shape == (gate.num_constraints(), Q)
    assert (got == want).all()


@pytest.mark.parametrize("gate,nc", CASES, ids=[c[0].id() for c in CASES])
def test_gate_tensorized_form_equals_generic_form(gate, nc):
    wires, consts, pi = _inputs(gate, nc)
    assert (_port_eval(gate, wires, consts, pi)
            == _port_eval(gate, wires, consts, pi, generic=True)).all()
