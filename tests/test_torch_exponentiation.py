"""ExponentiationGate and PoseidonMdsGate in the port against the reference
package, on the CPU.

Each gate's three constraint forms equal the reference's on random wires
drawn from a numpy seed: the device form (and the port's tensorized form
equals its generic one), the host verifier's `HostExtOps` form, and the
in-circuit `CircuitOps` form, whose builder state (gates, constants, copy
constraints, generators) is the reference's and whose witness values equal
`HostExtOps`'s. Each generator's outputs equal the reference's, on both of
the port's witness engines. The gates' tags (5 and 10) and their
generators' (8 and 16) are written to the reference's bytes and read back.
The recursion circuit over the common data of the bench_recursion inner
circuit at degree 2^18 (`plonky2_torch/data/inner18.verifier.bin`, from
`tests/torch_make_data.py --inner18`) has the reference's builder state:
its query index has 21 bits, more than an arithmetic gate's 20 ops, so
each query's `exp_from_bits` takes an ExponentiationGate row. Every
comparison is exact.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.gates import ops as jops
from plonky2_tpu.gates.exponentiation import ExponentiationGate, ExponentiationGenerator
from plonky2_tpu.gates.poseidon_mds import PoseidonMdsGate, PoseidonMdsGenerator
from plonky2_tpu.plonk import circuit_serialization as jcs
from plonky2_tpu.plonk import prover_serialization as jps
from plonky2_tpu.recursion import recursive_verifier as jrv
from plonky2_torch import convert
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates import ops as tops
from plonky2_torch.gates.gate import Gate as TGate
from plonky2_torch.iop import generator as tgen
from plonky2_torch.iop import witness as tw
from plonky2_torch.iop.target import VirtualTarget
from plonky2_torch.plonk import prover_serialization as tps
from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes
from plonky2_torch.recursion import recursive_verifier as trv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_plonk import _norm  # noqa: E402
from test_torch_recursion import (  # noqa: E402,F401  (no_commitment is a fixture)
    _both,
    _flat,
    _random,
    _witness,
    no_commitment,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026
Q = 8
# the standard config's width (min(80 - 2, (135 - 2) // 2)), a short one,
# and the MDS gate
GATES = [ExponentiationGate(66), ExponentiationGate(5), PoseidonMdsGate()]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wires(gate):
    rng = np.random.default_rng(SEED + gate.num_wires())
    return (rng.integers(0, fs.P, size=(135, Q), dtype=np.uint64),
            rng.integers(0, fs.P, size=(4,), dtype=np.uint64))


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.id()[:32])
def test_device_and_host_forms_equal_reference(gate):
    wires, pi = _wires(gate)
    consts = np.zeros((1, Q), dtype=np.uint64)
    port = convert.gate_from_reference(gate)
    assert port.id() == gate.id()
    want = np.asarray(gate.eval_unfiltered_device(jnp.asarray(wires), jnp.asarray(consts),
                                                  jnp.asarray(pi)))
    args = (tg.tensor(wires, "cpu"), tg.tensor(consts, "cpu"), tg.tensor(pi, "cpu"))
    got = tg.to_numpy(port.eval_unfiltered_device(*args))
    assert got.shape == want.shape == (gate.num_constraints(), Q)
    assert (got == want).all()
    assert (tg.to_numpy(TGate.eval_unfiltered_device(port, *args)) == want).all()
    ext = [(int(a), int(b)) for a, b in zip(wires[:, 0], wires[:, 1])]
    pi_ext = [(int(v), 0) for v in pi]
    assert port.eval_unfiltered(tops.HostExtOps(), tops.EvaluationVars([], ext, pi_ext)) == \
        gate.eval_unfiltered(jops.HostExtOps(), jops.EvaluationVars([], ext, pi_ext))
    for name in ("num_wires", "num_constants", "degree", "num_constraints"):
        assert getattr(port, name)() == getattr(gate, name)(), name


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.id()[:32])
def test_circuit_form_equals_reference(gate, no_commitment):
    """On CircuitOps over virtual extension targets: the reference's
    builder state, and witness values equal to HostExtOps's."""
    port_gate = convert.gate_from_reference(gate)

    def make(b, ops):
        g = port_gate if ops is tops else gate
        wires = b.add_virtual_extension_targets(g.num_wires())
        pi = b.add_virtual_extension_targets(4)
        out = g.eval_unfiltered(ops.CircuitOps(b), ops.EvaluationVars([], wires, pi))
        return [wires, pi], out

    tb, jb, (inputs, got), (_, want) = _both(make)
    targets = _flat(inputs)
    values = _random(len(targets))
    outputs = _witness(tb, jb, got, want, {t.index: v for t, v in zip(targets, values)})
    ext = [tuple(values[i:i + 2]) for i in range(0, len(values), 2)]
    nw = gate.num_wires()
    host = port_gate.eval_unfiltered(tops.HostExtOps(),
                                     tops.EvaluationVars([], ext[:nw], ext[nw:]))
    assert [tuple(outputs[i:i + 2]) for i in range(0, len(outputs), 2)] == host


def test_generators_equal_reference(no_commitment):
    """exp_from_bits (25 bits, padded to the gate's 66) and a PoseidonMdsGate
    row fed from virtual targets: the same builder state, and the outputs
    of both generators from seeded inputs equal the reference's on the
    port's native plan and on its Python engine."""
    from plonky2_torch.gates.poseidon_mds import PoseidonMdsGate as TMds

    def make(b, ops):
        base = b.add_virtual_target()
        bits = [b.add_virtual_bool_target_safe() for _ in range(25)]
        power = b.exp_from_bits(base, bits)
        mds = TMds() if ops is tops else PoseidonMdsGate()
        row = b.add_gate(mds, [])
        inputs = b.add_virtual_targets(24)
        wire = type(power)
        for i, t in enumerate(inputs):
            b.connect(t, wire(row, i))
        outputs = [wire(row, 24 + i) for i in range(24)]
        return [base, bits, inputs], [power] + outputs

    tb, jb, (inputs, got), (_, want) = _both(make)
    targets = _flat(inputs)
    values = _random(len(targets))
    values[1:26] = _random(25, SEED + 1, 2)
    assigned = {t.index: v for t, v in zip(targets, values)}
    out = _witness(tb, jb, got, want, assigned)
    e = sum(b << i for i, b in enumerate(values[1:26]))
    assert out[0] == fs.exp(values[0], e)
    data = tb.build(device="cpu")
    pw = tw.PartialWitness()
    for i, v in assigned.items():
        pw.set_target(VirtualTarget(i), int(v))
    for engine in ("native", "python"):
        port = tgen.generate_partial_witness(pw, data.prover_only, data.common, engine)
        assert [port.get_target(t) for t in got] == out, engine
    tgen.generate_partial_witness(pw, data.prover_only, data.common, "native")
    plan = data.prover_only.cache("host")["last_plan"]
    assert "ExponentiationGenerator" not in plan.fallbacks  # the native opcode ran it


def test_gate_and_generator_tags_round_trip_to_the_reference_bytes():
    """Gate tags 5 (with its num_power_bits) and 10 (no payload), and
    generator tags 8 (row, num_power_bits) and 16 (row)."""
    gates = [ExponentiationGate(66), ExponentiationGate(7), PoseidonMdsGate()]
    jw_ = jcs.CircuitWriter()
    for g in gates:
        jw_.write_gate(g, None)
    tw_ = tps.CircuitWriter()
    for g in gates:
        tw_.write_gate(convert.gate_from_reference(g))
    assert bytes(tw_.buf) == bytes(jw_.buf)
    assert [int.from_bytes(bytes(jw_.buf)[0:4], "little")] == [5]
    r = tps.Reader(bytes(jw_.buf))
    assert [r.gate().id() for _ in gates] == [g.id() for g in gates]
    r.finish()

    gens = [ExponentiationGenerator(17, 66), PoseidonMdsGenerator(3),
            ExponentiationGenerator(2, 5)]
    jpw = jps.ProverWriter()
    for g in gens:
        jps.write_generator(jpw, g, None)
    tpw = tps.ProverWriter()
    port_gens = [tps.GENERATOR_TAGS[8][1](tps.Reader(np.asarray([17, 66], "<u8").tobytes())),
                 tps.GENERATOR_TAGS[16][1](tps.Reader(np.asarray([3], "<u8").tobytes())),
                 tps.GENERATOR_TAGS[8][1](tps.Reader(np.asarray([2, 5], "<u8").tobytes()))]
    for g in port_gens:
        tps.write_generator(tpw, g)
    assert bytes(tpw.buf) == bytes(jpw.buf)
    r = tps.Reader(bytes(jpw.buf))
    read = [r.generator() for _ in gens]
    r.finish()
    assert [_norm(g) for g in read] == [_norm(g) for g in gens]
    registry = tps.default_registry()
    assert registry[8].__name__ == "ExponentiationGenerator"
    assert registry[16].__name__ == "PoseidonMdsGenerator"


def test_recursion_circuit_over_a_2_18_inner_circuit_equals_reference(no_commitment):
    """The in-circuit verifier of a proof of the bench_recursion inner
    circuit at degree 2^18 (28 queries of 21 bits): the reference's gates
    (28 ExponentiationGate rows among them), copy constraints and
    generators."""
    blob = open(os.path.join(ROOT, "plonky2_torch", "data", "inner18.verifier.bin"),
                "rb").read()
    _, t_common = verifier_data_from_bytes(blob)
    _, j_common = jcs.verifier_data_from_bytes(blob)
    assert t_common.degree_bits == 18

    def make(b, ops):
        rv, common = (trv, t_common) if ops is tops else (jrv, j_common)
        pt = rv.add_virtual_proof_with_pis(b, common)
        vdt = rv.add_virtual_verifier_data(b, common.config.fri_config.cap_height)
        rv.verify_proof(b, pt, vdt, common)
        b.register_public_inputs(pt.public_inputs)
        return []

    tb, _, _, _ = _both(make)  # the builder states are equal
    ids = [gi.gate.id() for gi in tb.gate_instances]
    exp_rows = [i for i, g in enumerate(ids) if g.startswith("ExponentiationGate")]
    assert len(exp_rows) == 28
    assert {ids[i] for i in exp_rows} == {"ExponentiationGate { num_power_bits: 66 }<D=2>"}
    assert sum(type(g).__name__ == "ExponentiationGenerator" for g in tb.generators) == 0
