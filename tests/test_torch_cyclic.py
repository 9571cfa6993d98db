"""The port's conditional and cyclic recursion against the reference, on the CPU.

The same calls on a port builder and on a reference builder leave the same
builder state (gate rows and constants, copy constraints, generators,
constants, open op slots, virtual-target count) and return the same
targets: each new builder method and the inverse and equality gadgets
(whose witness values then equal the reference's), the conditional
verifiers of `tests/test_conditional_cyclic.py` over factorial's common
data, and the IVC hash chain's cyclic circuit over the fixpoint of
`tests/validation_cyclic.py` (`plonky2_torch/data/cyclic_fixpoint.verifier.bin`).
Those builds commit nothing (`no_commitment`), and both packages' dummy
proofs are the same committed reference proof, so that neither proves
there. The Inverse and Equality generators' `run_once` and `run_batch`
equal the reference's. The port's dummy circuit over factorial's common
data has the reference's verifier bytes and proof bytes
(`plonky2_torch/data/dummy_factorial.*.bin`, written by
`tests/torch_make_data.py --cyclic`). Inputs are drawn with numpy from the
seed 2026; every comparison is exact.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from plonky2_tpu.gadgets import inverse as jinv
from plonky2_tpu.iop import generator as jgen
from plonky2_tpu.iop import target as jt
from plonky2_tpu.iop import witness as jw
from plonky2_tpu.plonk import circuit_builder as jcb
from plonky2_tpu.plonk import circuit_serialization as jcs
from plonky2_tpu.plonk import serialization as jser
from plonky2_tpu.recursion import conditional_recursive_verifier as jcrv
from plonky2_tpu.recursion import cyclic_recursion as jcyc
from plonky2_tpu.recursion import dummy_circuit as jdc
from plonky2_tpu.recursion import recursive_verifier as jrv
from plonky2_tpu.util import rng as jrng
from plonky2_torch.examples import cyclic_recursion as ivc
from plonky2_torch.field import scalar as fs
from plonky2_torch.gadgets import inverse as tinv
from plonky2_torch.iop import generator as tgen
from plonky2_torch.iop import target as tt
from plonky2_torch.iop import witness as tw
from plonky2_torch.plonk import circuit_builder as tcb
from plonky2_torch.plonk import circuit_serialization as tcs
from plonky2_torch.plonk import serialization as tser
from plonky2_torch.plonk.circuit_serialization import (
    verifier_data_from_bytes,
    verifier_data_to_bytes,
)
from plonky2_torch.plonk.prover_serialization import read_prover_data
from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
from plonky2_torch.recursion import conditional_recursive_verifier as tcrv
from plonky2_torch.recursion import cyclic_recursion as tcyc
from plonky2_torch.recursion import dummy_circuit as tdc
from plonky2_torch.recursion import recursive_verifier as trv
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_recursion import (  # noqa: E402,F401  (no_commitment is a fixture)
    CONFIG,
    J_CONFIG,
    _flat,
    _norm,
    _random,
    _witness,
    no_commitment,
)
from test_torch_witness import _run  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "plonky2_torch", "data")
SEED = 2026


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


class _Recorder:
    """A GeneratedValues stand-in: the (target, value) pairs written."""

    def __init__(self):
        self.written = []

    def set_target(self, t, v):
        self.written.append((_norm(t), int(v)))


def _gen(g):
    """A package-neutral form of a generator. A DummyProofGenerator's is
    what it writes, its outputs and its verifier data."""
    if type(g).__name__ == "DummyProofGenerator":
        rec = _Recorder()
        g.run_once(None, rec)
        vo = g.verifier_only
        return ("DummyProofGenerator", tuple(rec.written), _norm(g.outputs()),
                _norm(vo.constants_sigmas_cap), _norm(vo.circuit_digest))
    return (type(g).__name__, _norm(g))


def _state(b) -> dict:
    return {"gates": [(gi.gate.id(), [int(c) for c in gi.constants]) for gi in b.gate_instances],
            "copy_constraints": _norm(b.copy_constraints),
            "generators": [_gen(g) for g in b.generators],
            "constants": sorted((int(c), _norm(t)) for c, t in b.constants_to_targets.items()),
            "slots": {k: dict(v) for k, v in b.current_slots.items() if v},
            "public_inputs": _norm(b.public_inputs),
            "virtual_target_index": b.virtual_target_index}


def _common(c) -> tuple:
    """A package-neutral form of a CommonCircuitData."""
    return (c.config.num_wires, c.fri_params.degree_bits, [g.id() for g in c.gates],
            _norm(c.selectors_info.selector_indices), [tuple(r) for r in c.selectors_info.groups],
            c.quotient_degree_factor, c.num_gate_constraints, c.num_constants,
            c.num_public_inputs, _norm(c.k_is), c.num_partial_products)


def _both(make):
    """`make(builder, package)` ("port" or "ref") on a port and a reference
    builder: the same builder state and the same returned targets."""
    tb, jb = tcb.CircuitBuilder(CONFIG), jcb.CircuitBuilder(J_CONFIG)
    got, want = make(tb, "port"), make(jb, "ref")
    assert _state(tb) == _state(jb)
    assert _norm(got) == _norm(want)
    return tb, jb, got, want


# -- the builder surface and the gadgets ----------------------------------------------
# Each returns (its input targets, its outputs).

def _bool_safe(b, pkg):
    return [], b.add_virtual_bool_target_safe()


def _bool_unsafe(b, pkg):
    return [], b.add_virtual_bool_target_unsafe()


def _public_input(b, pkg):
    x = b.add_virtual_target()
    b.register_public_input(x)
    return [x], [b.add_virtual_public_input(), b.num_public_inputs()]


def _public_input_arr(b, pkg):
    return [], [b.add_virtual_public_input_arr(5), b.num_public_inputs()]


def _connect_hashes(b, pkg):
    h0, h1 = b.add_virtual_hash(), b.add_virtual_hash()
    b.connect_hashes(h0, h1)
    return [h0], h1


def _select(b, pkg):
    cond = b.add_virtual_bool_target_safe()
    x, y = b.add_virtual_targets(2)
    return [cond.target, x, y], [b.select(cond, x, y), b.select(cond, y, b.one())]


def _select_hash(b, pkg):
    cond = b.add_virtual_bool_target_safe()
    h0, h1 = b.add_virtual_hash(), b.add_virtual_hash()
    return [cond.target, h0, h1], b.select_hash(cond, h0, h1)


def _select_ext(b, pkg):
    cond = b.add_virtual_bool_target_safe()
    x, y = b.add_virtual_extension_targets(2)
    return [cond.target, x, y], b.select_ext(cond, x, y)


def _is_equal(b, pkg):
    xs = b.add_virtual_targets(6)
    ys = b.add_virtual_targets(6)
    return [xs, ys], [b.is_equal(x, y).target for x, y in zip(xs, ys)]


def _add_inverse(b, pkg):
    xs = b.add_virtual_targets(9)
    return [xs], [(tinv if pkg == "port" else jinv).add_inverse(b, x) for x in xs]


def _equal_pairs(n: int) -> list[int]:
    """n // 2 values of x, then as many of y: pairs equal, pairs with x = 0,
    y = 0 or both, and random pairs."""
    half = n // 2
    x, y = _random(half), _random(half, SEED + 1)
    for i in range(0, half, 3):
        y[i] = x[i]
    x[1] = 0
    y[2] = 0
    x[4] = y[4] = 0
    return x + y


# name: (make, the witness's inputs from their count or None)
BUILDER = {
    "add_virtual_bool_target_safe": (_bool_safe, None),
    "add_virtual_bool_target_unsafe": (_bool_unsafe, None),
    "add_virtual_public_input": (_public_input, None),
    "add_virtual_public_input_arr": (_public_input_arr, None),
    "connect_hashes": (_connect_hashes, None),
    "select": (_select, lambda n: [1] + _random(n - 1)),
    "select_false": (_select, lambda n: [0] + _random(n - 1)),
    "select_hash": (_select_hash, lambda n: [1] + _random(n - 1)),
    "select_ext": (_select_ext, lambda n: [0] + _random(n - 1)),
    "is_equal": (_is_equal, _equal_pairs),
    "add_inverse": (_add_inverse, lambda n: _random(n)),
}


@pytest.mark.parametrize("name", sorted(BUILDER))
def test_builder_method_equals_reference(name, no_commitment):
    """The reference's builder state and targets; where inputs are given,
    both circuits built and their witnesses equal (~0.1 s each)."""
    make, inputs = BUILDER[name]
    tb, jb, (targets, got), (_, want) = _both(make)
    if inputs is None:
        return
    targets = _flat(targets)
    values = _witness(tb, jb, got, want, {t.index: v for t, v in
                                          zip(targets, inputs(len(targets)))})
    if name == "is_equal":
        pairs = _equal_pairs(12)
        assert values == [int(a == b) for a, b in zip(pairs[:6], pairs[6:])]


# -- the Inverse and Equality generators -----------------------------------------------

def _gens(kind, T, G):
    """Ten generators of `kind` over fresh virtual targets: the inputs
    first, then the outputs."""
    if kind == "InverseGenerator":
        return [G.InverseGenerator(T.VirtualTarget(i), T.VirtualTarget(10 + i))
                for i in range(10)]
    return [G.EqualityGenerator(T.VirtualTarget(i), T.VirtualTarget(10 + i),
                                T.VirtualTarget(20 + i), T.VirtualTarget(30 + i))
            for i in range(10)]


@pytest.mark.parametrize("kind", ["InverseGenerator", "EqualityGenerator"])
def test_generator_equals_reference(kind):
    """run_once and run_batch on seeded inputs (x = y, x = 0 and y = 0
    among them, x nonzero for the inverse) against the reference's
    run_once and run_batch (~0.1 s)."""
    t_gens, j_gens = _gens(kind, tt, tinv), _gens(kind, jt, jinv)
    pairs = _equal_pairs(20)
    if kind == "InverseGenerator":
        vals = {("VirtualTarget", i): v or 1 for i, v in enumerate(pairs[:10])}
    else:
        vals = {("VirtualTarget", i): v for i, v in enumerate(pairs)}
    want = _run(kind, j_gens, jt, jw, jgen, vals, 40, batch=False)
    assert want[1].sum() == len(vals) + 10 * (1 if kind == "InverseGenerator" else 2)
    assert np.array_equal(_run(kind, j_gens, jt, jw, jgen, vals, 40, batch=True)[0], want[0])
    for batch in (False, True):
        got = _run(kind, t_gens, tt, tw, tgen, vals, 40, batch)
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0]), batch
    if kind == "EqualityGenerator":  # virtual target i is slot 8 · 135 + i
        eq = want[0][8 * 135 + 20:8 * 135 + 30]
        assert eq.tolist() == [int(a == b) for a, b in zip(pairs[:10], pairs[10:])]


def test_inverse_of_zero_raises():
    gens = _gens("InverseGenerator", tt, tinv)
    vals = {("VirtualTarget", i): (0 if i == 3 else i + 1) for i in range(10)}
    with pytest.raises(ZeroDivisionError):
        _run("InverseGenerator", gens, tt, tw, tgen, vals, 40, batch=True)


# -- the dummy circuit over factorial's common data -----------------------------------

@pytest.fixture(scope="module")
def factorial_common():
    return read_prover_data(_read("factorial.prover.bin"))[1]


def test_dummy_circuit_equals_reference(factorial_common):
    """Built and proved on the CPU (~8 s): the reference's verifier bytes
    and, under seed 2026 with public input 0 = 42, its proof bytes; the
    port's verifier accepts the proof."""
    circuit = tdc.dummy_circuit(factorial_common, device="cpu")
    assert circuit.common == factorial_common
    assert verifier_data_to_bytes(circuit.verifier_only, circuit.common) == _read(
        "dummy_factorial.verifier.bin")
    trng.seed(SEED)
    try:
        proof = tdc.dummy_proof(circuit, {0: 42}, device="cpu")
    finally:
        trng.seed(None)
    assert proof.public_inputs[0] == 42 and not any(proof.public_inputs[1:])
    assert proof_to_bytes(proof) == _read("dummy_factorial.proof.bin")
    circuit.verify(proof)


def test_dummy_circuit_refuses_another_shape(factorial_common):
    """A common data that no circuit of its gates has (one constant too
    many) is refused."""
    common = dataclasses.replace(factorial_common,
                                 num_constants=factorial_common.num_constants + 1)
    with pytest.raises(ValueError, match="not the one asked for"):
        tdc.dummy_circuit(common, device="cpu")


# -- the conditional verifiers and the cyclic circuit ----------------------------------

def _dummy_both(monkeypatch, verifier_name: str, proof_name: str):
    """Both packages' dummy_proof_and_vk take the committed dummy circuit's
    verifier data and proof instead of building and proving one."""
    blob, proof_blob = _read(verifier_name), _read(proof_name)
    t_vo, t_common = verifier_data_from_bytes(blob)
    j_vo, j_common = jcs.verifier_data_from_bytes(blob)
    t_proof = proof_from_bytes(proof_blob, t_common)
    j_proof = jser.proof_from_bytes(proof_blob, j_common)
    for mod, vo, common, proof in ((tdc, t_vo, t_common, t_proof),
                                   (jdc, j_vo, j_common, j_proof)):
        circuit = dataclasses.make_dataclass("Dummy", ["verifier_only", "common"])(vo, common)
        monkeypatch.setattr(mod, "dummy_circuit", lambda *a, c=circuit, **k: c)
        monkeypatch.setattr(mod, "dummy_proof", lambda *a, p=proof, **k: p)
    return t_common, j_common


def _inner(name: str):
    blob = _read(name) if name.startswith("cyclic") else open(
        os.path.join(ROOT, "fixtures", name), "rb").read()
    return verifier_data_from_bytes(blob)[1], jcs.verifier_data_from_bytes(blob)[1]


def test_conditionally_verify_proof_equals_reference(no_commitment):
    """Two proofs of factorial's shape, one selected and verified, its
    first public input exposed (~4 s)."""
    t_common, j_common = _inner("factorial.verifier.bin")

    def make(b, pkg):
        common, rv, crv = ((t_common, trv, tcrv) if pkg == "port" else (j_common, jrv, jcrv))
        cap_h = common.config.fri_config.cap_height
        cond = b.add_virtual_bool_target_safe()
        pt_a = rv.add_virtual_proof_with_pis(b, common)
        vdt_a = rv.add_virtual_verifier_data(b, cap_h)
        pt_b = rv.add_virtual_proof_with_pis(b, common)
        vdt_b = rv.add_virtual_verifier_data(b, cap_h)
        crv.conditionally_verify_proof(b, cond, pt_a, vdt_a, pt_b, vdt_b, common)
        sel = b.select(cond, pt_a.public_inputs[0], pt_b.public_inputs[0])
        b.register_public_input(sel)
        return cond, sel

    _both(make)


def test_conditionally_verify_proof_or_dummy_equals_reference(no_commitment, monkeypatch):
    """A proof of factorial's shape or the dummy proof, the committed
    dummy circuit's generator included; then the witness from
    `fixtures/factorial.proof.bin` with the condition false (the dummy
    verified): the port's native plan (the DummyProofGenerator in Python
    between its segments, the boolean input's cycle broken by the schedule
    given the inputs) against the reference's worklist (~15 s)."""
    _dummy_both(monkeypatch, "dummy_factorial.verifier.bin", "dummy_factorial.proof.bin")
    t_common, j_common = _inner("factorial.verifier.bin")

    def make(b, pkg):
        common, rv, crv = ((t_common, trv, tcrv) if pkg == "port" else (j_common, jrv, jcrv))
        cond = b.add_virtual_bool_target_safe()
        pt = rv.add_virtual_proof_with_pis(b, common)
        vdt = rv.add_virtual_verifier_data(b, common.config.fri_config.cap_height)
        if pkg == "port":
            crv.conditionally_verify_proof_or_dummy(b, cond, pt, vdt, common, device="cpu")
        else:
            crv.conditionally_verify_proof_or_dummy(b, cond, pt, vdt, common)
        return cond, pt, vdt

    tb, jb, got, want = _both(make)
    assert sum(type(g).__name__ == "DummyProofGenerator" for g in tb.generators) == 1
    data, j_data = tb.build(device="cpu"), jb.build()
    assert _common(data.common) == _common(j_data.common)

    blob, vd_blob = (open(os.path.join(ROOT, "fixtures", f"factorial.{k}.bin"), "rb").read()
                     for k in ("proof", "verifier"))
    witnesses = []
    for (cond, pt, vdt), d, ser, cs, rv, W, G, rng in (
            (got, data, tser, tcs, trv, tw, tgen, trng),
            (want, j_data, jser, jcs, jrv, jw, jgen, jrng)):
        vo, common = cs.verifier_data_from_bytes(vd_blob)
        pw = W.PartialWitness()
        pw.set_bool_target(cond, False)
        rv.set_proof_with_pis_target(pw, pt, ser.proof_from_bytes(blob, common))
        rv.set_verifier_data_target(pw, vdt, vo)
        rng.seed(SEED)
        try:
            witnesses.append(G.generate_partial_witness(pw, d.prover_only, d.common)
                             .full_witness())
        finally:
            rng.seed(None)
    assert data.prover_only.cache("host")["last_plan"].fallbacks == {"DummyProofGenerator": 1}
    assert np.array_equal(witnesses[0], witnesses[1])


def test_dummy_proof_generator_on_each_engine(no_commitment, monkeypatch):
    """A circuit of the dummy proof's targets alone, exposing its public
    inputs: the same witness on the native plan, the Python engine and the
    worklist, and the reference's; each writes the dummy proof's values
    into its targets (~2 s)."""
    _dummy_both(monkeypatch, "dummy_factorial.verifier.bin", "dummy_factorial.proof.bin")
    t_common, j_common = _inner("factorial.verifier.bin")

    def make(b, pkg):
        if pkg == "port":
            pt, vdt = tdc.dummy_proof_and_vk(b, t_common, device="cpu")
        else:
            pt, vdt = jdc.dummy_proof_and_vk(b, j_common)
        b.register_public_inputs(pt.public_inputs + vdt.circuit_digest)
        return pt, vdt

    tb, jb, _, _ = _both(make)
    data, j_data = tb.build(device="cpu"), jb.build()
    witnesses = []
    for run, rng in ((lambda e: tgen.generate_partial_witness(tw.PartialWitness(),
                                                              data.prover_only, data.common,
                                                              engine=e), trng),
                     (lambda e: jgen.generate_partial_witness(jw.PartialWitness(),
                                                              j_data.prover_only,
                                                              j_data.common), jrng)):
        for engine in (("native", "python", "worklist") if rng is trng else (None,)):
            rng.seed(SEED)
            try:
                if engine == "worklist":
                    w = tw.PartitionWitness(data.prover_only.representative_map, 135,
                                            data.common.degree)
                    tgen._run_worklist(w, data.prover_only, data.prover_only.generators)
                else:
                    w = run(engine)
            finally:
                rng.seed(None)
            witnesses.append(w.full_witness())
            if engine == "native":
                assert data.prover_only.cache("host")["last_plan"].fallbacks == {
                    "DummyProofGenerator": 1}
    assert all(np.array_equal(witnesses[0], w) for w in witnesses[1:])
    proof = proof_from_bytes(_read("dummy_factorial.proof.bin"), t_common)
    gen = next(g for g in data.prover_only.generators
               if type(g).__name__ == "DummyProofGenerator")
    part = tgen.generate_partial_witness(tw.PartialWitness(), data.prover_only, data.common)
    assert part.get_targets(gen.proof_with_pis_target.public_inputs) == proof.public_inputs
    assert part.get_targets(gen.outputs()) == gen._recorded().values


def _reference_cyclic(b, common_data):
    """tests/validation_cyclic.py's circuit on a reference builder."""
    one = b.one()
    initial_hash = b.add_virtual_hash()
    b.register_public_inputs(initial_hash)
    current_hash_in = b.add_virtual_hash()
    b.register_public_inputs(b.hash_n_to_hash_no_pad(list(current_hash_in)))
    counter = b.add_virtual_public_input()
    vdt = jcyc.add_verifier_data_public_inputs(b)
    common_data.num_public_inputs = b.num_public_inputs()
    condition = b.add_virtual_bool_target_safe()
    inner = jrv.add_virtual_proof_with_pis(b, common_data)
    inner_pis = inner.public_inputs
    b.connect_hashes(initial_hash, inner_pis[0:4])
    b.connect_hashes(current_hash_in, b.select_hash(condition, inner_pis[4:8], initial_hash))
    b.connect(counter, b.mul_add(condition.target, inner_pis[8], one))
    jcyc.conditionally_verify_cyclic_proof_or_dummy(b, condition, inner, common_data)
    return condition, inner, vdt


def test_cyclic_circuit_equals_reference(no_commitment, monkeypatch):
    """The hash chain's cyclic circuit over the committed fixpoint, made by
    `examples/cyclic_recursion.py` and by the reference's flow: the same
    builder state when the port's build starts (gate rows, copy
    constraints, the generators with the DummyProofGenerator's writes,
    constants, public inputs) and the same returned targets; the port's
    build then meets the goal common data (~7 s)."""
    t_fix, j_fix = _inner("cyclic_fixpoint.verifier.bin")
    assert (t_fix.degree_bits, len(t_fix.gates), t_fix.num_public_inputs) == (13, 12, 0)
    _dummy_both(monkeypatch, "cyclic_dummy.verifier.bin", "cyclic_dummy.proof.bin")
    states = []
    build = tcb.CircuitBuilder.build

    def keep(self, *a, **k):
        states.append(_state(self))
        return build(self, *a, **k)

    monkeypatch.setattr(tcb.CircuitBuilder, "build", keep)
    circuit = ivc.cyclic_circuit(t_fix, device="cpu")
    jb = jcb.CircuitBuilder(J_CONFIG)
    cond, inner, vdt = _reference_cyclic(jb, j_fix)
    assert len(states) == 1 and states[0] == _state(jb)
    assert _norm([circuit.condition, circuit.inner.public_inputs, circuit.verifier_data]) == \
        _norm([cond, inner.public_inputs, vdt])
    data = circuit.data
    assert data.common == t_fix and t_fix.num_public_inputs == j_fix.num_public_inputs == 77
    assert data.common.degree_bits == 13 and len(data.common.gates) == 12
    assert len(data.prover_only.generators) == 65821


# -- the verifier data in the public inputs --------------------------------------------

@pytest.fixture(scope="module")
def cyclic_proofs():
    """The committed dummy proof over the fixpoint, its key-carrying tail
    set to the dummy circuit's own verifier data, in both packages."""
    blob, proof_blob = _read("cyclic_dummy.verifier.bin"), _read("cyclic_dummy.proof.bin")
    out = []
    for read_vd, read_proof in ((verifier_data_from_bytes, proof_from_bytes),
                                (jcs.verifier_data_from_bytes, jser.proof_from_bytes)):
        vo, common = read_vd(blob)
        proof = read_proof(proof_blob, common)
        key = list(vo.circuit_digest) + [v for h in vo.constants_sigmas_cap for v in h]
        pis = list(proof.public_inputs[:-len(key)]) + key
        out.append((dataclasses.replace(proof, public_inputs=pis), vo, common))
    return out


@pytest.mark.parametrize("tamper", [None, "digest", "cap"])
def test_check_cyclic_proof_verifier_data(cyclic_proofs, tamper):
    """The key in the tail is accepted; a wrong digest element or cap
    element raises, in both packages alike."""
    outcomes = []
    for (proof, vo, common), cyc in zip(cyclic_proofs, (tcyc, jcyc)):
        digest, cap = cyc.verifier_data_from_slice(proof.public_inputs, common)
        assert [int(v) for v in digest] == list(vo.circuit_digest)
        assert [[int(v) for v in h] for h in cap] == [list(h) for h in vo.constants_sigmas_cap]
        pis = list(proof.public_inputs)
        if tamper == "digest":
            pis[-4 - 4 * 16 + 2] = fs.add(pis[-4 - 4 * 16 + 2], 1)
        elif tamper == "cap":
            pis[-4 * 7 + 1] = fs.add(pis[-4 * 7 + 1], 1)
        try:
            cyc.check_cyclic_proof_verifier_data(dataclasses.replace(proof, public_inputs=pis),
                                                 vo, common)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (tamper is None)


def test_verifier_data_from_slice_on_targets(cyclic_proofs):
    """On targets, and on too few public inputs (which both refuse)."""
    _, _, common = cyclic_proofs[0]
    ts = [tt.VirtualTarget(i) for i in range(77)]
    js = [jt.VirtualTarget(i) for i in range(77)]
    assert _norm(tcyc.verifier_data_from_slice(ts, common)) == _norm(
        jcyc.verifier_data_from_slice(js, cyclic_proofs[1][2]))
    with pytest.raises(ValueError):
        tcyc.verifier_data_from_slice(ts[:67], common)
    with pytest.raises(AssertionError):
        jcyc.verifier_data_from_slice(js[:67], cyclic_proofs[1][2])


def test_add_verifier_data_public_inputs_once(no_commitment):
    def make(b, pkg):
        cyc = tcyc if pkg == "port" else jcyc
        b.add_virtual_public_input()
        return cyc.add_verifier_data_public_inputs(b)

    tb, _, vd, _ = _both(make)
    assert tb.verifier_data_public_input is vd and len(tb.public_inputs) == 69
    with pytest.raises(ValueError):
        tcyc.add_verifier_data_public_inputs(tb)


# -- no fallback --------------------------------------------------------------------------

def test_cyclic_entry_points_without_a_device_need_cuda(factorial_common):
    """The chain, the dummy circuit and its proofs run on the card unless
    the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivc.chain(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdc.dummy_circuit(factorial_common)
    circuit = tdc.dummy_circuit(factorial_common, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdc.dummy_proof(circuit)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdc.cyclic_base_proof(factorial_common, circuit.verifier_only)
