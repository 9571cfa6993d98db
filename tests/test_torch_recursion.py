"""The port's in-circuit verifier against the reference package, on the CPU.

The same gadget calls on a port builder and on a reference builder leave
the same builder state: the gate rows and their constants, the copy
constraints, the generators, the constants' targets, the open op slots
and the virtual-target count. That holds for every gate of the middle
circuit on `CircuitOps` (whose outputs' witness values then equal
`HostExtOps`'s evaluation), the recursive challenger (whose challenges'
witness values equal the host `Challenger`'s) and each gadget of the
recursive verifier (whose witness values equal the reference's). The
builds here commit nothing: the constants-sigmas commitment is replaced
by its coefficients. The middle circuit the port builds over
`bench_cache/inner14.verifier.bin` equals `bench_cache/middle14.circuit.bin`
but for its cap and digest, and its witness from the inner proof is the
reference's. Inputs are drawn with numpy from the seed 2026; every
comparison is exact.
"""

import hashlib
import os
import sys
import types

import numpy as np
import pytest
import torch

from plonky2_tpu.gates import ops as jops
from plonky2_tpu.iop import generator as jgen
from plonky2_tpu.iop import witness as jw
from plonky2_tpu.iop.target import VirtualTarget as JVirtualTarget
from plonky2_tpu.plonk import circuit_builder as jcb
from plonky2_tpu.plonk.config import CircuitConfig as JConfig
from plonky2_tpu.recursion.recursive_challenger import RecursiveChallenger as JChallenger
from plonky2_torch import convert
from plonky2_torch.examples import bench_recursion
from plonky2_torch.field import goldilocks as gl
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri import oracle
from plonky2_torch.gadgets import reducing as tred
from plonky2_torch.gates import ops as tops
from plonky2_torch.hash import merkle
from plonky2_torch.iop import generator as tgen
from plonky2_torch.iop import witness as tw
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.iop.target import VirtualTarget
from plonky2_torch.plonk import circuit_builder as tcb
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.plonk.prover_serialization import read_circuit_data
from plonky2_torch.plonk.serialization import proof_from_bytes
from plonky2_torch.recursion.recursive_challenger import RecursiveChallenger
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_builder import GATES  # noqa: E402
from test_torch_plonk import _norm as _norm_fields  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026
CONFIG = CircuitConfig.standard_recursion_config()
J_CONFIG = JConfig.standard_recursion_config()
# the full witness of the middle circuit from bench_cache/inner14.proof.bin
# under seed 2026 (tests/reference_prove_middle.py, the reference's)
HEADLINE_WITNESS_SHA256 = "078753bd98bdd5a12f0b0e27d62eaa1639b66a6c532cb152cb51ff663b98ca1d"


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


@pytest.fixture
def no_commitment(monkeypatch):
    """Both builders commit to nothing and the cap is zeros; the port's
    keeps the values it was given where its `constants_sigmas_coeffs`
    go."""
    def port_batch(values, rate_bits, blinding, cap_height, device=None, hasher=None):
        return types.SimpleNamespace(polynomials=oracle._as_tensor(values, device),
                                     merkle_tree=types.SimpleNamespace(
                                         cap=[[0] * 4] * (1 << cap_height)))

    def ref_batch(values, rate_bits, blinding, cap_height, hasher=None):
        return types.SimpleNamespace(polynomials=None, merkle_tree=types.SimpleNamespace(
            cap=[[0] * 4] * (1 << cap_height)))

    monkeypatch.setattr(tcb, "PolynomialBatch", types.SimpleNamespace(from_values=port_batch))
    monkeypatch.setattr(jcb, "PolynomialBatch", types.SimpleNamespace(from_values=ref_batch))


def _norm(x):
    """A package-neutral form of targets (bool targets included) and
    generators."""
    if type(x).__name__ == "BoolTarget":
        return ("BoolTarget", _norm(x.target))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    return _norm_fields(x)


def _state(b) -> dict:
    return {"gates": [(gi.gate.id(), [int(c) for c in gi.constants]) for gi in b.gate_instances],
            "copy_constraints": _norm(b.copy_constraints),
            "generators": [(type(g).__name__, _norm(g)) for g in b.generators],
            "constants": sorted((int(c), _norm(t)) for c, t in b.constants_to_targets.items()),
            "slots": {k: dict(v) for k, v in b.current_slots.items() if v},
            "virtual_target_index": b.virtual_target_index}


def _both(make):
    """`make(builder, ops module)` on a port and a reference builder: the
    same builder state and the same returned targets. Returns both
    builders and both results."""
    tb, jb = tcb.CircuitBuilder(CONFIG), jcb.CircuitBuilder(J_CONFIG)
    got, want = make(tb, tops), make(jb, jops)
    assert _state(tb) == _state(jb)
    assert _norm(got) == _norm(want)
    return tb, jb, got, want


def _flat(x) -> list:
    """The base targets of a nest of targets, in order."""
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    if hasattr(x, "parts"):
        return list(x.parts)
    if hasattr(x, "target"):
        return [x.target]
    return [x]


def _witness(tb, jb, got, want, inputs: dict) -> list:
    """Both circuits built (no commitment) and their witnesses generated
    from `inputs` {virtual target index: value}: the port's values of its
    targets `got` equal the reference's of `want`. Returns them."""
    data, jdata = tb.build(device="cpu"), jb.build()
    pw, jpw = tw.PartialWitness(), jw.PartialWitness()
    for i, v in inputs.items():
        pw.set_target(VirtualTarget(i), int(v))
        jpw.set_target(JVirtualTarget(i), int(v))
    port = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    ref = jgen.generate_partial_witness(jpw, jdata.prover_only, jdata.common)
    values = [port.get_target(t) for t in _flat(got)]
    assert values == [ref.get_target(t) for t in _flat(want)]
    return values


def _random(n: int, seed: int = SEED, high: int = fs.P) -> list[int]:
    return [int(v) for v in np.random.default_rng(seed).integers(0, high, size=n,
                                                                  dtype=np.uint64)]


# -- every gate of the middle circuit on CircuitOps ----------------------------------

@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.id()[:40])
def test_circuit_ops_gate_equals_reference(gate, no_commitment):
    """The gate's constraints on CircuitOps over virtual extension targets:
    the reference's circuit, and witness values equal to HostExtOps's
    evaluation on the same random inputs."""
    port_gate = convert.gate_from_reference(gate)

    def make(b, ops):
        g = port_gate if ops is tops else gate
        consts = b.add_virtual_extension_targets(g.num_constants())
        wires = b.add_virtual_extension_targets(g.num_wires())
        pi = b.add_virtual_extension_targets(4)
        out = g.eval_unfiltered(ops.CircuitOps(b), ops.EvaluationVars(consts, wires, pi))
        return [consts, wires, pi], out

    tb, jb, (inputs, got), (_, want) = _both(make)
    targets = _flat(inputs)
    values = _random(len(targets))
    outputs = _witness(tb, jb, got, want, {t.index: v for t, v in zip(targets, values)})
    ext = [tuple(values[i:i + 2]) for i in range(0, len(values), 2)]
    nc, nw = gate.num_constants(), gate.num_wires()
    host = port_gate.eval_unfiltered(tops.HostExtOps(), tops.EvaluationVars(
        ext[:nc], ext[nc:nc + nw], ext[nc + nw:]))
    assert [tuple(outputs[i:i + 2]) for i in range(0, len(outputs), 2)] == host
    assert len(host) == gate.num_constraints()


# -- the recursive challenger ------------------------------------------------------------

def test_recursive_challenger_equals_host_challenger(no_commitment):
    """Elements, a cap and extension elements observed between squeezes:
    the reference's circuit, and challenges equal to the host's."""
    def make(b, ops):
        c = (RecursiveChallenger if ops is tops else JChallenger)(b)
        elems = b.add_virtual_targets(5)
        cap = [b.add_virtual_targets(4) for _ in range(16)]
        exts = b.add_virtual_extension_targets(3)
        c.observe_elements(elems)
        out = [c.get_n_challenges(2)]
        c.observe_cap(cap)
        out.append(c.get_extension_challenge())
        c.observe_extension_elements(exts)
        c.observe_element(elems[0])
        out += [c.get_n_challenges(11), c.get_hash()]
        return [elems, cap, exts], out

    tb, jb, (inputs, got), (_, want) = _both(make)
    targets = _flat(inputs)
    values = _random(len(targets))
    outputs = _witness(tb, jb, got, want, {t.index: v for t, v in zip(targets, values)})
    host = Challenger()
    host.observe_elements(values[:5])
    expect = host.get_n_challenges(2)
    host.observe_cap([values[5 + 4 * i:9 + 4 * i] for i in range(16)])
    expect += list(host.get_extension_challenge())
    host.observe_extension_elements([tuple(values[69 + 2 * i:71 + 2 * i]) for i in range(3)])
    host.observe_element(values[0])
    expect += host.get_n_challenges(11) + host.get_hash()
    assert outputs == expect


# -- the gadgets of the verifier -----------------------------------------------------------
# Each returns (its input targets, its outputs); `bits` inputs come first.

def _bits(b, n):
    """n new bool targets of the builder's own package."""
    return [type(b._false())(t) for t in b.add_virtual_targets(n)]


def _jmodule(name):
    import importlib

    return importlib.import_module(f"plonky2_tpu.gadgets.{name}")


def _gadget_low_bits(b, ops):
    x = b.add_virtual_target()
    return [x], b.low_bits(x, 17, 64)


def _gadget_le_sum(b, ops):
    bits = _bits(b, 5)
    return bits, b.le_sum(bits)


def _gadget_le_sum_base_sum_row(b, ops):
    bits = _bits(b, 30)
    return bits, b.le_sum(bits)


def _gadget_exp_from_bits_const_base(b, ops):
    bits = _bits(b, 17)
    return bits, b.exp_from_bits_const_base(fs.primitive_root_of_unity(17), bits)


def _gadget_exp_power_of_2(b, ops):
    x = b.add_virtual_target()
    return [x], b.exp_power_of_2(x, 4)


def _gadget_assert_leading_zeros(b, ops):
    x = b.add_virtual_target()
    b.assert_leading_zeros(x, 16)
    return [x], [x]


def _gadget_exp_power_of_2_extension(b, ops):
    x = b.add_virtual_extension_target()
    return [x], b.exp_power_of_2_extension(x, 13)


def _gadget_random_access(b, ops):
    index = b.add_virtual_target()
    v = b.add_virtual_targets(16)
    return [index, v], b.random_access(index, v)


def _gadget_random_access_extension(b, ops):
    index = b.add_virtual_target()
    v = b.add_virtual_extension_targets(13)
    return [index, v], b.random_access_extension(index, v)


def _gadget_interpolate_coset(b, ops):
    shift = b.add_virtual_target()
    values = b.add_virtual_extension_targets(16)
    point = b.add_virtual_extension_target()
    gate = convert.gate_from_reference(GATES[-1]) if ops is tops else GATES[-1]
    return [shift, values, point], b.interpolate_coset(type(gate)(4, 8), shift, values, point)


def _gadget_reduce(b, ops):
    alpha = b.add_virtual_extension_target()
    terms = b.add_virtual_extension_targets(40)
    rf = (tred if ops is tops else _jmodule("reducing")).ReducingFactorTarget(alpha)
    long = rf.reduce(terms, b)
    short = rf.reduce(terms[:5], b)
    return [alpha, terms], [long, short, rf.shift(short, b)]


def _gadget_reduce_base(b, ops):
    alpha = b.add_virtual_extension_target()
    terms = b.add_virtual_targets(100)
    rf = (tred if ops is tops else _jmodule("reducing")).ReducingFactorTarget(alpha)
    long = rf.reduce_base(terms, b)
    return [alpha, terms], [long, rf.reduce_base(terms[:7], b), rf.shift(long, b)]


def _gadget_div_extension(b, ops):
    num, den = b.add_virtual_extension_targets(2)
    return [num, den], [b.div_extension(num, den)]


# name: (gadget, its leading inputs below a bound, the bound, the witness
# checked). The reference gives le_sum's BaseSumGate row no generator of its
# sum, so that row is held to the reference's circuit alone.
GADGETS = {
    "low_bits": (_gadget_low_bits, 0, None, True),
    "le_sum": (_gadget_le_sum, 5, 2, True),
    "le_sum_base_sum_row": (_gadget_le_sum_base_sum_row, 30, 2, False),
    "exp_from_bits_const_base": (_gadget_exp_from_bits_const_base, 17, 2, True),
    "exp_power_of_2": (_gadget_exp_power_of_2, 0, None, True),
    "assert_leading_zeros": (_gadget_assert_leading_zeros, 1, 1 << 48, True),
    "exp_power_of_2_extension": (_gadget_exp_power_of_2_extension, 0, None, True),
    "random_access": (_gadget_random_access, 1, 16, True),
    "random_access_extension": (_gadget_random_access_extension, 1, 13, True),
    "interpolate_coset": (_gadget_interpolate_coset, 0, None, True),
    "reduce": (_gadget_reduce, 0, None, True),
    "reduce_base": (_gadget_reduce_base, 0, None, True),
    "div_extension": (_gadget_div_extension, 0, None, True),
}


@pytest.mark.parametrize("name", sorted(GADGETS))
def test_gadget_equals_reference(name, no_commitment):
    make, num_small, bound, with_witness = GADGETS[name]
    tb, jb, (inputs, got), (_, want) = _both(make)
    if not with_witness:
        return
    targets = _flat(inputs)
    values = _random(len(targets))
    values[:num_small] = _random(num_small, SEED + 1, bound)
    _witness(tb, jb, got, want, {t.index: v for t, v in zip(targets, values)})


def test_merkle_proof_gadget_equals_reference(no_commitment):
    """A real path of a 2^6-leaf tree of 7-element leaves under a cap of
    height 2, checked by both circuits on the same witness."""
    leaves = np.random.default_rng(SEED).integers(0, fs.P, size=(64, 7), dtype=np.uint64)
    tree = merkle.MerkleTree(torch.from_numpy(leaves.view(np.int64)), 2)
    index = 45
    leaf, proof = tree.open_many([index])[0]
    merkle.verify_merkle_proof_to_cap(leaf, index, tree.cap, proof)

    def make(b, ops):
        x = b.add_virtual_target()
        leaf_t = b.add_virtual_targets(7)
        cap_t = [b.add_virtual_targets(4) for _ in range(4)]
        sibs = [b.add_virtual_targets(4) for _ in range(4)]
        bits = b.low_bits(x, 6, 64)
        cap_index = b.le_sum(bits[4:])
        b.verify_merkle_proof_to_cap_with_cap_index(leaf_t, bits, cap_index, cap_t,
                                                    types.SimpleNamespace(siblings=sibs))
        return bits

    tb, jb, got, want = _both(make)
    values = [index] + leaf + [v for d in tree.cap for v in d] + [
        v for s in proof.siblings for v in s]
    bits = _witness(tb, jb, got, want, dict(enumerate(values)))
    assert bits == [(index >> i) & 1 for i in range(6)]


# -- the middle circuit at full width -----------------------------------------------------

def test_middle_circuit_equals_the_reference_file(no_commitment):
    """The port's recursion circuit over the 2^14 inner circuit: all of
    bench_cache/middle14.circuit.bin but the cap and the digest (no
    commitment is made here), then its witness from the inner proof."""
    inner_vo, inner_common = verifier_data_from_bytes(_read("bench_cache",
                                                            "inner14.verifier.bin"))
    data, pt, vdt = bench_recursion.recursion_circuit(inner_common, CONFIG, device="cpu")
    want_prover, want_common, _ = read_circuit_data(_read("bench_cache", "middle14.circuit.bin"))
    got_prover, got_common = data.prover_only, data.common
    assert got_common == want_common
    assert (got_common.degree_bits, len(got_common.gates), got_common.num_gate_constraints) == (
        13, 12, 123)
    coeffs = gl.to_numpy(ntt.ifft(gl.tensor(got_prover.constants_sigmas_coeffs, "cpu")))
    assert np.array_equal(coeffs, want_prover.constants_sigmas_coeffs)
    for name in ("sigmas", "subgroup", "representative_map"):
        assert np.array_equal(np.asarray(getattr(got_prover, name)),
                              np.asarray(getattr(want_prover, name))), name
    assert len(got_prover.generators) == len(want_prover.generators) == 8261
    assert [_norm(g) for g in got_prover.generators] == [
        _norm(g) for g in want_prover.generators]
    got_w, want_w = got_prover.generator_indices_by_watches, \
        want_prover.generator_indices_by_watches
    assert sorted(got_w) == sorted(want_w)
    assert all(np.array_equal(got_w[k], want_w[k]) for k in want_w)
    assert _norm(got_prover.public_inputs) == _norm(want_prover.public_inputs)

    inner_proof = proof_from_bytes(_read("bench_cache", "inner14.proof.bin"), inner_common)
    trng.seed(SEED)
    try:
        witness, pis, _ = tp.prepare_witness(
            got_prover, got_common, bench_recursion.recursion_inputs(
                pt, vdt, (inner_proof, inner_vo, inner_common)))
    finally:
        trng.seed(None)
    assert witness.shape == (135, 1 << 13)
    assert hashlib.sha256(np.ascontiguousarray(witness, dtype=np.uint64).tobytes()
                          ).hexdigest() == HEADLINE_WITNESS_SHA256
    assert pis == []


def test_recursion_without_a_device_needs_cuda():
    """No silent fallback: the recursion layer and the chain run on the
    card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    inner_vo, inner_common = verifier_data_from_bytes(_read("plonky2_torch", "data",
                                                            "inner4.verifier.bin"))
    inner = (proof_from_bytes(_read("plonky2_torch", "data", "inner4.proof.bin"), inner_common),
             inner_vo, inner_common)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_recursion.recursive_proof(inner, CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_recursion.chain(4)
