"""The port's PLONK lookups against the reference package, on the CPU.

LookupGate and LookupTableGate (ids, wire layout, generators), the lookup
checks of the vanishing polynomial in their three forms (host ops, the
device form over a [*, Q] batch, the circuit form's gates and witness), the
LUT polynomial on the host, the device and in a circuit, and the device
lookup columns against the reference's host row recurrences, all on inputs
drawn with numpy from the seed 2026. Then whole circuits, against the
reference's bytes in `plonky2_torch/data/lookup*` (written by
`tests/torch_make_data.py --lookups`): the 515-lookup circuit (degree 2^5),
the two-LUT circuit and the one-lookup circuit at 2^6 built to the
reference's verifier bytes and prover data; proofs, prover data and
compressed proofs read and written to the reference's bytes; the witness
on the native plan (fully native) equal to the reference's; and the
in-circuit verifier over the 2^14 lookup inner circuits' common data equal
to the reference's builder state. `tests/test_torch_lookups_prove.py`
proves them. Every comparison is exact.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from plonky2_tpu.gadgets import lookup as jlk
from plonky2_tpu.gates import lookup as jgl
from plonky2_tpu.gates import ops as jops
from plonky2_tpu.gates.simple_gates import NoopGate as JNoop
from plonky2_tpu.iop import generator as jgen
from plonky2_tpu.iop import witness as jw
from plonky2_tpu.plonk import circuit_builder as jcb
from plonky2_tpu.plonk import compressed as jcomp
from plonky2_tpu.plonk import prover as jp
from plonky2_tpu.plonk import serialization as jser
from plonky2_tpu.plonk import vanishing_poly as jvp
from plonky2_tpu.plonk.circuit_serialization import verifier_data_from_bytes as j_vd_from_bytes
from plonky2_tpu.plonk.config import CircuitConfig as JConfig
from plonky2_tpu.recursion import recursive_verifier as jrv
from plonky2_tpu.util import rng as jrng
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.field import scalar as fs
from plonky2_torch.gadgets import lookup as tlk
from plonky2_torch.gates import lookup as tgl
from plonky2_torch.gates import ops as tops
from plonky2_torch.gates.simple_gates import NoopGate
from plonky2_torch.iop import generator as tgen
from plonky2_torch.iop import witness as tw
from plonky2_torch.plonk import circuit_builder as tcb
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk import vanishing_poly as tvp
from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes
from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
from plonky2_torch.plonk.compressed import compress, decompress
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.plonk.prover_serialization import prover_data_to_bytes, read_prover_data
from plonky2_torch.plonk.serialization import (
    compressed_proof_from_bytes,
    compressed_proof_to_bytes,
    proof_from_bytes,
    proof_to_bytes,
)
from plonky2_torch.recursion import recursive_verifier as trv
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from reference_prove_lookups import INITIAL_A  # noqa: E402
from test_torch_recursion import _both, _flat, _random, _witness, no_commitment  # noqa: E402,F401
from torch_make_data import lookup_circuits  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026
Q = 8
CONFIG = CircuitConfig.standard_recursion_config()
J_CONFIG = JConfig.standard_recursion_config()
TEN = [(3 * i + 1, (7 * i) % 11) for i in range(10)]  # a LUT of 10 pairs: not 26's multiple
PROVED = ("lookup515", "lookup_two_tables", "lookup1_6")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(name: str) -> bytes:
    with open(os.path.join(ROOT, "plonky2_torch", "data", name), "rb") as f:
        return f.read()


def _port_circuit(name: str):
    """(builder, lookup input target or None) of a `--lookups` circuit on a
    port builder."""
    return lookup_circuits(tcb.CircuitBuilder, NoopGate, tlk, CONFIG)[name]


@pytest.fixture(scope="module")
def built():
    """name -> (CircuitData, lookup input) of the port's builds on the CPU."""
    out = {}
    for name in PROVED:
        b, initial = _port_circuit(name)
        out[name] = (b.build(device="cpu"), initial)
    return out


# -- the gates ------------------------------------------------------------------------

@pytest.mark.parametrize("lut", [list(zip(range(256), jlk.TIP5_TABLE)), TEN],
                         ids=["tip5", "ten"])
def test_gates_equal_reference(lut):
    """Ids (the LUT's keccak hash in them), slot counts, wire layout and
    every slot's generator outputs."""
    assert tlk.TIP5_TABLE == jlk.TIP5_TABLE and tlk.SMALLER_TABLE == jlk.SMALLER_TABLE
    assert tgl.LookupGate.num_slots_from_config(CONFIG) == 40
    assert tgl.LookupTableGate.num_slots_from_config(CONFIG) == 26
    port, ref = tgl.LookupGate.new_from_table(CONFIG, lut), jgl.LookupGate.new_from_table(
        J_CONFIG, lut)
    assert port.id() == ref.id() and port.num_wires() == ref.num_wires() == 80
    table, jtable = (tgl.LookupTableGate.new_from_table(CONFIG, lut, 7),
                     jgl.LookupTableGate.new_from_table(J_CONFIG, lut, 7))
    assert table.id() == jtable.id() and table.num_wires() == jtable.num_wires() == 78
    for i in range(40):
        assert (tgl.LookupGate.wire_ith_looking_inp(i), tgl.LookupGate.wire_ith_looking_out(i)) \
            == (jgl.LookupGate.wire_ith_looking_inp(i), jgl.LookupGate.wire_ith_looking_out(i))
    for i in range(26):
        assert [f(i) for f in (tgl.LookupTableGate.wire_ith_looked_inp,
                               tgl.LookupTableGate.wire_ith_looked_out,
                               tgl.LookupTableGate.wire_ith_multiplicity)] == [3 * i, 3 * i + 1,
                                                                               3 * i + 2]
    rows = -(-len(lut) // 26)
    for row in range(7, 7 + rows):  # every table slot, padding included
        for gen, jgen_ in zip(table.generators(row, []), jtable.generators(row, [])):
            out, jout = tgen.GeneratedValues(), jgen.GeneratedValues()
            gen.run_once(None, out)
            jgen_.run_once(None, jout)
            assert [(t.row, t.column, v) for t, v in out.target_values] == \
                [(t.row, t.column, v) for t, v in jout.target_values]
    for inp, want in lut[:3] + lut[-2:]:
        gen = port.generators(0, [])[5]
        wit = types.SimpleNamespace(get_target=lambda t, v=inp: v)
        out = tgen.GeneratedValues()
        gen.run_once(wit, out)
        assert out.target_values[0][1] == want
    with pytest.raises(ValueError, match="Incorrect input"):
        port.generators(0, [])[0].run_once(types.SimpleNamespace(get_target=lambda t: 1 << 17),
                                           tgen.GeneratedValues())


# -- the checks, the LUT polynomial and the lookup columns --------------------------------

def _commons():
    """The two-LUT circuit's common data, the port's and the reference's."""
    blob = _data("lookup_two_tables.verifier.bin")
    return verifier_data_from_bytes(blob)[1], j_vd_from_bytes(blob)[1]


def _check_inputs(seed, n):
    """Random wires [135], lookup selectors, this and the next row's
    lookup columns, four draws and two LUT evaluations: n values each."""
    r = np.random.default_rng(seed)
    draw = lambda k: r.integers(0, fs.P, size=(k, n), dtype=np.uint64)  # noqa: E731
    return draw(135), draw(6), draw(7), draw(7), draw(4), draw(2)


def _host_check(vp, ops_mod, common, inputs, col):
    """vp.check_lookup_constraints on HostExtOps at point `col` (values
    lifted to the extension); the draws and LUT evaluations are column 0's,
    one a challenge as the device form takes them."""
    wires, sel, local, nxt, deltas, evals = ([(int(v), 0) for v in a[:, c]]
                                             for a, c in zip(inputs, (col,) * 4 + (0, 0)))
    return vp.check_lookup_constraints(ops_mod.HostExtOps(), common,
                                       ops_mod.EvaluationVars([], wires, []), local, nxt, sel,
                                       deltas, evals)


def test_host_check_equals_reference():
    common, jcommon = _commons()
    values = _random(2 * 161, SEED)
    ext = [tuple(values[i:i + 2]) for i in range(0, len(values), 2)]
    wires, sel, local, nxt, deltas, evals = (ext[:135], ext[135:141], ext[141:148],
                                             ext[148:155], ext[155:159], ext[159:161])
    got = tvp.check_lookup_constraints(tops.HostExtOps(), common, tops.EvaluationVars(
        [], wires, []), local, nxt, sel, deltas, evals)
    want = jvp.check_lookup_constraints(jops.HostExtOps(), jcommon, jops.EvaluationVars(
        [], wires, []), local, nxt, sel, deltas, evals)
    assert got == want and len(got) == 3 + 2 + 1 + 2 * 6


def test_device_check_equals_reference_at_every_point():
    """The [*, Q] form on the CPU against the reference's host form at each
    of the Q points, with every check nonzero somewhere."""
    common, jcommon = _commons()
    inputs = _check_inputs(SEED + 1, Q)
    wires, sel, local, nxt, deltas, evals = (tg.tensor(a, "cpu") for a in inputs)
    got = tg.to_numpy(tvp.check_lookup_constraints_device(common, wires, sel, local, nxt,
                                                          deltas[:, 0], evals[:, 0]))
    assert got.shape == (18, Q)
    for col in range(Q):
        want = _host_check(jvp, jops, jcommon, inputs, col)
        assert [(int(v), 0) for v in got[:, col]] == want
    assert (got != 0).any(axis=1).all()


def test_circuit_check_equals_reference(no_commitment):
    """On CircuitOps: the reference's gates, copy constraints and
    generators, and witness values equal to the host form's."""
    common, jcommon = _commons()

    def make(b, ops):
        c = common if ops is tops else jcommon
        vp = tvp if ops is tops else jvp
        wires = b.add_virtual_extension_targets(80)
        sel, local, nxt = (b.add_virtual_extension_targets(k) for k in (6, 7, 7))
        deltas, evals = b.add_virtual_extension_targets(4), b.add_virtual_extension_targets(2)
        out = vp.check_lookup_constraints(ops.CircuitOps(b), c, ops.EvaluationVars(
            [], wires, []), local, nxt, sel, deltas, evals)
        return [wires, sel, local, nxt, deltas, evals], out

    tb, jb, (inputs, got), (_, want) = _both(make)
    targets = _flat(inputs)
    values = _random(len(targets), SEED + 2)
    outputs = _witness(tb, jb, got, want, {t.index: v for t, v in zip(targets, values)})
    ext = [tuple(values[i:i + 2]) for i in range(0, len(values), 2)]
    host = tvp.check_lookup_constraints(
        tops.HostExtOps(), common, tops.EvaluationVars([], ext[:80], []), ext[86:93],
        ext[93:100], ext[80:86], ext[100:104], ext[104:106])
    assert [tuple(outputs[i:i + 2]) for i in range(0, len(outputs), 2)] == host


@pytest.mark.parametrize("lut", [list(zip(range(256), jlk.TIP5_TABLE)), TEN],
                         ids=["tip5", "ten"])
def test_lut_poly_equals_reference_on_host_device_and_circuit(lut, no_commitment):
    common = types.SimpleNamespace(luts=[lut], config=CONFIG)
    jcommon = types.SimpleNamespace(luts=[lut], config=J_CONFIG)
    deltas = _random(8, SEED + 3)
    n = -(-len(lut) // 26) * 26
    assert tvp.get_lut_poly(common, 0, deltas, n + 3) == jvp.get_lut_poly(jcommon, 0, deltas,
                                                                         n + 3)
    want = [jvp.eval_lut_poly(jcommon, 0, deltas[4 * c:4 * c + 4]) for c in range(2)]
    assert [tvp.eval_lut_poly(common, 0, deltas[4 * c:4 * c + 4]) for c in range(2)] == want
    dev = tvp.lut_evals_device(common, tg.tensor(deltas, "cpu"), "cpu")
    assert [int(v) for v in tg.to_numpy(dev)[:, 0]] == want

    def make(b, ops):
        c, vp = (common, tvp) if ops is tops else (jcommon, jvp)
        d = b.add_virtual_targets(4)
        return d, vp.eval_lut_poly_circuit(b, c, 0, d)

    tb, jb, (d, got), (_, want_t) = _both(make)
    out = _witness(tb, jb, [got], [want_t], {t.index: v for t, v in zip(d, deltas[:4])})
    assert out == want[:1]


@pytest.mark.parametrize("name", ["lookup515", "lookup_two_tables"])
def test_device_lookup_columns_equal_the_reference_host_recurrence(name, built):
    """`lookup_polys_device` (an affine scan and prefix sums over the
    region's rows) and `compute_lookup_polys` bit for bit the reference's
    host recurrence on random deltas; with two LUTs, two regions."""
    data, initial = built[name]
    pw = tw.PartialWitness()
    if initial is not None:
        pw.set_target(initial, INITIAL_A)
    partition = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    tp.set_lookup_wires(data.prover_only, data.common, partition)
    witness = partition.full_witness()
    deltas = _random(8, SEED + 4)
    want = [col for c in range(2) for col in jp.compute_lookup_polys(
        witness, deltas[4 * c:4 * c + 4], data.prover_only, data.common)]
    assert [col for c in range(2) for col in tp.compute_lookup_polys(
        witness, deltas[4 * c:4 * c + 4], data.prover_only, data.common)] == want
    got = tp.lookup_polys_device(tg.tensor(witness, "cpu"), tg.tensor(deltas, "cpu"),
                                 data.prover_only, data.common)
    assert (tg.to_numpy(got) == np.asarray(want, dtype=np.uint64)).all()
    assert len(data.prover_only.lookup_rows) == len(data.common.luts)


# -- whole circuits -----------------------------------------------------------------

@pytest.mark.parametrize("name", PROVED)
def test_builds_equal_reference(name, built):
    data, _ = built[name]
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _data(
        f"{name}.verifier.bin")
    if name != "lookup1_6":
        assert prover_data_to_bytes(data.prover_only, data.common) == _data(
            f"{name}.prover.bin")


def test_515_lookup_circuit_shape(built):
    """The sizes the reference gives: degree 2^5, 7 lookup columns a
    challenge (1 RE, 6 SLDC), 5 lookup selectors, one region: the public
    input gate at row 0, 13 LookupGate rows, 10 table rows."""
    common, prover_only = built["lookup515"][0].common, built["lookup515"][0].prover_only
    assert (common.degree_bits, common.num_lookup_polys, common.num_lookup_selectors) == (5, 7, 5)
    assert [(lw.last_lu_gate, lw.last_lut_gate, lw.first_lut_gate)
            for lw in prover_only.lookup_rows] == [(1, 14, 23)]
    assert common.num_zs_partial_products_polys() + common.num_all_lookup_polys() == 34


@pytest.mark.parametrize("name", ["lookup515", "lookup_two_tables"])
def test_proof_prover_data_and_compressed_proof_round_trip(name):
    """The reference's proof and prover data (LUTs, tags 6 and 7, the two
    lookup generator tags, the lookup rows, lut_to_lookups) read and written
    to their bytes; the port's compressed proof is the reference's and
    decompresses to the proof."""
    vd, pb, prover = (_data(f"{name}.{k}.bin") for k in ("verifier", "proof", "prover"))
    verifier_only, common = verifier_data_from_bytes(vd)
    assert verifier_data_to_bytes(verifier_only, common) == vd
    proof = proof_from_bytes(pb, common)
    assert proof_to_bytes(proof) == pb
    prover_only, pcommon = read_prover_data(prover)
    assert pcommon == common and prover_data_to_bytes(prover_only, pcommon) == prover
    gens = {type(g).__name__ for g in prover_only.generators}
    assert {"LookupGenerator", "LookupTableGenerator"} <= gens
    ids = [g.id() for g in common.gates]
    assert any(i.startswith("LookupGate") for i in ids)
    assert any(i.startswith("LookupTableGate") for i in ids)

    j_vo, j_common = j_vd_from_bytes(vd)
    want = jser.compressed_proof_to_bytes(
        jcomp.compress(jser.proof_from_bytes(pb, j_common), j_vo, j_common), j_common)
    got = compressed_proof_to_bytes(compress(proof, verifier_only, common), common)
    assert got == want
    back = decompress(compressed_proof_from_bytes(got, common), verifier_only, common)
    assert proof_to_bytes(back) == pb


def test_witness_is_fully_native_and_equals_reference(no_commitment):
    """The 515-lookup circuit's witness (the lookup wires filled) on the
    native plan, no generator in Python, equal to the reference's and to
    the port's Python engine's."""
    tb, initial = _port_circuit("lookup515")
    jb, jinitial = lookup_circuits(jcb.CircuitBuilder, JNoop, jlk, J_CONFIG)["lookup515"]
    data, jdata = tb.build(device="cpu"), jb.build()
    pw, jpw = tw.PartialWitness(), jw.PartialWitness()
    pw.set_target(initial, INITIAL_A)
    jpw.set_target(jinitial, INITIAL_A)
    jrng.seed(SEED)
    try:
        jpart = jgen.generate_partial_witness(jpw, jdata.prover_only, jdata.common)
    finally:
        jrng.seed(None)
    jp.set_lookup_wires(jdata.prover_only, jdata.common, jpart)
    want = jpart.full_witness()
    for engine in ("native", "python"):
        trng.seed(SEED)
        try:
            part = tgen.generate_partial_witness(pw, data.prover_only, data.common, engine)
        finally:
            trng.seed(None)
        tp.set_lookup_wires(data.prover_only, data.common, part)
        assert (part.full_witness() == want).all(), engine
    tgen.generate_partial_witness(pw, data.prover_only, data.common, "native")
    assert data.prover_only.cache("host")["last_plan"].fallbacks == {}


@pytest.mark.parametrize("lookup_type", [1, 2])
def test_recursion_circuit_over_a_2_14_lookup_inner_equals_reference(lookup_type,
                                                                     no_commitment):
    """The in-circuit verifier of a proof of the 2^14 lookup inner circuit:
    the reference's gates, copy constraints and generators (the lookup
    deltas drawn, the TIP5 polynomial evaluated in the circuit)."""
    blob = _data(f"lookup{lookup_type}_14.verifier.bin")
    _, t_common = verifier_data_from_bytes(blob)
    _, j_common = j_vd_from_bytes(blob)
    assert (t_common.degree_bits, t_common.num_lookup_polys, len(t_common.luts)) == (14, 7, 1)

    def make(b, ops):
        rv, common = (trv, t_common) if ops is tops else (jrv, j_common)
        pt = rv.add_virtual_proof_with_pis(b, common)
        vdt = rv.add_virtual_verifier_data(b, common.config.fri_config.cap_height)
        rv.verify_proof(b, pt, vdt, common)
        b.register_public_inputs(pt.public_inputs)
        return [pt.proof.openings.lookup_zs, pt.proof.openings.next_lookup_zs]

    tb, _, (lookup_zs, next_lookup_zs), _ = _both(make)
    assert len(lookup_zs) == len(next_lookup_zs) == 14
