"""The port's witness phase against the reference package, on the CPU.

Each generator kind of the bench_recursion middle circuit (and the copy and
nonzero-test generators), read from `bench_cache/middle14.circuit.bin` by
both packages, moved onto the rows of a small witness and run on the same
seeded random inputs through `run_once` and `run_batch`: the port's values
equal the reference's. The engines: from factorial's committed inputs the
native plan and the levelized Python engine both give the committed
witness, and they agree on fibonacci and range_check; from the inner proof
the middle circuit's witness equals the reference's. The readers: the
inner proof and its verifier data, and the proof targets filled from them,
equal the reference's. The native library: built from the port's own
source, equal to the Python forms, and a failed build raises.
"""

import copy
import os
import sys
import types

import numpy as np
import pytest

from plonky2_tpu.iop import generator as jgen
from plonky2_tpu.iop import target as jt
from plonky2_tpu.iop import witness as jw
from plonky2_tpu.plonk import prover_serialization as jps
from plonky2_tpu.util import rng as jrng
from plonky2_torch import convert
from plonky2_torch import native
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates import poseidon_gate as tpg
from plonky2_torch.hash import poseidon as tps
from plonky2_torch.iop import generator as tgen
from plonky2_torch.iop import target as tt
from plonky2_torch.iop import witness as tw
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes
from plonky2_torch.plonk.prover_serialization import read_circuit_data, read_prover_data
from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
from plonky2_torch.recursion import recursive_verifier as trv
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_plonk import _norm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "plonky2_torch", "data")
SEED = 2026
KINDS = ["PoseidonGenerator", "ArithmeticBaseGenerator", "ArithmeticExtensionGenerator",
         "RandomAccessGenerator", "MulExtensionGenerator", "ReducingGenerator",
         "RandomValueGenerator", "InterpolationGenerator", "QuotientGeneratorExtension",
         "BaseSplitGenerator", "WireSplitGenerator", "ConstantGenerator",
         "ReducingExtensionGenerator"]


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def middle():
    """The middle circuit by the port's reader and by the reference's (its
    constants-sigmas commitment not built)."""
    def coefficients_only(r, common):
        num_polys, n = r.read_usize(), r.read_usize()
        r.pos += 8 * num_polys * n
        r.read_usize(), r.read_usize(), r.read_bool()
        return types.SimpleNamespace(polynomials=None)

    blob = _read("bench_cache", "middle14.circuit.bin")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "read_polynomial_batch", coefficients_only)
        ref = jps.circuit_data_from_bytes(blob)
    return read_circuit_data(blob), ref


def _pick(port_gens, ref_gens, kind, n=6):
    """Up to n (port, reference) pairs of one kind whose inputs and outputs
    do not overlap, so that they run side by side on free inputs."""
    pairs, ins, outs = [], set(), set()
    for a, b in zip(port_gens, ref_gens):
        if type(a).__name__ != kind:
            continue
        d = {_norm(t) for t in a.dependencies()}
        o = {_norm(t) for t in a.outputs()}
        if d & outs or o & ins or o & outs:
            continue
        pairs.append((a, b))
        ins |= d
        outs |= o
        if len(pairs) == n:
            break
    return pairs


def _move(gens, rows, virtual, T):
    """Copies of the generators on new rows and virtual indices (the maps
    grow as they meet new ones), with the targets of package T."""
    def conv(key, v):
        name = type(v).__name__
        if key == "row":
            return rows.setdefault(v, len(rows))
        if key == "gates":
            return [rows.setdefault(r, len(rows)) for r in v]
        if name == "Wire":
            return T.Wire(rows.setdefault(v.row, len(rows)), v.column)
        if name == "VirtualTarget":
            return T.VirtualTarget(virtual.setdefault(v.index, len(virtual)))
        if name == "ExtensionTarget":
            return T.ExtensionTarget(tuple(conv(None, p) for p in v.parts))
        return v

    out = []
    for g in gens:
        new = copy.copy(g)
        for k, v in vars(g).items():
            setattr(new, k, conv(k, v))
        out.append(new)
    return out


def _inputs(kind, gens, rng):
    """Seeded random values of the generators' dependencies (normalised
    target -> value), within what each kind requires of its inputs."""
    vals = {}
    for g in gens:
        deps = g.dependencies()
        for t in deps:
            vals[_norm(t)] = int(rng.integers(0, fs.P, dtype=np.uint64))
        first = _norm(deps[0]) if deps else None
        if kind == "PoseidonGenerator":
            vals[_norm(deps[-1])] = int(rng.integers(0, 2))  # the swap bit
        elif kind == "RandomAccessGenerator":
            vals[first] = int(rng.integers(0, 1 << g.bits))
        elif kind == "BaseSplitGenerator":
            vals[first] = int(rng.integers(0, min(fs.P, g.base ** g.num_limbs), dtype=np.uint64))
        elif kind == "WireSplitGenerator":
            vals[first] = int(rng.integers(0, min(fs.P, 1 << (g.num_limbs * len(g.gates))),
                                           dtype=np.uint64))
        elif kind == "NonzeroTestGenerator":
            vals[first] = int(rng.integers(0, 3)) * vals[first] // 2  # some zeros
    return vals


def _synthetic(kind, T, G):
    """Six copy or nonzero-test generators over fresh virtual targets."""
    cls = getattr(G, kind)
    return [cls(T.VirtualTarget(2 * i), T.VirtualTarget(2 * i + 1)) for i in range(6)]


def _run(kind, gens, T, W, G, vals, num_virtual, batch: bool):
    """The generators on a fresh witness of identity representatives, the
    inputs set, through run_batch or run_once each; (values, known)."""
    rows = 1 + max([t.row for g in gens for t in g.dependencies() + g.outputs()
                    if type(t).__name__ == "Wire"], default=0)
    degree = 1 << max(3, (rows - 1).bit_length())
    w = W.PartitionWitness(np.arange(degree * 135 + num_virtual, dtype=np.int64), 135, degree)
    for g in gens:
        for t in g.dependencies():
            w.set_target(t, vals[_norm(t)])
    if kind == "RandomValueGenerator":
        (jrng if G is jgen else trng).seed(SEED)
    try:
        if batch:
            type(gens[0]).run_batch(gens, w)
        else:
            buf = G.GeneratedValues()
            for g in gens:
                g.run_once(w, buf)
                for t, v in buf.target_values:
                    w.set_target(t, v)
                buf.target_values.clear()
    finally:
        (jrng if G is jgen else trng).seed(None)
    return w.values.copy(), w.known.copy()


@pytest.mark.parametrize("kind", KINDS + ["CopyGenerator", "NonzeroTestGenerator"])
def test_generator_equals_reference(middle, kind):
    (port, _, _), ref = middle
    if kind in KINDS:
        pairs = _pick(port.generators, ref.prover_only.generators, kind)
        rows, virtual = {}, {}
        t_gens = _move([a for a, _ in pairs], rows, virtual, tt)
        rows2, virtual2 = {}, {}
        j_gens = _move([b for _, b in pairs], rows2, virtual2, jt)
        assert (rows, virtual) == (rows2, virtual2)
    else:
        t_gens, j_gens, virtual = _synthetic(kind, tt, tgen), _synthetic(kind, jt, jgen), range(12)
    assert len(t_gens) >= 2
    vals = _inputs(kind, t_gens, np.random.default_rng(SEED))
    want = _run(kind, j_gens, jt, jw, jgen, vals, len(virtual), batch=False)
    assert want[1].sum() > len(vals)  # the generators wrote something
    paths = [False] + ([True] if hasattr(type(t_gens[0]), "run_batch") else [])
    for batch in paths:
        got = _run(kind, t_gens, tt, tw, tgen, vals, len(virtual), batch)
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0]), batch
    if hasattr(type(j_gens[0]), "run_batch"):
        ref_batch = _run(kind, j_gens, jt, jw, jgen, vals, len(virtual), batch=True)
        assert np.array_equal(ref_batch[0], want[0])


@pytest.mark.parametrize("engine", ["native", "python"])
def test_factorial_witness_from_inputs_on_each_engine(engine):
    prover_only, common = read_prover_data(_read("plonky2_torch", "data", "factorial.prover.bin"))
    inputs = tw.read_partial_witness(os.path.join(DATA, "factorial.inputs.npz"))
    want = np.load(os.path.join(DATA, "factorial.witness.npz"))
    trng.seed(SEED)
    try:
        partition = tgen.generate_partial_witness(inputs, prover_only, common, engine=engine)
    finally:
        trng.seed(None)
    assert np.array_equal(partition.full_witness(), want["witness"])
    assert partition.get_targets(prover_only.public_inputs) == [
        int(v) for v in want["public_inputs"]]


@pytest.mark.parametrize("name", ["fibonacci", "range_check", "factorial"])
def test_engines_agree(name):
    prover_only, common = read_prover_data(_read("plonky2_torch", "data", f"{name}.prover.bin"))
    inputs = tw.read_partial_witness(os.path.join(DATA, f"{name}.inputs.npz"))
    out = []
    for engine in ("native", "python"):
        trng.seed(SEED)
        try:
            out.append(tp.prepare_witness(prover_only, common, inputs, engine=engine))
        finally:
            trng.seed(None)
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1:] == out[1][1:]


@pytest.fixture(scope="module")
def inner():
    """The inner proof and its verifier data, by both packages."""
    from plonky2_tpu.plonk.circuit_serialization import verifier_data_from_bytes as j_vd
    from plonky2_tpu.plonk.serialization import proof_from_bytes as j_proof

    vd_bytes = _read("bench_cache", "inner14.verifier.bin")
    proof_bytes = _read("bench_cache", "inner14.proof.bin")
    t_vo, t_common = verifier_data_from_bytes(vd_bytes)
    j_vo, j_common = j_vd(vd_bytes)
    return ((t_vo, t_common, proof_from_bytes(proof_bytes, t_common)),
            (j_vo, j_common, j_proof(proof_bytes, j_common)), proof_bytes)


def test_inner_proof_and_verifier_data_readers_equal_reference(inner):
    (t_vo, t_common, t_proof), (j_vo, j_common, j_proof), proof_bytes = inner
    assert t_common == convert.common_from_reference(j_common)
    assert (t_vo.constants_sigmas_cap, t_vo.circuit_digest) == (
        j_vo.constants_sigmas_cap, j_vo.circuit_digest)
    assert proof_to_bytes(t_proof) == proof_bytes
    assert t_proof.public_inputs == j_proof.public_inputs
    for name in ("wires_cap", "plonk_zs_partial_products_cap", "quotient_polys_cap"):
        assert getattr(t_proof.proof, name) == getattr(j_proof.proof, name)
    assert _norm(t_proof.proof.opening_proof) == _norm(j_proof.proof.opening_proof)
    assert vars(t_proof.proof.openings) == vars(j_proof.proof.openings)  # lookups' too


@pytest.mark.parametrize("name", ["factorial", "fibonacci", "range_check"])
def test_proof_reader_round_trips_the_fixtures(name):
    prover_only, common = read_prover_data(_read("plonky2_torch", "data", f"{name}.prover.bin"))
    blob = _read("fixtures", f"{name}.proof.bin")
    assert proof_to_bytes(proof_from_bytes(blob, common)) == blob
    with pytest.raises(ValueError, match="trailing"):
        proof_from_bytes(blob + bytes(8), common)


def test_proof_targets_are_filled_as_the_reference_fills_them(inner):
    """bench.py's warm-start inputs: on a fresh builder the proof targets,
    then the verifier-data targets, filled from the inner proof: the same
    (target, value) pairs as the reference's, in the same order."""
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.recursion import recursive_verifier as jrv

    (t_vo, t_common, t_proof), (j_vo, j_common, j_proof), _ = inner
    b = CircuitBuilder()
    pt = trv.add_virtual_proof_with_pis(b, t_common)
    vdt = trv.add_virtual_verifier_data(b, t_common.config.fri_config.cap_height)
    got = tw.PartialWitness()
    trv.set_proof_with_pis_target(got, pt, t_proof)
    trv.set_verifier_data_target(got, vdt, t_vo)
    jb = JBuilder(CircuitConfig.standard_recursion_config())
    jpt = jrv.add_virtual_proof_with_pis(jb, j_common)
    jvdt = jrv.add_virtual_verifier_data(jb, j_common.config.fri_config.cap_height)
    want = jw.PartialWitness()
    jrv.set_proof_with_pis_target(want, jpt, j_proof)
    jrv.set_verifier_data_target(want, jvdt, j_vo)
    assert b.virtual_target_index == jb.virtual_target_index
    assert [(_norm(t), v) for t, v in got.target_values.items()] == [
        (_norm(t), v) for t, v in want.target_values.items()]


def test_middle_witness_from_the_inner_proof_equals_reference(middle, inner):
    """The first headline's witness phase: the middle circuit's full witness
    from the inner proof under seed 2026, on the native plan, equals the
    reference's (its own native plan)."""
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.recursion import recursive_verifier as jrv

    (port, common, _), ref = middle
    (t_vo, t_common, t_proof), (j_vo, j_common, j_proof), _ = inner
    b = CircuitBuilder()
    pw = tw.PartialWitness()
    trv.set_proof_with_pis_target(pw, trv.add_virtual_proof_with_pis(b, t_common), t_proof)
    trv.set_verifier_data_target(pw, trv.add_virtual_verifier_data(b, 4), t_vo)
    trng.seed(SEED)
    try:
        got, pis, pi_hash = tp.prepare_witness(port, common, pw)
    finally:
        trng.seed(None)
    jb = JBuilder(CircuitConfig.standard_recursion_config())
    jpw = jw.PartialWitness()
    jrv.set_proof_with_pis_target(jpw, jrv.add_virtual_proof_with_pis(jb, j_common), j_proof)
    jrv.set_verifier_data_target(jpw, jrv.add_virtual_verifier_data(jb, 4), j_vo)
    jrng.seed(SEED)
    try:
        want = jgen.generate_partial_witness(jpw, ref.prover_only, ref.common).full_witness()
    finally:
        jrng.seed(None)
    assert got.shape == (135, 1 << 13) and np.array_equal(got, np.asarray(want, np.uint64))
    assert pis == [] and pi_hash == tps.hash_no_pad([])


def test_native_library_equals_the_python_forms():
    rng = np.random.default_rng(SEED)
    states = rng.integers(0, fs.P, size=(5, 12), dtype=np.uint64)
    got = native.poseidon_permute(states)
    assert [[int(v) for v in row] for row in got] == [
        tps.permute([int(v) for v in row]) for row in states]
    swap = np.array([0, 1, 0, 1, 1], np.uint64)
    assert np.array_equal(native.poseidon_gate_witness(states, swap),
                          tpg.witness_rows(states, swap))
    x = np.array([0, 1, 5, fs.P - 1], np.uint64)
    assert [int(v) for v in native.batch_inverse(x)] == [0] + [fs.inverse(int(v))
                                                             for v in x[1:]]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises, and the
    Python engine runs only where asked for (it never loads the library)."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native witness executor failed"):
        native.library()
    prover_only, common = read_prover_data(_read("plonky2_torch", "data", "factorial.prover.bin"))
    inputs = tw.read_partial_witness(os.path.join(DATA, "factorial.inputs.npz"))
    with pytest.raises(RuntimeError, match="native witness executor failed"):
        tgen.generate_partial_witness(inputs, prover_only, common)
    tgen.generate_partial_witness(inputs, prover_only, common, engine="python")
    with pytest.raises(ValueError, match="unknown witness engine"):
        tgen.generate_partial_witness(inputs, prover_only, common, engine="numpy")
