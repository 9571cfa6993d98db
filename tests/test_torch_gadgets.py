"""The port's last builder gadgets against the reference package, on the CPU.

Each case of `plonky2_torch/examples/gadgets.py` (the cases of the
reference package's tests/test_algebra_gadgets.py, and the witness-plan
families around `split_low_high`) runs on a port builder and a reference
builder: the same builder state, the same verifier-data bytes (the
commitment replaced by zeros, so the digest, the gates and the selectors
are what is compared) and the same public inputs from the witness. The
`split_low_high` circuit's whole witness equals the reference's on both of
the port's engines, the native one running LowHighGenerator on its opcode.
The builder's convenience surface (`build_prover`, `build_verifier`,
`mock_build`, the domain separator), `check_constraints_on_h` on factorial's
honest and corrupted witness, and `common_data_to_bytes` round trips hold
to the reference's. The gadgets circuit itself is proved on the card
(tests/test_torch_cuda.py, chip_smoke.py). Every comparison is exact.
"""

import os
import sys
import types

import numpy as np
import pytest

from plonky2_tpu.gadgets import algebra_gadgets as jag
from plonky2_tpu.iop import generator as jgen
from plonky2_tpu.iop import witness as jw
from plonky2_tpu.plonk import circuit_builder as jcb
from plonky2_tpu.plonk import circuit_serialization as jcs
from plonky2_tpu.plonk import debug as jdebug
from plonky2_tpu.plonk import prover_serialization as jps
from plonky2_tpu.recursion.recursive_verifier import VerifierCircuitTarget as JVerifierTarget
from plonky2_tpu.util import rng as jrng
from plonky2_torch.examples import gadgets as eg
from plonky2_torch.field import goldilocks as gl
from plonky2_torch.field import scalar as fs
from plonky2_torch.iop import generator as tgen
from plonky2_torch.iop import witness as tw
from plonky2_torch.plonk import circuit_builder as tcb
from plonky2_torch.plonk import circuit_serialization as tcs
from plonky2_torch.plonk import debug as tdebug
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.circuit_data import VerifierCircuitData
from plonky2_torch.plonk.config import keccak_goldilocks_config
from plonky2_torch.plonk import prover_serialization as tps
from plonky2_torch.plonk.prover_serialization import read_prover_data
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_recursion import CONFIG, J_CONFIG, SEED, _state, no_commitment  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_KINDS = types.SimpleNamespace(
    PolynomialCoeffsExtTarget=jag.PolynomialCoeffsExtTarget,
    PolynomialCoeffsExtAlgebraTarget=jag.PolynomialCoeffsExtAlgebraTarget,
    VerifierCircuitTarget=JVerifierTarget)


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


def _seeded(generate, rng):
    """`generate()` with `rng` seeded, as a prove's witness phase draws."""
    rng.seed(SEED)
    try:
        return generate()
    finally:
        rng.seed(None)


def _both(names):
    """The cases on a port and a reference builder, built (no
    commitment), with their witnesses. Returns (port data, port inputs,
    port witness, reference data, reference witness)."""
    tb, jb = tcb.CircuitBuilder(CONFIG), jcb.CircuitBuilder(J_CONFIG)
    inputs = eg.add_cases(tb, eg.port_kinds(), names)
    j_inputs = eg.add_cases(jb, J_KINDS, names)
    assert _state(tb) == _state(jb)
    data, jdata = tb.build(device="cpu"), jb.build()
    pw, jpw = tw.PartialWitness(), jw.PartialWitness()
    for (t, v), (jt, jv) in zip(inputs, j_inputs):
        pw.set_target(t, v)
        jpw.set_target(jt, jv)
    port = _seeded(lambda: tgen.generate_partial_witness(pw, data.prover_only, data.common),
                   trng)
    ref = _seeded(lambda: jgen.generate_partial_witness(jpw, jdata.prover_only, jdata.common),
                  jrng)
    return data, pw, port, jdata, ref


@pytest.mark.parametrize("name", list(eg.CASES))
def test_case_equals_reference(name, no_commitment):
    data, _, port, jdata, ref = _both([name])
    if name == "split_le_base":
        # a BaseSumGate<4>: no registry tag, so no bytes in either package
        with pytest.raises(ValueError):
            tcs.verifier_data_to_bytes(data.verifier_only, data.common)
        assert [g.id() for g in data.common.gates] == [g.id() for g in jdata.common.gates]
        assert data.verifier_only.circuit_digest == list(jdata.verifier_only.circuit_digest)
    else:
        assert (tcs.verifier_data_to_bytes(data.verifier_only, data.common)
                == jcs.verifier_data_to_bytes(jdata.verifier_only, jdata.common))
    pis = port.get_targets(data.prover_only.public_inputs)
    assert pis == ref.get_targets(jdata.prover_only.public_inputs)
    assert len(pis) > 0


@pytest.mark.parametrize("engine", ["native", "python"])
def test_split_low_high_witness_equals_reference(engine, no_commitment):
    """The `split_low_high` circuit's whole witness on each of the port's
    engines; the native plan runs LowHighGenerator on its opcode, not in
    Python."""
    data, pw, _, _, ref = _both(["witness_families"])
    got = _seeded(lambda: tgen.generate_partial_witness(pw, data.prover_only, data.common,
                                                        engine=engine), trng)
    assert np.array_equal(got.full_witness(), np.asarray(ref.full_witness(), dtype=np.uint64))
    if engine == "native":
        assert "LowHighGenerator" not in data.prover_only.cache("host")["last_plan"].fallbacks


def test_split_low_high_generators_write_the_reference_bytes():
    """The split_low_high circuit's generators, LowHighGenerator (tag 12)
    among them, written by each package are the same bytes, and the port
    reads them back to themselves."""
    tb, jb = tcb.CircuitBuilder(CONFIG), jcb.CircuitBuilder(J_CONFIG)
    for b in (tb, jb):
        b.split_low_high(b.add_virtual_target(), 12, 40)
    assert "LowHighGenerator" in [type(g).__name__ for g in tb.generators]
    w, jw_ = tps.ProverWriter(), jps.ProverWriter()
    for g in tb.generators:
        tps.write_generator(w, g)
    for g in jb.generators:
        jps.write_generator(jw_, g, None)
    assert bytes(w.buf) == bytes(jw_.buf)
    r = tps.Reader(bytes(w.buf))
    read = [r.generator() for _ in tb.generators]
    r.finish()
    w2 = tps.ProverWriter()
    for g in read:
        tps.write_generator(w2, g)
    assert bytes(w2.buf) == bytes(w.buf)


def test_builder_convenience_surface_equals_reference(no_commitment):
    """build_prover / build_verifier / mock_build, the constant
    bool, hash and verifier data, and the domain separator (reference
    circuit_builder.rs:262, 1328-1347), on both builders."""
    def make(b, sep=None):
        if sep is not None:
            b.set_domain_separator(sep)
        xs = b.add_virtual_public_input_arr(3)
        h = b.add_virtual_hash_public_input()
        b.connect_array(xs[:2], xs[1:])
        b.register_public_input(b.constant_bool(True).target)
        vd = b.constant_verifier_data(types.SimpleNamespace(
            constants_sigmas_cap=[[1, 2, 3, 4], [5, 6, 7, 8]], circuit_digest=[9, 10, 11, 12]))
        b.register_public_inputs(vd.circuit_digest + vd.constants_sigmas_cap[1])
        return xs, h

    digests = []
    for sep in (None, [1, 2, 3]):
        tb, jb = tcb.CircuitBuilder(CONFIG), jcb.CircuitBuilder(J_CONFIG)
        make(tb, sep), make(jb, sep)
        assert _state(tb) == _state(jb)
        vd, jvd = tb.build_verifier(device="cpu"), jb.build_verifier()
        assert vd.to_bytes() == jvd.to_bytes()
        assert VerifierCircuitData.from_bytes(vd.to_bytes()).to_bytes() == vd.to_bytes()
        digests.append(vd.verifier_only.circuit_digest)
    assert digests[0] != digests[1]
    with pytest.raises(ValueError):
        b = tcb.CircuitBuilder(CONFIG)
        b.set_domain_separator([1])
        b.set_domain_separator([2])

    tb = tcb.CircuitBuilder(CONFIG)
    xs, h = make(tb)
    prover = tb.build_prover(device="cpu")
    assert prover.common.num_public_inputs == 3 + 4 + 1 + 8
    tb = tcb.CircuitBuilder(CONFIG)
    xs, h = make(tb)
    mock = tb.mock_build(device="cpu")
    pw = tw.PartialWitness()
    pw.set_target(xs[0], 4)
    for t in h:
        pw.set_target(t, 2)
    w = mock.generate_witness(pw)
    assert w.get_targets(mock.prover_only.public_inputs) == [
        4, 4, 4, 2, 2, 2, 2, 1, 9, 10, 11, 12, 5, 6, 7, 8]


@pytest.fixture(scope="module")
def factorial():
    """(prover-only data, common data, witness, public-inputs hash) of the
    committed factorial circuit (tests/torch_make_data.py)."""
    prover_only, common = read_prover_data(_read("plonky2_torch", "data", "factorial.prover.bin"))
    w = np.load(os.path.join(ROOT, "plonky2_torch", "data", "factorial.witness.npz"))
    return prover_only, common, w["witness"], [int(v) for v in w["public_inputs_hash"]]


def _zs_partial_products(prover_only, common, witness, betas, gammas) -> np.ndarray:
    routed = gl.tensor(witness[:common.config.num_routed_wires], "cpu")
    zs_pp = tp.all_partial_products_and_zs(routed, prover_only, common, betas, gammas)
    return gl.to_numpy(zs_pp)


@pytest.mark.parametrize("corrupt", [False, True], ids=["honest", "corrupted"])
def test_check_constraints_on_h_equals_reference(factorial, corrupt):
    """The port's checker and the reference's give the same verdicts on
    factorial's witness, honest and with one wire changed; the reference
    reads the same common data from the port's bytes."""
    prover_only, common, witness, pi_hash = factorial
    rng = np.random.default_rng(SEED)
    betas, gammas = ([int(v) for v in rng.integers(0, fs.P, 2, dtype=np.uint64)]
                     for _ in range(2))
    witness = np.array(witness, dtype=np.uint64)
    zs_pp = _zs_partial_products(prover_only, common, witness, betas, gammas)
    if corrupt:
        witness[3, 1] = (int(witness[3, 1]) + 1) % fs.P
    data = types.SimpleNamespace(common=common, prover_only=prover_only)
    got = tdebug.check_constraints_on_h(data, witness, zs_pp, pi_hash, betas, gammas, [])

    import jax.numpy as jnp

    jcommon = jcs.common_data_from_bytes(tcs.common_data_to_bytes(common))
    jdata = types.SimpleNamespace(common=jcommon, prover_only=types.SimpleNamespace(
        constants_sigmas_commitment=types.SimpleNamespace(
            polynomials=jnp.asarray(prover_only.constants_sigmas_coeffs)),
        subgroup=[int(v) for v in prover_only.subgroup]))
    want = jdebug.check_constraints_on_h(jdata, witness, zs_pp, pi_hash, betas, gammas, [])
    assert got == want
    assert bool(got) == corrupt


@pytest.mark.parametrize("name,gc", [("factorial", None), ("bench_recursion", None),
                                     ("keccak_factorial", "keccak")])
def test_common_data_bytes_round_trip(name, gc):
    """common_data_to_bytes of a fixture's common data is the tail of its
    verifier-data bytes and the reference's, and reads back to itself."""
    gc = keccak_goldilocks_config() if gc else None
    blob = _read("fixtures", f"{name}.verifier.bin")
    _, common = tcs.verifier_data_from_bytes(blob, gc)
    got = tcs.common_data_to_bytes(common)
    assert blob.endswith(got)
    assert tcs.common_data_to_bytes(tcs.common_data_from_bytes(got, gc)) == got
    assert jcs.common_data_to_bytes(jcs.common_data_from_bytes(got)) == got
