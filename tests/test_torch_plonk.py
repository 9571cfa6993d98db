"""The port's PLONK prover against the reference package, on the CPU.

At the factorial circuit (degree 2^6, from the port's committed data): the
committed data is what the reference makes now; the port's reader equals
`convert.circuit_from_reference` of the reference's objects; on the host
transcript path the prove's Zs and partial products, quotient chunks and
opening set each equal the reference's `_all_partial_products_and_zs`,
`_compute_quotient_polys` and `_opening_set` on the same inputs; on the
fused path (the default) the rounds take device draws and `_openings_final`
equals the reference's `_openings_final_fn`; both paths give
`fixtures/factorial.proof.bin` byte for byte, and a warm fused prove reads
nothing back to the host before its one fetch. At the bench_recursion
middle circuit: the port's reader equals the reference's (without building
the commitment). And the entry point refuses what it does not do.
"""

import os
import struct
import sys
import traceback
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from plonky2_tpu.field import scalar as fs
from plonky2_tpu.plonk import prover as jp
from plonky2_tpu.plonk import prover_serialization as jps
from plonky2_torch import convert
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.fri import prover as tfp
from plonky2_torch.iop.witness import read_partial_witness
from plonky2_torch.ops import poseidon as tkp
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.prover_serialization import Reader, read_circuit_data, read_prover_data
from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
from plonky2_torch.util import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_make_data  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "plonky2_torch", "data")
SEED = torch_make_data.SEED


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain Poseidon grind runs ~3x faster on one intra-op thread than
    on many while other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    """(prover bytes, CircuitData, witness, public inputs, hash) of factorial,
    made by the reference now."""
    return torch_make_data.factorial_data()


@pytest.fixture(scope="module")
def port_data():
    prover_only, common = read_prover_data(_read("plonky2_torch", "data", "factorial.prover.bin"))
    w = np.load(os.path.join(DATA, "factorial.witness.npz"))
    return (prover_only, common, w["witness"], [int(v) for v in w["public_inputs"]],
            [int(v) for v in w["public_inputs_hash"]])


def _recorded_prove(port_data, names, host: bool):
    """The port's plain-path prove of factorial on the host (host=True) or
    the fused transcript path, with the inputs and outputs of the named
    rounds recorded. Returns (proof bytes, calls, transcript path)."""
    prover_only, common, witness, pis, pi_hash = port_data
    calls = {}

    def spy(name):
        fn = getattr(tp, name)

        def run(*args):
            calls[name] = (args, fn(*args))
            return calls[name][1]
        return run

    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            mp.setattr(tp, name, spy(name))
        if host:
            mp.setattr(tfp, "_FORCE_HOST", True)
        pwp = tp.prove(prover_only, common, None, device="cpu",
                       _prepared=(witness, pis, pi_hash))
    return proof_to_bytes(pwp), calls, tp._LAST_TRANSCRIPT


@pytest.fixture(scope="module")
def port_prove(port_data):
    """The host-transcript prove, its three rounds recorded."""
    return _recorded_prove(port_data, ("all_partial_products_and_zs", "compute_quotient_polys",
                                       "opening_set"), host=True)


@pytest.fixture(scope="module")
def port_prove_fused(port_data):
    """The fused prove (the default path), its rounds recorded."""
    return _recorded_prove(port_data, ("all_partial_products_and_zs", "compute_quotient_polys",
                                       "_openings_final"), host=False)


def test_committed_factorial_data_is_what_the_reference_makes(reference, port_data):
    prover_bytes, _, witness, pis, pi_hash, inputs = reference
    assert _read("plonky2_torch", "data", "factorial.prover.bin") == prover_bytes
    assert np.array_equal(port_data[2], witness) and port_data[2].dtype == np.uint64
    assert port_data[3:] == (pis, pi_hash)
    committed = np.load(os.path.join(DATA, "factorial.inputs.npz"))
    for name, want in torch_make_data.inputs_arrays(inputs).items():
        assert np.array_equal(committed[name], want), name


def test_reader_equals_converted_reference_objects(reference, port_data):
    data = reference[1]
    want_prover, want_common = convert.circuit_from_reference(data.prover_only, data.common)
    got_prover, got_common = port_data[:2]
    assert got_common == want_common
    for name in ("constants_sigmas_coeffs", "sigmas", "subgroup"):
        got, want = getattr(got_prover, name), getattr(want_prover, name)
        assert got.dtype == want.dtype == np.uint64 and np.array_equal(got, want), name
    assert got_prover.circuit_digest == want_prover.circuit_digest


def test_factorial_prove_on_cpu_equals_the_fixture(port_prove):
    assert port_prove[2] == "host"
    assert port_prove[0] == _read("fixtures", "factorial.proof.bin")


def test_factorial_fused_prove_on_cpu_equals_the_fixture(port_prove_fused):
    assert port_prove_fused[2] == "fused"
    assert port_prove_fused[0] == _read("fixtures", "factorial.proof.bin")


def test_fused_rounds_take_device_draws_and_equal_reference(reference, port_prove_fused):
    data = reference[1]
    calls = port_prove_fused[1]
    (wires_routed, _, _, betas, gammas), got = calls["all_partial_products_and_zs"]
    assert isinstance(betas, torch.Tensor) and betas.shape == (data.common.config.num_challenges,)
    draws = lambda t: jnp.asarray(tg.to_numpy(t))  # noqa: E731
    want = jp._all_partial_products_and_zs(jnp.asarray(tg.to_numpy(wires_routed)),
                                           data.prover_only, data.common, draws(betas),
                                           draws(gammas))
    assert np.array_equal(tg.to_numpy(got), np.asarray(want))
    (_, _, cs, wires, zs_pp, pi_hash, betas, gammas, alphas), got = \
        calls["compute_quotient_polys"]
    assert isinstance(pi_hash, torch.Tensor) and isinstance(alphas, torch.Tensor)
    lde = lambda b: types.SimpleNamespace(lde=jnp.asarray(tg.to_numpy(b.lde)))  # noqa: E731
    want = jp._compute_quotient_polys(
        data.prover_only, data.common, data.prover_only.constants_sigmas_commitment,
        lde(wires), lde(zs_pp), [int(v) for v in tg.to_numpy(pi_hash)], draws(betas),
        draws(gammas), draws(alphas))
    assert np.array_equal(tg.to_numpy(got), np.asarray(want))


def test_openings_final_equals_reference(reference, port_prove_fused):
    args, got = port_prove_fused[1]["_openings_final"]
    sponge, zdraw, cs, wires, zs_pp, quot, nc, degree_bits, rate_bits = args
    rows = [int(t.shape[0]) for t in (cs, wires, zs_pp, quot)]
    fn = jp._openings_final_fn(*rows, nc, degree_bits, rate_bits)
    want = fn(*(jnp.asarray(tg.to_numpy(t)) for t in (sponge, zdraw, cs, wires, zs_pp, quot)))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert np.array_equal(tg.to_numpy(a), np.asarray(b))


class _HostReadAudit(TorchDispatchMode):
    """Records every operation that reads a tensor back to the host or makes
    one from host data (on a card each synchronises): `.item()`, `int()`,
    `bool()` and a Python `if` on a tensor, `nonzero`, boolean-mask
    indexing, `torch.tensor` / `as_tensor` / `from_numpy`, and (patched in
    by the test) `Tensor.numpy` / `tolist`. `paused` exempts the kernels'
    plain versions that read on the CPU where the card runs a kernel, and
    the pinned upload of the host-observed transcript prefix."""

    READS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
             "aten.lift_fresh.default", "aten.masked_select.default"}

    def __init__(self):
        super().__init__()
        self.paused = 0
        self.hits = []

    def hit(self, what):
        if not self.paused:
            where = [f"{os.path.basename(f.filename)}:{f.lineno}" for f in
                     traceback.extract_stack() if "plonky2_torch" in f.filename][-2:]
            self.hits.append((what, where))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name in self.READS or (name.startswith("aten.index") and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool
                for a in args if isinstance(a, (list, tuple)) for t in a)):
            self.hit(name)
        return func(*args, **(kwargs or {}))

    def exempt(self, fn):
        def run(*a, **k):
            self.paused += 1
            try:
                return fn(*a, **k)
            finally:
                self.paused -= 1
        return run


def test_warm_fused_prove_reads_nothing_back_before_its_fetch(port_data, port_prove_fused):
    """The CPU form of the card's `set_sync_debug_mode("error")` check: a
    warm `prove(_defer=True)` on a witness tensor reads nothing back and
    uploads nothing; `finish()` then gives the fixture's bytes."""
    prover_only, common, witness, pis, pi_hash = port_data
    witness_t = torch.from_numpy(np.ascontiguousarray(witness).view(np.int64).copy())
    audit = _HostReadAudit()
    numpy_, tolist_ = torch.Tensor.numpy, torch.Tensor.tolist
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tkp, "grind_device", audit.exempt(tkp.grind_device))
        mp.setattr(tg, "upload", audit.exempt(tg.upload))
        mp.setattr(torch.Tensor, "numpy", lambda t, *a, **k: (audit.hit("numpy"),
                                                              numpy_(t, *a, **k))[1])
        mp.setattr(torch.Tensor, "tolist", lambda t: (audit.hit("tolist"), tolist_(t))[1])
        with audit:
            finish = tp.prove(prover_only, common, None, device="cpu", _defer=True,
                              _prepared=(witness_t, pis, pi_hash))
    assert audit.hits == []
    assert tp._LAST_TRANSCRIPT == "fused"
    assert proof_to_bytes(finish()) == _read("fixtures", "factorial.proof.bin")


def test_zs_and_partial_products_equal_reference(reference, port_prove):
    data = reference[1]
    (wires_routed, _, _, betas, gammas), got = port_prove[1]["all_partial_products_and_zs"]
    want = jp._all_partial_products_and_zs(jnp.asarray(tg.to_numpy(wires_routed)),
                                           data.prover_only, data.common, betas, gammas)
    assert np.array_equal(tg.to_numpy(got), np.asarray(want))


def test_quotient_chunks_equal_reference(reference, port_prove):
    data = reference[1]
    (_, _, cs, wires, zs_pp, pi_hash, betas, gammas, alphas), got = \
        port_prove[1]["compute_quotient_polys"]
    assert np.array_equal(tg.to_numpy(cs.lde),
                          np.asarray(data.prover_only.constants_sigmas_commitment.lde))
    lde = lambda b: types.SimpleNamespace(lde=jnp.asarray(tg.to_numpy(b.lde)))  # noqa: E731
    want = jp._compute_quotient_polys(
        data.prover_only, data.common, data.prover_only.constants_sigmas_commitment,
        lde(wires), lde(zs_pp), pi_hash, betas, gammas, alphas)
    assert got.shape == (data.common.num_quotient_polys(), data.common.degree)
    assert np.array_equal(tg.to_numpy(got), np.asarray(want))


def test_opening_set_equals_reference(reference, port_prove):
    data = reference[1]
    (zeta, g_root, _, wires, zs_pp, quotient, _), got = port_prove[1]["opening_set"]
    polys = lambda b: types.SimpleNamespace(  # noqa: E731
        polynomials=jnp.asarray(tg.to_numpy(b.polynomials)))
    want = jp._opening_set(zeta, g_root, data.prover_only.constants_sigmas_commitment,
                           polys(wires), polys(zs_pp), polys(quotient), data.common)
    for name in ("constants", "plonk_sigmas", "wires", "plonk_zs", "plonk_zs_next",
                 "partial_products", "quotient_polys"):
        assert getattr(got, name) == getattr(want, name), name
    assert want.lookup_zs == want.lookup_zs_next == []


def _norm(x):
    """A package-neutral form of targets, generators and their fields, to
    hold the port's objects to the reference's."""
    name = type(x).__name__
    if name == "Wire":
        return ("Wire", x.row, x.column)
    if name == "VirtualTarget":
        return ("VirtualTarget", x.index)
    if name == "ExtensionTarget":
        return ("ExtensionTarget", _norm(x.parts))
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return (name, {k: _norm(v) for k, v in sorted(vars(x).items())})


def test_middle_reader_equals_reference(monkeypatch):
    def coefficients_only(r, common):  # the reference reader, minus the commitment
        num_polys, n = r.read_usize(), r.read_usize()
        polys = np.frombuffer(bytes(r.data[r.pos:r.pos + 8 * num_polys * n]),
                              dtype=np.uint64).reshape(num_polys, n)
        r.pos += 8 * num_polys * n
        r.read_usize(), r.read_usize(), r.read_bool()
        return types.SimpleNamespace(polynomials=polys)

    monkeypatch.setattr(jps, "read_polynomial_batch", coefficients_only)
    blob = _read("bench_cache", "middle14.circuit.bin")
    want = jps.circuit_data_from_bytes(blob)
    got_prover, got_common, got_verifier = read_circuit_data(blob)
    want_prover, want_common = convert.circuit_from_reference(want.prover_only, want.common)
    assert got_common == want_common
    assert (got_common.degree_bits, got_common.config.num_wires,
            got_common.config.num_routed_wires, got_common.quotient_degree_factor,
            got_common.num_constants, got_common.selectors_info.num_selectors,
            got_common.num_gate_constraints, got_common.num_partial_products,
            got_common.fri_params.reduction_arity_bits) == (13, 135, 80, 8, 5, 3, 123, 9, (4, 4))
    assert len(got_common.gates) == 12
    for name in ("constants_sigmas_coeffs", "sigmas", "subgroup"):
        assert np.array_equal(getattr(got_prover, name), getattr(want_prover, name)), name
    assert got_prover.circuit_digest == want_prover.circuit_digest
    assert got_verifier.constants_sigmas_cap == want.verifier_only.constants_sigmas_cap
    assert got_verifier.circuit_digest == want.verifier_only.circuit_digest
    # the witness generators, their watch lists, the public-input targets
    # and the representative map
    assert len(got_prover.generators) == len(want.prover_only.generators) == 8261
    for a, b in zip(got_prover.generators, want.prover_only.generators):
        assert _norm(a) == _norm(b)
    got_w, want_w = got_prover.generator_indices_by_watches, \
        want.prover_only.generator_indices_by_watches
    assert sorted(got_w) == sorted(want_w)
    assert all(np.array_equal(got_w[k], np.asarray(want_w[k], dtype=np.int64)) for k in got_w)
    assert _norm(got_prover.public_inputs) == _norm(want.prover_only.public_inputs)
    assert np.array_equal(got_prover.representative_map,
                          np.asarray(want.prover_only.representative_map, dtype=np.int64))


@pytest.mark.parametrize("tag,read,what", [
    (5, "gate", "ExponentiationGate"), (6, "gate", "LookupGate"),
    (7, "gate", "LookupTableGate"), (10, "gate", "PoseidonMdsGate"), (16, "gate", "unknown"),
    (3, "skip_generator", "BaseSumGenerator"), (22, "skip_generator", "SplitGenerator"),
    (25, "skip_generator", "unknown"),
])
def test_reader_rejects_tags_it_does_not_know(tag, read, what):
    """Tags the port has no class for raise; ExponentiationGate (5, its
    num_power_bits after the tag), LookupGate (6: its slots, its LUT's
    index in the common data's LUTs and the LUT's hash), LookupTableGate (7:
    its slots, its last LUT row, the LUT's index and hash) and
    PoseidonMdsGate (10, no payload) are read, to the reference's gates."""
    if tag in (5, 6, 7, 10):
        from plonky2_tpu.plonk.circuit_serialization import CircuitReader
        from plonky2_torch.gadgets.lookup import TIP5_TABLE
        from plonky2_torch.gates.lookup import lut_hash

        lut = list(zip(range(256), TIP5_TABLE))
        payload = {6: struct.pack("<QQ", 40, 0) + lut_hash(lut),
                   7: struct.pack("<QQQ", 26, 5, 0) + lut_hash(lut)}.get(tag, struct.pack("<Q", 66))
        blob = struct.pack("<I", tag) + payload + bytes(56)
        want = CircuitReader(blob).read_gate([lut])
        reader = Reader(blob)
        reader.luts = [lut]
        got = reader.gate()
        assert what in got.id() and got.id() == want.id()
        return
    with pytest.raises(ValueError, match=what):
        # a generator is read, no longer stepped over
        read = {"skip_generator": "generator"}.get(read, read)
        getattr(Reader(struct.pack("<I", tag) + bytes(64)), read)()


def test_prove_refuses_what_is_not_ported(port_data):
    """Without a card the default device raises. Zero knowledge is ported
    (tests/test_torch_zk.py proves a zk circuit), and lookups: the committed
    two-LUT circuit (degree 2^5) proves on the CPU from its prover data to
    the reference's bytes (tests/test_torch_lookups.py has the rest)."""
    from plonky2_torch.iop.witness import PartialWitness

    prover_only, common, *prepared = port_data
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.prove(prover_only, common, None, _prepared=prepared)
    lk_prover, lk_common = read_prover_data(
        _read("plonky2_torch", "data", "lookup_two_tables.prover.bin"))
    trng.seed(2026)
    try:
        got = proof_to_bytes(tp.prove(lk_prover, lk_common, PartialWitness(), device="cpu"))
    finally:
        trng.seed(None)
    assert lk_common.num_lookup_polys and tp._LAST_TRANSCRIPT == "host"
    assert got == _read("plonky2_torch", "data", "lookup_two_tables.proof.bin")


def test_random_witness_is_seeded_and_hashes_its_public_inputs(port_data):
    from plonky2_tpu.hash import poseidon as jps_hash

    common = port_data[1]
    w1, pis, pi_hash = tp.random_witness(common, 2026)
    w2, _, _ = tp.random_witness(common, 2026)
    assert w1.shape == (135, 64) and w1.dtype == np.uint64 and np.array_equal(w1, w2)
    assert (w1 < fs.P).all() and len(pis) == common.num_public_inputs == 2
    assert pi_hash == jps_hash.hash_no_pad(pis)


# -- proving from the circuit's inputs: the witness phase, prove_many ------------

@pytest.fixture(scope="module")
def sequential_proofs(port_data):
    """Three sequential proofs of factorial's committed inputs under seed
    2026: (inputs, [(prepared witness, proof)]). The first witness is the
    committed one, whose proof the fixture tests above hold to
    fixtures/factorial.proof.bin, so its proof is read from the fixture;
    the other two draw other values for the circuit's random wires and are
    proved here."""
    prover_only, common = port_data[:2]
    inputs = read_partial_witness(os.path.join(DATA, "factorial.inputs.npz"))
    trng.seed(SEED)
    try:
        prepared = [tp.prepare_witness(prover_only, common, inputs) for _ in range(3)]
    finally:
        trng.seed(None)
    proofs = [proof_from_bytes(_read("fixtures", "factorial.proof.bin"), common)]
    proofs += [tp.prove(prover_only, common, None, device="cpu", _prepared=p)
               for p in prepared[1:]]
    return inputs, list(zip(prepared, proofs))


def test_prepare_witness_from_inputs_gives_the_committed_witness(port_data, sequential_proofs):
    """prepare_witness of the committed inputs under seed 2026 (the native
    plan) gives the committed witness, public inputs and hash; the next two
    witnesses differ from it in their random wires only."""
    _, seq = sequential_proofs
    (witness, pis, pi_hash), _ = seq[0]
    assert np.array_equal(witness, port_data[2]) and (pis, pi_hash) == tuple(port_data[3:])
    assert len({prepared[0].tobytes() for prepared, _ in seq}) == 3
    assert all(p[1:] == (pis, pi_hash) for p, _ in seq)


@pytest.mark.parametrize("window,threads", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_prove_many_equals_sequential_proves(port_data, sequential_proofs, window, threads):
    """prove_many of factorial's inputs, K = 3, under seed 2026: its proofs,
    in order, are the three sequential proofs, and at most `window` are in
    flight. On the CPU the device chain is the plain path that the fixture
    tests above already hold; here each witness the sequential proofs were
    made from is proved once (its proof reused), so what runs is
    prove_many's own logic: the witness phases in proof order on the
    caller's thread (the rng draws), the deferred or threaded dispatch, the
    window and the order of the results. A witness no sequential proof was
    made from is proved for real, and its bytes then differ. The card's
    test (tests/test_torch_cuda.py) proves every proof for real."""
    prover_only, common = port_data[:2]
    inputs, seq = sequential_proofs
    done = {prepared[0].tobytes(): proof for prepared, proof in seq}
    real_prove = tp.prove
    defers = []

    def prove_once(prover_data, common_, inputs_, device=None, timing=None, _defer=False,
                   _prepared=None):
        defers.append(_defer)
        proof = done.get(_prepared[0].tobytes())
        if proof is None:
            return real_prove(prover_data, common_, inputs_, device, timing, _defer, _prepared)
        return (lambda: proof) if _defer else proof

    trng.seed(SEED)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tp, "prove", prove_once)
            got = tp.prove_many(prover_only, common, [inputs] * 3, device="cpu",
                                window=window, threads=threads)
    finally:
        trng.seed(None)
    assert [proof_to_bytes(p) for p in got] == [proof_to_bytes(p) for _, p in seq]
    assert 1 <= tp._LAST_MAX_IN_FLIGHT <= window
    assert defers == [threads == 1] * 3


@pytest.mark.parametrize("name", ["fibonacci", "range_check"])
def test_example_prove_from_inputs_equals_the_fixture(name):
    """The committed prover data and inputs of a circuit with no FRI fold
    step (the host transcript's branch), proved on the CPU under seed 2026
    from the port's own witness generation, through
    `ProverCircuitData.prove`: fixtures/<name>.proof.bin."""
    from plonky2_torch.plonk.circuit_data import ProverCircuitData

    data = ProverCircuitData(*read_prover_data(_read("plonky2_torch", "data",
                                                     f"{name}.prover.bin")))
    assert tuple(data.common.fri_params.reduction_arity_bits) == ()
    inputs = read_partial_witness(os.path.join(DATA, f"{name}.inputs.npz"))
    trng.seed(SEED)
    try:
        proof = data.prove(inputs, device="cpu")
    finally:
        trng.seed(None)
    assert tp._LAST_TRANSCRIPT == "host"
    assert proof_to_bytes(proof) == _read("fixtures", f"{name}.proof.bin")
