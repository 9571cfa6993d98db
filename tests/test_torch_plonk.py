"""The port's PLONK prover against the reference package, on the CPU.

At the factorial circuit (degree 2^6, from the port's committed data): the
committed data is what the reference makes now; the port's reader equals
`convert.circuit_from_reference` of the reference's objects; the prove's
Zs and partial products, quotient chunks and opening set each equal the
reference's `_all_partial_products_and_zs`, `_compute_quotient_polys` and
`_opening_set` on the same inputs; and the whole proof equals
`fixtures/factorial.proof.bin` byte for byte. At the bench_recursion middle
circuit: the port's reader equals the reference's (without building the
commitment). And the entry point refuses what it does not do.
"""

import os
import struct
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.field import scalar as fs
from plonky2_tpu.plonk import prover as jp
from plonky2_tpu.plonk import prover_serialization as jps
from plonky2_torch import convert
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.prover_serialization import Reader, read_circuit_data, read_prover_data
from plonky2_torch.plonk.serialization import proof_to_bytes

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_make_data  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "plonky2_torch", "data")


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


@pytest.fixture(scope="module")
def port_prove(port_data):
    """The port's plain-path prove of factorial, with the inputs and
    outputs of its three rounds recorded."""
    prover_only, common, witness, pis, pi_hash = port_data
    calls = {}

    def spy(name):
        fn = getattr(tp, name)

        def run(*args):
            calls[name] = (args, fn(*args))
            return calls[name][1]
        return run

    with pytest.MonkeyPatch.context() as mp:
        for name in ("all_partial_products_and_zs", "compute_quotient_polys", "opening_set"):
            mp.setattr(tp, name, spy(name))
        pwp = tp.prove(prover_only, common, witness, pis, pi_hash, device="cpu")
    return proof_to_bytes(pwp), calls


def test_committed_factorial_data_is_what_the_reference_makes(reference, port_data):
    prover_bytes, _, witness, pis, pi_hash = reference
    assert _read("plonky2_torch", "data", "factorial.prover.bin") == prover_bytes
    assert np.array_equal(port_data[2], witness) and port_data[2].dtype == np.uint64
    assert port_data[3:] == (pis, pi_hash)


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
    assert port_prove[0] == _read("fixtures", "factorial.proof.bin")


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


@pytest.mark.parametrize("tag,read,what", [
    (5, "gate", "ExponentiationGate"), (6, "gate", "LookupGate"),
    (7, "gate", "LookupTableGate"), (10, "gate", "PoseidonMdsGate"), (16, "gate", "unknown"),
    (3, "skip_generator", "BaseSumGenerator"), (22, "skip_generator", "SplitGenerator"),
    (25, "skip_generator", "unknown"),
])
def test_reader_rejects_tags_it_does_not_know(tag, read, what):
    with pytest.raises(ValueError, match=what):
        getattr(Reader(struct.pack("<I", tag) + bytes(64)), read)()


def test_prove_refuses_what_is_not_ported(port_data):
    import dataclasses

    prover_only, common, witness, pis, pi_hash = port_data
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.prove(prover_only, common, witness, pis, pi_hash)
    zk = dataclasses.replace(common, config=dataclasses.replace(common.config,
                                                                zero_knowledge=True))
    with pytest.raises(NotImplementedError, match="zero-knowledge"):
        tp.prove(prover_only, zk, witness, pis, pi_hash, device="cpu")
    with pytest.raises(NotImplementedError, match="lookups"):
        tp.prove(prover_only, dataclasses.replace(common, num_lookup_polys=1), witness, pis,
                 pi_hash, device="cpu")


def test_random_witness_is_seeded_and_hashes_its_public_inputs(port_data):
    from plonky2_tpu.hash import poseidon as jps_hash

    common = port_data[1]
    w1, pis, pi_hash = tp.random_witness(common, 2026)
    w2, _, _ = tp.random_witness(common, 2026)
    assert w1.shape == (135, 64) and w1.dtype == np.uint64 and np.array_equal(w1, w2)
    assert (w1 < fs.P).all() and len(pis) == common.num_public_inputs == 2
    assert pi_hash == jps_hash.hash_no_pad(pis)
