"""The port's transcript and its whole commit-and-open FRI proof against the
reference package: the same numpy-seeded inputs must give byte-identical
proof bytes to the reference sequence run on its host-transcript path, on
the port's fused path (the default) and on its host path; the port's fused
`fri_proof` equals the reference's fused one and leaves the host challenger
where the host path does. Also: the port imports neither jax nor the
reference package, and its entry points refuse to run without CUDA unless
asked for the CPU."""

import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from plonky2_tpu.field import scalar as fs
from plonky2_tpu.fri import prover as jfp
from plonky2_tpu.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu.fri.oracle import PolynomialBatch as JBatch
from plonky2_tpu.fri.structure import (
    FriBatchInfo,
    FriInstanceInfo,
    FriOracleInfo,
    FriPolynomialInfo,
)
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.plonk.serialization import Writer as JWriter
from plonky2_tpu.util import export_cache
from plonky2_torch import convert
from plonky2_torch.examples import commit_and_open as co
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.fri import prover as tfp
from plonky2_torch.fri.oracle import PolynomialBatch as TBatch
from plonky2_torch.fri.serialization import Writer as TWriter
from plonky2_torch.iop.challenger import Challenger as TChallenger


def test_challenger_transcript_matches_reference():
    rng = np.random.default_rng(5)
    j, t = JChallenger(), TChallenger()
    for step in range(6):
        xs = [int(v) for v in rng.integers(0, fs.P, size=3 + 5 * step, dtype=np.uint64)]
        j.observe_elements(xs)
        t.observe_elements(xs)
        k = int(rng.integers(1, 11))
        assert t.get_n_challenges(k) == j.get_n_challenges(k)
    cap = [[int(v) for v in row] for row in rng.integers(0, fs.P, size=(4, 4), dtype=np.uint64)]
    j.observe_cap(cap)
    t.observe_cap(cap)
    assert t.get_extension_challenge(2) == j.get_extension_challenge(2)
    j.observe_element(7)
    t.observe_element(7)
    assert t.compact() == j.compact()
    assert t.get_hash() == j.get_hash()


def _eval_ext(coeffs, z):
    """Host Horner evaluation of each row of [J, n] coefficients at z."""
    out = []
    for row in np.asarray(coeffs):
        acc = fs.ext_zero(2)
        for c in reversed(row):
            acc = fs.ext_add(fs.ext_mul(acc, z), fs.ext_from_base(int(c), 2))
        out.append(acc)
    return out


def _reference_commit_and_open(inputs, config) -> bytes:
    """The same sequence through the reference package, host transcript
    (openings evaluated with its host scalar field)."""
    rate, cap = config.rate_bits, config.cap_height
    nc = inputs.num_challenges
    degree_bits = inputs.wires.shape[1].bit_length() - 1
    params = config.fri_params(degree_bits, hiding=False)
    with jfp.force_host_path():
        cs = JBatch.from_values(inputs.constants_sigmas, rate, False, cap)
        wires = JBatch.from_values(inputs.wires, rate, False, cap)
        ch = JChallenger()
        params.observe(ch)
        ch.observe_hash(inputs.circuit_digest)
        ch.observe_hash(inputs.public_inputs_hash)
        ch.observe_cap(wires.merkle_tree.cap)
        ch.get_n_challenges(nc)
        ch.get_n_challenges(nc)
        zs = JBatch.from_values(inputs.zs_partial_products, rate, False, cap)
        ch.observe_cap(zs.merkle_tree.cap)
        ch.get_n_challenges(nc)
        quot = JBatch.from_coeffs(inputs.quotient_coeffs, rate, False, cap)
        ch.observe_cap(quot.merkle_tree.cap)
        zeta = ch.get_extension_challenge(2)
        zeta_next = fs.ext_scalar_mul(fs.primitive_root_of_unity(degree_bits), zeta)
        oracles = [cs, wires, zs, quot]
        zeta_values = [v for o in oracles for v in _eval_ext(o.polynomials, zeta)]
        next_values = _eval_ext(zs.polynomials[:nc], zeta_next)
        ch.observe_extension_elements(zeta_values)
        ch.observe_extension_elements(next_values)
        instance = FriInstanceInfo(
            oracles=[FriOracleInfo(int(o.polynomials.shape[0]), b)
                     for o, b in zip(oracles, co.ORACLE_BLINDING)],
            batches=[
                FriBatchInfo(point=zeta, polynomials=[
                    FriPolynomialInfo(i, k) for i, o in enumerate(oracles)
                    for k in range(int(o.polynomials.shape[0]))]),
                FriBatchInfo(point=zeta_next,
                             polynomials=FriPolynomialInfo.from_range(2, range(nc)))])
        proof = JBatch.prove_openings(instance, oracles, ch, params)
        assert jfp._LAST_PATH == "host"
    w = JWriter()
    for o in (wires, zs, quot):
        w.write_merkle_cap(o.merkle_tree.cap)
    w.write_field_ext_vec(zeta_values)
    w.write_field_ext_vec(next_values)
    w.write_fri_proof(proof)
    return bytes(w.buf)


def test_commit_and_open_is_byte_identical_to_reference(monkeypatch):
    # degree 2^7 at rate 3: the 2^10-point LDE takes the interleaved form;
    # arity bits 4 (one fold into width-32 leaves); the four PLONK oracle
    # roles at one poly count each, so the reference compiles each program
    # once (its disk export cache off: plain jit is the cheaper cold path)
    monkeypatch.setattr(export_cache, "_ENABLED", False)
    config = FriConfig(rate_bits=3, cap_height=4, proof_of_work_bits=8,
                       reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
                       num_query_rounds=4)
    inputs = co.random_inputs(7, counts=(4, 4, 4, 4), seed=2026)
    assert convert.fri_params(config.fri_params(7, False)) == \
        convert.fri_config(config).fri_params(7, False)
    port = co.commit_and_open(inputs, convert.fri_config(config), device="cpu")
    assert tfp._LAST_PATH == "fused"
    assert port == _reference_commit_and_open(inputs, config)
    with tfp.force_host_path():
        assert co.commit_and_open(inputs, convert.fri_config(config), device="cpu") == port
        assert tfp._LAST_PATH == "host"


def test_fused_fri_proof_equals_the_reference_fused_and_the_host_path(monkeypatch):
    """Degree 2^5 at rate 3, two fold steps of arity 4, 6 PoW bits, three
    pending inputs in the challenger: the port's fused fri_proof gives the
    reference's fused bytes and the port's host-path bytes, and the host
    challenger ends where the host path leaves it."""
    monkeypatch.setattr(export_cache, "_ENABLED", False)
    config = FriConfig(rate_bits=3, cap_height=1, proof_of_work_bits=6,
                       reduction_strategy=FriReductionStrategy.ConstantArityBits(2, 1),
                       num_query_rounds=5)
    rng = np.random.default_rng(11)
    values = [rng.integers(0, fs.P, size=(c, 32), dtype=np.uint64) for c in (3, 5)]
    final = rng.integers(0, fs.P, size=(2, 32), dtype=np.uint64)
    prefix = [int(v) for v in rng.integers(0, fs.P, size=11, dtype=np.uint64)]

    params = config.fri_params(5, False)
    assert tuple(params.reduction_arity_bits) == (2, 2)
    ch = JChallenger()
    ch.observe_elements(prefix)
    proof = jfp.fri_proof([JBatch.from_values(v, 3, False, 1).merkle_tree for v in values],
                          (final[0], final[1]), ch, params)
    assert jfp._LAST_PATH == "fused"
    w = JWriter()
    w.write_fri_proof(proof)

    trees = [TBatch.from_values(v, 3, False, 1, device="cpu").merkle_tree for v in values]
    coeffs = (tg.tensor(final[0], "cpu"), tg.tensor(final[1], "cpu"))
    fused, host = TChallenger(), TChallenger()
    fused.observe_elements(prefix)
    host.observe_elements(prefix)
    tparams = convert.fri_config(config).fri_params(5, False)
    out = []
    for challenger, force in ((fused, False), (host, True)):
        with tfp.force_host_path() if force else contextlib.nullcontext():
            proof = tfp.fri_proof(trees, coeffs, challenger, tparams)
        assert tfp._LAST_PATH == ("host" if force else "fused")
        tw = TWriter()
        tw.write_fri_proof(proof)
        out.append(bytes(tw.buf))
    assert out[0] == out[1] == bytes(w.buf)
    assert (fused.sponge_state, fused.input_buffer, fused.output_buffer) == \
        (host.sponge_state, host.input_buffer, host.output_buffer) == \
        (ch.sponge_state, ch.input_buffer, ch.output_buffer)
    assert fused.get_n_challenges(9) == host.get_n_challenges(9)


def test_port_imports_neither_jax_nor_the_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import plonky2_torch\n"
        "for m in pkgutil.walk_packages(plonky2_torch.__path__, 'plonky2_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m.startswith('plonky2_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('plonky2_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_point_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inputs = co.random_inputs(4, counts=(1, 1, 2, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        co.commit_and_open(inputs, co.middle_fri_config())


def test_zero_pow_bits_takes_witness_zero_where_the_reference_finds_none(monkeypatch):
    """proof_of_work_bits = 0 accepts every witness; the port takes the
    lowest, 0. The reference's threshold 1 << (64 - 0) wraps to 0 in uint64,
    so its grind chunk finds no witness (and its search would not end)."""
    import jax.numpy as jnp

    from plonky2_tpu.field import goldilocks as jg
    from plonky2_torch.fri.prover import fri_proof_of_work

    monkeypatch.setattr(export_cache, "_ENABLED", False)
    config = FriConfig(rate_bits=3, cap_height=0, proof_of_work_bits=0,
                       reduction_strategy=FriReductionStrategy.Fixed([]),
                       num_query_rounds=1)
    t = TChallenger()
    t.observe_elements([1, 2, 3])
    state = list(t.sponge_state)
    state[:3] = [1, 2, 3]
    assert fri_proof_of_work(t, convert.fri_config(config), "cpu") == 0
    found, _ = np.asarray(jfp._grind_chunk(jg.to_field(state), 3,
                                           jnp.asarray(np.uint64(0)), 0))
    assert found == 0
