"""The port's Starky prover and verifier against the reference package, on
the CPU.

The port proves FibonacciStark(2^5) and PermutationStark(2^5) to
`fixtures/starky_{fibonacci,permutation}.proof.bin`, and FibonacciStark(2^7)
(one FRI fold step: the fused FRI transcript) and LookupTestStark at 2^5 and
2^7 to the reference's bytes committed in `plonky2_torch/data/` (written by
`tests/torch_make_data.py --starky`), byte for byte; its verifier accepts
each proof and rejects tampered ones; its reader and writer round-trip the
fixtures. Module against module, on inputs drawn with numpy from a seed:
the logUp helper and Z columns, the vanishing polynomial at random
openings, the constraint-binding transcript, the constraint consumer under
`TorchBaseOps` and `HostBaseOps`, each equal to the reference's. Field
elements throughout, so every comparison is exact.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from plonky2_tpu.field import scalar as jfs
from plonky2_tpu.gates import ops as jops
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.starky import config as jconfig
from plonky2_tpu.starky import constraint_consumer as jcc
from plonky2_tpu.starky import evaluation_frame as jframe
from plonky2_tpu.starky import fibonacci_stark as jfib
from plonky2_tpu.starky import lookup as jlookup
from plonky2_tpu.starky import proof as jproof
from plonky2_tpu.starky import test_starks as jtest_starks
from plonky2_tpu.starky import vanishing as jvanishing
from plonky2_torch import convert
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.fri import oracle as toracle
from plonky2_torch.fri import prover as tfp
from plonky2_torch.gates.ops import HostBaseOps, TorchBaseOps
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.starky import lookup as tlookup
from plonky2_torch.starky import prover as tprover
from plonky2_torch.starky import stark_testing
from plonky2_torch.starky import vanishing as tvanishing
from plonky2_torch.starky.config import StarkConfig
from plonky2_torch.starky.constraint_consumer import ConstraintConsumer
from plonky2_torch.starky.evaluation_frame import StarkFrame
from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
from plonky2_torch.starky.get_challenges import bind_constraints
from plonky2_torch.starky.proof import StarkOpeningSet
from plonky2_torch.starky.serialization import stark_proof_from_bytes, stark_proof_to_bytes
from plonky2_torch.starky.test_starks import (
    LookupTestStark,
    PermutationStark,
    UnconstrainedStark,
)
from plonky2_torch.starky.verifier import verify_stark_proof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jfs.P
CONFIG = StarkConfig.standard_fast_config()


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain Poseidon grind runs faster on one intra-op thread while
    other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name: str, log_rows: int):
    """(port stark, trace, public inputs, reference file) of a committed proof."""
    n = 1 << log_rows
    if name == "fibonacci":
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        trace = stark.generate_trace(pis[0], pis[1])
    elif name == "permutation":
        stark = PermutationStark(n)
        pis = [3, 9]  # tools/generate_fixtures.py
        trace = stark.generate_trace(*pis)
    else:
        stark = LookupTestStark(n)
        pis = []
        trace = stark.generate_trace()
    ref = (("fixtures", f"starky_{name}.proof.bin") if log_rows == 5 and name != "lookup"
           else ("plonky2_torch", "data", f"starky_{name}{log_rows}.proof.bin"))
    return stark, trace, pis, ref


CASES = [("fibonacci", 5), ("permutation", 5), ("fibonacci", 7), ("lookup", 5), ("lookup", 7)]
_PROOFS: dict = {}


def _proved(name: str, log_rows: int):
    """(stark, proof, FRI path, reference bytes), each case proved once."""
    key = (name, log_rows)
    if key not in _PROOFS:
        stark, trace, pis, ref = _case(name, log_rows)
        proof = tprover.prove(stark, CONFIG, trace, pis, device="cpu")
        _PROOFS[key] = (stark, proof, tfp._LAST_PATH, _read(*ref))
    return _PROOFS[key]


@pytest.mark.parametrize("name,log_rows", CASES)
def test_prove_gives_the_reference_bytes_and_verifies(name, log_rows):
    stark, proof, path, ref = _proved(name, log_rows)
    assert stark_proof_to_bytes(proof, CONFIG) == ref
    # 2^5 rows have no FRI fold step (host transcript); 2^7 have one (fused)
    assert path == ("host" if log_rows == 5 else "fused")
    verify_stark_proof(stark, proof, CONFIG)


@pytest.mark.parametrize("name,log_rows", CASES)
def test_verifier_rejects_tampered_proofs(name, log_rows):
    stark, proof, _, _ = _proved(name, log_rows)
    tampered = []
    if stark.PUBLIC_INPUTS:
        bad = copy.deepcopy(proof)
        bad.public_inputs[-1] = (bad.public_inputs[-1] + 1) % P
        tampered.append(bad)
    bad = copy.deepcopy(proof)
    v = bad.proof.openings.local_values[0]
    bad.proof.openings.local_values[0] = ((v[0] + 1) % P, v[1])
    tampered.append(bad)
    if stark.uses_lookups():
        bad = copy.deepcopy(proof)
        v = bad.proof.openings.auxiliary_polys[0]
        bad.proof.openings.auxiliary_polys[0] = (jfs.add(v[0], 1), v[1])
        tampered.append(bad)
    for bad in tampered:
        with pytest.raises(ValueError):
            verify_stark_proof(stark, bad, CONFIG)


@pytest.mark.parametrize("name,log_rows", CASES)
def test_reader_round_trips_the_reference_bytes(name, log_rows):
    *_, ref = _case(name, log_rows)
    blob = _read(*ref)
    pwp = stark_proof_from_bytes(blob, CONFIG)
    assert stark_proof_to_bytes(pwp, CONFIG) == blob
    with pytest.raises(ValueError):
        stark_proof_from_bytes(blob + b"\0", CONFIG)


def test_unconstrained_stark_proves_a_trace_above_2_63():
    """The trace moves to int64 by its bit pattern: values >= 2^63 survive."""
    stark = UnconstrainedStark(1 << 5)
    trace = stark.generate_trace()
    assert (trace >= np.uint64(1 << 63)).any()
    on_cpu = toracle._as_tensor(trace, "cpu")
    assert (tg.to_numpy(on_cpu) == trace).all()
    with pytest.raises(ValueError):  # a tensor is never moved across devices
        toracle._as_tensor(on_cpu, "cuda")
    proof = tprover.prove(stark, CONFIG, trace, [], device="cpu")
    verify_stark_proof(stark, proof, CONFIG)
    assert proof.proof.openings.quotient_polys is not None


def test_config_converts_and_observes_like_the_reference():
    ref = jconfig.StarkConfig.standard_fast_config()
    assert convert.stark_config(ref) == CONFIG
    jc, tc = JChallenger(), Challenger()
    ref.observe(jc)
    CONFIG.observe(tc)
    assert jc.get_n_challenges(3) == tc.get_n_challenges(3)
    assert CONFIG.fri_params(20).reduction_arity_bits == (4, 4, 4, 4)


# -- module against module -------------------------------------------------------

def _reference_lookups():
    """Lookups that reach every branch: LookupTestStark's, and one with two
    looking columns (one chunk of two at degree 3), a next-row reference, a
    constant and a filter product."""
    jl = jlookup
    wide = jl.Lookup(
        columns=[jl.Column.linear_combination_with_constant([(0, 3), (2, P - 1)], 5),
                 jl.Column(next_row_linear_combination=[(1, 1)])],
        table_column=jl.Column.single(1),
        frequencies_column=jl.Column.single(2),
        filter_columns=[jl.Filter.default(),
                        jl.Filter(products=[(jl.Column.single(0), jl.Column.single(2))],
                                  constants=[jl.Column.one()])],
    )
    return jtest_starks.LookupTestStark(8).lookups() + [wide]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("constraint_degree", [2, 3])
def test_lookup_helper_columns_match_the_reference(which, constraint_degree):
    rng = np.random.default_rng(9 + which)
    trace = rng.integers(0, P, size=(3, 1 << 8), dtype=np.uint64)
    challenge = int(rng.integers(0, P, dtype=np.uint64))
    ref_lookup = _reference_lookups()[which]
    want = jlookup.lookup_helper_columns(ref_lookup, trace, challenge, constraint_degree)
    got = tlookup.lookup_helper_columns(convert.lookup(ref_lookup), tg.tensor(trace, "cpu"),
                                        challenge, constraint_degree)
    assert len(got) == len(want) == ref_lookup.num_helper_columns(constraint_degree)
    for a, b in zip(got, want):
        assert (tg.to_numpy(a) == b).all()


def test_lookup_denominator_hitting_the_challenge_raises_like_the_reference():
    trace = np.stack([np.arange(8, dtype=np.uint64)] * 3)
    challenge = P - 5  # row 5 of the looking column: 5 + challenge = 0
    ref_lookup = _reference_lookups()[0]
    with pytest.raises(ZeroDivisionError):
        jlookup.lookup_helper_columns(ref_lookup, trace, challenge, 3)
    with pytest.raises(ZeroDivisionError):
        tlookup.lookup_helper_columns(convert.lookup(ref_lookup), tg.tensor(trace, "cpu"),
                                      challenge, 3)


def test_cumsum_is_the_sequential_prefix_sum():
    rng = np.random.default_rng(4)
    x = rng.integers(P - 1000, P, size=(2, 1 << 12), dtype=np.uint64)
    x[0, :7] = [0, 1, P - 1, P - 2, 1 << 63, (1 << 32) - 1, 1 << 32]
    want = np.cumsum(x.astype(object), axis=1) % P
    assert (tg.to_numpy(tg.cumsum(tg.tensor(x, "cpu"), 1)) == want.astype(np.uint64)).all()


STARKS = [("fibonacci", FibonacciStark, jfib.FibonacciStark),
          ("permutation", PermutationStark, jtest_starks.PermutationStark),
          ("lookup", LookupTestStark, jtest_starks.LookupTestStark)]


def _rnd_ext(rng):
    return tuple(int(v) for v in rng.integers(0, P, 2, dtype=np.uint64))


@pytest.mark.parametrize("name,port_cls,ref_cls", STARKS)
def test_vanishing_poly_at_random_openings_matches_the_reference(name, port_cls, ref_cls):
    rng = np.random.default_rng(11)
    port, ref = port_cls(1 << 6), ref_cls(1 << 6)
    num_aux = port.num_lookup_helper_columns(CONFIG)
    opening = dict(local_values=[_rnd_ext(rng) for _ in range(port.COLUMNS)],
                   next_values=[_rnd_ext(rng) for _ in range(port.COLUMNS)],
                   auxiliary_polys=[_rnd_ext(rng) for _ in range(num_aux)] or None,
                   auxiliary_polys_next=[_rnd_ext(rng) for _ in range(num_aux)] or None,
                   ctl_zs_first=None, quotient_polys=None)
    pis = [int(v) for v in rng.integers(0, P, port.PUBLIC_INPUTS, dtype=np.uint64)]
    alphas = [int(v) for v in rng.integers(0, P, 2, dtype=np.uint64)]
    zeta = _rnd_ext(rng)
    lookup_challenges = ([int(v) for v in rng.integers(0, P, 2, dtype=np.uint64)]
                         if port.uses_lookups() else None)
    got = tvanishing.compute_eval_vanishing_poly(port, StarkOpeningSet(**opening), pis, alphas, zeta, 6,
                                      lookup_challenges, num_aux)
    want = jvanishing.compute_eval_vanishing_poly(
        ref, jproof.StarkOpeningSet(**opening), pis, alphas, zeta, 6,
        lookup_challenges=lookup_challenges, num_lookup_columns=num_aux)
    assert got == list(want)
    assert tvanishing.eval_l_0_and_l_last(6, zeta) == jvanishing.eval_l_0_and_l_last(6, zeta)


@pytest.mark.parametrize("name,port_cls,ref_cls", STARKS)
def test_constraint_binding_transcript_matches_the_reference(name, port_cls, ref_cls):
    """bind_constraints draws the dummy openings, observes their vanishing
    values and draws the alphas as the reference prover does
    (plonky2_tpu/starky/prover.py:121-149)."""
    port, ref = port_cls(1 << 6), ref_cls(1 << 6)
    rng = np.random.default_rng(12)
    prefix = [int(v) for v in rng.integers(0, P, 7, dtype=np.uint64)]
    pis = [int(v) for v in rng.integers(0, P, port.PUBLIC_INPUTS, dtype=np.uint64)]
    num_aux = port.num_lookup_helper_columns(CONFIG)
    lookup_challenges = [5, 6] if port.uses_lookups() else None
    tc, jc = Challenger(), JChallenger()
    tc.observe_elements(prefix)
    jc.observe_elements(prefix)
    got = bind_constraints(tc, port, CONFIG, pis, 6, num_aux, lookup_challenges)

    jcfg = jconfig.StarkConfig.standard_fast_config()
    alphas_prime = jc.get_n_challenges(2)
    evals = jvanishing.get_dummy_polys(jc, ref.COLUMNS, num_aux,
                                       max(2, ref.constraint_degree() + 1))
    zeta_prime = jc.get_extension_challenge(2)
    jc.observe_extension_elements(jvanishing.compute_eval_vanishing_poly(
        ref, evals, pis, alphas_prime, zeta_prime, 6, lookup_challenges=lookup_challenges,
        num_lookup_columns=ref.num_lookup_helper_columns(jcfg)))
    assert got == jc.get_n_challenges(2)
    assert tc.get_n_challenges(4) == jc.get_n_challenges(4)


@pytest.mark.parametrize("name,port_cls,ref_cls", STARKS)
def test_consumer_accumulators_torch_ops_equal_the_reference_host_ops(name, port_cls,
                                                                       ref_cls):
    """The prover's batched evaluation (TorchBaseOps over 64 points) equals
    the reference's HostBaseOps at each point, and the port's HostBaseOps
    equals it too."""
    port, ref = port_cls(1 << 6), ref_cls(1 << 6)
    rng = np.random.default_rng(13)
    m = 64
    local = rng.integers(0, P, size=(port.COLUMNS, m), dtype=np.uint64)
    nxt = rng.integers(0, P, size=(port.COLUMNS, m), dtype=np.uint64)
    sel = rng.integers(0, P, size=(3, m), dtype=np.uint64)  # z_last, l_first, l_last
    pis = [int(v) for v in rng.integers(0, P, port.PUBLIC_INPUTS, dtype=np.uint64)]
    alphas = [int(v) for v in rng.integers(0, P, 2, dtype=np.uint64)]

    ops = TorchBaseOps("cpu")
    consumer = ConstraintConsumer(ops, [tg.scalar_tensor(a, "cpu") for a in alphas],
                                  *(tg.tensor(s, "cpu") for s in sel))
    port.eval(ops, StarkFrame(list(tg.tensor(local, "cpu")), list(tg.tensor(nxt, "cpu")),
                              [tg.scalar_tensor(p, "cpu") for p in pis]), consumer)
    got = [np.broadcast_to(tg.to_numpy(a), (m,)) for a in consumer.accumulators()]

    for j in range(m):
        for host_ops, cc, frame_cls, stark in ((jops.HostBaseOps(), jcc.ConstraintConsumer,
                                                jframe.StarkFrame, ref),
                                               (HostBaseOps(), ConstraintConsumer,
                                                StarkFrame, port)):
            c = cc(host_ops, alphas, *(int(s[j]) for s in sel))
            stark.eval(host_ops, frame_cls([int(v) for v in local[:, j]],
                                           [int(v) for v in nxt[:, j]], pis), c)
            assert [int(a[j]) for a in got] == c.accumulators()


def test_host_base_ops_match_the_reference():
    rng = np.random.default_rng(14)
    xs = [int(v) for v in rng.integers(0, P, 16, dtype=np.uint64)] + [0, 1, P - 1]
    t, j = HostBaseOps(), jops.HostBaseOps()
    assert (t.zero(), t.one(), t.constant(-3)) == (j.zero(), j.one(), j.constant(-3))
    for a, b in zip(xs, xs[1:] + xs[:1]):
        for op in ("add", "sub", "mul"):
            assert getattr(t, op)(a, b) == getattr(j, op)(a, b)
        for op in ("square", "neg"):
            assert getattr(t, op)(a) == getattr(j, op)(a)
        assert t.add_const(a, b - P) == j.add_const(a, b - P)
        assert t.mul_const(b - P, a) == j.mul_const(b - P, a)


# -- the test kit and the entry point ----------------------------------------------

def test_stark_testing_kit():
    for stark in (FibonacciStark(1 << 3), PermutationStark(1 << 3)):
        stark_testing.test_stark_low_degree(stark, device="cpu")
    fib = FibonacciStark(1 << 5)
    pis = [0, 1, fibonacci(31, 0, 1)]
    stark_testing.test_stark_constraints_on_trace(fib, fib.generate_trace(0, 1), pis)
    with pytest.raises(AssertionError):
        stark_testing.test_stark_constraints_on_trace(fib, fib.generate_trace(0, 2), pis)
    stark_testing.test_stark_circuit_constraints(FibonacciStark(1 << 3), device="cpu")


def test_traces_match_the_reference():
    for port, ref, args in ((FibonacciStark(1 << 6), jfib.FibonacciStark(1 << 6), (2, 7)),
                            (PermutationStark(1 << 6), jtest_starks.PermutationStark(1 << 6),
                             (3, P - 1)),
                            (LookupTestStark(1 << 6), jtest_starks.LookupTestStark(1 << 6), ())):
        assert (port.generate_trace(*args) == ref.generate_trace(*args)).all()
    assert fibonacci(100, 0, 1) == jfib.fibonacci(100, 0, 1)


def test_entry_point_refuses_what_it_does_not_do():
    stark, trace, pis, _ = _case("fibonacci", 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tprover.prove(stark, CONFIG, trace, pis)
    # the unified shape of a variable-degree recursion circuit (max 2^10):
    # the reference's bytes (tests/torch_make_data.py --stark-recursion)
    small = dataclasses.replace(CONFIG, fri_config=dataclasses.replace(CONFIG.fri_config,
                                                                       num_query_rounds=1))
    proof = tprover.prove(stark, small, trace, pis, device="cpu",
                          verifier_circuit_fri_params=small.fri_params(10))
    with open(os.path.join(ROOT, "plonky2_torch", "data", "stark_var10_5.stark_proof.bin"),
              "rb") as f:
        assert stark_proof_to_bytes(proof, small) == f.read()
    # cross-table lookups whose column groups the CTL data would chunk
    # otherwise than a table's own checks: refused before any work
    from plonky2_torch.examples import multi_table as mt
    from plonky2_torch.starky.cross_table_lookup import prove_multi_table

    class Degree2(mt.CpuTable):
        def constraint_degree(self):
            return 2

    starks, ctls = mt.system()
    with pytest.raises(ValueError, match="constraint degree 2"):
        prove_multi_table([Degree2()] + starks[1:], CONFIG, [None] * 3, [[1], [], []], ctls,
                          device="cpu")
