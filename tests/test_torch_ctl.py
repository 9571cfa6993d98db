"""The port's cross-table lookups against the reference package, on the CPU.

The system is `plonky2_torch/examples/multi_table.py`'s three tables
(CpuTable, MemoryTable, StoreTable; two CTLs, table 0 with a logUp lookup
and three column groups in CTL 0) at tests/torch_make_data.py's
CTL_LOG_ROWS, traces from its numpy generator (seed 2026); the reference's
side is its twins in tests/reference_prove_ctl.py, which a test holds to the
port's tables. Module against module on the same inputs: the helper and Z
columns of every table (`cross_table_lookup_data`, at constraint degrees 2
and 3), `ctl_shape_data`, the vanishing polynomial with the CTL checks at
random openings, `check_ctls`, the proofs' `ctl_zs_first` against the
port's Z columns, `get_multi_proof_challenges` and the host verifier on the
reference's proofs (`plonky2_torch/data/ctl_table*.stark_proof.bin`, from
`tests/torch_make_data.py --ctl`), a tampered opening rejected as the
reference rejects it, the refusal of tables whose degrees would chunk
their column groups otherwise than the CTL data, and the builder state of
the circuit that verifies the three proofs (`verify_multi_table_circuit`).
`tests/test_torch_ctl_prove.py` proves the tables and the circuit. Every
comparison is exact.
"""

import copy
import os
import sys

import numpy as np
import pytest

from plonky2_tpu.starky import cross_table_lookup as jctl
from plonky2_tpu.starky import lookup as jlookup
from plonky2_tpu.starky import recursive_verifier as jsrv
from plonky2_tpu.starky import serialization as jser
from plonky2_tpu.starky import vanishing as jvanishing
from plonky2_tpu.starky.proof import StarkOpeningSet as JStarkOpeningSet
from plonky2_torch import convert
from plonky2_torch.examples import multi_table as mt
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.field import scalar as fs
from plonky2_torch.starky import cross_table_lookup as tctl
from plonky2_torch.starky import lookup as tlookup
from plonky2_torch.starky import recursive_verifier as tsrv
from plonky2_torch.starky import serialization as tser
from plonky2_torch.starky import vanishing as tvanishing
from plonky2_torch.starky.config import StarkConfig
from plonky2_torch.starky.fibonacci_stark import FibonacciStark
from plonky2_torch.starky.proof import StarkOpeningSet

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import reference_prove_ctl as rpc  # noqa: E402
from test_torch_recursion import _both, no_commitment  # noqa: E402,F401
from torch_make_data import (  # noqa: E402
    CTL_LOG_ROWS,
    CTL_POW_BITS,
    CTL_QUERIES,
    CTL_STANDALONE_LOG_ROWS,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "plonky2_torch", "data")
CONFIG = rpc.stark_config(CTL_QUERIES, CTL_POW_BITS, StarkConfig)
J_CONFIG = rpc.stark_config(CTL_QUERIES, CTL_POW_BITS)


@pytest.fixture(scope="module")
def system():
    """(port starks, port ctls, reference starks, reference ctls, traces,
    public inputs)."""
    starks, ctls = mt.system()
    jstarks, jctls = rpc.twins()
    traces, pis = mt.generate_traces(CTL_LOG_ROWS)
    return starks, ctls, jstarks, jctls, traces, pis


@pytest.fixture(scope="module")
def proofs(system):
    """The reference's proofs read by the port and by the reference."""
    out = []
    for i in range(3):
        with open(os.path.join(DATA, f"ctl_table{i}.stark_proof.bin"), "rb") as f:
            blob = f.read()
        out.append((tser.stark_proof_from_bytes(blob, CONFIG),
                    jser.stark_proof_from_bytes(blob, J_CONFIG)))
    return out


def _challenges(seed: int, port: bool):
    rng = np.random.default_rng(seed)
    mod = tlookup if port else jlookup
    return mod.GrandProductChallengeSet([
        mod.GrandProductChallenge(*(int(v) for v in rng.integers(0, fs.P, 2, dtype=np.uint64)))
        for _ in range(CONFIG.num_challenges)])


def _ext(rng, n: int) -> list:
    return [tuple(int(v) for v in rng.integers(0, fs.P, 2, dtype=np.uint64)) for _ in range(n)]


# -- the tables -----------------------------------------------------------------------

def test_twins_are_the_port_tables(system):
    starks, ctls, jstarks, jctls, _, _ = system
    for s, j in zip(starks, jstarks):
        assert (s.COLUMNS, s.PUBLIC_INPUTS, s.constraint_degree(), s.requires_ctls(),
                s.uses_lookups()) == (j.COLUMNS, j.PUBLIC_INPUTS, j.constraint_degree(),
                                      j.requires_ctls(), j.uses_lookups())
        assert s.lookups() == [convert.lookup(lk) for lk in j.lookups()]
    assert ctls == [convert.cross_table_lookup(c) for c in jctls]
    assert starks[0].COLUMNS >= 32


def test_check_ctls_as_reference(system):
    starks, ctls, _, jctls, traces, _ = system
    tctl.check_ctls(traces, ctls)
    tctl.check_ctls([tg.tensor(t, "cpu") for t in traces], ctls)
    jctl.check_ctls(traces, jctls)
    bad = mt.shifted_memory(traces)
    with pytest.raises(AssertionError, match="CTL 0 multiset mismatch"):
        tctl.check_ctls(bad, ctls)
    with pytest.raises(AssertionError, match="CTL 0 multiset mismatch"):
        jctl.check_ctls(bad, jctls)


@pytest.mark.parametrize("degree", [2, 3])
def test_ctl_columns_equal_reference(system, degree):
    """Every table's helper and Z columns, in the reference's order; at
    degree 3 table 0's CTL 0 Z has a chunk of two column groups and one of
    one, at degree 2 one helper a group."""
    _, ctls, _, jctls, traces, _ = system
    got = tctl.cross_table_lookup_data([tg.tensor(t, "cpu") for t in traces], ctls,
                                       _challenges(1, True), degree)
    want = jctl.cross_table_lookup_data(traces, jctls, _challenges(1, False), degree)
    shape = tctl.ctl_shape_data(3, ctls, _challenges(1, True), degree)
    for g_data, w_data, s_data in zip(got, want, shape):
        assert len(g_data.zs_columns) == len(w_data.zs_columns) == len(s_data.zs_columns)
        assert g_data.num_ctl_helper_polys() == w_data.num_ctl_helper_polys() \
            == s_data.num_ctl_helper_polys()
        for gz, wz in zip(g_data.zs_columns, w_data.zs_columns):
            assert (gz.challenge.beta, gz.challenge.gamma) == (wz.challenge.beta,
                                                               wz.challenge.gamma)
            assert [tg.to_numpy(h).tolist() for h in gz.helper_columns] == \
                [h.tolist() for h in wz.helper_columns]
            assert tg.to_numpy(gz.z).tolist() == wz.z.tolist()
    assert got[0].num_ctl_helper_polys() == ([2, 2, 0, 0] if degree == 3 else [3, 3, 0, 0])
    assert [len(d.zs_columns) for d in got] == [4, 4, 4]


def test_ctl_zs_first_are_the_z_columns_at_one(system, proofs):
    """Each proof's ctl_zs_first is its Z columns' value at the first row
    (the point 1), under the transcript's CTL challenges."""
    _, ctls, _, _, traces, _ = system
    want = np.load(os.path.join(DATA, "ctl.npz"))["challenges"]
    chals = tlookup.GrandProductChallengeSet(
        [tlookup.GrandProductChallenge(int(b), int(c)) for b, c in want])
    data = tctl.cross_table_lookup_data([tg.tensor(t, "cpu") for t in traces], ctls, chals, 3)
    for d, (port_proof, ref_proof) in zip(data, proofs):
        zs_first = [int(tg.to_numpy(z)[0]) for z in d.ctl_z_polys()]
        assert port_proof.proof.openings.ctl_zs_first == zs_first
        assert ref_proof.proof.openings.ctl_zs_first == zs_first


@pytest.mark.parametrize("table", [0, 1, 2])
def test_vanishing_poly_with_ctl_checks_equals_reference(system, table):
    """The α-combined constraints at random extension openings: the
    table's AIR, its logUp lookup and its CTL checks (`CtlCheckVars`
    sliced from the auxiliary openings)."""
    starks, ctls, jstarks, jctls, _, _ = system
    rng = np.random.default_rng(10 + table)
    stark, jstark = starks[table], jstarks[table]
    tdesc = tctl.ctl_shape_data(3, ctls, _challenges(2, True), 3)[table]
    jdesc = jctl.ctl_shape_data(3, jctls, _challenges(2, False), 3)[table]
    helpers = tdesc.num_ctl_helper_polys()
    num_lookup = stark.num_lookup_helper_columns(CONFIG)
    num_aux = num_lookup + sum(helpers) + len(helpers)
    opening = dict(local_values=_ext(rng, stark.COLUMNS), next_values=_ext(rng, stark.COLUMNS),
                   auxiliary_polys=_ext(rng, num_aux), auxiliary_polys_next=_ext(rng, num_aux),
                   ctl_zs_first=None, quotient_polys=None)
    pis = [int(v) for v in rng.integers(0, fs.P, stark.PUBLIC_INPUTS, dtype=np.uint64)]
    alphas = [int(v) for v in rng.integers(0, fs.P, 2, dtype=np.uint64)]
    zeta = _ext(rng, 1)[0]
    lookup_challenges = ([ch.beta for ch in _challenges(2, True).challenges]
                         if stark.uses_lookups() else None)
    got = tvanishing.compute_eval_vanishing_poly(
        stark, StarkOpeningSet(**opening), pis, alphas, zeta, CTL_LOG_ROWS[table],
        lookup_challenges, num_lookup,
        tctl.CtlCheckVars.from_proof(tdesc.zs_columns, opening["auxiliary_polys"],
                                     opening["auxiliary_polys_next"], num_lookup, helpers))
    want = jvanishing.compute_eval_vanishing_poly(
        jstark, JStarkOpeningSet(**opening), pis, alphas, zeta, CTL_LOG_ROWS[table],
        lookup_challenges, num_lookup,
        jctl.CtlCheckVars.from_proof(jdesc.zs_columns, opening["auxiliary_polys"],
                                     opening["auxiliary_polys_next"], num_lookup, helpers))
    assert got == want


# -- the transcript and the host verifier ---------------------------------------------

def test_multi_proof_challenges_equal_reference(system, proofs):
    starks, ctls, jstarks, jctls, _, _ = system
    got, got_desc = tctl.get_multi_proof_challenges(starks, CONFIG, [p for p, _ in proofs],
                                                    ctls)
    want, want_desc = jctl.get_multi_proof_challenges(jstarks, J_CONFIG,
                                                      [j for _, j in proofs], jctls)
    pairs = [(c.beta, c.gamma) for c in got.ctl_challenges.challenges]
    assert pairs == [(c.beta, c.gamma) for c in want.ctl_challenges.challenges]
    assert pairs == [tuple(int(v) for v in row)
                     for row in np.load(os.path.join(DATA, "ctl.npz"))["challenges"]]
    assert [d.num_ctl_helper_polys() for d in got_desc] == \
        [[len(z.helper_columns) for z in d.zs_columns] for d in want_desc]
    for g_ch, w_ch in zip(got.stark_challenges, want.stark_challenges):
        assert (g_ch.stark_alphas, g_ch.stark_zeta) == (w_ch.stark_alphas, w_ch.stark_zeta)
        assert g_ch.lookup_challenge_set.challenges == [
            tlookup.GrandProductChallenge(c.beta, c.gamma)
            for c in w_ch.lookup_challenge_set.challenges]
        gf, wf = g_ch.fri_challenges, w_ch.fri_challenges
        assert (gf.fri_alpha, gf.fri_betas, gf.fri_pow_response, gf.fri_query_indices) == \
            (wf.fri_alpha, wf.fri_betas, wf.fri_pow_response, wf.fri_query_indices)
    assert len({c.stark_zeta for c in got.stark_challenges}) == 3


def test_host_verifier_accepts_the_reference_proofs(system, proofs):
    starks, ctls, _, _, _, _ = system
    tctl.verify_multi_table(starks, CONFIG, [p for p, _ in proofs], ctls)


@pytest.mark.parametrize("what", ["ctl_zs_first", "sum", "short"])
def test_tampered_proofs_rejected_as_reference(system, proofs, what):
    """A changed ctl_zs_first opening fails table 1's FRI check; ctl_zs_first
    changed where the sums are checked only (after each table's checks)
    fails the CTL sum, in both packages. A proof with one ctl_zs_first
    opening too few fails the port's shape check with a ValueError (the
    reference fails too, with another exception), and too few openings
    given to the sums alone raise a ValueError."""
    starks, ctls, jstarks, jctls, _, _ = system
    port, ref = copy.deepcopy([p for p, _ in proofs]), copy.deepcopy([j for _, j in proofs])
    verdicts = []
    if what == "short":
        for ps in (port, ref):
            ps[1].proof.openings.ctl_zs_first.pop()
        with pytest.raises(ValueError, match="Wrong number of CTL Z openings"):
            tctl.verify_multi_table(starks, CONFIG, port, ctls)
        with pytest.raises(Exception):
            jctl.verify_multi_table(jstarks, J_CONFIG, ref, jctls)
        with pytest.raises(ValueError, match="too few ctl_zs_first openings of table 1"):
            tctl.verify_cross_table_lookups(
                ctls, [p.proof.openings.ctl_zs_first for p in port], CONFIG)
    elif what == "ctl_zs_first":
        for ps in (port, ref):
            ps[1].proof.openings.ctl_zs_first[0] = fs.add(ps[1].proof.openings.ctl_zs_first[0], 1)
        for fn, st, cf, ps, cs in ((tctl.verify_multi_table, starks, CONFIG, port, ctls),
                                   (jctl.verify_multi_table, jstarks, J_CONFIG, ref, jctls)):
            with pytest.raises(Exception) as e:
                fn(st, cf, ps, cs)
            verdicts.append(type(e.value).__name__)
        assert verdicts[0] == verdicts[1] == "ValueError"
    else:
        zs = [list(p.proof.openings.ctl_zs_first) for p in port]
        zs[1][0] = fs.add(zs[1][0], 1)
        for fn, cs, cf in ((tctl.verify_cross_table_lookups, ctls, CONFIG),
                           (jctl.verify_cross_table_lookups, jctls, J_CONFIG)):
            with pytest.raises(ValueError) as e:
                fn(cs, zs, cf)
            verdicts.append(str(e.value))
        assert verdicts[0] == verdicts[1] == "Cross-table lookup 0 verification failed."


def test_extra_looking_sums_as_reference(system, proofs):
    _, ctls, _, jctls, _, _ = system
    zs = [list(p.proof.openings.ctl_zs_first) for p, _ in proofs]
    # move CTL 1's first-challenge sum from table 0's Z into an extra looking sum
    extra = zs[0][2]
    zs[0][2] = 0
    for fn, cs in ((tctl.verify_cross_table_lookups, ctls),
                   (jctl.verify_cross_table_lookups, jctls)):
        fn(cs, zs, CONFIG, ctl_extra_looking_sums={1: [extra, 0]})
        with pytest.raises(ValueError):
            fn(cs, zs, CONFIG)


def test_tables_of_other_degrees_refused(system):
    """Table 0 (three column groups in CTL 0) declared at degree 2 while the
    others stay at 3: the CTL data is made at the largest degree (chunks of
    two), table 0's checks would chunk by one. The reference then fails in
    its checks (an IndexError in eval_helper_columns, here on the binding's
    dummy openings); the port raises a ValueError up front."""
    starks, ctls, jstarks, jctls, traces, pis = system

    class Degree2(mt.CpuTable):
        def constraint_degree(self):
            return 2

    class JDegree2(type(jstarks[0])):
        def constraint_degree(self):
            return 2

    with pytest.raises(ValueError, match="constraint degree 2"):
        tctl.prove_multi_table([Degree2()] + starks[1:], CONFIG, traces, pis, ctls,
                               device="cpu")
    with pytest.raises(ValueError, match="constraint degree 2"):
        tctl.check_constraint_degrees([Degree2()] + starks[1:], ctls)
    desc = jctl.ctl_shape_data(3, jctls, _challenges(3, False), 3)[0]
    helpers = [len(z.helper_columns) for z in desc.zs_columns]
    rng = np.random.default_rng(3)
    num_aux = 2 * 2 + sum(helpers) + len(helpers)
    opening = JStarkOpeningSet(
        local_values=_ext(rng, 35), next_values=_ext(rng, 35),
        auxiliary_polys=_ext(rng, num_aux), auxiliary_polys_next=_ext(rng, num_aux),
        ctl_zs_first=None, quotient_polys=None)
    with pytest.raises(IndexError):
        jvanishing.compute_eval_vanishing_poly(
            JDegree2(), opening, [1], [2, 3], (4, 5), 8, [6, 7], 4,
            jctl.CtlCheckVars.from_proof(desc.zs_columns, opening.auxiliary_polys,
                                         opening.auxiliary_polys_next, 4, helpers))


# -- the circuit ----------------------------------------------------------------------

@pytest.mark.parametrize("tables", [3, 4])
def test_multi_table_circuit_builder_state_equals_reference(system, no_commitment, tables):
    """verify_multi_table_circuit over targets of the three tables' proofs,
    and with a fourth outside every CTL (a Fibonacci table, no auxiliary
    oracle): the same gates, constants, copy constraints, generators and
    targets."""
    starks, ctls, jstarks, jctls, _, _ = system
    log_rows = list(CTL_LOG_ROWS)
    if tables == 4:
        starks = starks + [rpc.standalone_table(CTL_STANDALONE_LOG_ROWS, FibonacciStark)[0]]
        jstarks = jstarks + [rpc.standalone_table(CTL_STANDALONE_LOG_ROWS)[0]]
        log_rows.append(CTL_STANDALONE_LOG_ROWS)
    counts = mt.ctl_target_counts(starks, CONFIG, ctls)

    def make(b, ops):
        port = ops.__name__.startswith("plonky2_torch")
        srv, ctl = (tsrv, tctl) if port else (jsrv, jctl)
        st, cs, config = (starks, ctls, CONFIG) if port else (jstarks, jctls, J_CONFIG)
        pts = [srv.add_virtual_stark_proof_with_pis(b, s, config, bits, num_ctl_helper_zs=h,
                                                    num_ctl_zs=z)
               for s, bits, (h, z) in zip(st, log_rows, counts)]
        ctl.verify_multi_table_circuit(b, st, config, pts, cs, log_rows)
        for pt in pts:
            b.register_public_inputs(pt.public_inputs)
        return [[pt.public_inputs, pt.proof.openings.ctl_zs_first or [], pt.proof.trace_cap]
                for pt in pts]

    _both(make)
