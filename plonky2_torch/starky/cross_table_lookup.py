"""Cross-table lookups (reference starky/src/cross_table_lookup.rs; the
reference package's starky/cross_table_lookup.py).

A CrossTableLookup asserts that the filtered multiset of column
combinations in the looking tables equals the looked table's. Each table
carries, per CTL and challenge, a Z column: the reverse prefix sum of its
helper columns (filter / (Σ β^i c_i + γ), chunked as in logUp). The
verifier checks that the looking tables' Zs at the point 1 (`ctl_zs_first`)
sum to the looked table's.

The prover makes the helper and Z columns on the traces' device: one batch
inverse per column group and the Z column by a flip and a modular prefix
sum (the reference loops over the rows in Python). The multi-table prover
proves every table under one host transcript and keeps the traces and
commitments on the card:

    proofs, ctl_challenges = prove_multi_table(starks, config, traces,
                                               public_inputs, ctls, device=None)
    verify_multi_table(starks, config, proofs, ctls)
    verify_multi_table_circuit(builder, starks, config, proof_targets, ctls,
                               degree_bits_per_table)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.starky.lookup import (
    Filter,
    GrandProductChallenge,
    GrandProductChallengeSet,
    _all_rows,
    eval_helper_columns,
    get_grand_product_challenge_set,
    get_helper_cols,
)


@dataclass
class TableWithColumns:
    table: int  # the table's index in the multi-table system
    columns: list  # [Column]
    filter: Filter


@dataclass
class CrossTableLookup:
    looking_tables: list  # [TableWithColumns]
    looked_table: TableWithColumns


@dataclass
class CtlZData:
    helper_columns: list  # [[n] tensors]
    z: torch.Tensor | None
    challenge: GrandProductChallenge
    columns: list  # per column group, list[Column]
    filter: list  # per column group, Filter


@dataclass
class CtlData:
    zs_columns: list = field(default_factory=list)

    def num_ctl_helper_polys(self) -> list[int]:
        return [len(z.helper_columns) for z in self.zs_columns]

    def ctl_helper_polys(self) -> list:
        return [h for z in self.zs_columns for h in z.helper_columns]

    def ctl_z_polys(self) -> list:
        return [z.z for z in self.zs_columns]


def partial_sums(trace: torch.Tensor, columns_filters: list, challenge,
                 constraint_degree: int) -> list[torch.Tensor]:
    """The helper columns (where there is more than one column group) and
    the Z column, z[i] = Σ_{j >= i} Σ_k h_k[j] (reference
    cross_table_lookup.rs:383-415)."""
    helper_columns = get_helper_cols(trace, columns_filters, challenge, constraint_degree)
    x = helper_columns[0]
    for h in helper_columns[1:]:
        x = g.add(x, h)
    z = g.cumsum(x.flip(0)).flip(0)
    if len(columns_filters) > 1:
        return helper_columns + [z]
    return [z]


def _looking_groups(ctl) -> list[tuple[int, list]]:
    """(table, [(columns, filter)]) of each looking table, in the order of
    first appearance."""
    tables = []
    for t in ctl.looking_tables:
        if t.table not in tables:
            tables.append(t.table)
    return [(table, [(lt.columns, lt.filter) for lt in ctl.looking_tables if lt.table == table])
            for table in tables]


def _ctl_zs(num_tables: int, cross_table_lookups, ctl_challenges, make) -> list:
    """Per table, the CtlData of every CTL and challenge in the reference's
    order: for each CTL and challenge, the looking tables, then the looked
    one. make(table, groups, challenge) -> (helper columns, z)."""
    out = [CtlData() for _ in range(num_tables)]
    for ctl in cross_table_lookups:
        for challenge in ctl_challenges.challenges:
            for table, groups in _looking_groups(ctl):
                helpers, z = make(table, groups, challenge)
                out[table].zs_columns.append(CtlZData(
                    helper_columns=helpers, z=z, challenge=challenge,
                    columns=[gr[0] for gr in groups], filter=[gr[1] for gr in groups]))
            lt = ctl.looked_table  # the looked side never has helper columns
            _, z = make(lt.table, [(lt.columns, lt.filter)], challenge)
            out[lt.table].zs_columns.append(CtlZData(
                helper_columns=[], z=z, challenge=challenge,
                columns=[lt.columns], filter=[lt.filter]))
    return out


def cross_table_lookup_data(trace_per_table: list, cross_table_lookups: list,
                            ctl_challenges, constraint_degree: int) -> list:
    """Per table, its CtlData with the helper and Z columns on the traces'
    device (reference cross_table_lookup.rs:270-341). trace_per_table:
    [cols, n] int64 tensors."""
    def make(table, groups, challenge):
        cols = partial_sums(trace_per_table[table], groups, challenge, constraint_degree)
        return cols[:-1], cols[-1]

    return _ctl_zs(len(trace_per_table), cross_table_lookups, ctl_challenges, make)


def ctl_shape_data(num_tables: int, cross_table_lookups, ctl_challenges,
                   constraint_degree: int) -> list:
    """The CtlData structure (helper counts, challenges, columns, filters)
    without any values: what the verifier needs to slice the openings."""
    chunk = max(constraint_degree - 1, 1)

    def make(table, groups, challenge):
        num_helpers = -(-len(groups) // chunk) if len(groups) > 1 else 0
        return [None] * num_helpers, None

    return _ctl_zs(num_tables, cross_table_lookups, ctl_challenges, make)


def check_constraint_degrees(starks, cross_table_lookups) -> int:
    """The largest constraint degree, with which the CTL data is made.
    Raises ValueError where a table with a helper column has another
    degree: its checks would chunk its column groups otherwise than its
    columns were made (the reference then fails in its checks)."""
    max_degree = max(s.constraint_degree() for s in starks)
    chunk = max(max_degree - 1, 1)
    for ctl in cross_table_lookups:
        for table, groups in _looking_groups(ctl):
            own = max(starks[table].constraint_degree() - 1, 1)
            if len(groups) > 1 and own != chunk:
                raise ValueError(
                    f"table {table} has constraint degree {starks[table].constraint_degree()} "
                    f"and {len(groups)} column groups in one CTL, whose helper columns are "
                    f"made at the system's largest degree {max_degree}")
    return max_degree


def get_ctl_data(config, trace_per_table, cross_table_lookups, challenger,
                 max_constraint_degree: int):
    ctl_challenges = get_grand_product_challenge_set(challenger, config.num_challenges)
    return ctl_challenges, cross_table_lookup_data(
        trace_per_table, cross_table_lookups, ctl_challenges, max_constraint_degree)


def get_ctl_auxiliary_polys(ctl_data: CtlData | None):
    if ctl_data is None:
        return None
    return ctl_data.ctl_helper_polys() + ctl_data.ctl_z_polys()


@dataclass
class CtlCheckVars:
    """One Z column's openings and the data of its checks (values of the
    ops that evaluate them)."""

    helper_columns: list
    local_z: object
    next_z: object
    challenges: GrandProductChallenge
    columns: list
    filter: list

    @staticmethod
    def from_proof(ctl_zs_data, aux_openings, aux_next_openings, num_lookup_columns: int,
                   num_helpers_per_z: list[int]) -> list:
        """A table's auxiliary openings sliced into per-Z check vars: the
        logUp columns, then every helper column, then every Z."""
        out = []
        start = num_lookup_columns
        z_start = num_lookup_columns + sum(num_helpers_per_z)
        for i, zdata in enumerate(ctl_zs_data):
            k = num_helpers_per_z[i]
            out.append(CtlCheckVars(
                helper_columns=aux_openings[start:start + k],
                local_z=aux_openings[z_start + i],
                next_z=aux_next_openings[z_start + i],
                challenges=zdata.challenge,
                columns=zdata.columns,
                filter=zdata.filter,
            ))
            start += k
        return out


def eval_cross_table_lookup_checks(ops, frame, ctl_vars: list, consumer,
                                   constraint_degree: int) -> None:
    """The CTL constraints on any ops (reference
    cross_table_lookup.rs:558-631); the circuit's gates follow this order."""
    local = frame.get_local_values()
    nxt = frame.get_next_values()

    def chal(v):
        # an int on the host and the device; a base Target in a circuit
        if isinstance(v, int):
            return ops.constant(v)
        lift = getattr(ops, "from_base_target", None)
        return lift(v) if lift else v

    for lv in ctl_vars:
        beta = chal(lv.challenges.beta)
        gamma = chal(lv.challenges.gamma)
        evals = [[c.eval(ops, local, nxt) for c in group] for group in lv.columns]

        def combine(group_evals):
            acc = ops.zero()
            for e in reversed(group_evals):
                acc = ops.add(ops.mul(beta, acc), e)
            return ops.add(acc, gamma)

        eval_helper_columns(ops, lv.filter, evals, local, nxt, lv.helper_columns,
                            constraint_degree, (beta, gamma), consumer)

        if lv.helper_columns:
            h_sum = ops.zero()
            for h in lv.helper_columns:
                h_sum = ops.add(h_sum, h)
            consumer.constraint_last_row(ops.sub(lv.local_z, h_sum))
            consumer.constraint_transition(ops.sub(ops.sub(lv.local_z, lv.next_z), h_sum))
        elif len(lv.columns) > 1:
            combin0 = combine(evals[0])
            combin1 = combine(evals[1])
            f0 = lv.filter[0].eval_filter(ops, local, nxt)
            f1 = lv.filter[1].eval_filter(ops, local, nxt)
            prod = ops.mul(combin0, combin1)
            rhs = ops.add(ops.mul(f0, combin1), ops.mul(f1, combin0))
            consumer.constraint_last_row(ops.sub(ops.mul(prod, lv.local_z), rhs))
            consumer.constraint_transition(
                ops.sub(ops.mul(prod, ops.sub(lv.local_z, lv.next_z)), rhs))
        else:
            combin0 = combine(evals[0])
            f0 = lv.filter[0].eval_filter(ops, local, nxt)
            consumer.constraint_last_row(ops.sub(ops.mul(combin0, lv.local_z), f0))
            consumer.constraint_transition(
                ops.sub(ops.mul(combin0, ops.sub(lv.local_z, lv.next_z)), f0))


def _sums(cross_table_lookups, ctl_zs_first: list, num_challenges: int, zero, add, check,
          ctl_extra_looking_sums=None) -> None:
    """For each CTL and challenge, the looking tables' next ctl_zs_first
    summed (plus any extra looking sum) and checked against the looked
    table's next one; every opening is used once."""
    ctl_extra_looking_sums = ctl_extra_looking_sums or {}
    iters = [iter(v) for v in ctl_zs_first]

    def take(table):
        v = next(iters[table], None)
        if v is None:
            raise ValueError(f"too few ctl_zs_first openings of table {table}")
        return v

    for index, ctl in enumerate(cross_table_lookups):
        for c in range(num_challenges):
            looking_sum = zero()
            for table, _ in _looking_groups(ctl):
                looking_sum = add(looking_sum, take(table))
            extra = ctl_extra_looking_sums.get(index)
            if extra is not None:
                looking_sum = add(looking_sum, extra[c])
            check(index, looking_sum, take(ctl.looked_table.table))
    for it in iters:
        if next(it, None) is not None:
            raise ValueError("unconsumed ctl_zs_first openings")


def verify_cross_table_lookups(cross_table_lookups, ctl_zs_first: list, config,
                               ctl_extra_looking_sums=None) -> None:
    """Σ looking ctl_zs_first == looked ctl_zs_first for each CTL and
    challenge (reference cross_table_lookup.rs:852-902); raises ValueError."""
    def check(index, looking, looked):
        if looking != looked:
            raise ValueError(f"Cross-table lookup {index} verification failed.")

    _sums(cross_table_lookups, ctl_zs_first, config.num_challenges, lambda: 0, fs.add, check,
          ctl_extra_looking_sums)


def check_ctls(trace_per_table, cross_table_lookups) -> None:
    """The debug check: the filtered rows of the looking tables and of the
    looked table are equal multisets (reference cross_table_lookup.rs:969+);
    raises AssertionError as the reference does. Traces: [cols, n] u64
    arrays or int64 tensors."""
    def rows(t: TableWithColumns) -> np.ndarray:
        trace = trace_per_table[t.table]
        if not isinstance(trace, torch.Tensor):
            trace = g.tensor(np.asarray(trace, dtype=np.uint64), "cpu")
        ops, local, nxt, all_rows = _all_rows(trace)
        keep = all_rows(t.filter.eval_filter(ops, local, nxt)) != 0
        cols = torch.stack([all_rows(c.eval(ops, local, nxt)) for c in t.columns])
        return g.to_numpy(cols[:, keep])

    def sorted_rows(parts: list) -> np.ndarray:
        m = np.concatenate(parts, axis=1)
        return m[:, np.lexsort(m[::-1])]

    for index, ctl in enumerate(cross_table_lookups):
        looking = sorted_rows([rows(t) for t in ctl.looking_tables])
        looked = sorted_rows([rows(ctl.looked_table)])
        if looking.shape != looked.shape or not (looking == looked).all():
            raise AssertionError(f"CTL {index} multiset mismatch")


# -- proving and verifying the tables together -------------------------------------------
# The reference keeps multi-STARK orchestration out of tree (zkEVM); this is
# the reference package's: one transcript over all tables.

def prove_multi_table(starks, config, traces, public_inputs_per_table, cross_table_lookups,
                      device=None, timing=None):
    """Prove every table under one transcript with its CTLs, on `device`
    (CUDA unless the caller asks for another). traces: [COLUMNS, n] u64
    matrices, or int64 tensors on `device`. Returns (proofs,
    ctl_challenges). timing: a TimingTree whose top-level scopes are
    "compute trace commitments", "compute CTL data" and "table i", each
    table's holding the reference's prover scopes. Under a process group
    each table's batches are committed over the group (as the Starky
    prove's) and the CTL columns are whole on every rank."""
    from plonky2_torch.fri.oracle import PolynomialBatch, _as_tensor
    from plonky2_torch.iop.challenger import Challenger
    from plonky2_torch.starky.prover import prove_with_commitment
    from plonky2_torch.util import TimingTree

    device = parallel.placement(device)[1]
    timing = timing or TimingTree("prove multi table")
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    max_degree = check_constraint_degrees(starks, cross_table_lookups)
    traces = [_as_tensor(t, device) for t in traces]

    challenger = Challenger()
    config.observe(challenger)
    commitments = []
    with timing.scope("compute trace commitments"):
        for pis, trace in zip(public_inputs_per_table, traces):
            challenger.observe_elements(pis)
            c = PolynomialBatch.from_values(trace, rate_bits, False, cap_height)
            challenger.observe_cap(c.merkle_tree.cap)
            commitments.append(c)

    with timing.scope("compute CTL data"):
        ctl_challenges, ctl_data = get_ctl_data(config, traces, cross_table_lookups,
                                                challenger, max_degree)

    proofs = []
    for i, stark in enumerate(starks):
        with timing.scope(f"table {i}"):
            proofs.append(prove_with_commitment(
                stark, config, traces[i], commitments[i], challenger,
                public_inputs_per_table[i], timing,
                ctl_data=ctl_data[i], ctl_challenges=ctl_challenges))
    return proofs, ctl_challenges


def _table_ctl_vars(stark, config, desc, aux, aux_next) -> list:
    return CtlCheckVars.from_proof(desc.zs_columns, aux, aux_next,
                                   stark.num_lookup_helper_columns(config),
                                   [len(z.helper_columns) for z in desc.zs_columns])


def get_multi_proof_challenges(starks, config, proofs, cross_table_lookups):
    """Every challenge of a multi-table proof under the shared transcript
    (reference starky/src/proof.rs MultiProofChallenges; get_challenges.rs
    with the trace caps observed first). Returns (MultiProofChallenges, the
    per-table CtlData shapes that slice each table's openings)."""
    from plonky2_torch.iop.challenger import Challenger
    from plonky2_torch.starky.get_challenges import get_challenges
    from plonky2_torch.starky.proof import MultiProofChallenges

    max_degree = check_constraint_degrees(starks, cross_table_lookups)
    challenger = Challenger()
    config.observe(challenger)
    for pwp in proofs:
        challenger.observe_elements(pwp.public_inputs)
        challenger.observe_cap(pwp.proof.trace_cap)
    ctl_challenges = get_grand_product_challenge_set(challenger, config.num_challenges)
    ctl_desc = ctl_shape_data(len(starks), cross_table_lookups, ctl_challenges, max_degree)

    stark_challenges = [
        get_challenges(stark, pwp, config, challenger=challenger, observe_instance=False,
                       ctl_challenge_set=ctl_challenges, ctl_zs_data=ctl_desc[i].zs_columns,
                       num_ctl_helpers_per_z=ctl_desc[i].num_ctl_helper_polys())
        for i, (stark, pwp) in enumerate(zip(starks, proofs))]
    return (MultiProofChallenges(stark_challenges=stark_challenges,
                                 ctl_challenges=ctl_challenges), ctl_desc)


def verify_multi_table(starks, config, proofs, cross_table_lookups) -> None:
    """Replay the shared transcript, verify each table with its CTL checks,
    then the cross-table sums; raises ValueError where a proof fails."""
    from plonky2_torch.starky.verifier import verify_stark_proof_with_challenges

    multi, ctl_desc = get_multi_proof_challenges(starks, config, proofs, cross_table_lookups)
    ctl_zs_first = []
    for i, (stark, pwp) in enumerate(zip(starks, proofs)):
        o = pwp.proof.openings
        ctl_vars = _table_ctl_vars(stark, config, ctl_desc[i], o.auxiliary_polys or [],
                                   o.auxiliary_polys_next or [])
        verify_stark_proof_with_challenges(stark, pwp.proof, multi.stark_challenges[i],
                                           pwp.public_inputs, config, ctl_vars=ctl_vars)
        ctl_zs_first.append(list(o.ctl_zs_first or []))
    verify_cross_table_lookups(cross_table_lookups, ctl_zs_first, config)


# -- the circuit form --------------------------------------------------------------------

def verify_cross_table_lookups_circuit(builder, cross_table_lookups, ctl_zs_first_t: list,
                                       config) -> None:
    """The circuit dual of verify_cross_table_lookups: Σ looking
    ctl_zs_first == looked ctl_zs_first (reference cross_table_lookup.rs
    verify_cross_table_lookups_circuit)."""
    _sums(cross_table_lookups, ctl_zs_first_t, config.num_challenges, builder.zero,
          builder.add, lambda index, looking, looked: builder.connect(looking, looked))


def verify_multi_table_circuit(builder, starks, config, proof_ts, cross_table_lookups,
                               degree_bits_per_table: list[int]) -> None:
    """Verify every table's STARK proof in one Plonky2 circuit under a
    shared in-circuit transcript and CTL challenges, then the cross-table
    sums: the circuit dual of verify_multi_table."""
    from plonky2_torch.recursion.recursive_challenger import RecursiveChallenger
    from plonky2_torch.starky.recursive_verifier import (
        _get_challenges_target,
        _observe_stark_config,
        verify_stark_proof_with_challenges_circuit,
    )

    max_degree = check_constraint_degrees(starks, cross_table_lookups)
    challenger = RecursiveChallenger(builder)
    _observe_stark_config(builder, challenger, config)
    for pt in proof_ts:
        challenger.observe_elements(pt.public_inputs)
        challenger.observe_cap(pt.proof.trace_cap)
    ctl_challenges = GrandProductChallengeSet(challenges=[
        GrandProductChallenge(challenger.get_challenge(), challenger.get_challenge())
        for _ in range(config.num_challenges)])
    ctl_desc = ctl_shape_data(len(starks), cross_table_lookups, ctl_challenges, max_degree)

    ctl_zs_first_t = []
    for i, (stark, pt) in enumerate(zip(starks, proof_ts)):
        challenges = _get_challenges_target(
            builder, stark, pt, config, degree_bits_per_table[i], challenger=challenger,
            observe_instance=False, ctl_challenge_set=ctl_challenges,
            ctl_zs_data=ctl_desc[i].zs_columns,
            num_ctl_helpers_per_z=ctl_desc[i].num_ctl_helper_polys())
        o = pt.proof.openings
        ctl_vars = _table_ctl_vars(stark, config, ctl_desc[i], o.auxiliary_polys,
                                   o.auxiliary_polys_next)
        verify_stark_proof_with_challenges_circuit(
            builder, stark, pt.proof, pt.public_inputs, challenges, config,
            degree_bits_per_table[i], ctl_vars=ctl_vars)
        ctl_zs_first_t.append(list(o.ctl_zs_first or []))
    verify_cross_table_lookups_circuit(builder, cross_table_lookups, ctl_zs_first_t, config)
