"""logUp lookups for Starky (reference starky/src/lookup.rs; the reference
package's starky/lookup.py).

`Column` and `Filter` form a linear-combination DSL over trace cells, next
row included; a `Lookup` ties looking columns to a table column with a
frequencies column. For each challenge χ the helper columns hold batched
sums of filter / (column + χ), and the Z column accumulates
Σ h_i - m / (t + χ) down the rows, which must telescope to zero.

The prover computes the helper and Z columns on the trace's device: a batch
inverse per denominator column and the Z column as a modular prefix sum
(the reference loops over the rows in Python). `get_helper_cols` and
`eval_helper_columns` are the column-group helpers that the cross-table
lookups share (`cross_table_lookup.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.ops import TorchBaseOps


@dataclass
class Column:
    linear_combination: list = field(default_factory=list)  # [(col, coeff)]
    next_row_linear_combination: list = field(default_factory=list)
    constant: int = 0

    @staticmethod
    def single(c: int) -> "Column":
        return Column(linear_combination=[(c, 1)])

    @staticmethod
    def singles(cs) -> list:
        return [Column.single(c) for c in cs]

    @staticmethod
    def single_next_row(c: int) -> "Column":
        return Column(next_row_linear_combination=[(c, 1)])

    @staticmethod
    def constant_col(k: int) -> "Column":
        return Column(constant=k % fs.P)

    @staticmethod
    def zero() -> "Column":
        return Column.constant_col(0)

    @staticmethod
    def one() -> "Column":
        return Column.constant_col(1)

    @staticmethod
    def linear_combination_with_constant(pairs, constant: int) -> "Column":
        return Column(linear_combination=list(pairs), constant=constant % fs.P)

    def eval(self, ops, local, nxt):
        """ops-domain evaluation at a row."""
        acc = ops.constant(self.constant)
        for c, coeff in self.linear_combination:
            acc = ops.add(acc, ops.mul_const(coeff, local[c]))
        for c, coeff in self.next_row_linear_combination:
            acc = ops.add(acc, ops.mul_const(coeff, nxt[c]))
        return acc


@dataclass
class Filter:
    products: list = field(default_factory=list)  # [(Column, Column)]
    constants: list = field(default_factory=list)  # [Column]

    @staticmethod
    def default() -> "Filter":
        return Filter(constants=[Column.one()])

    @staticmethod
    def new_simple(col: Column) -> "Filter":
        return Filter(constants=[col])

    def eval_filter(self, ops, local, nxt):
        acc = ops.zero()
        for a, b in self.products:
            acc = ops.add(acc, ops.mul(a.eval(ops, local, nxt), b.eval(ops, local, nxt)))
        for c in self.constants:
            acc = ops.add(acc, c.eval(ops, local, nxt))
        return acc


@dataclass
class Lookup:
    columns: list  # [Column]
    table_column: Column
    frequencies_column: Column
    filter_columns: list  # [Filter]

    def num_helper_columns(self, constraint_degree: int) -> int:
        chunk = max(constraint_degree - 1, 1)
        return -(-len(self.columns) // chunk) + 1


@dataclass(frozen=True)
class GrandProductChallenge:
    beta: int
    gamma: int


@dataclass
class GrandProductChallengeSet:
    challenges: list


def get_grand_product_challenge(challenger) -> GrandProductChallenge:
    return GrandProductChallenge(challenger.get_challenge(), challenger.get_challenge())


def get_grand_product_challenge_set(challenger, num_challenges: int) -> GrandProductChallengeSet:
    return GrandProductChallengeSet(
        [get_grand_product_challenge(challenger) for _ in range(num_challenges)]
    )


def _inverse_or_raise(x: torch.Tensor, error=ZeroDivisionError,
                      message: str = "lookup denominator hit challenge") -> torch.Tensor:
    """1 / x of an [n] column; raises `error` as the reference does where a
    denominator is zero (one host read)."""
    if bool((x == 0).any()):
        raise error(message)
    return g.inverse_vector(x)


def _all_rows(trace: torch.Tensor):
    """(ops, local, next, broadcast) to evaluate columns over every row of a
    [cols, n] trace on its device; a constant column evaluates to a 0-d
    tensor, which `broadcast` widens to [n]."""
    n = trace.shape[1]
    return (TorchBaseOps(trace.device), list(trace), [torch.roll(r, -1) for r in trace],
            lambda v: torch.broadcast_to(v, (n,)))


def get_helper_cols(trace: torch.Tensor, columns_filters: list, challenge,
                    constraint_degree: int) -> list[torch.Tensor]:
    """The helper columns of column groups (reference lookup.rs
    get_helper_cols): chunks of `constraint_degree - 1` groups, each group
    combined as Σ β^i c_i + γ, each helper the sum over its chunk of
    filter / combination; [n] tensors on the trace's device.
    columns_filters: [(list[Column], Filter)]."""
    chunk_size = max(constraint_degree - 1, 1)
    ops, local, nxt, all_rows = _all_rows(trace)
    gamma = g.scalar_tensor(challenge.gamma, trace.device)
    combined, filters = [], []
    for cols, filt in columns_filters:
        acc = torch.zeros(trace.shape[1], dtype=torch.int64, device=trace.device)
        b_pow = 1
        for col in cols:
            acc = g.add(acc, g.mul_scalar(all_rows(col.eval(ops, local, nxt)), b_pow))
            b_pow = fs.mul(b_pow, challenge.beta)
        combined.append(g.add(acc, gamma))
        filters.append(all_rows(filt.eval_filter(ops, local, nxt)))
    helper_columns = []
    for start in range(0, len(combined), chunk_size):
        h = torch.zeros(trace.shape[1], dtype=torch.int64, device=trace.device)
        for i in range(start, min(start + chunk_size, len(combined))):
            inv = _inverse_or_raise(combined[i], AssertionError, "combine hit zero denominator")
            h = g.add(h, g.mul(filters[i], inv))
        helper_columns.append(h)
    return helper_columns


def eval_helper_columns(ops, filters, column_groups, local, nxt, helper_columns,
                        constraint_degree: int, challenge, consumer) -> None:
    """The helper columns' checks, shared by the CTLs' ops forms (reference
    lookup.rs eval_helper_columns). column_groups: per group, its columns
    already evaluated on `ops`; challenge: (β, γ) on `ops`."""
    if not helper_columns:
        return
    beta, gamma = challenge
    chunk_size = max(constraint_degree - 1, 1)

    def combine(evals):
        acc = ops.zero()
        for e in reversed(evals):
            acc = ops.add(ops.mul(beta, acc), e)
        return ops.add(acc, gamma)

    for ci, start in enumerate(range(0, len(column_groups), chunk_size)):
        chunk = column_groups[start:start + chunk_size]
        fil = filters[start:start + chunk_size]
        h = helper_columns[ci]
        if len(chunk) == 2:
            combin0 = combine(chunk[0])
            combin1 = combine(chunk[1])
            f0 = fil[0].eval_filter(ops, local, nxt)
            f1 = fil[1].eval_filter(ops, local, nxt)
            consumer.constraint(ops.sub(
                ops.mul(ops.mul(combin1, combin0), h),
                ops.add(ops.mul(f0, combin1), ops.mul(f1, combin0)),
            ))
        elif len(chunk) == 1:
            combin = combine(chunk[0])
            f0 = fil[0].eval_filter(ops, local, nxt)
            consumer.constraint(ops.sub(ops.mul(combin, h), f0))
        else:
            raise NotImplementedError("chunk sizes > 2")


def lookup_helper_columns(lookup: Lookup, trace: torch.Tensor, challenge: int,
                          constraint_degree: int) -> list[torch.Tensor]:
    """The helper columns and the Z column of one lookup under one challenge,
    [n] tensors on the trace's device (reference lookup.rs:579-656).
    trace: [cols, n] int64 tensor."""
    if len(lookup.columns) != len(lookup.filter_columns):
        raise ValueError("a lookup needs one filter per looking column")
    chunk_size = max(constraint_degree - 1, 1)
    ops, local, nxt, all_rows = _all_rows(trace)
    ch = g.scalar_tensor(challenge, trace.device)
    cols = [all_rows(c.eval(ops, local, nxt)) for c in lookup.columns]
    filters = [all_rows(f.eval_filter(ops, local, nxt)) for f in lookup.filter_columns]
    helper_columns = []
    for start in range(0, len(cols), chunk_size):
        h = torch.zeros(trace.shape[1], dtype=torch.int64, device=trace.device)
        for i in range(start, min(start + chunk_size, len(cols))):
            h = g.add(h, g.mul(filters[i], _inverse_or_raise(g.add(cols[i], ch))))
        helper_columns.append(h)

    table_inv = _inverse_or_raise(
        all_rows(g.add(lookup.table_column.eval(ops, local, nxt), ch)))
    freq = all_rows(lookup.frequencies_column.eval(ops, local, nxt))
    # Z(g^0) = 0, Z(g^(i+1)) = Σ_{j <= i} (Σ_k h_k[j] - freq[j] / (table[j] + χ))
    x = g.neg(g.mul(freq, table_inv))
    for h in helper_columns:
        x = g.add(x, h)
    z = torch.cat([torch.zeros_like(x[:1]), g.cumsum(x[:-1])])
    return helper_columns + [z]


class LookupCheckVars:
    def __init__(self, local_values, next_values, challenges):
        self.local_values = local_values
        self.next_values = next_values
        self.challenges = challenges


def eval_lookups(ops, stark, frame, lookup_vars: LookupCheckVars, consumer) -> None:
    """ops-generic lookup constraints (reference eval_packed_lookups_generic,
    lookup.rs:804-864), shared by the verifier, the prover's quotient and
    the circuit."""
    local = frame.get_local_values()
    nxt = frame.get_next_values()
    degree = stark.constraint_degree()
    chunk_size = max(degree - 1, 1)
    start = 0
    for lookup in stark.lookups():
        num_helpers = lookup.num_helper_columns(degree)
        for ch in lookup_vars.challenges:
            helpers = lookup_vars.local_values[start:start + num_helpers - 1]
            # the helper columns' checks
            for ci, hstart in enumerate(range(0, len(lookup.columns), chunk_size)):
                chunk = lookup.columns[hstart:hstart + chunk_size]
                fil = lookup.filter_columns[hstart:hstart + chunk_size]
                h = helpers[ci]
                if len(chunk) == 2:
                    combin0 = ops.add(chunk[0].eval(ops, local, nxt), ch)
                    combin1 = ops.add(chunk[1].eval(ops, local, nxt), ch)
                    f0 = fil[0].eval_filter(ops, local, nxt)
                    f1 = fil[1].eval_filter(ops, local, nxt)
                    t = ops.sub(
                        ops.mul(ops.mul(combin1, combin0), h),
                        ops.add(ops.mul(f0, combin1), ops.mul(f1, combin0)),
                    )
                    consumer.constraint(t)
                elif len(chunk) == 1:
                    combin = ops.add(chunk[0].eval(ops, local, nxt), ch)
                    f0 = fil[0].eval_filter(ops, local, nxt)
                    consumer.constraint(ops.sub(ops.mul(combin, h), f0))
                else:
                    raise NotImplementedError("chunk sizes > 2")

            # the Z column's check
            z = lookup_vars.local_values[start + num_helpers - 1]
            next_z = lookup_vars.next_values[start + num_helpers - 1]
            table_with_ch = ops.add(lookup.table_column.eval(ops, local, nxt), ch)
            hsum = ops.zero()
            for h in helpers:
                hsum = ops.add(hsum, h)
            y = ops.sub(ops.mul(hsum, table_with_ch),
                        lookup.frequencies_column.eval(ops, local, nxt))
            consumer.constraint_first_row(z)
            consumer.constraint(ops.sub(ops.mul(ops.sub(next_z, z), table_with_ch), y))
            start += num_helpers
