"""Three STARK tables linked by cross-table lookups, proved under one
transcript and verified on the host and in one Plonky2 circuit.

The system is a small zkVM's shape: a wide CPU table that reads and
writes a memory table and a store, a memory table, and a store table.

  table 0  CpuTable, 35 columns: four 0/1 selectors (at most one set a
           row), three (address, value) pairs that it sends to memory
           and a (key, word) pair that it sends to the store, a column
           range-checked by a logUp lookup into a table column with its
           frequencies, and sixteen free columns that drive four
           degree-3 transitions d' = u0·u1·u2 + u3; public input: d0 at
           the first row.
  table 1  MemoryTable, 11 columns: the memory rows under a 0/1 filter
           (the looked side of CTL 0) and a (key, word) pair it sends to
           the store under a second 0/1 filter; one degree-3 transition.
  table 2  StoreTable, 11 columns: an (address, value) pair it sends to
           memory, the store rows under a 0/1 filter (the looked side of
           CTL 1); one degree-3 transition.

  CTL 0: table 0's three pairs and table 2's pair, each under its own
         selector, looked up in table 1's filtered rows;
  CTL 1: table 0's (key, word) pair and table 1's, looked up in table 2.

Every table has constraint degree 3, so with the CTL data's chunk of two
column groups table 0's CTL 0 Z takes two helper columns (one chunk of
two groups and one of one). Traces come from one numpy generator:

    starks, ctls = system()
    traces, public_inputs = generate_traces((20, 18, 16), seed=2026)
    proofs, challenges = prove_multi_table(starks, config, traces, public_inputs, ctls,
                                           device="cuda")
    verify_multi_table(starks, config, proofs, ctls)
    data, pts = wrap_circuit(starks, config, proofs_degree_bits, ctls, circuit_config)
    data.prove(wrap_inputs(pts, proofs))

(`prove_multi_table` and `verify_multi_table` are
`starky.cross_table_lookup`'s.) chip_smoke runs it at 2^20, 2^18 and 2^16
rows under `StarkConfig.standard_fast_config()`.
"""

from __future__ import annotations

import numpy as np

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.starky.cross_table_lookup import CrossTableLookup, TableWithColumns
from plonky2_torch.starky.lookup import Column, Filter, Lookup
from plonky2_torch.starky.stark import Stark

LOG_ROWS = (20, 18, 16)


def _transition(ops, local, nxt, u: int, d: int, consumer) -> None:
    """d' = u0 · u1 · u2 + u3 over columns u..u+3 (degree 3)."""
    prod = ops.mul(ops.mul(local[u], local[u + 1]), local[u + 2])
    consumer.constraint_transition(ops.sub(nxt[d], ops.add(prod, local[u + 3])))


def _boolean(ops, x, consumer) -> None:
    consumer.constraint(ops.mul(x, ops.sub(x, ops.one())))


class CpuTable(Stark):
    COLUMNS = 35
    PUBLIC_INPUTS = 1
    SELECTORS = (0, 1, 2, 3)
    PAIRS = ((4, 5), (6, 7), (8, 9))  # sent to memory under selectors 0, 1, 2
    KEY_WORD = (10, 11)  # sent to the store under selector 3
    RANGE, TABLE, FREQ = 12, 13, 14
    FREE = 15  # 16 free columns
    DERIVED = 31  # 4 derived columns

    def eval(self, ops, frame, consumer) -> None:
        local = frame.get_local_values()
        nxt = frame.get_next_values()
        pis = frame.get_public_inputs()
        total = ops.zero()
        for s in self.SELECTORS:
            _boolean(ops, local[s], consumer)
            total = ops.add(total, local[s])
        _boolean(ops, total, consumer)
        for j in range(4):
            _transition(ops, local, nxt, self.FREE + 4 * j, self.DERIVED + j, consumer)
        consumer.constraint_first_row(ops.sub(local[self.DERIVED], pis[0]))

    def constraint_degree(self) -> int:
        return 3

    def requires_ctls(self) -> bool:
        return True

    def lookups(self) -> list:
        return [Lookup(columns=[Column.single(self.RANGE)],
                       table_column=Column.single(self.TABLE),
                       frequencies_column=Column.single(self.FREQ),
                       filter_columns=[Filter.default()])]


class MemoryTable(Stark):
    COLUMNS = 11
    PUBLIC_INPUTS = 0
    FILTER, ADDR, VAL = 0, 1, 2  # the looked side of CTL 0
    SEND, KEY, WORD = 3, 4, 5  # sent to the store
    FREE, DERIVED = 6, 10

    def eval(self, ops, frame, consumer) -> None:
        local = frame.get_local_values()
        nxt = frame.get_next_values()
        _boolean(ops, local[self.FILTER], consumer)
        _boolean(ops, local[self.SEND], consumer)
        _transition(ops, local, nxt, self.FREE, self.DERIVED, consumer)

    def constraint_degree(self) -> int:
        return 3

    def requires_ctls(self) -> bool:
        return True


class StoreTable(Stark):
    COLUMNS = 11
    PUBLIC_INPUTS = 0
    SEND, ADDR, VAL = 0, 1, 2  # sent to memory
    FILTER, KEY, WORD = 3, 4, 5  # the looked side of CTL 1
    FREE, DERIVED = 6, 10

    def eval(self, ops, frame, consumer) -> None:
        local = frame.get_local_values()
        nxt = frame.get_next_values()
        _boolean(ops, local[self.SEND], consumer)
        _boolean(ops, local[self.FILTER], consumer)
        _transition(ops, local, nxt, self.FREE, self.DERIVED, consumer)

    def constraint_degree(self) -> int:
        return 3

    def requires_ctls(self) -> bool:
        return True


def _group(table: int, columns, selector: int) -> TableWithColumns:
    return TableWithColumns(table, Column.singles(columns),
                            Filter.new_simple(Column.single(selector)))


def system() -> tuple[list, list]:
    """(starks, cross-table lookups) of the three tables."""
    cpu, mem, store = CpuTable, MemoryTable, StoreTable
    ctl0 = CrossTableLookup(
        looking_tables=[_group(0, pair, s) for pair, s in zip(cpu.PAIRS, cpu.SELECTORS)]
        + [_group(2, (store.ADDR, store.VAL), store.SEND)],
        looked_table=_group(1, (mem.ADDR, mem.VAL), mem.FILTER))
    ctl1 = CrossTableLookup(
        looking_tables=[_group(0, cpu.KEY_WORD, cpu.SELECTORS[3]),
                        _group(1, (mem.KEY, mem.WORD), mem.SEND)],
        looked_table=_group(2, (store.KEY, store.WORD), store.FILTER))
    return [CpuTable(), MemoryTable(), StoreTable()], [ctl0, ctl1]


def _derive(trace: np.ndarray, u: int, d: int) -> None:
    """d[i + 1] = u0[i] · u1[i] · u2[i] + u3[i] mod P (on the CPU)."""
    a, b, c, e = (g.tensor(trace[u + k, :-1], "cpu") for k in range(4))
    trace[d, 1:] = g.to_numpy(g.add(g.mul(g.mul(a, b), c), e))


def generate_traces(log_rows=LOG_ROWS, seed: int = 2026) -> tuple[list, list]:
    """([trace [COLUMNS, 2^log_rows[i]] u64 per table], [public inputs per
    table]) from one numpy generator. Active rows: 2^(log_rows[1] - 3) for
    each of table 0's memory pairs, 2^(log_rows[2] - 2) for table 2's,
    2^(log_rows[2] - 3) for each pair sent to the store."""
    rng = np.random.default_rng(seed)
    n0, n1, n2 = (1 << lg for lg in log_rows)
    a, b, c = n1 >> 3, n2 >> 2, n2 >> 3
    if 3 * a + c > n0 or 3 * a + b > n1 or min(a, c) < 1:
        raise ValueError(f"no room for the cross-table rows at {log_rows}")

    def felts(*shape):
        return rng.integers(0, fs.P, size=shape, dtype=np.uint64)

    cpu, mem, store = CpuTable, MemoryTable, StoreTable
    t0, t1, t2 = felts(cpu.COLUMNS, n0), felts(mem.COLUMNS, n1), felts(store.COLUMNS, n2)

    def pick(n, k):
        return rng.permutation(n)[:k]

    def rows_of(t, cols, rows):
        return t[list(cols)][:, rows]

    # table 0: disjoint active rows for its four selectors
    rows0 = pick(n0, 3 * a + c)
    t0[list(cpu.SELECTORS)] = 0
    active0 = [rows0[j * a:(j + 1) * a] for j in range(3)] + [rows0[3 * a:]]
    for s, rows in zip(cpu.SELECTORS, active0):
        t0[s, rows] = 1
    # table 2's rows sent to memory
    rows2 = pick(n2, b)
    t2[store.SEND] = 0
    t2[store.SEND, rows2] = 1
    # table 1: the memory rows are the multiset union of what is sent to it
    sent = np.concatenate([rows_of(t0, pair, rows) for pair, rows in zip(cpu.PAIRS, active0)]
                          + [rows_of(t2, (store.ADDR, store.VAL), rows2)], axis=1)
    rows1 = pick(n1, sent.shape[1])
    t1[mem.FILTER] = 0
    t1[mem.FILTER, rows1] = 1
    t1[mem.ADDR, rows1], t1[mem.VAL, rows1] = sent[:, rng.permutation(sent.shape[1])]
    sends1 = pick(n1, c)
    t1[mem.SEND] = 0
    t1[mem.SEND, sends1] = 1
    # table 2: the store rows are what tables 0 and 1 send to it
    stored = np.concatenate([rows_of(t0, cpu.KEY_WORD, active0[3]),
                             rows_of(t1, (mem.KEY, mem.WORD), sends1)], axis=1)
    rows2 = pick(n2, stored.shape[1])
    t2[store.FILTER] = 0
    t2[store.FILTER, rows2] = 1
    t2[store.KEY, rows2], t2[store.WORD, rows2] = stored[:, rng.permutation(stored.shape[1])]
    # table 0's range check: values below min(n0, 2^16) into [0, n0)
    t0[cpu.RANGE] = rng.integers(0, min(n0, 1 << 16), size=n0, dtype=np.uint64)
    t0[cpu.TABLE] = np.arange(n0, dtype=np.uint64)
    t0[cpu.FREQ] = np.bincount(t0[cpu.RANGE].astype(np.int64), minlength=n0).astype(np.uint64)
    # the degree-3 transitions
    for j in range(4):
        _derive(t0, cpu.FREE + 4 * j, cpu.DERIVED + j)
    _derive(t1, mem.FREE, mem.DERIVED)
    _derive(t2, store.FREE, store.DERIVED)
    return [t0, t1, t2], [[int(t0[cpu.DERIVED, 0])], [], []]


def shifted_memory(traces: list) -> list:
    """The traces with table 1's values shifted by 1: the CTL's sums then
    disagree (the reference's tests/test_ctl.py mismatch)."""
    t1 = traces[1].copy()
    v = t1[MemoryTable.VAL]
    t1[MemoryTable.VAL] = np.where(v == fs.P - 1, np.uint64(0), v + np.uint64(1))
    return [traces[0], t1, traces[2]]


def ctl_target_counts(starks, config, ctls) -> list[tuple[int, int]]:
    """(CTL helper and Z columns, CTL Z columns) of each table: what its
    proof target's auxiliary oracle holds beyond the logUp columns."""
    from plonky2_torch.starky.cross_table_lookup import ctl_shape_data
    from plonky2_torch.starky.lookup import GrandProductChallenge, GrandProductChallengeSet

    dummy = GrandProductChallengeSet([GrandProductChallenge(0, 0)
                                      for _ in range(config.num_challenges)])
    desc = ctl_shape_data(len(starks), ctls, dummy,
                          max(s.constraint_degree() for s in starks))
    return [(sum(len(z.helper_columns) for z in d.zs_columns) + len(d.zs_columns),
             len(d.zs_columns)) for d in desc]


def wrap_circuit(starks, stark_config, degree_bits: list[int], ctls, config, device=None,
                 timing=None):
    """(CircuitData, proof targets) of one circuit that verifies every
    table's proof and the cross-table sums (`verify_multi_table_circuit`),
    built on `device` (CUDA unless the caller asks for another); every
    table's public inputs become the circuit's."""
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.starky.cross_table_lookup import verify_multi_table_circuit
    from plonky2_torch.starky.recursive_verifier import add_virtual_stark_proof_with_pis

    builder = CircuitBuilder(config)
    pts = [add_virtual_stark_proof_with_pis(builder, stark, stark_config, bits,
                                            num_ctl_helper_zs=helper_zs, num_ctl_zs=zs)
           for stark, bits, (helper_zs, zs)
           in zip(starks, degree_bits, ctl_target_counts(starks, stark_config, ctls))]
    verify_multi_table_circuit(builder, starks, stark_config, pts, ctls, degree_bits)
    for pt in pts:
        builder.register_public_inputs(pt.public_inputs)
    return builder.build(device=device, timing=timing), pts


def wrap_inputs(pts, proofs) -> PartialWitness:
    """The witness inputs of the circuit: every table's proof targets."""
    from plonky2_torch.starky.recursive_verifier import set_stark_proof_with_pis_target

    pw = PartialWitness()
    for pt, proof in zip(pts, proofs):
        set_stark_proof_with_pis_target(pw, pt, proof)
    return pw
