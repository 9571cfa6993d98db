"""Witness generators and their schedulers (reference iop/generator.rs; the
reference package's `iop/generator.py`).

A generator fires once every target it depends on has a value and writes
its outputs. Three engines run a circuit's generators, all on the host:

  "native"  the compiled witness plan (`iop/witness_plan.py`): the level
            schedule as flat op streams run by the port's C++ executor;
            the default
  "python"  the levelized batch engine: each level's generators of one
            class run through their numpy `run_batch` (or `run_once`)
  worklist  the reference's dynamic scheduler, for circuits whose
            generators do not all declare their outputs or whose schedule
            stalls even given the inputs

A circuit's level schedule is cached on its prover data. Where it has a
cycle that the inputs break (a boolean input, checked by b · b = b, is
also the output of that check's generator), the schedule given the input
representatives is cached instead, one for each set of inputs: the
reference runs the worklist there.

`ENGINE` (or the `engine` argument of `generate_partial_witness`) picks
between the first two; nothing falls back from one to the other. Both draw
the random values in the same order, so they give the same witness.
"""

from __future__ import annotations

import hashlib

import numpy as np

from plonky2_torch.field import np_field as npf
from plonky2_torch.field import scalar as fs
from plonky2_torch.iop.target import Target, Wire, target_index
from plonky2_torch.iop.witness import PartialWitness, PartitionWitness
from plonky2_torch.util import rng

ENGINE = "native"  # or "python"
ENGINES = ("native", "python")


class GeneratedValues:
    def __init__(self):
        self.target_values: list[tuple[Target, int]] = []

    def set_target(self, target: Target, value: int) -> None:
        self.target_values.append((target, value))

    def set_extension_target(self, ext_target, value: tuple) -> None:
        for t, v in zip(ext_target.parts, value):
            self.set_target(t, v)

    def set_wires(self, row: int, columns, values) -> None:
        for c, v in zip(columns, values):
            self.set_target(Wire(row, c), v)


class SimpleGenerator:
    """Dependencies known up front; runs once when all are set
    (reference iop/generator.rs:206-234)."""

    def id(self) -> str:
        return type(self).__name__

    def dependencies(self) -> list[Target]:
        raise NotImplementedError

    def outputs(self) -> list[Target] | None:
        """The targets this generator writes, for the level schedule; None
        where they are not known statically (then the worklist runs)."""
        return None

    def run_once(self, witness: PartitionWitness, out_buffer: GeneratedValues) -> None:
        raise NotImplementedError


def _reps(witness, targets, n) -> np.ndarray:
    return np.fromiter((witness.rep_index(t) for t in targets), np.int64, n)


def _u64(values, n) -> np.ndarray:
    return np.fromiter(values, np.uint64, n)


class ConstantGenerator(SimpleGenerator):
    def __init__(self, row: int, constant_index: int, wire_index: int, constant: int):
        self.row = row
        self.constant_index = constant_index
        self.wire_index = wire_index
        self.constant = constant

    def dependencies(self):
        return []

    def outputs(self):
        return [Wire(self.row, self.wire_index)]

    def run_once(self, witness, out_buffer):
        out_buffer.set_target(Wire(self.row, self.wire_index), self.constant)

    @classmethod
    def run_batch(cls, gens, witness):
        n = len(gens)
        witness.set_reps(_reps(witness, (g.outputs()[0] for g in gens), n),
                         _u64((g.constant for g in gens), n))


class CopyGenerator(SimpleGenerator):
    def __init__(self, src: Target, dst: Target):
        self.src = src
        self.dst = dst

    def dependencies(self):
        return [self.src]

    def outputs(self):
        return [self.dst]

    def run_once(self, witness, out_buffer):
        out_buffer.set_target(self.dst, witness.get_target(self.src))

    @classmethod
    def run_batch(cls, gens, witness):
        n = len(gens)
        src = _reps(witness, (g.src for g in gens), n)
        witness.set_reps(_reps(witness, (g.dst for g in gens), n), witness.get_reps(src))


class RandomValueGenerator(SimpleGenerator):
    """A random field element from the seedable prover rng (`util/rng.py`)."""

    def __init__(self, target: Target):
        self.target = target

    def dependencies(self):
        return []

    def outputs(self):
        return [self.target]

    def run_once(self, witness, out_buffer):
        out_buffer.set_target(self.target, int(rng.field_elements(1, fs.P)[0]))

    @classmethod
    def run_batch(cls, gens, witness):
        reps = _reps(witness, (g.target for g in gens), len(gens))
        witness.set_reps(reps, rng.field_elements(len(gens), fs.P))


class NonzeroTestGenerator(SimpleGenerator):
    def __init__(self, to_test: Target, dummy: Target):
        self.to_test = to_test
        self.dummy = dummy

    def dependencies(self):
        return [self.to_test]

    def outputs(self):
        return [self.dummy]

    def run_once(self, witness, out_buffer):
        v = witness.get_target(self.to_test)
        out_buffer.set_target(self.dummy, fs.inverse(v) if v != 0 else 1)

    @classmethod
    def run_batch(cls, gens, witness):
        n = len(gens)
        x = witness.get_reps(_reps(witness, (g.to_test for g in gens), n))
        nonzero = [int(v) for v in x if v]
        inv = iter(fs.batch_inverse(nonzero))
        witness.set_reps(_reps(witness, (g.dummy for g in gens), n),
                         _u64((next(inv) if v else 1 for v in x), n))


class ArithmeticBaseGenerator(SimpleGenerator):
    """One op slot of ArithmeticGate (wires 4i .. 4i + 3: the multiplicands,
    the addend, the output): output = c0 · m0 · m1 + c1 · addend."""

    def __init__(self, row: int, const_0: int, const_1: int, i: int):
        self.row = row
        self.const_0 = const_0
        self.const_1 = const_1
        self.i = i

    def dependencies(self):
        return [Wire(self.row, 4 * self.i + k) for k in range(3)]

    def outputs(self):
        return [Wire(self.row, 4 * self.i + 3)]

    def run_once(self, witness, out_buffer):
        m0, m1, a = witness.get_targets(self.dependencies())
        out_buffer.set_target(self.outputs()[0], fs.add(fs.mul(self.const_0, fs.mul(m0, m1)),
                                                        fs.mul(self.const_1, a)))

    @classmethod
    def run_batch(cls, gens, witness):
        n = len(gens)
        rows = np.fromiter((g.row for g in gens), np.int64, n)
        base = np.fromiter((4 * g.i for g in gens), np.int64, n)
        m0, m1, a = (witness.get_reps(witness.wire_reps(rows, base + k)) for k in range(3))
        c0 = _u64((g.const_0 for g in gens), n)
        c1 = _u64((g.const_1 for g in gens), n)
        out = npf.add(npf.mul(c0, npf.mul(m0, m1)), npf.mul(c1, a))
        witness.set_reps(witness.wire_reps(rows, base + 3), out)


def _levelize(generators, witness, known=None) -> list[list[int]] | None:
    """Static topological levels over partition representatives.

    A dependency is internal where some generator produces its
    representative; the others come from the PartialWitness inputs, set
    before level 0. None (the worklist runs) where a generator lacks static
    outputs or the graph stalls. The schedule depends only on the circuit,
    so callers cache it. Where `known` (a mask over representatives) is
    given, those representatives count as set before level 0 even where a
    generator produces them: a schedule for these inputs alone, which
    breaks a cycle such as a boolean input's check b · b = b."""
    n = len(generators)
    out_reps: list[list[int]] = []
    deps_reps: list[list[int]] = []
    for g in generators:
        outs = g.outputs()
        if outs is None:
            return None
        out_reps.append([witness.rep_index(t) for t in outs])
        deps_reps.append([witness.rep_index(t) for t in g.dependencies()])
    produced: set[int] = set()
    for reps in out_reps:
        produced.update(reps)
    waiters: dict[int, list[int]] = {}
    unseen = [0] * n
    for i, reps in enumerate(deps_reps):
        for r in set(reps):
            if r in produced and (known is None or not known[r]):
                unseen[i] += 1
                waiters.setdefault(r, []).append(i)
    current = [i for i in range(n) if unseen[i] == 0]
    levels = []
    fired = 0
    seen: set[int] = set()
    while current:
        levels.append(current)
        fired += len(current)
        newly: list[int] = []
        for i in current:
            for r in out_reps[i]:
                if r not in seen:
                    seen.add(r)
                    newly.append(r)
        nxt: list[int] = []
        for r in newly:
            for w in waiters.get(r, ()):
                unseen[w] -= 1
                if unseen[w] == 0:
                    nxt.append(w)
        current = nxt
    return levels if fired == n else None


_BATCH_MIN = 8  # below this, run_once beats the numpy set-up


def run_group(gcls, idxs, generators, witness, buffer: GeneratedValues) -> None:
    """One level's generators of one class: `run_batch` where the class has
    one and the group is large enough, else `run_once` each."""
    run_batch = getattr(gcls, "run_batch", None)
    if run_batch is not None and len(idxs) >= getattr(gcls, "BATCH_MIN", _BATCH_MIN):
        run_batch([generators[i] for i in idxs], witness)
        return
    for i in idxs:
        generators[i].run_once(witness, buffer)
        for t, v in buffer.target_values:
            witness.set_target(t, v)
        buffer.target_values.clear()


def by_class(generators, level) -> dict[type, list[int]]:
    """A level's generator indices grouped by class, in first-seen order."""
    by_type: dict[type, list[int]] = {}
    for i in level:
        by_type.setdefault(type(generators[i]), []).append(i)
    return by_type


def _run_levelized(witness, generators, levels) -> None:
    buffer = GeneratedValues()
    for level in levels:
        for gcls, idxs in by_class(generators, level).items():
            run_group(gcls, idxs, generators, witness, buffer)


def _scatter_inputs(inputs: PartialWitness, witness: PartitionWitness,
                    num_wires: int, degree: int) -> None:
    """The PartialWitness inputs in one vector write. The index and value
    arrays are cached on the inputs (append-only, write-once), so a re-prove
    from the same inputs skips the Python loop."""
    items = inputs.target_values
    n = len(items)
    if n == 0:
        return
    cache = getattr(inputs, "_index_cache", None)
    if cache is not None and cache[0] == (n, num_wires, degree):
        idx, vals = cache[1], cache[2]
    else:
        idx = np.fromiter((target_index(t, num_wires, degree) for t in items), np.int64, n)
        vals = np.fromiter(items.values(), np.uint64, n)
        inputs._index_cache = ((n, num_wires, degree), idx, vals)
    witness.set_reps(witness.rep_map[idx], vals)


def _run_worklist(witness, prover_data, generators) -> None:
    """The reference's dynamic scheduler (iop/generator.rs:26-104)."""
    by_rep = prover_data.generator_indices_by_watches
    remaining = [True] * len(generators)
    pending: list[int] = list(range(len(generators)))
    buffer = GeneratedValues()
    while pending:
        next_pending: set[int] = set()
        newly_set_reps: list[int] = []
        for gi in pending:
            if not remaining[gi]:
                continue
            gen = generators[gi]
            if not witness.contains_all(gen.dependencies()):
                continue  # stays watched; re-queued when its inputs land
            gen.run_once(witness, buffer)
            remaining[gi] = False
            for t, v in buffer.target_values:
                rep = witness.set_target(t, v)
                if rep is not None:
                    newly_set_reps.append(rep)
            buffer.target_values.clear()
        for rep in newly_set_reps:
            for watcher in by_rep.get(rep, ()):
                if remaining[watcher]:
                    next_pending.add(watcher)
        pending = sorted(next_pending)
    if any(remaining):
        stuck = [generators[i].id() for i, r in enumerate(remaining) if r]
        raise RuntimeError(f"{len(stuck)} generators never fired (first few: {stuck[:5]}); "
                           "witness may be underconstrained")


def generate_partial_witness(inputs: PartialWitness, prover_data, common,
                             engine: str | None = None) -> PartitionWitness:
    """Run the circuit's generators from `inputs` (reference
    iop/generator.rs:26-104) on `engine` (default `ENGINE`)."""
    engine = engine or ENGINE
    if engine not in ENGINES:
        raise ValueError(f"unknown witness engine {engine!r}; expected one of {ENGINES}")
    generators = prover_data.generators
    cache = prover_data.cache("host")
    witness = PartitionWitness(prover_data.representative_map, common.config.num_wires,
                               common.degree)
    _scatter_inputs(inputs, witness, common.config.num_wires, common.degree)
    if "levels" not in cache:
        cache["levels"] = _levelize(generators, witness)
    levels, plan_key = cache["levels"], "witness_plan"
    if levels is None:
        # the circuit's schedule has a cycle; the schedule given these
        # inputs, cached by the set of input representatives
        input_set = hashlib.sha256(np.flatnonzero(witness.known).tobytes()).hexdigest()
        key = ("levels given the inputs", input_set)
        if key not in cache:
            cache[key] = _levelize(generators, witness, witness.known)
        levels, plan_key = cache[key], ("witness_plan given the inputs", input_set)
    cache["last_plan"] = None
    if levels is None:
        _run_worklist(witness, prover_data, generators)
    elif engine == "native":
        from plonky2_torch.iop.witness_plan import WitnessPlan

        if plan_key not in cache:
            cache[plan_key] = WitnessPlan(generators, levels, witness)
        cache["last_plan"] = cache[plan_key]
        cache[plan_key].run(witness, generators)
    else:
        _run_levelized(witness, generators, levels)
    return witness
