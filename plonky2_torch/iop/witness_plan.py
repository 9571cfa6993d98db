"""Compiled witness plans: the native engine of witness generation (the
reference package's `iop/witness_plan.py`).

A `WitnessPlan` compiles a circuit's level schedule (`generator._levelize`)
once into flat op streams over partition-representative indices; a prove's
witness generation is then a few calls into the port's C++ executor
(`native/`), each opcode the dual of one generator's `run_once`, with no
per-level Python dispatch. A generator class without an opcode runs through
its Python `run_batch` / `run_once` between native segments (`fallbacks`
names them). Random values are drawn from the prover rng (`util/rng.py`) in
the levelized engine's order, so both engines give the same witness. A
lookup op reads its LUT from the aux array's tail, where each distinct
LUT is stored once; a LUT slot's pair is a constant of the op.
"""

from __future__ import annotations

import os

import numpy as np

from plonky2_torch import native
from plonky2_torch.field import scalar as fs
from plonky2_torch.iop.generator import GeneratedValues, by_class, run_group
from plonky2_torch.util import rng

# opcodes: enum WpOp of native/src/plonky2_native.cc
_COPY = 1
_ARITH_BASE = 2
_ARITH_EXT = 3
_MUL_EXT = 4
_POSEIDON = 5
_RANDOM_ACCESS = 6
_REDUCING = 7
_REDUCING_EXT = 8
_INTERPOLATION = 9
_QUOTIENT_EXT = 10
_BASE_SPLIT = 11
_WIRE_SPLIT = 12
_LOW_HIGH = 13
_NONZERO = 16
_EXP = 17
_CONSTANT = 18
_RANDOM = 19
_LOOKUP = 20  # aux: (the LUT's offset in aux, its length)
_CONSTANT_PAIR = 21  # aux: the two outputs

THREADS = max(1, min(4, os.cpu_count() or 1))  # executor threads for costly levels


def _no_aux(gen):
    return ()


def _interp_aux(gen):
    gate = gen._gate()
    domain = fs.two_adic_subgroup(gen.subgroup_bits)
    return (gate.degree(), gate.num_points(), *domain, *gate.barycentric_weights)


def _compilers():
    """class -> (opcode, aux). The ops read and write the representatives
    in the order of the generator's dependencies() and outputs()."""
    from plonky2_torch.gadgets.extension_arithmetic import QuotientGeneratorExtension
    from plonky2_torch.gadgets.split_join import LowHighGenerator, WireSplitGenerator
    from plonky2_torch.gates.arithmetic_extension import (
        ArithmeticExtensionGenerator,
        MulExtensionGenerator,
    )
    from plonky2_torch.gates.base_sum import BaseSplitGenerator
    from plonky2_torch.gates.coset_interpolation import InterpolationGenerator
    from plonky2_torch.gates.exponentiation import ExponentiationGenerator
    from plonky2_torch.gates.lookup import LookupGenerator, LookupTableGenerator
    from plonky2_torch.gates.poseidon_gate import PoseidonGenerator
    from plonky2_torch.gates.random_access import RandomAccessGenerator
    from plonky2_torch.gates.reducing import ReducingExtensionGenerator, ReducingGenerator
    from plonky2_torch.iop.generator import (
        ArithmeticBaseGenerator,
        ConstantGenerator,
        CopyGenerator,
        NonzeroTestGenerator,
        RandomValueGenerator,
    )

    return {
        CopyGenerator: (_COPY, _no_aux),
        ArithmeticBaseGenerator: (_ARITH_BASE, lambda g: (g.const_0, g.const_1)),
        ArithmeticExtensionGenerator: (_ARITH_EXT, lambda g: (g.const_0, g.const_1)),
        MulExtensionGenerator: (_MUL_EXT, lambda g: (g.const_0,)),
        PoseidonGenerator: (_POSEIDON, _no_aux),
        RandomAccessGenerator: (_RANDOM_ACCESS, _no_aux),
        ReducingGenerator: (_REDUCING, _no_aux),
        ReducingExtensionGenerator: (_REDUCING_EXT, _no_aux),
        InterpolationGenerator: (_INTERPOLATION, _interp_aux),
        QuotientGeneratorExtension: (_QUOTIENT_EXT, _no_aux),
        BaseSplitGenerator: (_BASE_SPLIT, lambda g: (g.base,)),
        WireSplitGenerator: (_WIRE_SPLIT, lambda g: (g.num_limbs,)),
        LowHighGenerator: (_LOW_HIGH, lambda g: (g.n_log,)),
        NonzeroTestGenerator: (_NONZERO, _no_aux),
        ExponentiationGenerator: (_EXP, _no_aux),
        ConstantGenerator: (_CONSTANT, lambda g: (g.constant,)),
        RandomValueGenerator: (_RANDOM, lambda g: (0,)),  # drawn per run
        LookupGenerator: (_LOOKUP, None),  # aux set once the LUTs are placed
        LookupTableGenerator: (_CONSTANT_PAIR, lambda g: g.entry()),  # its slot's LUT pair
    }


class WitnessPlan:
    """One circuit's generator schedule in flat compiled form.

    segments: ("c", first op, end op) ranges run natively and ("py", class,
    [generator indices]) groups run in Python. The RandomValueGenerators'
    aux slots are refilled from the rng on every run."""

    def __init__(self, generators, levels, witness):
        compilers = _compilers()
        opcodes: list[int] = []
        in_reps: list[int] = []
        out_reps: list[int] = []
        aux: list[int] = []
        in_off, out_off, aux_off = [0], [0], [0]
        segments: list[tuple] = []
        random_aux_idx: list[int] = []
        barriers: list[int] = [0]  # op indices at level boundaries
        seg_start = 0
        rep = witness.rep_index
        self.fallbacks: dict[str, int] = {}  # class name -> generators run in Python
        lut_ids: dict[int, int] = {}  # id of a LUT list -> its index in luts
        luts: list = []
        lut_sites: list[tuple[int, int]] = []  # (aux index of a lookup op, LUT index)
        for level in levels:
            for gcls, idxs in by_class(generators, level).items():
                entry = compilers.get(gcls)
                if entry is None:
                    if seg_start < len(opcodes):
                        segments.append(("c", seg_start, len(opcodes)))
                    segments.append(("py", gcls, idxs))
                    self.fallbacks[gcls.__name__] = (self.fallbacks.get(gcls.__name__, 0)
                                                     + len(idxs))
                    seg_start = len(opcodes)
                    continue
                opcode, aux_fn = entry
                for i in idxs:
                    g = generators[i]
                    if opcode == _RANDOM:
                        random_aux_idx.append(len(aux))
                    opcodes.append(opcode)
                    in_reps.extend(rep(t) for t in g.dependencies())
                    out_reps.extend(rep(t) for t in g.outputs())
                    if opcode == _LOOKUP:
                        lut_sites.append((len(aux), lut_ids.setdefault(id(g.lut), len(luts))))
                        if lut_sites[-1][1] == len(luts):
                            luts.append(g.lut)
                        aux.extend((0, len(g.lut)))
                    else:
                        aux.extend(int(a) % fs.P for a in aux_fn(g))
                    in_off.append(len(in_reps))
                    out_off.append(len(out_reps))
                    aux_off.append(len(aux))
            if barriers[-1] != len(opcodes):
                barriers.append(len(opcodes))
        if seg_start < len(opcodes):
            segments.append(("c", seg_start, len(opcodes)))
        offsets = []
        for lut in luts:  # the LUTs' (input, output) pairs at the aux tail
            offsets.append(len(aux))
            for i, o in lut:
                aux.extend((int(i), int(o)))
        for site, k in lut_sites:
            aux[site] = offsets[k]

        self.opcodes = np.asarray(opcodes, np.int32)
        self.in_off = np.asarray(in_off, np.int64)
        self.out_off = np.asarray(out_off, np.int64)
        self.aux_off = np.asarray(aux_off, np.int64)
        self.in_reps = np.asarray(in_reps, np.int64)
        self.out_reps = np.asarray(out_reps, np.int64)
        self.aux = np.asarray(aux, np.uint64)
        self.segments = segments
        self.random_aux_idx = np.asarray(random_aux_idx, np.int64)
        # per native segment: the representatives it writes (for the known
        # mask), its level barriers, whether its levels may run threaded,
        # and the representatives it reads that no earlier op writes
        barriers_np = np.asarray(barriers, np.int64)
        self._seg = {}
        for s in segments:
            if s[0] != "c":
                continue
            start, end = s[1], s[2]
            inner = barriers_np[(barriers_np > start) & (barriers_np < end)]
            bars = np.concatenate([[start], inner, [end]]).astype(np.int64)
            # the threaded executor assumes one producer of a representative
            # a level; a level where two ops write one runs single-threaded
            threads_ok = all(
                len(np.unique(lvl)) == len(lvl)
                for lvl in (self.out_reps[self.out_off[b0]:self.out_off[b1]]
                            for b0, b1 in zip(bars[:-1], bars[1:])))
            seg_in = np.unique(self.in_reps[self.in_off[start]:self.in_off[end]])
            external = np.setdiff1d(seg_in, self.out_reps[:self.out_off[end]])
            self._seg[(start, end)] = (
                np.unique(self.out_reps[self.out_off[start]:self.out_off[end]]), bars,
                threads_ok, external)

    def run(self, witness, generators) -> None:
        if len(self.random_aux_idx):
            self.aux[self.random_aux_idx] = rng.field_elements(len(self.random_aux_idx), fs.P)
        values = witness.values
        buffer = GeneratedValues()
        for seg in self.segments:
            if seg[0] == "py":
                run_group(seg[1], seg[2], generators, witness, buffer)
                continue
            writes, bars, threads_ok, external = self._seg[(seg[1], seg[2])]
            # the executor would read an unset slot as 0, where the Python
            # engines raise: every input from outside the segment must be set
            if external.size and not witness.known[external].all():
                missing = external[~witness.known[external]]
                raise ValueError(f"batch read of unset representative: {missing[:8]}; a "
                                 "required PartialWitness input is missing")
            # as set_reps does, a value already known must not change
            preset = writes[witness.known[writes]]
            before = values[preset]
            rc = native.witness_plan_run_mt(values, self, bars, THREADS if threads_ok else 1)
            if rc >= 0:
                raise RuntimeError(f"witness plan op {rc} (opcode {self.opcodes[rc]}) failed: "
                                   "a bad access index, an overflowing decomposition or a "
                                   "division by zero; the witness is inconsistent")
            changed = values[preset] != before
            if changed.any():
                raise ValueError("Partition was batch-set twice with different values "
                                 f"(first rep {int(preset[changed][0])})")
            witness.known[writes] = True
