"""The inverse and equality gadgets (reference gadgets/arithmetic.rs; the
reference package's gadgets/inverse.py).

Each adds a hint target that a generator fills and constraints that make
the hint sound: `add_inverse` pins x · x_inv = 1; `is_equal` pins
(x - y) · m = 1 - eq and eq · (x - y) = 0. Neither generator has an
opcode in the native witness plan: both engines run their `run_batch`
(or `run_once`) in Python.
"""

from __future__ import annotations

import numpy as np

from plonky2_torch.field import np_field as npf
from plonky2_torch.field import scalar as fs
from plonky2_torch.iop.generator import SimpleGenerator, _reps, _u64
from plonky2_torch.iop.target import BoolTarget, Target


def _inverse_or_zero(x: np.ndarray) -> np.ndarray:
    """x^-1 where x is nonzero, else 0."""
    nonzero = [int(v) for v in x if v]
    inv = iter(fs.batch_inverse(nonzero))
    return _u64((next(inv) if v else 0 for v in x), len(x))


class InverseGenerator(SimpleGenerator):
    def __init__(self, x: Target, inv: Target):
        self.x = x
        self.inv = inv

    def dependencies(self):
        return [self.x]

    def outputs(self):
        return [self.inv]

    def run_once(self, witness, out_buffer):
        out_buffer.set_target(self.inv, fs.inverse(witness.get_target(self.x)))

    @classmethod
    def run_batch(cls, gens, witness):
        n = len(gens)
        x = witness.get_reps(_reps(witness, (g.x for g in gens), n))
        if (x == np.uint64(0)).any():
            raise ZeroDivisionError("inverse of zero in the Goldilocks field")
        witness.set_reps(_reps(witness, (g.inv for g in gens), n), _inverse_or_zero(x))


def add_inverse(builder, x: Target) -> Target:
    inv = builder.add_virtual_target()
    builder.add_simple_generator(InverseGenerator(x, inv))
    builder.connect(builder.mul(x, inv), builder.one())
    return inv


class EqualityGenerator(SimpleGenerator):
    def __init__(self, x: Target, y: Target, equal: Target, inv_hint: Target):
        self.x = x
        self.y = y
        self.equal = equal
        self.inv_hint = inv_hint

    def dependencies(self):
        return [self.x, self.y]

    def outputs(self):
        return [self.equal, self.inv_hint]

    def run_once(self, witness, out_buffer):
        diff = fs.sub(witness.get_target(self.x), witness.get_target(self.y))
        out_buffer.set_target(self.equal, int(diff == 0))
        out_buffer.set_target(self.inv_hint, fs.inverse(diff) if diff else 0)

    @classmethod
    def run_batch(cls, gens, witness):
        n = len(gens)
        x = witness.get_reps(_reps(witness, (g.x for g in gens), n))
        y = witness.get_reps(_reps(witness, (g.y for g in gens), n))
        diff = npf.sub(x, y)
        witness.set_reps(_reps(witness, (g.equal for g in gens), n),
                         (diff == np.uint64(0)).astype(np.uint64))
        witness.set_reps(_reps(witness, (g.inv_hint for g in gens), n), _inverse_or_zero(diff))


def is_equal(builder, x: Target, y: Target) -> BoolTarget:
    equal = builder.add_virtual_target()
    inv_hint = builder.add_virtual_target()
    builder.add_simple_generator(EqualityGenerator(x, y, equal, inv_hint))
    diff = builder.sub(x, y)
    # diff · inv_hint = 1 - equal, and equal · diff = 0
    diff_times_hint = builder.mul(diff, inv_hint)
    builder.connect(diff_times_hint, builder.sub(builder.one(), equal))
    builder.assert_zero(builder.mul(equal, diff))
    return BoolTarget(equal)
