"""CosetInterpolationGate: barycentric interpolation of a coset-indexed
vector at an extension point, with degree-bounded intermediate wires
(reference gates/coset_interpolation.rs).

Interpolation runs over the subgroup H at the shifted point z/shift with
the running sequences
  p[i] = p[i-1] * (z - x[i-1])
  e[i] = e[i-1] * (z - x[i-1]) + w[i-1] * v[i-1] * p[i-1],
restarting from witness intermediates every degree - 1 points; e[N] is the
first-form barycentric numerator, so no division is needed. The weights
w_i are computed on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import np_field as npf
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import Gate, rows
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Wire
from plonky2_torch.gates.ops import ealg_add, ealg_from_base, ealg_mul, ealg_sub, ealg_zero

D = 2


def subgroup_barycentric_weights(subgroup_bits: int) -> list[int]:
    """w_i = prod_{j != i} (x_i - x_j)^-1 over the two-adic subgroup."""
    pts = fs.two_adic_subgroup(subgroup_bits)
    prods = []
    for i, x_i in enumerate(pts):
        acc = 1
        for j, x_j in enumerate(pts):
            if j != i:
                acc = fs.mul(acc, fs.sub(x_i, x_j))
        prods.append(acc)
    return fs.batch_inverse(prods)


def _partial_interpolate(ops, domain, values, weights, x, init_eval, init_prod):
    """One degree-bounded chunk of the running interpolation."""
    ev, prod = init_eval, init_prod
    for x_i, v, w in zip(domain, values, weights):
        term = ealg_sub(ops, x, ealg_from_base(ops, ops.constant(x_i), D))
        wv = tuple(ops.mul_const(w, c) for c in v)
        ev = ealg_add(ops, ealg_mul(ops, ev, term), ealg_mul(ops, wv, prod))
        prod = ealg_mul(ops, prod, term)
    return ev, prod


class CosetInterpolationGate(Gate):
    def __init__(self, subgroup_bits: int, max_degree: int | None = None):
        if max_degree is None:
            max_degree = 1 << subgroup_bits
        if max_degree <= 1:
            raise ValueError("need at least quadratic constraints")
        n_points = 1 << subgroup_bits
        n_intermediates = (n_points - 2) // (max_degree - 1)
        self.subgroup_bits = subgroup_bits
        self._degree = (n_points - 2) // (n_intermediates + 1) + 2
        self.barycentric_weights = subgroup_barycentric_weights(subgroup_bits)

    def degree(self) -> int:
        return self._degree

    def num_points(self) -> int:
        return 1 << self.subgroup_bits

    # wires: shift, the values (D each), the evaluation point, its value,
    # the intermediate evals, the intermediate products, the shifted point
    @staticmethod
    def wire_shift() -> int:
        return 0

    def wires_value(self, i: int) -> range:
        return range(1 + i * D, 1 + (i + 1) * D)

    def _start_evaluation_point(self) -> int:
        return 1 + self.num_points() * D

    def wires_evaluation_point(self) -> range:
        s = self._start_evaluation_point()
        return range(s, s + D)

    def wires_evaluation_value(self) -> range:
        s = self._start_evaluation_point() + D
        return range(s, s + D)

    def _start_intermediates(self) -> int:
        return self._start_evaluation_point() + 2 * D

    def num_intermediates(self) -> int:
        return (self.num_points() - 2) // (self._degree - 1)

    def wires_intermediate_eval(self, i: int) -> range:
        s = self._start_intermediates() + D * i
        return range(s, s + D)

    def wires_intermediate_prod(self, i: int) -> range:
        s = self._start_intermediates() + D * (self.num_intermediates() + i)
        return range(s, s + D)

    def wires_shifted_evaluation_point(self) -> range:
        s = self._start_intermediates() + D * 2 * self.num_intermediates()
        return range(s, s + D)

    def id(self) -> str:
        return (f"CosetInterpolationGate {{ subgroup_bits: {self.subgroup_bits}, "
                f"degree: {self._degree} }}<D={D}>")

    def _chunks(self) -> list[list[int]]:
        """The points of each degree-bounded chunk: 0..degree, then
        degree - 1 more points a chunk."""
        deg, n = self._degree, self.num_points()
        chunks = [list(range(deg))]
        for j in range(1, self.num_intermediates() + 1):
            start = 1 + (deg - 1) * j
            chunks.append(list(range(start, min(start + deg - 1, n))))
        return chunks

    def eval_unfiltered(self, ops, vars) -> list:
        shift = vars.local_wires[0]
        evaluation_point = vars.get_local_ext_algebra(self.wires_evaluation_point())
        shifted = vars.get_local_ext_algebra(self.wires_shifted_evaluation_point())
        # evaluation_point == shift * shifted_evaluation_point
        constraints = list(ealg_sub(ops, evaluation_point,
                                    tuple(ops.mul(shift, c) for c in shifted)))
        domain = fs.two_adic_subgroup(self.subgroup_bits)
        values = [vars.get_local_ext_algebra(self.wires_value(i))
                  for i in range(self.num_points())]
        weights = self.barycentric_weights
        ev, prod = ealg_zero(ops, D), ealg_from_base(ops, ops.one(), D)
        for i, chunk in enumerate(self._chunks()):
            if i:
                ie = vars.get_local_ext_algebra(self.wires_intermediate_eval(i - 1))
                ip = vars.get_local_ext_algebra(self.wires_intermediate_prod(i - 1))
                constraints.extend(ealg_sub(ops, ie, ev))
                constraints.extend(ealg_sub(ops, ip, prod))
                ev, prod = ie, ip
            ev, prod = _partial_interpolate(
                ops, [domain[k] for k in chunk], [values[k] for k in chunk],
                [weights[k] for k in chunk], shifted, ev, prod)
        evaluation_value = vars.get_local_ext_algebra(self.wires_evaluation_value())
        constraints.extend(ealg_sub(ops, evaluation_value, ev))
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """Every chunk restarts from witness intermediates, so the chunks
        run side by side along a leading chunk axis; ragged chunks are
        padded with identity steps (term = 1, w·v = 0)."""
        dev = wires.device
        nI = self.num_intermediates()
        C = nI + 1
        Q = wires.shape[-1]
        domain = fs.two_adic_subgroup(self.subgroup_bits)
        chunks = self._chunks()
        L = max(len(c) for c in chunks)
        idx = np.zeros((L, C), np.int64)
        valid = np.zeros((L, C), bool)
        xi = np.zeros((L, C), np.uint64)
        wt = np.zeros((L, C), np.uint64)
        for j, chunk in enumerate(chunks):
            for t, k in enumerate(chunk):
                idx[t, j], valid[t, j] = k, True
                xi[t, j], wt[t, j] = domain[k], self.barycentric_weights[k]
        flat = idx.reshape(-1).tolist()
        v0 = rows(wires, [self.wires_value(k)[0] for k in flat]).reshape(L, C, Q)
        v1 = rows(wires, [self.wires_value(k)[1] for k in flat]).reshape(L, C, Q)
        sep = self.wires_shifted_evaluation_point()
        x0, x1 = wires[sep[0]][None], wires[sep[1]][None]  # [1, Q]
        zero = torch.zeros((1, Q), dtype=torch.int64, device=dev)
        one = torch.ones((1, Q), dtype=torch.int64, device=dev)
        ie0 = rows(wires, [self.wires_intermediate_eval(i)[0] for i in range(nI)])
        ie1 = rows(wires, [self.wires_intermediate_eval(i)[1] for i in range(nI)])
        ip0 = rows(wires, [self.wires_intermediate_prod(i)[0] for i in range(nI)])
        ip1 = rows(wires, [self.wires_intermediate_prod(i)[1] for i in range(nI)])
        ev = (torch.cat([zero, ie0]), torch.cat([zero, ie1]))
        prod = (torch.cat([one, ip0]), torch.cat([zero, ip1]))
        xi_t, wt_t = g.constant(xi, dev), g.constant(wt, dev)
        for t in range(L):
            term0 = g.sub(x0.expand(C, Q), xi_t[t][:, None])
            term1 = x1.expand(C, Q)
            wv0 = g.mul(wt_t[t][:, None], v0[t])
            wv1 = g.mul(wt_t[t][:, None], v1[t])
            if not valid[t].all():  # identity steps in the ragged tail
                m = (g.constant(valid[t], dev) != 0)[:, None]
                term0 = torch.where(m, term0, 1)
                term1 = torch.where(m, term1, 0)
                wv0 = torch.where(m, wv0, 0)
                wv1 = torch.where(m, wv1, 0)
            term = (term0, term1)
            ev = g.ext2_add(g.ext2_mul(ev, term), g.ext2_mul((wv0, wv1), prod))
            prod = g.ext2_mul(prod, term)
        shift = wires[0]
        ep = self.wires_evaluation_point()
        out = [g.sub(wires[ep[0]], g.mul(shift, wires[sep[0]]))[None],
               g.sub(wires[ep[1]], g.mul(shift, wires[sep[1]]))[None]]
        if nI:
            block = torch.stack([g.sub(ie0, ev[0][:nI]), g.sub(ie1, ev[1][:nI]),
                                 g.sub(ip0, prod[0][:nI]), g.sub(ip1, prod[1][:nI])], dim=1)
            out.append(block.reshape(4 * nI, Q))
        evv = self.wires_evaluation_value()
        out += [g.sub(wires[evv[0]], ev[0][nI])[None], g.sub(wires[evv[1]], ev[1][nI])[None]]
        return torch.cat(out)

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [InterpolationGenerator(row, self.subgroup_bits, self._degree)]

    def num_wires(self) -> int:
        return self._start_intermediates() + D * (2 * self.num_intermediates() + 1)

    def num_constants(self) -> int:
        return 0

    def num_constraints(self) -> int:
        return D * (2 + 2 * self.num_intermediates())


@functools.lru_cache(maxsize=None)
def _cached_gate(subgroup_bits: int, degree: int) -> CosetInterpolationGate:
    return CosetInterpolationGate(subgroup_bits, degree)


class InterpolationGenerator(SimpleGenerator):
    """The shifted point, the intermediates and the value of one row
    (reference gates/coset_interpolation.rs:287): the running first-form
    barycentric numerator over the subgroup, chunk by chunk."""

    def __init__(self, row: int, subgroup_bits: int, degree: int):
        self.row = row
        self.subgroup_bits = subgroup_bits
        self.degree = degree

    def _gate(self) -> CosetInterpolationGate:
        return _cached_gate(self.subgroup_bits, self.degree)

    def dependencies(self):
        gate = self._gate()
        cols = [0] + list(gate.wires_evaluation_point())
        cols += [c for i in range(gate.num_points()) for c in gate.wires_value(i)]
        return [Wire(self.row, c) for c in cols]

    def _out_cols(self) -> list[int]:
        gate = self._gate()
        cols = list(gate.wires_shifted_evaluation_point())
        for i in range(gate.num_intermediates()):
            cols += list(gate.wires_intermediate_eval(i)) + list(gate.wires_intermediate_prod(i))
        return cols + list(gate.wires_evaluation_value())

    def outputs(self):
        return [Wire(self.row, c) for c in self._out_cols()]

    @staticmethod
    def _interpolate(gate, x, values, ops):
        """(x, intermediates..., value) as ext2 pairs; `ops` holds the field
        ops of scalars or numpy rows: (sub, mul, ext_mul, ext_add, zero, one)."""
        sub, mul, ext_mul, ext_add, zero, one = ops
        domain = fs.two_adic_subgroup(gate.subgroup_bits)
        weights = gate.barycentric_weights
        ev, prod = (zero, zero), (one, zero)
        outs = [x]
        for i, chunk in enumerate(gate._chunks()):
            if i:
                outs += [ev, prod]
            for j in chunk:
                term = (sub(x[0], domain[j]), x[1])
                wv = (mul(weights[j], values[j][0]), mul(weights[j], values[j][1]))
                ev = ext_add(ext_mul(ev, term), ext_mul(wv, prod))
                prod = ext_mul(prod, term)
        return outs + [ev]

    def run_once(self, witness, out):
        gate = self._gate()
        v = witness.get_targets(self.dependencies())
        inv_shift = fs.inverse(v[0])
        x = (fs.mul(inv_shift, v[1]), fs.mul(inv_shift, v[2]))
        values = [(v[3 + 2 * i], v[4 + 2 * i]) for i in range(gate.num_points())]
        outs = self._interpolate(gate, x, values, (fs.sub, fs.mul, fs.ext_mul, fs.ext_add, 0, 1))
        out.set_wires(self.row, self._out_cols(), [c for e in outs for c in e])

    @classmethod
    def run_batch(cls, gens, witness):
        """Every row of the batch at once, numpy over the rows."""
        by: dict = {}
        for g_ in gens:
            by.setdefault((g_.subgroup_bits, g_.degree), []).append(g_)
        ops = (lambda a, c: npf.sub(a, np.uint64(c)),
               lambda c, a: npf.mul(np.uint64(c), a),
               lambda a, b: npf.ext2_mul(*a, *b), lambda a, b: npf.ext2_add(*a, *b),
               np.uint64(0), np.uint64(1))
        for key, group in by.items():
            gate = _cached_gate(*key)
            rows_ = np.fromiter((g_.row for g_ in group), np.int64, len(group))
            cols = [t.column for t in group[0].dependencies()]
            v = [witness.get_reps(witness.wire_reps(rows_, c)) for c in cols]
            inv_shift = np.asarray(fs.batch_inverse([int(s) for s in v[0]]), np.uint64)
            x = (npf.mul(inv_shift, v[1]), npf.mul(inv_shift, v[2]))
            values = [(v[3 + 2 * i], v[4 + 2 * i]) for i in range(gate.num_points())]
            outs = cls._interpolate(gate, x, values, ops)
            vals = [np.broadcast_to(c, rows_.shape) for e in outs for c in e]
            witness.set_reps(np.concatenate([witness.wire_reps(rows_, c)
                                             for c in group[0]._out_cols()]),
                             np.concatenate(vals))
