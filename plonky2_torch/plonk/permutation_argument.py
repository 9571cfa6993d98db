"""The copy constraints' disjoint-set forest and the sigma polynomials
(reference plonk/permutation_argument.rs; the reference package's
plonk/permutation_argument.py:12-82).

The reference keeps one parent entry per wire of the grid and per virtual
target (2.2 M at degree 2^14) and compresses every path in a Python loop.
Here only the entries that moved off themselves live in a dict, and
`compress_paths` writes them into an int64 array over the identity: the
same `parents` after compression, since the roots depend only on the
order of the merges (the root of `merge(x, y)` is x's). The wire partition
and the sigma cycles are computed on numpy in the reference's scan order
(row, then column).
"""

from __future__ import annotations

import numpy as np

from plonky2_torch.field import np_field as npf
from plonky2_torch.iop.target import Target, target_index


class Forest:
    def __init__(self, num_wires: int, num_routed_wires: int, degree: int,
                 num_virtual_targets: int):
        self.num_wires = num_wires
        self.num_routed_wires = num_routed_wires
        self.degree = degree
        self.size = num_wires * degree + num_virtual_targets
        self._parent: dict[int, int] = {}  # the entries that are not their own parent
        self.parents: np.ndarray | None = None  # after compress_paths

    def target_index(self, t: Target) -> int:
        return target_index(t, self.num_wires, self.degree)

    def find(self, x: int) -> int:
        parent = self._parent
        rep = x
        while rep in parent:
            rep = parent[rep]
        while x != rep:
            parent[x], x = rep, parent[x]
        return rep

    def merge(self, tx: Target, ty: Target) -> None:
        x = self.find(self.target_index(tx))
        y = self.find(self.target_index(ty))
        if x != y:
            self._parent[y] = x

    def compress_paths(self) -> np.ndarray:
        """Every entry's representative, [size] int64 (the reference's
        `parents` after `compress_paths`)."""
        parents = np.arange(self.size, dtype=np.int64)
        keys = list(self._parent)
        if keys:
            parents[np.asarray(keys, dtype=np.int64)] = [self.find(k) for k in keys]
        self.parents = parents
        return parents

    def sigma_polys(self, k_is: list[int], subgroup: np.ndarray) -> np.ndarray:
        """[num_routed_wires, degree] u64: sigma[col][row] = k_{c'} · g^{r'}
        for (r', c') the next routed wire of (row, col)'s class in scan
        order, the last wrapping to the first (reference
        permutation_argument.rs:90-140)."""
        n, nr = self.degree, self.num_routed_wires
        scan = (np.arange(n, dtype=np.int64)[:, None] * self.num_wires
                + np.arange(nr, dtype=np.int64)[None, :]).reshape(-1)
        reps = self.parents[scan]
        order = np.argsort(reps, kind="stable")  # each class's members in scan order
        sorted_reps = reps[order]
        starts = np.flatnonzero(np.r_[True, sorted_reps[1:] != sorted_reps[:-1]])
        ends = np.r_[starts[1:], order.shape[0]] - 1
        following = np.empty_like(order)
        following[:-1] = order[1:]
        following[ends] = order[starts]
        neighbor = np.empty_like(order)
        neighbor[order] = following
        k = np.asarray(k_is[:nr], dtype=np.uint64)
        sigma = npf.mul(k[neighbor % nr], np.asarray(subgroup, dtype=np.uint64)[neighbor // nr])
        return np.ascontiguousarray(sigma.reshape(n, nr).T)
