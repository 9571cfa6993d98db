"""PolynomialBatch: the FRI commitment oracle, device-resident.

All column polynomials of a commitment are one [num_polys, n] tensor:
iFFT -> coset LDE -> Poseidon Merkle tree over the LDE's natural layout
(`NaturalMerkleTree`). Under a non-algebraic hasher (Keccak) the LDE's
columns are gathered into bit-reversed row leaves [N, num_polys] on the
device, as the reference's `_values_to_lde_leaves` makes them, and those
leaves come to the host once for the host tree (`KeccakMerkleTree`).
A blinding batch (zero knowledge) salts each leaf with SALT_SIZE random
felts from the prover rng, drawn as the reference draws them: a
[SALT_SIZE, N] matrix appended as rows of the natural tree's columns, or an
[N, SALT_SIZE] matrix appended to the row leaves; both are one stream of
SALT_SIZE · N draws, so `salt_stream` makes either layout from it.
`prove_openings` forms the batch quotients by evaluating on the LDE domain
and dividing by (x - z) pointwise, then one coset iFFT, and hands the
result to the FRI prover.

Under a process group (`plonky2_torch.parallel`) a batch keeps its
coefficients whole and holds the rank's parts of the LDE (part v the
columns c = v (mod P), `lde_parts` [L, num_polys, N / P]) and their part
of the tree (`ShardedMerkleTree`, or under Keccak `ShardedKeccakMerkleTree`
over the parts' blocks of row leaves): `from_values` runs the iFFT
poly-sharded and all-gathers the coefficients, `_commit` computes the
rank's parts alone (`ntt.coset_lde_parts`) and takes their columns (or
rows) of the salt, and `part` slices the local form out of a batch
committed whole.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from plonky2_torch import parallel, resolve_device
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.proof import SALT_SIZE
from plonky2_torch.fri.prover import fri_proof
from plonky2_torch.hash.merkle import (
    KeccakMerkleTree,
    NaturalMerkleTree,
    ShardedKeccakMerkleTree,
    ShardedMerkleTree,
)
from plonky2_torch.util import log2_strict, reverse_bits, rng

def _as_tensor(x, device):
    """Tensors stay where they are (a device argument must agree; "cuda"
    with no index agrees with any card); host data uploads to `device` (CUDA
    unless the caller asks for another), by the bit pattern of its values."""
    if isinstance(x, torch.Tensor):
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != x.device.type
                                 or want.index not in (None, x.device.index)):
            raise ValueError(f"tensor on {x.device}, device={device} requested")
        if x.dtype != torch.int64:
            raise ValueError("field tensors are int64")
        return x.contiguous()
    return g.tensor(x, resolve_device(device))


def salt_stream(lde_size: int) -> np.ndarray:
    """One blinding commitment's SALT_SIZE · N salt felts from the prover
    rng, in draw order."""
    return rng.field_elements(SALT_SIZE * lde_size, fs.P)


class PolynomialBatch:
    """A batch of committed polynomials sharing one Merkle-cap tree."""

    def __init__(self, coeffs, lde, merkle_tree, degree_log: int, rate_bits: int,
                 blinding: bool, group=None):
        self.polynomials = coeffs  # [num_polys, n] coefficients, whole
        # [num_polys, N] natural-order coset-LDE values; under a group the
        # rank's parts, [L, num_polys, N / P] (`lde_parts`)
        self._lde = lde
        self.merkle_tree = merkle_tree
        self.degree_log = degree_log
        self.rate_bits = rate_bits
        self.blinding = blinding
        self.group = group

    @staticmethod
    def from_values(values, rate_bits: int, blinding: bool, cap_height: int,
                    device=None, hasher=None, salt=None) -> "PolynomialBatch":
        """salt: a blinding batch's salt stream (`salt_stream`, on the host
        or the device), else drawn here."""
        group = parallel.active_mesh()
        if group is None:
            coeffs = ntt.ifft(_as_tensor(values, device))
        else:
            local, num_polys = parallel.pad_shard_polys(
                _as_tensor(values, group.device if device is None else device), group)
            coeffs = parallel.gather_polys(ntt.ifft(local), group)[:num_polys]
        return PolynomialBatch._commit(coeffs, rate_bits, blinding, cap_height, hasher, salt,
                                       group)

    @staticmethod
    def from_coeffs(coeffs, rate_bits: int, blinding: bool, cap_height: int,
                    device=None, hasher=None, salt=None) -> "PolynomialBatch":
        group = parallel.active_mesh()
        if group is not None and device is None:
            device = group.device
        coeffs = _as_tensor(coeffs, device)
        return PolynomialBatch._commit(coeffs, rate_bits, blinding, cap_height, hasher, salt,
                                       group)

    @staticmethod
    def _commit(coeffs, rate_bits, blinding, cap_height, hasher, salt=None, group=None):
        if group is not None:
            return PolynomialBatch._commit_part(coeffs, rate_bits, blinding, cap_height, hasher,
                                                salt, group)
        lde = ntt.coset_lde(coeffs, rate_bits)
        n_lde = lde.shape[-1]
        if blinding:
            salt = _as_tensor(salt_stream(n_lde) if salt is None else salt, lde.device)
        if getattr(hasher, "algebraic", True):  # Poseidon (the default): K4 on the card
            cols = torch.cat([lde, salt.reshape(SALT_SIZE, n_lde)]) if blinding else lde
            tree = NaturalMerkleTree(cols, cap_height)
        else:
            leaves = _lde_leaves(lde)
            if blinding:
                leaves = torch.cat([leaves, salt.reshape(n_lde, SALT_SIZE)], dim=1)
            tree = KeccakMerkleTree(leaves, cap_height)
        return PolynomialBatch(coeffs, lde, tree, log2_strict(coeffs.shape[-1]),
                               rate_bits, blinding)

    @staticmethod
    def _commit_part(coeffs, rate_bits, blinding, cap_height, hasher, salt, group):
        """`_commit` of the rank's parts of the LDE and their part of the tree."""
        group.check_parts(coeffs.shape[-1] << rate_bits, "LDE points")
        lde = ntt.coset_lde_parts(coeffs, rate_bits, group.own_parts, group.parts)
        n_lde = lde.shape[-1] * group.parts
        if blinding:
            salt = _as_tensor(salt_stream(n_lde) if salt is None else salt, lde.device)
        if getattr(hasher, "algebraic", True):
            cols = lde
            if blinding:
                cols = torch.cat([lde, parallel.shard_parts(salt.reshape(SALT_SIZE, n_lde),
                                                            group)], dim=1)
            tree = ShardedMerkleTree(cols.contiguous(), cap_height, group)
        else:  # each part's block of row leaves, salted with the same rows of the salt
            blocks = [_lde_leaves(part) for part in lde]
            if blinding:
                m = blocks[0].shape[0]
                rows = salt.reshape(n_lde, SALT_SIZE)
                blocks = [torch.cat([leaves, rows[j * m:(j + 1) * m]], dim=1)
                          for leaves, j in zip(blocks, (reverse_bits(v, group.lg_parts)
                                                        for v in group.own_parts))]
            leaves = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
            tree = ShardedKeccakMerkleTree(leaves, cap_height, group)
        return PolynomialBatch(coeffs, lde, tree, log2_strict(coeffs.shape[-1]), rate_bits,
                               blinding, group)

    def part(self, group) -> "PolynomialBatch":
        """Rank group.rank's local form of this batch committed whole (the
        constants-sigmas batch of the circuit data): the coefficients, the
        rank's parts of the LDE and its part of the tree
        (`NaturalMerkleTree.part` or `KeccakMerkleTree.part`), with no
        rehash."""
        return PolynomialBatch(self.polynomials,
                               parallel.shard_parts(self.lde, group).contiguous(),
                               self.merkle_tree.part(group), self.degree_log, self.rate_bits,
                               self.blinding, group)

    @property
    def lde_parts(self):
        """Under a group the rank's parts of the LDE, [L, num_polys, N / P]."""
        if self.group is None:
            raise ValueError("a batch committed with no group has no parts")
        return self._lde

    @property
    def lde(self):
        """The natural-order LDE [num_polys, N]; under a group the rank's
        parts side by side, [num_polys, L N / P] (`parallel.shard_columns`'
        layout: a view at one part, else a copy)."""
        if self.group is None:
            return self._lde
        if self._lde.shape[0] == 1:
            return self._lde[0]
        return torch.movedim(self._lde, 0, -2).reshape(self._lde.shape[1], -1)

    @property
    def device(self):
        return self.polynomials.device

    @property
    def lde_bits(self) -> int:
        return self.degree_log + self.rate_bits

    def get_lde_values(self, index: int, step: int = 1) -> list[int]:
        """The polynomials' values at LDE point index · step, the salt
        stripped (reference fri/oracle.rs:142-151): the row leaf
        rev(index · step) of a host tree, the natural column index · step
        otherwise."""
        i = index * step
        if isinstance(self.merkle_tree, KeccakMerkleTree):
            leaf = self.merkle_tree.leaf(reverse_bits(i, self.lde_bits))
            return leaf[:len(leaf) - (SALT_SIZE if self.blinding else 0)]
        if self.group is not None:  # from the owner rank: the others add zeros
            group = parallel.communicator(self.group)
            v, k = i % group.parts, group.world
            col = self._lde[v // k if v % k == group.rank else 0][:, i // group.parts]
            col = col * int(v % k == group.rank)
            return [int(x) for x in g.to_numpy(group.all_reduce_disjoint(col))]
        return [int(v) for v in g.to_numpy(self.lde[:, i])]

    # -- batch opening proof ------------------------------------------------

    @staticmethod
    def prove_openings(instance, oracles, challenger, fri_params, hasher=None,
                       final_poly_coeff_len=None, max_num_query_steps=None):
        """FRI opening proof of `instance` over `oracles`, its fold trees
        under `hasher`, its transcript in the unified shape where the two
        lengths are given (`fri_proof`); returns FriProof."""
        alpha = challenger.get_extension_challenge(2)
        rate_bits = fri_params.config.rate_bits
        n = 1 << fri_params.degree_bits
        device = oracles[0].device
        final = (torch.zeros(n, dtype=torch.int64, device=device),
                 torch.zeros(n, dtype=torch.int64, device=device))
        for batch in instance.batches:
            polys = torch.stack([oracles[p.oracle_index].polynomials[p.polynomial_index]
                                 for p in batch.polynomials])
            q = _batch_quotient(polys, alpha, batch.point, rate_bits)
            # final = alpha^(batch size) * final + quotient (ReducingFactor shift)
            shift = fs.ext_exp(alpha, len(batch.polynomials))
            final = g.ext2_add(g.ext2_mul(g.ext_tensor(shift, device), final), q)
        return fri_proof([o.merkle_tree for o in oracles], final, challenger, fri_params,
                         hasher, final_poly_coeff_len, max_num_query_steps)


def _lde_leaves(lde):
    """The natural LDE [num_polys, N] as the reference's row leaves
    [N, num_polys] in bit-reversed order (reference fri/oracle.py
    `_coeffs_to_lde_leaves_impl`), on the LDE's device."""
    lg = log2_strict(lde.shape[-1])
    return lde[:, ntt.bit_reverse_index(lg, lde.device)].T.contiguous()


def eval_polys_at(coeffs, z):
    """[J, n] base coefficients at the extension point z (host ints or 0-d
    tensors) -> (e0, e1) [J]."""
    zp0, zp1 = g.ext2_powers(z, coeffs.shape[-1], coeffs.device)
    return (g.sum_mod(g.mul(coeffs, zp0[None, :]), 1),
            g.sum_mod(g.mul(coeffs, zp1[None, :]), 1))


@functools.lru_cache(maxsize=None)
def _coset_domain(lg_n: int, device: str):
    """[N] domain points g_mult · w^i of the FRI evaluation coset."""
    pts = g.np_powers(fs.primitive_root_of_unity(lg_n), 1 << lg_n).astype(object)
    pts = (pts * fs.MULTIPLICATIVE_GROUP_GENERATOR) % fs.P
    return g.tensor(pts.astype("uint64"), device)


def _batch_quotient(polys, alpha, z, rate_bits):
    """Coefficients of (F(X) - F(z)) / (X - z) for F = sum_j alpha^j f_j.

    polys: [J, n] base coefficients; alpha, z: extension elements, host
    ints or 0-d tensors on the polys' device (the device transcript's
    draws). Returns ext coefficient tensors (q0, q1) of length n."""
    J, n = polys.shape
    device = polys.device
    zz = g.ext_tensor(z, device)
    ap0, ap1 = g.ext2_powers(alpha, J, device)
    comp0 = g.sum_mod(g.mul(polys, ap0[:, None]), 0)
    comp1 = g.sum_mod(g.mul(polys, ap1[:, None]), 0)
    zp = g.ext2_powers(zz, n)
    fz = g.ext2_sum_mod(g.ext2_mul((comp0, comp1), zp))
    ev = ntt.coset_lde(torch.stack([comp0, comp1]), rate_bits)  # [2, N]
    N = ev.shape[1]
    xs = _coset_domain(log2_strict(N), str(device))
    num = (g.sub(ev[0], fz[0]), g.sub(ev[1], fz[1]))
    den = (g.sub(xs, zz[0]), g.neg(zz[1].expand(N)))
    qv = g.ext2_mul(num, g.ext2_inverse(den))
    q = ntt.coset_ifft(torch.stack(qv))[:, :n]  # degree < n: the tail is zero
    return q[0], q[1]
