"""Merkle-cap trees over Poseidon, built by kernel K4 (`ops.poseidon.merkle_tree`)
in at most three launches into one buffer of every level.

A `MerkleCap` of height h is the h-th layer from the root: 2^h digests in
place of the root. Digests are 4 felts; leaves of width <= 4 pass through
unhashed (`hash_or_noop`).

`NaturalMerkleTree` commits the LDE's natural [width, N] layout directly
(same commitment as the reference's bit-reversed row leaves) and pairs
contiguous halves per level; `MerkleTree` hashes row leaves [n, width]
and pairs adjacent rows (the FRI fold trees). Layers stay on the device as
views of the tree's buffer; query openings are gathered on the device at
device indices (`gather`) and leave it in one packed copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.ops import poseidon as kp
from plonky2_torch.util import reverse_bits


@dataclass
class MerkleProof:
    """Siblings from the leaf-digest level up to (excluding) the cap level."""

    siblings: list[list[int]]


def _proofs(leaves, sibs, levels):
    """Host (leaf, proof) pairs from gathered numpy arrays."""
    return [
        ([int(v) for v in leaves[qi]],
         MerkleProof([[int(v) for v in sibs[qi, k]] for k in range(levels)]))
        for qi in range(leaves.shape[0])
    ]


def gather_openings_rows(leaves, layers, idx, shift_bits: int = 0):
    """Openings of a row-leaf tree at device indices (reference
    hash/merkle.py `_gather_openings_rows_ref`): leaf i = idx >> shift_bits
    of leaves [n, width], and at each level k the sibling (i >> k) ^ 1 of
    layers[k] [n >> k, 4]. Returns (leaves [q, width], siblings
    [q, levels, 4]); the indices never leave the device."""
    i = idx >> shift_bits
    sibs = [layer[(i >> k) ^ 1] for k, layer in enumerate(layers)]
    return leaves[i], _stack_sibs(sibs, i.shape[0], leaves.device)


def gather_openings_cols(cols, layers, idx, lg_n: int, shift_bits: int = 0):
    """Openings of a natural-order tree at device reference indices
    (reference `_gather_openings_cols_ref`): cols [width, 2^lg_n], layers[k]
    [4, 2^lg_n >> k]. Reference leaf i is natural column r = rev_lg_n(i)
    (one lookup in a cached bit-reversal table), and its level-k sibling
    rev_{lg_n-k}((i >> k) ^ 1) is r's low lg_n - k bits with the top one
    flipped."""
    from plonky2_torch.ops.ntt import bit_reverse_index

    r = bit_reverse_index(lg_n, cols.device)[idx >> shift_bits]
    sibs = [layer[:, (r & ((1 << (lg_n - k)) - 1)) ^ (1 << (lg_n - k - 1))].T
            for k, layer in enumerate(layers)]
    return cols[:, r].T, _stack_sibs(sibs, r.shape[0], cols.device)


class MerkleTree:
    """Tree over row leaves [n, width]; layers[k] is [n >> k, 4]."""

    def __init__(self, leaves, cap_height: int = 0):
        self.leaves = leaves
        self.cap_height = cap_height
        self._layers = kp.merkle_tree(leaves, cap_height, natural=False)
        self._cap = None

    @property
    def cap_dev(self):
        """The cap on the device, [2^cap_height, 4] in digest order."""
        return self._layers[-1]

    @property
    def cap(self) -> list[list[int]]:
        if self._cap is None:
            cap = g.to_numpy(self._layers[-1])
            self._cap = [[int(v) for v in row] for row in cap]
        return self._cap

    def gather(self, idx, shift_bits: int = 0):
        """(leaves [q, width], siblings [q, levels, 4]) at device indices."""
        return gather_openings_rows(self.leaves, self._layers[:-1], idx, shift_bits)

    def open_many_dev(self, indices: list[int]):
        """(leaves [q, width], siblings [q, levels, 4]) gathered on the device."""
        return self.gather(torch.tensor(indices, dtype=torch.int64, device=self.leaves.device))

    def open_many(self, indices: list[int]):
        return open_many_packed([self], [indices])[0]


class NaturalMerkleTree:
    """Tree over natural-order columns [width, n]; layers[k] is [4, n >> k].

    Level-k invariant: ref_digest_k[i] == layers[k][:, rev_{lg_n-k}(i)], so
    cap and openings remap indices and present the reference's interface."""

    def __init__(self, cols, cap_height: int = 0):
        self.cap_height = cap_height
        self._lg_n = int(cols.shape[1]).bit_length() - 1
        self._cols = cols
        self._layers = kp.merkle_tree(cols, cap_height, natural=True)
        self._cap = None

    @property
    def cap_dev(self):
        """The cap layer on the device, [4, 2^cap_height]: the reference's
        digest c is column rev(c)."""
        return self._layers[-1]

    @property
    def cap(self) -> list[list[int]]:
        if self._cap is None:
            cap = g.to_numpy(self._layers[-1])
            self._cap = [[int(v) for v in cap[:, reverse_bits(c, self.cap_height)]]
                         for c in range(1 << self.cap_height)]
        return self._cap

    def gather(self, idx, shift_bits: int = 0):
        """(leaves [q, width], siblings [q, levels, 4]) at device reference
        indices."""
        return gather_openings_cols(self._cols, self._layers[:-1], idx, self._lg_n, shift_bits)

    def open_many_dev(self, indices: list[int]):
        """(leaves [q, width], siblings [q, levels, 4]) gathered on the
        device at host reference indices."""
        return self.gather(torch.tensor(indices, dtype=torch.int64, device=self._cols.device))

    def open_many(self, indices: list[int]):
        return open_many_packed([self], [indices])[0]


def _stack_sibs(sibs, q, device):
    if sibs:
        return torch.stack(sibs, dim=1)
    return torch.zeros((q, 0, 4), dtype=torch.int64, device=device)


def open_many_packed(trees, tree_indices):
    """Open many indices on many trees with ONE device-to-host copy.
    Returns, per tree, a list of (leaf values, MerkleProof)."""
    parts = []
    for tree, idxs in zip(trees, tree_indices):
        leaves, sibs = tree.open_many_dev(idxs)
        parts.append((leaves.shape, sibs.shape, leaves.reshape(-1), sibs.reshape(-1)))
    flat = g.to_numpy(torch.cat([x for p in parts for x in p[2:]]))
    out, pos = [], 0
    for (q, w), (_, levels, _), _, _ in parts:
        leaves = flat[pos:pos + q * w].reshape(q, w)
        pos += q * w
        sibs = flat[pos:pos + q * levels * 4].reshape(q, levels, 4)
        pos += q * levels * 4
        out.append(_proofs(leaves, sibs, levels))
    return out


def verify_merkle_proof_to_cap(leaf, leaf_index, cap, proof, hasher=None) -> None:
    """Raise if the proof is invalid (host scalar check)."""
    if hasher is None:
        from plonky2_torch.hash.hashers import PoseidonHasher

        hasher = PoseidonHasher
    digest = hasher.hash_or_noop(leaf)
    idx = leaf_index
    for sibling in proof.siblings:
        if idx & 1:
            digest = hasher.two_to_one(sibling, digest)
        else:
            digest = hasher.two_to_one(digest, sibling)
        idx >>= 1
    if digest != list(cap[idx]):
        raise ValueError(f"Merkle proof invalid: leaf {leaf_index} digest != cap[{idx}]")


def make_merkle_tree(leaves, cap_height: int) -> MerkleTree:
    """The Poseidon row-leaf tree (the only hasher the port has so far)."""
    return MerkleTree(leaves, cap_height)
