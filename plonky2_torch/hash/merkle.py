"""Merkle-cap trees over Poseidon, built by kernel K4 (`ops.poseidon.merkle_tree`)
in at most three launches into one buffer of every level.

A `MerkleCap` of height h is the h-th layer from the root: 2^h digests in
place of the root. Digests are 4 felts; leaves of width <= 4 pass through
unhashed (`hash_or_noop`).

`NaturalMerkleTree` commits the LDE's natural [width, N] layout directly
(same commitment as the reference's bit-reversed row leaves) and pairs
contiguous halves per level; `MerkleTree` hashes row leaves [n, width]
and pairs adjacent rows (the FRI fold trees). Layers stay on the device as
views of the tree's buffer; query openings leave it in one packed copy
(`open_many_packed`).
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


class MerkleTree:
    """Tree over row leaves [n, width]; layers[k] is [n >> k, 4]."""

    def __init__(self, leaves, cap_height: int = 0):
        self.leaves = leaves
        self.cap_height = cap_height
        self._layers = kp.merkle_tree(leaves, cap_height, natural=False)
        self._cap = None

    @property
    def cap(self) -> list[list[int]]:
        if self._cap is None:
            cap = g.to_numpy(self._layers[-1])
            self._cap = [[int(v) for v in row] for row in cap]
        return self._cap

    def open_many_dev(self, indices: list[int]):
        """(leaves [q, width], siblings [q, levels, 4]) gathered on the device."""
        dev = self.leaves.device
        idx = torch.tensor(indices, dtype=torch.int64, device=dev)
        sibs = [layer[(idx >> k) ^ 1] for k, layer in enumerate(self._layers[:-1])]
        return self.leaves[idx], _stack_sibs(sibs, len(indices), dev)

    def open_many(self, indices: list[int]):
        return open_many_packed([self], [indices])[0]


class NaturalMerkleTree:
    """Tree over natural-order columns [width, n]; layers[k] is [4, n >> k].

    Level-k invariant: ref_digest_k[i] == layers[k][:, rev_{lg_n-k}(i)], so
    cap and openings remap indices on the host and present the reference's
    interface."""

    def __init__(self, cols, cap_height: int = 0):
        self.cap_height = cap_height
        self._lg_n = int(cols.shape[1]).bit_length() - 1
        self._cols = cols
        self._layers = kp.merkle_tree(cols, cap_height, natural=True)
        self._cap = None

    @property
    def cap(self) -> list[list[int]]:
        if self._cap is None:
            cap = g.to_numpy(self._layers[-1])
            self._cap = [[int(v) for v in cap[:, reverse_bits(c, self.cap_height)]]
                         for c in range(1 << self.cap_height)]
        return self._cap

    def open_many_dev(self, indices: list[int]):
        """(leaves [q, width], siblings [q, levels, 4]) gathered on the
        device; reference indices map to natural columns on the host."""
        dev = self._cols.device
        levels = self._lg_n - self.cap_height
        leaf_idx = torch.tensor([reverse_bits(i, self._lg_n) for i in indices],
                                dtype=torch.int64, device=dev)
        sibs = []
        for k in range(levels):
            sib = torch.tensor(
                [reverse_bits((i >> k) ^ 1, self._lg_n - k) for i in indices],
                dtype=torch.int64, device=dev)
            sibs.append(self._layers[k][:, sib].T)
        return self._cols[:, leaf_idx].T, _stack_sibs(sibs, len(indices), dev)

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
