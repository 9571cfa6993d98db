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

`ShardedMerkleTree` is one rank's part of a natural tree over a process
group (`plonky2_torch.parallel`): its parts' columns and their subtrees,
the cap gathered whole, openings from the owner rank.

`KeccakMerkleTree` is the tree of `KeccakGoldilocksConfig`, over byte
digests of `KeccakHasher.HASH_SIZE`: its row leaves come to the host in one
copy and every level is hashed there in one batch (reference
hash/merkle.py:415-460). `ShardedKeccakMerkleTree` is one rank's part of
it over a group: its parts' contiguous blocks of row leaves and their
subtrees, hashed on the rank's host, the cap gathered whole, openings from
the owner rank. `HOST_TREES` adds up this process's seconds of those
copies and of the hashing, for a prove's phase split.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
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

    return _gather_natural(cols, layers, bit_reverse_index(lg_n, cols.device)[idx >> shift_bits],
                           lg_n)


def _gather_natural(cols, layers, r, lg_n: int):
    """`gather_openings_cols` at natural columns r: the leaf column r, and
    at level k the sibling (r mod 2^(lg_n - k)) ^ 2^(lg_n - k - 1)."""
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

    def part(self, group) -> "ShardedMerkleTree":
        """Rank group.rank's part of this tree over a group (layout:
        `plonky2_torch.parallel`): for each of its parts v the columns
        c = v (mod P) and the global levels' digests at the same residues,
        sliced out of this whole tree with no rehash; the levels above the
        local roots (where P exceeds 2^cap_height) and the cap stay whole."""
        count, p = group.parts, group.lg_parts
        local_cap = max(self.cap_height - p, 0)
        levels = self._lg_n - p - local_cap

        def parts(x):
            own = group.own_parts
            if len(own) == 1:
                return x[:, own[0]::count].contiguous()[None]
            return torch.stack([x[:, v::count] for v in own])
        return ShardedMerkleTree(
            parts(self._cols), self.cap_height, group,
            layers=[parts(layer) for layer in self._layers[:levels + 1]],
            top=self._layers[levels:-1] if p > self.cap_height else [],
            cap_dev=self._layers[-1])


class ShardedMerkleTree(NaturalMerkleTree):
    """One rank's part of a natural tree over [width, N] split over a group
    (`plonky2_torch.parallel`): for each of the rank's parts v (of P) the
    columns c = v (mod P), stacked as [L, width, N / P], and their local
    natural tree, cut at cap height cap_height - p, whose level-l digest i
    is the global level-l digest v + P i (`_layers[l]`: [L, 4, N / P >> l]).
    The cap is all-gathered (where P > 2^cap_height, the P local roots are,
    and the levels above them are hashed whole on every rank): `cap_dev`
    and `cap` are the whole tree's. `gather` opens reference indices: the
    rank owning a query's natural column gathers its leaf and path, the
    others zeros, and one SUM all-reduce gives every rank all of them."""

    def __init__(self, cols, cap_height: int, group, layers=None, top=None, cap_dev=None):
        self.group = group
        self.cap_height = cap_height
        self._cols = cols
        lg_local = int(cols.shape[-1]).bit_length() - 1
        p = group.lg_parts
        self._lg_n = lg_local + p
        local_cap = max(cap_height - p, 0)
        if local_cap > lg_local:
            raise ValueError("cap height exceeds the tree height")
        if layers is None:
            trees = [kp.merkle_tree(part, local_cap, natural=True) for part in cols]
            layers = ([layer[None] for layer in trees[0]] if len(trees) == 1
                      else [torch.stack(level) for level in zip(*trees)])
        self._layers = layers
        self._top = list(top or [])
        if cap_dev is None:
            roots = group.gather_parts(self._layers[-1])  # [P, 4, 2^local_cap]
            layer = roots.permute(1, 2, 0).reshape(4, -1).contiguous()  # global order
            if p > cap_height:
                top_layers = kp.merkle_tree(layer, cap_height, natural=True)
                self._top, cap_dev = top_layers[:-1], top_layers[-1]
            else:
                cap_dev = layer
        self._cap_dev = cap_dev
        self._cap = None

    @property
    def cap_dev(self):
        """The whole cap layer, [4, 2^cap_height] (column rev(c) is the
        reference's digest c)."""
        return self._cap_dev

    @property
    def cap(self) -> list[list[int]]:
        if self._cap is None:
            cap = g.to_numpy(self._cap_dev)
            self._cap = [[int(v) for v in cap[:, reverse_bits(c, self.cap_height)]]
                         for c in range(1 << self.cap_height)]
        return self._cap

    def gather(self, idx, shift_bits: int = 0):
        """(leaves [q, width], siblings [q, levels, 4]) at device reference
        indices, whole on every rank."""
        from plonky2_torch import parallel
        from plonky2_torch.ops.ntt import bit_reverse_index

        group = parallel.communicator(self.group)
        p, k = group.lg_parts, group.world
        c = bit_reverse_index(self._lg_n, self._cols.device)[idx >> shift_bits]
        v = c & (group.parts - 1)
        if k == group.parts:  # one part a rank
            own, t = v == group.rank, torch.zeros_like(v)
        else:
            own = v % k == group.rank
            t = torch.where(own, v // k, 0)
        i = c >> p
        lg_local = self._lg_n - p
        sibs = [layer[t, :, (i & ((1 << (lg_local - l)) - 1)) ^ (1 << (lg_local - l - 1))]
                for l, layer in enumerate(self._layers[:-1])]
        leaves = self._cols[t, :, i]
        sibs = _stack_sibs(sibs, i.shape[0], i.device)
        flat = group.all_reduce_disjoint(torch.cat([
            torch.where(own[:, None], leaves, 0).reshape(-1),
            torch.where(own[:, None, None], sibs, 0).reshape(-1)]))
        leaves = flat[:leaves.numel()].reshape(leaves.shape)
        sibs = flat[leaves.numel():].reshape(sibs.shape)
        if self._top:  # the whole levels above the local roots
            top = [layer[:, (c & (layer.shape[1] - 1)) ^ (layer.shape[1] >> 1)].T
                   for layer in self._top]
            sibs = torch.cat([sibs, torch.stack(top, dim=1)], dim=1)
        return leaves, sibs


def _stack_sibs(sibs, q, device):
    if sibs:
        return torch.stack(sibs, dim=1)
    return torch.zeros((q, 0, 4), dtype=torch.int64, device=device)


def open_many_packed(trees, tree_indices):
    """Open many indices on many trees: the device trees' openings with ONE
    device-to-host copy, the host (Keccak) trees' on the host (reference
    fri/prover.py `_open_many_packed`). Returns, per tree, a list of (leaf
    values, MerkleProof)."""
    parts, out = [], [None] * len(trees)
    for slot, (tree, idxs) in enumerate(zip(trees, tree_indices)):
        if isinstance(tree, KeccakMerkleTree):
            out[slot] = tree.open_many(idxs)
            continue
        leaves, sibs = tree.open_many_dev(idxs)
        parts.append((slot, leaves.shape, sibs.shape, leaves.reshape(-1), sibs.reshape(-1)))
    if parts:
        flat = g.to_numpy(torch.cat([x for p in parts for x in p[3:]]))
        pos = 0
        for slot, (q, w), (_, levels, _), _, _ in parts:
            leaves = flat[pos:pos + q * w].reshape(q, w)
            pos += q * w
            sibs = flat[pos:pos + q * levels * 4].reshape(q, levels, 4)
            pos += q * levels * 4
            out[slot] = _proofs(leaves, sibs, levels)
    return out


def verify_merkle_proof_to_cap(leaf, leaf_index, cap, proof, hasher=None) -> None:
    """Raise if the proof is invalid (host scalar check). Digests are 4-felt
    lists under Poseidon, bytes under Keccak."""
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
    expected = cap[idx] if isinstance(cap[idx], (bytes, bytearray)) else list(cap[idx])
    if digest != expected:
        raise ValueError(f"Merkle proof invalid: leaf {leaf_index} digest != cap[{idx}]")


# seconds spent by Keccak trees: "copy_s" bringing leaves to the host,
# "hash_s" hashing them; "trees" counts the trees built
HOST_TREES = {"copy_s": 0.0, "hash_s": 0.0, "trees": 0}


def reset_host_trees() -> None:
    HOST_TREES.update(copy_s=0.0, hash_s=0.0, trees=0)


class KeccakMerkleTree:
    """A tree over row leaves [n, width] with byte digests, hashed on the
    host level by level (reference hash/merkle.py `KeccakMerkleTree`).
    `leaves` is a u64 numpy array or a tensor, which comes to the host in
    one copy; layers[k] is [n >> k, HASH_SIZE] u8 and the cap is its last
    level as a list of bytes."""

    def __init__(self, leaves, cap_height: int = 0):
        from plonky2_torch.hash.hashers import KeccakHasher

        t0 = time.perf_counter()
        if isinstance(leaves, torch.Tensor):
            leaves = g.to_numpy(leaves)
        self.leaves = np.ascontiguousarray(leaves, dtype=np.uint64)
        t1 = time.perf_counter()
        self.cap_height = cap_height
        lg_n = int(self.leaves.shape[0]).bit_length() - 1
        if 1 << lg_n != self.leaves.shape[0]:
            raise ValueError(f"{self.leaves.shape[0]} leaves is not a power of two")
        layers = [KeccakHasher.hash_leaves_batch(self.leaves)]
        for _ in range(lg_n - cap_height):
            layers.append(KeccakHasher.compress_batch(layers[-1]))
        self._layers = layers
        self.cap = [bytes(row) for row in layers[-1]]
        HOST_TREES["copy_s"] += t1 - t0
        HOST_TREES["hash_s"] += time.perf_counter() - t1
        HOST_TREES["trees"] += 1

    def leaf(self, leaf_index: int) -> list[int]:
        return [int(v) for v in self.leaves[leaf_index]]

    def prove(self, leaf_index: int) -> MerkleProof:
        return MerkleProof([bytes(layer[(leaf_index >> k) ^ 1])
                            for k, layer in enumerate(self._layers[:-1])])

    def open_many(self, indices: list[int]):
        """(leaf values, MerkleProof) at each index, on the host."""
        idx = np.asarray(indices, dtype=np.int64)
        leaves = self.leaves[idx]
        sibs = [layer[(idx >> k) ^ 1] for k, layer in enumerate(self._layers[:-1])]
        return [([int(v) for v in leaves[qi]],
                 MerkleProof([bytes(level[qi]) for level in sibs]))
                for qi in range(len(indices))]

    def part(self, group) -> "ShardedKeccakMerkleTree":
        """Rank group.rank's part of this tree over a group, sliced out with
        no rehash: its parts' blocks of row leaves, the same blocks of each
        level up to the local cap, the whole levels above the local roots
        (where P exceeds 2^cap_height) and the whole cap."""
        p = group.lg_parts
        lg_m = int(self.leaves.shape[0]).bit_length() - 1 - p
        blocks = [reverse_bits(v, p) for v in group.own_parts]  # the parts' blocks of rows
        local_cap = max(self.cap_height - p, 0)

        def rows(x, l):
            return np.concatenate([x[(j << lg_m) >> l:((j + 1) << lg_m) >> l] for j in blocks])
        return ShardedKeccakMerkleTree(
            rows(self.leaves, 0), self.cap_height, group,
            layers=[rows(layer, l) for l, layer in enumerate(self._layers[:lg_m - local_cap + 1])],
            top=self._layers[lg_m:-1] if p > self.cap_height else [], cap=self.cap)


class ShardedKeccakMerkleTree(KeccakMerkleTree):
    """One rank's part of a Keccak tree over row leaves [N, width] split over
    a group: each of the rank's parts v (of P = 2^p), the natural LDE
    columns c = v (mod P), is the block of row leaves [j N / P, (j + 1) N / P)
    with j = rev_p(v), and `leaves` are those blocks in part order,
    [L N / P, width] (the bit-reversed rows of each part's columns,
    `fri.oracle._lde_leaves`). The rank hashes their subtrees on its host up
    to cap height cap_height - p (pairs of adjacent rows never cross a
    block); the P local caps are all-gathered as digests into the whole cap
    in block order (where P > 2^cap_height the P roots are, and the levels
    above them are hashed whole on every rank). `open_many` opens reference
    indices: the owner of each index's block gathers its leaf and path, the
    others zeros, and one SUM all-reduce gives every rank all of them."""

    def __init__(self, leaves, cap_height: int, group, layers=None, top=None, cap=None):
        from plonky2_torch.hash.hashers import KeccakHasher

        self.group = group
        p = group.lg_parts
        L = len(group.own_parts)
        lg_m = int(leaves.shape[0] // L).bit_length() - 1
        if L << lg_m != leaves.shape[0]:
            raise ValueError(f"{leaves.shape[0]} leaves are not {L} blocks of a power of two")
        local_cap = max(cap_height - p, 0)
        if local_cap > lg_m:
            raise ValueError("cap height exceeds the tree height")
        if layers is None:
            t0 = time.perf_counter()
            if isinstance(leaves, torch.Tensor):
                leaves = g.to_numpy(leaves)
            self.leaves = np.ascontiguousarray(leaves, dtype=np.uint64)
            t1 = time.perf_counter()
            layers = [KeccakHasher.hash_leaves_batch(self.leaves)]
            for _ in range(lg_m - local_cap):
                layers.append(KeccakHasher.compress_batch(layers[-1]))
            HOST_TREES["copy_s"] += t1 - t0
            HOST_TREES["hash_s"] += time.perf_counter() - t1
            HOST_TREES["trees"] += 1
        else:
            self.leaves = np.ascontiguousarray(leaves, dtype=np.uint64)
        self._layers = list(layers)
        self._lg_m = lg_m
        self.cap_height = cap_height
        self._top = list(top or [])
        if cap is None:
            local = torch.from_numpy(np.ascontiguousarray(self._layers[-1])).to(group.device)
            # [P, 2^local_cap, HASH_SIZE] in part order, then in block order
            caps = group.gather_parts(local.reshape(L, 1 << local_cap, -1)).cpu().numpy()
            layer = caps[[reverse_bits(j, p) for j in range(group.parts)]].reshape(
                -1, KeccakHasher.HASH_SIZE)
            t0 = time.perf_counter()
            for _ in range(p - cap_height):
                self._top.append(layer)
                layer = KeccakHasher.compress_batch(layer)
            HOST_TREES["hash_s"] += time.perf_counter() - t0
            cap = [bytes(row) for row in layer]
        self.cap = cap

    def open_many(self, indices: list[int]):
        """(leaf values, MerkleProof) at each reference index, whole on
        every rank."""
        from plonky2_torch import parallel

        group = parallel.communicator(self.group)
        p, k = group.lg_parts, group.world
        idx = np.asarray(indices, dtype=np.int64)
        lg_m = self._lg_m
        v = np.asarray([reverse_bits(int(j), p) for j in idx >> lg_m], dtype=np.int64)
        own = v % k == group.rank
        row = np.where(own, v // k, 0) * (1 << lg_m) + (idx & ((1 << lg_m) - 1))
        leaves = np.where(own[:, None], self.leaves[row], np.uint64(0))
        sibs = np.zeros((len(idx), len(self._layers) - 1, self._layers[0].shape[1]), np.int64)
        for l, layer in enumerate(self._layers[:-1]):
            sibs[:, l] = np.where(own[:, None], layer[(row >> l) ^ 1], 0)
        flat = torch.from_numpy(np.concatenate([leaves.view(np.int64).reshape(-1),
                                                sibs.reshape(-1)])).to(group.device)
        flat = group.all_reduce_disjoint(flat).cpu().numpy()
        leaves = flat[:leaves.size].view(np.uint64).reshape(leaves.shape)
        sibs = flat[leaves.size:].astype(np.uint8).reshape(sibs.shape)
        top = [layer[(idx >> (lg_m + m)) ^ 1] for m, layer in enumerate(self._top)]
        return [([int(x) for x in leaves[qi]],
                 MerkleProof([bytes(level) for level in sibs[qi]]
                             + [bytes(level[qi]) for level in top]))
                for qi in range(len(indices))]

    def leaf(self, leaf_index: int) -> list[int]:
        return self.open_many([leaf_index])[0][0]

    def prove(self, leaf_index: int) -> MerkleProof:
        return self.open_many([leaf_index])[0][1]


def make_merkle_tree(leaves, cap_height: int, hasher=None):
    """The row-leaf tree of `hasher`: K4's Poseidon tree on the leaves'
    device, or the host Keccak tree for a non-algebraic hasher."""
    if getattr(hasher, "algebraic", True):
        return MerkleTree(leaves, cap_height)
    return KeccakMerkleTree(leaves, cap_height)


class BatchMerkleTree:
    """One Merkle cap over row matrices of decreasing heights (reference
    hash/batch_merkle_tree.rs:17-165; the reference package's
    hash/merkle.py:478-580). Segment k is K4's tree over its leaves, stopped
    at the next matrix's height (the cap's at the last): the tallest
    matrix's rows for the first segment, [running digests ‖ rows] for each
    later one. Query i reads row i >> (top - h) of a matrix of height h.
    `leaves`: [2^h_k, width_k] int64 tensors on one device, h_k strictly
    decreasing."""

    def __init__(self, leaves: list, cap_height: int):
        if not leaves:
            raise ValueError("a batch tree needs at least one matrix")
        heights = [int(m.shape[0]).bit_length() - 1 for m in leaves]
        if any(1 << h != m.shape[0] for h, m in zip(heights, leaves)):
            raise ValueError("every matrix's height must be a power of two")
        if any(a <= b for a, b in zip(heights, heights[1:])):
            raise ValueError("the matrices' heights must decrease strictly")
        if cap_height > heights[-1]:
            raise ValueError("the cap is taller than the shortest matrix")
        self.cap_height = cap_height
        self.leaf_heights = heights
        self._mats = leaves
        self._segments = []  # per matrix: its segment's levels, the next matrix's height last
        digests = None
        for k, mat in enumerate(leaves):
            stop = heights[k + 1] if k + 1 < len(leaves) else cap_height
            seg = mat if k == 0 else torch.cat([digests, mat], dim=1)
            self._segments.append(kp.merkle_tree(seg, stop, natural=False))
            digests = self._segments[-1][-1]
        self._cap = None

    @property
    def cap_dev(self):
        """The cap on the device, [2^cap_height, 4] in digest order."""
        return self._segments[-1][-1]

    @property
    def cap(self) -> list[list[int]]:
        if self._cap is None:
            self._cap = [[int(v) for v in row] for row in g.to_numpy(self.cap_dev)]
        return self._cap

    def gather(self, idx, shift_bits: int = 0):
        """(the rows of every matrix side by side [q, Σ widths], the
        siblings of every segment in walk order [q, levels, 4]) at device
        indices."""
        top = self.leaf_heights[0]
        i = idx >> shift_bits
        rows = torch.cat([m[i >> (top - h)] for m, h in zip(self._mats, self.leaf_heights)],
                         dim=1)
        sibs = [layer[((i >> (top - h)) >> k) ^ 1]
                for seg, h in zip(self._segments, self.leaf_heights)
                for k, layer in enumerate(seg[:-1])]
        return rows, _stack_sibs(sibs, i.shape[0], i.device)

    def open_many_dev(self, indices: list[int]):
        return self.gather(torch.tensor(indices, dtype=torch.int64,
                                        device=self._mats[0].device))

    def open_batch_many(self, indices: list[int]):
        """(the matrices' rows concatenated, MerkleProof) at each index, in
        one device-to-host copy."""
        return open_many_packed([self], [indices])[0]

    def values(self, leaf_index: int) -> list[list[int]]:
        """Each matrix's row at the leaf index."""
        rows = self.open_batch_many([leaf_index])[0][0]
        out, pos = [], 0
        for m in self._mats:
            out.append(rows[pos:pos + m.shape[1]])
            pos += m.shape[1]
        return out

    def open_batch(self, leaf_index: int) -> MerkleProof:
        return self.open_batch_many([leaf_index])[0][1]


def verify_batch_merkle_proof_to_cap(leaf_data: list, leaf_heights: list, leaf_index: int,
                                     cap, proof: MerkleProof, hasher=None) -> None:
    """Raise if the batch path is invalid (reference hash/merkle_proofs.rs:72-110):
    the first matrix's row hashed, each sibling compressed in, and the next
    matrix's row absorbed with the digest where the walk reaches its height."""
    if hasher is None:
        from plonky2_torch.hash.hashers import PoseidonHasher

        hasher = PoseidonHasher
    if len(leaf_data) != len(leaf_heights):
        raise ValueError("one leaf row for each matrix")
    current = hasher.hash_or_noop(list(leaf_data[0]))
    height = leaf_heights[0]
    data_index = 1
    for sibling in proof.siblings:
        bit = leaf_index & 1
        leaf_index >>= 1
        current = (hasher.two_to_one(sibling, current) if bit
                   else hasher.two_to_one(current, sibling))
        height -= 1
        if data_index < len(leaf_heights) and height == leaf_heights[data_index]:
            current = hasher.hash_or_noop(list(current) + list(leaf_data[data_index]))
            data_index += 1
    if list(current) != list(cap[leaf_index]):
        raise ValueError("Batch Merkle proof invalid")
