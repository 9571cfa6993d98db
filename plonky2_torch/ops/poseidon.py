"""Poseidon kernels K4 (`merkle_tree`, and `sponge` as its leaf step) and
K5 (`permute`, `grind_chunk`, `grind_device`) with their plain PyTorch
versions.

States are state-major: [12, N] int64, one column per state, so the batch
runs along the contiguous axis. A Merkle tree lives in one flat buffer:
level k (leaf digests at k = 0, the cap last) starts at word
8 * (N - (N >> k)) and is [4, N >> k] for a natural-order tree, [N >> k, 4]
for a row-leaf tree (`tree_layers`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar
from plonky2_torch.hash.poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    N_ROUNDS,
    SPONGE_RATE,
    SPONGE_WIDTH,
)
from plonky2_torch.ops import K4, K5, K5_CHUNK, K5_DEVICE, stream_ptr
from plonky2_torch.ops.build import check, library

W = SPONGE_WIDTH
_NONE = -1  # u64 max: no witness found in the chunk


@functools.lru_cache(maxsize=None)
def _round_constants(device: str) -> torch.Tensor:
    return g.tensor(ALL_ROUND_CONSTANTS, device)


def round_constants(device) -> torch.Tensor:
    """[N_ROUNDS * 12] round constants on `device`."""
    return _round_constants(str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _mds(device: str) -> torch.Tensor:
    m = [[MDS_MATRIX_CIRC[(i - r) % W] + (MDS_MATRIX_DIAG[r] if i == r else 0)
          for i in range(W)] for r in range(W)]
    return torch.tensor(m, dtype=torch.int64, device=device)


def _check_states(x, rows=None):
    if x.dtype != torch.int64 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("expected a contiguous [rows, N] int64 tensor")
    if rows is not None and x.shape[0] != rows:
        raise ValueError(f"expected {rows} rows, got {x.shape[0]}")


# -- plain versions ----------------------------------------------------------

def _sbox(x):
    x2 = g.mul(x, x)
    x3 = g.mul(x2, x)
    return g.mul(g.mul(x3, x3), x)


def _mds_plain(s):
    """MDS on [12, N]: 32-bit halves times the small matrix, one reduction."""
    m = _mds(str(s.device))[:, :, None]
    acc_lo = (m * (s & g.MASK32)[None]).sum(1)  # < 2^42
    acc_hi = (m * g.shr32(s)[None]).sum(1)
    t = acc_lo + ((acc_hi & g.MASK32) << 32)
    t = torch.where(g.lt(t, acc_lo), t + g.EPSILON, t)
    t2 = t + g.shr32(acc_hi) * g.EPSILON
    t2 = torch.where(g.lt(t2, t), t2 + g.EPSILON, t2)
    return g.canonicalize(t2)


def permute_plain(states):
    """Plain PyTorch version of K5: 30 rounds over [12, N]."""
    _check_states(states, W)
    rc = round_constants(states.device).reshape(N_ROUNDS, W, 1)
    s = states
    for r in range(N_ROUNDS):
        s = g.add(s, rc[r])
        if HALF_N_FULL_ROUNDS <= r < HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS:
            s = torch.cat([_sbox(s[:1]), s[1:]])
        else:
            s = _sbox(s)
        s = _mds_plain(s)
    return s


def sponge_plain(cols):
    """Plain PyTorch version of K4: overwrite-mode sponge per column."""
    _check_states(cols)
    width, n = cols.shape
    state = torch.zeros((W, n), dtype=torch.int64, device=cols.device)
    for i in range(0, width, SPONGE_RATE):
        chunk = cols[i:i + SPONGE_RATE]
        state = permute_plain(torch.cat([chunk, state[chunk.shape[0]:]]))
    return state[:4]


def _check_inter(inter):
    if len(inter) != W or not all(0 <= int(v) < 1 << 64 for v in inter):
        raise ValueError("inter must be 12 ints in [0, 2^64)")


def grind_chunk_plain(inter, pos: int, start: int, count: int, threshold: int,
                      device="cpu"):
    """Plain PyTorch version of K5's grind mode: the lowest candidate c in
    [start, start + count) whose permuted state[7] is below `threshold`
    (u64 compare), or None. `inter` is the transcript state (pending inputs
    written in) as 12 host ints."""
    _check_inter(inter)
    cand = torch.arange(count, dtype=torch.int64, device=device) + g.i64(start)
    states = g.tensor(list(inter), device)[:, None].expand(W, count).clone()
    states[pos] = cand
    resp = permute_plain(states)[SPONGE_RATE - 1]
    ok = torch.nonzero(g.lt(resp, g.i64(threshold)))
    return None if ok.numel() == 0 else start + int(ok[0, 0])


def _check_grind_state(state, pending, pow_bits: int) -> int:
    if state.dtype != torch.int64 or state.shape != (W,) or not state.is_contiguous():
        raise ValueError("state must be a contiguous [12] int64 tensor")
    if (pending.dtype != torch.int64 or pending.dim() != 1 or not pending.is_contiguous()
            or pending.device != state.device):
        raise ValueError("pending must be a contiguous [k] int64 tensor on the state's device")
    k = int(pending.shape[0])
    if not 0 <= k < SPONGE_RATE:
        raise ValueError(f"{k} pending inputs: a transcript holds fewer than {SPONGE_RATE}")
    if not 0 <= pow_bits <= 64:
        raise ValueError("pow_bits must lie in [0, 64]")
    return k


def grind_device_plain(state, pending, pow_bits: int, chunk: int = 1 << 12):
    """Plain PyTorch version of K5's device grind: the state and pending
    inputs read from their tensors, then `grind_chunk_plain` over the chunks
    [0, chunk), [chunk, 2 chunk), ... in order, so the first chunk holding a
    valid candidate gives the lowest valid witness. Returns it as an int64
    [1] on the state's device (0 for pow_bits = 0)."""
    k = _check_grind_state(state, pending, pow_bits)
    if pow_bits == 0:
        return torch.zeros((1,), dtype=torch.int64, device=state.device)
    inter = [int(v) for v in g.to_numpy(state)]
    inter[:k] = [int(v) for v in g.to_numpy(pending)]
    threshold = 1 << (64 - pow_bits)
    start = 0
    while start < scalar.P:
        witness = grind_chunk_plain(inter, k, start, chunk, threshold, state.device)
        if witness is not None:
            return torch.full((1,), g.i64(witness), dtype=torch.int64, device=state.device)
        start += chunk
    return torch.full((1,), _NONE, dtype=torch.int64, device=state.device)


# -- Merkle trees: layout, launch plan, plain version ------------------------

def tree_words(n: int, levels: int) -> int:
    """Words of a tree buffer: levels 0..`levels` of 4-word digests."""
    return 8 * (n - (n >> levels)) + 4 * (n >> levels)


def tree_layers(buf, n: int, levels: int, natural: bool):
    """Views of each level of a tree buffer: [4, n >> k] natural, else [n >> k, 4]."""
    layers = []
    for k in range(levels + 1):
        m = n >> k
        v = buf[8 * (n - m): 8 * (n - m) + 4 * m]
        layers.append(v.view(4, m) if natural else v.view(m, 4))
    return layers


def _check_leaves(leaves, cap_height: int, natural: bool):
    _check_states(leaves)
    n = int(leaves.shape[1] if natural else leaves.shape[0])
    lg_n = n.bit_length() - 1
    if n < 1 or 1 << lg_n != n:
        raise ValueError("leaf count must be a power of two")
    if not 0 <= cap_height <= lg_n:
        raise ValueError("cap height exceeds the tree height")
    return n, lg_n - cap_height


SMS = 132  # streaming multiprocessors of an H100 SXM
TREE_STATES = 128  # the kernel's largest block, in states
COALESCED_RUN = 32  # natural leaves: columns a warp reads contiguously


def tree_launches(lg_n: int, levels: int, natural: bool):
    """K4's launch plan for a tree of 2^lg_n leaves compressed `levels`
    levels: a list of (first level, levels compressed, states a block).

    The leaf launch hashes one leaf a state in blocks of up to 128 states,
    halved (to 32) while that leaves fewer than two blocks per SM. A block
    compresses its leaves as far as its subtree goes; for the natural shape
    it keeps runs of >= 32 contiguous columns, so its depth is lg(states) - 5.
    Each later launch starts from two digests a state and compresses up to
    8 levels; the last one is a single block ending at the cap. The first
    launch is the one that hashes the leaves."""
    n = 1 << lg_n
    states = TREE_STATES
    while states > COALESCED_RUN and n // states < 2 * SMS:
        states //= 2
    states = min(states, n)
    lg_s = states.bit_length() - 1
    depth = min(levels, max(lg_s - 5, 0) if natural else lg_s)
    plan = [(0, depth, states)]
    k = depth
    while k < levels:
        states = min(TREE_STATES, (n >> k) // 2)
        depth = min(levels - k, states.bit_length())
        plan.append((k, depth, states))
        k += depth
    return plan


def _hash_or_noop_plain(leaves, natural: bool):
    cols = leaves if natural else leaves.T
    width, n = cols.shape
    if width <= 4:
        pad = torch.zeros((4 - width, n), dtype=torch.int64, device=cols.device)
        out = torch.cat([cols, pad])
    else:
        out = sponge_plain(cols.contiguous())
    return out if natural else out.T


def merkle_tree_plain(leaves, cap_height: int, natural: bool):
    """Plain PyTorch version of K4's tree: one `sponge_plain` per level."""
    n, levels = _check_leaves(leaves, cap_height, natural)
    buf = torch.empty(tree_words(n, levels), dtype=torch.int64, device=leaves.device)
    layers = tree_layers(buf, n, levels, natural)
    layers[0].copy_(_hash_or_noop_plain(leaves, natural))
    for k in range(1, levels + 1):
        prev, m = layers[k - 1], n >> k
        if natural:  # pair (j, j + m)
            layers[k].copy_(sponge_plain(torch.cat([prev[:, :m], prev[:, m:]])))
        else:  # pair rows (2i, 2i + 1)
            layers[k].copy_(sponge_plain(prev.reshape(m, 8).T.contiguous()).T)
    return layers


# -- kernel wrappers ---------------------------------------------------------

def merkle_tree(leaves, cap_height: int, natural: bool):
    """K4: every level of the Poseidon Merkle tree over `leaves`, from the
    leaf digests (hash_or_noop) to the 2^cap_height cap, in one buffer;
    returns `tree_layers` views. natural: leaves are the columns of
    [width, N] and level k pairs (j, j + (N >> k)); else the rows of
    [N, width], paired (2i, 2i + 1)."""
    n, levels = _check_leaves(leaves, cap_height, natural)
    if not leaves.is_cuda:
        return merkle_tree_plain(leaves, cap_height, natural)
    buf = torch.empty(tree_words(n, levels), dtype=torch.int64, device=leaves.device)
    width = int(leaves.shape[0] if natural else leaves.shape[1])
    lib = library("poseidon")
    for i, (k0, depth, states) in enumerate(tree_launches(n.bit_length() - 1, levels, natural)):
        src = leaves.data_ptr() if i == 0 else None
        err = lib.k4_tree(src, buf.data_ptr(), n, width, k0, depth, states, int(natural),
                          stream_ptr(leaves))
        check(err, "k4_tree")
        K4.launches += 1
    return tree_layers(buf, n, levels, natural)


def sponge(cols):
    """K4's leaf step alone: [width, N] columns -> [4, N] digests
    (hash_or_noop(col); the sponge hash_n_to_m_no_pad(col, 4) for width > 4)."""
    _check_states(cols)
    if not cols.is_cuda:
        return _hash_or_noop_plain(cols, True)
    return merkle_tree(cols, cols.shape[1].bit_length() - 1, True)[0]


def permute(states):
    """K5: one Poseidon permutation of each column of [12, N]."""
    _check_states(states, W)
    if not states.is_cuda:
        return permute_plain(states)
    n = states.shape[1]
    out = torch.empty_like(states)
    if n == 0:
        return out
    err = library("poseidon").k5_permute(states.data_ptr(), out.data_ptr(), n, stream_ptr(states))
    check(err, "k5_permute")
    K5.launches += 1
    K5.batch1 += n == 1
    return out


def grind_chunk(inter, pos: int, start: int, count: int, threshold: int, device="cuda"):
    """K5 in grind mode over candidates [start, start + count) on `device`:
    the lowest valid witness of the chunk, or None. `inter` is the
    transcript state (pending inputs written in) as 12 host ints; the one
    synchronisation is the read of the witness."""
    device = torch.device(device)
    if device.type != "cuda":
        return grind_chunk_plain(inter, pos, start, count, threshold, device)
    _check_inter(inter)
    host = (ctypes.c_uint64 * W)(*[int(v) for v in inter])
    best = torch.full((1,), _NONE, dtype=torch.int64, device=device)
    err = library("poseidon").k5_grind(host, pos, start, count, threshold, best.data_ptr(),
                                       stream_ptr(best))
    check(err, "k5_grind")
    K5_CHUNK.launches += 1
    found = int(best.item())
    return None if found == _NONE else g.u64(found)


def grind_device(state, pending, pow_bits: int):
    """K5's device grind: the lowest witness w (over the whole field) for
    which permuting the transcript state [12] with its k pending inputs
    [k] written in and w at position k gives state[7] below
    2^(64 - pow_bits). Returns an int64 [1] on the state's device and reads
    nothing back (all ones where no field element passes). At pow_bits = 0
    every witness passes and 0 is returned without a launch."""
    k = _check_grind_state(state, pending, pow_bits)
    if pow_bits == 0:
        return torch.zeros((1,), dtype=torch.int64, device=state.device)
    if not state.is_cuda:
        return grind_device_plain(state, pending, pow_bits)
    best = torch.full((1,), _NONE, dtype=torch.int64, device=state.device)
    err = library("poseidon").k5_grind_device(
        state.data_ptr(), pending.data_ptr() if k else None, k, 1 << (64 - pow_bits),
        best.data_ptr(), stream_ptr(state))
    check(err, "k5_grind_device")
    K5_DEVICE.launches += 1
    return best
