"""Poseidon kernels K4 (`sponge`) and K5 (`permute`, `grind_chunk`) with
their plain PyTorch versions.

States are state-major: [12, N] int64, one column per state, so the batch
runs along the contiguous axis.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from plonky2_torch.field import goldilocks as g
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
from plonky2_torch.ops import K4, K5, stream_ptr
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


def grind_chunk_plain(inter, pos: int, start: int, count: int, threshold: int):
    """Plain PyTorch version of K5's grind mode: the lowest candidate c in
    [start, start + count) whose permuted state[7] is below `threshold`
    (u64 compare), or None."""
    cand = torch.arange(count, dtype=torch.int64, device=inter.device) + g.i64(start)
    states = inter[:, None].expand(W, count).clone()
    states[pos] = cand
    resp = permute_plain(states)[SPONGE_RATE - 1]
    ok = torch.nonzero(g.lt(resp, g.i64(threshold)))
    return None if ok.numel() == 0 else start + int(ok[0, 0])


# -- kernel wrappers ---------------------------------------------------------

def sponge(cols):
    """K4: [width, N] columns -> [4, N] digests (hash_n_to_m_no_pad(col, 4))."""
    _check_states(cols)
    if not cols.is_cuda:
        return sponge_plain(cols)
    width, n = cols.shape
    out = torch.empty((4, n), dtype=torch.int64, device=cols.device)
    if n == 0:
        return out
    err = library("poseidon").k4_sponge(
        cols.data_ptr(), out.data_ptr(), width, n,
        round_constants(cols.device).data_ptr(), stream_ptr(cols))
    check(err, "k4_sponge")
    K4.launches += 1
    return out


def permute(states):
    """K5: one Poseidon permutation of each column of [12, N]."""
    _check_states(states, W)
    if not states.is_cuda:
        return permute_plain(states)
    n = states.shape[1]
    out = torch.empty_like(states)
    if n == 0:
        return out
    err = library("poseidon").k5_permute(
        states.data_ptr(), out.data_ptr(), n,
        round_constants(states.device).data_ptr(), stream_ptr(states))
    check(err, "k5_permute")
    K5.launches += 1
    return out


def grind_chunk(inter, pos: int, start: int, count: int, threshold: int):
    """K5 in grind mode over candidates [start, start + count): the lowest
    valid witness of the chunk, or None. `inter` is the [12] transcript
    state (pending inputs written in) on the device that grinds."""
    if inter.shape != (W,) or inter.dtype != torch.int64:
        raise ValueError("inter must be a [12] int64 tensor")
    if not inter.is_cuda:
        return grind_chunk_plain(inter, pos, start, count, threshold)
    host = (ctypes.c_uint64 * W)(*[g.u64(v) for v in inter.tolist()])
    best = torch.full((1,), _NONE, dtype=torch.int64, device=inter.device)
    err = library("poseidon").k5_grind(
        host, pos, start, count, threshold,
        round_constants(inter.device).data_ptr(), best.data_ptr(),
        stream_ptr(inter))
    check(err, "k5_grind")
    K5.launches += 1
    found = int(best.item())
    return None if found == _NONE else g.u64(found)
