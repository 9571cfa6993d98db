"""NTT kernels K2 (`ntt_rows`) and K3 (`ntt_four_step`) with their plain
PyTorch versions.

Both compute natural-order n-point NTTs (or inverse NTTs, 1/n included)
over the last axis of a [B, m] int64 tensor, with two options that the LDE
fuses in: a prologue `scale` table of shape [fan, m] (each input row fans
out to `fan` scaled copies) and, for fan > 1, the interleaved output layout
out[p, k*fan + j] = NTT(x[p] * scale[j])[k]. K2 also takes the zero-tail
form of a small LDE: `repeat_bits` = rb evaluates the m coefficients on the
(m << rb)-point domain. K2 holds one transform per block, so it serves
transforms of up to 2^MAX_SMEM_LG points; K3 serves the larger ones in two
launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.ops import K2, K3, stream_ptr
from plonky2_torch.ops.build import check, library
from plonky2_torch.util import log2_strict

MAX_SMEM_LG = 13  # 2^13 u64 = 64 KB of shared memory per transform


@functools.lru_cache(maxsize=None)
def bit_reverse_perm(lg_n: int) -> np.ndarray:
    """p[i] = reverse of i's lg_n-bit representation."""
    n = 1 << lg_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(lg_n):
        rev |= ((idx >> b) & 1) << (lg_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _bit_reverse_index(lg_n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(bit_reverse_perm(lg_n)).to(device)


def bit_reverse_index(lg_n: int, device) -> torch.Tensor:
    """`bit_reverse_perm(lg_n)` as an int64 index tensor on `device`, made
    once per size and device."""
    return _bit_reverse_index(lg_n, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _stage_twiddles_np(inverse: bool) -> np.ndarray:
    """Stage s (1..MAX_SMEM_LG) at offset 2^(s-1) - 1: [w_{2^s}^j, j < 2^(s-1)],
    w inverted for the inverse transform. A stage's row does not depend on
    the transform size, so one table serves every size."""
    rows = []
    for s in range(1, MAX_SMEM_LG + 1):
        root = fs.primitive_root_of_unity(s)
        if inverse:
            root = fs.inverse(root)
        rows.append(g.np_powers(root, 1 << (s - 1)))
    return np.concatenate(rows)


@functools.lru_cache(maxsize=None)
def _stage_twiddles(device: str, inverse: bool) -> torch.Tensor:
    return g.tensor(_stage_twiddles_np(inverse), device)


def stage_twiddles(device, inverse: bool) -> torch.Tensor:
    return _stage_twiddles(str(torch.device(device)), inverse)


@functools.lru_cache(maxsize=None)
def _four_step_twiddles_np(lg_n: int, inverse: bool) -> np.ndarray:
    """[a, b] table w_n^(k1*i2), flattened; the inverse has w_n^-1 and 1/n."""
    lg_a = (lg_n + 1) // 2
    a, b = 1 << lg_a, 1 << (lg_n - lg_a)
    w = fs.primitive_root_of_unity(lg_n)
    if inverse:
        w = fs.inverse(w)
    row = g.np_powers(w, b).astype(object)
    out = np.empty((a, b), dtype=np.uint64)
    cur = np.full(b, fs.inverse(1 << lg_n) if inverse else 1, dtype=object)
    for k1 in range(a):
        out[k1] = (cur % fs.P).astype(np.uint64)
        cur = (cur * row) % fs.P
    return out.reshape(-1)


@functools.lru_cache(maxsize=None)
def _four_step_twiddles(lg_n: int, inverse: bool, device: str) -> torch.Tensor:
    return g.tensor(_four_step_twiddles_np(lg_n, inverse), device)


def four_step_twiddles(lg_n: int, inverse: bool, device) -> torch.Tensor:
    return _four_step_twiddles(lg_n, inverse, str(torch.device(device)))


def _check(x, scale, fan, repeat_bits):
    if x.dtype != torch.int64 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("expected a contiguous [B, m] int64 tensor")
    m = x.shape[1]
    log2_strict(m)
    if fan < 1 or (fan > 1 and repeat_bits):
        raise ValueError("fan-out and the zero-tail form do not combine")
    if scale is not None:
        if (scale.shape != (fan, m) or scale.dtype != torch.int64
                or scale.device != x.device or not scale.is_contiguous()):
            raise ValueError(f"scale must be a contiguous [{fan}, {m}] int64 "
                             "tensor on the input's device")


def _dit_last(v, lg: int, start: int, inverse: bool):
    """DIT stages start+1..lg over the last axis of bit-reversed input."""
    n = 1 << lg
    batch = v.shape[:-1]
    tw = stage_twiddles(v.device, inverse)
    for s in range(start + 1, lg + 1):
        half = 1 << (s - 1)
        w = tw[half - 1:2 * half - 1]
        vv = v.reshape(batch + (n >> s, 2, half))
        even, odd = vv[..., 0, :], vv[..., 1, :]
        t = g.mul(odd, w)
        v = torch.stack([g.add(even, t), g.sub(even, t)], dim=-2).reshape(batch + (n,))
    return v


def _ntt_last(v, lg: int, inverse: bool):
    """Unscaled NTT over the last axis (natural order in and out)."""
    return _dit_last(v[..., bit_reverse_index(lg, v.device)], lg, 0, inverse)


def _fan_out(x, scale, fan):
    v = x[:, None, :]
    if scale is not None:
        return g.mul(v, scale[None])
    return v.expand(x.shape[0], fan, x.shape[1])


def _interleave(v, B0, fan, L):
    """[B0, fan, L] -> [B0, L*fan] with out[p, k*fan + j] = v[p, j, k]."""
    if fan == 1:
        return v.reshape(B0, L)
    return v.transpose(1, 2).reshape(B0, L * fan)


# -- K2 --------------------------------------------------------------------

def ntt_rows(x, inverse: bool = False, scale=None, fan: int = 1,
             repeat_bits: int = 0):
    """K2: one whole transform per block, up to 2^MAX_SMEM_LG points.

    x: [B, m] natural order. Output [B, m << repeat_bits] (fan == 1) or the
    interleaved [B, m * fan]."""
    _check(x, scale, fan, repeat_bits)
    if not x.is_cuda:
        return ntt_rows_plain(x, inverse, scale, fan, repeat_bits)
    B0, m = x.shape
    lg_m = log2_strict(m)
    lg = lg_m + repeat_bits
    if lg < 1 or lg > MAX_SMEM_LG:
        raise ValueError(f"ntt_rows takes 2..2^{MAX_SMEM_LG} points, got 2^{lg}")
    L = 1 << lg
    out = torch.empty((B0, L * fan), dtype=torch.int64, device=x.device)
    if B0 == 0:
        return out
    final = fs.inverse(L) if inverse else 1
    err = library("ntt").k2_ntt_rows(
        x.data_ptr(), out.data_ptr(), stage_twiddles(x.device, inverse).data_ptr(),
        None if scale is None else scale.data_ptr(),
        B0 * fan, lg_m, repeat_bits, fan, final, int(inverse), stream_ptr(x))
    check(err, "k2_ntt_rows")
    K2.launches += 1
    return out


def ntt_rows_plain(x, inverse: bool = False, scale=None, fan: int = 1,
                   repeat_bits: int = 0):
    """Plain PyTorch version of K2: bit-reverse, repeat, DIT stage by stage."""
    _check(x, scale, fan, repeat_bits)
    B0, m = x.shape
    lg_m = log2_strict(m)
    lg = lg_m + repeat_bits
    L = 1 << lg
    v = _fan_out(x, scale, fan)[..., bit_reverse_index(lg_m, x.device)]
    if repeat_bits:
        v = v.repeat_interleave(1 << repeat_bits, dim=-1)
    v = _dit_last(v, lg, repeat_bits, inverse)
    if inverse:
        v = g.mul_scalar(v, fs.inverse(L))
    return _interleave(v, B0, fan, L)


# -- K3 --------------------------------------------------------------------

def ntt_four_step(x, inverse: bool = False, scale=None, fan: int = 1):
    """K3: Bailey four-step transform for sizes beyond one block, in two
    launches through a scratch buffer.

    x: [B, n] natural order. Output [B, n] (fan == 1) or the interleaved
    [B, n * fan]."""
    _check(x, scale, fan, 0)
    if not x.is_cuda:
        return ntt_four_step_plain(x, inverse, scale, fan)
    B0, n = x.shape
    lg_n = log2_strict(n)
    if lg_n < 2 or lg_n > 2 * MAX_SMEM_LG:
        raise ValueError(f"ntt_four_step takes 2^2..2^{2 * MAX_SMEM_LG} points")
    out = torch.empty((B0, n * fan), dtype=torch.int64, device=x.device)
    if B0 == 0:
        return out
    scratch = torch.empty((B0 * fan, n), dtype=torch.int64, device=x.device)
    err = library("ntt").k3_ntt_four_step(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        stage_twiddles(x.device, inverse).data_ptr(),
        four_step_twiddles(lg_n, inverse, x.device).data_ptr(),
        None if scale is None else scale.data_ptr(),
        B0 * fan, lg_n, fan, int(inverse), stream_ptr(x))
    check(err, "k3_ntt_four_step")
    K3.launches += 2
    return out


def ntt_four_step_plain(x, inverse: bool = False, scale=None, fan: int = 1):
    """Plain PyTorch version of K3: NTT_a down the columns of the [a, b]
    view, twiddle w^(k1*i2), NTT_b along the rows, out[k1 + a*k2]."""
    _check(x, scale, fan, 0)
    B0, n = x.shape
    lg_n = log2_strict(n)
    lg_a = (lg_n + 1) // 2
    lg_b = lg_n - lg_a
    a, b = 1 << lg_a, 1 << lg_b
    v = _fan_out(x, scale, fan).reshape(B0 * fan, a, b)
    A = _ntt_last(v.transpose(1, 2), lg_a, inverse)  # [B, i2, k1]
    tw4 = four_step_twiddles(lg_n, inverse, x.device).reshape(a, b)
    A = g.mul(A, tw4.T)
    C = _ntt_last(A.transpose(1, 2), lg_b, inverse)  # [B, k1, k2]
    out = C.transpose(1, 2).reshape(B0, fan, n)
    return _interleave(out, B0, fan, n)
