"""Batched NTT / iNTT / coset LDE over Goldilocks on torch tensors.

Semantics follow the reference package's `field/ntt.py`: `fft` maps
coefficients to evaluations over the order-n two-adic subgroup in natural
order, `ifft` is its inverse, `coset_fft` evaluates on shift·<g>, and
`lde_fft` evaluates a degree < m polynomial on the (shifted) domain of size
m << rate_bits. Transforms run along the last axis; leading axes are batch.

One dispatch rule for every size: a transform of up to 2^13 points runs in
kernel K2 (one block holds it in shared memory), a larger one in the
four-step kernel K3. The LDE takes the interleaved-coset form at n >= 2^10
(2^rate coset FFTs of m points, fused scale prologue and interleaved write)
and the zero-tail form below (bit-reversed coefficients repeated 2^rate
times, remaining DIT stages).
"""

from __future__ import annotations

import functools

import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.ops import ntt as kn
from plonky2_torch.util import log2_strict

bit_reverse_perm = kn.bit_reverse_perm
bit_reverse_index = kn.bit_reverse_index

INTERLEAVED_LDE_MIN = 1 << 10


def _rows(x):
    """[..., n] -> contiguous [B, n] view and the batch shape."""
    batch = x.shape[:-1]
    return x.reshape(-1, x.shape[-1]).contiguous(), batch


def transform(x, inverse: bool = False, scale=None, fan: int = 1,
              repeat_bits: int = 0):
    """The dispatch rule: K2 up to 2^13 points, K3 beyond. x: [B, m]."""
    lg = log2_strict(x.shape[-1]) + repeat_bits
    if lg <= kn.MAX_SMEM_LG:
        return kn.ntt_rows(x, inverse, scale, fan, repeat_bits)
    if repeat_bits:
        raise ValueError("the zero-tail LDE form is for small domains only")
    return kn.ntt_four_step(x, inverse, scale, fan)


def fft(coeffs):
    """Coefficients -> evaluations on <g_n>, natural order."""
    x, batch = _rows(coeffs)
    return transform(x).reshape(batch + (x.shape[-1],))


def ifft(values):
    """Evaluations -> coefficients (inverse of fft, 1/n included)."""
    x, batch = _rows(values)
    return transform(x, inverse=True).reshape(batch + (x.shape[-1],))


@functools.lru_cache(maxsize=None)
def _powers_table(base: int, n: int, device: str):
    return g.tensor(g.np_powers(base % fs.P, n), device)


def shift_powers(shift: int, n: int, device, inverse: bool = False):
    """[1, s, ..., s^(n-1)] with s = shift (or its inverse) on `device`."""
    base = fs.inverse(shift) if inverse else shift
    return _powers_table(base, n, str(torch.device(device)))


def coset_fft(coeffs, shift: int | None = None):
    """Evaluate on the coset shift·<g_n> (default shift = field generator)."""
    if shift is None:
        shift = fs.MULTIPLICATIVE_GROUP_GENERATOR
    x, batch = _rows(coeffs)
    n = x.shape[-1]
    scale = shift_powers(shift, n, x.device).reshape(1, n)
    return transform(x, scale=scale).reshape(batch + (n,))


def coset_ifft(values, shift: int | None = None):
    if shift is None:
        shift = fs.MULTIPLICATIVE_GROUP_GENERATOR
    n = values.shape[-1]
    return g.mul(ifft(values), shift_powers(shift, n, values.device, inverse=True))


@functools.lru_cache(maxsize=None)
def _lde_coset_scale_table(shift: int, lg_m: int, rate_bits: int, device: str):
    """[2^rate, m] table: row j = powers of (shift · w_n^j)."""
    m = 1 << lg_m
    w_n = fs.primitive_root_of_unity(lg_m + rate_bits)
    rows = [g.np_powers(fs.mul(shift % fs.P, fs.exp(w_n, j)), m)
            for j in range(1 << rate_bits)]
    return g.tensor(rows, device)


def lde_fft(coeffs, rate_bits: int, shift: int | None = None):
    """Low-degree extension of degree < m polynomials to m << rate_bits
    points of the (shifted) subgroup."""
    x, batch = _rows(coeffs)
    m = x.shape[-1]
    lg_m = log2_strict(m)
    lg_n = lg_m + rate_bits
    if (1 << lg_n) >= INTERLEAVED_LDE_MIN and rate_bits > 0:
        # interleaved-coset form: out[s*2^rate + j] = F_j[s] with
        # F_j = fft(coeffs * powers(shift * w_n^j))
        table = _lde_coset_scale_table(shift or 1, lg_m, rate_bits, str(x.device))
        out = transform(x, scale=table, fan=1 << rate_bits)
    else:
        scale = None
        if shift is not None and shift != 1:
            scale = shift_powers(shift, m, x.device).reshape(1, m)
        out = transform(x, scale=scale, repeat_bits=rate_bits)
    return out.reshape(batch + (1 << lg_n,))


def coset_lde(coeffs, rate_bits: int):
    """LDE onto the g-shifted coset (the FRI evaluation domain)."""
    return lde_fft(coeffs, rate_bits, shift=fs.MULTIPLICATIVE_GROUP_GENERATOR)


def coset_lde_part(coeffs, rate_bits: int, part: int, parts: int):
    """The natural columns c = part (mod parts) of `coset_lde(coeffs,
    rate_bits)`, [..., N / parts] with local column i the global column
    part + parts i: the points a w_(N / parts)^i with a = g w_N^part, a
    coset of the subgroup of order M = N / parts. Where `parts` (a power
    of two) divides 2^rate_bits that is the LDE at rate_bits - lg parts on
    the coset a (in the interleaved form, the scale table's rows part::parts
    and a fan of 2^rate_bits / parts); above, M is below the degree n, and
    the coefficients are first reduced mod x^M - a^M (the sum of their n / M
    slices of M, slice s times a^(M s)), whose values on the coset are the
    same, and take the plain coset NTT of M points."""
    lg_parts = log2_strict(parts)
    if not 0 <= part < parts:
        raise ValueError(f"part {part} of {parts}")
    lg_m = log2_strict(coeffs.shape[-1])
    lg_n = lg_m + rate_bits
    if lg_parts > lg_n:
        raise ValueError(f"{parts} parts of a {1 << lg_n}-point LDE")
    shift = fs.mul(fs.MULTIPLICATIVE_GROUP_GENERATOR,
                   fs.exp(fs.primitive_root_of_unity(lg_n), part))
    if lg_parts <= rate_bits:
        return lde_fft(coeffs, rate_bits - lg_parts, shift=shift)
    m = 1 << (lg_n - lg_parts)
    slices = coeffs.reshape(tuple(coeffs.shape[:-1]) + (-1, m))
    weights = g.powers(fs.exp(shift, m), slices.shape[-2], coeffs.device)
    folded = g.sum_mod(g.mul(slices, weights[:, None]), -2)
    return lde_fft(folded, 0, shift=shift)
