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


@functools.lru_cache(maxsize=None)
def _parts_scale_table(lg_m: int, rate_bits: int, rows: tuple, device: str):
    """The rows `rows` of the coset LDE's scale table (`_lde_coset_scale_table`
    at the field generator), [len(rows), m]."""
    whole = _lde_coset_scale_table(fs.MULTIPLICATIVE_GROUP_GENERATOR, lg_m, rate_bits, device)
    return whole[list(rows)].contiguous()


def coset_lde_parts(coeffs, rate_bits: int, parts: tuple, count: int):
    """`coset_lde_part` of each of `parts` (of `count`), stacked:
    [len(parts), ..., N / count]. One part is `coset_lde_part` itself.
    Where `count` divides 2^rate_bits, part v is the fan rows j = v (mod
    count) of the interleaved LDE (out[s 2^rate + j] = F_j[s]), so the
    parts are one LDE launch over those rows of the scale table, in part
    order: local column s (2^rate / count) + u of part v is fan row
    v + count u at point s. K2 takes a power-of-two fan, so there the rows
    are padded with copies of the first and the copies dropped. Above
    2^rate_bits each part is folded and transformed on its own."""
    if len(parts) == 1:
        return coset_lde_part(coeffs, rate_bits, parts[0], count)[None]
    lg_count = log2_strict(count)
    lg_m = log2_strict(coeffs.shape[-1])
    if lg_count > lg_m + rate_bits:
        raise ValueError(f"{count} parts of a {1 << (lg_m + rate_bits)}-point LDE")
    if lg_count > rate_bits:
        return torch.stack([coset_lde_part(coeffs, rate_bits, v, count) for v in parts])
    x, batch = _rows(coeffs)
    fan = 1 << (rate_bits - lg_count)
    rows = [v + count * u for v in parts for u in range(fan)]
    padded = rows
    if lg_m <= kn.MAX_SMEM_LG and len(rows) & (len(rows) - 1):
        padded = rows + [rows[0]] * ((1 << len(rows).bit_length()) - len(rows))
    table = _parts_scale_table(lg_m, rate_bits, tuple(padded), str(x.device))
    out = transform(x, scale=table, fan=len(padded))  # [B, m * len(padded)]
    out = out.reshape(x.shape[0], x.shape[-1], len(padded))[..., :len(rows)]
    out = out.reshape(x.shape[0], x.shape[-1], len(parts), fan).permute(2, 0, 1, 3)
    return out.reshape((len(parts),) + batch + (x.shape[-1] * fan,))
