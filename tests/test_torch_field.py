"""The port's Goldilocks field (plonky2_torch.field.goldilocks) against the
reference package's device field on the same numpy-seeded inputs. Exact
equality: every value is an integer mod p."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plonky2_tpu.field import goldilocks as jg
from plonky2_tpu.field import scalar as fs
from plonky2_torch.field import goldilocks as tg


def _inputs(seed, n=512):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, fs.P, size=n, dtype=np.uint64)
    b = rng.integers(0, fs.P, size=n, dtype=np.uint64)
    # boundary values (as in tests/test_pallas_ops.py)
    edge = np.array([0, 1, fs.P - 1, fs.EPSILON, fs.EPSILON + 1, 1 << 32,
                     fs.P - (1 << 32)], dtype=np.uint64)
    return np.concatenate([a, edge]), np.concatenate([b, edge[::-1]])


def _t(x):
    return tg.tensor(x, "cpu")


def _same(port, ref):
    np.testing.assert_array_equal(tg.to_numpy(port), np.asarray(ref, dtype=np.uint64))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_reference(op):
    a, b = _inputs(1)
    _same(getattr(tg, op)(_t(a), _t(b)), getattr(jg, op)(jnp.asarray(a), jnp.asarray(b)))


def test_unary_ops_match_reference():
    a, _ = _inputs(2)
    _same(tg.neg(_t(a)), jg.neg(jnp.asarray(a)))
    _same(tg.square(_t(a)), jg.square(jnp.asarray(a)))
    _same(tg.exp_u64(_t(a), 12345), jg.exp_u64(jnp.asarray(a), 12345))
    _same(tg.inverse(_t(a)), jax.jit(jg.inverse)(jnp.asarray(a)))
    _same(tg.canonicalize(_t(np.array([fs.P, fs.P + 5, (1 << 64) - 1], dtype=np.uint64))),
          jg.to_field(np.array([fs.P, fs.P + 5, (1 << 64) - 1], dtype=np.uint64)))


def test_reduce128_matches_reference_on_arbitrary_u64():
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 1 << 64, size=256, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, size=256, dtype=np.uint64)
    _same(tg.reduce128(_t(lo), _t(hi)), jg.reduce128(jnp.asarray(lo), jnp.asarray(hi)))
    want = [(int(x) + (int(y) << 64)) % fs.P for x, y in zip(lo, hi)]
    assert [int(v) for v in tg.to_numpy(tg.reduce128(_t(lo), _t(hi)))] == want


def test_inverse_rows_and_powers_and_sum_match_reference():
    rng = np.random.default_rng(4)
    m = rng.integers(0, fs.P, size=(5, 33), dtype=np.uint64)
    m[2, 7] = 0
    _same(tg.inverse_rows(_t(m)), jax.jit(jg.inverse_rows)(jnp.asarray(m)))
    z = int(rng.integers(0, fs.P, dtype=np.uint64))
    powers = jax.jit(jg.powers, static_argnums=1)
    _same(tg.powers(_t(z).reshape(()), 37), powers(jnp.asarray(np.uint64(z)), 37))
    sum_mod = jax.jit(jg.sum_mod, static_argnums=1)
    for axis in (0, 1):
        _same(tg.sum_mod(_t(m), axis), sum_mod(jnp.asarray(m), axis))
    np.testing.assert_array_equal(tg.np_powers(z, 19), jg.np_powers(z, 19))


@pytest.mark.parametrize("rows", [1, 2, 9, 80])
def test_prefix_products_and_matmul_match_reference(rows):
    """g.cumprod against the reference's associative scan of g.mul (the
    round-2 scans, plonk/prover.py:589,593) down the rows and along them;
    g.matmul_mod against the reference's."""
    rng = np.random.default_rng(5 + rows)
    m = rng.integers(0, fs.P, size=(rows, 37), dtype=np.uint64)
    for axis in (0, 1):
        want = jax.jit(lambda x, a=axis: jax.lax.associative_scan(jg.mul, x, axis=a))
        _same(tg.cumprod(_t(m), axis), want(jnp.asarray(m)))
    mat = rng.integers(0, fs.P, size=(12, rows), dtype=np.uint64)
    _same(tg.matmul_mod(_t(mat), _t(m)), jax.jit(jg.matmul_mod)(jnp.asarray(mat),
                                                                jnp.asarray(m)))


def test_ext2_ops_match_reference():
    a0, a1 = _inputs(5, 64)
    b0, b1 = _inputs(6, 64)
    ta, tb = (_t(a0), _t(a1)), (_t(b0), _t(b1))
    ja, jb = (jnp.asarray(a0), jnp.asarray(a1)), (jnp.asarray(b0), jnp.asarray(b1))
    for name in ("ext2_add", "ext2_sub", "ext2_mul"):
        for p, r in zip(getattr(tg, name)(ta, tb), getattr(jg, name)(ja, jb)):
            _same(p, r)
    for p, r in zip(tg.ext2_inverse(tb), jax.jit(jg.ext2_inverse)(jb)):
        _same(p, r)
    for p, r in zip(tg.ext2_neg(ta), jg.ext2_neg(ja)):
        _same(p, r)
    for p, r in zip(tg.ext2_scalar_mul(ta[0], tb), jg.ext2_scalar_mul(ja[0], jb)):
        _same(p, r)
    for p, r in zip(tg.ext2_sum_mod(ta), jax.jit(jg.ext2_sum_mod)(ja)):
        _same(p, r)
    z = (int(a0[0]), int(a1[0]))
    zt = tg.ext_tensor(z, "cpu")
    zj = (jnp.asarray(np.uint64(z[0])), jnp.asarray(np.uint64(z[1])))
    for p, r in zip(tg.ext2_powers(zt, 45), jax.jit(jg.ext2_powers, static_argnums=1)(zj, 45)):
        _same(p, r)


def test_host_utilities_match_reference():
    from plonky2_tpu import util as ju
    from plonky2_torch import util as tu

    xs = list(range(32))
    assert tu.reverse_index_bits(xs) == ju.reverse_index_bits(xs)
    assert [tu.reverse_bits(i, 9) for i in range(0, 512, 7)] == \
        [ju.reverse_bits(i, 9) for i in range(0, 512, 7)]
    assert tu.log2_strict(1 << 13) == ju.log2_strict(1 << 13) == 13
    vals = [(5, 6), 7, (fs.P - 1, 3)]
    jr, tr = ju.ReducingFactor((11, 12)), tu.ReducingFactor((11, 12))
    assert tr.reduce(vals) == jr.reduce(vals)
    assert tr.shift((1, 2)) == jr.shift((1, 2))
    from plonky2_tpu.util import rng as jrng
    from plonky2_torch.util import rng as trng

    jrng.seed(2026)
    trng.seed(2026)
    np.testing.assert_array_equal(trng.field_matrix((3, 5), fs.P), jrng.field_matrix((3, 5), fs.P))
    np.testing.assert_array_equal(trng.field_elements(7, fs.P), jrng.field_elements(7, fs.P))
    jrng.seed(None)
    trng.seed(None)
