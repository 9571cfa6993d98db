"""The port's NTT (plonky2_torch.field.ntt and the plain versions of kernels
K2 and K3) against the reference package's `field.ntt` on the same
numpy-seeded inputs: fft/ifft/coset transforms at lg 6..12 with batch > 1,
and the LDE at rate 3 in both forms (zero-tail below 2^10 points,
interleaved-coset from 2^10). Exact equality."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plonky2_tpu.field import ntt as jntt
from plonky2_tpu.field import scalar as fs
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.field import ntt as tntt
from plonky2_torch.ops import ntt as kn

GEN = fs.MULTIPLICATIVE_GROUP_GENERATOR


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, fs.P, size=shape, dtype=np.uint64)


def _same(port, ref):
    np.testing.assert_array_equal(tg.to_numpy(port), np.asarray(ref))


@pytest.mark.parametrize("lg", [6, 12])
def test_fft_ifft_coset_match_reference(lg):
    x = _rand(lg, (3, 1 << lg))
    t = tg.tensor(x, "cpu")
    j = jnp.asarray(x)
    _same(tntt.fft(t), jax.jit(jntt.fft)(j))
    _same(tntt.ifft(t), jax.jit(jntt.ifft)(j))
    _same(tntt.coset_fft(t), jax.jit(jntt.coset_fft)(j))
    _same(tntt.coset_ifft(t), jax.jit(jntt.coset_ifft)(j))


@pytest.mark.parametrize("lg_m", [6, 7, 9])
def test_lde_both_forms_match_reference(lg_m):
    # rate 3: lg_m 6 takes the zero-tail form, 7 and 9 the interleaved one
    x = _rand(100 + lg_m, (2, 1 << lg_m))
    t = tg.tensor(x, "cpu")
    j = jnp.asarray(x)
    lde = jax.jit(jntt.lde_fft, static_argnums=(1, 2))
    _same(tntt.coset_lde(t, 3), lde(j, 3, GEN))
    _same(tntt.lde_fft(t, 3), lde(j, 3, None))
    _same(tntt.lde_fft(t, 3, shift=5), lde(j, 3, 5))


@pytest.mark.parametrize("lg", [10, 11, 14, 16])
def test_four_step_plain_matches_reference_fft(lg):
    # K3's plain version on the kernel's split (lg a = ceil(lg n / 2)), up to
    # 2^16 points (the main path's size)
    x = _rand(lg, (2, 1 << lg))
    t = tg.tensor(x, "cpu")
    j = jnp.asarray(x)
    _same(kn.ntt_four_step_plain(t), jax.jit(jntt.fft)(j))
    _same(kn.ntt_four_step_plain(t, inverse=True), jax.jit(jntt.ifft)(j))


@pytest.mark.parametrize("lg_n", [10, 16, 17])
def test_four_step_twiddles_are_powers_on_the_split(lg_n):
    # entry (k1, i2) of the [a, b] table is w^(k1*i2), times 1/n for the inverse
    lg_a = (lg_n + 1) // 2
    b = 1 << (lg_n - lg_a)
    w = fs.primitive_root_of_unity(lg_n)
    rng = np.random.default_rng(lg_n)
    picks = [(0, 0), ((1 << lg_a) - 1, b - 1)] + [
        (int(k1), int(i2)) for k1, i2 in zip(rng.integers(0, 1 << lg_a, 16),
                                             rng.integers(0, b, 16))]
    for inverse in (False, True):
        table = tg.to_numpy(kn.four_step_twiddles(lg_n, inverse, "cpu")).reshape(-1, b)
        assert table.shape == (1 << lg_a, b)
        root = fs.inverse(w) if inverse else w
        unit = fs.inverse(1 << lg_n) if inverse else 1
        for k1, i2 in picks:
            assert int(table[k1, i2]) == unit * pow(root, k1 * i2, fs.P) % fs.P


def test_four_step_plain_interleaved_lde_matches_rows_plain():
    x = tg.tensor(_rand(7, (2, 1 << 10)), "cpu")
    table = tntt._lde_coset_scale_table(GEN, 10, 2, "cpu")
    want = kn.ntt_rows_plain(x, scale=table, fan=4)
    _same(kn.ntt_four_step_plain(x, scale=table, fan=4), tg.to_numpy(want))


@pytest.mark.parametrize("fan", [2, 8])
def test_four_step_plain_interleaved_lde_at_2_14_matches_definition(fan):
    """The interleaved LDE as ntt_rows_plain defines it, out[p, k*fan + j] =
    NTT(x[p] * scale[j])[k], at m = 2^14 (beyond K2), with the reference's
    fft and Python-int scaling."""
    lg_m, rate_bits = 14, fan.bit_length() - 1
    x = _rand(300 + fan, (2, 1 << lg_m))
    table = tntt._lde_coset_scale_table(GEN, lg_m, rate_bits, "cpu")
    got = tg.to_numpy(kn.ntt_four_step_plain(tg.tensor(x, "cpu"), scale=table, fan=fan))
    scaled = (x.astype(object)[:, None, :] * tg.to_numpy(table).astype(object)[None]) % fs.P
    ffts = np.asarray(jax.jit(jntt.fft)(jnp.asarray(scaled.astype(np.uint64))))  # [2, fan, m]
    np.testing.assert_array_equal(got, ffts.transpose(0, 2, 1).reshape(2, -1))


def test_rows_plain_matches_interpret_mode_pallas_kernel():
    """K2's plain version against the TPU kernel itself (interpret mode):
    butterflies0_pallas takes bit-reversed rows along axis 0."""
    from plonky2_tpu.ops.pallas_ntt import butterflies0_pallas

    lg = 6
    x = _rand(9, (1 << lg, 8))
    perm = jntt.bit_reverse_perm(lg)
    ref = np.asarray(butterflies0_pallas(jnp.asarray(x[perm]), lg, interpret=True))
    port = kn.ntt_rows_plain(tg.tensor(np.ascontiguousarray(x.T), "cpu"))
    _same(port.T, ref)


def test_wrappers_take_the_plain_version_on_cpu():
    from plonky2_torch.ops import K2, K3

    before = (K2.launches, K3.launches)
    x = tg.tensor(_rand(1, (2, 1 << 8)), "cpu")
    _same(kn.ntt_rows(x), tg.to_numpy(kn.ntt_rows_plain(x)))
    _same(kn.ntt_four_step(x), tg.to_numpy(kn.ntt_four_step_plain(x)))
    assert (K2.launches, K3.launches) == before


@pytest.mark.parametrize("fan", [2, 4, 8, 16])
def test_rows_plain_interleaved_fans_match_reference_lde(fan):
    """K2's interleaved fan-out epilogue (fan = 2^rate cosets) against the
    reference's LDE at rates 1..4."""
    rate_bits = fan.bit_length() - 1
    lg_m = 10 - rate_bits  # the interleaved form's smallest domain, 2^10
    x = _rand(200 + fan, (2, 1 << lg_m))
    table = tntt._lde_coset_scale_table(GEN, lg_m, rate_bits, "cpu")
    port = kn.ntt_rows_plain(tg.tensor(x, "cpu"), scale=table, fan=fan)
    lde = jax.jit(jntt.lde_fft, static_argnums=(1, 2))
    _same(port, lde(jnp.asarray(x), rate_bits, GEN))
