"""The port's Poseidon (host permutation, plain versions of kernels K4 and
K5) and Merkle trees against the reference package on the same
numpy-seeded inputs. Exact equality."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plonky2_tpu.field import scalar as fs
from plonky2_tpu.hash import merkle as jm
from plonky2_tpu.hash import poseidon as jp
from plonky2_torch.field import goldilocks as tg
from plonky2_torch.hash import merkle as tm
from plonky2_torch.hash import poseidon as tp
from plonky2_torch.ops import poseidon as kp


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, fs.P, size=shape, dtype=np.uint64)


def _same(port, ref):
    np.testing.assert_array_equal(tg.to_numpy(port), np.asarray(ref))


def test_permutations_match_reference():
    states = _rand(1, (12, 64))
    _same(kp.permute_plain(tg.tensor(states, "cpu")),
          jax.jit(jp.permute_dev_sm)(jnp.asarray(states)))
    for col in range(3):
        s = [int(v) for v in states[:, col]]
        assert tp.permute(s) == jp.permute_py(s) == jp.permute(s)


@pytest.mark.parametrize("width", [8, 13, 32, 135])
def test_sponges_match_reference(width):
    cols = _rand(width, (width, 5))
    got = tg.to_numpy(kp.sponge_plain(tg.tensor(cols, "cpu")))
    for j in range(cols.shape[1]):
        col = [int(v) for v in cols[:, j]]
        want = jp.hash_n_to_m_no_pad(col, 4)
        assert [int(v) for v in got[:, j]] == want == tp.hash_no_pad(col)


def test_host_hashes_match_reference():
    xs = [int(v) for v in _rand(3, (21,))]
    assert tp.hash_n_to_m_no_pad(xs, 11) == jp.hash_n_to_m_no_pad(xs, 11)
    assert tp.hash_or_noop(xs[:3]) == jp.hash_or_noop(xs[:3])
    assert tp.two_to_one(xs[:4], xs[4:8]) == jp.two_to_one(xs[:4], xs[4:8])


def test_natural_tree_caps_and_openings_match_reference():
    cols = _rand(7, (135, 1 << 6))
    port = tm.NaturalMerkleTree(tg.tensor(cols, "cpu"), cap_height=4)
    ref = jm.NaturalMerkleTree(jnp.asarray(cols), cap_height=4)
    assert port.cap == ref.cap
    idx = [0, 5, 63, 17, 5]
    got = port.open_many(idx)
    want = ref.open_many(idx)
    assert [(v, p.siblings) for v, p in got] == [(v, p.siblings) for v, p in want]
    for i, (leaf, proof) in zip(idx, got):
        tm.verify_merkle_proof_to_cap(leaf, i, port.cap, proof)


@pytest.mark.parametrize("width", [8, 32])
def test_fold_tree_caps_and_openings_match_reference(width):
    leaves = _rand(width + 1, (1 << 7, width))
    port = tm.MerkleTree(tg.tensor(leaves, "cpu"), cap_height=4)
    ref = jm.MerkleTree(leaves, cap_height=4)
    assert port.cap == ref.cap
    idx = [3, 127, 64]
    got = port.open_many(idx)
    want = ref.open_many(idx)
    assert [(v, p.siblings) for v, p in got] == [(v, p.siblings) for v, p in want]


def test_grind_plain_finds_the_lowest_witness():
    inter = [int(v) for v in _rand(11, (12,))]
    pos, bits = 3, 6
    threshold = 1 << (64 - bits)
    got = kp.grind_chunk_plain(tg.tensor(inter, "cpu"), pos, 0, 1 << 9, threshold)
    for c in range(got + 1):
        s = list(inter)
        s[pos] = c
        ok = jp.permute_py(s)[7] < threshold
        assert ok == (c == got)
