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
    got = kp.grind_chunk_plain(inter, pos, 0, 1 << 9, threshold)
    assert kp.grind_chunk(inter, pos, 0, 1 << 9, threshold, "cpu") == got
    for c in range(got + 1):
        s = list(inter)
        s[pos] = c
        ok = jp.permute_py(s)[7] < threshold
        assert ok == (c == got)


def test_plain_permutation_matches_reference_on_edge_states():
    # all-zero and all-(p-1) states beside random ones: the words the kernels'
    # non-canonical round arithmetic comes closest to wrapping on
    states = np.concatenate([np.zeros((12, 1), np.uint64), np.full((12, 1), fs.P - 1, np.uint64),
                             _rand(21, (12, 4))], axis=1)
    got = tg.to_numpy(kp.permute_plain(tg.tensor(states, "cpu")))
    for j in range(states.shape[1]):
        s = [int(v) for v in states[:, j]]
        assert [int(v) for v in got[:, j]] == jp.permute(s) == tp.permute(s)


def test_cuda_constants_header_is_generated_from_the_tables():
    from pathlib import Path

    from plonky2_torch.hash import poseidon_constants as pc

    header = Path(tm.__file__).resolve().parent.parent / "csrc" / "poseidon_constants.cuh"
    assert header.read_text() == pc.cuda_header()
    # the frequency-domain MDS: its kernels are in the header, its symbolic
    # run gives the circulant rows, and its intermediates fit in int64
    f0, f2, f1r, f1i = pc._mds_freq_kernels()
    for name, taps in (("kMdsFreq0", f0), ("kMdsFreq2", f2), ("kMdsFreq1Re", f1r),
                       ("kMdsFreq1Im", f1i)):
        assert f"{name}(int d) {{ return d == 0 ? {taps[0]} : d == 1 ? {taps[1]} : {taps[2]}; }}" \
            in header.read_text()
    y, seen = pc.mds_freq_symbolic(pc._mds_freq_kernels())
    assert y == [[pc.MDS_MATRIX_CIRC[(i - r) % 12] for i in range(12)] for r in range(12)]
    bits = pc.mds_freq_bound_bits()
    assert f"constexpr int kMdsFreqBoundBits = {bits};" in header.read_text()
    assert bits <= 42 < 63
    assert max(abs(c) for f in seen for c in f) << 32 < 1 << bits


_DRIVER = r"""
#include <cstdio>
#include "poseidon_lane.cuh"
int main() {
  unsigned long long v;
  uint64_t s[12];
  for (;;) {
    for (int i = 0; i < 12; i++) {
      if (scanf("%llu", &v) != 1) return 0;
      s[i] = v;
    }
    poseidon::permute(s, kRoundConstants);
    for (int i = 0; i < 12; i++)
      printf("%llu%c", (unsigned long long)gl::canon(s[i]), i == 11 ? '\n' : ' ');
  }
}
"""


def test_one_lane_permutation_header_matches_reference_on_host(tmp_path):
    """K5's round function (csrc/poseidon_lane.cuh, frequency-domain MDS)
    compiled as host C++ by g++, against the reference permutation on 64
    seeded random states and the edge states; exact equality."""
    import shutil
    import subprocess
    from pathlib import Path

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the host driver")
    csrc = Path(kp.__file__).resolve().parent.parent / "csrc"
    (tmp_path / "driver.cpp").write_text(_DRIVER)
    exe = tmp_path / "driver"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", str(csrc), "-o", str(exe),
                    str(tmp_path / "driver.cpp")], check=True, capture_output=True, timeout=120)
    states = [[int(v) for v in col] for col in _rand(64, (12, 64)).T]
    for word in (0, fs.P - 1, (1 << 32) - 1, 1 << 63, fs.P):  # fs.P: a non-canonical input
        states.append([word] * 12)
    states.append([fs.P - 1 if i % 2 else (1 << 32) - 1 for i in range(12)])
    text = "\n".join(" ".join(map(str, s)) for s in states) + "\n"
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True, check=True,
                         timeout=60).stdout.split("\n")
    for s, line in zip(states, out):
        assert [int(v) for v in line.split()] == jp.permute([v % fs.P for v in s]), s
    assert len([line for line in out if line]) == len(states)


def _ref_tree(leaves, cap_height, natural):
    return (jm.NaturalMerkleTree(jnp.asarray(leaves), cap_height=cap_height) if natural
            else jm.MerkleTree(leaves, cap_height=cap_height))


@pytest.mark.parametrize("natural, width, lg_n, cap_height", [
    (True, 3, 4, 0), (True, 20, 3, 3), (False, 2, 4, 0), (False, 32, 3, 3),
])
def test_tree_entry_point_caps_and_openings_match_reference(natural, width, lg_n, cap_height):
    """kp.merkle_tree's plain path (through the tree classes) at cap height 0,
    cap height == height, and leaves of width <= 4 (hash_or_noop)."""
    n = 1 << lg_n
    leaves = _rand(1000 + width + lg_n, (width, n) if natural else (n, width))
    cls = tm.NaturalMerkleTree if natural else tm.MerkleTree
    port = cls(tg.tensor(leaves, "cpu"), cap_height=cap_height)
    ref = _ref_tree(leaves, cap_height, natural)
    assert port.cap == ref.cap
    idx = [0, n - 1, n // 3]
    got = port.open_many(idx)
    want = ref.open_many(idx)
    assert [(v, p.siblings) for v, p in got] == [(v, p.siblings) for v, p in want]


@pytest.mark.parametrize("lg_n, cap_height, natural", [
    (16, 4, True), (12, 4, False), (8, 4, False), (14, 4, False), (13, 4, True), (10, 10, True),
])
def test_tree_launch_plan_covers_every_level_in_three_launches(lg_n, cap_height, natural):
    plan = kp.tree_launches(lg_n, lg_n - cap_height, natural)
    assert len(plan) <= 3
    k = 0
    for i, (k0, depth, states) in enumerate(plan):
        assert k0 == k and 1 <= states <= kp.TREE_STATES
        s0 = states if i == 0 else 2 * states  # nodes a block starts from
        assert depth <= s0.bit_length() - 1 and ((1 << lg_n) >> k0) % s0 == 0
        if i == 0 and natural:
            assert states >> depth >= min(kp.COALESCED_RUN, states)
        k += depth
    assert k == lg_n - cap_height


def test_tree_layers_are_views_of_one_buffer():
    cols = tg.tensor(_rand(33, (8, 1 << 5)), "cpu")
    layers = kp.merkle_tree(cols, 1, natural=True)
    assert [tuple(x.shape) for x in layers] == [(4, 32 >> k) for k in range(5)]
    base = layers[0].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in layers)
