"""The port's device transcript against the host challenger and the
reference package, on CPU tensors: `DeviceChallenger` and `cap_boundary`
(every pending count, cap heights 0-4, 0-6 draws, both cap layouts),
`ext2_pow_static`, the Merkle gathers driven by device indices, and the
plain version of K5's device grind. Exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from plonky2_tpu.hash import merkle as jm
from plonky2_tpu.iop.challenger import cap_boundary_fn
from plonky2_tpu.util import export_cache
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.hash import poseidon as ps
from plonky2_torch.hash.merkle import MerkleTree, NaturalMerkleTree
from plonky2_torch.iop.challenger import Challenger, DeviceChallenger, cap_boundary
from plonky2_torch.ops import poseidon as kp
from plonky2_torch.util import reverse_bits


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Plain permutations of a few states run fastest on one intra-op thread
    while other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _felts(rng, shape):
    return rng.integers(0, fs.P, size=shape, dtype=np.uint64)


def _host_boundary(state, pending, cap_rows, n_draws):
    """The host challenger's observe_cap + draws from the same state."""
    ch = Challenger()
    ch.sponge_state = [int(v) for v in state]
    ch.input_buffer = [int(v) for v in pending]
    ch.observe_cap([[int(v) for v in row] for row in cap_rows])
    draws = ch.get_n_challenges(n_draws)
    return ch.sponge_state, ch.input_buffer, draws


@pytest.mark.parametrize("k_pending", range(8))
def test_cap_boundary_matches_the_host_challenger(k_pending):
    rng = np.random.default_rng(100 + k_pending)
    for cap_height in range(5):
        for natural in (True, False):
            n_draws = int(rng.integers(0, 7))
            state, pending = _felts(rng, 12), _felts(rng, k_pending)
            C = 1 << cap_height
            cap = _felts(rng, (4, C) if natural else (C, 4))
            rows = (cap[:, [reverse_bits(c, cap_height) for c in range(C)]].T if natural
                    else cap)
            st, pend, draws, cap_rows = cap_boundary(
                g.tensor(state, "cpu"), g.tensor(pending, "cpu"), k_pending,
                g.tensor(cap, "cpu"), cap_height, natural, n_draws)
            want_state, want_pend, want_draws = _host_boundary(state, pending, rows, n_draws)
            assert np.array_equal(g.to_numpy(cap_rows), rows)
            assert [int(v) for v in g.to_numpy(pend)] == want_pend
            assert [int(v) for v in g.to_numpy(draws)] == want_draws
            assert [int(v) for v in g.to_numpy(st)] == want_state


@pytest.mark.parametrize("k_pending, cap_height, natural, n_draws", [
    (0, 4, True, 6), (3, 2, True, 2), (7, 0, False, 1), (5, 4, False, 0), (1, 3, True, 4),
])
def test_cap_boundary_matches_the_reference(monkeypatch, k_pending, cap_height, natural,
                                            n_draws):
    monkeypatch.setattr(export_cache, "_ENABLED", False)
    rng = np.random.default_rng(7 * k_pending + cap_height)
    C = 1 << cap_height
    state, pending = _felts(rng, 12), _felts(rng, k_pending)
    cap = _felts(rng, (4, C) if natural else (C, 4))
    want = cap_boundary_fn(k_pending, cap_height, natural, n_draws)(
        jnp.asarray(state), jnp.asarray(pending), jnp.asarray(cap))
    got = cap_boundary(g.tensor(state, "cpu"), g.tensor(pending, "cpu"), k_pending,
                       g.tensor(cap, "cpu"), cap_height, natural, n_draws)
    for a, b in zip(got, want):
        assert np.array_equal(g.to_numpy(a), np.asarray(b))


def test_device_challenger_draws_and_observes_like_the_host_challenger():
    """Observations of every length, single draws across duplex boundaries,
    pending counts carried between calls."""
    rng = np.random.default_rng(3)
    host = Challenger()
    dev = DeviceChallenger(torch.zeros(12, dtype=torch.int64))
    for step in range(12):
        xs = _felts(rng, int(rng.integers(0, 13)))
        host.observe_elements([int(v) for v in xs])
        dev.observe_elements(g.tensor(xs, "cpu"))
        assert dev.k == len(host.input_buffer)
        n = int(rng.integers(0, 11)) if step % 3 else 0
        got = [g.u64(int(d)) for d in dev.get_n_challenges(n)]
        assert got == host.get_n_challenges(n)
    dev.observe_elements(g.tensor([5], "cpu"))
    host.observe_element(5)
    assert g.u64(int(dev.get_challenge())) == host.get_challenge()
    assert [int(v) for v in g.to_numpy(dev.state)] == host.sponge_state


@pytest.mark.parametrize("e", [0, 1, 2, 3, 7, 64, 258, 1 << 13, (1 << 64) - 2])
def test_ext2_pow_static_matches_host_ext_exp(e):
    rng = np.random.default_rng(e % 1000)
    x = tuple(int(v) for v in _felts(rng, 2))
    got = g.ext2_pow_static(g.ext_tensor(x, "cpu"), e)
    assert tuple(g.u64(int(t)) for t in got) == fs.ext_exp(x, e)


def test_scalar_helpers_pass_device_values_through():
    t = g.tensor([3, 4], "cpu")
    z = (t[0], t[1])
    assert g.scalar_tensor(z[0], "cpu") is z[0] and g.ext_tensor(z, "cpu") == z
    p0, p1 = g.ext2_powers(z, 5)
    q0, q1 = g.ext2_powers((3, 4), 5, "cpu")
    assert torch.equal(p0, q0) and torch.equal(p1, q1)
    assert torch.equal(g.powers(t[0], 6), g.powers(3, 6, "cpu"))


def _host_natural_openings(cols, layers, lg_n, indices):
    """Natural-tree openings by host index remapping (reference digest i of
    level k is column rev_{lg_n-k}(i))."""
    leaves = cols[:, [reverse_bits(i, lg_n) for i in indices]].T
    sibs = np.stack([layer[:, [reverse_bits((i >> k) ^ 1, lg_n - k) for i in indices]].T
                     for k, layer in enumerate(layers)], axis=1)
    return leaves, sibs


@pytest.mark.parametrize("lg_n, cap_height, shift_bits", [(6, 2, 0), (8, 0, 0), (7, 4, 2)])
def test_device_index_gathers_match_host_openings_and_the_reference(monkeypatch, lg_n,
                                                                    cap_height, shift_bits):
    monkeypatch.setattr(export_cache, "_ENABLED", False)
    rng = np.random.default_rng(lg_n)
    n = 1 << lg_n
    ref_idx = [int(v) for v in rng.integers(0, n << shift_bits, size=9)]
    idx = g.tensor(ref_idx, "cpu")
    indices = [i >> shift_bits for i in ref_idx]
    # natural-order tree: [width, n] columns
    cols = _felts(rng, (7, n))
    tree = NaturalMerkleTree(g.tensor(cols, "cpu"), cap_height)
    layers = [g.to_numpy(layer) for layer in tree._layers[:-1]]
    leaves, sibs = tree.gather(idx, shift_bits)
    want_leaves, want_sibs = _host_natural_openings(cols, layers, lg_n, indices)
    assert np.array_equal(g.to_numpy(leaves), want_leaves)
    assert np.array_equal(g.to_numpy(sibs), want_sibs)
    j_leaves, j_sibs = jm._gather_openings_cols_ref(
        jnp.asarray(cols), tuple(jnp.asarray(x) for x in layers), jnp.asarray(
            np.asarray(ref_idx, dtype=np.uint64)), (lg_n, shift_bits))
    assert np.array_equal(g.to_numpy(leaves), np.asarray(j_leaves))
    assert np.array_equal(g.to_numpy(sibs), np.asarray(j_sibs))
    # row-leaf tree: [n, width] rows, as the FRI fold steps commit
    rows = _felts(rng, (n, 8))
    rtree = MerkleTree(g.tensor(rows, "cpu"), cap_height)
    rlayers = [g.to_numpy(layer) for layer in rtree._layers[:-1]]
    leaves, sibs = rtree.gather(idx, shift_bits)
    assert np.array_equal(g.to_numpy(leaves), rows[indices])
    want = [np.stack([layer[(i >> k) ^ 1] for k, layer in enumerate(rlayers)]) for i in indices]
    assert np.array_equal(g.to_numpy(sibs), np.stack(want))
    j_leaves, j_sibs = jm._gather_openings_rows_ref(
        jnp.asarray(rows), tuple(jnp.asarray(x) for x in rlayers),
        jnp.asarray(np.asarray(ref_idx, dtype=np.uint64)), shift_bits)
    assert np.array_equal(g.to_numpy(sibs), np.asarray(j_sibs))


def _lowest_valid_witness(inter, k, threshold):
    """The lowest w with permute(inter, w at position k)[7] < threshold, by
    host scalar permutations one candidate at a time."""
    w = 0
    while True:
        s = list(inter)
        s[k] = w
        if ps.permute(s)[7] < threshold:
            return w
        w += 1


@pytest.mark.parametrize("pow_bits", [4, 6, 8, 10])
def test_plain_device_grind_matches_the_chunked_and_scalar_scans(pow_bits):
    """Chunks of 32 at 4-10 bits: at the low counts several candidates pass
    within one chunk and the lowest must win."""
    rng = np.random.default_rng(pow_bits)
    k = pow_bits % 8
    state, pending = _felts(rng, 12), _felts(rng, k)
    inter = [int(v) for v in state]
    inter[:k] = [int(v) for v in pending]
    threshold = 1 << (64 - pow_bits)
    st, pend = g.tensor(state, "cpu"), g.tensor(pending, "cpu")
    got = g.u64(int(kp.grind_device_plain(st, pend, pow_bits, chunk=32)[0]))
    assert got == kp.grind_chunk_plain(inter, k, 0, 1 << 12, threshold)
    assert g.u64(int(kp.grind_device(st, pend, pow_bits)[0])) == got
    if pow_bits <= 6:
        assert got == _lowest_valid_witness(inter, k, threshold)
        passing = [c for c in range(32 * (got // 32), 32 * (got // 32 + 1))
                   if ps.permute(inter[:k] + [c] + inter[k + 1:])[7] < threshold]
        assert passing[0] == got
    assert int(kp.grind_device(st, pend, 0)[0]) == 0
