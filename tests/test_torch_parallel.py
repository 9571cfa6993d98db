"""The port's multi-GPU path (`plonky2_torch.parallel`) on the CPU: one gloo
spawn of 4 ranks (one intra-op thread each) runs `tests/torch_parallel_ranks.py`
`four_ranks`, whose results are held here, rank by rank, to the reference
package and to one device (computed here while the ranks run).

- factorial (`plonky2_torch/data/factorial.prover.bin` and its witness)
  proved under the group on the fused and on the host transcript path,
  each rank's proof the bytes of `fixtures/factorial.proof.bin`;
- `sharded_commit` over rng(7) [8, 64] values (rate 3, cap 2): its
  coefficients, bit-reversed row leaves and cap equal the reference's
  `plonky2_tpu.parallel.sharded_commit` on the conftest's 8-device CPU mesh,
  and its leaves the reference's `_values_to_lde_leaves`;
- the uneven batches (135 polynomials, as tests/test_multichip.py's
  `test_pad_shard_polys_uneven`, and 13 polynomials whose rank LDEs take
  the interleaved form): coefficients, LDE and cap equal one device's;
- the sharded Z scan (`_round2_one_challenge` over blocks of the points)
  equal to one device's;
- `sharded_prover_step` equal to the reference's `(cap, z)`;
- cap heights 0 and 1 (below lg 4) and 4: the cap and openings of a batch
  committed under the group and of a tree sliced out of a whole one
  (`NaturalMerkleTree.part`), and `get_lde_values`, equal to one device's;
- refusals: a world of 3, a world not dividing 2^rate_bits, a quotient off
  the LDE domain, the Keccak config, prove_many, Starky, the multi-table
  prove, batch FRI and a circuit build under a group; and a collective
  that a rank leaves raises on the rank that waits in it, which fails
  `run_on_group` (a second spawn, of 2 ranks).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from plonky2_tpu.fri.oracle import _values_to_lde_leaves
from plonky2_tpu.parallel import make_mesh
from plonky2_tpu.parallel import sharded_commit as reference_sharded_commit
from plonky2_tpu.parallel import sharded_prover_step as reference_prover_step
from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.fri.oracle import PolynomialBatch
from plonky2_torch.plonk import prover as tp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as ranks  # noqa: E402

WORLD = 4
FIXTURE = os.path.join(ranks.ROOT, "fixtures", "factorial.proof.bin")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _one_device(values, cap_height):
    with parallel.use_mesh(None):
        return PolynomialBatch.from_values(values, 3, False, cap_height, device="cpu")


def _references() -> dict:
    """What the ranks' results are held to: the reference package's
    sharded commit and prover step on the 8-device mesh, and one device's
    batches, Z scan, caps and openings."""
    values = np.random.default_rng(7).integers(0, (1 << 64) - (1 << 32), size=(8, 64),
                                               dtype=np.uint64)
    out = {"sharded_commit": tuple(np.asarray(x) for x in reference_sharded_commit(
        values, 3, 2, make_mesh())),
        "leaves_1dev": np.asarray(_values_to_lde_leaves(np.array(values), 3, 0)[2]),
        "prover_step": tuple(np.asarray(x) for x in reference_prover_step(make_mesh()))}
    out["uneven"] = {shape: _one_device(ranks.uneven_values(*shape), 2) for shape in ranks.UNEVEN}
    wires, sigmas, s_id, beta, gamma = ranks.zscan_inputs()
    z, pp = tp._round2_one_challenge(*(g.tensor(m, "cpu") for m in (wires, sigmas, s_id)),
                                     g.scalar_tensor(beta, "cpu"),
                                     g.scalar_tensor(gamma, "cpu"), 8)
    out["zscan"] = g.to_numpy(torch.cat([z[None], pp]))
    out["caps"] = {}
    for cap_height in ranks.CAP_HEIGHTS:
        whole = _one_device(ranks.cap_values(), cap_height)
        out["caps"][cap_height] = dict(
            opened=(whole.merkle_tree.cap, ranks._openings(whole.merkle_tree)),
            lde_values=[whole.get_lde_values(i) for i in (0, 5, 511)])
    return out


def _missing_rank_error():
    """What `run_on_group` raises when a rank leaves a collective (2 ranks)."""
    try:
        parallel.run_on_group(ranks.collective_with_a_missing_rank, 2, "gloo", timeout_s=60)
    except RuntimeError as e:
        return e
    return None


@pytest.fixture(scope="module")
def spawned():
    """(every rank's results of `four_ranks` under 4 gloo ranks, the
    references, the 2-rank group's error): both spawns run while this
    process computes the references."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        four = pool.submit(parallel.run_on_group, ranks.four_ranks, WORLD, "gloo")
        missing = pool.submit(_missing_rank_error)
        refs = _references()
        results = four.result()
        error = missing.result()
    assert [r["rank"] for r in results] == list(range(WORLD))
    return results, refs, error


@pytest.fixture(scope="module")
def four(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def refs(spawned):
    return spawned[1]


@pytest.mark.parametrize("path", ["fused", "host"])
def test_factorial_proves_to_the_fixture_on_every_rank(four, path):
    with open(FIXTURE, "rb") as f:
        fixture = f.read()
    for r in four:
        proof, transcript, collectives = r["factorial"][path]
        assert transcript == path
        assert proof == fixture, f"rank {r['rank']}"
        assert collectives > 0


def test_sharded_commit_equals_the_reference(four, refs):
    coeffs, leaves, cap = refs["sharded_commit"]
    assert (leaves == refs["leaves_1dev"]).all()
    for r in four:
        got = r["sharded_commit"]
        assert (got[0] == coeffs).all() and (got[1] == leaves).all() and (got[2] == cap).all()


@pytest.mark.parametrize("shape", ranks.UNEVEN, ids=lambda s: f"{s[0]}x{s[1]}")
def test_uneven_batch_equals_one_device(four, refs, shape):
    ref = refs["uneven"][shape]
    rows, degree = shape
    for r in four:
        got = r["uneven"][shape]
        assert got["local_shape"] == (rows, 8 * degree // WORLD)
        assert (got["coeffs"] == g.to_numpy(ref.polynomials)).all()
        assert (got["lde"] == g.to_numpy(ref.lde)).all()
        assert got["cap"] == ref.merkle_tree.cap


def test_sharded_z_scan_equals_one_device(four, refs):
    for r in four:
        assert (r["zscan"] == refs["zscan"]).all()


def test_sharded_prover_step_equals_the_reference(four, refs):
    cap, z = refs["prover_step"]
    for r in four:
        assert (r["prover_step"][0] == cap).all() and (r["prover_step"][1] == z).all()


@pytest.mark.parametrize("cap_height", ranks.CAP_HEIGHTS)
def test_cap_and_openings_equal_one_device(four, refs, cap_height):
    want = refs["caps"][cap_height]
    for r in four:
        got = r["caps"][cap_height]
        assert got["built"] == want["opened"] and got["sliced"] == want["opened"]
        assert got["lde_values"] == want["lde_values"]


@pytest.mark.parametrize("name", [
    "rate_bits below lg world", "quotient on every other LDE point"])
def test_configs_off_the_layout_raise(four, name):
    for r in four:
        assert r["refusals"][name] == "ValueError"


@pytest.mark.parametrize("name", [
    "Keccak prove", "prove_many", "Starky prove", "multi-table prove", "batch FRI oracle",
    "batch FRI prove", "circuit build"])
def test_paths_not_under_a_group_raise(four, name):
    for r in four:
        assert r["refusals"][name] == "NotImplementedError"


def test_a_world_of_three_raises():
    with pytest.raises(ValueError, match="power of two"):
        parallel.run_on_group(ranks.four_ranks, 3, "gloo")


def test_a_rank_missing_from_a_collective_fails_the_group(spawned):
    error = spawned[2]
    assert isinstance(error, RuntimeError) and "rank 0 failed" in str(error)


def test_no_group_is_the_single_device_path():
    x = torch.arange(8, dtype=torch.int64).reshape(2, 4)
    assert parallel.active_mesh() is None
    for place in (parallel.shard_rows, parallel.shard_lanes, parallel.shard_columns,
                  parallel.gather_rows, parallel.gather_lanes, parallel.gather_columns):
        assert place(x) is x
    assert parallel.pad_shard_polys(x) == (x, 2)
