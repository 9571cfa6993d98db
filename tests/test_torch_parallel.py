"""The port's multi-GPU path (`plonky2_torch.parallel`) on the CPU: one gloo
spawn of 4 ranks (one intra-op thread each) runs `tests/torch_parallel_ranks.py`
`four_ranks`, whose results are held here, rank by rank, to the reference
package, to the committed reference bytes and to one device (computed here
while the ranks run).

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
- every other path under the group, to the reference's bytes: the Starky
  proves of FibonacciStark and LookupTestStark at 2^7 (rate 1, so the world
  of 4 exceeds 2^rate_bits and FibonacciStark's quotient lies on every
  other LDE point), the Keccak Starky at 2^5 (field digests), the three CTL
  tables, batch FRI, the Keccak factorial built and proved under the group,
  factorial built under the group (verifier bytes and fixture proof), and
  `prove_many` equal to the reference's sequential proves (one dispatch
  thread, and two on their own communicators); the low-degree circuit at three (rate, quotient
  degree) configs (a world above 2^rate_bits, the quotient on every 4th and
  every other LDE point) equal to the reference's proof (these five proofs
  from tests/torch_make_data.py --parallel, each also one device's);
- a collective that a rank leaves raises on the rank that waits in it,
  which fails `run_on_group` (a second spawn, of 2 ranks). Worlds that are
  not a power of two: tests/test_torch_parallel_any_world.py.
"""

import json
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
from plonky2_torch.fri import prover as fri_prover
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.serialization import proof_to_bytes

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as ranks  # noqa: E402

WORLD = 4
FIXTURE = os.path.join(ranks.ROOT, "fixtures", "factorial.proof.bin")


def _read(*parts) -> bytes:
    with open(os.path.join(ranks.ROOT, *parts), "rb") as f:
        return f.read()


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
    batches, Z scan, caps and openings, and its proofs of the circuits of
    `ranks.reference_proof_names()`."""
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
    # one device's proofs of the circuits whose reference proofs --parallel wrote
    out["one device"] = []
    with parallel.use_mesh(None), fri_prover.force_host_path():
        for rate_bits, qdf in ranks.PLONK_CONFIGS:
            builder, pw = ranks.low_degree_circuit(rate_bits, qdf)
            data = builder.build(device="cpu")
            with ranks.seeded():
                out["one device"].append(proof_to_bytes(data.prove(pw, device="cpu")))
        builder, inputs = ranks.prove_many_circuit()
        data = builder.build(device="cpu")
        with ranks.seeded():
            out["one device"] += [proof_to_bytes(tp.prove(data.prover_only, data.common, pw,
                                                          device="cpu")) for pw in inputs]
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


@pytest.mark.parametrize("name", ["fibonacci", "lookup"])
def test_starky_proves_to_the_reference_bytes_on_every_rank(four, name):
    want = _read("plonky2_torch", "data", f"starky_{name}{ranks.STARKY_LOG_ROWS}.proof.bin")
    for r in four:
        assert r["paths"][f"starky {name}"] == want, f"rank {r['rank']}"


@pytest.mark.parametrize("name", ["fibonacci", "lookup"])
def test_keccak_starky_equals_the_reference_field_by_field_on_every_rank(four, name):
    """Each rank hashed its own subtrees: the trace's, the quotient's (and
    the auxiliary batch's) and the FRI fold trees'."""
    with open(os.path.join(ranks.DATA, "stark_keccak.json")) as f:
        want = json.load(f)[f"{name}{ranks.STARK_KECCAK_LOG_ROWS}"]
    for r in four:
        fields, digest, trees = r["paths"][f"keccak starky {name}"]
        assert fields == want["fields"] and digest == want["digest"], f"rank {r['rank']}"
        assert trees > 0


@pytest.mark.parametrize("table", range(3))
def test_multi_table_proves_to_the_reference_bytes_on_every_rank(four, table):
    want = _read("plonky2_torch", "data", f"ctl_table{table}.stark_proof.bin")
    for r in four:
        assert r["paths"]["multi-table"][table] == want, f"rank {r['rank']}"


def test_batch_fri_equals_the_reference_on_every_rank(four):
    """The proof and the challenger's state after it (the oracle's cap
    observed first)."""
    with np.load(os.path.join(ranks.DATA, "batch_fri_9_7.npz")) as z:
        proof = z["proof"].tobytes()
        state = tuple([int(v) for v in z[k]] for k in ("sponge", "inputs", "outputs"))
    for r in four:
        got_proof, got_state = r["paths"]["batch FRI"]
        assert got_proof == proof and tuple(got_state) == state, f"rank {r['rank']}"


def test_keccak_factorial_builds_and_proves_to_the_fixture_on_every_rank(four):
    """Built and proved under the group, and built whole outside it (its
    host tree then sliced to each rank's part, `KeccakMerkleTree.part`)
    and proved under it."""
    verifier = _read("fixtures", "keccak_factorial.verifier.bin")
    proof = _read("fixtures", "keccak_factorial.proof.bin")
    for r in four:
        assert r["paths"]["keccak factorial"] == (verifier, proof, "host"), f"rank {r['rank']}"
        assert r["paths"]["keccak factorial, built whole"] == proof, f"rank {r['rank']}"


def _reference_proofs(refs, names) -> list[bytes]:
    """The reference's proofs (tests/torch_make_data.py --parallel) of
    `names`, each first held equal to one device's proof here."""
    every = ranks.reference_proof_names()
    want = [_read("plonky2_torch", "data", name) for name in names]
    assert want == [refs["one device"][every.index(name)] for name in names]
    return want


@pytest.mark.parametrize("threads", [1, 2])
def test_prove_many_equals_sequential_one_device_proves_on_every_rank(four, refs, threads):
    """One device's sequential proves, and the reference's, under the
    group: one dispatch thread, and two (each slot on its own
    communicator)."""
    want = _reference_proofs(refs, ranks.reference_proof_names()[len(ranks.PLONK_CONFIGS):])
    for r in four:
        proofs, in_flight = r["paths"][f"prove_many threads {threads}"]
        assert proofs == want, f"rank {r['rank']}"
        assert 1 <= in_flight <= 2  # the window


def test_build_under_the_group_gives_the_fixture_on_every_rank(four):
    """The build's verifier bytes, the fixture proof from its prover data
    under the group, and the parts it left: the rank's part for the group,
    and outside it the whole batch with the verifier's cap."""
    verifier, proof = _read("fixtures", "factorial.verifier.bin"), _read(FIXTURE)
    for r in four:
        assert r["paths"]["factorial build"] == (verifier, proof), f"rank {r['rank']}"
        assert r["paths"]["factorial build, parts"] == (True, True)


@pytest.mark.parametrize("config", ranks.PLONK_CONFIGS,
                         ids=lambda c: f"rate{c[0]}-qdf{c[1]}")
def test_plonk_at_any_rate_and_quotient_domain_equals_one_device(four, refs, config):
    """Rate 1 under a world of 4 (the fold, and Z(g x) on another rank), and
    quotients on every 4th and every other LDE point: one device's proof,
    and the reference's."""
    i = ranks.PLONK_CONFIGS.index(config)
    want, = _reference_proofs(refs, [ranks.reference_proof_names()[i]])
    for r in four:
        assert r["paths"][f"plonk rate {config[0]} qdf {config[1]}"] == want, f"rank {r['rank']}"


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
