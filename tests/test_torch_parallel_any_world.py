"""The port's multi-GPU path (`plonky2_torch.parallel`) over worlds that are
not a power of two, on the CPU: P = 8 parts for 3 ranks, 16 for 5, 6 or 7
(`parallel.parts_count`), part v on rank v mod k.

- One gloo spawn of 3 ranks runs `tests/torch_parallel_ranks.py`
  `four_ranks`: every path, each rank held to the same pins as under 4
  ranks (tests/test_torch_parallel.py): factorial on both transcripts, the
  sharded commit and prover step against the reference's, the uneven
  batches (each rank holding its 3 or 2 parts), the Z scan, the caps and
  openings at cap heights 0, 1 and 4, the Starky proves (Poseidon and
  Keccak), the multi-table prove, batch FRI, the Keccak factorial, the
  build, `prove_many` at one and two dispatch threads and the low-degree
  PLONK configs.
- One gloo spawn of 6 ranks runs `six_ranks`: the commit, the caps and
  openings, the Z scan and the rate-1 PLONK config (the fold).
- With no spawn: the part assignment, `ntt.coset_lde_parts` over every
  rank's parts against the reference's `coset_lde` at k = 3, 5, 6 and 7
  and rates 1 and 3, the quotient holders, and the refusal of a world
  that a circuit cannot split.

Every value is a field element, so every comparison is exact.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.field import ntt as jntt
from plonky2_tpu.field import scalar as fs
from plonky2_tpu.fri.oracle import _values_to_lde_leaves
from plonky2_tpu.parallel import make_mesh
from plonky2_tpu.parallel import sharded_commit as reference_sharded_commit
from plonky2_tpu.parallel import sharded_prover_step as reference_prover_step
from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.fri import prover as fri_prover
from plonky2_torch.fri.oracle import PolynomialBatch
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.serialization import proof_to_bytes

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as ranks  # noqa: E402

THREE, SIX = 3, 6
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
    """The reference package's sharded commit and prover step, and one
    device's batches, Z scan, caps, openings and proofs."""
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


@pytest.fixture(scope="module")
def spawned():
    """(every rank's results of `four_ranks` under 3 gloo ranks, of
    `six_ranks` under 6, the references): both spawns run while this
    process computes the references."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        three = pool.submit(parallel.run_on_group, ranks.four_ranks, THREE, "gloo")
        six = pool.submit(parallel.run_on_group, ranks.six_ranks, SIX, "gloo")
        refs = _references()
        results = three.result(), six.result()
    assert [r["rank"] for r in results[0]] == list(range(THREE))
    assert [r["rank"] for r in results[1]] == list(range(SIX))
    return (*results, refs)


@pytest.fixture(scope="module")
def three(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def six(spawned):
    return spawned[1]


@pytest.fixture(scope="module")
def refs(spawned):
    return spawned[2]


def _reference_proofs(refs, names) -> list[bytes]:
    """The reference's proofs (tests/torch_make_data.py --parallel) of
    `names`, each first held equal to one device's proof here."""
    every = ranks.reference_proof_names()
    want = [_read("plonky2_torch", "data", name) for name in names]
    assert want == [refs["one device"][every.index(name)] for name in names]
    return want


# -- a world of 3 (8 parts: 3, 3 and 2 a rank), every path -----------------------------

@pytest.mark.parametrize("path", ["fused", "host"])
def test_world_of_three_proves_factorial_to_the_fixture_on_every_rank(three, path):
    fixture = _read(FIXTURE)
    for r in three:
        proof, transcript, collectives = r["factorial"][path]
        assert transcript == path
        assert proof == fixture, f"rank {r['rank']}"
        assert collectives > 0


def test_world_of_three_sharded_commit_and_step_equal_the_reference(three, refs):
    coeffs, leaves, cap = refs["sharded_commit"]
    assert (leaves == refs["leaves_1dev"]).all()
    step_cap, step_z = refs["prover_step"]
    for r in three:
        got = r["sharded_commit"]
        assert (got[0] == coeffs).all() and (got[1] == leaves).all() and (got[2] == cap).all()
        assert (r["prover_step"][0] == step_cap).all() and (r["prover_step"][1] == step_z).all()


@pytest.mark.parametrize("world", [THREE, SIX])
@pytest.mark.parametrize("shape", ranks.UNEVEN, ids=lambda s: f"{s[0]}x{s[1]}")
def test_uneven_batch_in_parts_equals_one_device(three, six, refs, world, shape):
    """Each rank holds its parts (3 or 2 of 8, 3 or 2 of 16) of the
    columns; gathered, they are one device's LDE."""
    ref = refs["uneven"][shape]
    rows, degree = shape
    count = parallel.parts_count(world)
    for r in three if world == THREE else six:
        got = r["uneven"][shape]
        held = len(range(r["rank"], count, world))
        if world == THREE:  # [rows, parts side by side]
            assert got["local_shape"] == (rows, held * 8 * degree // count)
        else:  # [parts, rows, N / P]
            assert got["local_shape"] == (held, rows, 8 * degree // count)
        assert (got["coeffs"] == g.to_numpy(ref.polynomials)).all()
        assert (got["lde"] == g.to_numpy(ref.lde)).all()
        assert got["cap"] == ref.merkle_tree.cap


@pytest.mark.parametrize("world", [THREE, SIX])
def test_z_scan_over_part_blocks_equals_one_device(three, six, refs, world):
    for r in three if world == THREE else six:
        assert (r["zscan"] == refs["zscan"]).all()


@pytest.mark.parametrize("world", [THREE, SIX])
@pytest.mark.parametrize("cap_height", ranks.CAP_HEIGHTS)
def test_cap_and_openings_in_parts_equal_one_device(three, six, refs, world, cap_height):
    """Cap heights 0 and 1 (below lg P) and 4: a batch committed under the
    group and a tree sliced out of a whole one (`NaturalMerkleTree.part`)."""
    want = refs["caps"][cap_height]
    for r in three if world == THREE else six:
        got = r["caps"][cap_height]
        assert got["built"] == want["opened"] and got["sliced"] == want["opened"]
        assert got["lde_values"] == want["lde_values"]


@pytest.mark.parametrize("name", ["fibonacci", "lookup"])
def test_world_of_three_starky_proves_to_the_reference_bytes(three, name):
    want = _read("plonky2_torch", "data", f"starky_{name}{ranks.STARKY_LOG_ROWS}.proof.bin")
    for r in three:
        assert r["paths"][f"starky {name}"] == want, f"rank {r['rank']}"


@pytest.mark.parametrize("name", ["fibonacci", "lookup"])
def test_world_of_three_keccak_starky_equals_the_reference_field_by_field(three, name):
    with open(os.path.join(ranks.DATA, "stark_keccak.json")) as f:
        want = json.load(f)[f"{name}{ranks.STARK_KECCAK_LOG_ROWS}"]
    for r in three:
        fields, digest, trees = r["paths"][f"keccak starky {name}"]
        assert fields == want["fields"] and digest == want["digest"], f"rank {r['rank']}"
        assert trees > 0


@pytest.mark.parametrize("table", range(3))
def test_world_of_three_multi_table_proves_to_the_reference_bytes(three, table):
    want = _read("plonky2_torch", "data", f"ctl_table{table}.stark_proof.bin")
    for r in three:
        assert r["paths"]["multi-table"][table] == want, f"rank {r['rank']}"


def test_world_of_three_batch_fri_equals_the_reference(three):
    with np.load(os.path.join(ranks.DATA, "batch_fri_9_7.npz")) as z:
        proof = z["proof"].tobytes()
        state = tuple([int(v) for v in z[k]] for k in ("sponge", "inputs", "outputs"))
    for r in three:
        got_proof, got_state = r["paths"]["batch FRI"]
        assert got_proof == proof and tuple(got_state) == state, f"rank {r['rank']}"


def test_world_of_three_keccak_factorial_builds_and_proves_to_the_fixture(three):
    verifier = _read("fixtures", "keccak_factorial.verifier.bin")
    proof = _read("fixtures", "keccak_factorial.proof.bin")
    for r in three:
        assert r["paths"]["keccak factorial"] == (verifier, proof, "host"), f"rank {r['rank']}"
        assert r["paths"]["keccak factorial, built whole"] == proof, f"rank {r['rank']}"


@pytest.mark.parametrize("threads", [1, 2])
def test_world_of_three_prove_many_equals_sequential_proves(three, refs, threads):
    """At two dispatch threads each slot proves on its own communicator."""
    want = _reference_proofs(refs, ranks.reference_proof_names()[len(ranks.PLONK_CONFIGS):])
    for r in three:
        proofs, in_flight = r["paths"][f"prove_many threads {threads}"]
        assert proofs == want, f"rank {r['rank']}"
        assert 1 <= in_flight <= 2


def test_world_of_three_build_gives_the_fixture(three):
    verifier, proof = _read("fixtures", "factorial.verifier.bin"), _read(FIXTURE)
    for r in three:
        assert r["paths"]["factorial build"] == (verifier, proof), f"rank {r['rank']}"
        assert r["paths"]["factorial build, parts"] == (True, True)


@pytest.mark.parametrize("config", ranks.PLONK_CONFIGS, ids=lambda c: f"rate{c[0]}-qdf{c[1]}")
def test_world_of_three_plonk_at_any_rate_and_quotient_domain(three, refs, config):
    """Rate 1 (8 parts above 2^rate_bits: the fold, and Z(g x) in holders
    on the same rank and on others), and the quotient on every 4th and
    every other LDE point."""
    i = ranks.PLONK_CONFIGS.index(config)
    want, = _reference_proofs(refs, [ranks.reference_proof_names()[i]])
    for r in three:
        assert r["paths"][f"plonk rate {config[0]} qdf {config[1]}"] == want, f"rank {r['rank']}"


def test_world_of_six_plonk_at_rate_one_equals_the_reference(six, refs):
    want, = _reference_proofs(refs, [ranks.reference_proof_names()[0]])
    for r in six:
        assert r["plonk rate 1 qdf 2"] == want, f"rank {r['rank']}"


# -- no spawn ---------------------------------------------------------------------

@pytest.mark.parametrize("world", range(1, 9))
def test_parts_cover_the_work_once_and_balance(world):
    count = parallel.parts_count(world)
    assert count & (count - 1) == 0 and count >= world
    assert count == world if world & (world - 1) == 0 else world * 2 <= count < world * 4
    groups = [parallel.Group(r, world, torch.device("cpu")) for r in range(world)]
    owned = sorted(v for grp in groups for v in grp.own_parts)
    assert owned == list(range(count))
    assert max(len(grp.own_parts) for grp in groups) == groups[0].most == -(-count // world)


@pytest.mark.parametrize("rate_bits", [1, 3])
@pytest.mark.parametrize("world", [3, 5, 6, 7])
def test_coset_lde_parts_are_the_reference_lde_columns(world, rate_bits):
    """Each rank's parts (one interleaved LDE over its fan rows at rate 3
    and 8 parts, the fold part by part otherwise) are the columns
    c = v (mod P) of the reference's `coset_lde`."""
    x = np.random.default_rng(2026 + world).integers(0, fs.P, size=(3, 1 << 7),
                                                     dtype=np.uint64)
    want = np.asarray(jax.jit(jntt.coset_lde, static_argnums=1)(jnp.asarray(x), rate_bits))
    count = parallel.parts_count(world)
    coeffs = g.tensor(x, "cpu")
    for rank in range(world):
        own = parallel.Group(rank, world, torch.device("cpu")).own_parts
        got = g.to_numpy(ntt.coset_lde_parts(coeffs, rate_bits, own, count))
        assert got.shape == (len(own), 3, want.shape[-1] // count)
        for t, v in enumerate(own):
            np.testing.assert_array_equal(got[t], want[:, v::count])


@pytest.mark.parametrize("world", [3, 6])
@pytest.mark.parametrize("rate_bits, qd_bits", [(1, 1), (3, 1), (3, 3), (4, 3)])
def test_quotient_holders_take_every_point_once(world, rate_bits, qd_bits):
    """The holders' points cover the quotient domain once, and a table
    sliced to each rank's points, gathered as `QuotientPoints.gather`
    orders it, is the whole table."""
    n = 64
    whole = torch.arange(n << qd_bits, dtype=torch.int64)[None]
    points = [parallel.QuotientPoints(parallel.Group(r, world, torch.device("cpu")),
                                      rate_bits, qd_bits) for r in range(world)]
    K = points[0].holders
    blocks = {}
    for qp in points:
        if qp.holds:
            local = qp.table(whole)
            b = local.shape[-1] // len(qp.mine)
            for i, (_, a) in enumerate(qp.mine):
                blocks[a] = local[..., i * b:(i + 1) * b]
    assert sorted(blocks) == list(range(K))
    rebuilt = torch.movedim(torch.stack([blocks[a] for a in range(K)]), 0, -1).reshape(1, -1)
    assert torch.equal(rebuilt, whole)


def test_a_world_a_circuit_cannot_split_raises_naming_both():
    """8 rows over 5 ranks (16 parts), and an LDE of 8 points over 6 ranks."""
    from types import SimpleNamespace

    with pytest.raises(ValueError, match=r"8 rows do not split over a world of 5 ranks "
                                         r"\(16 parts\)"):
        tp._check_group(SimpleNamespace(degree=8), parallel.Group(0, 5, torch.device("cpu")))
    with parallel.use_mesh(parallel.Group(0, 6, torch.device("cpu"))):
        with pytest.raises(ValueError, match=r"8 LDE points do not split over a world of 6"):
            PolynomialBatch.from_coeffs(np.ones((2, 4), dtype=np.uint64), 1, False, 0)


def test_any_world_joins_a_group():
    parallel.check_world(3)
    parallel.check_world(7)
    with pytest.raises(ValueError, match="at least one"):
        parallel.check_world(0)


def test_prove_many_refuses_dispatch_threads_under_nccl():
    """Over NCCL (a group on the card) with more than one rank, dispatch
    threads raise before any work: their communicators deadlocked against
    each other on the cards. Raised before the group's device is touched."""
    prover_only, common, _ = ranks.factorial()
    with parallel.use_mesh(parallel.Group(0, 3, torch.device("cuda", 0))):
        with pytest.raises(ValueError, match="NCCL group of 3 ranks takes threads=1, not 2"):
            tp.prove_many(prover_only, common, [], threads=2)
