"""The rank functions of tests/test_torch_parallel.py.

`plonky2_torch.parallel.run_on_group` runs them in spawned processes, which
import this module by name: it imports neither JAX nor the reference
package, and pytest does not collect it. Each function takes the rank's
`Group` and returns plain data (bytes, numpy arrays, lists) for the test
process to compare with the reference and with one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri import prover as fri_prover
from plonky2_torch.fri.oracle import PolynomialBatch
from plonky2_torch.plonk import prover as tp
from plonky2_torch.plonk.prover_serialization import read_prover_data
from plonky2_torch.plonk.serialization import proof_to_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "plonky2_torch", "data")

# (rows, degree) of the uneven batches: the reference's 135 x 32, and a
# degree whose 2^12-point LDE takes the interleaved form on each rank
UNEVEN = ((135, 32), (13, 512))
CAP_HEIGHTS = (0, 1, 4)  # below, at and above lg 4
OPENED = list(range(0, 512, 37))  # reference indices of the 512-point LDE


def factorial():
    """(prover data, common data, prepared witness) of the factorial circuit."""
    with open(os.path.join(DATA, "factorial.prover.bin"), "rb") as f:
        prover_only, common = read_prover_data(f.read())
    w = np.load(os.path.join(DATA, "factorial.witness.npz"))
    return prover_only, common, (w["witness"], [int(v) for v in w["public_inputs"]],
                                 [int(v) for v in w["public_inputs_hash"]])


def uneven_values(rows: int, degree: int) -> np.ndarray:
    return np.random.default_rng(3).integers(0, 1 << 63, size=(rows, degree), dtype=np.uint64)


def cap_values() -> np.ndarray:
    return np.random.default_rng(5).integers(0, fs.P, size=(8, 64), dtype=np.uint64)


def zscan_inputs():
    """(wires, sigmas, s_id [8, 64], beta, gamma) drawn from a seed."""
    rng = np.random.default_rng(11)
    mats = [rng.integers(0, fs.P, size=(8, 64), dtype=np.uint64) for _ in range(3)]
    return (*mats, *(int(v) for v in rng.integers(0, fs.P, size=2, dtype=np.uint64)))


def _openings(tree):
    return [(leaf, proof.siblings) for leaf, proof in tree.open_many(OPENED)]


def _prove_factorial(group, host: bool):
    prover_only, common, prepared = factorial()
    force = fri_prover.force_host_path() if host else contextlib.nullcontext()
    parallel.Collectives.reset()
    with parallel.use_mesh(group), force:
        proof = proof_to_bytes(tp.prove(prover_only, common, None, _prepared=prepared))
    return proof, tp._LAST_TRANSCRIPT, parallel.Collectives.count


def _refusals(group) -> dict:
    """name -> the exception each refused call raised under the group."""
    from plonky2_torch.fri import batch_fri
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.plonk.config import keccak_goldilocks_config
    from plonky2_torch.starky import cross_table_lookup, prover as starky_prover

    prover_only, common, prepared = factorial()
    calls = {
        "rate_bits below lg world": lambda: PolynomialBatch.from_values(cap_values(), 1, False, 0),
        "quotient on every other LDE point": lambda: tp.prove(
            prover_only, dataclasses.replace(common, quotient_degree_factor=4), None,
            _prepared=prepared),
        "Keccak prove": lambda: tp.prove(
            prover_only, dataclasses.replace(common, gc=keccak_goldilocks_config()), None,
            _prepared=prepared),
        "prove_many": lambda: tp.prove_many(prover_only, common, []),
        "Starky prove": lambda: starky_prover.prove(None, None, None, None),
        "multi-table prove": lambda: cross_table_lookup.prove_multi_table(
            None, None, None, None, None),
        "batch FRI oracle": lambda: batch_fri.BatchFriOracle([], 3, 0),
        "batch FRI prove": lambda: batch_fri.batch_fri_proof([], [], None, None),
        "circuit build": lambda: CircuitBuilder().build(device=group.device),
    }
    out = {}
    with parallel.use_mesh(group):
        for name, call in calls.items():
            try:
                call()
                out[name] = None
            except (ValueError, NotImplementedError) as e:
                out[name] = type(e).__name__
    return out


def four_ranks(group) -> dict:
    """Everything tests/test_torch_parallel.py holds a 4-rank group to."""
    out = {"rank": group.rank, "world": group.world}
    out["factorial"] = {path: _prove_factorial(group, path == "host")
                        for path in ("fused", "host")}

    values = np.random.default_rng(7).integers(0, (1 << 64) - (1 << 32), size=(8, 64),
                                               dtype=np.uint64)
    coeffs, leaves, cap = parallel.sharded_commit(values, 3, 2, group)
    out["sharded_commit"] = tuple(g.to_numpy(t) for t in (coeffs, leaves, cap))

    out["uneven"] = {}
    for rows, degree in UNEVEN:
        with parallel.use_mesh(group):
            batch = PolynomialBatch.from_values(uneven_values(rows, degree), 3, False, 2)
            lde = parallel.gather_columns(batch.lde)
        out["uneven"][rows, degree] = dict(
            coeffs=g.to_numpy(batch.polynomials), lde=g.to_numpy(lde),
            local_shape=tuple(batch.lde.shape), cap=batch.merkle_tree.cap)

    wires, sigmas, s_id, beta, gamma = zscan_inputs()
    z, pp = tp._round2_one_challenge(
        *(g.tensor(parallel.shard_lanes(m, group), group.device) for m in (wires, sigmas, s_id)),
        g.scalar_tensor(beta, group.device), g.scalar_tensor(gamma, group.device), 8, group)
    out["zscan"] = g.to_numpy(parallel.gather_lanes(torch.cat([z[None], pp]), group))

    cap_step, z_step = parallel.sharded_prover_step(group)
    out["prover_step"] = (g.to_numpy(cap_step), g.to_numpy(z_step))

    out["caps"] = {}
    for cap_height in CAP_HEIGHTS:
        with parallel.use_mesh(group):
            built = PolynomialBatch.from_values(cap_values(), 3, False, cap_height)
            lde_values = [built.get_lde_values(i) for i in (0, 5, 511)]
        with parallel.use_mesh(None):
            whole = PolynomialBatch.from_values(cap_values(), 3, False, cap_height,
                                                device=group.device)
        sliced = whole.merkle_tree.part(group)
        out["caps"][cap_height] = dict(
            built=(built.merkle_tree.cap, _openings(built.merkle_tree)),
            sliced=(sliced.cap, _openings(sliced)), lde_values=lde_values)

    out["refusals"] = _refusals(group)
    return out


def collective_with_a_missing_rank(group):
    """Rank 0 all-gathers; rank 1 leaves the group without taking part, so
    rank 0's collective raises."""
    if group.rank == 0:
        group.all_gather(torch.zeros(4, dtype=torch.int64))
    return group.rank
