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


# -- the paths under the group, each beside what it is held to -----------------------

SEED = 2026  # tools/generate_fixtures.py
STARKY_LOG_ROWS = 7  # plonky2_torch/data/starky_{fibonacci,lookup}7.proof.bin
STARK_KECCAK_LOG_ROWS = 5  # tests/torch_make_data.py's, plonky2_torch/data/stark_keccak.json
CTL_LOG_ROWS = (8, 7, 6)  # tests/torch_make_data.py's, plonky2_torch/data/ctl_table*
CTL_QUERIES, CTL_POW_BITS = 1, 8
# (rate bits, max quotient degree factor) of the low-degree circuit: a world
# of 4 above 2^rate_bits (the fold, and the next rows on another rank), the
# quotient on every 4th LDE point (rank 0 holds it all), on every other one
PLONK_CONFIGS = ((1, 2), (3, 2), (4, 8))
PROVE_MANY_INPUTS = (1, 2, 3)  # factorial's initial value in each proof
PROVE_MANY_POW_BITS = 8  # the plain grind of 16 bits is most of a CPU prove


@contextlib.contextmanager
def seeded():
    from plonky2_torch.util import rng

    rng.seed(SEED)
    try:
        yield
    finally:
        rng.seed(None)


def starky_case(name: str, log_rows: int):
    """(stark, trace, public inputs) of tests/test_torch_starky.py's cases."""
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_torch.starky.test_starks import LookupTestStark

    n = 1 << log_rows
    if name == "fibonacci":
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        return stark, stark.generate_trace(pis[0], pis[1]), pis
    stark = LookupTestStark(n)
    return stark, stark.generate_trace(), []


def ctl_config():
    """standard_fast_config at CTL_QUERIES queries and CTL_POW_BITS bits
    (tests/reference_prove_ctl.py `stark_config`)."""
    from plonky2_torch.starky.config import StarkConfig

    config = StarkConfig.standard_fast_config()
    return dataclasses.replace(config, fri_config=dataclasses.replace(
        config.fri_config, num_query_rounds=CTL_QUERIES, proof_of_work_bits=CTL_POW_BITS))


def batch_fri_params():
    """tests/torch_make_data.py's `batch_fri_small_params`."""
    from plonky2_torch.fri import config as fc

    arities = (1,) * 4
    return fc.FriParams(
        config=fc.FriConfig(rate_bits=3, cap_height=2, proof_of_work_bits=8,
                            reduction_strategy=fc.FriReductionStrategy.Fixed(arities),
                            num_query_rounds=8),
        hiding=False, degree_bits=9, reduction_arity_bits=arities)


def _builder_modules(package: str):
    """(CircuitBuilder, CircuitConfig, PartialWitness) of `package`: the port,
    or the reference for tests/torch_make_data.py's `--parallel`."""
    import importlib

    return (importlib.import_module(f"{package}.plonk.circuit_builder").CircuitBuilder,
            importlib.import_module(f"{package}.plonk.config").CircuitConfig,
            importlib.import_module(f"{package}.iop.witness").PartialWitness)


def low_degree_circuit(rate_bits: int, qdf: int, package: str = "plonky2_torch"):
    """(CircuitBuilder, PartialWitness) of `package`: eight 60-bit splits
    (BaseSumGate, of degree 2) and no public input, so no gate exceeds a
    quotient degree factor of 2, under standard_recursion_config at
    `rate_bits`, `qdf` and 8 PoW bits."""
    builder_cls, config_cls, witness_cls = _builder_modules(package)
    base = config_cls.standard_recursion_config()
    config = dataclasses.replace(base, max_quotient_degree_factor=qdf, fri_config=dataclasses.
                                 replace(base.fri_config, rate_bits=rate_bits,
                                         proof_of_work_bits=8))
    builder = builder_cls(config)
    xs = [builder.add_virtual_target() for _ in range(8)]
    for x in xs:
        builder.split_le(x, 60)
    pw = witness_cls()
    for i, x in enumerate(xs):
        pw.set_target(x, 1000 + i)
    return builder, pw


def prove_many_circuit(package: str = "plonky2_torch"):
    """(CircuitBuilder, PartialWitnesses) of `package`: examples/factorial.py's
    circuit of 100! under standard_recursion_config at PROVE_MANY_POW_BITS
    PoW bits, and its inputs at PROVE_MANY_INPUTS."""
    builder_cls, config_cls, witness_cls = _builder_modules(package)
    base = config_cls.standard_recursion_config()
    builder = builder_cls(dataclasses.replace(base, fri_config=dataclasses.replace(
        base.fri_config, proof_of_work_bits=PROVE_MANY_POW_BITS)))
    initial = cur = builder.add_virtual_target()
    for i in range(2, 101):
        cur = builder.mul(cur, builder.constant(i))
    builder.register_public_input(initial)
    builder.register_public_input(cur)
    inputs = []
    for v in PROVE_MANY_INPUTS:
        pw = witness_cls()
        pw.set_target(initial, v)
        inputs.append(pw)
    return builder, inputs


def reference_proof_names() -> list[str]:
    """The files under plonky2_torch/data that tests/torch_make_data.py's
    `--parallel` writes from the reference: the low-degree circuit's proof at
    each of PLONK_CONFIGS, then prove_many's circuit's sequential proofs."""
    return ([f"low_degree_rate{r}_qdf{q}.proof.bin" for r, q in PLONK_CONFIGS]
            + [f"prove_many_factorial{v}.proof.bin" for v in PROVE_MANY_INPUTS])


def _paths(group) -> dict:
    """Every prover path under the group: name -> what its test compares."""
    from plonky2_torch.examples import batch_fri as bf
    from plonky2_torch.examples import factorial as fact
    from plonky2_torch.examples import multi_table as mt
    from plonky2_torch.hash import merkle
    from plonky2_torch.hash.hashers import KeccakHasher
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.starky import cross_table_lookup as ctl
    from plonky2_torch.starky import prover as sp
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.serialization import stark_proof_to_bytes
    from torch_proof_walk import digest, field_digests

    out = {}
    config = StarkConfig.standard_fast_config()
    with parallel.use_mesh(group):
        for name in ("fibonacci", "lookup"):
            stark, trace, pis = starky_case(name, STARKY_LOG_ROWS)
            out[f"starky {name}"] = stark_proof_to_bytes(sp.prove(stark, config, trace, pis),
                                                         config)
            stark, trace, pis = starky_case(name, STARK_KECCAK_LOG_ROWS)
            merkle.reset_host_trees()
            proof = sp.prove(stark, config, trace, pis, hasher=KeccakHasher)
            out[f"keccak starky {name}"] = (field_digests(proof), digest(proof),
                                            merkle.HOST_TREES["trees"])

        starks, ctls = mt.system()
        traces, pis = mt.generate_traces(CTL_LOG_ROWS)
        proofs, _ = ctl.prove_multi_table(starks, ctl_config(), traces, pis, ctls)
        out["multi-table"] = [stark_proof_to_bytes(p, ctl_config()) for p in proofs]

        params = batch_fri_params()
        run = bf.prove(bf.random_groups((9, 7), (3, 2), 2), params)
        out["batch FRI"] = (bf.proof_bytes(run.proof), (
            list(run.challenger.sponge_state), list(run.challenger.input_buffer),
            list(run.challenger.output_buffer)))

        with seeded():
            data, proof = fact.keccak_build_and_prove()
        out["keccak factorial"] = (verifier_data_to_bytes(data.verifier_only, data.common),
                                   proof_to_bytes(proof), tp._LAST_TRANSCRIPT)
        # built whole, outside the group: its Keccak tree sliced to the rank's part
        with parallel.use_mesh(None):
            data = fact.keccak_build_and_prove(device=group.device)[0]
        pw = PartialWitness()
        pw.set_target(data.prover_only.public_inputs[0], 1)
        with seeded():
            out["keccak factorial, built whole"] = proof_to_bytes(data.prove(pw))

        builder, inputs = prove_many_circuit()
        with parallel.use_mesh(None):
            data = builder.build(device=group.device)

        def prove_many(threads):  # on the host transcript: the fused one emulates K5 here
            with seeded(), fri_prover.force_host_path():
                proofs = tp.prove_many(data.prover_only, data.common, inputs,
                                       device=group.device, window=2, threads=threads)
            return [proof_to_bytes(p) for p in proofs], tp._LAST_MAX_IN_FLIGHT

        out["prove_many threads 1"] = prove_many(1)
        # two dispatch threads, each slot on its own communicator
        out["prove_many threads 2"] = prove_many(2)

        with seeded(), fri_prover.force_host_path():
            data, proof = fact.build_and_prove()
        out["factorial build"] = (verifier_data_to_bytes(data.verifier_only, data.common),
                                  proof_to_bytes(proof))
    # the build left the rank's part for this group, and the whole batch outside it
    # has the same cap
    part = data.prover_only.cache(group.device).get(("constants_sigmas", group.rank, group.world))
    with parallel.use_mesh(None):
        whole = data.prover_only.commitment(data.common, group.device)
    out["factorial build, parts"] = (
        part is not None and part.lde_parts.shape[0] == len(group.own_parts)
        and part.lde_parts.shape[-1] * group.parts == whole.lde.shape[-1],
        whole.merkle_tree.cap == data.verifier_only.constants_sigmas_cap)

    with parallel.use_mesh(group):
        for rate_bits, qdf in PLONK_CONFIGS:
            builder, pw = low_degree_circuit(rate_bits, qdf)
            data = builder.build()
            with seeded(), fri_prover.force_host_path():
                out[f"plonk rate {rate_bits} qdf {qdf}"] = proof_to_bytes(data.prove(pw))
    return out


def four_ranks(group) -> dict:
    """Everything tests/test_torch_parallel.py holds a 4-rank group to, and
    tests/test_torch_parallel_any_world.py a 3-rank one."""
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

    out["paths"] = _paths(group)
    return out


def collective_with_a_missing_rank(group):
    """Rank 0 all-gathers; rank 1 leaves the group without taking part, so
    rank 0's collective raises."""
    if group.rank == 0:
        group.all_gather(torch.zeros(4, dtype=torch.int64))
    return group.rank


def six_ranks(group) -> dict:
    """What tests/test_torch_parallel_any_world.py holds a 6-rank group (16
    parts, two or three a rank) to: the commit, the caps and openings, the
    Z scan and the PLONK config at rate 1 (the fold)."""
    out = {"rank": group.rank, "world": group.world, "uneven": {}, "caps": {}}
    for rows, degree in UNEVEN:
        with parallel.use_mesh(group):
            batch = PolynomialBatch.from_values(uneven_values(rows, degree), 3, False, 2)
            lde = parallel.gather_columns(batch.lde)
        out["uneven"][rows, degree] = dict(
            coeffs=g.to_numpy(batch.polynomials), lde=g.to_numpy(lde),
            local_shape=tuple(batch.lde_parts.shape), cap=batch.merkle_tree.cap)
    wires, sigmas, s_id, beta, gamma = zscan_inputs()
    z, pp = tp._round2_one_challenge(
        *(g.tensor(parallel.shard_lanes(m, group), group.device) for m in (wires, sigmas, s_id)),
        g.scalar_tensor(beta, group.device), g.scalar_tensor(gamma, group.device), 8, group)
    out["zscan"] = g.to_numpy(parallel.gather_lanes(torch.cat([z[None], pp]), group))
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
    rate_bits, qdf = PLONK_CONFIGS[0]
    builder, pw = low_degree_circuit(rate_bits, qdf)
    with parallel.use_mesh(group):
        data = builder.build()
        with seeded(), fri_prover.force_host_path():
            out[f"plonk rate {rate_bits} qdf {qdf}"] = proof_to_bytes(data.prove(pw))
    return out
