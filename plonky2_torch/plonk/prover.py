"""PLONK prover (reference plonk/prover.py:384-556, :976-1304,
plonk/prover.rs:113-815), under `PoseidonGoldilocksConfig` or
`KeccakGoldilocksConfig`, with or without zero knowledge, with or without
lookups.

`prepare_witness` is the host witness phase: the circuit's generators run
from the caller's PartialWitness (`iop/generator.py`, the native witness
plan by default), the lookup wires are filled (`set_lookup_wires`: the last
LookupGate's free slots and the table rows' multiplicities), then the
public inputs, their hash and the full witness matrix. Every rng draw of
a non-zk prove happens there. Under zero
knowledge the blinding rows' random values are drawn there too, and the
three salted commitments' salts (wires, Zs and partial products, quotient:
the reference's draw order, with no other draw between) right after it, on
the host, and go up with the witness (`_draw_salts`). `prove` runs the
witness phase and then the device chain; `prove_many` runs the witness
phases on the caller's thread in proof order and overlaps them with
earlier proofs' device chains.

The device chain runs every round on tensors of one device:

  wires commitment        iFFT, coset LDE, Merkle tree   (fri/oracle.py: K2, K4)
  partial products, Zs    batch inverses and modular prefix-product scans;
  and lookup columns      with LUTs, each challenge's RE and partial-SLDC
                          columns over the lookup region's rows (host row
                          recurrences, or on the device an affine scan and
                          prefix sums), committed with the Zs
  quotient polynomials    every gate's constraints over the 2^(degree bits +
                          log qdf)-point coset, filtered, α-reduced, divided by
                          Z_H, then one coset iFFT (K3) into qdf chunks per
                          challenge
  openings, FRI           fri/oracle.py, fri/prover.py (K2, K3, K4, K5)

The Fiat-Shamir transcript takes one of two paths, which give the same
proof bytes. The fused path (the default, as in the reference, whenever
`_can_fuse_transcript` holds) moves the host-observed prefix (FRI
parameters, circuit digest, public-inputs hash) to the device before the
wires commitment and keeps the transcript there (`DeviceChallenger`): the
caps, the draws, the openings and the whole FRI argument return in one
device-to-host fetch, and a warm prove synchronises with the host nowhere
before it: the lookup deltas stay device draws, and each LUT's polynomial
is evaluated from them on the device. The host path (inside
`fri.prover.force_host_path()`, and
under Keccak, as the reference routes it) reads each cap and draw back to
the host between the rounds; under Keccak the commitments' trees and the
grind are the host's too (`fri/oracle.py`, `fri/prover.py`). The field
work between the kernels is plain PyTorch on the same device.

Under a process group (`plonky2_torch.parallel.use_mesh`) `prove` and
`prove_many` run on the group's device on every rank and give the single
device's proof bytes on each, on both transcript paths and under either
hasher: the witness, the coefficients, the openings, FRI and the
transcript are whole on every rank; each commitment holds the rank's parts
of the LDE and their part of the tree, the constants-sigmas batch is the
part a build under the group left or is sliced out of the one committed
whole (`_constants_part`), round 2 scans its parts' contiguous blocks of
the points with a carry across the blocks and gathers its values, and the
ranks holding quotient points evaluate them and gather the values before
the coset iFFT (`parallel.QuotientPoints`). Every rank computes its parts of the work
(the P parts of `parallel.Group.parts`: P = k for a power-of-two world k,
else the least power of two >= 2k); a world takes any config whose n rows
split into its P parts, and `_check_group` raises, naming both numbers,
for one that does not.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri import prover as fri_prover
from plonky2_torch.fri.oracle import PolynomialBatch, _batch_quotient, eval_polys_at, salt_stream
from plonky2_torch.gates.gate import UNUSED_SELECTOR, rows
from plonky2_torch.gates.lookup import LookupGate, LookupTableGate
from plonky2_torch.hash import poseidon as ps
from plonky2_torch.hash.merkle import NaturalMerkleTree
from plonky2_torch.iop.challenger import Challenger, DeviceChallenger, cap_boundary
from plonky2_torch.iop.generator import generate_partial_witness
from plonky2_torch.iop.target import Wire
from plonky2_torch.plonk import config as pcfg
from plonky2_torch.plonk.proof import OpeningSet, Proof, ProofWithPublicInputs
from plonky2_torch.plonk.vanishing_poly import (
    CHALLENGE_A,
    CHALLENGE_ALPHA,
    CHALLENGE_B,
    CHALLENGE_DELTA,
    NUM_COINS_LOOKUP,
    check_lookup_constraints_device,
    eval_lut_poly,
    lut_evals_device,
)
from plonky2_torch.util import TimingTree, log2_strict

# which transcript path the last prove took: "fused" or "host"
_LAST_TRANSCRIPT = None
# the most proofs the last prove_many had in flight at once
_LAST_MAX_IN_FLIGHT = 0
# the pipeline the last prove_many ran: "single-stream" (threads == 1, and
# under zero knowledge whatever `threads` asked, so the rng stream stays in
# proof order) or "threads"
_LAST_PROVE_MANY_MODE = None


def random_witness(common, seed: int):
    """A witness matrix [num_wires, degree], public inputs and their
    Poseidon hash, drawn from a numpy seed. It need not satisfy the circuit:
    the prover's work is the same."""
    rng = np.random.default_rng(seed)
    witness = rng.integers(0, fs.P, size=(common.config.num_wires, common.degree),
                           dtype=np.uint64)
    public_inputs = [int(v) for v in rng.integers(0, fs.P, size=common.num_public_inputs,
                                                  dtype=np.uint64)]
    return witness, public_inputs, ps.hash_no_pad(public_inputs)


def _can_fuse_transcript(common, challenger, constants_sigmas) -> bool:
    """The reference's conditions for the fused path: a Poseidon
    transcript, at least one FRI fold step, natural-order trees; and not
    inside force_host_path()."""
    from plonky2_torch.hash.hashers import PoseidonHasher

    return (not fri_prover._FORCE_HOST
            and challenger.hasher is PoseidonHasher
            and bool(tuple(common.fri_params.reduction_arity_bits))
            and isinstance(constants_sigmas.merkle_tree, NaturalMerkleTree))


def prepare_witness(prover_data, common, inputs, timing: TimingTree | None = None,
                    engine: str | None = None):
    """The host witness phase of a prove (reference plonk/prover.py:384):
    the generators run from `inputs` (a PartialWitness) on `engine` (the
    native witness plan unless the caller or `generator.ENGINE` says
    "python"), then the public inputs, their Poseidon hash and the full
    witness [num_wires, degree] u64. Returns (witness, public inputs,
    public-inputs hash)."""
    timing = timing or TimingTree("prepare")
    with timing.scope("generate partial witness"):
        partition_witness = generate_partial_witness(inputs, prover_data, common, engine)
    if common.num_lookup_polys:
        set_lookup_wires(prover_data, common, partition_witness)
    public_inputs = partition_witness.get_targets(prover_data.public_inputs)
    public_inputs_hash = ps.hash_no_pad(public_inputs)
    with timing.scope("compute full witness"):
        witness = partition_witness.full_witness()
    return witness, public_inputs, public_inputs_hash


# -- lookups ------------------------------------------------------------------

def set_lookup_wires(prover_data, common, witness) -> None:
    """Each LUT's lookups counted into its table rows' multiplicity wires,
    and the last LookupGate's free slots filled with the LUT's first entry,
    each counted too (reference plonk/prover.rs:41-111). `witness`: the
    PartitionWitness after the generators."""
    num_entries = LookupGate.num_slots_from_config(common.config)
    num_lut_entries = LookupTableGate.num_slots_from_config(common.config)
    for lut_index, lw in enumerate(prover_data.lookup_rows):
        lut = common.luts[lut_index]
        lookups = prover_data.lut_to_lookups[lut_index]
        value_to_idx = {inp: i for i, (inp, _) in enumerate(lut)}
        multiplicities = [0] * len(lut)
        for looking_in, _ in lookups:
            multiplicities[value_to_idx[witness.get_target(looking_in)]] += 1
        first_inp, first_out = lut[0]
        for slot in range(num_entries - (-len(lookups)) % num_entries, num_entries):
            witness.set_target(Wire(lw.last_lut_gate - 1, LookupGate.wire_ith_looking_inp(slot)),
                               first_inp)
            witness.set_target(Wire(lw.last_lut_gate - 1, LookupGate.wire_ith_looking_out(slot)),
                               first_out)
            multiplicities[0] += 1
        for entry, m in enumerate(multiplicities):
            witness.set_target(Wire(lw.first_lut_gate - entry // num_lut_entries,
                                    LookupTableGate.wire_ith_multiplicity(
                                        entry % num_lut_entries)), m)


def _lookup_shape(common) -> tuple[int, int, int, int, int]:
    """(LookupGate slots, slots a lookup chunk, SLDC columns, LookupTableGate
    slots, slots a table chunk)."""
    config = common.config
    num_lu_slots = LookupGate.num_slots_from_config(config)
    lu_degree = config.max_quotient_degree_factor - 1
    num_partial = -(-num_lu_slots // lu_degree)
    num_lut_slots = LookupTableGate.num_slots_from_config(config)
    return num_lu_slots, lu_degree, num_partial, num_lut_slots, -(-num_lut_slots // num_partial)


def compute_lookup_polys(witness, deltas4, prover_data, common) -> list[list[int]]:
    """One challenge's RE column and partial-SLDC columns [num_lookup_polys,
    degree] from its four draws, by the reference's row recurrences over
    each lookup region, table rows from the top, then the lookup rows
    (reference plonk/prover.rs:458-605). witness: [num_wires, degree] u64."""
    degree = common.degree
    num_lu_slots, lu_degree, num_partial, num_lut_slots, lut_degree = _lookup_shape(common)
    polys = [[0] * degree for _ in range(num_partial + 1)]
    da, db, dalpha, ddelta = (deltas4[k] for k in (CHALLENGE_A, CHALLENGE_B, CHALLENGE_ALPHA,
                                                   CHALLENGE_DELTA))

    def w(row, col):
        return int(witness[col, row])

    for lw in prover_data.lookup_rows:
        for row in range(lw.first_lut_gate, lw.last_lut_gate - 1, -1):
            ins = [w(row, LookupTableGate.wire_ith_looked_inp(s)) for s in range(num_lut_slots)]
            outs = [w(row, LookupTableGate.wire_ith_looked_out(s)) for s in range(num_lut_slots)]
            inv = fs.batch_inverse([fs.sub(dalpha, fs.add(i, fs.mul(da, o)))
                                    for i, o in zip(ins, outs)])
            new_re = polys[0][(row + 1) % degree]
            for i, o in zip(ins, outs):
                new_re = fs.add(fs.mul(new_re, ddelta), fs.add(i, fs.mul(db, o)))
            polys[0][row] = new_re
            for slot in range(num_partial):
                acc = polys[slot][row] if slot else polys[num_partial][(row + 1) % degree]
                for s in range(slot * lut_degree, min((slot + 1) * lut_degree, num_lut_slots)):
                    acc = fs.add(acc, fs.mul(w(row, LookupTableGate.wire_ith_multiplicity(s)),
                                             inv[s]))
                polys[slot + 1][row] = acc
        for row in range(lw.last_lut_gate - 1, lw.last_lu_gate - 1, -1):
            inv = fs.batch_inverse([
                fs.sub(dalpha, fs.add(w(row, LookupGate.wire_ith_looking_inp(s)),
                                      fs.mul(da, w(row, LookupGate.wire_ith_looking_out(s)))))
                for s in range(num_lu_slots)])
            for slot in range(num_partial):
                prev = polys[slot][row] if slot else polys[num_partial][(row + 1) % degree]
                acc = 0
                for s in range(slot * lu_degree, min((slot + 1) * lu_degree, num_lu_slots)):
                    acc = fs.add(acc, inv[s])
                polys[slot + 1][row] = fs.sub(prev, acc)
    return polys


def _affine_scan(a, b):
    """Along the last dim, the inclusive prefix compositions of the maps
    x -> a_k x + b_k: (A, B) with x_k = A_k x_{-1} + B_k, in log2(len)
    Hillis-Steele steps. Field arithmetic is exact, so this is the
    sequential recurrence's value."""
    k = 1
    while k < a.shape[-1]:
        a, b = (torch.cat([a[..., :k], g.mul(a[..., k:], a[..., :-k])], -1),
                torch.cat([b[..., :k], g.add(g.mul(b[..., :-k], a[..., k:]), b[..., k:])], -1))
        k <<= 1
    return a, b


def _chunk_sums(x, size: int, count: int):
    """[..., S] -> [..., count]: modular sums of `size` consecutive slots,
    the tail padded with zeros."""
    fill = count * size - x.shape[-1]
    if fill:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (fill,))], -1)
    return g.sum_mod(x.reshape(x.shape[:-1] + (count, size)), -1)


def lookup_polys_device(witness, deltas, prover_data, common):
    """Every challenge's lookup columns [num_challenges · num_lookup_polys,
    degree] on the witness's device, bit for bit `compute_lookup_polys`'s,
    from the device witness and the device draws `deltas` [4 · num
    challenges], with no host read: the region's wires are read with host
    row ranges and column lists; per row the table slots' inverses come
    from one batch inversion, the RE's row Horner is a weighted sum with
    δ's powers and its recurrence an affine scan, and the SLDC columns are
    modular prefix sums, all challenges at once."""
    nc = common.config.num_challenges
    degree = common.degree
    num_lu_slots, lu_degree, num_partial, num_lut_slots, lut_degree = _lookup_shape(common)
    d = deltas.reshape(nc, NUM_COINS_LOOKUP)
    da, db, dalpha = (d[:, k, None, None] for k in (CHALLENGE_A, CHALLENGE_B, CHALLENGE_ALPHA))
    pows = torch.stack([g.powers(d[c, CHALLENGE_DELTA], num_lut_slots + 1) for c in range(nc)])
    out = torch.zeros((nc, num_partial + 1, degree), dtype=torch.int64, device=witness.device)
    for lw in prover_data.lookup_rows:
        first, last_lut, last_lu = lw.first_lut_gate, lw.last_lut_gate, lw.last_lu_gate
        n_lut, n_lu = first + 1 - last_lut, last_lut - last_lu

        def region(cols, lo, hi):
            """[rows, slots]: the wires of `cols` at rows hi - 1 down to lo."""
            return rows(witness[:, lo:hi], cols).flip(1).T

        ins = region([LookupTableGate.wire_ith_looked_inp(s) for s in range(num_lut_slots)],
                     last_lut, first + 1)
        outs = region([LookupTableGate.wire_ith_looked_out(s) for s in range(num_lut_slots)],
                      last_lut, first + 1)
        mult = region([LookupTableGate.wire_ith_multiplicity(s) for s in range(num_lut_slots)],
                      last_lut, first + 1)
        lu_ins = region([LookupGate.wire_ith_looking_inp(s) for s in range(num_lu_slots)],
                        last_lu, last_lut)
        lu_outs = region([LookupGate.wire_ith_looking_out(s) for s in range(num_lu_slots)],
                         last_lu, last_lut)
        # every 1 / (α - (in + a · out)) of the region in one inversion
        dens = torch.cat([g.sub(dalpha, g.add(ins, g.mul(da, outs))).reshape(-1),
                          g.sub(dalpha, g.add(lu_ins, g.mul(da, lu_outs))).reshape(-1)])
        n = dens.shape[0]
        size = 1 << max(n - 1, 1).bit_length()
        inv = g.inverse_vector(torch.cat([dens, torch.ones(size - n, dtype=torch.int64,
                                                           device=dens.device)]))[:n]
        inv_lut = inv[:nc * n_lut * num_lut_slots].reshape(nc, n_lut, num_lut_slots)
        inv_lu = inv[nc * n_lut * num_lut_slots:].reshape(nc, n_lu, num_lu_slots)

        # the RE over the table rows: x_k = δ^S · x_{k-1} + Σ_s (in_s + b · out_s) δ^(S-1-s)
        combos = g.add(ins, g.mul(db, outs))
        e = g.sum_mod(g.mul(combos, pows[:, None, :num_lut_slots].flip(-1)), -1)  # [nc, n_lut]
        step = pows[:, num_lut_slots]
        e[:, 0] = g.add(e[:, 0], g.mul(step, out[:, 0, (first + 1) % degree]))
        _, re_col = _affine_scan(step[:, None].expand(nc, n_lut).contiguous(), e)

        # the SLDC over the table rows, then on down the lookup rows
        chunks = g.cumsum(_chunk_sums(g.mul(mult, inv_lut), lut_degree, num_partial), -1)
        carry = out[:, num_partial, (first + 1) % degree]
        s_incl = g.cumsum(chunks[..., -1], -1)  # [nc, n_lut]
        s_before = g.add(carry[:, None], torch.cat([torch.zeros_like(s_incl[:, :1]),
                                                    s_incl[:, :-1]], -1))
        cols_lut = g.add(s_before[..., None], chunks)
        out[:, 0, last_lut:first + 1] = re_col.flip(-1)
        out[:, 1:, last_lut:first + 1] = cols_lut.flip(1).transpose(1, 2)
        if n_lu:
            carry = g.add(carry, s_incl[:, -1])
            chunks = g.cumsum(_chunk_sums(inv_lu, lu_degree, num_partial), -1)
            s_incl = g.cumsum(chunks[..., -1], -1)
            s_before = g.sub(carry[:, None], torch.cat([torch.zeros_like(s_incl[:, :1]),
                                                        s_incl[:, :-1]], -1))
            cols_lu = g.sub(s_before[..., None], chunks)
            out[:, 1:, last_lu:last_lut] = cols_lu.flip(1).transpose(1, 2)
    return out.reshape(nc * (num_partial + 1), degree)


def _draw_salts(common, device):
    """The salts of a zk prove's three blinding commitments (wires, Zs and
    partial products, quotient), each a stream of SALT_SIZE · N felts from
    the prover rng, drawn in that order in one draw and uploaded without a
    synchronisation; (None, None, None) without zero knowledge."""
    if not common.config.zero_knowledge:
        return None, None, None
    n_lde = common.degree << common.config.fri_config.rate_bits
    flat = g.upload(salt_stream(3 * n_lde), device)
    blinding = (pcfg.WIRES.blinding, pcfg.ZS_PARTIAL_PRODUCTS.blinding, pcfg.QUOTIENT.blinding)
    return tuple(s if b else None for s, b in zip(flat.reshape(3, -1), blinding))


def prove(prover_data, common, inputs, device=None, timing: TimingTree | None = None,
          _defer: bool = False, _prepared=None):
    """Prove `common`'s circuit from `inputs` (a PartialWitness) on `device`
    (CUDA unless the caller asks for another). _prepared: what
    `prepare_witness` returns, (witness, public inputs, public-inputs hash),
    in place of running it; the witness is [num_wires, degree] u64 values or
    that matrix as an int64 tensor already on the device, and `inputs` is
    then unused. _defer=True returns `finish()` unrun: on the fused path
    every launch is queued and the one fetch and the parse wait for the
    call; a host-path prove completes and returns a closure over its
    proof."""
    global _LAST_TRANSCRIPT
    group, device = parallel.placement(device)
    _check_group(common, group)
    timing = timing or TimingTree("prove")
    if _prepared is None:
        _prepared = prepare_witness(prover_data, common, inputs, timing)
    witness, public_inputs, public_inputs_hash = _prepared
    config = common.config
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    nc = config.num_challenges
    salts = _draw_salts(common, device)

    hasher = common.generic_config().hasher

    def commit_values(values, salt):
        return PolynomialBatch.from_values(values, rate_bits, salt is not None, cap_height,
                                           hasher=hasher, salt=salt)

    constants_sigmas = (prover_data.commitment(common, device) if group is None
                        else _constants_part(prover_data, common, group))
    challenger = Challenger(hasher)
    common.fri_params.observe(challenger)
    challenger.observe_hash(prover_data.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    fused = _can_fuse_transcript(common, challenger, constants_sigmas)
    if fused:  # the host-observed prefix goes up ahead of the wires commitment
        transcript = (g.upload(challenger.sponge_state, device),
                      g.upload(challenger.input_buffer, device))
        pi_hash_dev = g.upload(public_inputs_hash, device)
    with timing.scope("wires commitment"):
        witness_dev = (witness.to(device) if isinstance(witness, torch.Tensor)
                       else g.upload(witness, device))
        wires = commit_values(witness_dev, salts[0])

    if fused:
        _LAST_TRANSCRIPT = "fused"
        out = _prove_fused(prover_data, common, constants_sigmas, wires, witness_dev,
                           transcript, public_inputs, pi_hash_dev, timing, _defer, salts)
        if not _defer:  # every per-circuit table of this device (and group) now exists
            prover_data.cache(device)[_group_key("warm", group)] = True
        return out
    _LAST_TRANSCRIPT = "host"
    challenger.observe_cap(wires.merkle_tree.cap)
    betas = challenger.get_n_challenges(nc)
    gammas = challenger.get_n_challenges(nc)
    deltas = []
    if common.num_lookup_polys:
        deltas = betas + gammas + challenger.get_n_challenges((NUM_COINS_LOOKUP - 2) * nc)

    with timing.scope("partial products and Zs"):
        zs_pp_values = all_partial_products_and_zs(
            witness_dev[:config.num_routed_wires], prover_data, common, betas, gammas)
    if deltas:
        with timing.scope("compute lookup polys"):
            witness_np = g.to_numpy(witness_dev) if isinstance(witness, torch.Tensor) else witness
            lookup = [col for c in range(nc) for col in compute_lookup_polys(
                witness_np, deltas[NUM_COINS_LOOKUP * c:NUM_COINS_LOOKUP * (c + 1)],
                prover_data, common)]
            zs_pp_values = torch.cat([zs_pp_values, g.tensor(lookup, device)])
    del witness_dev
    with timing.scope("zs_partial_products commitment"):
        zs_pp = commit_values(zs_pp_values, salts[1])
    challenger.observe_cap(zs_pp.merkle_tree.cap)
    alphas = challenger.get_n_challenges(nc)

    with timing.scope("quotient polys"):
        lookup_args = ()  # the draws and the LUT evaluations, where there are LUTs
        if deltas:
            lookup_args = (g.tensor(deltas, device), g.tensor(
                [[eval_lut_poly(common, k, deltas[NUM_COINS_LOOKUP * c:NUM_COINS_LOOKUP * (c + 1)])
                  for k in range(len(common.luts))] for c in range(nc)],
                device).reshape(nc, len(common.luts)))
        quotient_chunks = compute_quotient_polys(
            prover_data, common, constants_sigmas, wires, zs_pp, public_inputs_hash,
            betas, gammas, alphas, *lookup_args)
    with timing.scope("quotient commitment"):
        quotient = PolynomialBatch.from_coeffs(quotient_chunks, rate_bits, salts[2] is not None,
                                               cap_height, hasher=hasher, salt=salts[2])
    challenger.observe_cap(quotient.merkle_tree.cap)
    zeta = challenger.get_extension_challenge(2)
    if fs.ext_exp(zeta, common.degree) == fs.ext_one(2):
        raise ValueError("Opening point is in the subgroup.")

    with timing.scope("openings"):
        openings = opening_set(zeta, fs.primitive_root_of_unity(common.degree_bits),
                               constants_sigmas, wires, zs_pp, quotient, common)
    for batch in openings.to_fri_openings().batches:
        challenger.observe_extension_elements(batch.values)

    with timing.scope("FRI opening proof"):
        opening_proof = PolynomialBatch.prove_openings(
            common.get_fri_instance(zeta), [constants_sigmas, wires, zs_pp, quotient],
            challenger, common.fri_params, hasher)
    proof = Proof(wires_cap=wires.merkle_tree.cap,
                  plonk_zs_partial_products_cap=zs_pp.merkle_tree.cap,
                  quotient_polys_cap=quotient.merkle_tree.cap,
                  openings=openings, opening_proof=opening_proof)
    done = ProofWithPublicInputs(proof=proof, public_inputs=list(public_inputs))
    prover_data.cache(device)[_group_key("warm", group)] = True
    return (lambda: done) if _defer else done


# -- under a process group ------------------------------------------------------

def _check_group(common, group) -> None:
    """Under a group the circuit's n rows must split into the group's P
    parts (round 2's blocks, the LDE's parts)."""
    if group is not None:
        group.check_parts(common.degree, "rows")


def _constants_part(prover_data, common, group):
    """The rank's local form of the constants-sigmas batch: the one a build
    under a group of this rank and world left, or else sliced out of the
    batch committed whole on the group's device (built once a circuit, its
    local form once a rank and world); its collectives over `group`."""
    cache = prover_data.cache(group.device)
    key = ("constants_sigmas", group.rank, group.world)
    if key not in cache:
        with parallel.use_mesh(None):
            whole = prover_data.commitment(common, group.device)
        cache[key] = whole.part(group)
    return cache[key]


def _group_key(name: str, group):
    return name if group is None else (name, group.rank, group.world)


# -- round 2: the permutation argument's partial products and Zs ---------------

def _round2_tables(prover_data, common, device, group=None) -> dict:
    """Sigmas and the identity permutation's values k_i · g^j on `device`,
    once per circuit; under a group the rank's block of the points."""
    cache = prover_data.cache(device)
    key = _group_key("round2", group)
    if key not in cache:
        k_is = g.tensor(common.k_is[:common.config.num_routed_wires], device)
        subgroup = g.tensor(parallel.shard_lanes(prover_data.subgroup, group), device)
        cache[key] = {"sigmas": g.tensor(parallel.shard_lanes(prover_data.sigmas, group),
                                         device),
                      "s_id": g.mul(k_is[:, None], subgroup[None, :])}
    return cache[key]


def _chunk_products(x, qdf: int):
    """[R, n] -> [ceil(R / qdf), n]: products of qdf consecutive rows (the
    last chunk padded with ones)."""
    num_chunks = -(-x.shape[0] // qdf)
    pad = num_chunks * qdf - x.shape[0]
    if pad:
        x = torch.cat([x, torch.ones((pad, x.shape[1]), dtype=x.dtype, device=x.device)])
    chunks = x.reshape(num_chunks, qdf, x.shape[1])
    prod = chunks[:, 0]
    for j in range(1, qdf):
        prod = g.mul(prod, chunks[:, j])
    return prod


def _round2_one_challenge(wires_routed, sigmas, s_id, beta, gamma, qdf: int, group=None):
    """One challenge's Z [n] and partial products [num_chunks - 1, n].

    Per row the quotient of the identity and σ terms; their qdf-row chunk
    products; the inclusive prefix products of those down the chunks; and Z
    as the exclusive prefix product of the rows' totals over the points,
    Z(g^0) = 1 (the reference's sequential loop, plonk/prover.rs:365-449,
    as modular prefix-product scans). Under a group the inputs are the
    rank's block of the points, and so are Z and the partial products: Z's
    scan carries the lower ranks' products in (`g.cumprod_across`)."""
    numer = g.add(wires_routed, g.add(g.mul(beta, s_id), gamma))
    denom = g.add(wires_routed, g.add(g.mul(beta, sigmas), gamma))
    quot = g.mul(numer, g.inverse_rows(denom))
    cumprods = g.cumprod(_chunk_products(quot, qdf), 0)
    z_incl, carry = g.cumprod_across(cumprods[-1], group)
    z = g.exclusive_blocks(z_incl, carry)
    return z, g.mul(z[None, :], cumprods[:-1])


def all_partial_products_and_zs(wires_routed, prover_data, common, betas, gammas):
    """[num_challenges * (1 + num_partial_products), degree] values: every
    challenge's Z first, then each challenge's partial products. Under a
    group each rank computes its block of the points and the blocks are
    gathered, so the values are whole on every rank."""
    device = wires_routed.device
    group = parallel.active_mesh()
    t = _round2_tables(prover_data, common, device, group)
    wires_routed = parallel.shard_lanes(wires_routed, group)
    zs, pps = [], []
    for beta, gamma in zip(betas, gammas):
        z, pp = _round2_one_challenge(wires_routed, t["sigmas"], t["s_id"],
                                      g.scalar_tensor(beta, device),
                                      g.scalar_tensor(gamma, device),
                                      common.quotient_degree_factor, group)
        zs.append(z)
        pps.append(pp)
    return parallel.gather_lanes(torch.cat([torch.stack(zs)] + pps), group)


# -- round 3: the quotient polynomials -----------------------------------------

def _quotient_tables(prover_data, common, device, points) -> dict:
    """On the quotient domain's points x = shift · v^j (v of order
    Q = qdf · degree): Z_H(x)^-1 (period qdf), L_0(x) = Z_H(x) / (n (x - 1))
    and the identity permutation's values k_i · x, on `device`, once per
    circuit; under a group the rank's points (`points`, a
    `parallel.QuotientPoints`)."""
    cache = prover_data.cache(device)
    key = _group_key("quotient", points.group)
    if key not in cache:
        whole = _quotient_tables_whole(common, device)
        cache[key] = {name: points.table(t).contiguous() for name, t in whole.items()}
    return cache[key]


def _quotient_tables_whole(common, device) -> dict:
    qdf, n = common.quotient_degree_factor, common.degree
    lg_q = log2_strict(qdf) + common.degree_bits
    v = fs.primitive_root_of_unity(lg_q)
    shift = fs.MULTIPLICATIVE_GROUP_GENERATOR
    xs_np = (g.np_powers(v, 1 << lg_q).astype(object) * shift % fs.P).astype(np.uint64)
    u = fs.exp(v, n)  # of order qdf
    z_h_vals = [fs.sub(fs.mul(fs.exp(shift, n), fs.exp(u, j)), 1) for j in range(qdf)]
    xs = g.tensor(xs_np, device)
    z_h = g.tensor(np.tile(np.asarray(z_h_vals, dtype=np.uint64), n), device)
    z_h_inv = g.tensor(np.tile(np.asarray(fs.batch_inverse(z_h_vals), dtype=np.uint64), n),
                       device)
    den = g.mul_scalar(g.sub(xs, g.scalar_tensor(1, device)), n % fs.P)
    den_inv = g.inverse_vector(den)
    k_is = g.tensor(common.k_is[:common.config.num_routed_wires], device)
    return {"z_h_inv": z_h_inv, "l_0": g.mul(z_h, den_inv),
            "s_id": g.mul(k_is[:, None], xs[None, :])}


def _gate_constraints(common, wires_q, constants_q, public_inputs_hash):
    """public_inputs_hash: 4 host ints or a [4] tensor on the device.
    Σ over gates of filter · constraints, [num_gate_constraints, Q]: each
    gate's constraints times the product of (k - s) over the other gates
    k of its selector group s, and times (UNUSED_SELECTOR - s) where the
    circuit has several groups."""
    device = wires_q.device
    si = common.selectors_info
    gate_constants = constants_q[si.num_selectors + common.num_lookup_selectors:
                                 common.num_constants]
    pi = (public_inputs_hash if isinstance(public_inputs_hash, torch.Tensor)
          else g.tensor(public_inputs_hash, device))
    acc = torch.zeros((common.num_gate_constraints, wires_q.shape[-1]), dtype=torch.int64,
                      device=device)
    for i, gate in enumerate(common.gates):
        ev = gate.eval_unfiltered_device(wires_q, gate_constants, pi)
        if ev.shape[0] == 0:
            continue
        s = constants_q[si.selector_indices[i]]
        factors = [k for k in si.groups[si.selector_indices[i]] if k != i]
        if si.num_selectors > 1:
            factors.append(UNUSED_SELECTOR)
        filt = None
        for k in factors:
            f = g.sub(g.scalar_tensor(k, device), s)
            filt = f if filt is None else g.mul(filt, f)
        if filt is not None:
            ev = g.mul(filt[None, :], ev)
        acc[:ev.shape[0]] = g.add(acc[:ev.shape[0]], ev)
    return acc


def compute_quotient_polys(prover_data, common, constants_sigmas, wires, zs_pp,
                           public_inputs_hash, betas, gammas, alphas, deltas=None,
                           lut_re_evals=None):
    """The quotient chunks' coefficients [num_challenges · qdf, degree]:
    t_0 .. t_{qdf-1} of each challenge. The terms are, in order, each
    challenge's L_0 · (Z - 1), each challenge's partial-product checks, each
    challenge's lookup checks (with LUTs: `deltas` [4 · num_challenges] and
    `lut_re_evals` [num_challenges, num_luts] on the device), then the
    filtered gate constraints; challenge i reduces them by powers of α_i,
    divides by Z_H and takes the coset iFFT. Under a group the ranks that
    hold quotient points evaluate them (`parallel.QuotientPoints`: Z(g·x)
    and the lookup columns' next rows from the same rank or, where the
    next rows lie on another, one exchange), and the reduced values are
    gathered before the iFFT."""
    device = wires.device
    config = common.config
    qdf, n = common.quotient_degree_factor, common.degree
    nc = config.num_challenges
    points = parallel.QuotientPoints(parallel.active_mesh(), config.fri_config.rate_bits,
                                     log2_strict(qdf))
    # the Zs' and the lookup columns' values at g·x, in one exchange where
    # they lie on another rank (every rank takes part)
    zs, lk = common.zs_range(), common.lookup_range()
    zs_q = points.points(zs_pp)
    shifted = points.next_rows(torch.cat([zs_q[zs.start:zs.stop], zs_q[lk.start:lk.stop]]))
    vanishing = None
    if points.holds:
        vanishing = _vanishing_at_points(
            prover_data, common, points, constants_sigmas, wires, zs_q, shifted,
            public_inputs_hash, betas, gammas, alphas, deltas, lut_re_evals)
    quotient_values = points.gather(vanishing, (nc, (qdf * n) // points.holders))
    return ntt.coset_ifft(quotient_values).reshape(-1, n)


def _vanishing_at_points(prover_data, common, points, constants_sigmas, wires, zs_q, shifted,
                         public_inputs_hash, betas, gammas, alphas, deltas, lut_re_evals):
    """The α-reduced terms over Z_H at the rank's quotient points,
    [num_challenges, points]. zs_q: the Zs-partial-products batch at the
    points; shifted: its Zs, then its lookup columns, at the next rows."""
    device = wires.device
    config = common.config
    qdf = common.quotient_degree_factor
    num_routed, nc = config.num_routed_wires, config.num_challenges
    num_prods = common.num_partial_products
    t = _quotient_tables(prover_data, common, device, points)
    # natural-order LDEs at the quotient domain's points
    cs_q = points.points(constants_sigmas)
    wires_q = points.points(wires)
    zs, lk = common.zs_range(), common.lookup_range()

    z1_terms, pp_terms = [], []
    one = g.scalar_tensor(1, device)
    sigmas_q = cs_q[common.num_constants:common.num_constants + num_routed]
    wires_routed = wires_q[:num_routed]
    for i in range(nc):
        beta = g.scalar_tensor(betas[i], device)
        gamma = g.scalar_tensor(gammas[i], device)
        z_x = zs_q[zs[i]]
        z1_terms.append(g.mul(t["l_0"], g.sub(z_x, one))[None])
        num_prod = _chunk_products(g.add(wires_routed, g.add(g.mul(beta, t["s_id"]), gamma)),
                                   qdf)
        den_prod = _chunk_products(g.add(wires_routed, g.add(g.mul(beta, sigmas_q), gamma)),
                                   qdf)
        pp = common.partial_products_range()[i * num_prods:(i + 1) * num_prods]
        accs = torch.cat([z_x[None], zs_q[pp.start:pp.stop], shifted[i][None]])
        pp_terms.append(g.sub(g.mul(accs[1:], den_prod), g.mul(accs[:-1], num_prod)))
    lookup_terms = []
    if common.num_lookup_polys:
        num_sel, nlp = common.selectors_info.num_selectors, common.num_lookup_polys
        lookup_selectors = cs_q[num_sel:num_sel + common.num_lookup_selectors]
        d = deltas.reshape(nc, NUM_COINS_LOOKUP)
        for i in range(nc):
            local = zs_q[lk.start + nlp * i:lk.start + nlp * (i + 1)]
            lookup_terms.append(check_lookup_constraints_device(
                common, wires_q, lookup_selectors, local,
                shifted[len(zs) + nlp * i:len(zs) + nlp * (i + 1)], d[i], lut_re_evals[i]))
    all_terms = torch.cat(z1_terms + pp_terms + lookup_terms
                          + [_gate_constraints(common, wires_q, cs_q, public_inputs_hash)])
    del z1_terms, pp_terms, lookup_terms

    vanishing = torch.stack([
        g.sum_mod(g.mul(g.powers(a, all_terms.shape[0], device)[:, None],
                        all_terms), 0)
        for a in alphas])
    return g.mul(vanishing, t["z_h_inv"][None, :])


# -- openings --------------------------------------------------------------------

def _ext_list(e0, e1) -> list[tuple]:
    return [(int(a), int(b)) for a, b in zip(g.to_numpy(e0), g.to_numpy(e1))]


def opening_set(zeta, g_root, constants_sigmas, wires, zs_pp, quotient, common) -> OpeningSet:
    """Every committed polynomial at ζ, and the Zs and the lookup columns
    at g·ζ (reference plonk/proof.rs:314-351)."""
    oracles = (constants_sigmas, wires, zs_pp, quotient)
    at_zeta = _ext_list(*eval_polys_at(torch.cat([o.polynomials for o in oracles]), zeta))
    zs, lk = common.zs_range(), common.lookup_range()
    zeta_next = fs.ext_scalar_mul(g_root, zeta)
    at_next = _ext_list(*eval_polys_at(torch.cat([zs_pp.polynomials[zs.start:zs.stop],
                                                  zs_pp.polynomials[lk.start:lk.stop]]),
                                       zeta_next))
    off = np.cumsum([0] + [o.polynomials.shape[0] for o in oracles])
    cs_eval, wires_eval, zs_pp_eval, quotient_eval = (
        at_zeta[a:b] for a, b in zip(off[:-1], off[1:]))
    return OpeningSet(
        constants=[cs_eval[i] for i in common.constants_range()],
        plonk_sigmas=[cs_eval[i] for i in common.sigmas_range()],
        wires=wires_eval,
        plonk_zs=[zs_pp_eval[i] for i in zs],
        plonk_zs_next=at_next[:len(zs)],
        partial_products=[zs_pp_eval[i] for i in common.partial_products_range()],
        quotient_polys=quotient_eval,
        lookup_zs=[zs_pp_eval[i] for i in lk],
        lookup_zs_next=at_next[len(zs):],
    )


# -- the fused path: the transcript on the device -------------------------------

def _openings_final(sponge, zdraw, cs, wires, zs_pp, quot, num_challenges: int,
                    degree_bits: int, rate_bits: int, n_zpp: int | None = None):
    """The opening argument's transcript segment on the device (reference
    `_openings_final_fn`): every committed polynomial (coefficients [rows,
    n] of the four oracles) at ζ = zdraw and the Zs-partial-products oracle
    at g·ζ; the openings observed in the FRI-openings order (batch 0: every
    polynomial at ζ, the lookup columns (the Zs-partial-products oracle's
    rows from `n_zpp` on) after the quotient; batch 1: the Zs, then the
    lookup columns, at g·ζ; c0 then c1 of each); the FRI α drawn; and the
    FRI final polynomial, Σ over the two batches of α^(batch size)-shifted
    batch quotients. Returns (openings [2, cs + wires + 2 zs + quot] laid
    out [cs@ζ | wires@ζ | zs@ζ | zs@gζ | quot@ζ], [ζ0, ζ1, gζ0, gζ1], final
    c0, final c1, sponge state)."""
    z = (zdraw[0], zdraw[1])
    g_root = fs.primitive_root_of_unity(degree_bits)
    gz = (g.mul_scalar(z[0], g_root), g.mul_scalar(z[1], g_root))
    all_polys = torch.cat([cs, wires, zs_pp, quot])
    at_z = eval_polys_at(all_polys, z)
    at_gz = eval_polys_at(zs_pp, gz)
    n_z = zs_pp.shape[0]
    o = cs.shape[0] + wires.shape[0] + n_z
    packed = torch.stack([torch.cat([at_z[i][:o], at_gz[i], at_z[i][o:]]) for i in (0, 1)])

    n_zpp = n_z if n_zpp is None else n_zpp
    batch0, batch1 = all_polys, zs_pp[:num_challenges]
    obs0, obs1 = torch.stack(at_z, dim=-1), torch.stack(at_gz, dim=-1)[:num_challenges]
    if n_zpp < n_z:  # the lookup columns: after the quotient at ζ, after the Zs at g·ζ
        lookup = zs_pp[n_zpp:]
        batch0 = torch.cat([all_polys[:o - n_z + n_zpp], quot, lookup])
        batch1 = torch.cat([batch1, lookup])
        obs0 = torch.cat([obs0[:o - n_z + n_zpp], obs0[o:], obs0[o - n_z + n_zpp:o]])
        obs1 = torch.cat([obs1, torch.stack(at_gz, dim=-1)[n_zpp:]])
    dc = DeviceChallenger(sponge)
    dc.observe_elements(obs0)
    dc.observe_elements(obs1)
    alpha = (dc.get_challenge(), dc.get_challenge())

    n = cs.shape[-1]
    final = (torch.zeros(n, dtype=torch.int64, device=cs.device),
             torch.zeros(n, dtype=torch.int64, device=cs.device))
    for point, polys in ((z, batch0), (gz, batch1)):
        q = _batch_quotient(polys, alpha, point, rate_bits)
        shift = g.ext2_pow_static(alpha, polys.shape[0])
        final = g.ext2_add(g.ext2_mul(shift, final), q)
    zz = torch.stack([z[0], z[1], gz[0], gz[1]])
    return packed, zz, final[0], final[1], dc.state


def _prove_fused(prover_data, common, constants_sigmas, wires, witness_dev, transcript,
                 public_inputs, pi_hash_dev, timing, defer: bool, salts):
    """The prove on the device transcript (reference `_prove_fused`): after
    the host-observed prefix, each cap is absorbed and its challenges drawn
    on the device (`cap_boundary`), the openings and the FRI argument follow
    (`_openings_final`, `fri.prover._fri_proof_fused`), and the caps,
    openings, ζ and the FRI proof come back in one fetch in `finish()`."""
    config = common.config
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    nc = config.num_challenges
    C = 1 << cap_height
    sponge, pending = transcript
    no_pending = sponge.new_empty((0,))

    lookups = bool(common.num_lookup_polys)
    sponge, _, draws, cap_w = cap_boundary(
        sponge, pending, int(pending.shape[0]), wires.merkle_tree.cap_dev, cap_height, True,
        (NUM_COINS_LOOKUP if lookups else 2) * nc)
    betas, gammas = draws[:nc], draws[nc:2 * nc]
    with timing.scope("partial products and Zs"):
        zs_pp_values = all_partial_products_and_zs(
            witness_dev[:config.num_routed_wires], prover_data, common, betas, gammas)
    if lookups:  # the deltas are the whole draw stream
        with timing.scope("compute lookup polys"):
            zs_pp_values = torch.cat([zs_pp_values, lookup_polys_device(
                witness_dev, draws, prover_data, common)])
    with timing.scope("zs_partial_products commitment"):
        zs_pp = PolynomialBatch.from_values(zs_pp_values, rate_bits, salts[1] is not None,
                                            cap_height, salt=salts[1])
    sponge, _, alphas, cap_z = cap_boundary(sponge, no_pending, 0, zs_pp.merkle_tree.cap_dev,
                                            cap_height, True, nc)
    with timing.scope("quotient polys"):
        lookup_args = (draws, lut_evals_device(common, draws, draws.device)) if lookups else ()
        quotient_chunks = compute_quotient_polys(
            prover_data, common, constants_sigmas, wires, zs_pp, pi_hash_dev,
            betas, gammas, alphas, *lookup_args)
    with timing.scope("quotient commitment"):
        quotient = PolynomialBatch.from_coeffs(quotient_chunks, rate_bits, salts[2] is not None,
                                               cap_height, salt=salts[2])
    sponge, _, zdraw, cap_q = cap_boundary(sponge, no_pending, 0,
                                           quotient.merkle_tree.cap_dev, cap_height, True, 2)

    oracles = (constants_sigmas, wires, zs_pp, quotient)
    n_cs, n_w, n_z, n_q = (int(o.polynomials.shape[0]) for o in oracles)
    total = n_cs + n_w + 2 * n_z + n_q
    with timing.scope("openings + final poly"):
        packed, zz, f0, f1, sponge = _openings_final(
            sponge, zdraw, *(o.polynomials for o in oracles), nc, common.degree_bits,
            rate_bits, *((common.num_zs_partial_products_polys(),) if lookups else ()))
    extra = torch.cat([cap_w.reshape(-1), cap_z.reshape(-1), cap_q.reshape(-1),
                       packed.reshape(-1), zz])
    with timing.scope("FRI dispatch" if defer else "FRI opening proof"):
        fri_out = fri_prover._fri_proof_fused(
            [o.merkle_tree for o in oracles], (f0, f1), None, common.fri_params,
            device_state=(sponge, no_pending), extra_payload=extra, timing=timing,
            defer=defer)

    def finish() -> ProofWithPublicInputs:
        opening_proof, flat = fri_out() if defer else fri_out
        caps, pos = [], 0
        for _ in range(3):
            caps.append([[int(v) for v in flat[pos + 4 * r:pos + 4 * (r + 1)]]
                         for r in range(C)])
            pos += 4 * C
        packed_h = flat[pos:pos + 2 * total].reshape(2, total)
        pos += 2 * total
        zeta = (int(flat[pos]), int(flat[pos + 1]))
        # the reference checks ζ before the openings; ζ is fixed by the
        # transcript, so checking it after the fetch refuses the same proofs
        if fs.ext_exp(zeta, common.degree) == fs.ext_one(2):
            raise ValueError("Opening point is in the subgroup.")
        off = np.cumsum([0, n_cs, n_w, n_z, n_z, n_q])
        cs_eval, wires_eval, zs_pp_eval, zs_pp_next_eval, quotient_eval = (
            [(int(a), int(b)) for a, b in zip(packed_h[0, s:e], packed_h[1, s:e])]
            for s, e in zip(off[:-1], off[1:]))
        openings = OpeningSet(
            constants=[cs_eval[i] for i in common.constants_range()],
            plonk_sigmas=[cs_eval[i] for i in common.sigmas_range()],
            wires=wires_eval,
            plonk_zs=[zs_pp_eval[i] for i in common.zs_range()],
            plonk_zs_next=[zs_pp_next_eval[i] for i in common.zs_range()],
            partial_products=[zs_pp_eval[i] for i in common.partial_products_range()],
            quotient_polys=quotient_eval,
            lookup_zs=[zs_pp_eval[i] for i in common.lookup_range()],
            lookup_zs_next=[zs_pp_next_eval[i] for i in common.lookup_range()],
        )
        proof = Proof(wires_cap=caps[0], plonk_zs_partial_products_cap=caps[1],
                      quotient_polys_cap=caps[2], openings=openings,
                      opening_proof=opening_proof)
        return ProofWithPublicInputs(proof=proof, public_inputs=list(public_inputs))

    return finish if defer else finish()


# -- batched proving -------------------------------------------------------------

def _prove_on_slots(prover_data, common, todo, prepare, device, group, window: int,
                    threads: int, in_flight, timing) -> list:
    """`prove_many`'s dispatch threads: proof i (of `todo`, (i, inputs)
    pairs in order) is proved whole by slot i mod threads, a thread with
    its own stream and, under a group, its own communicator, which takes
    its proofs in order from a queue; the caller's thread prepares the
    witnesses in order and, with `window` proofs in flight, waits for the
    oldest. Returns the proofs in order."""
    import queue
    from concurrent.futures import Future

    slots = group.slots(threads) if group is not None else [None] * threads
    queues = [queue.Queue() for _ in range(threads)]

    def run(slot, jobs):
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        with parallel.use_mesh(slot):
            while True:
                job = jobs.get()
                if job is None:
                    return
                prepared, future = job
                if not future.set_running_or_notify_cancel():
                    continue
                try:
                    with (torch.cuda.stream(stream) if stream is not None
                          else contextlib.nullcontext()), in_flight:
                        future.set_result(prove(prover_data, common, None, device,
                                                _prepared=prepared))
                except BaseException as e:  # noqa: BLE001 - handed to the caller
                    future.set_exception(e)

    workers = [threading.Thread(target=run, args=(slot, jobs), daemon=True)
               for slot, jobs in zip(slots, queues)]
    for w in workers:
        w.start()
    out, futures = [], collections.deque()
    try:
        for i, inputs in todo:
            future = Future()
            queues[i % threads].put((prepare(i, inputs), future))
            futures.append(future)
            while len(futures) >= window:
                with timing.scope(f"finish proof {len(out)}"):
                    out.append(futures.popleft().result())
        while futures:
            with timing.scope(f"finish proof {len(out)}"):
                out.append(futures.popleft().result())
    finally:
        for jobs in queues:
            jobs.put(None)
        for w in workers:
            w.join()
    return out


class _InFlight:
    """Counts the proofs whose device chain is queued and not yet fetched."""

    def __init__(self):
        self.lock = threading.Lock()
        self.now = 0
        self.most = 0

    def enter(self):
        with self.lock:
            self.now += 1
            self.most = max(self.most, self.now)

    def leave(self):
        with self.lock:
            self.now -= 1

    def __enter__(self):
        self.enter()

    def __exit__(self, *exc):
        self.leave()


def prove_many(prover_data, common, inputs_list, device=None,
               timing: TimingTree | None = None, window: int = 3,
               threads: int = 1) -> list[ProofWithPublicInputs]:
    """Prove many PartialWitnesses of one circuit (reference
    plonk/prover.py:1245), the proofs byte-identical to sequential `prove`
    calls: every witness phase (all of a non-zk proof's rng draws) runs on
    the caller's thread in proof order, and at most `window` proofs are in
    flight, each holding its oracles on the device. A zk proof also draws
    its salts when its prove is dispatched, so under zero knowledge the
    single-stream pipeline runs whatever `threads` says, as in the
    reference (plonk/prover.py:1258-1273); `_LAST_PROVE_MANY_MODE` records
    the pipeline taken.

    threads == 1 (the default): each proof's chain is queued as
    `prove(_defer=True)` on a CUDA stream of a pool of `window`, and the
    oldest proof is fetched once `window` are queued, so the next witness
    phase overlaps the device work. threads >= 2: proof i runs whole on
    dispatch slot i mod threads, a thread with its own stream that runs its
    proofs in order; the threads contend for the GIL over ~10^5 launches a
    proof, and on one H100 two and three gave fewer proofs/s than one
    (chip_smoke's prove_many line, PERF.md). Until a prove of the circuit
    has completed on the device (its per-device cache's "warm", under a
    group its rank's and world's), the first proof runs alone on the
    caller's stream, so the per-circuit tables (and the allocator's
    blocks) exist before other streams read them. `_LAST_MAX_IN_FLIGHT`
    holds the most proofs in flight.

    Under a process group every rank issues the same collectives in the
    same order on each communicator: with one thread the caller's thread
    dispatches the proofs in order; with dispatch threads each slot proves
    under its own communicator (`parallel.Group.slots`, made and started
    in slot order before the threads), so a communicator's collectives are
    its slot's proofs' in proof order on every rank. That holds over gloo.
    Over NCCL with more than one rank, dispatch threads raise ValueError:
    there the slots' communicators deadlocked against each other (ranks
    waiting in different communicators' all-reduces until their 120 s
    timeout, in chip_smoke.py's `--phases multigpu --world 3` case
    "prove_many threads 2" on H100s), as NCCL documents for collectives
    issued on several communicators from several threads."""
    global _LAST_MAX_IN_FLIGHT, _LAST_PROVE_MANY_MODE
    group, device = parallel.placement(device)
    _check_group(common, group)
    if window < 1 or threads < 1:
        raise ValueError("window and threads must be at least 1")
    if common.config.zero_knowledge:
        threads = 1
    if group is not None and threads > 1 and group.world > 1 and device.type == "cuda":
        raise ValueError(f"prove_many under an NCCL group of {group.world} ranks takes "
                         f"threads=1, not {threads}: its dispatch slots deadlocked across "
                         "their communicators on H100s (chip_smoke.py --phases multigpu "
                         "--world 3, case 'prove_many threads 2')")
    _LAST_PROVE_MANY_MODE = "single-stream" if threads == 1 else "threads"
    timing = timing or TimingTree("prove_many")
    cuda = device.type == "cuda"
    cache = prover_data.cache(device)
    in_flight = _InFlight()
    out: list = []
    todo = list(enumerate(inputs_list))

    def prepare(i, inputs):
        with timing.scope(f"witness {i}"):
            return prepare_witness(prover_data, common, inputs)

    def on(stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    if cuda and not cache.get(_group_key("warm", group)) and todo:
        i, inputs = todo.pop(0)
        prepared = prepare(i, inputs)
        with timing.scope(f"dispatch proof {i}"), in_flight:
            out.append(prove(prover_data, common, None, device, _prepared=prepared))

    if threads == 1:
        streams = [torch.cuda.Stream(device) for _ in range(window)] if cuda else [None] * window
        pending = collections.deque()

        def finish_oldest():
            stream, finish = pending.popleft()
            with timing.scope(f"finish proof {len(out)}"), on(stream):
                out.append(finish())
            in_flight.leave()

        for i, inputs in todo:
            prepared = prepare(i, inputs)
            stream = streams[i % window]
            with timing.scope(f"dispatch proof {i}"), on(stream):
                in_flight.enter()
                pending.append((stream, prove(prover_data, common, None, device,
                                              _defer=True, _prepared=prepared)))
            while len(pending) >= window:
                finish_oldest()
        while pending:
            finish_oldest()
    else:
        out += _prove_on_slots(prover_data, common, todo, prepare, device, group, window,
                               threads, in_flight, timing)
    _LAST_MAX_IN_FLIGHT = in_flight.most
    return out
