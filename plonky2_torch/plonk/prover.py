"""PLONK prover on the host-transcript path (reference plonk/prover.py:405-556,
plonk/prover.rs:113-815), for non-zk circuits without lookups under
`PoseidonGoldilocksConfig`.

The Fiat-Shamir transcript runs on the host; every round runs on tensors of
one device:

  wires commitment        iFFT, coset LDE, Merkle tree   (fri/oracle.py: K2, K4)
  partial products, Zs    batch inverses and modular prefix-product scans
  quotient polynomials    every gate's constraints over the 2^(degree bits +
                          log qdf)-point coset, filtered, α-reduced, divided by
                          Z_H, then one coset iFFT (K3) into qdf chunks per
                          challenge
  openings, FRI           fri/oracle.py, fri/prover.py (K2, K3, K4, K5)

The field work between the kernels is plain PyTorch on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch import resolve_device
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.oracle import PolynomialBatch, eval_polys_at
from plonky2_torch.gates.gate import UNUSED_SELECTOR
from plonky2_torch.hash import poseidon as ps
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.plonk.proof import OpeningSet, Proof, ProofWithPublicInputs
from plonky2_torch.util import TimingTree, log2_strict


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


def prove(prover_data, common, witness, public_inputs, public_inputs_hash, device=None,
          timing: TimingTree | None = None) -> ProofWithPublicInputs:
    """Prove `common`'s circuit on `witness` ([num_wires, degree] u64 values,
    as the reference's `prepare_witness` returns it) on `device` (CUDA
    unless the caller asks for another)."""
    device = resolve_device(device)
    if common.config.zero_knowledge:
        raise NotImplementedError("zero-knowledge circuits are not ported (ROADMAP item 10)")
    if common.num_lookup_polys:
        raise NotImplementedError("circuits with lookups are not ported (ROADMAP item 9)")
    timing = timing or TimingTree("prove")
    config = common.config
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    nc = config.num_challenges

    def commit_values(values):
        return PolynomialBatch.from_values(values, rate_bits, False, cap_height)

    constants_sigmas = prover_data.commitment(common, device)
    with timing.scope("wires commitment"):
        witness_dev = g.tensor(witness, device)
        wires = commit_values(witness_dev)

    challenger = Challenger()
    common.fri_params.observe(challenger)
    challenger.observe_hash(prover_data.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires.merkle_tree.cap)
    betas = challenger.get_n_challenges(nc)
    gammas = challenger.get_n_challenges(nc)

    with timing.scope("partial products and Zs"):
        zs_pp_values = all_partial_products_and_zs(
            witness_dev[:config.num_routed_wires], prover_data, common, betas, gammas)
    del witness_dev
    with timing.scope("zs_partial_products commitment"):
        zs_pp = commit_values(zs_pp_values)
    challenger.observe_cap(zs_pp.merkle_tree.cap)
    alphas = challenger.get_n_challenges(nc)

    with timing.scope("quotient polys"):
        quotient_chunks = compute_quotient_polys(
            prover_data, common, constants_sigmas, wires, zs_pp, public_inputs_hash,
            betas, gammas, alphas)
    with timing.scope("quotient commitment"):
        quotient = PolynomialBatch.from_coeffs(quotient_chunks, rate_bits, False, cap_height)
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
            challenger, common.fri_params)
    proof = Proof(wires_cap=wires.merkle_tree.cap,
                  plonk_zs_partial_products_cap=zs_pp.merkle_tree.cap,
                  quotient_polys_cap=quotient.merkle_tree.cap,
                  openings=openings, opening_proof=opening_proof)
    return ProofWithPublicInputs(proof=proof, public_inputs=list(public_inputs))


# -- round 2: the permutation argument's partial products and Zs ---------------

def _round2_tables(prover_data, common, device) -> dict:
    """Sigmas and the identity permutation's values k_i · g^j on `device`,
    once per circuit."""
    cache = prover_data.cache(device)
    if "round2" not in cache:
        k_is = g.tensor(common.k_is[:common.config.num_routed_wires], device)
        subgroup = g.tensor(prover_data.subgroup, device)
        cache["round2"] = {"sigmas": g.tensor(prover_data.sigmas, device),
                           "s_id": g.mul(k_is[:, None], subgroup[None, :])}
    return cache["round2"]


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


def _round2_one_challenge(wires_routed, sigmas, s_id, beta, gamma, qdf: int):
    """One challenge's Z [n] and partial products [num_chunks - 1, n].

    Per row the quotient of the identity and σ terms; their qdf-row chunk
    products; the inclusive prefix products of those down the chunks; and Z
    as the exclusive prefix product of the rows' totals over the points,
    Z(g^0) = 1 (the reference's sequential loop, plonk/prover.rs:365-449,
    as modular prefix-product scans)."""
    numer = g.add(wires_routed, g.add(g.mul(beta, s_id), gamma))
    denom = g.add(wires_routed, g.add(g.mul(beta, sigmas), gamma))
    quot = g.mul(numer, g.inverse_rows(denom))
    cumprods = g.cumprod(_chunk_products(quot, qdf), 0)
    z_incl = g.cumprod(cumprods[-1], 0)
    z = torch.cat([torch.ones_like(z_incl[:1]), z_incl[:-1]])
    return z, g.mul(z[None, :], cumprods[:-1])


def all_partial_products_and_zs(wires_routed, prover_data, common, betas, gammas):
    """[num_challenges * (1 + num_partial_products), degree] values: every
    challenge's Z first, then each challenge's partial products."""
    device = wires_routed.device
    t = _round2_tables(prover_data, common, device)
    zs, pps = [], []
    for beta, gamma in zip(betas, gammas):
        z, pp = _round2_one_challenge(wires_routed, t["sigmas"], t["s_id"],
                                      g.scalar_tensor(beta, device),
                                      g.scalar_tensor(gamma, device),
                                      common.quotient_degree_factor)
        zs.append(z)
        pps.append(pp)
    return torch.cat([torch.stack(zs)] + pps)


# -- round 3: the quotient polynomials -----------------------------------------

def _quotient_tables(prover_data, common, device) -> dict:
    """On the quotient domain's points x = shift · v^j (v of order
    Q = qdf · degree): Z_H(x)^-1 (period qdf), L_0(x) = Z_H(x) / (n (x - 1))
    and the identity permutation's values k_i · x, on `device`, once per
    circuit."""
    cache = prover_data.cache(device)
    if "quotient" in cache:
        return cache["quotient"]
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
    split = 1 << (lg_q // 2)  # batch-inverse [split, Q / split] along its rows
    den_inv = g.inverse_rows(den.reshape(split, -1)).reshape(-1)
    k_is = g.tensor(common.k_is[:common.config.num_routed_wires], device)
    cache["quotient"] = {"z_h_inv": z_h_inv, "l_0": g.mul(z_h, den_inv),
                         "s_id": g.mul(k_is[:, None], xs[None, :])}
    return cache["quotient"]


def _gate_constraints(common, wires_q, constants_q, public_inputs_hash):
    """Σ over gates of filter · constraints, [num_gate_constraints, Q]: each
    gate's constraints times the product of (k - s) over the other gates
    k of its selector group s, and times (UNUSED_SELECTOR - s) where the
    circuit has several groups."""
    device = wires_q.device
    si = common.selectors_info
    gate_constants = constants_q[si.num_selectors + common.num_lookup_selectors:
                                 common.num_constants]
    pi = g.tensor(public_inputs_hash, device)
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
                           public_inputs_hash, betas, gammas, alphas):
    """The quotient chunks' coefficients [num_challenges · qdf, degree]:
    t_0 .. t_{qdf-1} of each challenge. The terms are, in order, each
    challenge's L_0 · (Z - 1), each challenge's partial-product checks, then
    the filtered gate constraints; challenge i reduces them by powers of
    α_i, divides by Z_H and takes the coset iFFT."""
    device = wires.device
    config = common.config
    qdf, n = common.quotient_degree_factor, common.degree
    num_routed, nc = config.num_routed_wires, config.num_challenges
    num_prods = common.num_partial_products
    step = 1 << (config.fri_config.rate_bits - log2_strict(qdf))
    t = _quotient_tables(prover_data, common, device)
    # natural-order LDEs, subsampled to the Q-point quotient domain
    cs_q = constants_sigmas.lde[:, ::step]
    wires_q = wires.lde[:, ::step]
    zs_q = zs_pp.lde[:, ::step]

    z1_terms, pp_terms = [], []
    one = g.scalar_tensor(1, device)
    sigmas_q = cs_q[common.num_constants:common.num_constants + num_routed]
    wires_routed = wires_q[:num_routed]
    for i in range(nc):
        beta = g.scalar_tensor(betas[i], device)
        gamma = g.scalar_tensor(gammas[i], device)
        z_x = zs_q[common.zs_range()[i]]
        z_gx = torch.roll(z_x, -qdf)  # Z(g·x): g is qdf steps of the Q-point coset
        z1_terms.append(g.mul(t["l_0"], g.sub(z_x, one))[None])
        num_prod = _chunk_products(g.add(wires_routed, g.add(g.mul(beta, t["s_id"]), gamma)),
                                   qdf)
        den_prod = _chunk_products(g.add(wires_routed, g.add(g.mul(beta, sigmas_q), gamma)),
                                   qdf)
        pp = common.partial_products_range()[i * num_prods:(i + 1) * num_prods]
        accs = torch.cat([z_x[None], zs_q[pp.start:pp.stop], z_gx[None]])
        pp_terms.append(g.sub(g.mul(accs[1:], den_prod), g.mul(accs[:-1], num_prod)))
    all_terms = torch.cat(z1_terms + pp_terms
                          + [_gate_constraints(common, wires_q, cs_q, public_inputs_hash)])
    del z1_terms, pp_terms

    vanishing = torch.stack([
        g.sum_mod(g.mul(g.powers(g.scalar_tensor(a, device), all_terms.shape[0])[:, None],
                        all_terms), 0)
        for a in alphas])
    quotient_values = g.mul(vanishing, t["z_h_inv"][None, :])
    return ntt.coset_ifft(quotient_values).reshape(-1, n)


# -- openings --------------------------------------------------------------------

def _ext_list(e0, e1) -> list[tuple]:
    return [(int(a), int(b)) for a, b in zip(g.to_numpy(e0), g.to_numpy(e1))]


def opening_set(zeta, g_root, constants_sigmas, wires, zs_pp, quotient, common) -> OpeningSet:
    """Every committed polynomial at ζ, and the Zs at g·ζ
    (reference plonk/proof.rs:314-351)."""
    oracles = (constants_sigmas, wires, zs_pp, quotient)
    at_zeta = _ext_list(*eval_polys_at(torch.cat([o.polynomials for o in oracles]), zeta))
    zs = common.zs_range()
    zeta_next = fs.ext_scalar_mul(g_root, zeta)
    at_next = _ext_list(*eval_polys_at(zs_pp.polynomials[zs.start:zs.stop], zeta_next))
    off = np.cumsum([0] + [o.polynomials.shape[0] for o in oracles])
    cs_eval, wires_eval, zs_pp_eval, quotient_eval = (
        at_zeta[a:b] for a, b in zip(off[:-1], off[1:]))
    return OpeningSet(
        constants=[cs_eval[i] for i in common.constants_range()],
        plonk_sigmas=[cs_eval[i] for i in common.sigmas_range()],
        wires=wires_eval,
        plonk_zs=[zs_pp_eval[i] for i in zs],
        plonk_zs_next=at_next,
        partial_products=[zs_pp_eval[i] for i in common.partial_products_range()],
        quotient_polys=quotient_eval,
    )
