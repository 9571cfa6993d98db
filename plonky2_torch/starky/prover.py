"""The STARK prover (reference starky/src/prover.rs:40-470; the reference
package's starky/prover.py).

Every round runs on tensors of one device (CUDA unless the caller asks for
another):

  compute trace commitment      iFFT, ×2^rate coset LDE, Merkle tree (K2/K3, K4)
  auxiliary commitment          logUp helper and Z columns (batch inverses, a
                                modular prefix sum), then a multi-table
                                proof's CTL helper and Z columns
                                (cross_table_lookup.py), then as above
  compute quotient polys        every constraint over the 2^(degree bits +
                                qd bits)-point coset (`TorchBaseOps`),
                                α-combined, times Z_H^-1, one coset iFFT (K3)
  compute quotient commitment   coset LDE and Merkle tree
  openings, FRI opening proof   fri/oracle.py, fri/prover.py (K2-K5)

The transcript is the host `Challenger` up to FRI; the FRI argument takes
the port's fused device transcript whenever it has a fold step under
Poseidon, and the host one otherwise (no fold step, or `KeccakHasher`,
whose trees are hashed on the host), with the same bytes. The prover draws no randomness.

Under a process group (`plonky2_torch.parallel.use_mesh`) the trace,
auxiliary and quotient batches are committed in the group's layout (each
rank its parts of the LDE and their part of the tree; under Keccak their
subtrees, hashed on its host) and the ranks holding quotient points
evaluate them; the logUp and CTL columns, the openings, FRI and the
transcript are whole on every rank, and every rank's proof is the single
device's.
"""

from __future__ import annotations

import functools

import torch

from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.oracle import PolynomialBatch, _as_tensor, eval_polys_at
from plonky2_torch.gates.ops import TorchBaseOps
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.starky.constraint_consumer import ConstraintConsumer
from plonky2_torch.starky.cross_table_lookup import CtlCheckVars, get_ctl_auxiliary_polys
from plonky2_torch.starky.evaluation_frame import StarkFrame
from plonky2_torch.starky.get_challenges import bind_constraints, unified_shape
from plonky2_torch.starky.lookup import (
    LookupCheckVars,
    get_grand_product_challenge_set,
    lookup_helper_columns,
)
from plonky2_torch.starky.proof import StarkOpeningSet, StarkProof, StarkProofWithPublicInputs
from plonky2_torch.starky.vanishing import eval_vanishing_poly
from plonky2_torch.util import TimingTree, log2_strict


def prove(stark, config, trace_poly_values, public_inputs, device=None,
          timing: TimingTree | None = None,
          verifier_circuit_fri_params=None, hasher=None) -> StarkProofWithPublicInputs:
    """Prove that `trace_poly_values` ([COLUMNS, n] u64 values, or that
    matrix as an int64 tensor already on `device`) satisfies `stark` with
    `public_inputs`, on `device` (CUDA unless the caller asks for another).
    verifier_circuit_fri_params: the FRI params of the largest degree that
    a variable-degree recursion circuit verifies; the FRI transcript then
    takes their shape (`fri.prover.fri_proof`). hasher: the commitments'
    and the transcript's (Poseidon by default); under `KeccakHasher` the
    trees are hashed on the host and FRI takes the host path. Under a
    process group it runs on the group's device over the group."""
    device = parallel.placement(device)[1]
    timing = timing or TimingTree("starky prove")
    trace = _as_tensor(trace_poly_values, device)
    degree_bits = log2_strict(trace.shape[-1])
    fri_params = config.fri_params(degree_bits)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    if fri_params.total_arities() > degree_bits + rate_bits - cap_height:
        raise ValueError("the FRI arities fold below the Merkle cap")

    with timing.scope("compute trace commitment"):
        trace_commitment = PolynomialBatch.from_values(trace, rate_bits, False, cap_height,
                                                       hasher=hasher)

    challenger = Challenger(hasher)
    challenger.observe_elements(public_inputs)
    config.observe(challenger)
    challenger.observe_cap(trace_commitment.merkle_tree.cap)

    return prove_with_commitment(stark, config, trace, trace_commitment, challenger,
                                 public_inputs, timing,
                                 verifier_circuit_fri_params=verifier_circuit_fri_params,
                                 hasher=hasher)


def prove_with_commitment(stark, config, trace, trace_commitment, challenger,
                          public_inputs, timing: TimingTree | None = None,
                          ctl_data=None, ctl_challenges=None,
                          verifier_circuit_fri_params=None,
                          hasher=None) -> StarkProofWithPublicInputs:
    """The rounds after the trace commitment. trace: [COLUMNS, n] int64
    tensor on the commitment's device; the challenger has observed the
    public inputs, the config and the trace cap. A table of a multi-table
    proof passes its CtlData (`cross_table_lookup.get_ctl_data`, columns on
    the trace's device) and the CTL challenges, which are then its logUp
    challenges too (reference prover.py:97-98)."""
    timing = timing or TimingTree("starky prove")
    degree = trace.shape[-1]
    degree_bits = log2_strict(degree)
    fri_params = config.fri_params(degree_bits)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    constraint_degree = stark.constraint_degree()
    if constraint_degree > (1 << rate_bits) + 1:
        raise ValueError("The degree of the Stark constraints must be <= blowup_factor + 1")

    lookup_challenges = None
    auxiliary_polys_commitment = None
    num_auxiliary_polys = 0
    if stark.uses_lookups():
        challenge_set = ctl_challenges
        if challenge_set is None:
            challenge_set = get_grand_product_challenge_set(challenger, config.num_challenges)
        lookup_challenges = [ch.beta for ch in challenge_set.challenges]
    if stark.uses_lookups() or ctl_data is not None:
        # the helper columns are made inside the commitment's scope, so the
        # scopes cover the whole prove; the CTL columns come after logUp's
        with timing.scope("compute auxiliary polynomials commitment"):
            aux_cols = [col for lookup in stark.lookups()
                        for challenge in (lookup_challenges or [])
                        for col in lookup_helper_columns(lookup, trace, challenge,
                                                         constraint_degree)]
            if ctl_data is not None:
                aux_cols += get_ctl_auxiliary_polys(ctl_data)
            num_auxiliary_polys = len(aux_cols)
            if aux_cols:
                auxiliary_polys_commitment = PolynomialBatch.from_values(
                    torch.stack(aux_cols), rate_bits, False, cap_height, hasher=hasher)
        if auxiliary_polys_commitment is not None:
            challenger.observe_cap(auxiliary_polys_commitment.merkle_tree.cap)

    num_ctl_polys = ctl_data.num_ctl_helper_polys() if ctl_data is not None else []
    alphas = bind_constraints(challenger, stark, config, public_inputs, degree_bits,
                              num_auxiliary_polys, lookup_challenges,
                              None if ctl_data is None else ctl_data.zs_columns, num_ctl_polys)

    with timing.scope("compute quotient polys"):
        quotient_chunks = compute_quotient_polys(
            stark, config, trace_commitment, public_inputs, alphas, degree_bits,
            auxiliary_polys_commitment, lookup_challenges, ctl_data)

    with timing.scope("compute quotient commitment"):
        quotient_commitment = PolynomialBatch.from_coeffs(quotient_chunks, rate_bits, False,
                                                          cap_height, hasher=hasher)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    zeta = challenger.get_extension_challenge(2)
    if fs.ext_exp(zeta, degree) == fs.ext_one(2):
        raise ValueError("Opening point is in the subgroup.")

    g_root = fs.primitive_root_of_unity(degree_bits)
    num_ctl_zs = [0] * len(ctl_data.zs_columns) if ctl_data is not None else []
    with timing.scope("openings"):
        openings = opening_set(
            zeta, g_root, trace_commitment, quotient_commitment, auxiliary_polys_commitment,
            ctl_zs_start=(None if ctl_data is None or auxiliary_polys_commitment is None
                          else stark.num_lookup_helper_columns(config) + sum(num_ctl_polys)))
    for batch in openings.to_fri_openings().batches:
        challenger.observe_extension_elements(batch.values)

    instance = stark.fri_instance(zeta, g_root, sum(num_ctl_polys), num_ctl_zs, config)
    oracles = [trace_commitment]
    if auxiliary_polys_commitment is not None:
        oracles.append(auxiliary_polys_commitment)
    oracles.append(quotient_commitment)
    with timing.scope("FRI opening proof"):
        opening_proof = PolynomialBatch.prove_openings(
            instance, oracles, challenger, fri_params, hasher=hasher,
            **unified_shape(verifier_circuit_fri_params))

    proof = StarkProof(
        trace_cap=trace_commitment.merkle_tree.cap,
        auxiliary_polys_cap=(auxiliary_polys_commitment.merkle_tree.cap
                             if auxiliary_polys_commitment is not None else None),
        quotient_polys_cap=quotient_commitment.merkle_tree.cap,
        openings=openings,
        opening_proof=opening_proof,
    )
    return StarkProofWithPublicInputs(proof=proof, public_inputs=list(public_inputs))


# -- the quotient ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def quotient_tables(degree_bits: int, qd_bits: int, device: str) -> dict:
    """On the quotient coset's points x = shift · v^j (v of order
    Q = 2^(degree_bits + qd_bits)): Z_H(x)^-1 (period 2^qd_bits), the
    Lagrange selectors of the first and the last row LDE'd onto the coset,
    and x - g^-1; made once per shape and device."""
    n = 1 << degree_bits
    shift = fs.MULTIPLICATIVE_GROUP_GENERATOR
    v = fs.primitive_root_of_unity(qd_bits + degree_bits)
    xs = g.mul_scalar(g.powers(v, n << qd_bits, device), shift)
    u = fs.exp(v, n)
    z_h_vals = [fs.sub(fs.mul(fs.exp(shift, n), fs.exp(u, j)), 1) for j in range(1 << qd_bits)]
    z_h_inv = g.tensor(fs.batch_inverse(z_h_vals), device).repeat(n)
    sel = torch.zeros((2, n), dtype=torch.int64, device=device)
    sel[0, 0] = 1
    sel[1, n - 1] = 1
    sel_lde = ntt.coset_lde(ntt.ifft(sel), qd_bits)  # [2, Q]
    last = fs.inverse(fs.primitive_root_of_unity(degree_bits))
    return {"z_h_inv": z_h_inv, "l_first": sel_lde[0], "l_last": sel_lde[1],
            "z_last": g.sub(xs, g.scalar_tensor(last, device))}


def compute_quotient_polys(stark, config, trace_commitment, public_inputs, alphas,
                           degree_bits: int, auxiliary_polys_commitment=None,
                           lookup_challenges=None, ctl_data=None) -> torch.Tensor:
    """The quotient chunks' coefficients [num_challenges · qdf, n]: every
    constraint over the quotient coset, α-combined per challenge, divided by
    Z_H and taken back by one coset iFFT (reference prover.rs:488-670). The
    CTL checks read the auxiliary LDE on the coset and its roll by one row
    (reference prover.py:246-255). Under a group the ranks holding quotient
    points evaluate them (`parallel.QuotientPoints`: the trace's and the
    auxiliary columns' next rows from the same rank or, where they lie on
    another, one exchange a batch) and the values are gathered before the
    iFFT."""
    qdf = stark.quotient_degree_factor()
    qd_bits = (qdf - 1).bit_length()
    rate_bits = config.fri_config.rate_bits
    if qd_bits > rate_bits:
        raise ValueError("Having constraints of degree higher than the rate is not supported yet.")
    n = 1 << degree_bits
    points = parallel.QuotientPoints(parallel.active_mesh(), rate_bits, qd_bits)
    # each batch at the points and at their next rows (every rank takes part
    # in the exchange)
    batches = [trace_commitment] + ([auxiliary_polys_commitment]
                                    if auxiliary_polys_commitment is not None else [])
    at_points = [points.points(b) for b in batches]
    at_next = [points.next_rows(x) for x in at_points]
    evals = None
    if points.holds:
        evals = _vanishing_at_points(stark, config, points, trace_commitment.device, at_points,
                                     at_next, public_inputs, alphas, degree_bits, qd_bits,
                                     lookup_challenges, ctl_data)
    evals = points.gather(evals, (len(alphas), (n << qd_bits) // points.holders))
    return ntt.coset_ifft(evals).reshape(-1, n)


def _vanishing_at_points(stark, config, points, device, at_points, at_next, public_inputs,
                         alphas, degree_bits, qd_bits, lookup_challenges, ctl_data):
    """The α-combined constraints over Z_H at the rank's quotient points,
    [num_challenges, points]. at_points, at_next: the trace's (and the
    auxiliary batch's) values at the points and at their next rows."""
    t = {name: points.table(v) for name, v in
         quotient_tables(degree_bits, qd_bits, str(device)).items()}
    ops = TorchBaseOps(device)
    trace_q = at_points[0]
    frame = StarkFrame(list(trace_q), list(at_next[0]),
                       [g.scalar_tensor(pi, device) for pi in public_inputs])
    consumer = ConstraintConsumer(ops, [g.scalar_tensor(a, device) for a in alphas],
                                  t["z_last"], t["l_first"], t["l_last"])
    lookup_vars = ctl_vars = None
    aux_local = aux_next = []  # a table with neither logUp nor a CTL commits no aux
    if len(at_points) > 1:
        aux_local, aux_next = list(at_points[1]), list(at_next[1])
    if stark.uses_lookups():
        lookup_vars = LookupCheckVars(aux_local, aux_next,
                                      [g.scalar_tensor(c, device) for c in lookup_challenges])
    if ctl_data is not None:
        ctl_vars = CtlCheckVars.from_proof(ctl_data.zs_columns, aux_local, aux_next,
                                           stark.num_lookup_helper_columns(config),
                                           ctl_data.num_ctl_helper_polys())
    eval_vanishing_poly(ops, stark, frame, consumer, lookup_vars, ctl_vars)
    q = trace_q.shape[-1]
    evals = torch.stack([torch.broadcast_to(a, (q,)) for a in consumer.accumulators()])
    return g.mul(evals, t["z_h_inv"][None])


# -- openings --------------------------------------------------------------------

def opening_set(zeta, g_root, trace_commitment, quotient_commitment,
                auxiliary_polys_commitment=None, ctl_zs_start: int | None = None
                ) -> StarkOpeningSet:
    """The trace, auxiliary and quotient polynomials at ζ, the trace and
    auxiliary polynomials at g·ζ, and, from auxiliary column ctl_zs_start
    on (a table with CTLs), the CTL Zs at 1: the sums of their
    coefficients (reference prover.py:362-368). One fetch."""
    zeta_next = fs.ext_scalar_mul(g_root, zeta)
    shifted = [trace_commitment.polynomials]
    if auxiliary_polys_commitment is not None:
        shifted.append(auxiliary_polys_commitment.polynomials)
    shifted = torch.cat(shifted)
    at_z = eval_polys_at(torch.cat([shifted, quotient_commitment.polynomials]), zeta)
    at_next = eval_polys_at(shifted, zeta_next)
    parts = [at_z[0], at_next[0], at_z[1], at_next[1]]
    if ctl_zs_start is not None:
        parts.append(g.sum_mod(auxiliary_polys_commitment.polynomials[ctl_zs_start:], 1))
    flat = [int(v) for v in g.to_numpy(torch.cat(parts))]
    m = at_z[0].shape[0] + at_next[0].shape[0]
    values = list(zip(flat[:m], flat[m:2 * m]))
    ctl_zs_first = flat[2 * m:] if ctl_zs_start is not None else None
    num_trace = trace_commitment.polynomials.shape[0]
    num_shifted = shifted.shape[0]
    at_z, at_next = values[:len(values) - num_shifted], values[len(values) - num_shifted:]
    aux = aux_next = None
    if auxiliary_polys_commitment is not None:
        aux, aux_next = at_z[num_trace:num_shifted], at_next[num_trace:]
    return StarkOpeningSet(
        local_values=at_z[:num_trace],
        next_values=at_next[:num_trace],
        auxiliary_polys=aux,
        auxiliary_polys_next=aux_next,
        ctl_zs_first=ctl_zs_first,
        quotient_polys=at_z[num_shifted:],
    )
