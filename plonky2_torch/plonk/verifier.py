"""The PLONK verifier on the host, in Python-int field arithmetic
(reference plonk/verifier.rs:17-118; the reference package's
plonk/verifier.py:23-139): the proof's shape, the transcript's replay,
the quotient identity at ζ with every gate's constraints and the lookup
checks (each LUT's polynomial at the challenge's δ by `eval_lut_poly`) on
`HostExtOps`, and the FRI proof. A bad proof raises ValueError at the
check where the reference's verifier raises.
"""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.verifier import verify_fri_proof
from plonky2_torch.gates.ops import EvaluationVars, HostExtOps
from plonky2_torch.hash import poseidon as ps
from plonky2_torch.plonk.get_challenges import get_challenges
from plonky2_torch.plonk.vanishing_poly import (
    NUM_COINS_LOOKUP,
    eval_lut_poly,
    eval_vanishing_poly,
)


def validate_proof_with_pis_shape(proof_with_pis, common) -> None:
    """Reference plonk/validate_shape.rs."""
    proof = proof_with_pis.proof
    config = common.config
    if len(proof_with_pis.public_inputs) != common.num_public_inputs:
        raise ValueError("Wrong number of public inputs")
    cap_len = 1 << config.fri_config.cap_height
    for cap in (proof.wires_cap, proof.plonk_zs_partial_products_cap,
                proof.quotient_polys_cap):
        if len(cap) != cap_len:
            raise ValueError("Wrong Merkle cap length")
    o = proof.openings
    for vals, expected in ((o.constants, common.num_constants),
                           (o.plonk_sigmas, config.num_routed_wires),
                           (o.wires, config.num_wires),
                           (o.plonk_zs, config.num_challenges),
                           (o.plonk_zs_next, config.num_challenges),
                           (o.partial_products,
                            config.num_challenges * common.num_partial_products),
                           (o.quotient_polys, common.num_quotient_polys()),
                           (o.lookup_zs, common.num_all_lookup_polys()),
                           (o.lookup_zs_next, common.num_all_lookup_polys())):
        if len(vals) != expected:
            raise ValueError(f"Opening-set shape mismatch: got {len(vals)}, want {expected}")


def verify(proof_with_pis, verifier_data, common) -> None:
    """Raise unless `proof_with_pis` is a valid proof of the circuit of
    `verifier_data` (its constants-sigmas cap and circuit digest) and
    `common`."""
    validate_proof_with_pis_shape(proof_with_pis, common)
    public_inputs_hash = ps.hash_no_pad(list(proof_with_pis.public_inputs))
    challenges = get_challenges(proof_with_pis, public_inputs_hash,
                                verifier_data.circuit_digest, common)
    verify_with_challenges(proof_with_pis.proof, public_inputs_hash, challenges,
                           verifier_data, common)


def verify_with_challenges(proof, public_inputs_hash, challenges, verifier_data,
                           common) -> None:
    openings = proof.openings
    zeta = challenges.plonk_zeta
    degree = common.degree

    def lift(c):
        return (c, 0)

    vars = EvaluationVars(openings.constants, openings.wires,
                          [lift(h) for h in public_inputs_hash])
    # L_0(ζ) = (ζ^n - 1) / (n (ζ - 1))
    zeta_pow_deg = fs.ext_exp(zeta, degree)
    z_h_zeta = fs.ext_sub(zeta_pow_deg, fs.ext_one(2))
    l_0_zeta = fs.ext_div(z_h_zeta,
                          fs.ext_scalar_mul(degree % fs.P, fs.ext_sub(zeta, fs.ext_one(2))))
    deltas = challenges.plonk_deltas
    lut_re_evals = [[lift(eval_lut_poly(common, k, deltas[NUM_COINS_LOOKUP * c:
                                                          NUM_COINS_LOOKUP * (c + 1)]))
                     for k in range(len(common.luts))]
                    for c in range(common.config.num_challenges)] if deltas else []
    vanishing_polys_zeta = eval_vanishing_poly(
        HostExtOps(), common, zeta, vars, openings.plonk_zs, openings.plonk_zs_next,
        openings.partial_products, openings.plonk_sigmas,
        [lift(b) for b in challenges.plonk_betas], [lift(g) for g in challenges.plonk_gammas],
        [lift(a) for a in challenges.plonk_alphas], l_0_zeta, openings.lookup_zs,
        openings.lookup_zs_next, [lift(d) for d in deltas], lut_re_evals)
    # vanishing(ζ) = Z_H(ζ) · Σ_k t_k(ζ) ζ^(n k)
    qdf = common.quotient_degree_factor
    for i in range(common.config.num_challenges):
        t_zeta = fs.ext_zero(2)
        for c in reversed(openings.quotient_polys[i * qdf:(i + 1) * qdf]):
            t_zeta = fs.ext_add(fs.ext_mul(t_zeta, zeta_pow_deg), c)
        if vanishing_polys_zeta[i] != fs.ext_mul(z_h_zeta, t_zeta):
            raise ValueError(f"Quotient identity check failed for challenge {i}")
    verify_fri_proof(common.get_fri_instance(zeta), openings.to_fri_openings(),
                     challenges.fri_challenges,
                     [verifier_data.constants_sigmas_cap, proof.wires_cap,
                      proof.plonk_zs_partial_products_cap, proof.quotient_polys_cap],
                     proof.opening_proof, common.fri_params, common.generic_config().hasher)
