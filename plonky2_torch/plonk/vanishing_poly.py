"""The vanishing polynomial at one point, on the ops protocol (reference
plonk/vanishing_poly.rs:57-164; the reference package's
plonk/vanishing_poly.py:20-308). The verifier runs it on `HostExtOps` at ζ,
every gate through its generic `eval_unfiltered`, the form the prover's
device evaluation is held to. Lookups (ROADMAP item 9) are not ported: a
circuit with lookup polynomials raises.

Challenges, the point x, L_0(x) and the openings are ops-domain values the
caller lifts.
"""

from __future__ import annotations

from plonky2_torch.gates.gate import UNUSED_SELECTOR
from plonky2_torch.gates.ops import EvaluationVars


def reduce_with_powers(ops, terms, alpha):
    """sum_i alpha^i · terms[i], by Horner from the last term (reference
    plonk_common.rs)."""
    acc = ops.zero()
    for t in reversed(terms):
        acc = ops.add(ops.mul(alpha, acc), t)
    return acc


def compute_filter(ops, row: int, group: range, s, many_selectors: bool):
    """The product of (k - s) over the other gates k of the selector
    group, and (UNUSED_SELECTOR - s) where there are several groups
    (reference gates/gate.rs:326-338)."""
    acc = ops.one()
    for i in group:
        if i != row:
            acc = ops.mul(acc, ops.sub(ops.constant(i), s))
    if many_selectors:
        acc = ops.mul(acc, ops.sub(ops.constant(UNUSED_SELECTOR), s))
    return acc


def evaluate_gate_constraints(ops, common, vars) -> list:
    """Every gate's constraints times its filter, summed constraint by
    constraint (reference vanishing_poly.rs:671-755)."""
    constraints = [ops.zero()] * common.num_gate_constraints
    si = common.selectors_info
    gate_vars = EvaluationVars(
        vars.local_constants[si.num_selectors + common.num_lookup_selectors:],
        vars.local_wires, vars.public_inputs_hash)
    for i, gate in enumerate(common.gates):
        selector_index = si.selector_indices[i]
        f = compute_filter(ops, i, si.groups[selector_index],
                           vars.local_constants[selector_index], si.num_selectors > 1)
        for k, c in enumerate(gate.eval_unfiltered(ops, gate_vars)):
            constraints[k] = ops.add(constraints[k], ops.mul(f, c))
    return constraints


def check_partial_products(ops, numerators, denominators, partials, z_x, z_gx,
                           max_degree: int) -> list:
    """The chunked partial-product checks (reference
    util/partial_products.rs:63-107)."""
    accs = [z_x] + list(partials) + [z_gx]
    terms = []
    for c in range(-(-len(numerators) // max_degree)):
        num_chunk = numerators[c * max_degree:(c + 1) * max_degree]
        den_chunk = denominators[c * max_degree:(c + 1) * max_degree]
        num_prod, den_prod = num_chunk[0], den_chunk[0]
        for v in num_chunk[1:]:
            num_prod = ops.mul(num_prod, v)
        for v in den_chunk[1:]:
            den_prod = ops.mul(den_prod, v)
        terms.append(ops.sub(ops.mul(accs[c + 1], den_prod), ops.mul(accs[c], num_prod)))
    return terms


def eval_vanishing_poly(ops, common, x, vars, local_zs, next_zs, partial_products,
                        s_sigmas, betas, gammas, alphas, l_0_x) -> list:
    """One α-combined vanishing value per challenge: L_0(x) (Z(x) - 1) of
    each challenge, each challenge's partial-product checks, then the
    filtered gate constraints (reference vanishing_poly.rs:57-164)."""
    if common.num_lookup_polys:
        raise NotImplementedError("circuits with lookups are not ported (ROADMAP item 9)")
    config = common.config
    num_prods = common.num_partial_products
    constraint_terms = evaluate_gate_constraints(ops, common, vars)
    z_1_terms, partial_product_terms = [], []
    for i in range(config.num_challenges):
        z_x, z_gx = local_zs[i], next_zs[i]
        z_1_terms.append(ops.mul(l_0_x, ops.add_const(z_x, -1)))
        numerators, denominators = [], []
        for j in range(config.num_routed_wires):
            wire = vars.local_wires[j]
            s_id = ops.mul_const(common.k_is[j], x)
            numerators.append(ops.add(wire, ops.add(ops.mul(betas[i], s_id), gammas[i])))
            denominators.append(ops.add(wire, ops.add(ops.mul(betas[i], s_sigmas[j]),
                                                      gammas[i])))
        partial_product_terms.extend(check_partial_products(
            ops, numerators, denominators, partial_products[i * num_prods:(i + 1) * num_prods],
            z_x, z_gx, common.quotient_degree_factor))
    terms = z_1_terms + partial_product_terms + constraint_terms
    return [reduce_with_powers(ops, terms, a) for a in alphas]
