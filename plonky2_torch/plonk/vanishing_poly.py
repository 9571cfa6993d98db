"""The vanishing polynomial at one point, on the ops protocol (reference
plonk/vanishing_poly.rs:57-164; the reference package's
plonk/vanishing_poly.py:20-308). The verifier runs it on `HostExtOps` at ζ,
every gate through its generic `eval_unfiltered`, the form the prover's
device evaluation is held to; the in-circuit verifier runs it on
`CircuitOps`, so its targets come in the order of these ops.

The lookup argument's checks (reference vanishing_poly.rs:343-515) take a
challenge's four lookup draws (its block of `NUM_COINS_LOOKUP`: a, b, α, δ)
and each LUT's polynomial Σ_j (in_j + b · out_j) δ^(N-1-j) at δ
(`eval_lut_poly`; `eval_lut_poly_circuit` in a circuit). They have three
forms: `check_lookup_constraints` on the ops protocol (host and circuit),
and `check_lookup_constraints_device` over the quotient domain's [*, Q]
tensors, the same values in the same order.

Challenges, the point x, L_0(x) and the openings are ops-domain values the
caller lifts.
"""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import UNUSED_SELECTOR, rows
from plonky2_torch.gates.lookup import LookupGate, LookupTableGate
from plonky2_torch.gates.ops import EvaluationVars

# the roles of a challenge's four lookup draws (reference vanishing_poly.rs
# LookupChallenges)
CHALLENGE_A, CHALLENGE_B, CHALLENGE_ALPHA, CHALLENGE_DELTA = range(4)
NUM_COINS_LOOKUP = 4


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


def _padded_lut(common, lut_index: int) -> tuple[list[tuple[int, int]], int]:
    """The LUT padded with its first entry to whole LookupTableGate rows,
    and that length N."""
    lut = common.luts[lut_index]
    nb_slots = LookupTableGate.num_slots_from_config(common.config)
    n = -(-len(lut) // nb_slots) * nb_slots
    return list(lut) + [lut[0]] * (n - len(lut)), n


def get_lut_poly(common, lut_index: int, deltas, degree: int) -> list[int]:
    """The LUT's polynomial's coefficients, ascending: (in + b · out) of
    the padded LUT's entries from the last to the first, behind
    degree - N zeros (reference vanishing_poly.rs:30)."""
    b = deltas[CHALLENGE_B]
    padded, n = _padded_lut(common, lut_index)
    coeffs = [fs.add(i, fs.mul(b, o)) for i, o in padded] + [0] * (degree - n)
    coeffs.reverse()
    return coeffs


def eval_lut_poly(common, lut_index: int, deltas) -> int:
    """get_lut_poly at δ, by Horner from the top coefficient."""
    _, n = _padded_lut(common, lut_index)
    acc = 0
    for c in reversed(get_lut_poly(common, lut_index, deltas, n)):
        acc = fs.add(fs.mul(acc, deltas[CHALLENGE_DELTA]), c)
    return acc


def eval_lut_poly_circuit(builder, common, lut_index: int, deltas):
    """eval_lut_poly with b and δ as targets and the LUT's entries as
    constants: a base target (reference vanishing_poly.rs:756-794
    `get_lut_poly_circuit`, the targets in its order)."""
    b, delta = deltas[CHALLENGE_B], deltas[CHALLENGE_DELTA]
    lut = common.luts[lut_index]
    _, n = _padded_lut(common, lut_index)
    coeffs = [builder.add_const(builder.mul_const(o, b), i) for i, o in lut]
    pad_i, pad_o = lut[0]  # made once, padding or not, as the reference makes it
    coeffs += [builder.add_const(builder.mul_const(pad_o, b), pad_i)] * (n - len(lut))
    acc = builder.zero()
    for c in coeffs:  # ascending coefficients are these reversed: Horner from the top
        acc = builder.add(builder.mul(acc, delta), c)
    return acc


def lut_evals_device(common, deltas, device):
    """[num_challenges, num_luts]: each challenge's eval_lut_poly of each
    LUT from the device draws `deltas` [4 · num_challenges], as a table of
    δ's powers and one weighted sum over the padded LUT, with no host read
    (field arithmetic is exact, so this is Horner's value)."""
    nc = common.config.num_challenges
    d = deltas.reshape(nc, NUM_COINS_LOOKUP)
    out = []
    for c in range(nc):
        b, delta = d[c, CHALLENGE_B], d[c, CHALLENGE_DELTA]
        vals = []
        for k in range(len(common.luts)):
            padded, n = _padded_lut(common, k)
            ins = g.constant([i for i, _ in padded], device)
            outs = g.constant([o for _, o in padded], device)
            pows = g.powers(delta, n).flip(0)  # δ^(N-1-j)
            vals.append(g.sum_mod(g.mul(g.add(ins, g.mul(b, outs)), pows), 0))
        out.append(torch.stack(vals))
    return torch.stack(out)


def check_lookup_constraints(ops, common, vars, local_lookup_zs, next_lookup_zs,
                             lookup_selectors, deltas, lut_re_evals) -> list:
    """One challenge's lookup checks (reference vanishing_poly.rs:343-515):
    the last SLDC, the first SLDC and the first RE are zero where their
    selectors say; the RE ends at each LUT's polynomial at δ; the RE's row
    transition over the table rows; then per partial-SLDC column its
    transitions over the table rows and over the lookup rows. `deltas` are
    the challenge's four draws and `lut_re_evals` its LUT evaluations, as
    ops-domain values."""
    num_lu_slots = LookupGate.num_slots_from_config(common.config)
    num_lut_slots = LookupTableGate.num_slots_from_config(common.config)
    lu_degree = common.quotient_degree_factor - 1
    num_sldc_polys = len(local_lookup_zs) - 1
    lut_degree = -(-num_lut_slots // num_sldc_polys)
    sel_trans_sre, sel_trans_ldc, sel_init_sre, sel_last_ldc = lookup_selectors[:4]
    w = vars.local_wires

    z_re, next_z_re = local_lookup_zs[0], next_lookup_zs[0]
    z_x_sldcs, z_gx_sldcs = local_lookup_zs[1:], next_lookup_zs[1:]
    da = deltas[CHALLENGE_A]
    looked_combos = [ops.add(w[LookupTableGate.wire_ith_looked_inp(s)],
                             ops.mul(da, w[LookupTableGate.wire_ith_looked_out(s)]))
                     for s in range(num_lut_slots)]
    looking_combos = [ops.add(w[LookupGate.wire_ith_looking_inp(s)],
                              ops.mul(da, w[LookupGate.wire_ith_looking_out(s)]))
                      for s in range(num_lu_slots)]
    db = deltas[CHALLENGE_B]
    lookup_combos = [ops.add(w[LookupTableGate.wire_ith_looked_inp(s)],
                             ops.mul(db, w[LookupTableGate.wire_ith_looked_out(s)]))
                     for s in range(num_lut_slots)]

    constraints = [ops.mul(sel_last_ldc, z_x_sldcs[-1]),
                   ops.mul(sel_init_sre, z_x_sldcs[0]),
                   ops.mul(sel_init_sre, z_re)]
    for r in range(4, common.num_lookup_selectors):
        constraints.append(ops.mul(lookup_selectors[r], ops.sub(z_re, lut_re_evals[r - 4])))

    dd = deltas[CHALLENGE_DELTA]
    cur_sum = next_z_re
    for elt in lookup_combos:
        cur_sum = ops.add(ops.mul(cur_sum, dd), elt)
    constraints.append(ops.mul(sel_trans_sre, ops.sub(z_re, cur_sum)))

    dalpha = deltas[CHALLENGE_ALPHA]
    alpha_minus_looked = [ops.sub(dalpha, c) for c in looked_combos]
    alpha_minus_looking = [ops.sub(dalpha, c) for c in looking_combos]

    def prod(terms):
        acc = ops.one()
        for t in terms:
            acc = ops.mul(acc, t)
        return acc

    for poly in range(num_sldc_polys):
        lut_rng = range(poly * lut_degree, min((poly + 1) * lut_degree, num_lut_slots))
        lu_rng = range(poly * lu_degree, min((poly + 1) * lu_degree, num_lu_slots))
        lut_prod = prod([alpha_minus_looked[i] for i in lut_rng])
        lu_prod = prod([alpha_minus_looking[i] for i in lu_rng])
        lu_sum_prods = ops.zero()
        for i in lu_rng:
            lu_sum_prods = ops.add(lu_sum_prods,
                                   prod([alpha_minus_looking[j] for j in lu_rng if j != i]))
        lut_sum_prods_with_mul = ops.zero()
        for i in lut_rng:
            lut_sum_prods_with_mul = ops.add(lut_sum_prods_with_mul, ops.mul(
                w[LookupTableGate.wire_ith_multiplicity(i)],
                prod([alpha_minus_looked[j] for j in lut_rng if j != i])))
        prev = z_gx_sldcs[-1] if poly == 0 else z_x_sldcs[poly - 1]
        diff = ops.sub(z_x_sldcs[poly], prev)
        constraints.append(ops.mul(sel_trans_sre,
                                   ops.sub(ops.mul(lut_prod, diff), lut_sum_prods_with_mul)))
        constraints.append(ops.mul(sel_trans_ldc, ops.add(ops.mul(lu_prod, diff), lu_sum_prods)))
    return constraints


def _chunks(x, size: int, count: int, pad: int):
    """[S, Q] -> [count, size, Q]: the rows in chunks of `size`, the tail
    filled with `pad`."""
    fill = count * size - x.shape[0]
    if fill:
        x = torch.cat([x, torch.full((fill, x.shape[1]), pad, dtype=x.dtype, device=x.device)])
    return x.reshape(count, size, x.shape[1])


def _products_but_one(c):
    """For [P, k, Q] chunks: each chunk's product over k [P, Q], and for
    each i the product of the others [P, k, Q] (prefix times suffix)."""
    pre = g.cumprod(c, 1)
    suf = g.cumprod(c.flip(1), 1).flip(1)
    one = torch.ones_like(c[:, :1])
    return pre[:, -1], g.mul(torch.cat([one, pre[:, :-1]], 1), torch.cat([suf[:, 1:], one], 1))


def check_lookup_constraints_device(common, wires, lookup_selectors, local_zs, next_zs,
                                    deltas, lut_re_evals):
    """`check_lookup_constraints` of one challenge over the quotient
    domain: wires [W, Q], lookup_selectors [num_lookup_selectors, Q], the
    challenge's lookup columns here and at the next row [num_lookup_polys,
    Q], its four draws [4] and LUT evaluations [num_luts], all on the
    device. Returns the checks [3 + num_luts + 1 + 2 · num SLDC, Q] in that
    function's order: the RE transition's Horner over the table slots as
    one weighted sum with δ's powers, and the products over each chunk of
    slots, with and without each slot, from prefix and suffix products
    (padding slots count 1 in the products and nothing in the sums)."""
    config = common.config
    device = wires.device
    num_lu_slots = LookupGate.num_slots_from_config(config)
    num_lut_slots = LookupTableGate.num_slots_from_config(config)
    lu_degree = common.quotient_degree_factor - 1
    num_sldc = local_zs.shape[0] - 1
    lut_degree = -(-num_lut_slots // num_sldc)
    da, db, dalpha, dd = (deltas[k] for k in range(NUM_COINS_LOOKUP))
    sel = lookup_selectors

    lut_in = rows(wires, [LookupTableGate.wire_ith_looked_inp(s) for s in range(num_lut_slots)])
    lut_out = rows(wires, [LookupTableGate.wire_ith_looked_out(s) for s in range(num_lut_slots)])
    mult = rows(wires, [LookupTableGate.wire_ith_multiplicity(s) for s in range(num_lut_slots)])
    lu_in = rows(wires, [LookupGate.wire_ith_looking_inp(s) for s in range(num_lu_slots)])
    lu_out = rows(wires, [LookupGate.wire_ith_looking_out(s) for s in range(num_lu_slots)])

    z_re, next_re = local_zs[0], next_zs[0]
    sldc, next_sldc = local_zs[1:], next_zs[1:]
    out = [g.mul(sel[3], sldc[-1])[None], g.mul(sel[2], sldc[0])[None],
           g.mul(sel[2], z_re)[None]]
    num_luts = sel.shape[0] - 4
    if num_luts:
        out.append(g.mul(sel[4:], g.sub(z_re[None], lut_re_evals[:, None])))
    pows = g.powers(dd, num_lut_slots + 1)
    combos = g.add(lut_in, g.mul(db, lut_out))
    cur_sum = g.add(g.mul(next_re, pows[num_lut_slots]),
                    g.sum_mod(g.mul(pows[:num_lut_slots].flip(0)[:, None], combos), 0))
    out.append(g.mul(sel[0], g.sub(z_re, cur_sum))[None])

    lut_prod, lut_others = _products_but_one(
        _chunks(g.sub(dalpha, g.add(lut_in, g.mul(da, lut_out))), lut_degree, num_sldc, 1))
    lut_sum = g.sum_mod(g.mul(_chunks(mult, lut_degree, num_sldc, 0), lut_others), 1)
    lu_prod, lu_others = _products_but_one(
        _chunks(g.sub(dalpha, g.add(lu_in, g.mul(da, lu_out))), lu_degree, num_sldc, 1))
    real = np.zeros((num_sldc * lu_degree, 1), dtype=np.uint64)
    real[:num_lu_slots] = 1
    lu_sum = g.sum_mod(g.mul(g.constant(real, device).reshape(num_sldc, lu_degree, 1),
                             lu_others), 1)
    diff = g.sub(sldc, torch.cat([next_sldc[-1:], sldc[:-1]]))
    table = g.mul(sel[0], g.sub(g.mul(lut_prod, diff), lut_sum))
    looking = g.mul(sel[1], g.add(g.mul(lu_prod, diff), lu_sum))
    out.append(torch.stack([table, looking], 1).reshape(2 * num_sldc, -1))
    return torch.cat(out)


def eval_vanishing_poly(ops, common, x, vars, local_zs, next_zs, partial_products,
                        s_sigmas, betas, gammas, alphas, l_0_x, local_lookup_zs=(),
                        next_lookup_zs=(), deltas=(), lut_re_evals=()) -> list:
    """One α-combined vanishing value per challenge: L_0(x) (Z(x) - 1) of
    each challenge, each challenge's partial-product checks, each
    challenge's lookup checks (where the circuit has LUTs: `deltas` has
    NUM_COINS_LOOKUP values a challenge, `lut_re_evals` one list a
    challenge), then the filtered gate constraints (reference
    vanishing_poly.rs:57-164)."""
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
    lookup_terms = []
    if common.num_lookup_polys:
        num_sel = common.selectors_info.num_selectors
        lookup_selectors = vars.local_constants[num_sel:num_sel + common.num_lookup_selectors]
        nlp = common.num_lookup_polys
        for i in range(config.num_challenges):
            lookup_terms.extend(check_lookup_constraints(
                ops, common, vars, local_lookup_zs[nlp * i:nlp * (i + 1)],
                next_lookup_zs[nlp * i:nlp * (i + 1)], lookup_selectors,
                deltas[NUM_COINS_LOOKUP * i:NUM_COINS_LOOKUP * (i + 1)], lut_re_evals[i]))
    terms = z_1_terms + partial_product_terms + lookup_terms + constraint_terms
    return [reduce_with_powers(ops, terms, a) for a in alphas]
