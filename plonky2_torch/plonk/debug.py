"""The debug constraint checker: every term of the vanishing polynomial
replayed on H with exact host scalars, reporting which family and row fail
(the reference package's plonk/debug.py; the analog of the reference's
debug_assertions check_constraints, starky/src/prover.rs:242-257).
"""

from __future__ import annotations

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.ops import EvaluationVars, HostBaseOps
from plonky2_torch.plonk.vanishing_poly import (
    NUM_COINS_LOOKUP,
    check_lookup_constraints,
    check_partial_products,
    compute_filter,
    eval_lut_poly,
)


def check_constraints_on_h(data, witness, zs_partial_products, public_inputs_hash,
                           betas, gammas, deltas, rows=None) -> list[str]:
    """The failures, as descriptions (empty where every constraint holds).

    witness: [num_wires, n] u64 values; zs_partial_products: [polys, n] u64
    values (the Zs, then the partial products, then the lookup polys);
    rows: the rows to check (all by default).
    """
    common = data.common
    config = common.config
    n = common.degree
    ops = HostBaseOps()
    failures = []

    cs_values = g.to_numpy(ntt.fft(g.tensor(data.prover_only.constants_sigmas_coeffs, "cpu")))
    num_constants = common.num_constants
    num_sel = common.selectors_info.num_selectors
    nls = common.num_lookup_selectors
    subgroup = data.prover_only.subgroup
    nc = config.num_challenges
    nlp = common.num_lookup_polys

    if common.luts:
        lut_re_evals = [
            [eval_lut_poly(common, lut, deltas[c * NUM_COINS_LOOKUP:(c + 1) * NUM_COINS_LOOKUP])
             for lut in range(len(common.luts))]
            for c in range(nc)
        ]

    rows = rows if rows is not None else range(n)
    for r in rows:
        r_next = (r + 1) % n
        local_constants = [int(cs_values[j, r]) for j in range(num_constants)]
        s_sigmas = [int(cs_values[num_constants + j, r]) for j in range(config.num_routed_wires)]
        local_wires = [int(witness[j, r]) for j in range(config.num_wires)]
        vars = EvaluationVars(local_constants, local_wires, list(public_inputs_hash))

        # gate constraints
        for i, gate in enumerate(common.gates):
            sel_idx = common.selectors_info.selector_indices[i]
            filt = compute_filter(ops, i, common.selectors_info.groups[sel_idx],
                                  local_constants[sel_idx], num_sel > 1)
            if filt == 0:
                continue
            gate_vars = EvaluationVars(local_constants[num_sel + nls:], local_wires,
                                       list(public_inputs_hash))
            for k, c in enumerate(gate.eval_unfiltered(ops, gate_vars)):
                if fs.mul(filt, c) != 0:
                    failures.append(f"row {r}: gate {gate.id()[:40]} constraint {k}")

        # permutation argument
        x = int(subgroup[r])
        for i in range(nc):
            z_x = int(zs_partial_products[i, r])
            z_gx = int(zs_partial_products[i, r_next])
            if r == 0 and z_x != 1:
                failures.append(f"row 0: Z_{i}(1) != 1")
            numerators = [
                fs.add(local_wires[j], fs.add(fs.mul(betas[i], fs.mul(common.k_is[j], x)),
                                              gammas[i]))
                for j in range(config.num_routed_wires)
            ]
            denominators = [
                fs.add(local_wires[j], fs.add(fs.mul(betas[i], s_sigmas[j]), gammas[i]))
                for j in range(config.num_routed_wires)
            ]
            pps = [int(zs_partial_products[nc + i * common.num_partial_products + c, r])
                   for c in range(common.num_partial_products)]
            terms = check_partial_products(ops, numerators, denominators, pps, z_x, z_gx,
                                           common.quotient_degree_factor)
            for k, t in enumerate(terms):
                if t != 0:
                    failures.append(f"row {r}: partial product term {k} challenge {i}")

        # lookups
        if common.luts:
            lookup_selectors = local_constants[num_sel:num_sel + nls]
            base = nc * (1 + common.num_partial_products)
            for i in range(nc):
                cur_local = [int(zs_partial_products[base + nlp * i + j, r])
                             for j in range(nlp)]
                cur_next = [int(zs_partial_products[base + nlp * i + j, r_next])
                            for j in range(nlp)]
                cur_deltas = deltas[NUM_COINS_LOOKUP * i:NUM_COINS_LOOKUP * (i + 1)]
                terms = check_lookup_constraints(
                    ops, common, vars, cur_local, cur_next, lookup_selectors,
                    cur_deltas, lut_re_evals[i],
                )
                for k, t in enumerate(terms):
                    if t != 0:
                        failures.append(f"row {r}: lookup term {k} challenge {i}")
    return failures
