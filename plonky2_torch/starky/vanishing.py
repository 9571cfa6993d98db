"""The STARK vanishing polynomial at a point and the constraint-binding
openings (reference starky/src/vanishing_poly.rs, get_challenges.rs)."""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.ops import HostExtOps
from plonky2_torch.starky.constraint_consumer import ConstraintConsumer
from plonky2_torch.starky.evaluation_frame import StarkFrame
from plonky2_torch.starky.lookup import LookupCheckVars, eval_lookups
from plonky2_torch.starky.proof import StarkOpeningSet


def eval_vanishing_poly(ops, stark, frame, consumer, lookup_vars=None, ctl_vars=None) -> None:
    """The table's constraints, then its logUp lookups and its CTL checks
    when present, the CTL helpers chunked by the table's own degree
    (reference vanishing.py:13-30)."""
    stark.eval(ops, frame, consumer)
    if lookup_vars is not None:
        eval_lookups(ops, stark, frame, lookup_vars, consumer)
    if ctl_vars is not None:
        from plonky2_torch.starky.cross_table_lookup import eval_cross_table_lookup_checks

        eval_cross_table_lookup_checks(ops, frame, ctl_vars, consumer, stark.constraint_degree())


def eval_l_0_and_l_last(log_n: int, x: tuple) -> tuple[tuple, tuple]:
    """L_0(x) = (x^n - 1) / (n (x - 1)); L_{n-1}(x) = (x^n - 1) / (n (g x - 1))
    (reference vanishing_poly.rs:98-107)."""
    n = 1 << log_n
    g = fs.primitive_root_of_unity(log_n)
    one = fs.ext_one(2)
    z_x = fs.ext_sub(fs.ext_exp(x, n), one)
    d0 = fs.ext_scalar_mul(n % fs.P, fs.ext_sub(x, one))
    d1 = fs.ext_scalar_mul(n % fs.P, fs.ext_sub(fs.ext_scalar_mul(g, x), one))
    return fs.ext_mul(z_x, fs.ext_inverse(d0)), fs.ext_mul(z_x, fs.ext_inverse(d1))


def get_dummy_polys(challenger, num_trace_polys: int, num_aux_polys: int,
                    pow_degree: int) -> StarkOpeningSet:
    """The simulated opening set that binds the constraints before the
    quotient's alphas are drawn (reference get_challenges.rs:202-252)."""
    log_pow_degree = (pow_degree - 1).bit_length()
    num_extension_powers = max(1, 50 // log_pow_degree - 1)
    total = num_trace_polys * 2 + num_aux_polys * 2
    num_zetas = (total + num_extension_powers - 1) // num_extension_powers
    nb_dummy_per_zeta = min(num_extension_powers + 1, total)

    evals = []
    for zeta in challenger.get_n_extension_challenges(num_zetas):
        cur = zeta
        for _ in range(nb_dummy_per_zeta):
            evals.append(cur)
            cur = fs.ext_exp(cur, pow_degree)

    next_start = num_trace_polys
    aux_start = num_trace_polys * 2
    aux_next_start = aux_start + num_aux_polys
    is_aux = num_aux_polys > 0
    return StarkOpeningSet(
        local_values=evals[:next_start],
        next_values=evals[next_start:aux_start],
        auxiliary_polys=evals[aux_start:aux_next_start] if is_aux else None,
        auxiliary_polys_next=evals[aux_next_start:] if is_aux else None,
        ctl_zs_first=None,
        quotient_polys=None,
    )


def compute_eval_vanishing_poly(stark, opening_set, public_inputs, alphas, zeta,
                                degree_bits: int, lookup_challenges=None,
                                num_lookup_columns: int = 0, ctl_vars=None) -> list[tuple]:
    """The α-combined constraints at the extension point ζ on the host, one
    per alpha (reference vanishing_poly.rs:109-172): the constraint binding
    and the verifier. ctl_vars: the table's CtlCheckVars on these openings."""
    ops = HostExtOps()
    l_0, l_last = eval_l_0_and_l_last(degree_bits, zeta)
    last = fs.inverse(fs.primitive_root_of_unity(degree_bits))
    z_last = fs.ext_sub(zeta, fs.ext_from_base(last, 2))
    consumer = ConstraintConsumer(
        ops, [fs.ext_from_base(a, 2) for a in alphas], z_last, l_0, l_last)
    frame = StarkFrame(
        opening_set.local_values,
        opening_set.next_values,
        [fs.ext_from_base(pi, 2) for pi in public_inputs],
    )
    lookup_vars = None
    if lookup_challenges is not None:
        lookup_vars = LookupCheckVars(
            (opening_set.auxiliary_polys or [])[:num_lookup_columns],
            (opening_set.auxiliary_polys_next or [])[:num_lookup_columns],
            [fs.ext_from_base(c, 2) for c in lookup_challenges],
        )
    eval_vanishing_poly(ops, stark, frame, consumer, lookup_vars, ctl_vars)
    return consumer.accumulators()
