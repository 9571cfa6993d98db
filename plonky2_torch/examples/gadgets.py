"""One circuit over the builder's whole gadget surface: boolean logic,
extension inner products and division, the extension algebra, polynomial
evaluation, Frobenius, the generalized select, random access over verifier
data, base-B splits, and `split_low_high` beside the other witness-plan
families (arithmetic, Poseidon, random access, splits, exponentiation,
inverse, equality).

Each case is a function `case(builder, kinds) -> inputs` that adds its
gadgets and public inputs to `builder` and returns the (target, value)
pairs that its witness needs; `kinds` names the package's
`PolynomialCoeffsExtTarget`, `PolynomialCoeffsExtAlgebraTarget` and
`VerifierCircuitTarget`, so the same case runs on another builder with the
same surface. `circuit(device)` makes the cases of CIRCUIT_CASES in one
circuit at the full-width `standard_recursion_config`.

    python -m plonky2_torch.examples.gadgets        # build, prove, verify on the card
"""

from __future__ import annotations

import types

import numpy as np

from plonky2_torch.field import scalar as fs


def _ext_values(seed: int, n: int) -> list[tuple[int, int]]:
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(0, fs.P, 2, dtype=np.uint64))
            for _ in range(n)]


def bool_logic(b, kinds) -> list:
    t = b.add_virtual_bool_target_safe()
    f = b.add_virtual_bool_target_safe()
    outs = [b.and_(t, f), b.or_(t, f), b.not_(t), b.not_(f), b.and_(t, t), b.or_(f, f)]
    b.register_public_inputs([o.target for o in outs])
    b.register_public_input(b.if_(t, b.constant(77), b.constant(33)))
    b.register_public_input(b.if_(f, b.constant(77), b.constant(33)))
    b.register_public_input(b.cube(b.constant(5)))
    return [(t.target, 1), (f.target, 0)]


def ext_inner_product(b, kinds) -> list:
    a, bb, c, d, e = _ext_values(1, 5)
    wide = b.wide_arithmetic_extension(*(b.constant_extension(v) for v in (a, bb, c, d, e)))
    div_add = b.div_add_extension(b.constant_extension(a), b.constant_extension(bb),
                                  b.constant_extension(c))
    sms = b.scalar_mul_sub_extension(b.constant(7), b.constant_extension(a),
                                     b.constant_extension(c))
    b.register_public_inputs(list(wide.parts) + list(div_add.parts) + list(sms.parts))
    return []


def ext_algebra(b, kinds) -> list:
    vals = _ext_values(2, 4)
    ct = [b.constant_extension(v) for v in vals]
    out = b.mul_ext_algebra(ct[:2], ct[2:])
    b.register_public_inputs([t for et in out for t in et.parts])
    return []


def polynomial_eval(b, kinds) -> list:
    *coeffs, z = _ext_values(3, 6)
    poly = kinds.PolynomialCoeffsExtTarget([b.constant_extension(c) for c in coeffs])
    ev = poly.eval(b, b.constant_extension(z))
    ev_s = poly.eval_scalar(b, b.constant(12345))
    b.register_public_inputs(list(ev.parts) + list(ev_s.parts))
    alg = kinds.PolynomialCoeffsExtAlgebraTarget(
        [[b.constant_extension(c), b.constant_extension((0, 0))] for c in coeffs])
    ev_a = alg.eval_scalar(b, b.constant_extension(z))
    b.register_public_inputs(list(ev_a[0].parts))
    return []


def frobenius(b, kinds) -> list:
    (x,) = _ext_values(4, 1)
    fr = b.frobenius_ext(b.constant_extension(x))
    fr2 = b.repeated_frobenius_ext(b.constant_extension(x), 2)
    b.register_public_inputs(list(fr.parts) + list(fr2.parts))
    return []


def select_and_random_access(b, kinds) -> list:
    x, y = _ext_values(5, 2)
    s1 = b.select_ext_generalized(b.one_extension(), b.constant_extension(x),
                                  b.constant_extension(y))
    s0 = b.select_ext_generalized(b.zero_extension(), b.constant_extension(x),
                                  b.constant_extension(y))
    b.register_public_inputs(list(s1.parts) + list(s0.parts))

    def fake_vk(tag):
        cap = [[b.constant(tag * 100 + i * 4 + j) for j in range(4)] for i in range(2)]
        return kinds.VerifierCircuitTarget(
            constants_sigmas_cap=cap, circuit_digest=[b.constant(tag * 1000 + j)
                                                      for j in range(4)])

    sel = b.random_access_verifier_data(b.constant(1), [fake_vk(1), fake_vk(2)])
    b.register_public_inputs(sel.circuit_digest)
    b.register_public_inputs(sel.constants_sigmas_cap[0])
    return []


def split_le_base(b, kinds) -> list:
    """8 base-4 limbs of 16 bits: a BaseSumGate<4>, which no registry tag
    covers, so this case's common data has no bytes."""
    x = b.add_virtual_target()
    b.register_public_inputs(b.split_le_base(x, 8, 4))
    return [(x, 0b1101100111000110)]


def split_le_base2(b, kinds) -> list:
    """The same 16 bits as 16 base-2 limbs (a BaseSumGate<2>)."""
    x = b.add_virtual_target()
    b.register_public_inputs(b.split_le_base(x, 16, 2))
    return [(x, 0b1101100111000110)]


def witness_families(b, kinds) -> list:
    """The witness plan's families around `split_low_high` (the reference
    package's tests/test_witness_plan.py `_rich_circuit`), with the
    builder's constants, add_many, mul_many and constant hash and cap."""
    x = b.add_virtual_target()
    xe = b.convert_to_ext(x)
    y = b.mul_add(x, x, b.constant(5))
    ye = b.mul_extension(xe, xe)
    ze = b.add_extension(ye, b.mul_extension(xe, ye))
    qe = b.div_extension(ze, ye)
    h = b.hash_n_to_hash_no_pad([x, y] * 5)
    arr = [b.constant(10 + i) for i in range(8)]
    ra = b.random_access(b.constant(3), arr)
    lo, hi = b.split_low_high(y, 12, 64)
    bits = b.split_le(ra, 8)
    e = b.exp_u64(x, 13)
    inv = b.inverse(y)
    eq = b.is_equal(x, y)
    s = b.add_many([h[0], ra, lo, hi, e, inv, eq.target, qe.parts[0], bits[0].target])
    b.register_public_input(s)
    b.register_public_inputs([lo, hi])
    cs = b.constants([3, 5, 7])
    b.register_public_input(b.mul_many([x] + cs))
    cap = b.constant_merkle_cap([[1, 2, 3, 4], [5, 6, 7, 8]])
    b.connect_hashes(cap[1], b.constant_hash([5, 6, 7, 8]))
    b.register_public_input(b.add_many([t for d in cap for t in d]))
    return [(x, 12345)]


CASES = {
    "bool_logic": bool_logic,
    "ext_inner_product": ext_inner_product,
    "ext_algebra": ext_algebra,
    "polynomial_eval": polynomial_eval,
    "frobenius": frobenius,
    "select_and_random_access": select_and_random_access,
    "split_le_base": split_le_base,
    "split_le_base2": split_le_base2,
    "witness_families": witness_families,
}
# the cases of the one circuit: every case whose gates have registry tags
CIRCUIT_CASES = [name for name in CASES if name != "split_le_base"]


def port_kinds():
    from plonky2_torch.gadgets import algebra_gadgets as ag
    from plonky2_torch.recursion.recursive_verifier import VerifierCircuitTarget

    return types.SimpleNamespace(
        PolynomialCoeffsExtTarget=ag.PolynomialCoeffsExtTarget,
        PolynomialCoeffsExtAlgebraTarget=ag.PolynomialCoeffsExtAlgebraTarget,
        VerifierCircuitTarget=VerifierCircuitTarget)


def add_cases(builder, kinds, names=None) -> list:
    """The cases named (by default CIRCUIT_CASES) on one builder, in that
    order; their witness inputs."""
    inputs = []
    for name in names or CIRCUIT_CASES:
        inputs += CASES[name](builder, kinds)
    return inputs


def circuit(device=None, names=None):
    """The gadgets circuit at standard_recursion_config, built on `device`
    (CUDA unless the caller asks for another). Returns (CircuitData,
    PartialWitness)."""
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.plonk.config import CircuitConfig

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    inputs = add_cases(builder, port_kinds(), names)
    data = builder.build(device=device)
    pw = PartialWitness()
    for t, v in inputs:
        pw.set_target(t, v)
    return data, pw


def main(device=None):
    data, pw = circuit(device)
    proof = data.prove(pw, device=device)
    data.verify(proof)
    print(f"gadgets circuit: 2^{data.common.degree_bits} rows, "
          f"{len(proof.public_inputs)} public inputs, verified")


if __name__ == "__main__":
    main()
