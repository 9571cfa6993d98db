"""The builder's boolean logic, extension-algebra ops, in-circuit
polynomial evaluation, Frobenius, vectorized random access and base-B
splits (the reference package's gadgets/algebra_gadgets.py). Each method
makes its ops in the reference's order: the op slots, and so the bytes,
depend on it.

Reference: gadgets/arithmetic.rs:36-361 (cube, not/and/or/_if),
gadgets/arithmetic_extension.rs:171-510 (inner products, ext-algebra ops,
div_add), iop/ext_target.rs:31-75 (frobenius), gadgets/select.rs:22-30,
gadgets/random_access.rs:76-120, gadgets/polynomial.rs,
gadgets/split_base.rs:22-29 (split_le_base via BaseSumGate).

An ExtensionAlgebra element is represented as a list of D ExtensionTargets
(the reference's ExtensionAlgebraTarget), matching gates/ops.py's
get_local_ext_algebra convention.
"""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.gadgets.extension_arithmetic import QuotientGeneratorExtension
from plonky2_torch.gadgets.reducing import ReducingFactorTarget
from plonky2_torch.gates.base_sum import WIRE_SUM, BaseSumGate
from plonky2_torch.iop.target import BoolTarget, ExtensionTarget, Target, Wire

D = 2


class AlgebraGadgetsMixin:
    # -- boolean logic (reference gadgets/arithmetic.rs:339-361) -------------

    def not_(self, b: BoolTarget) -> BoolTarget:
        return BoolTarget(self.sub(self.one(), b.target))

    def and_(self, b1: BoolTarget, b2: BoolTarget) -> BoolTarget:
        return BoolTarget(self.mul(b1.target, b2.target))

    def or_(self, b1: BoolTarget, b2: BoolTarget) -> BoolTarget:
        # b1 + b2 - b1*b2
        res_minus_b2 = self.arithmetic(fs.P - 1, 1, b1.target, b2.target, b1.target)
        return BoolTarget(self.add(res_minus_b2, b2.target))

    def if_(self, b: BoolTarget, x: Target, y: Target) -> Target:
        """b ? x : y (reference `_if`)."""
        not_b = self.not_(b)
        maybe_x = self.mul(b.target, x)
        return self.mul_add(not_b.target, y, maybe_x)

    def cube(self, x: Target) -> Target:
        return self.mul_many([x, x, x])

    # -- extension inner products (arithmetic_extension.rs:171-194) ----------

    def inner_product_extension(self, constant: int, starting_acc: ExtensionTarget,
                                pairs) -> ExtensionTarget:
        """sum_{(a,b)} constant * a * b + starting_acc."""
        acc = starting_acc
        for a, b in pairs:
            acc = self.arithmetic_extension(constant, 1, a, b, acc)
        return acc

    def wide_arithmetic_extension(self, a, b, c, d, e) -> ExtensionTarget:
        """a*b + c*d + e."""
        return self.inner_product_extension(1, e, [(a, b), (c, d)])

    def scalar_mul_sub_extension(self, a: Target, b: ExtensionTarget,
                                 c: ExtensionTarget) -> ExtensionTarget:
        """a*b - c with base-field a."""
        a_ext = self.convert_to_ext(a)
        return self.arithmetic_extension(1, fs.P - 1, a_ext, b, c)

    def div_add_extension(self, x: ExtensionTarget, y: ExtensionTarget,
                          z: ExtensionTarget) -> ExtensionTarget:
        """x/y + z (reference arithmetic_extension.rs:491-510)."""
        inv = self.add_virtual_extension_target()
        one = self.one_extension()
        self.add_simple_generator(QuotientGeneratorExtension(one, y, inv))
        y_inv = self.mul_extension(y, inv)
        self.connect_extension(y_inv, one)
        return self.mul_add_extension(x, inv, z)

    # -- extension algebra (lists of D ExtensionTargets) ---------------------

    def zero_ext_algebra(self) -> list:
        return [self.zero_extension() for _ in range(D)]

    def add_ext_algebra(self, a: list, b: list) -> list:
        return [self.add_extension(a[i], b[i]) for i in range(D)]

    def sub_ext_algebra(self, a: list, b: list) -> list:
        return [self.sub_extension(a[i], b[i]) for i in range(D)]

    def mul_add_ext_algebra(self, a: list, b: list, c: list) -> list:
        """a*b + c in F[X]/(X^D - W) over the extension field
        (reference arithmetic_extension.rs:278-306)."""
        w = fs.EXT_W[D]
        inner = [[] for _ in range(D)]
        inner_w = [[] for _ in range(D)]
        for i in range(D):
            for j in range(D - i):
                inner[(i + j) % D].append((a[i], b[j]))
            for j in range(D - i, D):
                inner_w[(i + j) % D].append((a[i], b[j]))
        res = []
        for pairs_w, pairs, ci in zip(inner_w, inner, c):
            acc = self.inner_product_extension(w, ci, pairs_w)
            res.append(self.inner_product_extension(1, acc, pairs))
        return res

    def mul_ext_algebra(self, a: list, b: list) -> list:
        return self.mul_add_ext_algebra(a, b, self.zero_ext_algebra())

    def scalar_mul_add_ext_algebra(self, a: ExtensionTarget, b: list,
                                   c: list) -> list:
        return [self.mul_add_extension(a, b[i], c[i]) for i in range(D)]

    def scalar_mul_ext_algebra(self, a: ExtensionTarget, b: list) -> list:
        return self.scalar_mul_add_ext_algebra(a, b, self.zero_ext_algebra())

    # -- select / frobenius ---------------------------------------------------

    def select_ext_generalized(self, b: ExtensionTarget, x: ExtensionTarget,
                               y: ExtensionTarget) -> ExtensionTarget:
        """b*x + (1-b)*y for an extension-valued (not necessarily boolean) b
        (reference gadgets/select.rs:22-30)."""
        tmp = self.mul_sub_extension(b, y, y)
        return self.mul_sub_extension(b, x, tmp)

    def frobenius_ext(self, x: ExtensionTarget) -> ExtensionTarget:
        return self.repeated_frobenius_ext(x, 1)

    def repeated_frobenius_ext(self, x: ExtensionTarget, count: int) -> ExtensionTarget:
        """x^(p^count) via the W-power twist (reference iop/ext_target.rs:31-75)."""
        if count % D == 0:
            return x
        count %= D
        k = (fs.P - 1) // D
        z0 = fs.exp(fs.EXT_W[D], k * count)
        z = 1
        parts = []
        for i in range(D):
            parts.append(self.mul_const(z, x.parts[i]))
            z = fs.mul(z, z0)
        return ExtensionTarget(tuple(parts))

    def neg_one_extension(self) -> ExtensionTarget:
        return self.constant_extension((fs.P - 1, 0))

    def constant_ext_algebra(self, values) -> list:
        """values: D extension values -> [D] ExtensionTargets."""
        return [self.constant_extension(v) for v in values]

    def convert_to_ext_algebra(self, et: ExtensionTarget) -> list:
        """Lift an extension element to the algebra: [et, 0, ..]
        (reference ext_target.rs convert_to_ext_algebra)."""
        return [et] + [self.zero_extension() for _ in range(D - 1)]

    def flatten_target(self, ets) -> list:
        """[ExtensionTarget] -> flat base Targets (reference flatten_target)."""
        return [t for et in ets for t in et.parts]

    def unflatten_target(self, ts) -> list:
        if len(ts) % D:
            raise ValueError(f"{len(ts)} targets do not split into extension targets")
        return [ExtensionTarget(tuple(ts[i:i + D])) for i in range(0, len(ts), D)]

    def connect_merkle_caps(self, a, b) -> None:
        if len(a) != len(b):
            raise ValueError("Merkle caps of different lengths")
        for da, db in zip(a, b):
            self.connect_array(da, db)

    def connect_verifier_data(self, a, b) -> None:
        self.connect_array(a.circuit_digest, b.circuit_digest)
        self.connect_merkle_caps(a.constants_sigmas_cap, b.constants_sigmas_cap)

    # -- vectorized random access (gadgets/random_access.rs:76-120) ----------

    def random_access_merkle_cap(self, access_index: Target, caps: list) -> list:
        """caps: list of MerkleCapTargets (each a list of 4-target digests)."""
        cap_size = len(caps[0])
        if any(len(c) != cap_size for c in caps):
            raise ValueError("Merkle caps of different lengths")
        return [
            self.random_access_hash(access_index, [c[i] for c in caps])
            for i in range(cap_size)
        ]

    def random_access_verifier_data(self, access_index: Target, vks: list):
        from plonky2_torch.recursion.recursive_verifier import VerifierCircuitTarget

        return VerifierCircuitTarget(
            constants_sigmas_cap=self.random_access_merkle_cap(
                access_index, [vk.constants_sigmas_cap for vk in vks]),
            circuit_digest=self.random_access_hash(
                access_index, [vk.circuit_digest for vk in vks]),
        )

    # -- base-B decomposition (gadgets/split_base.rs:22-29) ------------------

    def split_le_base(self, x: Target, num_limbs: int, base: int = 2) -> list:
        """Little-endian base-B limbs of x via a BaseSumGate; range-checks
        each limb by the gate's constraints."""
        gate = BaseSumGate(num_limbs, base)
        row = self.add_gate(gate, [])
        self.connect(x, Wire(row, WIRE_SUM))
        return [Wire(row, c) for c in gate.limbs()]


class PolynomialCoeffsExtTarget:
    """Polynomial with ExtensionTarget coefficients (ascending); in-circuit
    evaluation (reference gadgets/polynomial.rs:14-44)."""

    def __init__(self, coeffs: list):
        self.coeffs = list(coeffs)

    def eval_scalar(self, builder, point: Target) -> ExtensionTarget:
        pt = ReducingFactorTarget(builder.convert_to_ext(point))
        return pt.reduce(self.coeffs, builder)

    def eval(self, builder, point: ExtensionTarget) -> ExtensionTarget:
        pt = ReducingFactorTarget(point)
        return pt.reduce(self.coeffs, builder)


class PolynomialCoeffsExtAlgebraTarget:
    """Polynomial with ExtensionAlgebra coefficients
    (reference gadgets/polynomial.rs:46-95)."""

    def __init__(self, coeffs: list):
        self.coeffs = list(coeffs)  # each a list of D ExtensionTargets

    def eval_scalar(self, builder, point: ExtensionTarget) -> list:
        acc = builder.zero_ext_algebra()
        for c in reversed(self.coeffs):
            acc = builder.scalar_mul_add_ext_algebra(point, acc, c)
        return acc

    def eval(self, builder, point: list) -> list:
        acc = builder.zero_ext_algebra()
        for c in reversed(self.coeffs):
            acc = builder.add_ext_algebra(builder.mul_ext_algebra(point, acc), c)
        return acc

    def eval_with_powers(self, builder, powers: list) -> list:
        if len(self.coeffs) != len(powers) + 1:
            raise ValueError("eval_with_powers needs one power fewer than coefficients")
        acc = self.coeffs[0]
        for c, p in zip(self.coeffs[1:], powers):
            acc = builder.add_ext_algebra(builder.mul_ext_algebra(c, p), acc)
        return acc
