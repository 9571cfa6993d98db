"""Extension-field (D = 2) arithmetic on builder targets (reference
gadgets/arithmetic_extension.rs; the reference package's
gadgets/extension_arithmetic.py:28-246).

An ExtensionTarget is a pair of base targets. Every op goes through
`arithmetic_extension`: folded where its operands are constants, shared
where the same op was made before, else one op slot of an
ArithmeticExtensionGate (or of a MulExtensionGate where the addend is the
constant zero). The division's quotient comes from its generator and is
checked by one multiplication.
"""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.arithmetic_extension import ArithmeticExtensionGate, MulExtensionGate
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import ExtensionTarget, Target, Wire

D = 2


def ext_from_range(row: int, rng: range) -> ExtensionTarget:
    """The extension target on the wires `rng` of `row`."""
    return ExtensionTarget(tuple(Wire(row, w) for w in rng))


class QuotientGeneratorExtension(SimpleGenerator):
    """quotient = numerator / denominator in F_{p^2}."""

    def __init__(self, numerator, denominator, quotient):
        self.numerator = numerator
        self.denominator = denominator
        self.quotient = quotient

    def dependencies(self):
        return list(self.numerator.parts) + list(self.denominator.parts)

    def outputs(self):
        return list(self.quotient.parts)

    def run_once(self, witness, out):
        num = witness.get_extension_target(self.numerator)
        den = witness.get_extension_target(self.denominator)
        out.set_extension_target(self.quotient, fs.ext_div(num, den))


class ExtensionArithmeticMixin:
    """Mixed into CircuitBuilder; uses its constant, connect, find_slot,
    add_simple_generator and targets_to_constants."""

    # -- constants and conversions ------------------------------------------------

    def constant_extension(self, c) -> ExtensionTarget:
        c = fs.ext_from_base(c, D) if isinstance(c, int) else tuple(c)
        return ExtensionTarget(tuple(self.constant(x) for x in c))

    def zero_extension(self) -> ExtensionTarget:
        return self.constant_extension(0)

    def one_extension(self) -> ExtensionTarget:
        return self.constant_extension(1)

    def convert_to_ext(self, t: Target) -> ExtensionTarget:
        return ExtensionTarget((t, self.zero()))

    def connect_extension(self, a: ExtensionTarget, b: ExtensionTarget) -> None:
        for x, y in zip(a.parts, b.parts):
            self.connect(x, y)

    def target_as_constant_ext(self, t: ExtensionTarget):
        cs = tuple(self.target_as_constant(x) for x in t.parts)
        return None if None in cs else cs

    # -- the slot op ----------------------------------------------------------------

    def arithmetic_extension(self, const_0: int, const_1: int, m0: ExtensionTarget,
                             m1: ExtensionTarget, addend: ExtensionTarget) -> ExtensionTarget:
        """const_0 · m0 · m1 + const_1 · addend over F_{p^2}."""
        const_0 %= fs.P
        const_1 %= fs.P
        special = self._arithmetic_extension_special_cases(const_0, const_1, m0, m1, addend)
        if special is not None:
            return special
        key = ("ext", const_0, const_1, m0, m1, addend)
        if key not in self.base_arithmetic_results:
            if self.target_as_constant_ext(addend) == fs.ext_zero(D):
                result = self._compute_mul_extension_operation(const_0, m0, m1)
            else:
                result = self._compute_arithmetic_extension_operation(const_0, const_1, m0,
                                                                      m1, addend)
            self.base_arithmetic_results[key] = result
        return self.base_arithmetic_results[key]

    def _compute_arithmetic_extension_operation(self, const_0, const_1, m0, m1, addend):
        gate = ArithmeticExtensionGate.new_from_config(self.config)
        constants = [const_0, const_1]
        row, i = self.find_slot(gate, constants, constants)
        self.connect_extension(m0, ext_from_range(row, gate.wires_ith_multiplicand_0(i)))
        self.connect_extension(m1, ext_from_range(row, gate.wires_ith_multiplicand_1(i)))
        self.connect_extension(addend, ext_from_range(row, gate.wires_ith_addend(i)))
        return ext_from_range(row, gate.wires_ith_output(i))

    def _compute_mul_extension_operation(self, const_0, m0, m1):
        gate = MulExtensionGate.new_from_config(self.config)
        constants = [const_0]
        row, i = self.find_slot(gate, constants, constants)
        self.connect_extension(m0, ext_from_range(row, gate.wires_ith_multiplicand_0(i)))
        self.connect_extension(m1, ext_from_range(row, gate.wires_ith_multiplicand_1(i)))
        return ext_from_range(row, gate.wires_ith_output(i))

    def _arithmetic_extension_special_cases(self, const_0, const_1, m0, m1, addend):
        """The folds of reference gadgets/arithmetic_extension.rs (the
        reference package's extension_arithmetic.py:121-154)."""
        zero, one = fs.ext_zero(D), fs.ext_one(D)
        m0_const = self.target_as_constant_ext(m0)
        m1_const = self.target_as_constant_ext(m1)
        addend_const = self.target_as_constant_ext(addend)
        first_term_zero = const_0 == 0 or m0_const == zero or m1_const == zero
        second_term_zero = const_1 == 0 or addend_const == zero
        if first_term_zero:
            first_term_const = zero
        elif m0_const is not None and m1_const is not None:
            first_term_const = fs.ext_scalar_mul(const_0, fs.ext_mul(m0_const, m1_const))
        else:
            first_term_const = None
        if second_term_zero:
            second_term_const = zero
        elif addend_const is not None:
            second_term_const = fs.ext_scalar_mul(const_1, addend_const)
        else:
            second_term_const = None
        if first_term_const is not None and second_term_const is not None:
            return self.constant_extension(fs.ext_add(first_term_const, second_term_const))
        if first_term_zero and const_1 == 1:
            return addend
        if second_term_zero:
            if m0_const is not None and fs.ext_scalar_mul(const_0, m0_const) == one:
                return m1
            if m1_const is not None and fs.ext_scalar_mul(const_0, m1_const) == one:
                return m0
        return None

    # -- derived ops ------------------------------------------------------------------

    def add_extension(self, a, b) -> ExtensionTarget:
        return self.arithmetic_extension(1, 1, a, self.one_extension(), b)

    def sub_extension(self, a, b) -> ExtensionTarget:
        return self.arithmetic_extension(1, fs.P - 1, a, self.one_extension(), b)

    def mul_extension_with_const(self, const_0: int, a, b) -> ExtensionTarget:
        return self.arithmetic_extension(const_0, 0, a, b, self.zero_extension())

    def mul_extension(self, a, b) -> ExtensionTarget:
        return self.mul_extension_with_const(1, a, b)

    def square_extension(self, x) -> ExtensionTarget:
        return self.mul_extension(x, x)

    def mul_add_extension(self, a, b, c) -> ExtensionTarget:
        return self.arithmetic_extension(1, 1, a, b, c)

    def mul_sub_extension(self, a, b, c) -> ExtensionTarget:
        return self.arithmetic_extension(1, fs.P - 1, a, b, c)

    def add_const_extension(self, x, c: int) -> ExtensionTarget:
        return self.add_extension(x, self.constant_extension(c % fs.P))

    def mul_const_extension(self, c: int, x) -> ExtensionTarget:
        one = self.one_extension()
        return self.arithmetic_extension(c % fs.P, 0, x, one, self.zero_extension())

    def scalar_mul_add_extension(self, a: Target, b: ExtensionTarget,
                                 c: ExtensionTarget) -> ExtensionTarget:
        return self.arithmetic_extension(1, 1, self.convert_to_ext(a), b, c)

    def exp_power_of_2_extension(self, x, k: int) -> ExtensionTarget:
        for _ in range(k):
            x = self.square_extension(x)
        return x

    def exp_u64_extension(self, x, e: int) -> ExtensionTarget:
        """x^e for a constant e, square and multiply from the low bit."""
        result = self.one_extension()
        b = x
        while e > 0:
            if e & 1:
                result = self.mul_extension(result, b)
            e >>= 1
            if e:
                b = self.square_extension(b)
        return result

    def div_extension(self, num, den) -> ExtensionTarget:
        """num / den: the quotient from its generator, held by
        quotient · den = num."""
        quotient = self.add_virtual_extension_target()
        self.add_simple_generator(QuotientGeneratorExtension(num, den, quotient))
        self.connect_extension(self.mul_extension(quotient, den), num)
        return quotient

    def inverse_extension(self, x) -> ExtensionTarget:
        return self.div_extension(self.one_extension(), x)

    def select_ext(self, b, x, y) -> ExtensionTarget:
        """b ? x : y with a BoolTarget b."""
        return self.mul_add_extension(self.convert_to_ext(b.target), self.sub_extension(x, y), y)
