"""The extension-field division generator (reference
gadgets/arithmetic_extension.rs; the reference package's
gadgets/extension_arithmetic.py:28). The builder's extension gadgets
are not ported yet (ROADMAP item 28)."""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.iop.generator import SimpleGenerator


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
