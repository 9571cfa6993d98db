"""ReducingFactorTarget: the α-reduction Σ α^i · terms[i] in a circuit, with
the count of terms reduced so far for `shift` (reference
util/reducing.rs:113-260; the reference package's gadgets/reducing.py).

Short reductions are Horner steps on arithmetic slots; long ones are rows
of ReducingGate (base-field terms) or ReducingExtensionGate (extension
terms), `max_coeffs_len` terms a row, the terms zero-padded at the top.
"""

from __future__ import annotations

from plonky2_torch.gadgets.extension_arithmetic import ext_from_range
from plonky2_torch.gates.arithmetic_extension import ArithmeticExtensionGate
from plonky2_torch.gates.reducing import ReducingExtensionGate, ReducingGate
from plonky2_torch.iop.target import ExtensionTarget, Wire


class ReducingFactorTarget:
    def __init__(self, base: ExtensionTarget):
        self.base = base
        self.count = 0

    def _short(self, builder, n: int) -> bool:
        return n <= ArithmeticExtensionGate.new_from_config(builder.config).num_ops + 1

    def reduce_base(self, terms, builder) -> ExtensionTarget:
        """terms: base Targets."""
        terms = list(terms)
        if self._short(builder, len(terms)):
            return self.reduce_arithmetic([builder.convert_to_ext(t) for t in terms], builder)
        width = ReducingGate.max_coeffs_len(builder.config.num_wires,
                                            builder.config.num_routed_wires)
        self.count += len(terms)
        zero = builder.zero()
        acc = builder.zero_extension()
        padded = terms + [zero] * (-len(terms) % width)
        padded.reverse()
        for start in range(0, len(padded), width):
            gate = ReducingGate(width)
            row = builder.add_gate(gate, [])
            builder.connect_extension(self.base, ext_from_range(row, gate.wires_alpha()))
            builder.connect_extension(acc, ext_from_range(row, gate.wires_old_acc()))
            for t, c in zip(padded[start:start + width], gate.wires_coeffs()):
                builder.connect(t, Wire(row, c))
            acc = ext_from_range(row, gate.wires_output())
        return acc

    def reduce(self, terms, builder) -> ExtensionTarget:
        """terms: ExtensionTargets."""
        terms = list(terms)
        if self._short(builder, len(terms)):
            return self.reduce_arithmetic(terms, builder)
        width = ReducingExtensionGate.max_coeffs_len(builder.config.num_wires,
                                                     builder.config.num_routed_wires)
        self.count += len(terms)
        zero_ext = builder.zero_extension()
        acc = zero_ext
        padded = terms + [zero_ext] * (-len(terms) % width)
        padded.reverse()
        for start in range(0, len(padded), width):
            gate = ReducingExtensionGate(width)
            row = builder.add_gate(gate, [])
            builder.connect_extension(self.base, ext_from_range(row, gate.wires_alpha()))
            builder.connect_extension(acc, ext_from_range(row, gate.wires_old_acc()))
            for i, t in enumerate(padded[start:start + width]):
                builder.connect_extension(t, ext_from_range(row, gate.wires_coeff(i)))
            acc = ext_from_range(row, gate.wires_output())
        return acc

    def reduce_arithmetic(self, terms, builder) -> ExtensionTarget:
        self.count += len(terms)
        acc = builder.zero_extension()
        for et in reversed(terms):
            acc = builder.mul_add_extension(self.base, acc, et)
        return acc

    def shift(self, x: ExtensionTarget, builder) -> ExtensionTarget:
        """α^count · x, the count then reset."""
        if self.count == 0:
            return x
        exp = builder.exp_u64_extension(self.base, self.count)
        self.count = 0
        return builder.mul_extension(exp, x)
