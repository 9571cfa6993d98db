"""The builder gadgets of the recursive verifier: bit sums, exponentiation by
bits, random access, Merkle paths and coset interpolation in a circuit
(reference gadgets/{split_base,arithmetic,random_access,interpolation}.rs
and hash/merkle_proofs.rs; the reference package's
gadgets/recursion_gadgets.py:16-233).
"""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.gadgets.extension_arithmetic import ext_from_range
from plonky2_torch.gates.arithmetic_base import ArithmeticGate
from plonky2_torch.gates.arithmetic_extension import ArithmeticExtensionGate
from plonky2_torch.gates.base_sum import START_LIMBS, WIRE_SUM, BaseSumGate
from plonky2_torch.gates.exponentiation import ExponentiationGate
from plonky2_torch.gates.random_access import RandomAccessGate
from plonky2_torch.iop.target import ExtensionTarget, Target, Wire


def _pad_to_power_of_two(v: list) -> list:
    """v with its last element repeated up to the next power of two."""
    n = len(v)
    return v + v[-1:] * ((1 << (n - 1).bit_length()) - n) if n > 1 else v


class RecursionGadgetsMixin:
    """Mixed into CircuitBuilder."""

    def num_base_arithmetic_ops_per_gate(self) -> int:
        if self.config.use_base_arithmetic_gate:
            return ArithmeticGate.new_from_config(self.config).num_ops
        return ArithmeticExtensionGate.new_from_config(self.config).num_ops

    # -- bit sums and exponentiation ------------------------------------------------

    def le_sum(self, bits) -> Target:
        """Σ 2^i · bits[i] (reference gadgets/split_base.rs:38-75): Horner
        steps on arithmetic slots where they fit one gate, else one
        BaseSumGate row."""
        bits = list(bits)
        num_bits = len(bits)
        if num_bits >= 64:
            raise ValueError(f"{num_bits} bits may overflow the field")
        if num_bits == 0:
            return self.zero()
        if num_bits - 1 <= self.num_base_arithmetic_ops_per_gate():
            two = self.two()
            rev = bits[::-1]
            acc = rev[0].target
            for b in rev[1:]:
                acc = self.mul_add(two, acc, b.target)
            return acc
        num_limbs = BaseSumGate.new_from_config(self.config, 2).num_limbs
        row = self.add_gate(BaseSumGate(num_limbs, 2), [])
        for bit, wire in zip(bits, range(START_LIMBS, START_LIMBS + num_limbs)):
            self.connect(bit.target, Wire(row, wire))
        for wire in range(START_LIMBS + num_bits, START_LIMBS + num_limbs):
            self.assert_zero(Wire(row, wire))
        return Wire(row, WIRE_SUM)

    def exp_from_bits(self, base: Target, exponent_bits) -> Target:
        """base^(Σ 2^i · bits[i]) on an ExponentiationGate row, the bits
        padded with false to the gate's width (reference
        gadgets/arithmetic.rs:248-269)."""
        bits = list(exponent_bits)
        gate = ExponentiationGate.new_from_config(self.config)
        while len(bits) < gate.num_power_bits:
            bits.append(self._false())
        row = self.add_gate(gate, [])
        self.connect(base, Wire(row, gate.wire_base()))
        for i, bit in enumerate(bits):
            self.connect(bit.target, Wire(row, gate.wire_power_bit(i)))
        return Wire(row, gate.wire_output())

    def exp_from_bits_const_base(self, base: int, exponent_bits) -> Target:
        """base^(Σ 2^i · bits[i]) for a constant base: one arithmetic op a
        bit, product · (1 + bit · (base^(2^i) - 1)) (reference
        gadgets/arithmetic.rs:280-309)."""
        bits = list(exponent_bits)
        if len(bits) > self.num_base_arithmetic_ops_per_gate():
            return self.exp_from_bits(self.constant(base), bits)
        product = self.one()
        for i, bit in enumerate(bits):
            pow_const = fs.exp(base, 1 << i)
            product = self.arithmetic(fs.sub(pow_const, 1), 1, product, bit.target, product)
        return product

    def exp(self, base: Target, exponent: Target, max_bits: int) -> Target:
        """base^exponent for an exponent target of at most max_bits bits
        (reference gadgets/arithmetic.rs exp)."""
        return self.exp_from_bits(base, self.split_le(exponent, max_bits))

    def exp_extension_from_bits(self, base, exponent_bits) -> ExtensionTarget:
        """base^(Σ 2^i · bits[i]) for an extension base: square and select
        (reference gadgets/arithmetic_extension.rs exp_extension_from_bits)."""
        one = self.one_extension()
        acc, cur = one, base
        for bit in exponent_bits:
            acc = self.mul_extension(acc, self.select_ext(bit, cur, one))
            cur = self.square_extension(cur)
        return acc

    def exp_power_of_2(self, base: Target, k: int) -> Target:
        for _ in range(k):
            base = self.square(base)
        return base

    def assert_leading_zeros(self, x: Target, leading_zeros: int) -> None:
        self.range_check(x, 64 - leading_zeros)

    # -- random access --------------------------------------------------------------

    def random_access(self, access_index: Target, v: list) -> Target:
        """v[access_index] on a RandomAccessGate op slot (reference
        gadgets/random_access.rs:17-52); v is padded to a power of two
        with its last element."""
        v = _pad_to_power_of_two(list(v))
        if len(v) == 1:
            return v[0]
        bits = len(v).bit_length() - 1
        claimed = self.add_virtual_target()
        gate = RandomAccessGate.new_from_config(self.config, bits)
        row, copy = self.find_slot(gate, [], [])
        for i, val in enumerate(v):
            self.connect(val, Wire(row, gate.wire_list_item(i, copy)))
        self.connect(access_index, Wire(row, gate.wire_access_index(copy)))
        self.connect(claimed, Wire(row, gate.wire_claimed_element(copy)))
        return claimed

    def random_access_hash(self, access_index: Target, v: list) -> list[Target]:
        """v: 4-target digests."""
        return [self.random_access(access_index, [h[i] for h in v]) for i in range(4)]

    def random_access_extension(self, access_index: Target, v: list) -> ExtensionTarget:
        v = _pad_to_power_of_two(list(v))
        return ExtensionTarget(tuple(self.random_access(access_index, [et.parts[i] for et in v])
                                     for i in range(2)))

    # -- conditional equality -----------------------------------------------------------

    def conditional_assert_eq(self, cond: Target, x: Target, y: Target) -> None:
        """cond · (x - y) = 0 (reference circuit_builder.rs conditional_assert_eq)."""
        self.assert_zero(self.mul(cond, self.sub(x, y)))

    def conditional_assert_eq_ext(self, cond: Target, x, y) -> None:
        prod = self.mul_extension(self.convert_to_ext(cond), self.sub_extension(x, y))
        self.connect_extension(prod, self.zero_extension())

    # -- Merkle paths ------------------------------------------------------------------

    def verify_merkle_proof_to_cap_with_cap_index(self, leaf_data: list, leaf_index_bits,
                                                  cap_index: Target, merkle_cap_t,
                                                  proof_t) -> None:
        """The leaf's path up to the cap entry `cap_index`: one swapped
        permutation a sibling (reference hash/merkle_proofs.rs:144-183)."""
        zero = self.zero()
        state = self.hash_or_noop(leaf_data)
        for bit, sibling in zip(leaf_index_bits, proof_t.siblings):
            state = self.permute_swapped(list(state) + list(sibling) + [zero] * 4, bit)[:4]
        for i in range(4):
            result = self.random_access(cap_index, [h[i] for h in merkle_cap_t])
            self.connect(result, state[i])

    def verify_merkle_proof_to_cap_with_cap_indices(
            self, condition: Target, leaf_data: list, leaf_index_bits, min_log_n: int,
            max_log_n: int, n_index: Target, cap_index: Target, merkle_cap_t,
            proof_t) -> None:
        """A path of a tree of any height 2^min_log_n..2^max_log_n: every
        sibling of the tallest path is compressed in, a shift register
        keeps the last max - min + 1 digests, the one at n_index (the
        tree's height) is selected and, where `condition` is 1, compared
        with the cap entry at cap_index (reference
        hash/merkle_proofs.rs:186-239)."""
        zero = self.zero()
        state = self.hash_or_noop(leaf_data)
        final_states = [state] * (max_log_n - min_log_n + 1)
        for bit, sibling in zip(leaf_index_bits, proof_t.siblings):
            state = self.permute_swapped(list(state) + list(sibling) + [zero] * 4, bit)[:4]
            final_states = final_states[1:] + [state]
        for i in range(4):
            result = self.random_access(cap_index, [h[i] for h in merkle_cap_t])
            selected = self.random_access(n_index, [s[i] for s in final_states])
            self.conditional_assert_eq(condition, result, selected)

    def verify_batch_merkle_proof_to_cap_with_cap_index(
            self, leaf_data: list, leaf_heights: list[int], leaf_index_bits,
            cap_index: Target, merkle_cap_t, proof_t) -> None:
        """A `BatchMerkleTree` path: each shorter matrix's row is hashed in
        with the running digest where the walk reaches its height
        (reference hash/merkle_proofs.rs:243-296)."""
        zero = self.zero()
        state = self.hash_or_noop(list(leaf_data[0]))
        height = leaf_heights[0]
        data_index = 1
        for bit, sibling in zip(leaf_index_bits, proof_t.siblings):
            state = self.permute_swapped(list(state) + list(sibling) + [zero] * 4, bit)[:4]
            height -= 1
            if data_index < len(leaf_heights) and height == leaf_heights[data_index]:
                state = self.hash_or_noop(list(state) + list(leaf_data[data_index]))
                data_index += 1
        for i in range(4):
            result = self.random_access(cap_index, [h[i] for h in merkle_cap_t])
            self.connect(result, state[i])

    # -- coset interpolation ------------------------------------------------------------

    def interpolate_coset(self, gate, coset_shift: Target, values,
                          evaluation_point: ExtensionTarget) -> ExtensionTarget:
        """The interpolant of `values` on the coset shift · <ω> at the
        point, on one CosetInterpolationGate row (reference
        gadgets/interpolation.rs:15-38)."""
        row = self.num_gates()
        self.connect(coset_shift, Wire(row, gate.wire_shift()))
        for i, v in enumerate(values):
            self.connect_extension(v, ext_from_range(row, gate.wires_value(i)))
        self.connect_extension(evaluation_point,
                               ext_from_range(row, gate.wires_evaluation_point()))
        eval_t = ext_from_range(row, gate.wires_evaluation_value())
        self.add_gate(gate, [])
        return eval_t
