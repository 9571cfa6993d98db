"""The circuit builder (reference plonk/circuit_builder.rs:141-1348; the
reference package's plonk/circuit_builder.py).

Every choice that reaches the bytes follows the reference in its order: the
virtual-target numbering, the gate rows and the op slots `find_slot`
hands out, the generators' registration order (which fixes the order of
the rng draws of `RandomValueGenerator`), the constants sorted by value,
the gates sorted by (degree, id), the selector groups, the sigma cycles and
the circuit digest. `build` commits the constants and sigmas on the build's
device (CUDA unless the caller asks for another) and keeps that commitment
for the proves there. The gadgets of the in-circuit verifier are mixed in
from `gadgets/`: the extension arithmetic, the extension algebra and the
recursion gadgets, and the rest of the reference's gadget surface
(`gadgets/algebra_gadgets.py`). A builder of a cyclic circuit carries its own verifier
data's public-input targets (`verifier_data_public_input`) and the common
data its build must give (`goal_common_data`, checked at the end of
`build`). Lookups come from `gadgets/lookup.py` (LUTs, lookups into them);
the build places their gates after the public-input gate and adds the
lookup selector columns between the gate selectors and the gate
constants. Under a zero-knowledge config the build adds the reference's
blinding rows before padding (`_blind`).
"""

from __future__ import annotations

import numpy as np

from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.oracle import PolynomialBatch
from plonky2_torch.gadgets.algebra_gadgets import AlgebraGadgetsMixin
from plonky2_torch.gadgets.extension_arithmetic import ExtensionArithmeticMixin
from plonky2_torch.gadgets.lookup import LookupMixin
from plonky2_torch.gadgets.recursion_gadgets import RecursionGadgetsMixin
from plonky2_torch.gates.arithmetic_base import ArithmeticGate
from plonky2_torch.gates.gate import UNUSED_SELECTOR
from plonky2_torch.gates.lookup import LookupGate
from plonky2_torch.gates.poseidon_gate import PoseidonGate
from plonky2_torch.gates.simple_gates import ConstantGate, NoopGate, PublicInputGate
from plonky2_torch.iop.generator import ConstantGenerator, CopyGenerator, RandomValueGenerator
from plonky2_torch.iop.target import (
    BoolTarget,
    ExtensionTarget,
    Target,
    VirtualTarget,
    Wire,
    is_routable,
)
from plonky2_torch.ops import ntt as kn
from plonky2_torch.plonk import config as pcfg
from plonky2_torch.plonk.circuit_data import (
    CircuitData,
    CommonCircuitData,
    ProverOnlyCircuitData,
    SelectorsInfo,
    VerifierOnlyCircuitData,
)
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.plonk.permutation_argument import Forest
from plonky2_torch.util import TimingTree, log2_strict

D = 2


class GateInstance:
    __slots__ = ("gate", "constants")

    def __init__(self, gate, constants):
        self.gate = gate
        self.constants = constants


class CircuitBuilder(ExtensionArithmeticMixin, AlgebraGadgetsMixin, RecursionGadgetsMixin,
                     LookupMixin):
    def __init__(self, config: CircuitConfig | None = None, gc=None):
        self.gc = pcfg.check_generic_config(gc)
        self.config = config or CircuitConfig.standard_recursion_config()
        self.gate_instances: list[GateInstance] = []
        self.gates: dict[str, object] = {}  # id -> gate, in first-use order
        self.copy_constraints: list[tuple[Target, Target]] = []
        self.generators: list = []
        self.public_inputs: list[Target] = []
        self.virtual_target_index = 0
        self.constants_to_targets: dict[int, Target] = {}
        self.targets_to_constants: dict[Target, int] = {}
        self.constant_generators: list[ConstantGenerator] = []
        self.base_arithmetic_results: dict[tuple, Target] = {}
        # op-slot batching: gate id -> {params: (row, next free op)}
        self.current_slots: dict[str, dict[tuple, tuple[int, int]]] = {}
        # cyclic recursion (reference circuit_builder.rs:429, 1284)
        self.verifier_data_public_input = None
        self.goal_common_data = None
        self.blinding = (0, 0)  # the blinding rows and Z pairs that build() added
        # lookups (gadgets/lookup.py): the LUTs, each LUT's region of rows
        # and each LUT's (looking in, looking out) pairs
        self.luts: list = []
        self.lookup_rows: list = []
        self.lut_to_lookups: list = []
        self.domain_separator = None

    # -- targets --------------------------------------------------------------

    def add_virtual_target(self) -> Target:
        t = VirtualTarget(self.virtual_target_index)
        self.virtual_target_index += 1
        return t

    def add_virtual_targets(self, n: int) -> list[Target]:
        return [self.add_virtual_target() for _ in range(n)]

    def add_virtual_bool_target_safe(self) -> BoolTarget:
        b = BoolTarget(self.add_virtual_target())
        self.assert_bool(b)
        return b

    def add_virtual_bool_target_unsafe(self) -> BoolTarget:
        return BoolTarget(self.add_virtual_target())

    def add_virtual_hash(self) -> list[Target]:
        return self.add_virtual_targets(4)

    def add_virtual_hashes(self, n: int) -> list[list[Target]]:
        return [self.add_virtual_hash() for _ in range(n)]

    def add_virtual_extension_target(self) -> ExtensionTarget:
        return ExtensionTarget(tuple(self.add_virtual_target() for _ in range(D)))

    def add_virtual_extension_targets(self, n: int) -> list[ExtensionTarget]:
        return [self.add_virtual_extension_target() for _ in range(n)]

    # -- gates ----------------------------------------------------------------

    def num_gates(self) -> int:
        return len(self.gate_instances)

    def add_gate(self, gate, constants: list[int]) -> int:
        """Append a row of `gate`; its constants are zero-padded. Only a
        ConstantGate's extra-constant wires get ConstantGenerators (the
        reference's rule, circuit_builder.rs:186-209)."""
        if gate.num_wires() > self.config.num_wires:
            raise ValueError(f"{gate.id()} requires {gate.num_wires()} wires, the config "
                             f"has {self.config.num_wires}")
        if gate.num_constants() > self.config.num_constants and not isinstance(gate,
                                                                              ConstantGate):
            raise ValueError(f"{gate.id()} requires {gate.num_constants()} constants")
        if len(constants) > gate.num_constants():
            raise ValueError("Too many constants.")
        constants = list(constants) + [0] * (gate.num_constants() - len(constants))
        row = len(self.gate_instances)
        if isinstance(gate, ConstantGate):
            for constant_index, wire_index in gate.extra_constant_wires():
                self.constant_generators.append(
                    ConstantGenerator(row, constant_index, wire_index, 0))
        self.gates.setdefault(gate.id(), gate)
        self.gate_instances.append(GateInstance(gate, constants))
        return row

    def find_slot(self, gate, params: list[int], constants: list[int]) -> tuple[int, int]:
        """(row, op) of the next free op of a multi-op gate with these
        parameters, a new row when none is open (reference
        circuit_builder.rs:813-840)."""
        gate_slots = self.current_slots.setdefault(gate.id(), {})
        key = tuple(params)
        if key in gate_slots:
            row, op = gate_slots[key]
        else:
            row, op = self.add_gate(gate, list(constants)), 0
        if op == gate.num_ops - 1:
            gate_slots.pop(key, None)
        else:
            gate_slots[key] = (row, op + 1)
        return row, op

    # -- copy constraints and generators ----------------------------------------

    def connect(self, x: Target, y: Target) -> None:
        if not (is_routable(x, self.config) and is_routable(y, self.config)):
            raise ValueError("Tried to route a wire that isn't routable")
        self.copy_constraints.append((x, y))

    def generate_copy(self, src: Target, dst: Target) -> None:
        self.add_simple_generator(CopyGenerator(src, dst))

    def add_simple_generator(self, gen) -> None:
        self.generators.append(gen)

    def add_generators(self, gens) -> None:
        self.generators.extend(gens)

    # -- constants and public inputs ----------------------------------------------

    def constant(self, c: int) -> Target:
        c %= fs.P
        if c not in self.constants_to_targets:
            t = self.add_virtual_target()
            self.constants_to_targets[c] = t
            self.targets_to_constants[t] = c
        return self.constants_to_targets[c]

    def zero(self) -> Target:
        return self.constant(0)

    def one(self) -> Target:
        return self.constant(1)

    def two(self) -> Target:
        return self.constant(2)

    def neg_one(self) -> Target:
        return self.constant(fs.P - 1)

    def constants(self, cs) -> list[Target]:
        return [self.constant(c) for c in cs]

    def constant_bool(self, b: bool) -> BoolTarget:
        return BoolTarget(self.one() if b else self.zero())

    def constant_hash(self, digest) -> list[Target]:
        return [self.constant(int(v)) for v in digest]

    def constant_merkle_cap(self, cap) -> list[list[Target]]:
        return [self.constant_hash(d) for d in cap]

    def constant_verifier_data(self, verifier_only):
        """The verifier data as constant targets (reference
        circuit_builder.rs constant_verifier_data)."""
        from plonky2_torch.recursion.recursive_verifier import VerifierCircuitTarget

        return VerifierCircuitTarget(
            constants_sigmas_cap=self.constant_merkle_cap(verifier_only.constants_sigmas_cap),
            circuit_digest=self.constant_hash(verifier_only.circuit_digest))

    def set_domain_separator(self, separator: list[int]) -> None:
        """Field elements that enter the circuit digest, so otherwise equal
        circuits get distinct digests (reference circuit_builder.rs:262-266)."""
        if self.domain_separator is not None:
            raise ValueError("the domain separator is already set")
        self.domain_separator = list(separator)

    def _false(self) -> BoolTarget:
        return BoolTarget(self.zero())

    def target_as_constant(self, t: Target):
        return self.targets_to_constants.get(t)

    def register_public_input(self, t: Target) -> None:
        self.public_inputs.append(t)

    def register_public_inputs(self, ts) -> None:
        self.public_inputs.extend(ts)

    def add_virtual_public_input(self) -> Target:
        t = self.add_virtual_target()
        self.register_public_input(t)
        return t

    def add_virtual_public_input_arr(self, n: int) -> list[Target]:
        ts = self.add_virtual_targets(n)
        self.register_public_inputs(ts)
        return ts

    def add_virtual_hash_public_input(self) -> list[Target]:
        h = self.add_virtual_hash()
        self.register_public_inputs(h)
        return h

    def num_public_inputs(self) -> int:
        return len(self.public_inputs)

    def connect_array(self, xs, ys) -> None:
        if len(xs) != len(ys):
            raise ValueError("connect_array of arrays of different lengths")
        for x, y in zip(xs, ys):
            self.connect(x, y)

    def connect_hashes(self, a, b) -> None:
        for x, y in zip(a, b):
            self.connect(x, y)

    def select_hash(self, b: BoolTarget, h0, h1) -> list[Target]:
        return [self.select(b, x, y) for x, y in zip(h0, h1)]

    # -- arithmetic (reference circuit_builder.py:306-404) --------------------------

    def arithmetic(self, const_0: int, const_1: int, m0: Target, m1: Target,
                   addend: Target) -> Target:
        """const_0 · m0 · m1 + const_1 · addend, folded where its operands
        are constants, shared where the same operation was made before."""
        const_0 %= fs.P
        const_1 %= fs.P
        special = self._arithmetic_special_cases(const_0, const_1, m0, m1, addend)
        if special is not None:
            return special
        key = (const_0, const_1, m0, m1, addend)
        if key not in self.base_arithmetic_results:
            self.base_arithmetic_results[key] = self._add_base_arithmetic_operation(
                const_0, const_1, m0, m1, addend)
        return self.base_arithmetic_results[key]

    def _add_base_arithmetic_operation(self, const_0, const_1, m0, m1, addend) -> Target:
        """One op slot of an ArithmeticGate with these constants."""
        gate = ArithmeticGate.new_from_config(self.config)
        constants = [const_0, const_1]
        row, i = self.find_slot(gate, constants, constants)
        self.connect(m0, Wire(row, ArithmeticGate.wire_ith_multiplicand_0(i)))
        self.connect(m1, Wire(row, ArithmeticGate.wire_ith_multiplicand_1(i)))
        self.connect(addend, Wire(row, ArithmeticGate.wire_ith_addend(i)))
        return Wire(row, ArithmeticGate.wire_ith_output(i))

    def _arithmetic_special_cases(self, const_0, const_1, m0, m1, addend):
        zero = self.zero()
        mul_0_const = self.target_as_constant(m0)
        mul_1_const = self.target_as_constant(m1)
        addend_const = self.target_as_constant(addend)
        first_term_zero = const_0 == 0 or m0 == zero or m1 == zero
        second_term_zero = const_1 == 0 or addend == zero
        if first_term_zero:
            first_term_const = 0
        elif mul_0_const is not None and mul_1_const is not None:
            first_term_const = fs.mul(fs.mul(mul_0_const, mul_1_const), const_0)
        else:
            first_term_const = None
        if second_term_zero:
            second_term_const = 0
        elif addend_const is not None:
            second_term_const = fs.mul(addend_const, const_1)
        else:
            second_term_const = None
        if first_term_const is not None and second_term_const is not None:
            return self.constant(fs.add(first_term_const, second_term_const))
        if first_term_zero and const_1 == 1:
            return addend
        if second_term_zero:
            if mul_0_const is not None and fs.mul(mul_0_const, const_0) == 1:
                return m1
            if mul_1_const is not None and fs.mul(mul_1_const, const_0) == 1:
                return m0
        return None

    def add(self, x: Target, y: Target) -> Target:
        return self.arithmetic(1, 1, x, self.one(), y)

    def add_many(self, ts) -> Target:
        ts = list(ts)
        acc = ts[0]
        for t in ts[1:]:
            acc = self.add(acc, t)
        return acc

    def sub(self, x: Target, y: Target) -> Target:
        return self.arithmetic(1, fs.P - 1, x, self.one(), y)

    def mul(self, x: Target, y: Target) -> Target:
        return self.arithmetic(1, 0, x, y, self.zero())

    def mul_many(self, ts) -> Target:
        ts = list(ts)
        acc = ts[0]
        for t in ts[1:]:
            acc = self.mul(acc, t)
        return acc

    def mul_add(self, x: Target, y: Target, z: Target) -> Target:
        return self.arithmetic(1, 1, x, y, z)

    def mul_sub(self, x: Target, y: Target, z: Target) -> Target:
        return self.arithmetic(1, fs.P - 1, x, y, z)

    def mul_const(self, c: int, x: Target) -> Target:
        return self.arithmetic(c, 0, x, self.one(), self.zero())

    def mul_const_add(self, c: int, x: Target, y: Target) -> Target:
        return self.arithmetic(c, 1, x, self.one(), y)

    def add_const(self, x: Target, c: int) -> Target:
        return self.add(x, self.constant(c))

    def neg(self, x: Target) -> Target:
        return self.mul(x, self.neg_one())

    def square(self, x: Target) -> Target:
        return self.mul(x, x)

    def exp_u64(self, base: Target, exponent: int) -> Target:
        """base^exponent for a constant exponent (square-and-multiply)."""
        result = self.one()
        b = base
        e = exponent
        while e > 0:
            if e & 1:
                result = self.mul(result, b)
            e >>= 1
            if e:
                b = self.square(b)
        return result

    def inverse(self, x: Target) -> Target:
        """1 / x, held by x · x_inv = 1 (`gadgets/inverse.py`)."""
        from plonky2_torch.gadgets.inverse import add_inverse

        return add_inverse(self, x)

    # -- assertions and bit splits ------------------------------------------------

    def assert_zero(self, x: Target) -> None:
        self.connect(x, self.zero())

    def assert_one(self, x: Target) -> None:
        self.connect(x, self.one())

    def assert_bool(self, b: BoolTarget) -> None:
        self.connect(self.mul(b.target, b.target), b.target)

    def is_equal(self, x: Target, y: Target) -> BoolTarget:
        from plonky2_torch.gadgets.inverse import is_equal

        return is_equal(self, x, y)

    def select(self, b: BoolTarget, x: Target, y: Target) -> Target:
        """b ? x : y = b · (x - y) + y (reference gadgets/select.rs)."""
        return self.add(self.mul(b.target, self.sub(x, y)), y)

    def split_le(self, integer: Target, num_bits: int) -> list[BoolTarget]:
        from plonky2_torch.gadgets.split_join import split_le

        return split_le(self, integer, num_bits)

    def split_low_high(self, x: Target, n_log: int, num_bits: int) -> tuple[Target, Target]:
        from plonky2_torch.gadgets.split_join import split_low_high

        return split_low_high(self, x, n_log, num_bits)

    def range_check(self, x: Target, n_log: int) -> None:
        from plonky2_torch.gadgets.split_join import range_check

        range_check(self, x, n_log)

    def low_bits(self, x: Target, num_low_bits: int, num_bits: int) -> list[BoolTarget]:
        from plonky2_torch.gadgets.split_join import low_bits

        return low_bits(self, x, num_low_bits, num_bits)

    # -- in-circuit hashing ---------------------------------------------------------

    def permute_swapped(self, inputs: list[Target], swap: BoolTarget) -> list[Target]:
        """One PoseidonGate row (reference hash/poseidon.rs:892-919)."""
        row = self.add_gate(PoseidonGate(), [])
        self.connect(swap.target, Wire(row, PoseidonGate.WIRE_SWAP))
        for i in range(12):
            self.connect(inputs[i], Wire(row, PoseidonGate.wire_input(i)))
        return [Wire(row, PoseidonGate.wire_output(i)) for i in range(12)]

    def permute(self, inputs: list[Target]) -> list[Target]:
        return self.permute_swapped(inputs, self._false())

    def hash_n_to_m_no_pad(self, inputs: list[Target], num_outputs: int) -> list[Target]:
        state = [self.zero()] * 12
        for i in range(0, len(inputs), 8):
            chunk = inputs[i:i + 8]
            state = self.permute(chunk + state[len(chunk):])
        outputs = []
        while True:
            for s in state[:8]:
                outputs.append(s)
                if len(outputs) == num_outputs:
                    return outputs
            state = self.permute(state)

    def hash_n_to_hash_no_pad(self, inputs: list[Target]) -> list[Target]:
        return self.hash_n_to_m_no_pad(inputs, 4)

    def hash_or_noop(self, inputs: list[Target]) -> list[Target]:
        """At most four inputs are their own digest, zero-padded."""
        if len(inputs) <= 4:
            return list(inputs) + [self.zero()] * (4 - len(inputs))
        return self.hash_n_to_hash_no_pad(inputs)

    # -- build ------------------------------------------------------------------------

    def _fri_params(self, degree_bits: int):
        return self.config.fri_config.fri_params(degree_bits, self.config.zero_knowledge)

    def _num_blinding_gates(self, degree_estimate: int) -> tuple[int, int]:
        """(regular blinding rows, Z blinding pairs) for a degree estimate:
        as many random values as the openings reveal, the FRI queries' among
        them (the reference package's plonk/circuit_builder.py:517-528)."""
        d = 2
        fri_queries = self.config.fri_config.num_query_rounds
        arities = [1 << x for x in
                   self._fri_params(log2_strict(degree_estimate)).reduction_arity_bits]
        total_fri_folding_points = sum(a - 1 for a in arities)
        final_poly_coeffs = degree_estimate // int(np.prod(arities, dtype=object))
        fri_openings = fri_queries * (1 + d * total_fri_folding_points + d * final_poly_coeffs)
        return d + fri_openings, 2 * d + fri_openings

    def _blinding_counts(self) -> tuple[int, int]:
        """The blinding counts at the least power-of-two degree that holds
        the gates, the regular rows and both rows of each Z pair."""
        num_gates = len(self.gate_instances)
        degree_estimate = 1 << (max(num_gates, 1) - 1).bit_length()
        while True:
            regular, z = self._num_blinding_gates(degree_estimate)
            if num_gates + regular + 2 * z <= degree_estimate:
                return regular, z
            degree_estimate *= 2

    def _blind(self) -> None:
        """Noop rows of random wires, then pairs of noop rows whose routed
        wires are random and copied from the first row to the second, so
        each Z's product is blinded and unchanged (the reference package's
        plonk/circuit_builder.py:547-560)."""
        regular, z = self.blinding = self._blinding_counts()
        nw, nrw = self.config.num_wires, self.config.num_routed_wires
        for _ in range(regular):
            row = self.add_gate(NoopGate(), [])
            for w in range(nw):
                self.add_simple_generator(RandomValueGenerator(Wire(row, w)))
        for _ in range(z):
            g1 = self.add_gate(NoopGate(), [])
            g2 = self.add_gate(NoopGate(), [])
            for w in range(nrw):
                self.add_simple_generator(RandomValueGenerator(Wire(g1, w)))
                self.generate_copy(Wire(g1, w), Wire(g2, w))

    def _blind_and_pad(self) -> None:
        """Under zero knowledge the blinding rows, then noops to the next
        power of two (at least one row)."""
        if self.config.zero_knowledge:
            self._blind()
        while not self.gate_instances or len(self.gate_instances) & (len(self.gate_instances) - 1):
            self.add_gate(NoopGate(), [])

    def _constant_polys(self) -> np.ndarray:
        """[max gate constants, degree]: each row's gate constants."""
        max_constants = max(g.num_constants() for g in self.gates.values())
        out = np.zeros((max_constants, len(self.gate_instances)), dtype=np.uint64)
        for j, gi in enumerate(self.gate_instances):
            out[:len(gi.constants), j] = gi.constants
        return out

    def _lookup_selectors(self) -> list[np.ndarray]:
        """Where the circuit has LUTs, [4 + num LUTs, degree]: the RE
        transition (the table rows), the SLDC transition (the lookup rows),
        the RE start (the noop row after each table), the last lookup row,
        then one column a LUT marking its lowest table row (reference
        gates/selectors.rs:51-111); else nothing."""
        if not self.luts:
            return []
        n = len(self.gate_instances)
        sel = np.zeros((4 + len(self.luts), n), dtype=np.uint64)
        for k, lw in enumerate(self.lookup_rows):
            sel[0, lw.last_lut_gate:lw.first_lut_gate + 1] = 1
            sel[1, lw.last_lu_gate:lw.last_lut_gate] = 1
            sel[2, lw.first_lut_gate + 1] = 1
            sel[3, lw.last_lu_gate] = 1
            sel[4 + k, lw.last_lut_gate] = 1
        return [sel]

    def _selector_polynomials(self, gates, max_degree: int):
        """The greedy grouping by degree (reference gates/selectors.rs:113-185):
        one selector polynomial a group, holding a row's gate index where
        its gate is in the group and UNUSED_SELECTOR elsewhere."""
        index = {g.id(): i for i, g in enumerate(gates)}
        row_gate = np.fromiter((index[gi.gate.id()] for gi in self.gate_instances), np.int64,
                               len(self.gate_instances))
        num_gates = len(gates)
        if gates[-1].degree() + num_gates - 1 <= max_degree:
            return ([row_gate.astype(np.uint64)],
                    SelectorsInfo([0] * num_gates, [range(0, num_gates)]))
        if gates[-1].degree() >= max_degree:
            raise ValueError(f"{gates[-1].id()} has too high degree; increase "
                             "quotient_degree_factor")
        groups, start = [], 0
        while start < num_gates:
            size = 0
            while start + size < num_gates and size + gates[start + size].degree() < max_degree:
                size += 1
            groups.append(range(start, start + size))
            start += size
        group_of = [next(k for k, r in enumerate(groups) if i in r) for i in range(num_gates)]
        row_group = np.asarray(group_of, dtype=np.int64)[row_gate]
        polys = [np.where(row_group == k, row_gate, UNUSED_SELECTOR).astype(np.uint64)
                 for k in range(len(groups))]
        return polys, SelectorsInfo(group_of, groups)

    def build_prover(self, device=None):
        """Proving-only circuit data (reference circuit_builder.rs:1336-1340)."""
        return self.build(device).prover_data()

    def build_verifier(self, device=None):
        """Verification-only circuit data (reference circuit_builder.rs:1343-1347)."""
        return self.build(device).verifier_data()

    def mock_build(self, device=None):
        """Witness-generation-only circuit data (reference
        circuit_builder.rs:1328-1334)."""
        return self.build(device).mock()

    def build(self, device=None, timing: TimingTree | None = None) -> CircuitData:
        """The reference's build (circuit_builder.py:613-795), step by step.
        The constants-sigmas commitment runs on `device` (CUDA unless the
        caller asks for another); `timing` gets the scopes "selectors and
        constants", "forest and sigmas", "constants-sigmas commitment" and
        "generators and watch index". Under a process group the commitment
        runs over the group: every rank gets the one-device circuit, and
        its prover data keeps the rank's part of the batch for proves under
        a group of this rank and world (`plonk.prover._constants_part`)."""
        group, device = parallel.placement(device)
        config = self.config
        timing = timing or TimingTree("build")
        fri = config.fri_config

        # the public inputs' hash, routed to a PublicInputGate
        num_public_inputs = len(self.public_inputs)
        public_inputs_hash = self.hash_n_to_hash_no_pad(list(self.public_inputs))
        pi_gate = self.add_gate(PublicInputGate(), [])
        for hash_part, wire in zip(public_inputs_hash, PublicInputGate.wires_public_inputs_hash()):
            self.connect(hash_part, Wire(pi_gate, wire))
        for wire in range(4, config.num_wires):
            self.add_simple_generator(RandomValueGenerator(Wire(pi_gate, wire)))
        if self.luts:
            self.add_all_lookups()

        # the constants, sorted by value, on ConstantGates
        while len(self.constants_to_targets) > len(self.constant_generators):
            self.add_gate(ConstantGate(config.num_constants), [])
        for (c, t), const_gen in zip(sorted(self.constants_to_targets.items()),
                                     self.constant_generators):
            self.gate_instances[const_gen.row].constants[const_gen.constant_index] = c
            self.connect(Wire(const_gen.row, const_gen.wire_index), t)
            const_gen.constant = c
            self.add_simple_generator(const_gen)

        self._blind_and_pad()
        degree = len(self.gate_instances)
        degree_bits = log2_strict(degree)
        fri_params = self._fri_params(degree_bits)
        if fri_params.total_arities() > degree_bits + fri.rate_bits - fri.cap_height:
            raise ValueError("FRI total reduction arity is too large.")

        quotient_degree_factor = config.max_quotient_degree_factor
        gates = sorted(self.gates.values(), key=lambda g: (g.degree(), g.id()))
        with timing.scope("selectors and constants"):
            selector_polys, selectors_info = self._selector_polynomials(
                gates, quotient_degree_factor + 1)
            lookup_selectors = self._lookup_selectors()
            constant_vecs = np.concatenate([np.stack(selector_polys)] + lookup_selectors
                                           + [self._constant_polys()])
        num_constants = constant_vecs.shape[0]
        subgroup = np.asarray(fs.two_adic_subgroup(degree_bits), dtype=np.uint64)
        k_is = fs.get_unique_coset_shifts(degree, config.num_routed_wires)

        with timing.scope("forest and sigmas"):
            forest = Forest(config.num_wires, config.num_routed_wires, degree,
                            self.virtual_target_index)
            for a, b in self.copy_constraints:
                forest.merge(a, b)
            parents = forest.compress_paths()
            sigmas = forest.sigma_polys(k_is, subgroup)

        with timing.scope("constants-sigmas commitment"):
            commitment = PolynomialBatch.from_values(
                np.concatenate([constant_vecs, sigmas]), fri.rate_bits,
                pcfg.CONSTANTS_SIGMAS.blinding, fri.cap_height, device=device,
                hasher=self.gc.hasher)
            cap = commitment.merkle_tree.cap

        with timing.scope("generators and watch index"):
            # each row's gate generators, less the unused ops of a row whose
            # slots were left open
            incomplete = {row: op for slots in self.current_slots.values()
                          for row, op in slots.values()}
            for row, gi in enumerate(self.gate_instances):
                gens = gi.gate.generators(row, gi.constants)
                if row in incomplete:
                    gens = gens[:incomplete[row]]
                self.add_generators(gens)
            watches: dict[int, list[int]] = {}
            for i, gen in enumerate(self.generators):
                for watch in gen.dependencies():
                    watches.setdefault(int(parents[forest.target_index(watch)]), []).append(i)
            watches = {rep: np.asarray(sorted(set(v)), dtype=np.int64)
                       for rep, v in watches.items()}

        # the circuit digest (reference circuit_builder.rs:1252-1264), with
        # the digest of the domain separator, under the config's hasher
        hasher = self.gc.hasher
        circuit_digest = hasher.hash_no_pad(
            [x for h in cap for x in hasher.digest_to_felts(h)]
            + hasher.digest_to_felts(hasher.hash_pad(self.domain_separator or []))
            + [degree_bits])

        common = CommonCircuitData(
            gc=self.gc, config=config, fri_params=fri_params, gates=gates,
            selectors_info=selectors_info,
            quotient_degree_factor=quotient_degree_factor,
            num_gate_constraints=max(g.num_constraints() for g in gates),
            num_constants=num_constants, num_public_inputs=num_public_inputs, k_is=k_is,
            num_partial_products=-(-config.num_routed_wires // quotient_degree_factor) - 1,
            num_lookup_polys=(-(-LookupGate.num_slots_from_config(config)
                                // (quotient_degree_factor - 1)) + 1 if self.luts else 0),
            num_lookup_selectors=4 + len(self.luts) if self.luts else 0,
            luts=[list(lut) for lut in self.luts])
        prover_only = ProverOnlyCircuitData(
            constants_sigmas_coeffs=g.to_numpy(commitment.polynomials),
            sigmas=sigmas, subgroup=subgroup, circuit_digest=circuit_digest,
            generators=self.generators, generator_indices_by_watches=watches,
            public_inputs=self.public_inputs, representative_map=parents,
            lookup_rows=list(self.lookup_rows),
            lut_to_lookups=[list(lookups) for lookups in self.lut_to_lookups])
        prover_only.cache(device)["constants_sigmas" if group is None else (
            "constants_sigmas", group.rank, group.world)] = commitment
        verifier_only = VerifierOnlyCircuitData(constants_sigmas_cap=cap,
                                                circuit_digest=circuit_digest)
        if self.goal_common_data is not None and common != self.goal_common_data:
            raise ValueError("the built CommonCircuitData is not the goal (the cyclic "
                             "fixpoint)")
        # the kernel of the commitment's iFFT, by field/ntt.py's dispatch rule
        build_info = {"device": str(device),
                      "constants_sigmas_ifft": "K2" if degree_bits <= kn.MAX_SMEM_LG else "K3"}
        if config.zero_knowledge:
            build_info["blinding"] = self.blinding
        return CircuitData(prover_only, verifier_only, common, build_info)
