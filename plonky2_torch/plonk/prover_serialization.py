"""The reference package's circuit bytes, both ways, for the port's circuit
data.

Readers: `read_prover_data` reads `prover_data_to_bytes` (common data, then
the prover-only data); `read_circuit_data` reads `circuit_data_to_bytes`
(common, prover-only, verifier-only), the layout of
`bench_cache/middle14.circuit.bin`. Writers: `prover_data_to_bytes` and
`circuit_data_to_bytes` write those layouts from the port's circuit data
(`ProverWriter`, `write_prover_only_circuit_data`; `CircuitWriter` writes
the common and verifier-only data). Layouts: the reference's
`plonk/circuit_serialization.py:192-323` (common data, gate tags) and
`plonk/prover_serialization.py:28-650` (targets, generator payloads,
prover-only fields), all integers little-endian.

Generators go by tag in the reference's registry order
(generator_serialization.rs:155-182; `GENERATOR_TAGS`, `default_registry`).
A generator outside the registry, such as square_root's, raises the
reference's ValueError; a caller's `registry` (the default one with its
own classes appended) adds it, and such a class writes and reads its own
payload (`serialize(w)`, classmethod `deserialize(r)`). The common data
carries the LUTs; a lookup gate or generator names its LUT by index (and a
gate by its hash too), and the prover-only data ends with the lookup rows
and each LUT's lookups. A gate or generator tag the port has no class for
raises ValueError. Digests are Poseidon's unless the
reader is given a Keccak hasher (`Reader(data, hasher)`).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from plonky2_torch.fri.config import FriConfig, FriParams, FriReductionStrategy
from plonky2_torch.fri.serialization import Writer
from plonky2_torch.gadgets.lookup import LookupWire
from plonky2_torch.gadgets.extension_arithmetic import QuotientGeneratorExtension
from plonky2_torch.gadgets.split_join import LowHighGenerator, WireSplitGenerator
from plonky2_torch.gates.arithmetic_base import ArithmeticGate
from plonky2_torch.gates.arithmetic_extension import (
    ArithmeticExtensionGate,
    ArithmeticExtensionGenerator,
    MulExtensionGate,
    MulExtensionGenerator,
)
from plonky2_torch.gates.base_sum import BaseSplitGenerator, BaseSumGate
from plonky2_torch.gates.coset_interpolation import CosetInterpolationGate, InterpolationGenerator
from plonky2_torch.gates.exponentiation import ExponentiationGate, ExponentiationGenerator
from plonky2_torch.gates.lookup import (
    LookupGate,
    LookupGenerator,
    LookupTableGate,
    LookupTableGenerator,
)
from plonky2_torch.gates.poseidon_gate import PoseidonGate, PoseidonGenerator
from plonky2_torch.gates.poseidon_mds import PoseidonMdsGate, PoseidonMdsGenerator
from plonky2_torch.gates.random_access import RandomAccessGate, RandomAccessGenerator
from plonky2_torch.gates.reducing import (
    ReducingExtensionGate,
    ReducingExtensionGenerator,
    ReducingGate,
    ReducingGenerator,
)
from plonky2_torch.gates.simple_gates import ConstantGate, NoopGate, PublicInputGate
from plonky2_torch.iop.generator import (
    ArithmeticBaseGenerator,
    ConstantGenerator,
    CopyGenerator,
    NonzeroTestGenerator,
    RandomValueGenerator,
)
from plonky2_torch.iop.target import BoolTarget, ExtensionTarget, VirtualTarget, Wire
from plonky2_torch.plonk.circuit_data import (
    CommonCircuitData,
    ProverOnlyCircuitData,
    SelectorsInfo,
    VerifierOnlyCircuitData,
)
from plonky2_torch.plonk.config import CircuitConfig

# the reference's gate registry order (its GATE_TAGS); None: not ported
GATE_TAGS = [
    ("ArithmeticGate", lambda r: ArithmeticGate(r.usize())),
    ("ArithmeticExtensionGate", lambda r: ArithmeticExtensionGate(r.usize())),
    ("BaseSumGate", lambda r: BaseSumGate(r.usize(), 2)),
    ("ConstantGate", lambda r: ConstantGate(r.usize())),
    ("CosetInterpolationGate", lambda r: _coset_interpolation_gate(r)),
    ("ExponentiationGate", lambda r: ExponentiationGate(r.usize())),
    ("LookupGate", lambda r: _lookup_gate(r)),
    ("LookupTableGate", lambda r: _lookup_table_gate(r)),
    ("MulExtensionGate", lambda r: MulExtensionGate(r.usize())),
    ("NoopGate", lambda r: NoopGate()),
    ("PoseidonMdsGate", lambda r: PoseidonMdsGate()),
    ("PoseidonGate", lambda r: PoseidonGate()),
    ("PublicInputGate", lambda r: PublicInputGate()),
    ("RandomAccessGate", lambda r: RandomAccessGate(r.usize(), r.usize(), r.usize())),
    ("ReducingExtensionGate", lambda r: ReducingExtensionGate(r.usize())),
    ("ReducingGate", lambda r: ReducingGate(r.usize())),
]

# the reference's generator registry order (generator_serialization.rs:155-182)
# and each tag's reader; None: the tag has no class in the port
GENERATOR_TAGS = [
    ("ArithmeticBaseGenerator", lambda r: ArithmeticBaseGenerator(
        r.usize(), r.field(), r.field(), r.usize())),
    ("ArithmeticExtensionGenerator", lambda r: ArithmeticExtensionGenerator(
        r.usize(), r.field(), r.field(), r.usize())),
    ("BaseSplitGenerator", lambda r: BaseSplitGenerator(r.usize(), r.usize(), 2)),
    ("BaseSumGenerator", None),
    ("ConstantGenerator", lambda r: ConstantGenerator(r.usize(), r.usize(), r.usize(),
                                                      r.field())),
    ("CopyGenerator", lambda r: CopyGenerator(r.target(), r.target())),
    ("DummyProofGenerator", lambda r: _read_dummy_proof_generator(r)),
    ("EqualityGenerator", lambda r: _inverse_module().EqualityGenerator(
        r.target(), r.target(), r.target(), r.target())),
    ("ExponentiationGenerator", lambda r: ExponentiationGenerator(r.usize(), r.usize())),
    ("InterpolationGenerator", lambda r: _interpolation_generator(r)),
    ("LookupGenerator", lambda r: _lookup_generator(r)),
    ("LookupTableGenerator", lambda r: _lookup_table_generator(r)),
    ("LowHighGenerator", lambda r: LowHighGenerator(r.target(), r.usize(), r.target(),
                                                    r.target())),
    ("MulExtensionGenerator", lambda r: MulExtensionGenerator(r.usize(), r.field(), r.usize())),
    ("NonzeroTestGenerator", lambda r: NonzeroTestGenerator(r.target(), r.target())),
    ("PoseidonGenerator", lambda r: PoseidonGenerator(r.usize())),
    ("PoseidonMdsGenerator", lambda r: PoseidonMdsGenerator(r.usize())),
    ("QuotientGeneratorExtension", lambda r: QuotientGeneratorExtension(
        r.ext_target(), r.ext_target(), r.ext_target())),
    ("RandomAccessGenerator", lambda r: _random_access_generator(r)),
    ("RandomValueGenerator", lambda r: RandomValueGenerator(r.target())),
    ("ReducingGenerator", lambda r: ReducingGenerator(r.usize(), r.usize())),
    ("ReducingExtensionGenerator", lambda r: ReducingExtensionGenerator(r.usize(), r.usize())),
    ("SplitGenerator", None),
    ("WireSplitGenerator", lambda r: WireSplitGenerator(
        r.target(), [int(v) for v in r.usize_vec()], r.usize())),
    ("InverseGenerator", lambda r: _inverse_module().InverseGenerator(r.target(), r.target())),
]


def _inverse_module():
    from plonky2_torch.gadgets import inverse

    return inverse


def default_registry() -> list:
    """Per generator tag, the port's class (None where the port has none)."""
    from plonky2_torch.recursion.dummy_circuit import DummyProofGenerator

    inv = _inverse_module()
    classes = {c.__name__: c for c in (
        ArithmeticBaseGenerator, ArithmeticExtensionGenerator, BaseSplitGenerator,
        ConstantGenerator, CopyGenerator, DummyProofGenerator, inv.EqualityGenerator,
        ExponentiationGenerator, InterpolationGenerator, LookupGenerator,
        LookupTableGenerator, LowHighGenerator, MulExtensionGenerator, NonzeroTestGenerator,
        PoseidonGenerator,
        PoseidonMdsGenerator, QuotientGeneratorExtension, RandomAccessGenerator,
        RandomValueGenerator,
        ReducingGenerator, ReducingExtensionGenerator, WireSplitGenerator,
        inv.InverseGenerator)}
    return [classes.get(name) if read is not None else None for name, read in GENERATOR_TAGS]


class Reader:
    def __init__(self, data: bytes, hasher=None, registry=None):
        self.data = memoryview(data)
        self.pos = 0
        self.hasher = hasher  # the digests' form: Poseidon unless a Keccak hasher
        self.registry = registry  # generator classes by tag; None: the default
        self.luts: list = []  # the common data's, once read

    def u8(self) -> int:
        x = self.data[self.pos]
        self.pos += 1
        return x

    def bool(self) -> bool:
        return self.u8() != 0

    def u16(self) -> int:
        (x,) = struct.unpack_from("<H", self.data, self.pos)
        self.pos += 2
        return x

    def u32(self) -> int:
        (x,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return x

    def usize(self) -> int:
        (x,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return x

    def u64_array(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.data, dtype="<u8", count=n, offset=self.pos).astype(np.uint64)
        self.pos += 8 * n
        return out

    def field_vec(self, n: int) -> list[int]:
        return [int(v) for v in self.u64_array(n)]

    def usize_vec(self) -> np.ndarray:
        return self.u64_array(self.usize())

    def hash(self) -> list[int] | bytes:
        if not getattr(self.hasher, "algebraic", True):
            out = bytes(self.data[self.pos:self.pos + self.hasher.HASH_SIZE])
            self.pos += self.hasher.HASH_SIZE
            return out
        return self.field_vec(4)

    def merkle_cap(self, cap_height: int) -> list[list[int]]:
        return [self.hash() for _ in range(1 << cap_height)]

    def field(self) -> int:
        return self.usize()

    def target(self):
        if self.bool():
            return Wire(self.usize(), self.usize())
        return VirtualTarget(self.usize())

    def target_vec(self) -> list:
        return [self.target() for _ in range(self.usize())]

    def ext_target(self) -> ExtensionTarget:
        return ExtensionTarget((self.target(), self.target()))

    def byte_string(self) -> bytes:
        """A usize length, then that many bytes."""
        n = self.usize()
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    # -- common circuit data ------------------------------------------------

    def fri_reduction_strategy(self) -> FriReductionStrategy:
        kind = self.u8()
        if kind == 0:
            return FriReductionStrategy.Fixed(tuple(int(v) for v in self.usize_vec()))
        if kind == 1:
            return FriReductionStrategy.ConstantArityBits(self.usize(), self.usize())
        return FriReductionStrategy.MinSize(self.usize() if self.u8() else None)

    def fri_config(self) -> FriConfig:
        rate_bits, cap_height, num_query_rounds = self.usize(), self.usize(), self.usize()
        pow_bits = self.u32()
        return FriConfig(rate_bits=rate_bits, cap_height=cap_height,
                         proof_of_work_bits=pow_bits,
                         reduction_strategy=self.fri_reduction_strategy(),
                         num_query_rounds=num_query_rounds)

    def fri_params(self) -> FriParams:
        config = self.fri_config()
        arity_bits = tuple(int(v) for v in self.usize_vec())
        degree_bits = self.usize()
        return FriParams(config=config, hiding=self.bool(), degree_bits=degree_bits,
                         reduction_arity_bits=arity_bits)

    def circuit_config(self) -> CircuitConfig:
        return CircuitConfig(
            num_wires=self.usize(), num_routed_wires=self.usize(),
            num_constants=self.usize(), security_bits=self.usize(),
            num_challenges=self.usize(), max_quotient_degree_factor=self.usize(),
            use_base_arithmetic_gate=self.bool(), zero_knowledge=self.bool(),
            fri_config=self.fri_config())

    def selectors_info(self) -> SelectorsInfo:
        indices = [int(v) for v in self.usize_vec()]
        groups = [range(self.usize(), self.usize()) for _ in range(self.usize())]
        return SelectorsInfo(selector_indices=indices, groups=groups)

    def gate(self):
        tag = self.u32()
        if tag >= len(GATE_TAGS):
            raise ValueError(f"unknown gate tag {tag}")
        name, read = GATE_TAGS[tag]
        if read is None:
            raise ValueError(f"gate tag {tag} ({name}) is not ported")
        return read(self)

    def common_circuit_data(self) -> CommonCircuitData:
        config = self.circuit_config()
        fri_params = self.fri_params()
        selectors_info = self.selectors_info()
        qdf, num_gate_constraints, num_constants, num_public_inputs = (
            self.usize(), self.usize(), self.usize(), self.usize())
        k_is = self.field_vec(self.usize())
        num_partial_products, num_lookup_polys, num_lookup_selectors = (
            self.usize(), self.usize(), self.usize())
        self.luts = [[(self.u16(), self.u16()) for _ in range(self.usize())]
                     for _ in range(self.usize())]
        gates = [self.gate() for _ in range(self.usize())]
        return CommonCircuitData(
            config=config, fri_params=fri_params, gates=gates,
            selectors_info=selectors_info, quotient_degree_factor=qdf,
            num_gate_constraints=num_gate_constraints, num_constants=num_constants,
            num_public_inputs=num_public_inputs, k_is=k_is,
            num_partial_products=num_partial_products, num_lookup_polys=num_lookup_polys,
            num_lookup_selectors=num_lookup_selectors, luts=self.luts)

    # -- prover-only circuit data ---------------------------------------------

    def generator(self):
        tag = self.u32()
        if self.registry is not None and tag < len(self.registry) and hasattr(
                self.registry[tag], "deserialize"):
            return self.registry[tag].deserialize(self)
        if tag >= len(GENERATOR_TAGS):
            raise ValueError(f"unknown generator tag {tag}")
        name, read = GENERATOR_TAGS[tag]
        if read is None:
            raise ValueError(f"generator tag {tag} ({name}) is not ported")
        return read(self)

    def matrix(self) -> np.ndarray:
        rows, cols = self.usize(), self.usize()
        return self.u64_array(rows * cols).reshape(rows, cols)

    def prover_only_circuit_data(self, common: CommonCircuitData) -> ProverOnlyCircuitData:
        generators = [self.generator() for _ in range(self.usize())]
        watches = {}  # representative -> the generators watching it
        for _ in range(self.usize()):
            k = self.usize()
            watches[k] = self.usize_vec().astype(np.int64)
        coeffs = self.matrix()  # the constants-sigmas batch's coefficients
        degree_log, rate_bits, blinding = self.usize(), self.usize(), self.bool()
        if (1 << degree_log != coeffs.shape[1]
                or rate_bits != common.config.fri_config.rate_bits):
            raise ValueError("constants-sigmas batch does not match the common data")
        sigmas = self.matrix()
        subgroup = self.u64_array(self.usize())
        public_inputs = self.target_vec()
        representative_map = self.usize_vec().astype(np.int64)
        if self.bool():
            raise ValueError("an FFT root table is not expected")
        circuit_digest = self.hash()
        lookup_rows = [LookupWire(self.usize(), self.usize(), self.usize())
                       for _ in range(self.usize())]
        lut_to_lookups = [[(self.target(), self.target()) for _ in range(self.usize())]
                          for _ in range(self.usize())]
        return ProverOnlyCircuitData(constants_sigmas_coeffs=coeffs,
                                     constants_sigmas_blinding=blinding, sigmas=sigmas,
                                     subgroup=subgroup, circuit_digest=circuit_digest,
                                     generators=generators,
                                     generator_indices_by_watches=watches,
                                     public_inputs=public_inputs,
                                     representative_map=representative_map,
                                     lookup_rows=lookup_rows, lut_to_lookups=lut_to_lookups)

    def verifier_only_circuit_data(self) -> VerifierOnlyCircuitData:
        cap = self.merkle_cap(self.usize())
        return VerifierOnlyCircuitData(constants_sigmas_cap=cap, circuit_digest=self.hash())

    def finish(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{len(self.data) - self.pos} trailing bytes")


def _coset_interpolation_gate(r: Reader) -> CosetInterpolationGate:
    subgroup_bits, degree = r.usize(), r.usize()
    weights = r.field_vec(r.usize())
    gate = CosetInterpolationGate(subgroup_bits, degree)
    if gate.degree() != degree or gate.barycentric_weights != weights:
        raise ValueError("CosetInterpolationGate payload disagrees with its parameters")
    return gate


def _lookup_gate(r: Reader) -> LookupGate:
    """Tag 6: the slot count, the LUT's index and its hash."""
    num_slots = r.usize()
    lut = r.luts[r.usize()]
    return _hashed(r, LookupGate(num_slots, lut))


def _lookup_table_gate(r: Reader) -> LookupTableGate:
    """Tag 7: the slot count, the last LUT row, the LUT's index and its
    hash."""
    num_slots, last_lut_row = r.usize(), r.usize()
    lut = r.luts[r.usize()]
    return _hashed(r, LookupTableGate(num_slots, lut, last_lut_row))


def _hashed(r: Reader, gate):
    """The gate, once the 32-byte LUT hash that follows is its LUT's."""
    if bytes(r.data[r.pos:r.pos + 32]) != gate.lut_hash:
        raise ValueError(f"the LUT hash read with a {type(gate).__name__} is not its LUT's")
    r.pos += 32
    return gate


def _lookup_generator(r: Reader) -> LookupGenerator:
    row, slot_nb = r.usize(), r.usize()
    return LookupGenerator(row, r.luts[r.usize()], slot_nb)


def _lookup_table_generator(r: Reader) -> LookupTableGenerator:
    row, slot_nb, num_slots, last_lut_row = (r.usize() for _ in range(4))
    return LookupTableGenerator(row, r.luts[r.usize()], slot_nb, num_slots, last_lut_row)


def _interpolation_generator(r: Reader) -> InterpolationGenerator:
    gen = InterpolationGenerator(r.usize(), r.usize(), r.usize())
    if r.field_vec(r.usize()) != gen._gate().barycentric_weights:
        raise ValueError("InterpolationGenerator payload disagrees with its parameters")
    return gen


class TargetReplayBuilder:
    """Allocates virtual targets as a builder does, but from a list of
    targets already read, in order (reference prover_serialization.py:83):
    a proof-target structure is rebuilt by replaying its allocation."""

    def __init__(self, targets):
        self._it = iter(targets)

    def add_virtual_target(self):
        return next(self._it)

    def add_virtual_targets(self, n: int) -> list:
        return [next(self._it) for _ in range(n)]

    def add_virtual_hash(self) -> list:
        return self.add_virtual_targets(4)

    def add_virtual_extension_target(self) -> ExtensionTarget:
        return ExtensionTarget(tuple(self.add_virtual_targets(2)))

    def add_virtual_extension_targets(self, n: int) -> list:
        return [self.add_virtual_extension_target() for _ in range(n)]


def flatten_targets(obj, out: list) -> list:
    """The targets of a target structure (dataclasses, lists, extension
    and bool targets) in field order, appended to `out`."""
    if isinstance(obj, (Wire, VirtualTarget)):
        out.append(obj)
    elif isinstance(obj, BoolTarget):
        out.append(obj.target)
    elif isinstance(obj, ExtensionTarget):
        out.extend(obj.parts)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            flatten_targets(x, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            flatten_targets(getattr(obj, f.name), out)
    else:
        raise TypeError(f"cannot flatten targets from {type(obj)}")
    return out


def _read_dummy_proof_generator(r: Reader):
    """Tag 6 (reference prover_serialization.py:371): the verifier-data
    targets, the dummy circuit's verifier bytes, the proof targets (replayed
    from its common data) and the proof's bytes."""
    from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes
    from plonky2_torch.plonk.serialization import proof_from_bytes
    from plonky2_torch.recursion.dummy_circuit import DummyProofGenerator
    from plonky2_torch.recursion.recursive_verifier import (
        VerifierCircuitTarget,
        add_virtual_proof_with_pis,
    )

    cap_len = r.usize()
    replay = TargetReplayBuilder(r.target_vec())
    vk_t = VerifierCircuitTarget(
        constants_sigmas_cap=[replay.add_virtual_hash() for _ in range(cap_len)],
        circuit_digest=replay.add_virtual_hash())
    verifier_only, inner_common = verifier_data_from_bytes(r.byte_string())
    pt_flat = r.target_vec()
    pt = add_virtual_proof_with_pis(TargetReplayBuilder(pt_flat), inner_common)
    if flatten_targets(pt, []) != pt_flat:
        raise ValueError("the proof targets do not replay in their order")
    proof = proof_from_bytes(r.byte_string(), inner_common)
    return DummyProofGenerator(pt, proof, vk_t, verifier_only, inner_common=inner_common)


def _random_access_generator(r: Reader) -> RandomAccessGenerator:
    row, copy, bits, num_copies, num_extra = (r.usize() for _ in range(5))
    return RandomAccessGenerator(row, bits, num_copies, num_extra, copy)


# -- writers -------------------------------------------------------------------

_TAG_OF = {name: tag for tag, (name, _) in enumerate(GATE_TAGS)}


class CircuitWriter(Writer):
    luts: list = []  # the common data's LUTs, which lookup gates and generators index

    def write_bool(self, b: bool) -> None:
        self.write_u8(1 if b else 0)

    def write_u32(self, x: int) -> None:
        self.buf += struct.pack("<I", x)

    def write_usize_vec(self, v) -> None:
        self.write_usize(len(v))
        for x in v:
            self.write_usize(x)

    def write_fri_reduction_strategy(self, rs) -> None:
        if rs.kind == "fixed":
            self.write_u8(0)
            self.write_usize_vec(list(rs.fixed))
        elif rs.kind == "constant_arity":
            self.write_u8(1)
            self.write_usize(rs.arity_bits)
            self.write_usize(rs.final_poly_bits)
        else:  # MinSize
            self.write_u8(2)
            self.write_bool(rs.max_arity_bits is not None)
            if rs.max_arity_bits is not None:
                self.write_usize(rs.max_arity_bits)

    def write_fri_config(self, cfg) -> None:
        for x in (cfg.rate_bits, cfg.cap_height, cfg.num_query_rounds):
            self.write_usize(x)
        self.write_u32(cfg.proof_of_work_bits)
        self.write_fri_reduction_strategy(cfg.reduction_strategy)

    def write_fri_params(self, p) -> None:
        self.write_fri_config(p.config)
        self.write_usize_vec(list(p.reduction_arity_bits))
        self.write_usize(p.degree_bits)
        self.write_bool(p.hiding)

    def write_circuit_config(self, c) -> None:
        for x in (c.num_wires, c.num_routed_wires, c.num_constants, c.security_bits,
                  c.num_challenges, c.max_quotient_degree_factor):
            self.write_usize(x)
        self.write_bool(c.use_base_arithmetic_gate)
        self.write_bool(c.zero_knowledge)
        self.write_fri_config(c.fri_config)

    def write_gate(self, gate) -> None:
        """The gate's tag and parameters; a lookup gate's LUT by its index
        in the common data's LUTs (`self.luts`), then its hash."""
        name = type(gate).__name__
        if name not in _TAG_OF:
            raise ValueError(f"no registry tag for {gate.id()}")
        self.write_u32(_TAG_OF[name])
        if isinstance(gate, (ArithmeticGate, ArithmeticExtensionGate, MulExtensionGate)):
            self.write_usize(gate.num_ops)
        elif isinstance(gate, BaseSumGate):
            if gate.base != 2:
                raise ValueError("the registry's BaseSumGate tag is BaseSumGate<2>")
            self.write_usize(gate.num_limbs)
        elif isinstance(gate, ConstantGate):
            self.write_usize(gate.num_consts)
        elif isinstance(gate, ExponentiationGate):
            self.write_usize(gate.num_power_bits)
        elif isinstance(gate, (LookupGate, LookupTableGate)):
            self.write_usize(gate.num_slots)
            if isinstance(gate, LookupTableGate):
                self.write_usize(gate.last_lut_row)
            self.write_usize(self.luts.index(gate.lut))
            self.buf += gate.lut_hash
        elif isinstance(gate, CosetInterpolationGate):
            self.write_usize(gate.subgroup_bits)
            self.write_usize(gate.degree())
            self.write_usize(len(gate.barycentric_weights))
            self.write_field_vec(gate.barycentric_weights)
        elif isinstance(gate, RandomAccessGate):
            for x in (gate.bits, gate.num_copies, gate.num_extra_constants):
                self.write_usize(x)
        elif isinstance(gate, (ReducingGate, ReducingExtensionGate)):
            self.write_usize(gate.num_coeffs)
        # Noop, PoseidonMds, Poseidon, PublicInput: no payload

    def write_common_circuit_data(self, common: CommonCircuitData) -> None:
        self.write_circuit_config(common.config)
        self.write_fri_params(common.fri_params)
        si = common.selectors_info
        self.write_usize_vec(si.selector_indices)
        self.write_usize(len(si.groups))
        for gr in si.groups:
            self.write_usize(gr.start)
            self.write_usize(gr.stop)
        for x in (common.quotient_degree_factor, common.num_gate_constraints,
                  common.num_constants, common.num_public_inputs, len(common.k_is)):
            self.write_usize(x)
        self.write_field_vec(common.k_is)
        for x in (common.num_partial_products, common.num_lookup_polys,
                  common.num_lookup_selectors):
            self.write_usize(x)
        self.luts = common.luts
        self.write_usize(len(common.luts))
        for lut in common.luts:
            self.write_usize(len(lut))
            for i, o in lut:
                self.buf += struct.pack("<HH", i, o)
        self.write_usize(len(common.gates))
        for gate in common.gates:
            self.write_gate(gate)

    def write_verifier_only_circuit_data(self, vd: VerifierOnlyCircuitData) -> None:
        self.write_usize((len(vd.constants_sigmas_cap) - 1).bit_length())
        self.write_merkle_cap(vd.constants_sigmas_cap)
        self.write_hash(vd.circuit_digest)


class ProverWriter(CircuitWriter):
    """The circuit writer with targets (reference mod.rs:205-266)."""

    def write_target(self, t) -> None:
        if isinstance(t, Wire):
            self.write_bool(True)
            self.write_usize(t.row)
            self.write_usize(t.column)
        else:
            self.write_bool(False)
            self.write_usize(t.index)

    def write_target_vec(self, v) -> None:
        self.write_usize(len(v))
        for t in v:
            self.write_target(t)

    def write_target_ext(self, et: ExtensionTarget) -> None:
        for t in et.parts:
            self.write_target(t)

    def write_byte_string(self, b: bytes) -> None:
        self.write_usize(len(b))
        self.buf += b


def _write_dummy_proof_generator(w: ProverWriter, gen) -> None:
    """Tag 6's payload (reference prover_serialization.py:346)."""
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes

    w.write_usize(len(gen.verifier_data_target.constants_sigmas_cap))
    w.write_target_vec(flatten_targets(gen.verifier_data_target, []))
    w.write_byte_string(verifier_data_to_bytes(gen.verifier_only, gen.inner_common))
    w.write_target_vec(flatten_targets(gen.proof_with_pis_target, []))
    w.write_byte_string(proof_to_bytes(gen.proof_with_pis))


def _write_generator_payload(w: ProverWriter, gen) -> None:
    """A registry generator's payload (reference prover_serialization.py:117;
    the reference's file:line per kind there)."""
    name = type(gen).__name__
    if name in ("ArithmeticBaseGenerator", "ArithmeticExtensionGenerator"):
        w.write_usize(gen.row)
        w.write_field(gen.const_0)
        w.write_field(gen.const_1)
        w.write_usize(gen.i)
    elif name == "BaseSplitGenerator":
        w.write_usize(gen.row)
        w.write_usize(gen.num_limbs)
    elif name == "ConstantGenerator":
        w.write_usize(gen.row)
        w.write_usize(gen.constant_index)
        w.write_usize(gen.wire_index)
        w.write_field(gen.constant)
    elif name == "CopyGenerator":
        w.write_target(gen.src)
        w.write_target(gen.dst)
    elif name == "DummyProofGenerator":
        _write_dummy_proof_generator(w, gen)
    elif name == "EqualityGenerator":
        for t in (gen.x, gen.y, gen.equal, gen.inv_hint):
            w.write_target(t)
    elif name == "ExponentiationGenerator":
        w.write_usize(gen.row)
        w.write_usize(gen.num_power_bits)
    elif name == "LookupGenerator":
        w.write_usize(gen.row)
        w.write_usize(gen.slot_nb)
        w.write_usize(w.luts.index(gen.lut))
    elif name == "LookupTableGenerator":
        for x in (gen.row, gen.slot_nb, gen.num_slots, gen.last_lut_row):
            w.write_usize(x)
        w.write_usize(w.luts.index(gen.lut))
    elif name == "InterpolationGenerator":
        w.write_usize(gen.row)
        w.write_usize(gen.subgroup_bits)
        w.write_usize(gen.degree)
        weights = gen._gate().barycentric_weights
        w.write_usize(len(weights))
        w.write_field_vec(weights)
    elif name == "LowHighGenerator":
        w.write_target(gen.integer)
        w.write_usize(gen.n_log)
        w.write_target(gen.low)
        w.write_target(gen.high)
    elif name == "MulExtensionGenerator":
        w.write_usize(gen.row)
        w.write_field(gen.const_0)
        w.write_usize(gen.i)
    elif name == "NonzeroTestGenerator":
        w.write_target(gen.to_test)
        w.write_target(gen.dummy)
    elif name in ("PoseidonGenerator", "PoseidonMdsGenerator"):
        w.write_usize(gen.row)
    elif name == "QuotientGeneratorExtension":
        for et in (gen.numerator, gen.denominator, gen.quotient):
            w.write_target_ext(et)
    elif name == "RandomAccessGenerator":
        for x in (gen.row, gen.copy, gen.bits, gen.num_copies, gen.num_extra_constants):
            w.write_usize(x)
    elif name == "RandomValueGenerator":
        w.write_target(gen.target)
    elif name in ("ReducingGenerator", "ReducingExtensionGenerator"):
        w.write_usize(gen.row)
        w.write_usize(gen.num_coeffs)
    elif name == "WireSplitGenerator":
        w.write_target(gen.integer)
        w.write_usize_vec([int(v) for v in gen.gates])
        w.write_usize(gen.num_limbs)
    elif name == "InverseGenerator":
        w.write_target(gen.x)
        w.write_target(gen.inv)
    else:
        raise ValueError(f"unsupported generator {name}")


def write_generator(w: ProverWriter, gen, registry=None) -> None:
    """`gen`'s tag in `registry` (default `default_registry()`), then its
    payload; a class outside the default registry writes its own
    (`serialize(w)`). Raises the reference's ValueError (reference
    prover_serialization.py:463-473) for a generator outside the
    registry."""
    registry = registry or default_registry()
    t = type(gen)
    for tag, cls in enumerate(registry):
        if cls is t:
            w.write_u32(tag)
            if hasattr(gen, "serialize"):
                gen.serialize(w)
            else:
                _write_generator_payload(w, gen)
            return
    raise ValueError(
        f"generator {t.__name__} is not in the serializer registry; pass a "
        f"custom registry (reference WitnessGeneratorSerializer pattern)")


def write_polynomial_batch(w: ProverWriter, coeffs, rate_bits: int,
                           blinding: bool = False) -> None:
    """The constants-sigmas batch as the reference writes it (reference
    prover_serialization.py:488): the coefficient matrix, then degree_log,
    rate_bits and blinding (a built circuit's is never salted, zero
    knowledge or not); its LDE and tree are recomputed on reading, salted
    from the prover rng where the flag says so."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint64)
    w.write_usize(coeffs.shape[0])
    w.write_usize(coeffs.shape[1])
    w.buf += coeffs.astype("<u8").tobytes()
    w.write_usize(int(coeffs.shape[1]).bit_length() - 1)
    w.write_usize(rate_bits)
    w.write_bool(blinding)


def write_prover_only_circuit_data(w: ProverWriter, prover_only, common,
                                   registry=None) -> None:
    """In the reference's field order (reference mod.rs:1834-1933)."""
    w.luts = common.luts
    w.write_usize(len(prover_only.generators))
    for gen in prover_only.generators:
        write_generator(w, gen, registry)
    watches = prover_only.generator_indices_by_watches
    w.write_usize(len(watches))
    for k in sorted(watches):
        w.write_usize(int(k))
        w.write_usize_vec([int(v) for v in watches[k]])
    write_polynomial_batch(w, prover_only.constants_sigmas_coeffs,
                           common.config.fri_config.rate_bits,
                           prover_only.constants_sigmas_blinding)
    sigmas = np.ascontiguousarray(prover_only.sigmas, dtype=np.uint64)
    w.write_usize(sigmas.shape[0])
    w.write_usize(sigmas.shape[1])
    w.buf += sigmas.astype("<u8").tobytes()
    subgroup = np.ascontiguousarray(prover_only.subgroup, dtype=np.uint64)
    w.write_usize(len(subgroup))
    w.buf += subgroup.astype("<u8").tobytes()
    w.write_target_vec(prover_only.public_inputs)
    w.write_usize_vec([int(v) for v in prover_only.representative_map])
    w.write_bool(False)  # no FFT root table
    w.write_hash(prover_only.circuit_digest)
    w.write_usize(len(prover_only.lookup_rows))
    for lw in prover_only.lookup_rows:
        for x in (lw.last_lu_gate, lw.last_lut_gate, lw.first_lut_gate):
            w.write_usize(x)
    w.write_usize(len(prover_only.lut_to_lookups))
    for lookups in prover_only.lut_to_lookups:
        w.write_usize(len(lookups))
        for looking_in, looking_out in lookups:
            w.write_target(looking_in)
            w.write_target(looking_out)


def circuit_data_to_bytes(data, registry=None) -> bytes:
    """CircuitData -> the reference's `circuit_data_to_bytes` (reference
    prover_serialization.py:619)."""
    w = ProverWriter()
    w.write_common_circuit_data(data.common)
    write_prover_only_circuit_data(w, data.prover_only, data.common, registry)
    w.write_verifier_only_circuit_data(data.verifier_only)
    return bytes(w.buf)


def prover_data_to_bytes(prover_only, common, registry=None) -> bytes:
    """(ProverOnlyCircuitData, CommonCircuitData) -> the reference's
    `prover_data_to_bytes` (reference prover_serialization.py:639)."""
    w = ProverWriter()
    w.write_common_circuit_data(common)
    write_prover_only_circuit_data(w, prover_only, common, registry)
    return bytes(w.buf)


def read_prover_data(data: bytes, registry=None):
    """`prover_data_to_bytes` -> (ProverOnlyCircuitData, CommonCircuitData)."""
    r = Reader(data, registry=registry)
    common = r.common_circuit_data()
    prover_only = r.prover_only_circuit_data(common)
    r.finish()
    return prover_only, common


def read_circuit_data(data: bytes, registry=None):
    """`circuit_data_to_bytes` -> (ProverOnlyCircuitData, CommonCircuitData,
    VerifierOnlyCircuitData)."""
    r = Reader(data, registry=registry)
    common = r.common_circuit_data()
    prover_only = r.prover_only_circuit_data(common)
    verifier_only = r.verifier_only_circuit_data()
    r.finish()
    return prover_only, common, verifier_only
