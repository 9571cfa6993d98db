"""Read the reference package's circuit bytes into the port's circuit data.

`read_prover_data` reads `prover_data_to_bytes` (common data, then the
prover-only data); `read_circuit_data` reads `circuit_data_to_bytes`
(common, prover-only, verifier-only), the layout of
`bench_cache/middle14.circuit.bin`. Layouts: the reference's
`plonk/circuit_serialization.py:192-323` (common data, gate tags) and
`plonk/prover_serialization.py:250-345, 476-617` (generator payloads,
prover-only fields), all integers little-endian.

The witness generators are read into the port's generator objects, with
the watch lists, the public-input targets and the representative map; the
lookup rows are stepped over. A gate or generator tag the port has no class
for raises ValueError. Only Poseidon digests are read
(`PoseidonGoldilocksConfig`).
"""

from __future__ import annotations

import struct

import numpy as np

from plonky2_torch.fri.config import FriConfig, FriParams, FriReductionStrategy
from plonky2_torch.gadgets.extension_arithmetic import QuotientGeneratorExtension
from plonky2_torch.gadgets.split_join import WireSplitGenerator
from plonky2_torch.gates.arithmetic_base import ArithmeticGate
from plonky2_torch.gates.arithmetic_extension import (
    ArithmeticExtensionGate,
    ArithmeticExtensionGenerator,
    MulExtensionGate,
    MulExtensionGenerator,
)
from plonky2_torch.gates.base_sum import BaseSplitGenerator, BaseSumGate
from plonky2_torch.gates.coset_interpolation import CosetInterpolationGate, InterpolationGenerator
from plonky2_torch.gates.poseidon_gate import PoseidonGate, PoseidonGenerator
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
from plonky2_torch.iop.target import ExtensionTarget, VirtualTarget, Wire
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
    ("ExponentiationGate", None),
    ("LookupGate", None),
    ("LookupTableGate", None),
    ("MulExtensionGate", lambda r: MulExtensionGate(r.usize())),
    ("NoopGate", lambda r: NoopGate()),
    ("PoseidonMdsGate", None),
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
    ("DummyProofGenerator", None),
    ("EqualityGenerator", None),
    ("ExponentiationGenerator", None),
    ("InterpolationGenerator", lambda r: _interpolation_generator(r)),
    ("LookupGenerator", None),
    ("LookupTableGenerator", None),
    ("LowHighGenerator", None),
    ("MulExtensionGenerator", lambda r: MulExtensionGenerator(r.usize(), r.field(), r.usize())),
    ("NonzeroTestGenerator", lambda r: NonzeroTestGenerator(r.target(), r.target())),
    ("PoseidonGenerator", lambda r: PoseidonGenerator(r.usize())),
    ("PoseidonMdsGenerator", None),
    ("QuotientGeneratorExtension", lambda r: QuotientGeneratorExtension(
        r.ext_target(), r.ext_target(), r.ext_target())),
    ("RandomAccessGenerator", lambda r: _random_access_generator(r)),
    ("RandomValueGenerator", lambda r: RandomValueGenerator(r.target())),
    ("ReducingGenerator", lambda r: ReducingGenerator(r.usize(), r.usize())),
    ("ReducingExtensionGenerator", lambda r: ReducingExtensionGenerator(r.usize(), r.usize())),
    ("SplitGenerator", None),
    ("WireSplitGenerator", lambda r: WireSplitGenerator(
        r.target(), [int(v) for v in r.usize_vec()], r.usize())),
    ("InverseGenerator", None),
]


class Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

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

    def hash(self) -> list[int]:
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

    def skip_target(self) -> None:
        is_wire = self.bool()
        self.pos += 16 if is_wire else 8

    def skip_vec(self, item_bytes: int) -> None:
        """Step over a length-prefixed vector of fixed-size items."""
        n = self.usize()
        self.pos += item_bytes * n

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
        for _ in range(self.usize()):  # lookup tables: (u16, u16) pairs
            self.skip_vec(4)
        gates = [self.gate() for _ in range(self.usize())]
        return CommonCircuitData(
            config=config, fri_params=fri_params, gates=gates,
            selectors_info=selectors_info, quotient_degree_factor=qdf,
            num_gate_constraints=num_gate_constraints, num_constants=num_constants,
            num_public_inputs=num_public_inputs, k_is=k_is,
            num_partial_products=num_partial_products, num_lookup_polys=num_lookup_polys,
            num_lookup_selectors=num_lookup_selectors)

    # -- prover-only circuit data ---------------------------------------------

    def generator(self):
        tag = self.u32()
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
        if (1 << degree_log != coeffs.shape[1] or blinding
                or rate_bits != common.config.fri_config.rate_bits):
            raise ValueError("constants-sigmas batch does not match the common data")
        sigmas = self.matrix()
        subgroup = self.u64_array(self.usize())
        public_inputs = self.target_vec()
        representative_map = self.usize_vec().astype(np.int64)
        if self.bool():
            raise ValueError("an FFT root table is not expected")
        circuit_digest = self.hash()
        self.skip_vec(24)  # lookup rows: 3 usizes each
        for _ in range(self.usize()):  # lut_to_lookups: target pairs
            for _ in range(2 * self.usize()):
                self.skip_target()
        return ProverOnlyCircuitData(constants_sigmas_coeffs=coeffs, sigmas=sigmas,
                                     subgroup=subgroup, circuit_digest=circuit_digest,
                                     generators=generators,
                                     generator_indices_by_watches=watches,
                                     public_inputs=public_inputs,
                                     representative_map=representative_map)

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


def _interpolation_generator(r: Reader) -> InterpolationGenerator:
    gen = InterpolationGenerator(r.usize(), r.usize(), r.usize())
    if r.field_vec(r.usize()) != gen._gate().barycentric_weights:
        raise ValueError("InterpolationGenerator payload disagrees with its parameters")
    return gen


def _random_access_generator(r: Reader) -> RandomAccessGenerator:
    row, copy, bits, num_copies, num_extra = (r.usize() for _ in range(5))
    return RandomAccessGenerator(row, bits, num_copies, num_extra, copy)


def read_prover_data(data: bytes):
    """`prover_data_to_bytes` -> (ProverOnlyCircuitData, CommonCircuitData)."""
    r = Reader(data)
    common = r.common_circuit_data()
    prover_only = r.prover_only_circuit_data(common)
    r.finish()
    return prover_only, common


def read_circuit_data(data: bytes):
    """`circuit_data_to_bytes` -> (ProverOnlyCircuitData, CommonCircuitData,
    VerifierOnlyCircuitData)."""
    r = Reader(data)
    common = r.common_circuit_data()
    prover_only = r.prover_only_circuit_data(common)
    verifier_only = r.verifier_only_circuit_data()
    r.finish()
    return prover_only, common, verifier_only
