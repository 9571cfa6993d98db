"""Read the reference package's circuit bytes into the port's circuit data.

`read_prover_data` reads `prover_data_to_bytes` (common data, then the
prover-only data); `read_circuit_data` reads `circuit_data_to_bytes`
(common, prover-only, verifier-only), the layout of
`bench_cache/middle14.circuit.bin`. Layouts: the reference's
`plonk/circuit_serialization.py:192-323` (common data, gate tags) and
`plonk/prover_serialization.py:250-345, 498-617` (generator payloads,
prover-only fields), all integers little-endian.

The prover needs no witness generators, so their section is stepped over
by each tag's payload layout; so are the watch lists, the public-input
targets, the representative map and the lookup rows. A gate or generator
tag the port does not know raises ValueError. Only Poseidon digests are
read (`PoseidonGoldilocksConfig`).
"""

from __future__ import annotations

import struct

import numpy as np

from plonky2_torch.fri.config import FriConfig, FriParams, FriReductionStrategy
from plonky2_torch.gates.arithmetic_base import ArithmeticGate
from plonky2_torch.gates.arithmetic_extension import ArithmeticExtensionGate, MulExtensionGate
from plonky2_torch.gates.base_sum import BaseSumGate
from plonky2_torch.gates.coset_interpolation import CosetInterpolationGate
from plonky2_torch.gates.poseidon_gate import PoseidonGate
from plonky2_torch.gates.random_access import RandomAccessGate
from plonky2_torch.gates.reducing import ReducingExtensionGate, ReducingGate
from plonky2_torch.gates.simple_gates import ConstantGate, NoopGate, PublicInputGate
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

# each generator tag's payload: u = usize, f = field, t = target,
# e = extension target (two targets), U = usize vec, F = field vec (both
# length-prefixed); None: the tag has no generator in the reference either
GENERATOR_PAYLOADS = [
    ("ArithmeticBaseGenerator", "uffu"),
    ("ArithmeticExtensionGenerator", "uffu"),
    ("BaseSplitGenerator", "uu"),
    ("BaseSumGenerator", None),
    ("ConstantGenerator", "uuuf"),
    ("CopyGenerator", "tt"),
    ("DummyProofGenerator", "dummy"),
    ("EqualityGenerator", "tttt"),
    ("ExponentiationGenerator", "uu"),
    ("InterpolationGenerator", "uuuF"),
    ("LookupGenerator", "uuu"),
    ("LookupTableGenerator", "uuuuu"),
    ("LowHighGenerator", "tutt"),
    ("MulExtensionGenerator", "ufu"),
    ("NonzeroTestGenerator", "tt"),
    ("PoseidonGenerator", "u"),
    ("PoseidonMdsGenerator", "u"),
    ("QuotientGeneratorExtension", "eee"),
    ("RandomAccessGenerator", "uuuuu"),
    ("RandomValueGenerator", "t"),
    ("ReducingGenerator", "uu"),
    ("ReducingExtensionGenerator", "uu"),
    ("SplitGenerator", None),
    ("WireSplitGenerator", "tUu"),
    ("InverseGenerator", "tt"),
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

    def skip_target(self) -> None:
        is_wire = self.bool()
        self.pos += 16 if is_wire else 8

    def skip_target_vec(self) -> None:
        for _ in range(self.usize()):
            self.skip_target()

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

    def skip_generator(self) -> None:
        tag = self.u32()
        if tag >= len(GENERATOR_PAYLOADS):
            raise ValueError(f"unknown generator tag {tag}")
        name, layout = GENERATOR_PAYLOADS[tag]
        if layout is None:
            raise ValueError(f"generator tag {tag} ({name}) has no known payload")
        if layout == "dummy":
            # cap length, verifier-data targets, verifier-data bytes, proof
            # targets, proof bytes (reference prover_serialization.py:386-405)
            self.usize()
            self.skip_target_vec()
            self.skip_vec(1)
            self.skip_target_vec()
            self.skip_vec(1)
            return
        for kind in layout:
            if kind in "uf":
                self.pos += 8
            elif kind == "t":
                self.skip_target()
            elif kind == "e":
                self.skip_target()
                self.skip_target()
            else:  # "U", "F": length-prefixed
                self.skip_vec(8)

    def matrix(self) -> np.ndarray:
        rows, cols = self.usize(), self.usize()
        return self.u64_array(rows * cols).reshape(rows, cols)

    def prover_only_circuit_data(self, common: CommonCircuitData) -> ProverOnlyCircuitData:
        for _ in range(self.usize()):
            self.skip_generator()
        for _ in range(self.usize()):  # generator indices by watch
            self.usize()
            self.skip_vec(8)
        coeffs = self.matrix()  # the constants-sigmas batch's coefficients
        degree_log, rate_bits, blinding = self.usize(), self.usize(), self.bool()
        if (1 << degree_log != coeffs.shape[1] or blinding
                or rate_bits != common.config.fri_config.rate_bits):
            raise ValueError("constants-sigmas batch does not match the common data")
        sigmas = self.matrix()
        subgroup = self.u64_array(self.usize())
        self.skip_target_vec()  # public-input targets
        self.skip_vec(8)  # representative map
        if self.bool():
            raise ValueError("an FFT root table is not expected")
        circuit_digest = self.hash()
        self.skip_vec(24)  # lookup rows: 3 usizes each
        for _ in range(self.usize()):  # lut_to_lookups: target pairs
            for _ in range(2 * self.usize()):
                self.skip_target()
        return ProverOnlyCircuitData(constants_sigmas_coeffs=coeffs, sigmas=sigmas,
                                     subgroup=subgroup, circuit_digest=circuit_digest)

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
