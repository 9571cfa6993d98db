"""Circuit data (reference plonk/circuit_data.rs:161-680):
`CommonCircuitData` with the polynomial index ranges of each oracle and the
FRI instance; `ProverOnlyCircuitData` with the witness generators, the
preprocessed polynomials and per-device caches of their commitment and of
the quotient domain's tables; `VerifierOnlyCircuitData`, the
constants-sigmas cap and the circuit digest; and the entry points over
them: `ProverCircuitData` proves, `VerifierCircuitData` verifies, and
`CircuitData` (what `CircuitBuilder.build` returns) does both."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from plonky2_torch import device_key
from plonky2_torch.fri.config import FriParams
from plonky2_torch.fri.structure import (
    FriBatchInfo,
    FriInstanceInfo,
    FriOracleInfo,
    FriPolynomialInfo,
)
from plonky2_torch.field import scalar as fs
from plonky2_torch.plonk import config as pcfg
from plonky2_torch.plonk.config import CircuitConfig


@dataclass
class SelectorsInfo:
    selector_indices: list[int]
    groups: list[range]

    @property
    def num_selectors(self) -> int:
        return len(self.groups)


@dataclass
class CommonCircuitData:
    config: CircuitConfig
    fri_params: FriParams
    gates: list  # Gate instances, sorted by (degree, id)
    selectors_info: SelectorsInfo
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int
    num_public_inputs: int
    k_is: list[int]
    num_partial_products: int
    num_lookup_polys: int = 0  # a challenge's RE and partial-SLDC columns
    num_lookup_selectors: int = 0
    luts: list = field(default_factory=list)  # lists of (u16 input, u16 output)
    # the GenericConfig (None: Poseidon); not part of the reference's common
    # data, so left out of equality
    gc: object = field(default=None, compare=False)

    def generic_config(self):
        return self.gc if self.gc is not None else pcfg.poseidon_goldilocks_config()

    @property
    def degree_bits(self) -> int:
        return self.fri_params.degree_bits

    @property
    def degree(self) -> int:
        return 1 << self.degree_bits

    # polynomial index ranges within the commitments
    def constants_range(self) -> range:
        return range(0, self.num_constants)

    def sigmas_range(self) -> range:
        return range(self.num_constants, self.num_constants + self.config.num_routed_wires)

    def zs_range(self) -> range:
        return range(0, self.config.num_challenges)

    def partial_products_range(self) -> range:
        return range(self.config.num_challenges,
                     (self.num_partial_products + 1) * self.config.num_challenges)

    def lookup_range(self) -> range:
        """The lookup columns, after the Zs and partial products."""
        start = self.num_zs_partial_products_polys()
        return range(start, start + self.num_all_lookup_polys())

    def num_preprocessed_polys(self) -> int:
        return self.sigmas_range().stop

    def num_zs_partial_products_polys(self) -> int:
        return self.config.num_challenges * (1 + self.num_partial_products)

    def num_all_lookup_polys(self) -> int:
        return self.config.num_challenges * self.num_lookup_polys

    def num_quotient_polys(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    # the FRI instance: the lookup columns live in the Zs-partial-products
    # oracle but are opened after the quotient at ζ, and after the Zs at g·ζ
    def fri_all_polys(self) -> list[FriPolynomialInfo]:
        zpp = pcfg.ZS_PARTIAL_PRODUCTS.index
        return (
            FriPolynomialInfo.from_range(pcfg.CONSTANTS_SIGMAS.index,
                                         range(self.num_preprocessed_polys()))
            + FriPolynomialInfo.from_range(pcfg.WIRES.index, range(self.config.num_wires))
            + FriPolynomialInfo.from_range(zpp, range(self.num_zs_partial_products_polys()))
            + FriPolynomialInfo.from_range(pcfg.QUOTIENT.index,
                                           range(self.num_quotient_polys()))
            + FriPolynomialInfo.from_range(zpp, self.lookup_range()))

    def fri_next_batch_polys(self) -> list[FriPolynomialInfo]:
        zpp = pcfg.ZS_PARTIAL_PRODUCTS.index
        return (FriPolynomialInfo.from_range(zpp, self.zs_range())
                + FriPolynomialInfo.from_range(zpp, self.lookup_range()))

    def fri_oracles(self) -> list[FriOracleInfo]:
        return [
            FriOracleInfo(self.num_preprocessed_polys(), pcfg.CONSTANTS_SIGMAS.blinding),
            FriOracleInfo(self.config.num_wires, pcfg.WIRES.blinding),
            FriOracleInfo(self.num_zs_partial_products_polys() + self.num_all_lookup_polys(),
                          pcfg.ZS_PARTIAL_PRODUCTS.blinding),
            FriOracleInfo(self.num_quotient_polys(), pcfg.QUOTIENT.blinding),
        ]

    def get_fri_instance(self, zeta: tuple) -> FriInstanceInfo:
        zeta_next = fs.ext_scalar_mul(fs.primitive_root_of_unity(self.degree_bits), zeta)
        return FriInstanceInfo(
            oracles=self.fri_oracles(),
            batches=[FriBatchInfo(point=zeta, polynomials=self.fri_all_polys()),
                     FriBatchInfo(point=zeta_next, polynomials=self.fri_next_batch_polys())])


@dataclass
class ProverOnlyCircuitData:
    """What a prove needs beyond the common data. The preprocessed
    polynomials stay on the host as coefficients; `commitment(device)`
    commits them once per device and `caches` holds each device's tables
    (and, under "host", the witness engines' schedule and plan)."""

    constants_sigmas_coeffs: np.ndarray  # [num_constants + num_routed, degree] u64
    sigmas: np.ndarray  # [num_routed, degree] u64 values
    subgroup: np.ndarray  # [degree] u64
    circuit_digest: list[int]
    generators: list = field(default_factory=list, repr=False)
    # the batch's blinding flag as written (pcfg.CONSTANTS_SIGMAS: never)
    constants_sigmas_blinding: bool = pcfg.CONSTANTS_SIGMAS.blinding
    # partition representative -> indices of the generators that read it
    generator_indices_by_watches: dict = field(default_factory=dict, repr=False)
    public_inputs: list = field(default_factory=list)  # targets
    # flat target index (iop/target.py target_index) -> partition representative
    representative_map: np.ndarray | None = field(default=None, repr=False)
    # lookups: each LUT's region of rows (gadgets/lookup.py LookupWire) and
    # its (looking in, looking out) target pairs
    lookup_rows: list = field(default_factory=list)
    lut_to_lookups: list = field(default_factory=list, repr=False)
    caches: dict = field(default_factory=dict, repr=False, compare=False)

    def cache(self, device) -> dict:
        """The tables of `device` ("host": the witness engines'); a card
        named without its index is the current one, so "cuda" and
        "cuda:0" share one entry."""
        key = device if device == "host" else str(device_key(device))
        return self.caches.setdefault(key, {})

    def commitment(self, common: CommonCircuitData, device):
        """The constants-sigmas PolynomialBatch on `device` (built once)."""
        from plonky2_torch.fri.oracle import PolynomialBatch

        cache = self.cache(device)
        if "constants_sigmas" not in cache:
            fri = common.config.fri_config
            cache["constants_sigmas"] = PolynomialBatch.from_coeffs(
                self.constants_sigmas_coeffs, fri.rate_bits,
                self.constants_sigmas_blinding, fri.cap_height, device=device,
                hasher=common.generic_config().hasher)
        return cache["constants_sigmas"]


@dataclass
class VerifierOnlyCircuitData:
    constants_sigmas_cap: list  # 4-felt digests, or bytes under Keccak
    circuit_digest: list[int] | bytes


@dataclass
class ProverCircuitData:
    """Proving-only circuit data (reference plonk/circuit_data.rs:256-297)."""

    prover_only: ProverOnlyCircuitData
    common: CommonCircuitData

    def prove(self, inputs, device=None, timing=None):
        from plonky2_torch.plonk.prover import prove

        return prove(self.prover_only, self.common, inputs, device=device, timing=timing)

    def prove_many(self, inputs_list, device=None, timing=None, window: int = 3,
                   threads: int = 1):
        from plonky2_torch.plonk.prover import prove_many

        return prove_many(self.prover_only, self.common, inputs_list, device=device,
                          timing=timing, window=window, threads=threads)


@dataclass
class VerifierCircuitData:
    """Verification-only circuit data (reference plonk/circuit_data.rs:299-337)."""

    verifier_only: VerifierOnlyCircuitData
    common: CommonCircuitData

    def verify(self, proof_with_pis) -> None:
        from plonky2_torch.plonk.verifier import verify

        verify(proof_with_pis, self.verifier_only, self.common)

    def to_bytes(self) -> bytes:
        from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes

        return verifier_data_to_bytes(self.verifier_only, self.common)

    @staticmethod
    def from_bytes(data: bytes, gc=None) -> "VerifierCircuitData":
        from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes

        return VerifierCircuitData(*verifier_data_from_bytes(data, gc))


@dataclass
class MockCircuitData:
    """Witness-generation-only circuit data (reference
    plonk/circuit_data.rs:145)."""

    prover_only: ProverOnlyCircuitData
    common: CommonCircuitData

    def generate_witness(self, inputs):
        """The PartialWitness that `inputs` generate."""
        from plonky2_torch.iop.generator import generate_partial_witness

        return generate_partial_witness(inputs, self.prover_only, self.common)


@dataclass
class CircuitData:
    """A built circuit (reference plonk/circuit_data.rs:161-254).
    `build_info`: what the build ran where (its device, the kernel of the
    constants-sigmas iFFT) and, under zero knowledge, its blinding (regular
    rows, Z pairs)."""

    prover_only: ProverOnlyCircuitData
    verifier_only: VerifierOnlyCircuitData
    common: CommonCircuitData
    build_info: dict = field(default_factory=dict, compare=False)

    def prover_data(self) -> ProverCircuitData:
        return ProverCircuitData(self.prover_only, self.common)

    def verifier_data(self) -> VerifierCircuitData:
        return VerifierCircuitData(self.verifier_only, self.common)

    def mock(self) -> MockCircuitData:
        return MockCircuitData(self.prover_only, self.common)

    def prove(self, inputs, device=None, timing=None):
        """Prove from `inputs` (a PartialWitness) on `device` (CUDA unless
        the caller asks for another)."""
        return self.prover_data().prove(inputs, device=device, timing=timing)

    def verify(self, proof_with_pis) -> None:
        self.verifier_data().verify(proof_with_pis)

    def compress(self, proof_with_pis):
        """The proof compressed (plonk/compressed.py; reference
        circuit_data.rs:206-215)."""
        from plonky2_torch.plonk.compressed import compress

        return compress(proof_with_pis, self.verifier_only, self.common)

    def decompress(self, compressed_proof):
        from plonky2_torch.plonk.compressed import decompress

        return decompress(compressed_proof, self.verifier_only, self.common)

    def verify_compressed(self, compressed_proof) -> None:
        from plonky2_torch.plonk.compressed import verify_compressed

        verify_compressed(compressed_proof, self.verifier_only, self.common)
