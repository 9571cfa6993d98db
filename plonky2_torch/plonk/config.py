"""Circuit configuration, the generic configs and the PLONK oracles'
indices and FRI blinding roles, as the reference package's
`plonk/config.py` defines them (reference plonk/circuit_data.rs:62-141,
plonk/config.rs:95-126, plonk/plonk_common.rs:18-41).

A `GenericConfig` names the transcript and Merkle hasher and the in-circuit
(algebraic) hasher: `PoseidonGoldilocksConfig` hashes everything with
Poseidon; `KeccakGoldilocksConfig` commits and runs its transcript with
Keccak (the config of a proof posted where Keccak is cheap to verify) and
keeps Poseidon in-circuit."""

from __future__ import annotations

from dataclasses import dataclass, field

from plonky2_torch.fri.config import FriConfig, FriReductionStrategy

POSEIDON_GOLDILOCKS = "PoseidonGoldilocksConfig"
KECCAK_GOLDILOCKS = "KeccakGoldilocksConfig"


@dataclass(frozen=True)
class GenericConfig:
    """The runtime form of the reference's GenericConfig type: the
    transcript and Merkle hasher and the in-circuit hasher."""

    name: str
    hasher: object
    inner_hasher: object


def poseidon_goldilocks_config() -> GenericConfig:
    from plonky2_torch.hash.hashers import PoseidonHasher

    return GenericConfig(POSEIDON_GOLDILOCKS, PoseidonHasher, PoseidonHasher)


def keccak_goldilocks_config() -> GenericConfig:
    from plonky2_torch.hash.hashers import KeccakHasher, PoseidonHasher

    return GenericConfig(KECCAK_GOLDILOCKS, KeccakHasher, PoseidonHasher)


def check_generic_config(gc) -> GenericConfig:
    """`gc` (None for Poseidon, a config's name, or a config with a `name`)
    as the port's GenericConfig; raise for a config the port does not
    have."""
    name = POSEIDON_GOLDILOCKS if gc is None else getattr(gc, "name", gc)
    if name == POSEIDON_GOLDILOCKS:
        return poseidon_goldilocks_config()
    if name == KECCAK_GOLDILOCKS:
        return keccak_goldilocks_config()
    raise NotImplementedError(f"{name} is not ported (the port has {POSEIDON_GOLDILOCKS} "
                              f"and {KECCAK_GOLDILOCKS})")


@dataclass(frozen=True)
class PlonkOracle:
    index: int
    blinding: bool


CONSTANTS_SIGMAS = PlonkOracle(0, False)
WIRES = PlonkOracle(1, True)
ZS_PARTIAL_PRODUCTS = PlonkOracle(2, True)
QUOTIENT = PlonkOracle(3, True)


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 135
    num_routed_wires: int = 80
    num_constants: int = 2
    use_base_arithmetic_gate: bool = True
    security_bits: int = 100
    num_challenges: int = 2
    zero_knowledge: bool = False
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = field(default_factory=lambda: FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=16,
        reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
        num_query_rounds=28))

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        return CircuitConfig()

    @staticmethod
    def standard_recursion_zk_config() -> "CircuitConfig":
        """The standard config with zero knowledge: blinding rows in the
        circuit and salted wires, Zs and quotient commitments."""
        return CircuitConfig(zero_knowledge=True)
