"""Circuit configuration and the PLONK oracles' indices and FRI blinding
roles, as the reference package's `plonk/config.py` defines them (reference
plonk/circuit_data.rs:62-141, plonk/plonk_common.rs:18-41). Only
`PoseidonGoldilocksConfig` is ported; the Keccak transcript is ROADMAP
item 11 and is refused by name."""

from __future__ import annotations

from dataclasses import dataclass, field

from plonky2_torch.fri.config import FriConfig, FriReductionStrategy

POSEIDON_GOLDILOCKS = "PoseidonGoldilocksConfig"
KECCAK_GOLDILOCKS = "KeccakGoldilocksConfig"


def check_generic_config(gc) -> None:
    """Raise unless `gc` (None, a name, or an object with a `name`) is the
    Poseidon config, the only one the port has."""
    name = POSEIDON_GOLDILOCKS if gc is None else getattr(gc, "name", gc)
    if name != POSEIDON_GOLDILOCKS:
        raise NotImplementedError(
            f"{name} is not ported (the port has {POSEIDON_GOLDILOCKS} only; "
            f"{KECCAK_GOLDILOCKS} is ROADMAP item 11)")


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
