"""Circuit configuration and the PLONK oracles' indices and FRI blinding
roles, as the reference package's `plonk/config.py` defines them (reference
plonk/circuit_data.rs:62-141, plonk/plonk_common.rs:18-41). Only
`PoseidonGoldilocksConfig` is ported."""

from __future__ import annotations

from dataclasses import dataclass

from plonky2_torch.fri.config import FriConfig


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
    num_wires: int
    num_routed_wires: int
    num_constants: int
    use_base_arithmetic_gate: bool
    security_bits: int
    num_challenges: int
    zero_knowledge: bool
    max_quotient_degree_factor: int
    fri_config: FriConfig
