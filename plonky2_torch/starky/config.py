"""StarkConfig (reference starky/src/config.rs; the reference package's
starky/config.py)."""

from __future__ import annotations

from dataclasses import dataclass, field

from plonky2_torch.fri.config import FriConfig, FriReductionStrategy


@dataclass(frozen=True)
class StarkConfig:
    security_bits: int = 100
    num_challenges: int = 2
    fri_config: FriConfig = field(
        default_factory=lambda: FriConfig(
            rate_bits=1,
            cap_height=4,
            proof_of_work_bits=16,
            reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
            num_query_rounds=84,
        )
    )

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig()

    def fri_params(self, degree_bits: int):
        return self.fri_config.fri_params(degree_bits, False)

    def observe(self, challenger) -> None:
        challenger.observe_element(self.security_bits)
        challenger.observe_element(self.num_challenges)
        self.fri_config.observe(challenger)
