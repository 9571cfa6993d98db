"""FRI configuration and derived parameters.

Parity: reference fri/mod.rs:31-118 (FriConfig/FriParams, challenger
observation order) and fri/reduction_strategies.rs (Fixed / ConstantArityBits /
MinSize).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FriReductionStrategy:
    """kind: 'fixed' | 'constant_arity' | 'min_size'."""

    kind: str = "constant_arity"
    arity_bits: int = 4
    final_poly_bits: int = 5
    fixed: tuple[int, ...] = ()
    max_arity_bits: int | None = None

    @staticmethod
    def Fixed(arities):
        return FriReductionStrategy(kind="fixed", fixed=tuple(arities))

    @staticmethod
    def ConstantArityBits(arity_bits, final_poly_bits):
        return FriReductionStrategy(
            kind="constant_arity", arity_bits=arity_bits, final_poly_bits=final_poly_bits
        )

    @staticmethod
    def MinSize(max_arity_bits=None):
        return FriReductionStrategy(kind="min_size", max_arity_bits=max_arity_bits)

    def reduction_arity_bits(
        self, degree_bits: int, rate_bits: int, cap_height: int, num_queries: int
    ) -> list[int]:
        if self.kind == "fixed":
            return list(self.fixed)
        if self.kind == "constant_arity":
            result = []
            db = degree_bits
            while db > self.final_poly_bits and db + rate_bits - self.arity_bits >= cap_height:
                assert db >= self.arity_bits
                result.append(self.arity_bits)
                db -= self.arity_bits
            return result
        if self.kind == "min_size":
            return _min_size_arity_bits(degree_bits, rate_bits, num_queries, self.max_arity_bits)
        raise ValueError(self.kind)

    def serialize_felts(self) -> list[int]:
        """Felts observed into the challenger (reference reduction_strategies.rs:60-81)."""
        if self.kind == "fixed":
            return [0] + list(self.fixed)
        if self.kind == "constant_arity":
            return [1, self.arity_bits, self.final_poly_bits]
        if self.kind == "min_size":
            return [2, self.max_arity_bits or 0]
        raise ValueError(self.kind)


def _min_size_arity_bits(degree_bits, rate_bits, num_queries, opt_max_arity_bits):
    max_arity_bits = opt_max_arity_bits if opt_max_arity_bits is not None else 4

    def relative_proof_size(arity_bits_seq):
        D = 4
        current_layer_bits = degree_bits + rate_bits
        total = 0
        for ab in arity_bits_seq:
            arity = 1 << ab
            total += (arity - 1) * D * num_queries
            total += current_layer_bits * 4 * num_queries
            current_layer_bits -= ab
        assert current_layer_bits >= rate_bits
        total += D * (1 << (current_layer_bits - rate_bits))
        return total

    def helper(prefix, global_max):
        sum_ar = sum(prefix)
        current_layer_bits = degree_bits + rate_bits - sum_ar
        assert current_layer_bits >= rate_bits
        best, best_size = list(prefix), relative_proof_size(prefix)
        max_ab = min(prefix[-1] if prefix else global_max, current_layer_bits - rate_bits)
        for next_ab in range(1, max_ab + 1):
            arity_bits, size = helper(prefix + [next_ab], global_max)
            if size < best_size:
                best, best_size = arity_bits, size
        return best, best_size

    return helper([], max_arity_bits)[0]


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int
    cap_height: int
    proof_of_work_bits: int
    reduction_strategy: FriReductionStrategy
    num_query_rounds: int

    def fri_params(self, degree_bits: int, hiding: bool) -> "FriParams":
        rab = self.reduction_strategy.reduction_arity_bits(
            degree_bits, self.rate_bits, self.cap_height, self.num_query_rounds
        )
        return FriParams(
            config=self,
            hiding=hiding,
            degree_bits=degree_bits,
            reduction_arity_bits=tuple(rab),
        )

    @property
    def num_cap_elements(self) -> int:
        return 1 << self.cap_height

    def observe(self, challenger) -> None:
        challenger.observe_element(self.rate_bits)
        challenger.observe_element(self.cap_height)
        challenger.observe_element(self.proof_of_work_bits)
        challenger.observe_elements(self.reduction_strategy.serialize_felts())
        challenger.observe_element(self.num_query_rounds)


@dataclass(frozen=True)
class FriParams:
    config: FriConfig
    hiding: bool
    degree_bits: int
    reduction_arity_bits: tuple[int, ...] = field(default_factory=tuple)

    def total_arities(self) -> int:
        return sum(self.reduction_arity_bits)

    def max_arity_bits(self):
        return max(self.reduction_arity_bits) if self.reduction_arity_bits else None

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    @property
    def lde_size(self) -> int:
        return 1 << self.lde_bits

    def final_poly_bits(self) -> int:
        return self.degree_bits - self.total_arities()

    def final_poly_len(self) -> int:
        return 1 << self.final_poly_bits()

    def observe(self, challenger) -> None:
        self.config.observe(challenger)
        challenger.observe_element(1 if self.hiding else 0)
        challenger.observe_element(self.degree_bits)
        challenger.observe_elements(list(self.reduction_arity_bits))
