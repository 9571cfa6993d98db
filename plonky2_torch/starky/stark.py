"""The Stark base class: an AIR's shape and its FRI instance (reference
starky/src/stark.rs:25-279).

A subclass writes its constraints once against the ops protocol
(`eval(ops, frame, consumer)`); the prover, the verifier and the circuit
evaluate them with their own ops.
"""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.structure import (
    FriBatchInfo,
    FriInstanceInfo,
    FriOracleInfo,
    FriPolynomialInfo,
)


class Stark:
    COLUMNS: int = 0
    PUBLIC_INPUTS: int = 0

    def eval(self, ops, frame, consumer) -> None:
        """Emit all AIR constraints through the consumer."""
        raise NotImplementedError

    def constraint_degree(self) -> int:
        raise NotImplementedError

    def quotient_degree_factor(self) -> int:
        return max(1, self.constraint_degree() - 1) if self.constraint_degree() >= 1 else 0

    def num_quotient_polys(self, config) -> int:
        return self.quotient_degree_factor() * config.num_challenges

    # -- lookups and CTLs (none by default) -----------------------------------

    def lookups(self) -> list:
        return []

    def uses_lookups(self) -> bool:
        return len(self.lookups()) > 0

    def requires_ctls(self) -> bool:
        return False

    def num_lookup_helper_columns(self, config) -> int:
        return sum(
            lookup.num_helper_columns(self.constraint_degree()) for lookup in self.lookups()
        ) * config.num_challenges

    # -- the FRI instance (reference stark.rs:102-172) ------------------------

    def fri_instance(self, zeta, g: int, num_ctl_helpers: int, num_ctl_zs: list[int],
                     config) -> FriInstanceInfo:
        oracles = []
        trace_info = FriPolynomialInfo.from_range(len(oracles), range(0, self.COLUMNS))
        oracles.append(FriOracleInfo(self.COLUMNS, False))

        num_lookup_columns = self.num_lookup_helper_columns(config)
        num_auxiliary_polys = num_lookup_columns + num_ctl_helpers + len(num_ctl_zs)
        if self.uses_lookups() or self.requires_ctls():
            aux_info = FriPolynomialInfo.from_range(len(oracles), range(0, num_auxiliary_polys))
            oracles.append(FriOracleInfo(num_auxiliary_polys, False))
        else:
            aux_info = []

        num_quotient_polys = self.num_quotient_polys(config)
        if num_quotient_polys > 0:
            quotient_info = FriPolynomialInfo.from_range(
                len(oracles), range(0, num_quotient_polys))
            oracles.append(FriOracleInfo(num_quotient_polys, False))
        else:
            quotient_info = []

        zeta_batch = FriBatchInfo(point=zeta,
                                  polynomials=trace_info + aux_info + quotient_info)
        zeta_next = fs.ext_scalar_mul(g, zeta)
        zeta_next_batch = FriBatchInfo(point=zeta_next, polynomials=trace_info + aux_info)
        batches = [zeta_batch, zeta_next_batch]

        if self.requires_ctls():
            ctl_zs_info = FriPolynomialInfo.from_range(
                1, range(num_lookup_columns + num_ctl_helpers, num_auxiliary_polys))
            batches.append(FriBatchInfo(point=fs.ext_one(2), polynomials=ctl_zs_info))

        return FriInstanceInfo(oracles=oracles, batches=batches)
