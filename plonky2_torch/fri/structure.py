"""FRI instance descriptors (reference fri/structure.rs:14-93)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FriOracleInfo:
    num_polys: int
    blinding: bool


@dataclass(frozen=True)
class FriPolynomialInfo:
    oracle_index: int
    polynomial_index: int

    @staticmethod
    def from_range(oracle_index: int, polynomial_indices: range) -> list["FriPolynomialInfo"]:
        return [FriPolynomialInfo(oracle_index, i) for i in polynomial_indices]


@dataclass
class FriBatchInfo:
    point: tuple  # extension element
    polynomials: list[FriPolynomialInfo]


@dataclass
class FriInstanceInfo:
    oracles: list[FriOracleInfo]
    batches: list[FriBatchInfo]


@dataclass
class FriOpeningBatch:
    values: list[tuple]  # extension elements


@dataclass
class FriOpenings:
    batches: list[FriOpeningBatch]
