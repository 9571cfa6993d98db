"""Carry state into the port: numpy uint64 arrays <-> the port's int64
tensors, and FRI parameters given by any object with the reference's field
names (for example the reference package's FriConfig/FriParams) -> the
port's dataclasses. Reads attributes only; imports nothing outside the port."""

from __future__ import annotations

from plonky2_torch.field import goldilocks as g
from plonky2_torch.fri.config import FriConfig, FriParams, FriReductionStrategy

to_tensor = g.tensor  # numpy uint64 -> int64 tensor on a device
to_numpy = g.to_numpy  # int64 tensor -> numpy uint64


def fri_reduction_strategy(s) -> FriReductionStrategy:
    return FriReductionStrategy(kind=s.kind, arity_bits=s.arity_bits,
                                final_poly_bits=s.final_poly_bits, fixed=tuple(s.fixed),
                                max_arity_bits=s.max_arity_bits)


def fri_config(c) -> FriConfig:
    return FriConfig(rate_bits=c.rate_bits, cap_height=c.cap_height,
                     proof_of_work_bits=c.proof_of_work_bits,
                     reduction_strategy=fri_reduction_strategy(c.reduction_strategy),
                     num_query_rounds=c.num_query_rounds)


def fri_params(p) -> FriParams:
    return FriParams(config=fri_config(p.config), hiding=p.hiding,
                     degree_bits=p.degree_bits,
                     reduction_arity_bits=tuple(p.reduction_arity_bits))
