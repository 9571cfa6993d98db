"""Carry state into the port: numpy uint64 arrays <-> the port's int64
tensors, and FRI parameters given by any object with the reference's field
names (for example the reference package's FriConfig/FriParams) -> the
port's dataclasses, the reference's StarkConfig, logUp lookups and
cross-table lookups -> the port's, and the reference's gates, targets and
circuit data -> the port's. Reads attributes only; imports nothing outside the port."""

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


def stark_config(c):
    """The port's StarkConfig for a reference StarkConfig."""
    from plonky2_torch.starky.config import StarkConfig

    return StarkConfig(security_bits=c.security_bits, num_challenges=c.num_challenges,
                       fri_config=fri_config(c.fri_config))


def column(c):
    """The port's starky Column for a reference Column."""
    from plonky2_torch.starky.lookup import Column

    return Column(linear_combination=[tuple(p) for p in c.linear_combination],
                  next_row_linear_combination=[tuple(p) for p in c.next_row_linear_combination],
                  constant=c.constant)


def filter_(f):
    """The port's starky Filter for a reference Filter."""
    from plonky2_torch.starky.lookup import Filter

    return Filter(products=[(column(a), column(b)) for a, b in f.products],
                  constants=[column(c) for c in f.constants])


def lookup(lk):
    """The port's starky Lookup for a reference Lookup."""
    from plonky2_torch.starky.lookup import Lookup

    return Lookup(columns=[column(c) for c in lk.columns],
                  table_column=column(lk.table_column),
                  frequencies_column=column(lk.frequencies_column),
                  filter_columns=[filter_(f) for f in lk.filter_columns])


def cross_table_lookup(ctl):
    """The port's CrossTableLookup for a reference CrossTableLookup."""
    from plonky2_torch.starky.cross_table_lookup import CrossTableLookup, TableWithColumns

    def table(t):
        return TableWithColumns(t.table, [column(c) for c in t.columns], filter_(t.filter))

    return CrossTableLookup(looking_tables=[table(t) for t in ctl.looking_tables],
                            looked_table=table(ctl.looked_table))


def fri_params(p) -> FriParams:
    return FriParams(config=fri_config(p.config), hiding=p.hiding,
                     degree_bits=p.degree_bits,
                     reduction_arity_bits=tuple(p.reduction_arity_bits))


def lut(table) -> list[tuple[int, int]]:
    return [(int(i), int(o)) for i, o in table]


def target(t):
    """The port's Wire or VirtualTarget for a reference target."""
    from plonky2_torch.iop.target import VirtualTarget, Wire

    return Wire(t.row, t.column) if hasattr(t, "row") else VirtualTarget(t.index)


def gate_from_reference(gate):
    """The port's gate for a reference gate object (by class name and
    fields). Raises NotImplementedError for a gate the port lacks."""
    from plonky2_torch.gates import (
        arithmetic_base,
        arithmetic_extension,
        base_sum,
        coset_interpolation,
        exponentiation,
        poseidon_gate,
        poseidon_mds,
        random_access,
        reducing,
        simple_gates,
    )
    from plonky2_torch.gates import lookup as lookup_gates

    make = {
        "NoopGate": lambda: simple_gates.NoopGate(),
        "ConstantGate": lambda: simple_gates.ConstantGate(gate.num_consts),
        "PublicInputGate": lambda: simple_gates.PublicInputGate(),
        "ArithmeticGate": lambda: arithmetic_base.ArithmeticGate(gate.num_ops),
        "ArithmeticExtensionGate":
            lambda: arithmetic_extension.ArithmeticExtensionGate(gate.num_ops),
        "MulExtensionGate": lambda: arithmetic_extension.MulExtensionGate(gate.num_ops),
        "BaseSumGate": lambda: base_sum.BaseSumGate(gate.num_limbs, gate.base),
        "ReducingGate": lambda: reducing.ReducingGate(gate.num_coeffs),
        "ReducingExtensionGate": lambda: reducing.ReducingExtensionGate(gate.num_coeffs),
        "RandomAccessGate": lambda: random_access.RandomAccessGate(
            gate.bits, gate.num_copies, gate.num_extra_constants),
        "CosetInterpolationGate": lambda: coset_interpolation.CosetInterpolationGate(
            gate.subgroup_bits, gate.degree()),
        "PoseidonGate": lambda: poseidon_gate.PoseidonGate(),
        "ExponentiationGate": lambda: exponentiation.ExponentiationGate(gate.num_power_bits),
        "PoseidonMdsGate": lambda: poseidon_mds.PoseidonMdsGate(),
        "LookupGate": lambda: lookup_gates.LookupGate(gate.num_slots, lut(gate.lut)),
        "LookupTableGate": lambda: lookup_gates.LookupTableGate(
            gate.num_slots, lut(gate.lut), gate.last_lut_row),
    }.get(type(gate).__name__)
    if make is None:
        raise NotImplementedError(f"{type(gate).__name__} is not ported")
    return make()


def common_from_reference(common):
    """The port's CommonCircuitData for the reference's: every common field
    the prover reads."""
    from plonky2_torch.plonk.circuit_data import CommonCircuitData, SelectorsInfo
    from plonky2_torch.plonk.config import CircuitConfig

    c = common.config
    config = CircuitConfig(
        num_wires=c.num_wires, num_routed_wires=c.num_routed_wires,
        num_constants=c.num_constants, use_base_arithmetic_gate=c.use_base_arithmetic_gate,
        security_bits=c.security_bits, num_challenges=c.num_challenges,
        zero_knowledge=c.zero_knowledge, max_quotient_degree_factor=c.max_quotient_degree_factor,
        fri_config=fri_config(c.fri_config))
    return CommonCircuitData(
        config=config, fri_params=fri_params(common.fri_params),
        gates=[gate_from_reference(gt) for gt in common.gates],
        selectors_info=SelectorsInfo(list(common.selectors_info.selector_indices),
                                     [range(r.start, r.stop)
                                      for r in common.selectors_info.groups]),
        quotient_degree_factor=common.quotient_degree_factor,
        num_gate_constraints=common.num_gate_constraints,
        num_constants=common.num_constants, num_public_inputs=common.num_public_inputs,
        k_is=[int(k) for k in common.k_is], num_partial_products=common.num_partial_products,
        num_lookup_polys=common.num_lookup_polys,
        num_lookup_selectors=common.num_lookup_selectors,
        luts=[lut(t) for t in common.luts])


def circuit_from_reference(prover_only, common):
    """(ProverOnlyCircuitData, CommonCircuitData) of the port for the
    reference's circuit objects: its commitment's coefficients, sigmas,
    subgroup, digest and lookup rows, and every common field the prover
    reads."""
    import numpy as np

    from plonky2_torch.gadgets.lookup import LookupWire
    from plonky2_torch.plonk.circuit_data import ProverOnlyCircuitData

    u64 = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.uint64))  # noqa: E731
    port_prover = ProverOnlyCircuitData(
        constants_sigmas_coeffs=u64(prover_only.constants_sigmas_commitment.polynomials),
        sigmas=u64(prover_only.sigmas), subgroup=u64(prover_only.subgroup),
        circuit_digest=[int(v) for v in prover_only.circuit_digest],
        lookup_rows=[LookupWire(lw.last_lu_gate, lw.last_lut_gate, lw.first_lut_gate)
                     for lw in prover_only.lookup_rows],
        lut_to_lookups=[[(target(a), target(b)) for a, b in lookups]
                        for lookups in prover_only.lut_to_lookups])
    return port_prover, common_from_reference(common)
