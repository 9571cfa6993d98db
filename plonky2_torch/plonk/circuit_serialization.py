"""Verifier circuit data, and common circuit data alone, to and from the
reference's bytes (reference
util/serialization/mod.rs:1623-1960; the reference package's
plonk/circuit_serialization.py:56-362): the verifier-only data (cap
height, constants-sigmas cap, circuit digest), then the common data. The
reader and the writer are `prover_serialization.py`'s: the writer writes
each gate with its tag in the reference's registry order (`GATE_TAGS`) and
its parameters.
`bench_cache/inner14.verifier.bin` and `fixtures/*.verifier.bin` are in
this layout."""

from __future__ import annotations

from plonky2_torch.plonk import config as pcfg
from plonky2_torch.plonk.circuit_data import CommonCircuitData, VerifierOnlyCircuitData
from plonky2_torch.plonk.prover_serialization import CircuitWriter, Reader


def verifier_data_to_bytes(verifier_only: VerifierOnlyCircuitData,
                           common: CommonCircuitData) -> bytes:
    w = CircuitWriter()
    w.write_verifier_only_circuit_data(verifier_only)
    w.write_common_circuit_data(common)
    return bytes(w.buf)


def verifier_data_from_bytes(data: bytes, gc=None
                             ) -> tuple[VerifierOnlyCircuitData, CommonCircuitData]:
    """The bytes' verifier-only and common data. The bytes do not say
    which generic config made them (the reference's type parameter), so
    pass `gc` for a Keccak circuit: its digests are raw bytes (reference
    plonk/circuit_serialization.py:350-360)."""
    gc = None if gc is None else pcfg.check_generic_config(gc)
    r = Reader(data, None if gc is None else gc.hasher)
    verifier_only = r.verifier_only_circuit_data()
    common = r.common_circuit_data()
    common.gc = gc
    r.finish()
    return verifier_only, common



def common_data_to_bytes(common: CommonCircuitData) -> bytes:
    """The common data alone (reference plonk/circuit_serialization.py:331)."""
    w = CircuitWriter()
    w.write_common_circuit_data(common)
    return bytes(w.buf)


def common_data_from_bytes(data: bytes, gc=None) -> CommonCircuitData:
    """`common_data_to_bytes`' inverse; `gc` as in `verifier_data_from_bytes`."""
    gc = None if gc is None else pcfg.check_generic_config(gc)
    r = Reader(data, None if gc is None else gc.hasher)
    common = r.common_circuit_data()
    common.gc = gc
    r.finish()
    return common
