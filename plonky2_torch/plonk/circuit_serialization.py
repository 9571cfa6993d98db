"""Read the reference's verifier circuit data (reference
plonk/circuit_serialization.py:350 `verifier_data_from_bytes`): the
verifier-only data (cap height, constants-sigmas cap, circuit digest), then
the common data, on the common-data reader of `prover_serialization.py`.
`bench_cache/inner14.verifier.bin` is in this layout."""

from __future__ import annotations

from plonky2_torch.plonk.circuit_data import CommonCircuitData, VerifierOnlyCircuitData
from plonky2_torch.plonk.prover_serialization import Reader


def verifier_data_from_bytes(data: bytes) -> tuple[VerifierOnlyCircuitData, CommonCircuitData]:
    r = Reader(data)
    verifier_only = r.verifier_only_circuit_data()
    common = r.common_circuit_data()
    r.finish()
    return verifier_only, common
