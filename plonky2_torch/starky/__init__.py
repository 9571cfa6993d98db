"""Starky: the FRI-based STARK prover and verifier for AIRs, with logUp
lookups and cross-table lookups (counterpart of the reference package's
`starky/`).

An AIR (`stark.Stark`) writes its constraints once against the ops
protocol of `gates/ops.py`; the prover evaluates them with `TorchBaseOps`
over the whole quotient coset on the prover's device, the verifier with
`HostExtOps` at ζ, `stark_testing` with `HostBaseOps` row by row and with
`CircuitOps` in a circuit. The commitments, openings and FRI argument run
on the port's PCS (`fri/oracle.py`, `fri/prover.py`) and its kernels.

    prover.prove(stark, config, trace, public_inputs, device=None,
                 verifier_circuit_fri_params=None)
    verifier.verify_stark_proof(stark, proof_with_pis, config,
                                verifier_circuit_fri_params=None)
    serialization.stark_proof_to_bytes / stark_proof_from_bytes
    recursive_verifier.add_virtual_stark_proof_with_pis / verify_stark_proof_circuit
        / set_stark_proof_with_pis_target   (a STARK proof verified in a circuit)
    cross_table_lookup.prove_multi_table(starks, config, traces, public_inputs,
                                         ctls, device=None, timing=None)
        / verify_multi_table / get_multi_proof_challenges / check_ctls
        / verify_multi_table_circuit   (tables linked by cross-table lookups,
                                        one transcript; CrossTableLookup,
                                        TableWithColumns)

The entry points load their module on first use.
"""

import importlib

_EXPORTS = {
    "prove": "prover",
    "verify_stark_proof": "verifier",
    "stark_proof_to_bytes": "serialization",
    "stark_proof_from_bytes": "serialization",
    "add_virtual_stark_proof_with_pis": "recursive_verifier",
    "verify_stark_proof_circuit": "recursive_verifier",
    "set_stark_proof_with_pis_target": "recursive_verifier",
    "CrossTableLookup": "cross_table_lookup",
    "TableWithColumns": "cross_table_lookup",
    "prove_multi_table": "cross_table_lookup",
    "verify_multi_table": "cross_table_lookup",
    "get_multi_proof_challenges": "cross_table_lookup",
    "check_ctls": "cross_table_lookup",
    "verify_multi_table_circuit": "cross_table_lookup",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
