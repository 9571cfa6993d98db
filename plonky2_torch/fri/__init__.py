"""FRI: the commitment oracle (`oracle.py`), the prover (`prover.py`: fused
and host transcripts, the unified shape of STARK recursion), the verifier
on the host (`verifier.py`) and in a circuit (`recursive_verifier.py`), and
batch FRI over polynomials of several degrees (`batch_fri.py`). The entry
points below load their module on first use."""

import importlib

_EXPORTS = {
    "fri_proof": "prover",
    "force_host_path": "prover",
    "fri_challenges": "verifier",
    "verify_fri_proof": "verifier",
    "verify_fri_proof_with_multiple_degree_bits": "recursive_verifier",
    "BatchFriOracle": "batch_fri",
    "batch_fri_proof": "batch_fri",
    "verify_batch_fri_proof": "batch_fri",
    "verify_batch_fri_proof_circuit": "batch_fri",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
