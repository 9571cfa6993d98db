"""Starky: the FRI-based STARK prover and verifier for AIRs, with logUp
lookups (counterpart of the reference package's `starky/`).

An AIR (`stark.Stark`) writes its constraints once against the ops
protocol of `gates/ops.py`; the prover evaluates them with `TorchBaseOps`
over the whole quotient coset on the prover's device, the verifier with
`HostExtOps` at ζ, `stark_testing` with `HostBaseOps` row by row and with
`CircuitOps` in a circuit. The commitments, openings and FRI argument run
on the port's PCS (`fri/oracle.py`, `fri/prover.py`) and its kernels.

    prover.prove(stark, config, trace, public_inputs, device=None)
    verifier.verify_stark_proof(stark, proof_with_pis, config)
    serialization.stark_proof_to_bytes / stark_proof_from_bytes

Cross-table lookups and the STARK-to-SNARK recursive verifier are not
ported yet.
"""
