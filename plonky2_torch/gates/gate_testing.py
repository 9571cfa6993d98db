"""Gate test kit (reference gates/gate_testing.rs:24-87; the reference
package's gates/gate_testing.py), on the port's tensors.

- `low_degree_check`: random wire and constant polynomials of degree < n
  are evaluated on a subgroup large enough for the gate's degree, the
  gate's constraints are evaluated there (`eval_unfiltered_device`), and
  an iNTT certifies that every constraint polynomial stays within the
  gate's degree bound.
- `device_vs_scalar_check`: the batched evaluation (`eval_unfiltered_device`)
  agrees pointwise with the generic-ops host evaluation (`eval_unfiltered`
  on `HostBaseOps`): the counterpart of the reference's native/circuit
  equality test for the port's two forms.

Both run on the CPU by default, or on the device given.
"""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.ops import EvaluationVars, HostBaseOps


def _log2_ceil(n: int) -> int:
    return max(n - 1, 0).bit_length()


def _random_eval_grid(gate, n_bits: int, rng, device):
    """Random degree < n wire and constant polynomials on the subgroup of
    n 2^ceil(lg degree) points."""
    n = 1 << n_bits
    rate_bits = _log2_ceil(max(gate.degree(), 1))
    num_wires, num_constants = gate.num_wires(), gate.num_constants()
    coeffs = rng.integers(0, fs.P, size=(num_wires + num_constants, n), dtype=np.uint64)
    values = ntt.lde_fft(g.tensor(coeffs, device), rate_bits, shift=1)
    return values[:num_wires], values[num_wires:], n


def low_degree_check(gate, n_bits: int = 2, seed: int = 0, device="cpu") -> None:
    rng = np.random.default_rng(seed)
    wires, constants, n = _random_eval_grid(gate, n_bits, rng, device)
    pi_hash = torch.zeros((4,), dtype=torch.int64, device=wires.device)
    ev = gate.eval_unfiltered_device(wires, constants, pi_hash)
    assert ev.shape[0] == gate.num_constraints(), (
        f"{gate.id()}: {ev.shape[0]} constraints != claimed {gate.num_constraints()}")
    if ev.shape[0] == 0:
        return
    coeffs = g.to_numpy(ntt.ifft(ev.contiguous()))
    # the constraint degree bound: gate.degree() * (n - 1)
    tail = coeffs[:, gate.degree() * (n - 1) + 1:]
    bad = np.nonzero(tail.any(axis=1))[0]
    assert bad.size == 0, f"{gate.id()}: constraints {bad.tolist()} exceed degree {gate.degree()}"


def device_vs_scalar_check(gate, num_points: int = 4, seed: int = 1, device="cpu") -> None:
    rng = np.random.default_rng(seed)
    num_wires, num_constants = gate.num_wires(), gate.num_constants()
    wires = rng.integers(0, fs.P, size=(num_wires, num_points), dtype=np.uint64)
    constants = rng.integers(0, fs.P, size=(num_constants, num_points), dtype=np.uint64)
    pi_hash = rng.integers(0, fs.P, size=(4,), dtype=np.uint64)
    dev = g.to_numpy(gate.eval_unfiltered_device(
        g.tensor(wires, device), g.tensor(constants, device), g.tensor(pi_hash, device)))
    ops = HostBaseOps()
    for p in range(num_points):
        local = EvaluationVars([int(constants[i, p]) for i in range(num_constants)],
                               [int(wires[i, p]) for i in range(num_wires)],
                               [int(h) for h in pi_hash])
        expected = gate.eval_unfiltered(ops, local)
        assert [int(v) for v in dev[:, p]] == [int(e) for e in expected], (
            f"{gate.id()}: device/scalar mismatch at point {p}")
