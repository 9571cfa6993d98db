"""Gate base class (reference gates/gate.rs:53-254).

A gate defines its constraint polynomials once over the ops protocol
(`gates/ops.py`): `eval_unfiltered` on `HostExtOps` is the verifier's form
at ζ, and `eval_unfiltered_device` evaluates them over the whole quotient
domain. Gates with many constraints override the latter with a tensorized
form: the same values in the same order, in far fewer tensor operations.
The builder reads `generators`, `num_wires`, `num_constants`, `degree`
and `extra_constant_wires`.
"""

from __future__ import annotations

import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.gates.ops import EvaluationVars, TorchBaseOps


class Gate:
    def id(self) -> str:
        raise NotImplementedError

    def eval_unfiltered(self, ops, vars) -> list:
        """Constraint values in canonical order."""
        raise NotImplementedError

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """wires: [num_wires, Q] int64; constants: [num_gate_constants, Q]
        (selector columns stripped); public_inputs_hash: [4] int64.
        Returns [num_constraints, Q] in the order of eval_unfiltered."""
        ops = TorchBaseOps(wires.device)
        vars = EvaluationVars(list(constants), list(wires), list(public_inputs_hash))
        cs = self.eval_unfiltered(ops, vars)
        q = wires.shape[-1]
        if not cs:
            return torch.zeros((0, q), dtype=torch.int64, device=wires.device)
        return torch.stack([c.expand(q) for c in cs])

    def generators(self, row: int, local_constants: list[int]) -> list:
        """The witness generators of the gate instance at `row`."""
        return []

    def num_wires(self) -> int:
        raise NotImplementedError

    def num_constants(self) -> int:
        raise NotImplementedError

    def degree(self) -> int:
        raise NotImplementedError

    def num_constraints(self) -> int:
        raise NotImplementedError

    def extra_constant_wires(self) -> list[tuple[int, int]]:
        """(constant index, wire index) pairs routed as extra constants."""
        return []

    def __eq__(self, other):
        return isinstance(other, Gate) and self.id() == other.id()

    def __hash__(self):
        return hash(self.id())


UNUSED_SELECTOR = (1 << 32) - 1  # u32::MAX (reference gates/selectors.rs:14)


def rows(wires, idx) -> torch.Tensor:
    """wires[idx] for a host list of row indices (their index tensor made
    once per list and device)."""
    return wires[g.constant(idx, wires.device)]
