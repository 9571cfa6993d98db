"""NoopGate, ConstantGate, PublicInputGate
(reference gates/noop.rs, gates/constant.rs, gates/public_input.rs)."""

from __future__ import annotations

from plonky2_torch.gates.gate import Gate


class NoopGate(Gate):
    def id(self) -> str:
        return "NoopGate"

    def eval_unfiltered(self, ops, vars) -> list:
        return []

    def num_wires(self) -> int:
        return 0

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 0

    def num_constraints(self) -> int:
        return 0


class ConstantGate(Gate):
    """Routes `num_consts` gate constants to wires 0..num_consts. Its
    ConstantGenerators are registered when the builder adds the gate, from
    `extra_constant_wires` (reference gates/constant.rs:113)."""

    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def id(self) -> str:
        return f"ConstantGate {{ num_consts: {self.num_consts} }}"

    def eval_unfiltered(self, ops, vars) -> list:
        return [ops.sub(vars.local_constants[i], vars.local_wires[i])
                for i in range(self.num_consts)]

    def extra_constant_wires(self) -> list[tuple[int, int]]:
        return [(i, i) for i in range(self.num_consts)]

    def num_wires(self) -> int:
        return self.num_consts

    def num_constants(self) -> int:
        return self.num_consts

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return self.num_consts


class PublicInputGate(Gate):
    """Pins the 4 public-input-hash elements to wires 0..4."""

    @staticmethod
    def wires_public_inputs_hash() -> range:
        return range(4)

    def id(self) -> str:
        return "PublicInputGate"

    def eval_unfiltered(self, ops, vars) -> list:
        return [ops.sub(vars.local_wires[w], h)
                for w, h in zip(range(4), vars.public_inputs_hash)]

    def num_wires(self) -> int:
        return 4

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return 4
