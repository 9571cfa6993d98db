"""The circuit builder's virtual-target allocation (reference
plonk/circuit_builder.rs; the reference package's
plonk/circuit_builder.py:116-151).

The port reads circuits the reference built. What it rebuilds is the
allocation of virtual targets, which must follow the reference's numbering
exactly: a circuit's input targets (a proof's and a verifier's targets in a
recursion circuit) are its first allocations, so rebuilding them in the
same order on a fresh builder gives the indices its generators and copy
constraints refer to. Gates, constants and `build` are not ported.
"""

from __future__ import annotations

from plonky2_torch.iop.target import ExtensionTarget, Target, VirtualTarget

D = 2


class CircuitBuilder:
    def __init__(self, config=None):
        self.config = config
        self.virtual_target_index = 0

    def add_virtual_target(self) -> Target:
        t = VirtualTarget(self.virtual_target_index)
        self.virtual_target_index += 1
        return t

    def add_virtual_targets(self, n: int) -> list[Target]:
        return [self.add_virtual_target() for _ in range(n)]

    def add_virtual_hash(self) -> list[Target]:
        return self.add_virtual_targets(4)

    def add_virtual_hashes(self, n: int) -> list[list[Target]]:
        return [self.add_virtual_hash() for _ in range(n)]

    def add_virtual_extension_target(self) -> ExtensionTarget:
        return ExtensionTarget(tuple(self.add_virtual_target() for _ in range(D)))

    def add_virtual_extension_targets(self, n: int) -> list[ExtensionTarget]:
        return [self.add_virtual_extension_target() for _ in range(n)]
