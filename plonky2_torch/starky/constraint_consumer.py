"""The α-accumulating constraint consumer, ops-generic (reference
starky/src/constraint_consumer.rs): one definition serves the verifier's
extension scalars, the prover's tensors over the quotient coset and the
in-circuit targets."""

from __future__ import annotations


class ConstraintConsumer:
    def __init__(self, ops, alphas, z_last, lagrange_basis_first, lagrange_basis_last):
        self.ops = ops
        self.alphas = list(alphas)
        self.constraint_accs = [ops.zero() for _ in alphas]
        self.z_last = z_last
        self.lagrange_basis_first = lagrange_basis_first
        self.lagrange_basis_last = lagrange_basis_last

    def accumulators(self):
        return self.constraint_accs

    def constraint(self, c) -> None:
        ops = self.ops
        for i, alpha in enumerate(self.alphas):
            self.constraint_accs[i] = ops.add(ops.mul(alpha, self.constraint_accs[i]), c)

    def constraint_transition(self, c) -> None:
        self.constraint(self.ops.mul(c, self.z_last))

    def constraint_first_row(self, c) -> None:
        self.constraint(self.ops.mul(c, self.lagrange_basis_first))

    def constraint_last_row(self, c) -> None:
        self.constraint(self.ops.mul(c, self.lagrange_basis_last))
