"""The STARK test kit (reference starky/src/stark_testing.rs:25-130; the
reference package's starky/stark_testing.py). The functions keep the
reference's names; they live in the package, so pytest does not collect
them.

`test_stark_low_degree` evaluates the constraints on a random trace's LDE
and checks by an iFFT that each stays within the claimed degree;
`test_stark_constraints_on_trace` replays them row by row on a concrete
trace (`HostBaseOps`); `test_stark_circuit_constraints` holds the
α-combined constraints on extension scalars to the same constraints built
and proved in a circuit (`CircuitOps`).
"""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch import resolve_device
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.ops import HostBaseOps, TorchBaseOps
from plonky2_torch.starky.constraint_consumer import ConstraintConsumer
from plonky2_torch.starky.evaluation_frame import StarkFrame


class _Collector:
    """A consumer that keeps each constraint with its kind."""

    def __init__(self):
        self.items = []

    def constraint(self, c):
        self.items.append(("all", c))

    def constraint_transition(self, c):
        self.items.append(("transition", c))

    def constraint_first_row(self, c):
        self.items.append(("first", c))

    def constraint_last_row(self, c):
        self.items.append(("last", c))


def test_stark_low_degree(stark, degree_bits: int = 3, seed: int = 0, device=None) -> None:
    """Every constraint of a random trace's LDE on the 2^(degree_bits + 2)
    subgroup has degree at most constraint_degree · (n - 1), on `device`
    (CUDA unless the caller asks for another)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = 1 << degree_bits
    rate_bits = 2
    big_n = n << rate_bits
    trace_coeffs = rng.integers(0, fs.P, size=(stark.COLUMNS, n), dtype=np.uint64)
    # on the plain subgroup (shift 1) the next row is 2^rate_bits points on
    big = ntt.lde_fft(g.tensor(trace_coeffs, device), rate_bits, shift=1)
    nxt = torch.roll(big, -(1 << rate_bits), dims=1)
    pis = rng.integers(0, fs.P, size=(stark.PUBLIC_INPUTS,), dtype=np.uint64)
    frame = StarkFrame(list(big), list(nxt), [g.scalar_tensor(int(p), device) for p in pis])
    collector = _Collector()
    stark.eval(TorchBaseOps(device), frame, collector)

    max_deg = stark.constraint_degree() * (n - 1)
    for kind, c in collector.items:
        coeffs = g.to_numpy(ntt.ifft(torch.broadcast_to(c, (big_n,)).contiguous()))
        assert not coeffs[max_deg + 1:].any(), (
            f"{kind} constraint exceeds claimed degree {stark.constraint_degree()}"
        )


def test_stark_constraints_on_trace(stark, trace, public_inputs) -> None:
    """Replay every constraint on a concrete [cols, n] u64 trace with exact
    host scalars (the reference's debug-assertions check)."""
    cols, n = trace.shape
    ops = HostBaseOps()
    for r in range(n):
        r_next = (r + 1) % n
        frame = StarkFrame(
            [int(trace[c, r]) for c in range(cols)],
            [int(trace[c, r_next]) for c in range(cols)],
            list(public_inputs),
        )

        class _Checker:
            def constraint(self, c):
                assert c == 0, f"constraint violated at row {r}"

            def constraint_transition(self, c):
                if r != n - 1:
                    assert c == 0, f"transition constraint violated at row {r}"

            def constraint_first_row(self, c):
                if r == 0:
                    assert c == 0, "first-row constraint violated"

            def constraint_last_row(self, c):
                if r == n - 1:
                    assert c == 0, "last-row constraint violated"

        stark.eval(ops, frame, _Checker())


def test_stark_circuit_constraints(stark, seed: int = 0, public_inputs=None,
                                   device=None) -> None:
    """The α-accumulated constraints on a random frame with host extension
    scalars equal those evaluated in a circuit through CircuitOps, built,
    proved and verified on `device` (CUDA unless the caller asks for
    another; reference stark_testing.rs:76-130)."""
    from plonky2_torch.gates.ops import CircuitOps, HostExtOps
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.plonk.config import CircuitConfig

    rng = np.random.default_rng(seed)
    D = 2
    pis = list(public_inputs if public_inputs is not None
               else rng.integers(0, fs.P, stark.PUBLIC_INPUTS, dtype=np.uint64))

    def rnd():
        return tuple(int(x) for x in rng.integers(0, fs.P, D, dtype=np.uint64))

    local = [rnd() for _ in range(stark.COLUMNS)]
    nxt = [rnd() for _ in range(stark.COLUMNS)]
    alphas = [rnd(), rnd()]
    z_last, l_first, l_last = rnd(), rnd(), rnd()

    hops = HostExtOps()
    consumer = ConstraintConsumer(hops, alphas, z_last, l_first, l_last)
    frame = StarkFrame(local, nxt, [fs.ext_from_base(int(p), D) for p in pis])
    stark.eval(hops, frame, consumer)
    expected = consumer.accumulators()

    b = CircuitBuilder(CircuitConfig.standard_recursion_config())
    ops = CircuitOps(b)
    ce = b.constant_extension
    consumer_t = ConstraintConsumer(ops, [ce(a) for a in alphas], ce(z_last), ce(l_first),
                                    ce(l_last))
    frame_t = StarkFrame([ce(v) for v in local], [ce(v) for v in nxt],
                         [ce(fs.ext_from_base(int(p), D)) for p in pis])
    stark.eval(ops, frame_t, consumer_t)
    for acc in consumer_t.accumulators():
        b.register_public_inputs(list(acc.parts))
    data = b.build(device=device)
    proof = data.prove(PartialWitness(), device=device)
    data.verify(proof)
    got = [tuple(proof.public_inputs[i:i + D])
           for i in range(0, len(proof.public_inputs), D)]
    assert got == list(expected), "in-circuit constraint evaluation mismatch"
