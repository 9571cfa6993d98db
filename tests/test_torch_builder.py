"""The port's circuit builder against the reference package, on the CPU.

Under the seed the fixtures were made with (2026): the port builds
factorial, fibonacci, range_check and square_root (`plonky2_torch.examples`,
device "cpu") to the reference's verifier bytes (`fixtures/*.verifier.bin`)
and proves them to its proof bytes (`fixtures/*.proof.bin`); the built
prover data of factorial, fibonacci and range_check equals the reference's
(`plonky2_torch/data/*.prover.bin`): the preprocessed polynomials, the
public-input targets, the representative map, the watch index and the
generators in order. The bench_recursion fixture chain's inner circuit
(2^4) builds and proves to the reference's bytes
(`plonky2_torch/data/inner4.*.bin`, written by tests/torch_make_data.py).
Each gate's builder surface equals the reference's, and the numpy forest
equals the reference's union-find on random copy constraints.
"""

import os

import numpy as np
import pytest
import torch

from plonky2_tpu.field import scalar as fs
from plonky2_tpu.gates import arithmetic_base as j_ab
from plonky2_tpu.gates import arithmetic_extension as j_ae
from plonky2_tpu.gates import base_sum as j_bs
from plonky2_tpu.gates import coset_interpolation as j_ci
from plonky2_tpu.gates import poseidon_gate as j_pg
from plonky2_tpu.gates import random_access as j_ra
from plonky2_tpu.gates import reducing as j_rd
from plonky2_tpu.gates import simple_gates as j_sg
from plonky2_tpu.iop.target import VirtualTarget as JVirtualTarget
from plonky2_tpu.iop.target import Wire as JWire
from plonky2_tpu.plonk.config import CircuitConfig as JConfig
from plonky2_tpu.plonk.permutation_argument import Forest as JForest
from plonky2_torch import convert
from plonky2_torch.examples import bench_recursion, factorial, fibonacci, range_check, square_root
from plonky2_torch.iop.target import VirtualTarget, Wire
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.plonk.permutation_argument import Forest
from plonky2_torch.plonk.prover_serialization import read_prover_data
from plonky2_torch.plonk.serialization import proof_to_bytes
from plonky2_torch.util import rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026  # tools/generate_fixtures.py
EXAMPLES = {"factorial": factorial, "fibonacci": fibonacci, "range_check": range_check,
            "square_root": square_root}


def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_BUILT = {}


def _built(name):
    """(CircuitData, proof bytes) of an example, built and proved on the
    CPU under the fixtures' seed, once a module."""
    if name not in _BUILT:
        rng.seed(SEED)
        try:
            data, proof = EXAMPLES[name].build_and_prove(device="cpu")[:2]
        finally:
            rng.seed(None)
        _BUILT[name] = (data, proof_to_bytes(proof))
    return _BUILT[name]


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_builds_to_the_reference_verifier_bytes(name):
    data, _ = _built(name)
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "fixtures", f"{name}.verifier.bin")
    assert data.build_info == {"device": "cpu", "constants_sigmas_ifft": "K2"}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_proves_to_the_fixture_under_seed_2026(name):
    _, proof = _built(name)
    assert proof == _read("fixtures", f"{name}.proof.bin")


def _generator_state(gen) -> tuple:
    """A generator's class and fields, numpy arrays as lists."""
    fields = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in vars(gen).items()}
    return type(gen).__name__, fields


@pytest.mark.parametrize("name", ["factorial", "fibonacci", "range_check"])
def test_built_prover_data_equals_the_reference(name):
    built = _built(name)[0].prover_only
    ref, _ = read_prover_data(_read("plonky2_torch", "data", f"{name}.prover.bin"))
    np.testing.assert_array_equal(built.constants_sigmas_coeffs, ref.constants_sigmas_coeffs)
    np.testing.assert_array_equal(built.sigmas, ref.sigmas)
    np.testing.assert_array_equal(built.subgroup, ref.subgroup)
    np.testing.assert_array_equal(built.representative_map, ref.representative_map)
    assert built.circuit_digest == ref.circuit_digest
    assert built.public_inputs == ref.public_inputs
    assert built.generator_indices_by_watches.keys() == ref.generator_indices_by_watches.keys()
    for rep, gens in ref.generator_indices_by_watches.items():
        np.testing.assert_array_equal(built.generator_indices_by_watches[rep], gens)
    assert ([_generator_state(g) for g in built.generators]
            == [_generator_state(g) for g in ref.generators])


def test_inner_circuit_at_2_4_builds_and_proves_to_the_reference_bytes():
    rng.seed(SEED)
    try:
        data = bench_recursion.dummy_circuit(CircuitConfig.standard_recursion_config(), 4,
                                             device="cpu")
        proof = data.prove(bench_recursion.PartialWitness(), device="cpu")
    finally:
        rng.seed(None)
    assert verifier_data_to_bytes(data.verifier_only, data.common) == _read(
        "plonky2_torch", "data", "inner4.verifier.bin")
    assert proof_to_bytes(proof) == _read("plonky2_torch", "data", "inner4.proof.bin")
    data.verify(proof)


J_CONFIG = JConfig.standard_recursion_config()
# each gate of the slice, and the recursion gates, as the builder makes them
GATES = [
    j_sg.NoopGate(), j_sg.ConstantGate(2), j_sg.PublicInputGate(),
    j_ab.ArithmeticGate.new_from_config(J_CONFIG), j_bs.BaseSumGate.new_from_config(J_CONFIG, 2),
    j_pg.PoseidonGate(), j_ae.ArithmeticExtensionGate.new_from_config(J_CONFIG),
    j_ae.MulExtensionGate.new_from_config(J_CONFIG), j_rd.ReducingGate(43),
    j_rd.ReducingExtensionGate(32), j_ra.RandomAccessGate.new_from_config(J_CONFIG, 4),
    j_ra.RandomAccessGate(2, 10, 0), j_ci.CosetInterpolationGate(4, 6),
]

# the extra arguments of the gates' new_from_config
NEW_FROM_CONFIG_ARGS = {"ArithmeticGate": (), "ArithmeticExtensionGate": (),
                        "MulExtensionGate": (), "BaseSumGate": (2,), "RandomAccessGate": (4,)}


def _targets(ts) -> list:
    return [(t.row, t.column) if hasattr(t, "row") else ("v", t.index) for t in ts]


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.id()[:40])
def test_gate_builder_surface_equals_the_reference(gate):
    port = convert.gate_from_reference(gate)
    assert port.id() == gate.id()
    for what in ("num_wires", "num_constants", "degree", "num_constraints",
                 "extra_constant_wires"):
        assert getattr(port, what)() == getattr(gate, what)(), what
    constants = [fs.P - 3, 5][:gate.num_constants()]
    want = gate.generators(7, constants)
    got = port.generators(7, constants)
    assert [type(g).__name__ for g in got] == [type(g).__name__ for g in want]
    for p, r in zip(got, want):
        assert _targets(p.dependencies()) == _targets(r.dependencies())
        assert _targets(p.outputs()) == _targets(r.outputs())
        shared = set(vars(p)) & set(vars(r))
        assert {k: vars(p)[k] for k in shared} == {k: vars(r)[k] for k in shared}
    args = NEW_FROM_CONFIG_ARGS.get(type(gate).__name__)
    if args is not None:
        assert (type(port).new_from_config(CircuitConfig.standard_recursion_config(), *args).id()
                == type(gate).new_from_config(J_CONFIG, *args).id())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forest_and_sigmas_equal_the_reference_union_find(seed):
    """Random copy constraints among the routed wires and virtual targets
    of a 2^5-row grid: the same representatives after compression and the
    same sigma polynomials."""
    r = np.random.default_rng(seed)
    num_wires, num_routed, degree, num_virtual = 12, 8, 32, 50
    port = Forest(num_wires, num_routed, degree, num_virtual)
    ref = JForest(num_wires, num_routed, degree, num_virtual)

    def target(pair):
        if r.random() < 0.3:
            i = int(r.integers(num_virtual))
            pair.append((VirtualTarget(i), JVirtualTarget(i)))
        else:
            row, col = int(r.integers(degree)), int(r.integers(num_routed))
            pair.append((Wire(row, col), JWire(row, col)))

    for _ in range(120):
        a, b = [], []
        target(a)
        target(b)
        port.merge(a[0][0], b[0][0])
        ref.merge(a[0][1], b[0][1])
    ref.compress_paths()
    np.testing.assert_array_equal(port.compress_paths(), np.asarray(ref.parents))
    k_is = fs.get_unique_coset_shifts(degree, num_routed)
    subgroup = fs.two_adic_subgroup(5)
    np.testing.assert_array_equal(
        port.sigma_polys(k_is, np.asarray(subgroup, dtype=np.uint64)),
        ref.wire_partition().get_sigma_polys(5, k_is, subgroup))


def test_builder_refuses_zero_knowledge_and_other_configs():
    """Zero knowledge is no longer refused: the small zk circuit (its
    blinding rows, their random-value generators and copies) builds to the
    reference's verifier bytes (`plonky2_torch/data/zk_factorial.verifier.bin`,
    from `tests/torch_make_data.py --zk`). A generic config the port lacks
    is still refused by name."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_make_data import zk_factorial_circuit
    from plonky2_torch.plonk import circuit_builder, config

    want = _read("plonky2_torch", "data", "zk_factorial.verifier.bin")
    data = zk_factorial_circuit(config, circuit_builder)[0].build(device="cpu")
    assert verifier_data_to_bytes(data.verifier_only, data.common) == want
    with pytest.raises(NotImplementedError, match="BlakeGoldilocksConfig is not ported"):
        CircuitBuilder(gc="BlakeGoldilocksConfig")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_build_without_a_device_needs_cuda():
    builder = CircuitBuilder()
    builder.register_public_input(builder.add_virtual_target())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        builder.build()


def test_selector_groups_equal_the_reference_on_a_many_gate_circuit():
    """Every gate of GATES on rows of both builders: the gates' degrees
    sum past the quotient degree, so the greedy grouping makes several
    selector polynomials."""
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder

    jb, tb = JBuilder(J_CONFIG), CircuitBuilder(CircuitConfig.standard_recursion_config())
    for gate in GATES + GATES[::-1]:
        jb.add_gate(gate, [])
        tb.add_gate(convert.gate_from_reference(gate), [])
    jgates = sorted(jb.gates.values(), key=lambda g: (g.degree(), g.id()))
    tgates = sorted(tb.gates.values(), key=lambda g: (g.degree(), g.id()))
    assert [g.id() for g in tgates] == [g.id() for g in jgates]
    want_polys, want_info = jb._selector_polynomials(jgates, 9)
    got_polys, got_info = tb._selector_polynomials(tgates, 9)
    assert len(want_info.groups) > 1
    assert got_info.selector_indices == want_info.selector_indices
    assert got_info.groups == want_info.groups
    np.testing.assert_array_equal(np.stack(got_polys), np.stack(want_polys))
    np.testing.assert_array_equal(tb._constant_polys(), np.stack(jb._constant_polys()))
