"""The port's CUDA kernels (K2-K5) against their plain PyTorch versions on
the card, at small shapes. Needs an NVIDIA GPU: every test skips without
one. On the card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts="" -m cuda
"""

import numpy as np
import pytest
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.ops import ntt as kn
from plonky2_torch.ops import poseidon as kp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(dev, shape, seed=0):
    rng = np.random.default_rng(seed)
    return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)


@pytest.mark.parametrize("lg", [1, 6, 10, 13])
def test_k2_rows_match_plain(dev, lg):
    x = _rand(dev, (3, 1 << lg), lg)
    for inverse in (False, True):
        assert torch.equal(kn.ntt_rows(x, inverse), kn.ntt_rows_plain(x, inverse))


def test_k2_lde_forms_match_plain(dev):
    gen = fs.MULTIPLICATIVE_GROUP_GENERATOR
    x = _rand(dev, (2, 1 << 9), 1)
    table = ntt._lde_coset_scale_table(gen, 9, 3, str(dev))
    assert torch.equal(kn.ntt_rows(x, scale=table, fan=8),
                       kn.ntt_rows_plain(x, scale=table, fan=8))
    y = _rand(dev, (2, 1 << 5), 2)
    s = ntt.shift_powers(gen, 32, dev).reshape(1, 32)
    assert torch.equal(kn.ntt_rows(y, scale=s, repeat_bits=3),
                       kn.ntt_rows_plain(y, scale=s, repeat_bits=3))


@pytest.mark.parametrize("lg", [14, 15, 16, 17, 18, 19, 20])
def test_k3_four_step_matches_plain(dev, lg):
    # every size from 2^14 (odd and even splits), the interleaved LDE
    # layout at fans 2 and 8
    gen = fs.MULTIPLICATIVE_GROUP_GENERATOR
    for fan in (1, 2, 8):
        table = (ntt._lde_coset_scale_table(gen, lg, fan.bit_length() - 1, str(dev))
                 if fan > 1 else None)
        for batch in (1, 2):
            x = _rand(dev, (batch, 1 << lg), lg + fan + batch)
            for inverse in (False, True):
                assert torch.equal(kn.ntt_four_step(x, inverse, table, fan),
                                   kn.ntt_four_step_plain(x, inverse, table, fan))


def test_k3_quotient_shape_and_launch_count(dev):
    # [16, 2^16], the quotient's coset iFFT shape: two launches per call
    from plonky2_torch.ops import K3

    x = _rand(dev, (16, 1 << 16), 16)
    before = K3.launches
    got = kn.ntt_four_step(x, inverse=True)
    assert K3.launches == before + 2
    assert torch.equal(got, kn.ntt_four_step_plain(x, inverse=True))


@pytest.mark.parametrize("lg", [1, 6, 10, 13])
def test_k2_interleaved_fans_match_plain(dev, lg):
    # fans 2..8 take the cluster epilogue, 16 the strided one
    gen = fs.MULTIPLICATIVE_GROUP_GENERATOR
    for rate_bits in (1, 2, 3, 4):
        if lg + rate_bits > kn.MAX_SMEM_LG:
            continue
        x = _rand(dev, (3, 1 << lg), lg + rate_bits)
        table = ntt._lde_coset_scale_table(gen, lg, rate_bits, str(dev))
        for inverse in (False, True):
            assert torch.equal(kn.ntt_rows(x, inverse, table, 1 << rate_bits),
                               kn.ntt_rows_plain(x, inverse, table, 1 << rate_bits))


@pytest.mark.parametrize("width", [5, 8, 32, 135])
def test_k4_sponge_matches_plain(dev, width):
    cols = _rand(dev, (width, 1024), width)
    assert torch.equal(kp.sponge(cols), kp.sponge_plain(cols))


@pytest.mark.parametrize("natural, width, lg_n, cap_height", [
    (True, 135, 12, 4), (True, 3, 10, 0), (True, 20, 8, 8), (True, 8, 1, 0),
    (False, 32, 12, 4), (False, 8, 14, 4), (False, 4, 9, 2), (False, 32, 6, 6),
])
def test_k4_trees_match_plain(dev, natural, width, lg_n, cap_height):
    n = 1 << lg_n
    leaves = _rand(dev, (width, n) if natural else (n, width), lg_n)
    want = kp.merkle_tree_plain(leaves, cap_height, natural)
    got = kp.merkle_tree(leaves, cap_height, natural)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_k5_permute_and_grind_match_plain(dev):
    states = _rand(dev, (12, 1000), 3)
    assert torch.equal(kp.permute(states), kp.permute_plain(states))
    inter = [g.u64(int(v)) for v in _rand("cpu", (12,), 4)]
    for pos, bits in ((0, 6), (7, 10)):
        thr = 1 << (64 - bits)
        assert (kp.grind_chunk(inter, pos, 0, 1 << 12, thr, dev)
                == kp.grind_chunk_plain(inter, pos, 0, 1 << 12, thr, dev))


@pytest.mark.parametrize("threshold", [0, 1 << 63, 1 << 48])
def test_k5_grind_thresholds_match_plain(dev, threshold):
    # 0: no candidate meets it (None); 2^63: 1 bit; 2^48: 16 bits
    inter = [g.u64(int(v)) for v in _rand("cpu", (12,), 5)]
    want = kp.grind_chunk_plain(inter, 5, 0, 1 << 17, threshold, dev)
    assert kp.grind_chunk(inter, 5, 0, 1 << 17, threshold, dev) == want
    assert (want is None) == (threshold == 0)


def test_k5_permute_edge_states_match_plain(dev):
    p = fs.P
    cols = [[0] * 12, [p - 1] * 12, [(1 << 32) - 1] * 12, [1 << 63] * 12,
            [p - 1 if i % 2 else (1 << 32) - 1 for i in range(12)]]
    states = g.tensor([[c[i] for c in cols] for i in range(12)], dev)
    assert torch.equal(kp.permute(states), kp.permute_plain(states))


def _factorial(dev):
    import os

    from plonky2_torch.plonk.prover_serialization import read_prover_data

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "plonky2_torch", "data", "factorial.prover.bin"), "rb") as f:
        prover_only, common = read_prover_data(f.read())
    w = np.load(os.path.join(root, "plonky2_torch", "data", "factorial.witness.npz"))
    with open(os.path.join(root, "fixtures", "factorial.proof.bin"), "rb") as f:
        fixture = f.read()
    return (prover_only, common, w["witness"], [int(v) for v in w["public_inputs"]],
            [int(v) for v in w["public_inputs_hash"]]), fixture


def test_factorial_prove_on_the_card_equals_the_fixture(dev):
    """The PLONK prove from the port's committed factorial data, on the
    card, on the fused transcript path (the default): the bytes of
    fixtures/factorial.proof.bin, through K2, K4, K5's duplexes and one K5
    device grind (every transform of degree 2^6 is small enough for K2)."""
    from plonky2_torch import ops
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.serialization import proof_to_bytes

    args, fixture = _factorial(dev)
    ops.reset_launches()
    pwp = tp.prove(args[0], args[1], None, device=dev, _prepared=args[2:])
    assert tp._LAST_TRANSCRIPT == "fused"
    assert ops.K2.launches and ops.K4.launches and ops.K5.batch1
    assert ops.K5_DEVICE.launches == 1 and ops.K5_CHUNK.launches == 0
    assert proof_to_bytes(pwp) == fixture


def test_factorial_host_path_prove_on_the_card_equals_the_fixture(dev):
    from plonky2_torch import ops
    from plonky2_torch.fri.prover import force_host_path
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.serialization import proof_to_bytes

    args, fixture = _factorial(dev)
    ops.reset_launches()
    with force_host_path():
        pwp = tp.prove(args[0], args[1], None, device=dev, _prepared=args[2:])
    assert tp._LAST_TRANSCRIPT == "host"
    assert ops.K5_CHUNK.launches and ops.K5_DEVICE.launches == 0
    assert proof_to_bytes(pwp) == fixture


@pytest.mark.parametrize("host", [False, True], ids=["fused", "host"])
def test_factorial_under_an_nccl_group_of_one_equals_the_fixture(dev, host):
    """The prove over a process group of one in this process, NCCL
    (`plonky2_torch.parallel`): the bytes of fixtures/factorial.proof.bin on
    both transcript paths, through the group's commitments, gathers and
    owner-rank openings."""
    import contextlib

    from plonky2_torch import parallel
    from plonky2_torch.fri.prover import force_host_path
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.serialization import proof_to_bytes

    args, fixture = _factorial(dev)
    force = force_host_path() if host else contextlib.nullcontext()
    with parallel.local_group("nccl") as group, parallel.use_mesh(group), force:
        parallel.Collectives.reset()
        pwp = tp.prove(args[0], args[1], None, _prepared=args[2:])
    assert tp._LAST_TRANSCRIPT == ("host" if host else "fused")
    assert parallel.Collectives.count > 0
    assert proof_to_bytes(pwp) == fixture


@pytest.mark.parametrize("pow_bits", [0, 1, 8, 12])
def test_k5_grind_device_matches_plain(dev, pow_bits):
    from plonky2_torch import ops

    for k in (0, 3, 7):
        state = _rand(dev, (12,), 10 * pow_bits + k)
        pending = _rand(dev, (k,), 10 * pow_bits + k + 1)
        before = ops.K5_DEVICE.launches
        got = kp.grind_device(state, pending, pow_bits)
        assert ops.K5_DEVICE.launches == before + (pow_bits > 0)
        assert torch.equal(got, kp.grind_device_plain(state, pending, pow_bits))


def test_warm_fused_defer_prove_makes_no_synchronisation(dev):
    """A warm prove(_defer=True) of a witness already on the card runs under
    torch.cuda.set_sync_debug_mode("error") without raising; finish() then
    fetches the fixture's bytes."""
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.serialization import proof_to_bytes

    args, fixture = _factorial(dev)
    witness = g.tensor(args[2], dev)
    prepared = (witness, *args[3:])
    tp.prove(args[0], args[1], None, device=dev, _prepared=prepared)  # per-circuit tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = tp.prove(args[0], args[1], None, device=dev, _defer=True, _prepared=prepared)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert proof_to_bytes(finish()) == fixture


def _circuit(name):
    import os

    from plonky2_torch.iop.witness import read_partial_witness
    from plonky2_torch.plonk.prover_serialization import read_prover_data

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(root, "plonky2_torch", "data")
    with open(os.path.join(data, f"{name}.prover.bin"), "rb") as f:
        prover_only, common = read_prover_data(f.read())
    with open(os.path.join(root, "fixtures", f"{name}.proof.bin"), "rb") as f:
        fixture = f.read()
    return prover_only, common, read_partial_witness(os.path.join(data, f"{name}.inputs.npz")), \
        fixture


@pytest.mark.parametrize("name", ["factorial", "fibonacci", "range_check"])
def test_prove_from_inputs_on_the_card_equals_the_fixture(dev, name):
    """The witness phase (the native plan) from the committed inputs under
    seed 2026, then the prove on the card: the fixture's bytes (fibonacci
    and range_check have no FRI fold step: the host transcript's branch)."""
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import rng

    prover_only, common, inputs, fixture = _circuit(name)
    rng.seed(2026)
    try:
        pwp = tp.prove(prover_only, common, inputs, device=dev)
    finally:
        rng.seed(None)
    assert tp._LAST_TRANSCRIPT == ("fused" if name == "factorial" else "host")
    assert proof_to_bytes(pwp) == fixture


@pytest.mark.parametrize("window,threads", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_prove_many_on_the_card_equals_sequential_proves(dev, window, threads):
    """prove_many of factorial's inputs, K = 3, under seed 2026, on the card
    (each proof's device chain on its own stream): the bytes of three
    sequential proves under the same seed, at most `window` in flight."""
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import rng

    prover_only, common, inputs, fixture = _circuit("factorial")
    rng.seed(2026)
    try:
        seq = [proof_to_bytes(tp.prove(prover_only, common, inputs, device=dev))
               for _ in range(3)]
        rng.seed(2026)
        got = tp.prove_many(prover_only, common, [inputs] * 3, device=dev, window=window,
                            threads=threads)
    finally:
        rng.seed(None)
    assert seq[0] == fixture and len(set(seq)) == 3
    assert [proof_to_bytes(p) for p in got] == seq
    assert 1 <= tp._LAST_MAX_IN_FLIGHT <= window


@pytest.mark.parametrize("name", ["factorial", "fibonacci", "range_check", "square_root"])
def test_example_builds_proves_and_verifies_on_the_card(dev, name):
    """The example built and proved on the card, with the device left to
    its default, gives its fixture's verifier and proof bytes, and the
    port's verifier accepts the proof."""
    import importlib
    import os

    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import rng

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    module = importlib.import_module(f"plonky2_torch.examples.{name}")
    rng.seed(2026)
    try:
        data, proof = module.build_and_prove()[:2]
    finally:
        rng.seed(None)
    assert data.build_info["device"] == "cuda"
    for suffix, got in (("verifier", verifier_data_to_bytes(data.verifier_only, data.common)),
                        ("proof", proof_to_bytes(proof))):
        with open(os.path.join(root, "fixtures", f"{name}.{suffix}.bin"), "rb") as f:
            assert got == f.read(), suffix
    data.verify(proof)


def test_keccak_factorial_on_the_card_gives_the_fixture(dev):
    """keccak_factorial (KeccakGoldilocksConfig) built and proved on the
    card: the fixture's verifier and proof bytes, the host-transcript path
    recorded, and its compressed proof decompresses to the proof's bytes
    and verifies."""
    import os

    from plonky2_torch.examples import factorial
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import rng

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng.seed(2026)
    try:
        data, proof = factorial.keccak_build_and_prove()
    finally:
        rng.seed(None)
    assert (tp._LAST_TRANSCRIPT, fri_prover._LAST_PATH) == ("host", "host")
    for suffix, got in (("verifier", verifier_data_to_bytes(data.verifier_only, data.common)),
                        ("proof", proof_to_bytes(proof))):
        with open(os.path.join(root, "fixtures", f"keccak_factorial.{suffix}.bin"), "rb") as f:
            assert got == f.read(), suffix
    compressed = data.compress(proof)
    assert proof_to_bytes(data.decompress(compressed)) == proof_to_bytes(proof)
    data.verify_compressed(compressed)


def test_fibonacci_serialization_example_on_the_card(dev):
    """The example's round trips (proof, verifier data, prover data read
    back and proved again) run on the card."""
    from plonky2_torch.examples import fibonacci_serialization

    out = fibonacci_serialization.main()
    assert set(out) == {"proof", "verifier", "prover"}


def test_bench_recursion_chain_on_the_card_gives_the_fixture(dev):
    """The fixture chain, inner 2^4, middle and outer, built by the port's
    in-circuit verifier and proved on the card with the device left to its
    default, under seed 2026: the outer proof and verifier bytes of
    `fixtures/bench_recursion.*.bin`; each layer verifies."""
    import os

    from plonky2_torch.examples import bench_recursion
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import rng

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng.seed(2026)
    try:
        layers = bench_recursion.chain(4)
    finally:
        rng.seed(None)
    proof, data = layers[-1].proof, layers[-1].data
    assert [layer.data.build_info["device"] for layer in layers] == ["cuda"] * 3
    assert [layer.data.common.degree_bits for layer in layers] == [4, 11, 13]
    for suffix, got in (("verifier", verifier_data_to_bytes(data.verifier_only, data.common)),
                        ("proof", proof_to_bytes(proof))):
        with open(os.path.join(root, "fixtures", f"bench_recursion.{suffix}.bin"), "rb") as f:
            assert got == f.read(), suffix


@pytest.mark.parametrize("width", [2, 4])
def test_k4_narrow_tree_over_2_21_leaves_matches_plain(dev, width):
    """The Starky trace, auxiliary and quotient trees at 2^20 rows: a natural
    tree of 2^21 hash_or_noop leaves of width 2 (or 4), cap height 4."""
    leaves = _rand(dev, (width, 1 << 21), width)
    want = kp.merkle_tree_plain(leaves, 4, True)
    got = kp.merkle_tree(leaves, 4, True)
    assert len(got) == len(want) == 18 and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name,log_rows", [("fibonacci", 5), ("permutation", 5),
                                           ("fibonacci", 7), ("lookup", 5), ("lookup", 7)])
def test_starky_prove_on_the_card_gives_the_reference_bytes(dev, name, log_rows):
    """The Starky prover with the device left to its default: the fixtures
    at 2^5 and the reference's committed proofs, through K2, K4 and K5's
    chunk grind (no FRI fold step at 2^5: the host transcript) or its
    duplexes and device grind (one fold step at 2^7: the fused one)."""
    import os

    from plonky2_torch import ops
    from plonky2_torch.starky import prover
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_torch.starky.serialization import stark_proof_to_bytes
    from plonky2_torch.starky.test_starks import LookupTestStark, PermutationStark
    from plonky2_torch.starky.verifier import verify_stark_proof

    n = 1 << log_rows
    if name == "fibonacci":
        stark, pis = FibonacciStark(n), [0, 1, fibonacci(n - 1, 0, 1)]
        trace = stark.generate_trace(0, 1)
    elif name == "permutation":
        stark, pis = PermutationStark(n), [3, 9]
        trace = stark.generate_trace(*pis)
    else:
        stark, pis = LookupTestStark(n), []
        trace = stark.generate_trace()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = (os.path.join(root, "fixtures", f"starky_{name}.proof.bin")
           if log_rows == 5 and name != "lookup"
           else os.path.join(root, "plonky2_torch", "data", f"starky_{name}{log_rows}.proof.bin"))
    config = StarkConfig.standard_fast_config()
    ops.reset_launches()
    proof = prover.prove(stark, config, trace, pis)
    assert ops.K2.launches and ops.K4.launches
    if log_rows == 5:
        assert ops.K5_CHUNK.launches and not ops.K5_DEVICE.launches
    else:
        assert ops.K5_DEVICE.launches == 1 and ops.K5.batch1
    with open(ref, "rb") as f:
        assert stark_proof_to_bytes(proof, config) == f.read()
    verify_stark_proof(stark, proof, config)


def _two_inner_proofs():
    """tests/test_conditional_cyclic.py's inner circuit (x times 30
    constants) built on the card, and its proofs from x = 3 and x = 5."""
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder

    b = CircuitBuilder()
    x = b.add_virtual_target()
    cur = x
    for i in range(30):
        cur = b.mul(cur, b.constant(i % 11 + 2))
    b.register_public_input(cur)
    data = b.build()
    proofs = []
    for v in (3, 5):
        pw = PartialWitness()
        pw.set_target(x, v)
        proofs.append(data.prove(pw))
        data.verify(proofs[-1])
    return data, proofs


def test_conditionally_verify_proof_on_the_card(dev):
    """One circuit selecting between two proofs, proved with the condition
    either way on the card: each proof verifies and exposes the selected
    proof's public input."""
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.recursion import recursive_verifier as rv
    from plonky2_torch.recursion.conditional_recursive_verifier import conditionally_verify_proof

    data, (proof_a, proof_b) = _two_inner_proofs()
    cap_h = data.common.config.fri_config.cap_height
    b = CircuitBuilder()
    cond = b.add_virtual_bool_target_safe()
    pt_a, vdt_a = rv.add_virtual_proof_with_pis(b, data.common), rv.add_virtual_verifier_data(
        b, cap_h)
    pt_b, vdt_b = rv.add_virtual_proof_with_pis(b, data.common), rv.add_virtual_verifier_data(
        b, cap_h)
    conditionally_verify_proof(b, cond, pt_a, vdt_a, pt_b, vdt_b, data.common)
    b.register_public_input(b.select(cond, pt_a.public_inputs[0], pt_b.public_inputs[0]))
    outer = b.build()
    for flag, expected in ((True, proof_a.public_inputs[0]), (False, proof_b.public_inputs[0])):
        pw = PartialWitness()
        pw.set_bool_target(cond, flag)
        for pt, vdt, proof in ((pt_a, vdt_a, proof_a), (pt_b, vdt_b, proof_b)):
            rv.set_proof_with_pis_target(pw, pt, proof)
            rv.set_verifier_data_target(pw, vdt, data.verifier_only)
        outer_proof = outer.prove(pw)
        assert outer_proof.public_inputs == [expected]
        outer.verify(outer_proof)


def test_conditionally_verify_proof_or_dummy_on_the_card(dev):
    """A proof or a dummy proof (built and proved on the card inside the
    build), the condition either way: each outer proof verifies."""
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.recursion import recursive_verifier as rv
    from plonky2_torch.recursion.conditional_recursive_verifier import (
        conditionally_verify_proof_or_dummy,
    )

    data, (proof_a, _) = _two_inner_proofs()
    b = CircuitBuilder()
    cond = b.add_virtual_bool_target_safe()
    pt = rv.add_virtual_proof_with_pis(b, data.common)
    vdt = rv.add_virtual_verifier_data(b, data.common.config.fri_config.cap_height)
    conditionally_verify_proof_or_dummy(b, cond, pt, vdt, data.common)
    outer = b.build()
    for flag in (True, False):
        pw = PartialWitness()
        pw.set_bool_target(cond, flag)
        rv.set_proof_with_pis_target(pw, pt, proof_a)
        rv.set_verifier_data_target(pw, vdt, data.verifier_only)
        outer.verify(outer.prove(pw))


# tests/reference_prove_cyclic.py: the reference's IVC hash chain under seed 2026
CYCLIC_VERIFIER_SHA256 = "ac6d7e1aa7705efb8866bd781540da5851d781be8b780c6d0cf9bb8471028920"
CYCLIC_PROOF_SHA256S = ("ca4aa96195c765e13e8a9ad7bc04cef39a83bdd39afce6cb8abac7b8cb030e51",
                        "9f26fbee1fb26bb2cf96f0f3107c2b93eab2efe8aee1b659e18d0e04f626f48d",
                        "7822ed40f147fcce688714c4fdf9bc7316918cefef9371dcd227ccf15812512b")


@pytest.fixture(scope="module")
def cyclic_chain():
    """The hash chain on the card, the device left to its default, each
    step under seed 2026: (circuit, [base, layer 1, layer 2])."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from plonky2_torch.examples import cyclic_recursion as ivc
    from plonky2_torch.util import rng

    def seeded(run):
        rng.seed(2026)
        try:
            return run()
        finally:
            rng.seed(None)

    circuit = seeded(lambda: ivc.cyclic_circuit(ivc.common_data_for_recursion().common))
    proofs = [seeded(lambda: ivc.base_proof(circuit))]
    for _ in range(2):
        proofs.append(seeded(lambda: ivc.step(circuit, proofs[-1])))
    return circuit, proofs


def test_cyclic_chain_on_the_card_gives_the_reference_bytes(cyclic_chain):
    """The cyclic circuit's verifier bytes and the base and two layers'
    proofs are the reference's; each proof carries the circuit's key,
    verifies, and counts 1, 2, 3 hashes of its chain."""
    import hashlib

    from plonky2_torch.examples import cyclic_recursion as ivc
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes

    circuit, proofs = cyclic_chain
    data = circuit.data
    assert data.build_info["device"] == "cuda"
    assert hashlib.sha256(verifier_data_to_bytes(data.verifier_only, data.common)
                          ).hexdigest() == CYCLIC_VERIFIER_SHA256
    for layer, proof in enumerate(proofs):
        assert hashlib.sha256(proof_to_bytes(proof)).hexdigest() == CYCLIC_PROOF_SHA256S[layer]
        ivc.check(circuit, proof, layer + 1)


def test_cyclic_proof_with_a_tampered_key_is_rejected(cyclic_chain):
    """A layer proof whose public inputs carry another circuit digest or cap
    entry fails check_cyclic_proof_verifier_data and the verifier."""
    import dataclasses

    from plonky2_torch.field import scalar as fs
    from plonky2_torch.recursion.cyclic_recursion import check_cyclic_proof_verifier_data

    circuit, proofs = cyclic_chain
    data = circuit.data
    for index in (9 + 1, 76):  # a digest element, the last cap element
        pis = list(proofs[1].public_inputs)
        pis[index] = fs.add(pis[index], 1)
        tampered = dataclasses.replace(proofs[1], public_inputs=pis)
        with pytest.raises(ValueError, match="Cyclic proof"):
            check_cyclic_proof_verifier_data(tampered, data.verifier_only, data.common)
        with pytest.raises(ValueError):
            data.verify(tampered)


def test_batch_fri_on_the_card_gives_the_reference_bytes(dev):
    """The CPU tests' batch-FRI case on the card, both transcript paths:
    the reference's proof bytes and challenger state
    (plonky2_torch/data/batch_fri_9_7.npz), accepted by the verifier."""
    import os

    from plonky2_torch.examples import batch_fri as bf
    from plonky2_torch.fri import config as tfc
    from plonky2_torch.fri import prover as fp
    from torch_make_data import DATA, batch_fri_small_params

    params = batch_fri_small_params(tfc)
    groups = bf.random_groups((9, 7), (3, 2), 2)
    oracle = bf.commit(groups, params, dev)
    with np.load(os.path.join(DATA, "batch_fri_9_7.npz")) as z:
        want = z["proof"].tobytes(), tuple([int(v) for v in z[k]]
                                           for k in ("sponge", "inputs", "outputs"))
    for host in (False, True):
        if host:
            with fp.force_host_path():
                run = bf.prove(groups, params, oracle=oracle)
        else:
            run = bf.prove(groups, params, oracle=oracle)
        ch = run.challenger
        assert (bf.proof_bytes(run.proof), (list(ch.sponge_state), list(ch.input_buffer),
                                            list(ch.output_buffer))) == want
    bf.verify(run, params)


def test_variable_degree_stark_wrap_on_the_card_gives_the_reference_bytes(dev):
    """The CPU tests' variable-degree wrap (max 2^10, min 2^4, one inner
    query) built and proved on the card over the 2^7-row FibonacciStark
    proof: the reference's verifier bytes and proof."""
    import dataclasses
    import os

    from plonky2_torch.examples import stark_recursion as sr
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.config import CircuitConfig
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_torch.starky.prover import prove
    from plonky2_torch.util import rng
    from torch_make_data import DATA, STARK_WRAP_QUERIES

    base = StarkConfig.standard_fast_config()
    config = dataclasses.replace(base, fri_config=dataclasses.replace(
        base.fri_config, num_query_rounds=STARK_WRAP_QUERIES))

    def read(name):
        with open(os.path.join(DATA, name), "rb") as f:
            return f.read()

    data, pt = sr.wrap_circuit(FibonacciStark(1 << 10), config, 10,
                               CircuitConfig.standard_recursion_config(), min_degree_bits=4,
                               device=dev)
    assert verifier_data_to_bytes(data.verifier_only, data.common) == read(
        "stark_wrap_var10_4.verifier.bin")
    stark = FibonacciStark(1 << 7)
    pis = [0, 1, fibonacci(127, 0, 1)]
    stark_proof = prove(stark, config, stark.generate_trace(0, 1), pis, device=dev,
                        verifier_circuit_fri_params=config.fri_params(10))
    rng.seed(2026)
    try:
        proof = data.prove(sr.wrap_inputs(pt, stark_proof, 7), device=dev)
    finally:
        rng.seed(None)
    assert proof_to_bytes(proof) == read("stark_wrap_var10_4_7.proof.bin")
    data.verify(proof)


def test_multi_table_on_the_card_gives_the_reference_bytes(dev):
    """The CPU tests' three CTL-linked tables (2^8, 2^7, 2^6 rows, one
    query, 8 PoW bits) proved on the card by prove_multi_table, and their
    verifier circuit built and proved there: the reference's bytes."""
    import dataclasses
    import os

    from plonky2_torch.examples import multi_table as mt
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.config import CircuitConfig
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.cross_table_lookup import prove_multi_table, verify_multi_table
    from plonky2_torch.starky.serialization import stark_proof_to_bytes
    from plonky2_torch.util import rng
    from torch_make_data import CTL_LOG_ROWS, CTL_POW_BITS, CTL_QUERIES, DATA

    base = StarkConfig.standard_fast_config()
    config = dataclasses.replace(base, fri_config=dataclasses.replace(
        base.fri_config, num_query_rounds=CTL_QUERIES, proof_of_work_bits=CTL_POW_BITS))

    def read(name):
        with open(os.path.join(DATA, name), "rb") as f:
            return f.read()

    starks, ctls = mt.system()
    traces, pis = mt.generate_traces(CTL_LOG_ROWS)
    proofs, _ = prove_multi_table(starks, config, traces, pis, ctls, device=dev)
    for i, proof in enumerate(proofs):
        assert stark_proof_to_bytes(proof, config) == read(f"ctl_table{i}.stark_proof.bin")
    verify_multi_table(starks, config, proofs, ctls)
    data, pts = mt.wrap_circuit(starks, config, list(CTL_LOG_ROWS), ctls,
                                CircuitConfig.standard_recursion_config(), device=dev)
    assert verifier_data_to_bytes(data.verifier_only, data.common) == read(
        "ctl_wrap.verifier.bin")
    rng.seed(2026)
    try:
        proof = data.prove(mt.wrap_inputs(pts, proofs), device=dev)
    finally:
        rng.seed(None)
    assert proof_to_bytes(proof) == read("ctl_wrap.proof.bin")
    data.verify(proof)


def test_keccak_starky_prove_on_the_card_equals_its_cpu_proof(dev):
    """FibonacciStark and LookupTestStark at 2^7 under KeccakHasher: the
    card's proof (LDEs on the card, trees and grind on the host) equals the
    CPU's field by field, and the Keccak verifier accepts it."""
    from plonky2_torch.hash.hashers import KeccakHasher
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_torch.starky.prover import prove
    from plonky2_torch.starky.test_starks import LookupTestStark
    from plonky2_torch.starky.verifier import verify_stark_proof
    from torch_proof_walk import field_digests

    config = StarkConfig.standard_fast_config()
    n = 1 << 7
    fib = FibonacciStark(n)
    pis = [0, 1, fibonacci(n - 1, 0, 1)]
    lookup = LookupTestStark(n)
    for stark, trace, p in ((fib, fib.generate_trace(0, 1), pis),
                            (lookup, lookup.generate_trace(), [])):
        card = prove(stark, config, trace, p, device=dev, hasher=KeccakHasher)
        cpu = prove(stark, config, trace, p, device="cpu", hasher=KeccakHasher)
        assert field_digests(card) == field_digests(cpu)
        verify_stark_proof(stark, card, config, hasher=KeccakHasher)


def test_gadgets_circuit_on_the_card_gives_the_reference_bytes(dev):
    """plonky2_torch/examples/gadgets.py's circuit built and proved on the
    card (rng seed 2026): the reference's verifier data and proof
    (plonky2_torch/data/gadgets.*.bin), accepted by the port's verifier."""
    import os

    from plonky2_torch.examples import gadgets
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import rng
    from torch_make_data import DATA

    def read(name):
        with open(os.path.join(DATA, name), "rb") as f:
            return f.read()

    data, pw = gadgets.circuit(dev)
    assert verifier_data_to_bytes(data.verifier_only, data.common) == read(
        "gadgets.verifier.bin")
    rng.seed(2026)
    try:
        proof = data.prove(pw, device=dev)
    finally:
        rng.seed(None)
    assert proof_to_bytes(proof) == read("gadgets.proof.bin")
    data.verify(proof)
