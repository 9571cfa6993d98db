"""FRI prover: commit-phase folding, proof-of-work grind, query rounds
(reference fri/prover.py). Two paths give the same proof bytes:

- fused (the default under Poseidon with at least one fold step): the
  transcript stays on the device (`iop.challenger.DeviceChallenger`) through
  each fold step's cap and β, the final polynomial, the proof-of-work grind
  (K5's device grind), the PoW response and the query indices; the openings
  are gathered at the device indices and the whole argument leaves the
  device in one fetch (`_fri_fused_finish`);
- host (`force_host_path()`, no fold step, or a non-algebraic hasher): the
  host challenger, one cap and one β crossing per fold step, the grind
  chunk by chunk, the indices drawn on the host. Under Keccak
  (`KeccakGoldilocksConfig`, as in the reference) the fold trees are host
  Keccak trees and the grind runs on the host (`_fri_proof_of_work_host`).

Folding, re-LDEs and Merkle builds run on the device on both. Coefficient
tensors are kept trimmed to their nonzero prefix (folding the zero tail
yields zeros, so results are identical).

Under a process group (`plonky2_torch.parallel`) FRI runs whole on every
rank; the initial oracles' openings come from their owner ranks inside
their trees' `gather` (`hash/merkle.py` `ShardedMerkleTree`). The host
path's chunked grind is split over the ranks (`_lowest_witness`), and
so is the fused path's grind on the CPU, where the plain grind is the
prove's cost; K5's device grind on the card runs whole on every rank.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.proof import (
    FriInitialTreeProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
)
from plonky2_torch.hash.merkle import MerkleProof, make_merkle_tree, open_many_packed
from plonky2_torch.hash.poseidon_constants import SPONGE_RATE, SPONGE_WIDTH
from plonky2_torch.iop.challenger import DeviceChallenger
from plonky2_torch.ops import poseidon as kp

GRIND_CHUNK_CUDA = 1 << 17
GRIND_CHUNK_CPU = 1 << 12

# _FORCE_HOST puts every prove on the host transcript (set it through
# force_host_path()); _LAST_PATH records which path the last FRI proof took,
# "fused" or "host".
_FORCE_HOST = False
_LAST_PATH = None


@contextlib.contextmanager
def force_host_path():
    """Scope in which proves take the host-transcript path; the previous
    setting comes back on exit, exceptions included."""
    global _FORCE_HOST
    prev = _FORCE_HOST
    _FORCE_HOST = True
    try:
        yield
    finally:
        _FORCE_HOST = prev


def _scope(timing, name: str):
    return timing.scope(name) if timing is not None else contextlib.nullcontext()


def fri_proof(initial_merkle_trees, final_coeffs, challenger, fri_params,
              hasher=None, final_poly_coeff_len=None, max_num_query_steps=None) -> FriProof:
    """final_coeffs: ext coefficient tensors (c0, c1) of length 2^degree_bits;
    the fold trees are `hasher`'s (Poseidon by default). With a fold step,
    a Poseidon transcript and outside force_host_path() the fused path runs
    and leaves the host challenger in the state the host path would; else
    the host path, recorded in `_LAST_PATH` (reference fri/prover.py:61-85).

    final_poly_coeff_len and max_num_query_steps give the transcript the
    shape of a larger proof, for a circuit that verifies proofs of several
    degrees: after the last fold, each missing step observes a zero cap
    and draws a β that nothing uses, and the final polynomial is observed
    padded with zero coefficients (reference fri/prover.rs:119-131). The
    proof itself keeps its own shape. Both paths do it (the reference's
    takes its "commit_fused" route here); the bytes are the same."""
    global _LAST_PATH
    from plonky2_torch.hash.hashers import PoseidonHasher

    pads = _unified_pads(fri_params, final_poly_coeff_len, max_num_query_steps)
    if (not _FORCE_HOST and getattr(hasher, "algebraic", True)
            and fri_params.reduction_arity_bits
            and challenger.hasher is PoseidonHasher):
        return _fri_proof_fused(initial_merkle_trees, final_coeffs, challenger, fri_params,
                                pads=pads)[0]
    _LAST_PATH = "host"
    n = fri_params.lde_size
    trees, final_poly = _fri_committed_trees(final_coeffs, challenger, fri_params, hasher, pads)
    pow_witness = fri_proof_of_work(challenger, fri_params.config, final_coeffs[0].device)
    query_round_proofs = _fri_prover_query_rounds(
        initial_merkle_trees, trees, challenger, n, fri_params)
    return FriProof(
        commit_phase_merkle_caps=[t.cap for t in trees],
        query_round_proofs=query_round_proofs,
        final_poly=final_poly,
        pow_witness=pow_witness,
    )


def _fold_step_leaves(values, arity_bits: int):
    """Bit-reverse the values, chunk them into arity cosets and flatten each
    coset's extension elements into one leaf [e0.0, e0.1, e1.0, ...]."""
    v0, v1 = values
    L = v0.shape[0]
    perm = ntt.bit_reverse_index(L.bit_length() - 1, v0.device)
    return torch.stack([v0[perm], v1[perm]], dim=-1).reshape(L >> arity_bits,
                                                             2 << arity_bits)


def _fold_coeffs(coeffs, beta, arity_bits: int):
    """Fold the coefficients by β per arity chunk: Σ_j β^j c[i·arity + j]."""
    c0, c1 = coeffs
    arity = 1 << arity_bits
    m = c0.shape[0] // arity
    c0 = c0.reshape(m, arity)
    c1 = c1.reshape(m, arity)
    acc = (c0[:, arity - 1], c1[:, arity - 1])
    for j in range(arity - 2, -1, -1):
        acc = g.ext2_add(g.ext2_mul(acc, beta), (c0[:, j], c1[:, j]))
    return acc


def _fold_coeffs_and_relde(coeffs, beta, arity_bits: int, rate_bits: int, shift: int):
    """Fold the coefficients by β per arity chunk; LDE them on the next coset."""
    acc = _fold_coeffs(coeffs, beta, arity_bits)
    values = ntt.lde_fft(torch.stack(acc), rate_bits, shift=shift)
    return acc, (values[0], values[1])


def _initial_lde(coeffs, rate_bits: int):
    values = ntt.coset_lde(torch.stack(coeffs), rate_bits)
    return values[0], values[1]


def _unified_pads(fri_params, final_poly_coeff_len, max_num_query_steps) -> tuple[int, int]:
    """(dummy fold steps, zero final coefficients) the transcript adds for
    the unified shape."""
    steps = (0 if max_num_query_steps is None
             else max(0, max_num_query_steps - len(fri_params.reduction_arity_bits)))
    coeffs = (0 if final_poly_coeff_len is None
              else max(0, final_poly_coeff_len - fri_params.final_poly_len()))
    return steps, coeffs


def _fri_committed_trees(coeffs, challenger, fri_params, hasher=None, pads=(0, 0)):
    rate_bits = fri_params.config.rate_bits
    cap_height = fri_params.config.cap_height
    device = coeffs[0].device
    shift = fs.MULTIPLICATIVE_GROUP_GENERATOR
    values = _initial_lde(coeffs, rate_bits)
    trees = []
    for arity_bits in fri_params.reduction_arity_bits:
        tree = make_merkle_tree(_fold_step_leaves(values, arity_bits), cap_height, hasher)
        trees.append(tree)
        challenger.observe_cap(tree.cap)
        beta = challenger.get_extension_challenge(2)
        shift = fs.exp(shift, 1 << arity_bits)
        coeffs, values = _fold_coeffs_and_relde(coeffs, g.ext_tensor(beta, device), arity_bits,
                                                rate_bits, shift)

    for _ in range(pads[0]):
        challenger.observe_elements([0] * (4 << cap_height))
        challenger.get_extension_challenge(2)
    c0, c1 = g.to_numpy(torch.stack(coeffs))
    final_poly = [(int(a), int(b)) for a, b in zip(c0, c1)]
    for coeff in final_poly + [(0, 0)] * pads[1]:
        challenger.observe_extension_element(coeff)
    return trees, final_poly


def fri_proof_of_work(challenger, config, device) -> int:
    """Grind for the LOWEST witness whose duplexed challenge has
    proof_of_work_bits leading zeros (any valid witness verifies, but only
    the lowest gives the reference's proof bytes). A non-algebraic
    (Keccak) transcript grinds on the host, as in the reference."""
    if not getattr(challenger.hasher, "algebraic", True):
        return _fri_proof_of_work_host(challenger, config)
    pow_bits = config.proof_of_work_bits
    if pow_bits == 0:
        witness = 0
    else:
        intermediate = list(challenger.sponge_state)
        pos = len(challenger.input_buffer)
        for i, x in enumerate(challenger.input_buffer):
            intermediate[i] = x
        threshold = 1 << (64 - pow_bits)
        chunk = GRIND_CHUNK_CUDA if torch.device(device).type == "cuda" else GRIND_CHUNK_CPU
        witness = _lowest_witness(
            lambda start: kp.grind_chunk(intermediate, pos, start, chunk, threshold, device),
            chunk, parallel.active_mesh())
    challenger.observe_element(witness)
    response = challenger.get_challenge()
    if response >= 1 << (64 - pow_bits):
        raise RuntimeError("proof-of-work witness does not meet the threshold")
    return witness


def _lowest_witness(search, chunk: int, group=None) -> int:
    """The lowest valid witness over the chunks [j chunk, (j + 1) chunk)
    (`search(start)`: a chunk's lowest valid candidate or None), in order;
    under a group the chunks are dealt out to the ranks in turn (in round
    t rank r searches chunk t k + r) and one all-gather of each rank's find
    ends the first round where any rank found one, with the least of the
    finds (every candidate below it lies in a chunk some rank searched)."""
    world, rank = (1, 0) if group is None else (group.world, group.rank)
    t = 0
    while True:
        start = (t * world + rank) * chunk
        found = search(start) if start < fs.P else None
        if group is None:
            finds = [] if found is None else [found]
        else:
            mine = torch.full((1,), -1 if found is None else g.i64(found), dtype=torch.int64,
                              device=group.device)
            finds = [g.u64(v) for v in group.all_gather(mine).reshape(-1).tolist() if v != -1]
        if finds:
            return min(finds)
        t += 1
        if t * world * chunk >= fs.P:
            raise RuntimeError("proof of work failed (searched the entire field)")


def _device_grind(state, pending, pow_bits: int):
    """The fused transcript's grind: K5's device grind (every rank runs it
    whole on the card), or on the CPU under a group the plain grind's
    chunks dealt out over the ranks (`_lowest_witness`)."""
    group = parallel.active_mesh()
    if group is None or state.is_cuda or pow_bits == 0:
        return kp.grind_device(state, pending, pow_bits)
    inter = [int(v) for v in g.to_numpy(state)]
    k = int(pending.shape[0])
    inter[:k] = [int(v) for v in g.to_numpy(pending)]
    threshold = 1 << (64 - pow_bits)
    witness = _lowest_witness(
        lambda start: kp.grind_chunk_plain(inter, k, start, GRIND_CHUNK_CPU, threshold,
                                           state.device),
        GRIND_CHUNK_CPU, group)
    return torch.full((1,), g.i64(witness), dtype=torch.int64, device=state.device)


GRIND_CHUNK_HOST = 1 << 14


def _fri_proof_of_work_host(challenger, config) -> int:
    """The grind of a Keccak transcript on the host (reference
    fri/prover.py `_fri_proof_of_work_host`): per candidate, the state with
    the witness in place hashed three times over gives 12 words; the
    response is the 8th word below p (the challenger pops state[RATE - 1]
    first), and a candidate whose three hashes keep fewer than 8 words is
    passed over, as there. The lowest passing candidate wins. At 0 bits the
    witness is 0, where the reference's np.uint64(1 << 64) raises
    (ROADMAP section 3)."""
    from plonky2_torch.hash import keccak as kk

    pow_bits = config.proof_of_work_bits
    threshold = 1 << (64 - pow_bits)
    if pow_bits == 0:
        witness = 0
    else:
        state = list(challenger.sponge_state)
        pos = len(challenger.input_buffer)
        state[:pos] = challenger.input_buffer
        base = np.frombuffer(kk.felts_to_bytes(state), dtype=np.uint8)
        rows = np.arange(GRIND_CHUNK_HOST)
        start = 0
        while True:
            states = np.tile(base, (GRIND_CHUNK_HOST, 1))
            cands = np.arange(start, start + GRIND_CHUNK_HOST, dtype=np.uint64)
            states[:, pos * 8:(pos + 1) * 8] = cands.astype("<u8").view(np.uint8).reshape(-1, 8)
            d = kk.keccak256_batch(states)
            words = [d.view("<u8")]
            for _ in range(2):
                d = kk.keccak256_batch(d)
                words.append(d.view("<u8"))
            w = np.concatenate(words, axis=1)  # [chunk, 12]
            csum = np.cumsum(w < np.uint64(fs.P), axis=1)
            resp = w[rows, np.argmax(csum == 8, axis=1)]
            good = np.nonzero((csum[:, -1] >= 8) & (resp < np.uint64(threshold)))[0]
            if good.size:
                witness = int(cands[good[0]])
                break
            start += GRIND_CHUNK_HOST
            if start >= fs.P:
                raise RuntimeError("proof of work failed (searched the entire field)")
    challenger.observe_element(witness)
    if challenger.get_challenge() >= threshold:
        raise RuntimeError("proof-of-work witness does not meet the threshold")
    return witness


def _fri_prover_query_rounds(initial_merkle_trees, trees, challenger, n, fri_params):
    indices = [c % n for c in challenger.get_n_challenges(fri_params.config.num_query_rounds)]
    tree_indices = [indices] * len(initial_merkle_trees)
    xs = indices
    for arity_bits in fri_params.reduction_arity_bits:
        xs = [x >> arity_bits for x in xs]
        tree_indices.append(xs)
    all_opens = open_many_packed(list(initial_merkle_trees) + list(trees), tree_indices)
    initial_opens = all_opens[:len(initial_merkle_trees)]
    step_opens = all_opens[len(initial_merkle_trees):]
    rounds = []
    for qi in range(len(indices)):
        steps = [FriQueryStep(evals=_unflatten(opens[qi][0]), merkle_proof=opens[qi][1])
                 for opens in step_opens]
        rounds.append(FriQueryRound(
            initial_trees_proof=FriInitialTreeProof(
                evals_proofs=[opens[qi] for opens in initial_opens]),
            steps=steps,
        ))
    return rounds


def _unflatten(flat: list[int]) -> list[tuple]:
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


# -- the fused path --------------------------------------------------------------

def _fused_commit_pow(coeffs, dc, fri_params, pads=(0, 0)):
    """The FRI transcript on the device (reference `_fused_commit_pow_fn`):
    the initial LDE; per fold step the leaves, the K4 tree, its cap observed
    into `dc`, β, the fold and re-LDE; then the unified shape's dummy steps
    and zero coefficients (`pads`) around the final polynomial observed,
    K5's device grind, the PoW response and the query indices drawn (masked
    to the LDE size). Returns (step trees, packed payload [caps, final
    polynomial c0 then c1, witness, response, indices, sponge state],
    device indices)."""
    config = fri_params.config
    rate_bits, cap_height = config.rate_bits, config.cap_height
    values = _initial_lde(coeffs, rate_bits)
    shift = fs.MULTIPLICATIVE_GROUP_GENERATOR
    trees = []
    for arity_bits in fri_params.reduction_arity_bits:
        tree = make_merkle_tree(_fold_step_leaves(values, arity_bits), cap_height)
        trees.append(tree)
        dc.observe_cap_rows(tree.cap_dev)
        beta = (dc.get_challenge(), dc.get_challenge())
        shift = fs.exp(shift, 1 << arity_bits)
        coeffs, values = _fold_coeffs_and_relde(coeffs, beta, arity_bits, rate_bits, shift)
    witness, pow_response, idx = _final_pow_queries(dc, coeffs, fri_params, pads)
    packed = torch.cat([t.cap_dev.reshape(-1) for t in trees]
                       + [coeffs[0], coeffs[1], witness, pow_response.reshape(1), idx,
                          dc.state])
    return trees, packed, idx


def _final_pow_queries(dc, coeffs, fri_params, pads=(0, 0)):
    """The fused transcript's end: the unified shape's dummy steps, the
    final polynomial (c0, c1 per coefficient, then the zero padding)
    observed, K5's device grind, the PoW response and the query indices
    masked to the LDE size; all on the device."""
    config = fri_params.config
    zeros = coeffs[0].new_zeros
    for _ in range(pads[0]):
        dc.observe_cap_rows(zeros((1 << config.cap_height, 4)))
        dc.get_n_challenges(2)
    dc.observe_elements(torch.stack(coeffs, dim=-1))
    if pads[1]:
        dc.observe_elements(zeros(2 * pads[1]))
    witness = _device_grind(dc.state, dc.pending(), config.proof_of_work_bits)
    dc.observe_elements(witness)
    pow_response = dc.get_challenge()
    idx = torch.stack(dc.get_n_challenges(config.num_query_rounds)) & (fri_params.lde_size - 1)
    return witness, pow_response, idx


def _sim_remaining_outputs(k_pending: int, arities, cap_rows: int, n_final: int,
                           num_queries: int, pads=(0, 0)) -> int:
    """How many squeezed outputs the host challenger would still hold after
    the fused transcript: its observe / draw sequence run on counts alone
    (the unified shape's `pads` included)."""
    state = {"inp": k_pending, "out": 0}

    def observe(times):
        for _ in range(times):
            state["out"] = 0
            state["inp"] += 1
            if state["inp"] == SPONGE_RATE:
                state["inp"] = 0
                state["out"] = SPONGE_RATE

    def get(times=1):
        for _ in range(times):
            if state["inp"] or not state["out"]:
                state["inp"] = 0
                state["out"] = SPONGE_RATE
            state["out"] -= 1

    for _ in range(len(arities) + pads[0]):
        observe(cap_rows * 4)
        get(2)
    observe(2 * (n_final + pads[1]))
    observe(1)  # the PoW witness
    get(1)  # the PoW response
    get(num_queries)  # the query indices
    return state["out"]


def _gather_all(initial_trees, step_trees, arities, idx, head):
    """Every tree's openings at the device query indices (each fold step's
    tree at idx >> the arity bits folded so far), packed after `head` into
    one flat tensor. Returns it and each tree's (queries, leaf width,
    levels)."""
    parts, shapes = list(head), []
    gathers = [t.gather(idx) for t in initial_trees]
    shift_bits = 0
    for tree, arity_bits in zip(step_trees, arities):
        shift_bits += arity_bits
        gathers.append(tree.gather(idx, shift_bits))
    for leaves, sibs in gathers:
        parts += [leaves.reshape(-1), sibs.reshape(-1)]
        shapes.append((int(leaves.shape[0]), int(leaves.shape[1]), int(sibs.shape[1])))
    return torch.cat(parts), shapes


def _fri_proof_fused(initial_trees, coeffs, challenger, fri_params, device_state=None,
                     extra_payload=None, timing=None, defer: bool = False, pads=(0, 0)):
    """The fused FRI proof (reference `_fri_proof_fused_impl`). Returns
    (FriProof, the fetched `extra_payload` or None). `pads`: the unified
    shape's (dummy steps, zero final coefficients).

    device_state = (sponge [12], pending [k]) continues a transcript that is
    already on the device (the fused prove) and `challenger` may be None;
    otherwise the host challenger's state goes up and comes back synced.
    extra_payload: a flat device tensor fetched in front of the FRI payload.
    defer=True returns `finish()` unrun: every launch is queued and the one
    fetch and the parse wait for the call."""
    global _LAST_PATH
    _LAST_PATH = "fused"
    config = fri_params.config
    arities = tuple(fri_params.reduction_arity_bits)
    device = coeffs[0].device
    lg_n = int(coeffs[0].shape[0]).bit_length() - 1
    n_final = 1 << (lg_n - sum(arities))
    if device_state is not None:
        sponge, pending = device_state
    else:
        sponge = g.upload(challenger.sponge_state, device)
        pending = g.upload(challenger.input_buffer, device)
    k_pending = int(pending.shape[0])
    with _scope(timing, "dispatch commit+pow+query program"):
        trees, packed, idx = _fused_commit_pow(coeffs, DeviceChallenger(sponge, pending),
                                               fri_params, pads)
    extra = extra_payload if extra_payload is not None else packed.new_empty((0,))
    with _scope(timing, "dispatch gather program"):
        out_dev, shapes = _gather_all(initial_trees, trees, arities, idx, [extra, packed])

    def finish():
        return _fri_fused_finish(out_dev, len(initial_trees), challenger, fri_params,
                                 device_state is None, timing, int(extra.shape[0]),
                                 extra_payload is not None, n_final, k_pending, shapes, pads)

    return finish if defer else finish()


def _fri_fused_finish(out_dev, n_init, challenger, fri_params, sync_challenger, timing,
                      n_extra, has_extra, n_final, k_pending, shapes, pads=(0, 0)):
    """The one device-to-host fetch of the fused FRI proof and its parse;
    the PoW response is checked here, after the fetch."""
    config = fri_params.config
    arities = tuple(fri_params.reduction_arity_bits)
    rows = 1 << config.cap_height
    num_queries = config.num_query_rounds
    with _scope(timing, "block on device + fetch"):
        flat = g.to_numpy(out_dev)
    with _scope(timing, "parse payload"):
        extra_host = flat[:n_extra] if has_extra else None
        pos = n_extra
        caps = []
        for _ in arities:
            caps.append([[int(v) for v in flat[pos + 4 * r:pos + 4 * (r + 1)]]
                         for r in range(rows)])
            pos += 4 * rows
        final_poly = [(int(a), int(b)) for a, b in zip(flat[pos:pos + n_final],
                                                       flat[pos + n_final:pos + 2 * n_final])]
        pos += 2 * n_final
        pow_witness, pow_response = int(flat[pos]), int(flat[pos + 1])
        pos += 2
        if pow_response >= 1 << (64 - config.proof_of_work_bits):
            raise RuntimeError("proof-of-work witness does not meet the threshold")
        pos += num_queries  # the indices, already applied on the device
        sponge_out = flat[pos:pos + SPONGE_WIDTH]
        pos += SPONGE_WIDTH
        opens = []
        for q, w, levels in shapes:
            leaves = flat[pos:pos + q * w].reshape(q, w)
            pos += q * w
            sibs = flat[pos:pos + q * levels * 4].reshape(q, levels, 4)
            pos += q * levels * 4
            opens.append((leaves, sibs, levels))
        if sync_challenger:
            m = _sim_remaining_outputs(k_pending, arities, rows, n_final, num_queries, pads)
            challenger.sponge_state = [int(x) for x in sponge_out]
            challenger.input_buffer = []
            challenger.output_buffer = [int(x) for x in sponge_out[:m]]

        def proof(leaves, sibs, levels, qi):
            return MerkleProof([[int(v) for v in sibs[qi, k]] for k in range(levels)])

        rounds = []
        for qi in range(num_queries):
            rounds.append(FriQueryRound(
                initial_trees_proof=FriInitialTreeProof(evals_proofs=[
                    ([int(v) for v in o[0][qi]], proof(*o, qi)) for o in opens[:n_init]]),
                steps=[FriQueryStep(evals=_unflatten([int(v) for v in o[0][qi]]),
                                    merkle_proof=proof(*o, qi)) for o in opens[n_init:]]))
    return FriProof(commit_phase_merkle_caps=caps, query_round_proofs=rounds,
                    final_poly=final_poly, pow_witness=pow_witness), extra_host
