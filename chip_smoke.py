#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (plonky2_torch) on one CUDA card.

    python3 chip_smoke.py                 # the whole run, on this checkout
    python3 chip_smoke.py --times DIR     # only K3's and K5's timings, on the
                                          # checkout at DIR (e.g. the parent commit)
    python3 chip_smoke.py --phases NAME.. # only the named phases (PHASES)
    python3 chip_smoke.py --phases multigpu  # the prove over every card (one
                                          # process a card, NCCL), beside one card's
    python3 chip_smoke.py --phases multigpu --cases NAME..  # only the named
                                          # cases of it (MULTIGPU_CASES)

In order: prints the card's name and power limit; builds the CUDA kernels
from `plonky2_torch/csrc/` (timed); proves the factorial circuit on the card
from the port's committed data on the fused transcript path (the default)
and on the host path, each to the bytes of `fixtures/factorial.proof.bin`,
then on the CPU (plain versions) to the same bytes; reads the
bench_recursion middle circuit (`bench_cache/middle14.circuit.bin`,
timed), requires its constants-sigmas commitment's cap to equal the file's
verifier cap, draws a witness from seed 2026, puts it on the card and
proves it on the fused path (the main path) and on the host path
(`force_host_path()`): per path one warm-up, MIDDLE_PROVES proves timed end
to end with no synchronised phase, each with every launch count set to 0
just before and read just after and the proof's sha256 the pinned one,
then MIDDLE_PROVES proves with the device synchronised at each phase's
start and end for the phase split, and (the fused path) one profiled
prove; counts the host
synchronisations of one warm prove per path under
`torch.cuda.set_sync_debug_mode("warn")` and requires the fused
`prove(_defer=True)` to raise nothing under "error"; then the headline
(bench.py's warm-start work): reads the inner proof and its verifier data
(`bench_cache/inner14.*.bin`, timed), rebuilds the proof and verifier-data
targets on a fresh builder and fills a PartialWitness from them, requires
the seed-2026 full witness of `prepare_witness` (the native plan; the time
of its first call, the plan's compilation included) to be the pinned one,
then one warm-up and HEADLINE_PROVES timed `prove(prover_data, common, pw)`
calls (witness + prove, the rng re-seeded before each, the counts set to 0
just before each and read just after, each proof the pinned one), as many
with every phase synchronised for the split (the two witness scopes beside
the device phases), and a `prove(_defer=True)` from the prepared host
witness under "error"; then prove_many at K = BATCH_K, window BATCH_WINDOW,
threads 1 and 2, each batch's proofs equal to K sequential proves under
the same seed sequence, the K witnesses pairwise distinct, at most the
window in flight, with proofs/s; then the build phase: builds the
bench_recursion inner circuit at 2^14 with the port's builder
(`examples/bench_recursion.py` `dummy_circuit`, once cold and
BUILD_REPEATS times timed, the counts set to 0 just before each build and
read just after, the split by scope of the median run on lines of its
own), requires its
verifier bytes to be `bench_cache/inner14.verifier.bin`'s, proves it under
seed 2026 (a first call and INNER_PROVES timed proves, each proof the
reference's, INNER14_PROOF_SHA256) and verifies it with
the port's verifier, proves the middle circuit from that proof (seed 2026; the
reference's MIDDLE_OVER_INNER14_SHA256) and verifies the middle proof
against the circuit file's verifier data; builds the middle circuit with
the port's in-circuit verifier over its inner circuit
(`examples/bench_recursion.py` `recursion_circuit`, once cold and
BUILD_REPEATS times timed, counts and split as above) and requires it to
be the headline's `bench_cache/middle14.circuit.bin` (common data,
constants-sigmas coefficients, sigmas, generators, watch lists, public
inputs, representative map, cap and digest), proves it from the port's
inner proof (a first call and INNER_PROVES timed proves, each
MIDDLE_OVER_INNER14_SHA256) and verifies it; builds the outer
circuit over it (timed, its verifier bytes the reference's
OUTER_VERIFIER_SHA256) and proves it from that middle proof (seed 2026; a
first call, INNER_PROVES timed proves, each the reference's
OUTER_OVER_INNER14_SHA256, one synchronised for the split) and verifies
it; runs the fixture chain (`chain(4)` under seed
2026: inner 2^4, middle and outer built, proved and verified on the card)
to `fixtures/bench_recursion.proof.bin` and `.verifier.bin`; then builds,
proves and verifies factorial, fibonacci, range_check and square_root on
the card to their fixtures' bytes; runs the Starky phase
(`starky_phase`: FibonacciStark and PermutationStark at 2^5 to their
fixtures' bytes, then
FibonacciStark and LookupTestStark at 2^STARKY_LOG_ROWS rows, a first
call, STARKY_PROVES timed proves with the counts set to 0 just before each
and read just after, each the reference's sha256, one synchronised for the
split by the reference's scope names, each proof verified; then K3's x2 LDE, iFFTs and rate-0 coset FFT, K4's width-2 and
width-4 trees over 2^21 leaves and K5's device grind at the Starky
transcript's state against their plain versions, timed); runs the cyclic
phase (`cyclic_phase`: the IVC hash chain of `examples/cyclic_recursion.py`,
the fixpoint built on the card to the reference's verifier bytes, the
cyclic circuit built once cold and BUILD_REPEATS times timed with its
split by scope and its verifier bytes the reference's, the base proof and
CYCLIC_LAYERS self-verifying layers each the reference's sha256, checked by
`check_cyclic_proof_verifier_data`, the port's verifier and the host
`hash_no_pad` chain, one layer synchronised for the split); runs the
Keccak phase (`keccak_phase`: `keccak_factorial` under
`KeccakGoldilocksConfig` built and proved on the card and on the CPU to
its fixtures' bytes, then the headline proof wrapped in a proof with
Keccak caps and transcript: the bench_recursion outer layer over it built
on a Keccak builder once cold and BUILD_REPEATS times timed, proved
KECCAK_PROVES times (the host transcript and host Keccak trees, the
trees' seconds apart), one synchronised for the split, verified, compressed and decompressed, every sha256 the reference's, and
the headline proof compressed to the reference's bytes); runs the sizes
phase (`sizes_phase`: the bench_recursion chain at inner 2^SIZES_LOG, the
middle layer's 28 queries on ExponentiationGate rows: each circuit built
once, timed and split, each layer proved (a first call with the peak of
allocated device memory, SIZES_PROVES timed proves of the inner and
middle layers, one synchronised for the split) and verified, every verifier data and proof the reference's; then K3's
LDE x8 of [135, 2^18] and iFFT of [83, 2^18], K4's wires tree over 2^21
leaves (each compared on a slice, timed whole) and K5's device grind at
its transcript against their plain versions); runs the zk phase
(`zk_phase`: the chain at inner 2^ZK_LOG under
`standard_recursion_zk_config()` for every layer, as above with
ZK_PROVES, its blinding rows counted, every hash the reference's; the
inner proof again on the host path to the same bytes; the middle layer's
fused `prove(_defer=True)` with 0 host synchronisations before its fetch
and nothing raised under "error"; `prove_many` of ZK_BATCH_K middle
proofs at threads 1 and 2, each equal to sequential proves, on the
single-stream pipeline that zero knowledge keeps; the middle proof
compressed and decompressed to its bytes; then K3's LDE x8 of
[135, 2^15], K4's salted trees of width 139, 24 and 20 over 2^18 leaves
and K5's device grind at its transcript against their plain versions);
runs the lookups phase (`lookups_phase`: the chains at inner 2^LOOKUP_LOG
over the one-TIP5-lookup and the 515-lookup inner circuits, as above with
LOOKUP_PROVES timed inner proves split with "compute lookup polys", the
one-lookup chain's outer only built, every hash the reference's; the
515-lookup inner proved on the host path to the same bytes; its device
lookup columns and LUT evaluations of one fused prove equal to the host
recurrence on that prove's draws; 0 host synchronisations before the
fused prove's fetch and nothing raised under "error"; prove_many of four
lookup inputs equal to sequential proves; then K3's LDE x8 of the 34-wide
Zs-partial-products-lookup batch [34, 2^14] and K4's tree of width 34
over 2^17 leaves against their plain versions); runs the batch FRI phase
(`batch_fri_phase`: groups of 2^20, 2^16 and 2^12 coefficients committed
in one BatchFriOracle and opened in one batch-FRI proof, fused and host
paths to the same bytes and challenger state, 0 host synchronisations
before the fused proof's fetch, the host verifier, its verifier circuit
built, proved and verified, every hash the reference's; then K3's and
K2's LDE x2 of the three groups, K3's coset FFT and iFFT at [2, 2^17],
K4's batch-tree segments and fold tree and K5's device grind at its
transcript against their plain versions); runs the STARK recursion phase
(`stark_recursion_phase`: the Starky phase's 2^20-row proofs each
verified in a circuit, built, proved STARK_WRAP_PROVES times after a
first call and verified, and the variable-degree circuit (STARK_VAR) over
FibonacciStark proofs of 2^14 and 2^17 rows made under its FRI params,
every hash the reference's; `--phases batch_fri stark_recursion` runs
these two alone); runs the cross-table lookup phase (`ctl_phase`:
`examples/multi_table.py`'s three tables at 2^20, 2^18 and 2^16 rows
proved by prove_multi_table, split table by table, host syncs counted,
profiled, verified on the host, table 1 shifted by 1 rejected by the
whole verify_multi_table, and the circuit verifying the three proofs
built, proved and verified, every hash the reference's; then K3's iFFT
and LDEs and K4's trees at the new widths, K2's FRI re-LDE of table 0 and
K5's device grind against their plain versions; `--phases ctl`);
runs the Keccak Starky phase (`stark_keccak_phase`: FibonacciStark and
LookupTestStark at 2^STARKY_LOG_ROWS rows under `KeccakHasher`, the LDEs
on the card and the trees and grind on the host, a first call,
STARK_KECCAK_PROVES timed proves synchronised at their phases, the host
trees' seconds apart, each proof's field-by-field walk digest the
reference's, accepted by the port's Keccak verifier and refused by a
Poseidon one; then every K2/K3 call of the path against its plain
version) and the gadgets phase (`gadgets_phase`: `examples/gadgets.py`'s
circuit over the builder's whole gadget surface built and proved on the
card to the reference's bytes, verified by the port's Python verifier and
its native binary; `--phases stark_keccak gadgets`); the port's native
verifier (`native.verifier_binary()`, built with g++ after the kernels)
also checks the headline, the Keccak wrap, the CTL circuit's proof and the
2^20 FibonacciStark proof, each time printed beside the Python
verifier's; runs `commit_and_open`
at the bench_recursion middle-circuit shapes (degree 2^13, oracles of
85/135/20/16 polynomials; its FRI proof on the fused path) with the counts
set to 0 just before and read just after each of its runs and its pinned
sha256, and profiles one more; holds each kernel and mode against its plain
PyTorch version on the same card input at the main path's full shapes
(exact equality) and times both with CUDA events; checks K2 at every fan
(1, 2, 4, 8, 16) and size (2^1..2^13) and the zero-tail form, K3 at every
size 2^14..2^20 (fans 1, 2, 8, batch 1 and 2, both directions, and batch 16
at 2^16), K4's Merkle trees (natural and row-leaf, cap height 0 to the full
height, leaves of width <= 4) level by level, K5's permutation on one state
(the transcript's duplex), on [12, 2^17] and on edge states, its chunk grind
at thresholds 0, 1 bit and 16 bits, and its device grind at 0, 1, 8 and 16
bits on the seed-2026 middle transcript's state and on random states (the
middle witness also against the chunk-by-chunk grind); at the build
path's shapes, K3's iFFT and LDE x8 of [83, 2^14] and K4's tree of width
83 over 2^17 leaves, and at the recursion layers' build shapes K2's iFFT
and LDE x8 of [85, 2^13] and K4's tree of width 85 over 2^16 leaves,
against their plain versions and timed; times K4's whole
wires tree and each of its launches, K3 at [2, 2^16], [16, 2^16] and
[1, 2^20], K5's bare grind launch (no candidate passing, and 16 bits), its
`grind_chunk` wrapper, its permute mode and its device grind; runs
`commit_and_open` at degree 2^10 on the card and on the CPU (plain
versions) and requires identical proof bytes; last, the multigpu phase
as a group of one in this process over NCCL (`multigpu_phase(in_process=
True)`: the middle circuit's random-witness prove on both paths and the
headline, each to its pin, with 0 host syncs before the fused fetch, and
one run of each other path under the group: the 2^20 Starky and Keccak
Starky, the multi-table prove, batch FRI, the Keccak wrap, prove_many
and the middle build, each to its pin; `--phases multigpu` runs it over
every card, beside the same proves on one card, with each rank's K3
sub-LDE and K4 local tree against their plain versions and
`sharded_prover_step` against the reference's). The
line before the last is
the `kernels` JSON object (launches: the headline prove's, the chunk
grind's from the host-path prove; beside them the inner build's and
prove's, the middle and outer builds', the outer prove's and the two 2^20
Starky proves', the cyclic build's and
a cyclic layer's, the Keccak wrap's build's and prove's, the 2^18
chain's inner build's and prove's and middle build's and prove's, the zk
chain's inner build's and prove's and middle prove's, the two lookup
inners' builds' and proves', the batch FRI prove's, the Fibonacci 2^20
wrap's and the variable-degree wrap's of 2^17 rows, the multi-table
prove's and its circuit's build's and prove's, the two 2^20 Keccak
Starky proves', the gadgets prove's and the headline prove's under a
group of one (`launches_prove_multigpu`), and the headline's,
prove_many's and the new phases' numbers), the last line the ok JSON
object. Every timing line names the
card and its power limit. Any failed check exits non-zero and prints no
result; so does a run without CUDA, and a run of the script alone, without
the `plonky2_torch/` package beside it. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

# H100 SXM peaks used for the bounds. HBM: 3.35 TB/s (NVIDIA data sheet).
# Integer work: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# One Goldilocks multiply needs at least the four 32x32 partial products
# of its 64x64 -> 128-bit product.
OPS_PER_MODMUL = 4
# One Poseidon permutation in the least work the repository computes it
# with: 8*12 + 22 S-boxes of 4 multiplies each, and 30 MDS layers in the
# frequency domain (csrc/poseidon_lane.cuh), 182 additions and shifted
# additions a layer. Every Poseidon bound (K4 and K5) uses it.
OPS_PER_PERMUTATION = (8 * 12 + 22) * 4 * OPS_PER_MODMUL + 30 * 182
# The dense MDS's count (144 constant multiply-adds on two 32-bit halves a
# layer), which K4 still computes and earlier bounds used; printed only.
OPS_PER_PERMUTATION_DENSE = (8 * 12 + 22) * 4 * OPS_PER_MODMUL + 30 * 144 * 2
GRIND_CHUNK = 1 << 17
SEED = 2026
MIDDLE_SHA256 = "757e4d01343c"  # the middle-shape commit_and_open's sha256 (prefix), seed 2026
MIDDLE_RUNS = 5
# the middle circuit's proof under random_witness(common, 2026): the port's
# plain path and the reference's host path give it on the CPU
# (tests/reference_prove_middle.py)
MIDDLE_PROVE_SHA256 = "0759dc2ebfa4f3097d596d1633f22fa013534b750fe1ba265a2fee16038a23ea"
# The repeats of the earlier paths were cut when the sizes and zk phases
# came (MIDDLE_PROVES, HEADLINE_PROVES, KECCAK_PROVES 5 -> 3, BATCH_K
# 16 -> 8, BUILD_REPEATS 3 -> 2), and again when the batch FRI and STARK
# recursion phases came (STARKY_PROVES, SIZES_PROVES, ZK_PROVES,
# LOOKUP_PROVES, MIDDLE_PROVES, HEADLINE_PROVES, INNER_PROVES,
# KECCAK_PROVES 3 -> 2, BATCH_K 8 -> 4; the profiled runs of the host-path
# middle prove, the inner 2^14 prove, the outer prove, the Starky 2^20
# prove, the cyclic layer, the Keccak wrap and the zk and one-lookup
# inners dropped: PERF.md keeps their earlier profiles), and again when
# the cross-table lookup phase came (STARKY_PROVES, KECCAK_PROVES,
# SIZES_PROVES, ZK_PROVES, LOOKUP_PROVES, BATCH_FRI_PROVES,
# STARK_WRAP_PROVES 2 -> 1, ZK_BATCH_K 4 -> 2; the profiled runs of the
# 2^18 inner, the lookup2 inner, the batch FRI prove and the 2^20 wrap
# dropped: PERF.md keeps their earlier profiles), so that a slow call on
# a loaded host stays well inside the script's time limit.
# Every *_PROVES below is such a time-budget setting, not a sample size:
# where it is 1, the "median" printed is that one run's wall.
MIDDLE_PROVES = 2
# the headline: bench_cache/inner14.proof.bin in the middle circuit's proof
# targets, the rng seeded to 2026; the full witness and the proof that the
# port's plain path, both witness engines and the reference give on the CPU
# (tests/reference_prove_middle.py)
HEADLINE_WITNESS_SHA256 = "078753bd98bdd5a12f0b0e27d62eaa1639b66a6c532cb152cb51ff663b98ca1d"
HEADLINE_PROOF_SHA256 = "9871be1789d5a82569612f725440a7345b8109716330ade7f73f336fa64fde28"
HEADLINE_PROVES = 2
BATCH_K = 4  # a quarter of bench.py's prove_many batch
BATCH_WINDOW = 3
# the build phase: the bench_recursion inner circuit at 2^14 built by the
# port (its verifier bytes must be bench_cache/inner14.verifier.bin), its
# proof under seed 2026, and the middle circuit's proof over that proof
# (seed 2026 again), as the reference gives them on the CPU
# (tests/reference_prove_middle.py --inner14)
INNER14_PROOF_SHA256 = "1b219186eb45a666f057473503c83d65ed05c7bb8e507c767d156508bf457bf4"
MIDDLE_OVER_INNER14_SHA256 = "e83fe3c3a9c0665b09f7095f9d48b12d8a6d62e32fa60001f5b42e9a9d0bbc67"
# the outer circuit the reference builds over the middle circuit: its
# verifier data and its proof from the middle proof above (seed 2026 again)
# (tests/reference_prove_middle.py --inner14)
OUTER_VERIFIER_SHA256 = "47c500d46e351b01f17042d874a343163ed27c6345503aa74847f4f8666f43cc"
OUTER_OVER_INNER14_SHA256 = "e54f11fa117f1111f5c1fa26dde2dfea77210e4ad97378cb2595ad5a1b01ad15"
BUILD_REPEATS = 2
INNER_PROVES = 2
# the Starky phase: FibonacciStark(2^20) (public inputs [0, 1,
# fibonacci(2^20 - 1, 0, 1)]) and LookupTestStark(2^20) (its own trace,
# numpy seed 0) under standard_fast_config, as the reference proves them on
# the CPU (tests/reference_prove_stark.py)
STARKY_LOG_ROWS = 20
FIB20_PROOF_SHA256 = "d0a5c168846f3ac76182eb10e06a66332b41fe3333db9d3e8757a68b103d47c2"
LOOKUP20_PROOF_SHA256 = "165cc9881eed695f44a9a3fd7a4e89bc2c5c56d7f2a6ac87bb342726b9df588d"
STARKY_PROVES = 1
# the IVC hash chain of examples/cyclic_recursion.py under seed 2026
# (tests/reference_prove_cyclic.py, the reference's): the fixpoint's and the
# cyclic circuit's verifier bytes, then the base proof and each layer's
CYCLIC_FIXPOINT_VERIFIER_SHA256 = "22dbdb6c67717335abdd12cb353e1a5c62054df1ec61f7c48d581f355a51fb9a"
CYCLIC_VERIFIER_SHA256 = "ac6d7e1aa7705efb8866bd781540da5851d781be8b780c6d0cf9bb8471028920"
CYCLIC_PROOF_SHA256S = ("ca4aa96195c765e13e8a9ad7bc04cef39a83bdd39afce6cb8abac7b8cb030e51",
                        "9f26fbee1fb26bb2cf96f0f3107c2b93eab2efe8aee1b659e18d0e04f626f48d",
                        "7822ed40f147fcce688714c4fdf9bc7316918cefef9371dcd227ccf15812512b")
CYCLIC_LAYERS = 2
# the Keccak phase: the bench_recursion outer layer over the headline's
# middle proof, built under keccak_goldilocks_config(), its proof (seed
# 2026) and that proof compressed, and the headline proof compressed, as
# the reference makes them on the CPU (tests/reference_prove_keccak.py)
KECCAK_WRAP_VERIFIER_SHA256 = "1a37b5b780bda71c137dbfc4b4d70dca7a51ebe57b8a3c18f10f7dd26f00fd1e"
KECCAK_WRAP_PROOF_SHA256 = "743e8711e2acf31b92717b9d996c774807ea2015192247dde5b29bb7cb285aa1"
KECCAK_WRAP_COMPRESSED_SHA256 = "db49d158afbc41f591cc9f5f8ec4b028f6248c27cd4d77ec503c7dbce0fb3d0e"
KECCAK_HEADLINE_COMPRESSED_SHA256 = (
    "5b025c580d187f30086873ded6505a60ee9d5bcb42cd031d09c2953464cec444")
KECCAK_PROVES = 1
# the sizes phase: the bench_recursion chain at inner 2^18 (the middle
# layer's exp_from_bits on ExponentiationGate rows), each layer's verifier
# data and its proof under seed 2026 as the reference makes them on the CPU
# (tests/reference_prove_sizes.py), inner first
SIZES_LOG = 18
SIZES_VERIFIER_SHA256S = (
    "e2997095f14a4a952fb9e26b559e1b6ca15799584e0be03f6c473a857b3a7fdb",
    "51d29bfa35ee08ae495774a6abfab62945fbc2d02f7426707cf6133206297ca8",
    "1f3d569ce6b3016f16242597adc8be8af5c7afbdabad6525207f309cc4ea2a16")
SIZES_PROOF_SHA256S = (
    "9a2307914d0c3be06cff3a846d99ffffa65747a1e5c84d347b4a742af6a88847",
    "61d95e18d1f88c7bfda381eb4275bab6ecc546bc91648bb7661f18ab7bb8db37",
    "0304b6d260f046ed93f1802490b012380adec3261d3c3eb965aec10aade2d4a2")
SIZES_PROVES = 1
# the zk phase: the chain at inner 2^14 under standard_recursion_zk_config()
# for every layer (tests/reference_prove_zk.py), inner first
ZK_LOG = 14
ZK_VERIFIER_SHA256S = (
    "db6a25fce39a61b99b9495a1baf477d22610fcd14b2af8b00826f82131ea3351",
    "94c92dc7b1a6282fc6602fba3a7e4f1cc7f4d5ef36c53a4e98c786963cbd3ce1",
    "bce1c8be8a8e735fe99211c9f5deee220132222142b49a73eacaad3eccea053d")
ZK_PROOF_SHA256S = (
    "281341165b89c2ca6ae96693a07c71748b8d39d11a458e414847e1cee841ce06",
    "0d81013f0230828d57daa03f2457481fc05f27dc3926efda53c974da537ee6ad",
    "273384706a5dd026b6a80c029553bd18a098bcdd4afe55a9110d13688ae05d84")
ZK_PROVES = 1
ZK_BATCH_K = 2
# the bench_recursion chains over the two lookup inner circuits at 2^14
# (lookup type 1: one TIP5 lookup, its input public; 2: 515 lookups), the
# reference's verifier data and proofs per layer under seed 2026
# (tests/reference_prove_lookups.py)
LOOKUP_LOG = 14
LOOKUP_VERIFIER_SHA256S = {
    1: ("cb141d086c16b3d45b5f8e8fa81dc86df7f4a81a0f10f7f1fa0cf00e17934b57",
        "03a52f14897fe078c304c70fff036d89ebfbaeabd014432df9681d78e39c011e",
        "c3920fc7477d47f97fc6a5fb481f698cd040e969bd89ef9a9eb722498f8f15d4"),
    2: ("0010d0d3ec6d9860dd15982357fcea6f93f35b29459aa1b35d73b501e609b437",
        "182073434d02302e3a9e24402dc953c82add6ef530de69d03f9b670cd2712db1",
        "47c500d46e351b01f17042d874a343163ed27c6345503aa74847f4f8666f43cc"),
}
LOOKUP_PROOF_SHA256S = {
    1: ("b12527abc8f477232b163160095997aff591b2ddd3070dbb399279b661afe297",
        "3ad4d23a7893d0ba3f08d448305388c638aebeedf892bc694baffda919bd1888",
        "df986d7f11c2587a25300289a99eadeaeb732668d434ecd660a4777504abb472"),
    2: ("0969dd9fcf082f3c0b00ace263a8fe743f3d156eeaff44064cf5435c3fa17bc9",
        "fab4e31cff18f922990405be8a324dcc873e9e45367735223103d33f11cf0c41",
        "1996bf97c1bb62fdbcabb8e4b14e4cd91c6aec02d4644d94ae41a1592c878d4f"),
}
LOOKUP_PROVES = 1
LOOKUP_BATCH_INPUTS = (2, 17, 100, 255)  # prove_many's lookup inputs, K = 4
# the batch FRI phase: groups of 2^20, 2^16 and 2^12 coefficients (16, 8
# and 4 polynomials, numpy seed 2026) under standard_fast_config's FRI
# config, the batch-FRI proof, its verifier circuit's verifier data and
# that circuit's proof (seed 2026), as the reference makes them on the CPU
# (tests/reference_prove_batch_fri.py)
BATCH_FRI_PROOF_SHA256 = "4ccf65c4ce7803ece49b719140e1cbd0004a5e973c4308bb5a1ec32d4efa59f8"
BATCH_FRI_VERIFIER_SHA256 = "607f2dcbc8210654c9967b8e18b67382c76620fb7b83e2e453795ada18ad1f42"
BATCH_FRI_CIRCUIT_PROOF_SHA256 = (
    "e168ff9a54cdf27a91e38fb50f6b96653e1ba7129413379e8340beae5b1803e8")
BATCH_FRI_PROVES = 1
# the STARK recursion phase: the 2^20-row FibonacciStark and LookupTestStark
# proofs (FIB20_PROOF_SHA256, LOOKUP20_PROOF_SHA256) each verified in a
# circuit under standard_recursion_config(); the variable-degree circuit
# (max 2^18, min 2^12, standard_fast_config's 84 queries) over the
# FibonacciStark proofs of 2^14 and 2^17 rows made under fri_params(18):
# the reference's verifier data and proofs (seed 2026;
# tests/reference_prove_stark_recursion.py)
STARK_WRAP_VERIFIER_SHA256S = {
    "fibonacci": "335a6d29a0c204c6eb7d1d79e328d695e656c2eadebbe2e2fc2986c01f25714b",
    "lookup": "5766fdf47f47fa77fe7fab46bcb6d5c5c9be9e247684641ecfd3cb6e06ff1ed1",
}
STARK_WRAP_PROOF_SHA256S = {
    "fibonacci": "580afe02ed4557389cbd8e88c5827ada7b7e123524d5ecf791faadd9088d9dea",
    "lookup": "63728c5e0326326a483d12b255cc99c5f280fa15014dfad1a88e71baa38d1324",
}
STARK_WRAP_PROVES = 1
STARK_VAR = (18, 12, 14, 17)  # max and min degree bits, the two proofs' degree bits
STARK_VAR_VERIFIER_SHA256 = "e2a9c4221e7e8f912694021516d91ea6f6833edb22bdf81c490b6306cce5f972"
STARK_VAR_PROOF_SHA256S = (  # the STARK proofs under fri_params(18)
    "c687d72c02c09c5541197a1c5fadfff29b23e0a2e2ecdffdaae72fcdccbee3d5",
    "7a5122171db3cb24ad620f53948e167776bebcebfcd9caaa2e2ddaadcf433913")
STARK_VAR_WRAP_SHA256S = (
    "4544b636c1e98e225caa8ecdb77797e0029e3ece72404d2a75a5cc6f951f2e7c",
    "c876f2bf4e922e3b11868286bea70b222ca42171df4edbf61aba8345c4c9e731")
# the cross-table lookup phase: examples/multi_table.py's three tables
# (CpuTable 35 columns, MemoryTable, StoreTable; traces from numpy seed
# 2026) at CTL_LOG_ROWS under standard_fast_config, each table's proof of
# prove_multi_table; the circuit verifying the three proofs and the CTL
# sums (standard_recursion_config()): its verifier data and proof (seed
# 2026), as the reference makes them on the CPU (tests/reference_prove_ctl.py)
CTL_LOG_ROWS = (20, 18, 16)
CTL_PROOF_SHA256S = (
    "b988ec0fd535cf860c4e0f153fd8eb8b714b711182ebbeb767c7489bfe63b152",
    "e941652bdb1199b31611eb0009527543f73994e1fcf2741face77dd36341b6ce",
    "b526705f0580da77245cdb4a18ecb7b55c64ccef14fd256f0e844768c8ba18db")
CTL_WRAP_VERIFIER_SHA256 = "59c3ca9efa498fc9c23a6fa4d08c0d76e81fd9c4835a9ed8cd930fcc1ca5d756"
CTL_WRAP_PROOF_SHA256 = "be22072bad395c882249063ddb05bb5a5ca50d833f988664ec3cb2b685e00ae6"
CTL_PROVES = 1
# the Keccak-hashed Starky proves (FibonacciStark and LookupTestStark at
# 2^STARKY_LOG_ROWS rows, standard_fast_config, KeccakHasher): the digest of
# each proof's field-by-field walk (`proof_walk_digest`; the reference
# writes no bytes for such a proof), tests/reference_prove_stark_keccak.py
STARK_KECCAK_FIB20_DIGEST = "f67ae6d2cbdd78ab56e7a83a27aa6be00690d60ec870b7c0735a639bc57adbb9"
STARK_KECCAK_LOOKUP20_DIGEST = "2c75b1344ed23bd4482ba8293d65405a00fdd288f2b67575e942c6cde81ce4a2"
STARK_KECCAK_PROVES = 1
# the circuit of plonky2_torch/examples/gadgets.py at standard_recursion_config,
# built and proved (rng seed 2026) by the reference: tests/reference_prove_gadgets.py
GADGETS_VERIFIER_SHA256 = "4f7785bb527d424884e1367411446e6fee6e659d9c70387a8f3ec67cb8fb938a"
GADGETS_PROOF_SHA256 = "83b9fa1378839631d0fa70e4d7d138bfd046d9554633c8453be44464ba5d5455"
# the multigpu phase: the proves over a process group of every card (--phases
# multigpu), or of one in this process (the whole run), each beside one
# card's; the reference's multi-chip dry-run step (`sharded_prover_step`,
# its cap and Z as u64 bytes) from tests/reference_prover_step.py
# the paths that run under a group besides the PLONK prove: Starky (Poseidon
# and Keccak) at 2^STARKY_LOG_ROWS, the multi-table prove at CTL_LOG_ROWS,
# batch FRI, the Keccak wrap of the headline proof, prove_many of the middle
# circuit (MULTIGPU_BATCH_K proofs of the headline's inputs over every card,
# BATCH_K / 2 in the group of one; window BATCH_WINDOW, threads 1), the middle
# circuit's build, and prove_many at two dispatch threads (each slot on its
# own communicator; run in the group of one and on one card only: under an
# NCCL group of more ranks prove_many refuses dispatch threads)
MULTIGPU_PATHS = ("starky fibonacci", "starky lookup", "multi-table", "batch FRI",
                  "keccak wrap", "keccak starky fibonacci", "prove_many", "middle build",
                  "prove_many threads 2")
MULTIGPU_CASES = ("middle fused", "middle host", "headline", "inner18", "zk inner",
                  "lookup1 inner") + MULTIGPU_PATHS
MULTIGPU_IN_PROCESS = ("middle fused", "middle host", "headline") + MULTIGPU_PATHS
# one timed run and nothing else, after the cases before them warmed their circuit
MULTIGPU_ONCE = ("prove_many", "middle build", "prove_many threads 2")
MULTIGPU_PROVES = 3
MULTIGPU_BATCH_K = 16
# the one-card parts check: every rank of these worlds played on the one
# card (8 parts for 3 ranks, 16 for 6), its part LDEs and subtrees against
# the whole LDE's columns and the whole tree's digests, at these (polynomials,
# lg degree) shapes at rate 3: K3 (2^16 coefficients) and K2 (2^10)
PARTS_WORLDS = (3, 6)
PARTS_SHAPES = ((8, 16), (8, 10))
PARTS_CAP_HEIGHT = 4
MULTIGPU_PROFILED = ("headline", "inner18")  # profiled on one card and on every rank
PROVER_STEP_SHA256 = "a5494b24073cd19d1dd5d5dbd7d5d40619829cc287c0d0e80da40469ea8fac88"


def same_generators(a: list, b: list) -> bool:
    """The same generator classes with equal fields, in order."""
    import numpy as np

    def same(x, y):
        if type(x) is not type(y) or vars(x).keys() != vars(y).keys():
            return False
        return all(np.array_equal(u, v) if isinstance(u, np.ndarray) else u == v
                   for u, v in zip(vars(x).values(), vars(y).values()))

    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def circuit_differences(built, prover_only, common, verifier_only) -> list[str]:
    """What of a built CircuitData differs from a circuit read from its
    file: the common data, the preprocessed polynomials, the generators,
    their watch lists, the public inputs, the representative map and the
    verifier data (cap and digest)."""
    import numpy as np

    got = built.prover_only
    out = [name for name in ("constants_sigmas_coeffs", "sigmas", "subgroup",
                             "representative_map")
           if not np.array_equal(np.asarray(getattr(got, name)),
                                 np.asarray(getattr(prover_only, name)))]
    if built.common != common:
        out.append("common data")
    if not same_generators(got.generators, prover_only.generators):
        out.append("generators")
    w, want = got.generator_indices_by_watches, prover_only.generator_indices_by_watches
    if w.keys() != want.keys() or not all(np.array_equal(w[k], want[k]) for k in want):
        out.append("watch lists")
    if got.public_inputs != prover_only.public_inputs:
        out.append("public inputs")
    if built.verifier_only.constants_sigmas_cap != verifier_only.constants_sigmas_cap:
        out.append("constants-sigmas cap")
    if got.circuit_digest != prover_only.circuit_digest or \
            built.verifier_only.circuit_digest != verifier_only.circuit_digest:
        out.append("circuit digest")
    return out


def median_run(runs: list) -> tuple[float, dict, float]:
    """Of timed runs [(wall, split by scope)], the one whose wall is the
    median (the lower of two): its wall, its split and its time outside
    the scopes, so that the split adds up to the wall."""
    wall, split = sorted(runs, key=lambda r: r[0])[(len(runs) - 1) // 2]
    return wall, split, wall - sum(split.values())


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, warmup: int, per: int = 1) -> float:
    """Median of `reps` samples, each `per` back-to-back runs bracketed by
    CUDA events, divided by `per` (per > 1 keeps a kernel shorter than its
    host-side call from timing the host)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def compare(a, b) -> tuple[int, float]:
    """(mismatching elements, max |a - b| over u64 values)."""
    import numpy as np

    from plonky2_torch.field import goldilocks as g

    if a is None or b is None or not hasattr(a, "shape"):
        return (0, 0.0) if a == b else (1, float("inf"))
    if a.shape != b.shape:
        return a.numel() or 1, float("inf")
    x, y = g.to_numpy(a), g.to_numpy(b)
    bad = x != y
    if not bad.any():
        return 0, 0.0
    diff = max(abs(int(u) - int(v)) for u, v in zip(x[bad][:4096], y[bad][:4096]))
    return int(bad.sum()), float(diff)


def ptxas_lines(log: str) -> list[str]:
    """Each kernel's registers and spill bytes from `nvcc -Xptxas -v`."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(k\d_\w+?_kernel)(\w*)'", line)
        if m:
            targs = re.match(r"I((?:L[a-z]\d+E)+)E", m.group(2))
            name = m.group(1) + (f"<{','.join(re.findall(r'L[a-z](\d+)E', targs.group(1)))}>"
                                 if targs else "")
            spills = "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)} registers, {spills} bytes spilled")
            name = None
    return out


def profiled(torch, run, warmup=None):
    """The CUDA kernels' key_averages of one `run()`, recorded after one
    unrecorded warm-up step in the same profiler session (`warmup()`, by
    default `run()`): a session that starts recording at once lost its
    first kernels' records on the H100 once an earlier session had run in
    the process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    kernels = []

    def ready(prof):
        kernels.extend(e for e in prof.key_averages() if e.device_type == DeviceType.CUDA)

    with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=ready,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in (warmup or run, run):
            step()
            torch.cuda.synchronize()
            prof.step()
    return kernels


def profile_line(torch, run, wall_s: float, label: str, warmup=None) -> dict | None:
    """One run under the CUDA profiler (kernels only, no CPU-op recording;
    `warmup` as `profiled`'s): the kernels' summed device time against the
    unprofiled wall time, the number of kernel launches, the kernels with
    the most device time, and each port kernel's device time and launches.
    Returns the first three (None where the profiler saw no kernels)."""
    kernels = profiled(torch, run, warmup)

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    if device_ms == 0:
        print(f"profile {label}: device time not measured (the profiler saw no kernels)")
        return
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    tops = ", ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
    print(f"profile {label}: kernels busy the device {device_ms:.3f} ms of the "
          f"{wall_s * 1e3:.1f} ms "
          f"unprofiled wall ({device_ms / (wall_s * 1e3):.1%}); "
          f"{sum(e.count for e in kernels)} kernel launches; top device time: {tops}")
    import re

    ported = {}
    for e in kernels:
        m = re.search(r"(k\d_\w+?_kernel)", e.key)
        if m:
            ms, n = ported.get(m.group(1), (0.0, 0))
            ported[m.group(1)] = (ms + dev_us(e) / 1e3, n + e.count)
    print(f"profile {label}: port kernels' device time: " + ", ".join(
        f"{k} {ms:.3f} ms over {n} launches" for k, (ms, n) in sorted(ported.items())))
    return dict(device_ms=device_ms, busy=device_ms / (wall_s * 1e3),
                launches=sum(e.count for e in kernels))


@contextlib.contextmanager
def one_cpu_thread(torch):
    """Plain CPU runs take one intra-op thread: the plain Poseidon grind's
    small chunks run faster on one thread than spread over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def device_ms(torch, fn, key: str, calls: int = 20):
    """Device time per call of the kernels whose name holds `key`, summed by
    the CUDA profiler over `calls` calls (None where it saw none)."""

    def run():
        for _ in range(calls):
            fn()

    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in profiled(torch, run)
             if key in e.key)
    return us / calls / 1e3 if us else None


def kernel_times(torch, dev, kn, kp, build, stream_ptr, wrapper: bool) -> dict:
    """K3's and K5's times at the shapes compared across versions, on the
    checkout whose modules are passed (this one, or one given with
    --times): K3 inverse at [2, 2^16] (the main path's: the quotient's and
    the FRI batch quotient's coset iFFTs), [16, 2^16] (on no path; the
    batch earlier records took for the quotient's) and [1, 2^20] (a larger
    circuit's); K5 as (i)
    one bare grind launch of 2^17 candidates at a
    threshold no candidate meets, so that every permutation runs, (ii) the
    same launch at 16 bits, (iii) the grind_chunk wrapper at 16 bits, with
    its synchronisation (where `wrapper`: the --times mode leaves it out,
    since an older wrapper took the state as a tensor), (iv) permute on
    [12, 2^17]."""
    import ctypes

    import numpy as np

    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import scalar as fs

    rng = np.random.default_rng(SEED + 7)

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    t = {}
    for batch, lg in ((2, 16), (16, 16), (1, 20)):
        y = rand((batch, 1 << lg))
        t[f"k3_inverse_{batch}x2^{lg}"] = time_ms(
            torch, lambda y=y: kn.ntt_four_step(y, inverse=True), reps=20, warmup=3, per=20)
        t[f"k3_inverse_{batch}x2^{lg}_device"] = device_ms(
            torch, lambda y=y: kn.ntt_four_step(y, inverse=True), "k3_")
    inter = [int(v) for v in rng.integers(0, fs.P, size=12, dtype=np.uint64)]
    host = (ctypes.c_uint64 * 12)(*inter)
    best = torch.full((1,), -1, dtype=torch.int64, device=dev)
    lib = build.library("poseidon")

    def bare(threshold):
        build.check(lib.k5_grind(host, 5, 0, GRIND_CHUNK, threshold, best.data_ptr(),
                                 stream_ptr(best)), "k5_grind")

    t["k5_grind_bare_none"] = time_ms(torch, lambda: bare(0), reps=10, warmup=2)
    t["k5_grind_bare_none_device"] = device_ms(torch, lambda: bare(0), "k5_", calls=10)
    t["k5_grind_bare_16bits"] = time_ms(torch, lambda: bare(1 << 48), reps=10, warmup=2)
    if wrapper:
        t["k5_grind_wrapper_16bits"] = time_ms(
            torch, lambda: kp.grind_chunk(inter, 5, 0, GRIND_CHUNK, 1 << 48, dev),
            reps=10, warmup=2)
    states = rand((12, GRIND_CHUNK))
    t["k5_permute_12x2^17"] = time_ms(torch, lambda: kp.permute(states), reps=10, warmup=2)
    return t


def times_only(root: str) -> int:
    """--times DIR: build the kernels of the checkout at DIR and print K3's
    and K5's times as one JSON line; no checks, no ok line."""
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(root))
    try:
        import plonky2_torch
        from plonky2_torch import ops
        from plonky2_torch.ops import build
        from plonky2_torch.ops import ntt as kn
        from plonky2_torch.ops import poseidon as kp
    except ImportError as e:
        return fail(f"the port cannot be imported from {root} ({e})")
    if not os.path.abspath(plonky2_torch.__file__).startswith(os.path.abspath(root)):
        return fail(f"plonky2_torch came from {plonky2_torch.__file__}, not {root}")
    build.build_all()
    for src, log in build.ptxas_log.items():
        print(f"ptxas {src}: " + "; ".join(ptxas_lines(log)))
    t = kernel_times(torch, torch.device("cuda"), kn, kp, build, ops.stream_ptr, wrapper=False)
    print(json.dumps({"times": t, "root": os.path.abspath(root),
                      "card": torch.cuda.get_device_name(0)}))
    return 0


def starky_phase(torch, dev, card, failures, root) -> dict:
    """The Starky prover on the card: the two fixtures at 2^5 to their
    bytes (the committed reference proofs at 2^5 and 2^7 are
    tests/test_torch_cuda.py's);
    FibonacciStark and LookupTestStark at 2^STARKY_LOG_ROWS rows, each a
    first call, STARKY_PROVES timed proves (the counts set to 0 just before
    each and read just after, each proof the reference's sha256), one
    synchronised for the phase split, and each verified by the port's
    verifier; then each new kernel shape of the path against its
    plain version, timed. Returns what the kernels line and the summary
    take; appends to `failures`."""
    import numpy as np

    from plonky2_torch import ops
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.ops import ntt as kn
    from plonky2_torch.ops import poseidon as kp
    from plonky2_torch.starky import prover as sp
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_torch.starky.serialization import stark_proof_to_bytes
    from plonky2_torch.starky.test_starks import LookupTestStark, PermutationStark
    from plonky2_torch.starky.verifier import verify_stark_proof
    from plonky2_torch.util import TimingTree

    config = StarkConfig.standard_fast_config()

    def read(*parts) -> bytes:
        with open(os.path.join(root, *parts), "rb") as f:
            return f.read()

    def fib_case(n):
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        return stark, stark.generate_trace(pis[0], pis[1]), pis

    def lookup_case(n):
        stark = LookupTestStark(n)
        return stark, stark.generate_trace(), []

    def verified(stark, proof, what) -> tuple[bool, float]:
        """(accepted, seconds) of the port's verifier on `proof`."""
        t0 = time.perf_counter()
        try:
            verify_stark_proof(stark, proof, config)
            ok = True
        except ValueError as e:
            ok = False
            failures.append(f"the port's verifier rejects the {what} proof: {e}")
        return ok, time.perf_counter() - t0

    t_phase = time.perf_counter()
    perm = PermutationStark(1 << 5)
    fixtures = [("fibonacci 2^5", *fib_case(1 << 5), ("fixtures", "starky_fibonacci.proof.bin")),
                ("permutation 2^5", perm, perm.generate_trace(3, 9), [3, 9],
                 ("fixtures", "starky_permutation.proof.bin"))]
    for what, stark, trace, pis, ref in fixtures:
        proof = sp.prove(stark, config, trace, pis, device=dev)
        same = stark_proof_to_bytes(proof, config) == read(*ref)
        ok, _ = verified(stark, proof, what)
        print(f"starky {what} ({card}): proof = {'/'.join(ref)}: {same} (FRI transcript "
              f"{fri_prover._LAST_PATH}); the port's verifier accepts it: {ok}")
        if not same:
            failures.append(f"the starky {what} proof on the card is not {'/'.join(ref)}")

    print(f"starky phase: the fixtures' proves and verifies took "
          f"{time.perf_counter() - t_phase:.1f} s")
    grind_inputs = []
    grind_device = kp.grind_device

    def recording_grind(state, pending, pow_bits):
        grind_inputs.append((state.clone(), pending.clone(), pow_bits))
        return grind_device(state, pending, pow_bits)

    n = 1 << STARKY_LOG_ROWS
    out = {}
    for name, make, want in (("fibonacci", fib_case, FIB20_PROOF_SHA256),
                             ("lookup", lookup_case, LOOKUP20_PROOF_SHA256)):
        t0 = time.perf_counter()
        stark, trace, pis = make(n)
        trace_s = time.perf_counter() - t0
        trace_dev = g.tensor(trace, dev)  # the prove's input, already on the card

        def prove(timing=None, stark=stark, trace_dev=trace_dev, pis=pis):
            return sp.prove(stark, config, trace_dev, pis, device=dev, timing=timing)

        def pinned(proof, what, name=name, want=want):
            digest = hashlib.sha256(stark_proof_to_bytes(proof, config)).hexdigest()
            if digest != want:
                failures.append(f"{what}: the starky {name} 2^{STARKY_LOG_ROWS} proof's sha256 "
                                f"is {digest}, not {want}")
            return digest

        t0 = time.perf_counter()
        if name == "fibonacci":
            kp.grind_device = recording_grind
        try:
            proof = prove()
        finally:
            kp.grind_device = grind_device
        first_s = time.perf_counter() - t0
        pinned(proof, "first call")
        accepted, verify_s = verified(stark, proof, f"{name} 2^{STARKY_LOG_ROWS}")
        if name == "fibonacci":
            out["native"] = native_verify(card, failures,
                                          f"FibonacciStark 2^{STARKY_LOG_ROWS} proof",
                                          ["--stark=fibonacci"],
                                          [stark_proof_to_bytes(proof, config)], verify_s)
        walls = []
        for _ in range(STARKY_PROVES):
            ops.reset_launches()
            t0 = time.perf_counter()
            proof = prove()
            walls.append(time.perf_counter() - t0)
            launches = ops.launch_counts()
            duplexes = ops.K5.batch1
            digest = pinned(proof, "timed prove")
            if fri_prover._LAST_PATH != "fused":
                failures.append(f"the starky {name} prove's FRI took the "
                                f"{fri_prover._LAST_PATH} path")
        timing = TimingTree("starky prove", sync=torch.cuda.synchronize)
        t0 = time.perf_counter()
        pinned(prove(timing), "synchronised prove")
        sync_wall = time.perf_counter() - t0
        split = timing.split()
        wall = statistics.median(walls)
        size = len(stark_proof_to_bytes(proof, config))
        print(f"starky {name} prove (2^{STARKY_LOG_ROWS} rows, {stark.COLUMNS} columns, "
              f"constraint degree {stark.constraint_degree()}; {card}): {wall:.4f} s median of "
              f"{[round(w, 4) for w in walls]} (first call {first_s:.3f} s; the trace made in "
              f"{trace_s:.3f} s on the host), {size} proof bytes, sha256 {digest} (the "
              f"reference's: {want}); launches {launches} (K5 permutes on one state: "
              f"{duplexes}); the port's verifier: {verify_s:.3f} s, accepted: {accepted}")
        print(f"starky {name} prove phases ({card}), s, the device synchronised at each "
              f"phase's start and end ({sync_wall:.4f} s wall): "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; outside the phases {sync_wall - sum(split.values()):.4f}")
        for label, count in launches.items():
            if count == 0 and label != ops.K5_CHUNK.label:  # the host path's grind
                failures.append(f"{label} was not launched on the starky {name} prove")
        print(f"starky phase so far: {time.perf_counter() - t_phase:.1f} s")
        out[name] = dict(wall_s=wall, walls=walls, first_s=first_s, sync_wall_s=sync_wall,
                         split=split, launches=launches, duplexes=duplexes,
                         verify_s=verify_s, sha256=digest, proof_bytes=size)
        out.setdefault("proofs", {})[name] = proof  # the STARK recursion phase wraps them
        del trace_dev

    # each new kernel shape of the path against its plain version: K3's
    # x2 LDE [2, 2^20] -> [2, 2^21] (the trace commitment), its iFFTs at
    # [2, 2^20] (the trace's, and Fibonacci's quotient coset iFFT) and
    # [2, 2^21] (the lookup STARK's quotient), the selectors' coset FFT at
    # rate 0 [2, 2^20]; K4's natural trees of width 2 and 4 over 2^21
    # leaves (the hash_or_noop leaves); K5's device grind on the Fibonacci
    # prove's transcript
    rng = np.random.default_rng(SEED + 20)

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    lg = STARKY_LOG_ROWS
    gen = fs.MULTIPLICATIVE_GROUP_GENERATOR
    x = rand((2, n))
    x21 = rand((2, 2 * n))
    tab = ntt._lde_coset_scale_table(gen, lg, 1, str(dev))
    shift = ntt.shift_powers(gen, n, dev).reshape(1, n)
    lde2, lde4 = kn.ntt_four_step(x, scale=tab, fan=2), rand((4, 2 * n))

    def k3_bound(batch, lg_n):
        m = 1 << lg_n
        return 8 * 2 * batch * m, OPS_PER_MODMUL * batch * (m // 2 * lg_n + m)

    def tree_bound(width, lg_n):
        m = 1 << lg_n
        return (8 * (width * m + kp.tree_words(m, lg_n - 4)),
                OPS_PER_PERMUTATION * (m - (m >> (lg_n - 4))))  # no leaf hashing: width <= 4

    shapes = [
        (ops.K3, f"starky_lde_2x2_{lg}_x2", lambda: kn.ntt_four_step(x, scale=tab, fan=2),
         lambda: kn.ntt_four_step_plain(x, False, tab, 2),
         8 * (x.numel() + tab.numel() + 2 * x.numel()),
         OPS_PER_MODMUL * 2 * 2 * ((n // 2) * lg + n)),
        (ops.K3, f"starky_ifft_2x2_{lg}", lambda: kn.ntt_four_step(x, inverse=True),
         lambda: kn.ntt_four_step_plain(x, inverse=True), *k3_bound(2, lg)),
        (ops.K3, f"starky_ifft_2x2_{lg + 1}", lambda: kn.ntt_four_step(x21, inverse=True),
         lambda: kn.ntt_four_step_plain(x21, inverse=True), *k3_bound(2, lg + 1)),
        (ops.K3, f"starky_coset_fft_2x2_{lg}", lambda: kn.ntt_four_step(x, scale=shift),
         lambda: kn.ntt_four_step_plain(x, scale=shift),
         8 * (2 * x.numel() + n), OPS_PER_MODMUL * 2 * ((n // 2) * lg + 2 * n)),
        (ops.K4, f"starky_tree_2x2_{lg + 1}", lambda: kp.merkle_tree(lde2, 4, True),
         lambda: kp.merkle_tree_plain(lde2, 4, True), *tree_bound(2, lg + 1)),
        (ops.K4, f"starky_tree_4x2_{lg + 1}", lambda: kp.merkle_tree(lde4, 4, True),
         lambda: kp.merkle_tree_plain(lde4, 4, True), *tree_bound(4, lg + 1)),
    ]
    if len(grind_inputs) != 1:
        failures.append(f"the starky Fibonacci first call ran {len(grind_inputs)} device "
                        f"grinds, not 1")
    else:
        state, pending, bits = grind_inputs[0]
        witness = g.u64(int(kp.grind_device(state, pending, bits)[0]))
        shapes.append((ops.K5_DEVICE, "starky_grind_device",
                       lambda: kp.grind_device(state, pending, bits),
                       lambda: kp.grind_device_plain(state, pending, bits, chunk=GRIND_CHUNK),
                       8 * (12 + int(pending.shape[0]) + 1),
                       OPS_PER_PERMUTATION * (witness + 1)))
        print(f"K5 device grind on the starky Fibonacci 2^{lg} transcript ({bits} bits, "
              f"{int(pending.shape[0])} pending): witness {witness}")
    out["shapes"] = shape_checks(torch, failures, [(*shape, None) for shape in shapes])
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"starky phase ({card}): {out['phase_s']:.1f} s")
    return out


def cyclic_phase(torch, dev, card, failures) -> dict:
    """The IVC hash chain (`examples/cyclic_recursion.py`) on the card: the
    fixpoint's three circuits built (its verifier bytes the reference's);
    the cyclic circuit built once cold and BUILD_REPEATS times timed, each
    under seed 2026 with the counts set to 0 just before and read just
    after, split by scope (the dummy circuit's build, its prove, the
    in-circuit verifier, the build's own scopes), its verifier bytes the
    reference's; the base proof (`cyclic_base_proof` and the prove) and
    CYCLIC_LAYERS self-verifying layers, each under seed 2026 with the
    counts set to 0 just before and read just after, each the reference's
    sha256, checked by `check_cyclic_proof_verifier_data` and the port's
    verifier, its counter and tip held to the host `hash_no_pad`; then one
    layer synchronised at each phase for the split. Returns what the
    kernels line and the summary take; appends to
    `failures`."""
    from plonky2_torch import ops
    from plonky2_torch.examples import cyclic_recursion as ivc
    from plonky2_torch.hash.poseidon import hash_no_pad
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.recursion.cyclic_recursion import check_cyclic_proof_verifier_data
    from plonky2_torch.util import TimingTree
    from plonky2_torch.util import rng as prover_rng

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    def vd_sha(data) -> str:
        return hashlib.sha256(verifier_data_to_bytes(data.verifier_only, data.common)).hexdigest()

    t_phase = time.perf_counter()
    timing = TimingTree("fixpoint", sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    fix = ivc.common_data_for_recursion(dev, timing)
    fixpoint_s = time.perf_counter() - t0
    fix_sha = vd_sha(fix)
    print(f"cyclic fixpoint (the empty circuit and two recursion levels, the last of degree "
          f"2^{fix.common.degree_bits}, built on the card; {card}): {fixpoint_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in timing.split().items())
          + f"); verifier sha256 {fix_sha} (the reference's: "
          f"{CYCLIC_FIXPOINT_VERIFIER_SHA256})")
    if fix_sha != CYCLIC_FIXPOINT_VERIFIER_SHA256:
        failures.append(f"the cyclic fixpoint's verifier bytes are {fix_sha}, not the "
                        "reference's")
    common = fix.common

    builds = []
    for _ in range(1 + BUILD_REPEATS):  # the first build is cold
        timing = TimingTree("build", sync=torch.cuda.synchronize)
        ops.reset_launches()
        t0 = time.perf_counter()
        circuit = seeded(lambda: ivc.cyclic_circuit(common, dev, timing))
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0, timing.split()))
        build_launches = ops.launch_counts()
        cyclic_sha = vd_sha(circuit.data)
        if cyclic_sha != CYCLIC_VERIFIER_SHA256:
            failures.append(f"the cyclic circuit's verifier bytes are {cyclic_sha}, not the "
                            "reference's")
    data = circuit.data
    build_wall, build_split, build_outside = median_run(builds[1:])
    print(f"cyclic circuit build (degree 2^{data.common.degree_bits}, "
          f"{data.common.num_public_inputs} public inputs, {len(data.prover_only.generators)} "
          f"generators, a 2^{common.degree_bits} dummy circuit built and proved inside; {card}): "
          f"{build_wall:.4f} s median of {[round(w, 4) for w, _ in builds[1:]]} (cold "
          f"{builds[0][0]:.4f} s); verifier sha256 {cyclic_sha} (the reference's: "
          f"{CYCLIC_VERIFIER_SHA256}); launches {build_launches}")
    for k, v in build_split.items():
        print(f"cyclic circuit build split, the median run ({card}): {k} {v:.4f} s")
    print(f"cyclic circuit build split, the median run ({card}): outside the scopes "
          f"{build_outside:.4f} s")
    for label, n in build_launches.items():
        if n == 0 and label != ops.K5_CHUNK.label:  # the host path's grind
            failures.append(f"{label} was not launched in the cyclic circuit's build")

    def pinned(proof, layer, what) -> str:
        digest = hashlib.sha256(proof_to_bytes(proof)).hexdigest()
        if digest != CYCLIC_PROOF_SHA256S[layer]:
            failures.append(f"{what}: the cyclic proof {layer}'s sha256 is {digest}, not "
                            f"{CYCLIC_PROOF_SHA256S[layer]}")
        return digest

    proofs, layers = [], []
    for layer in range(CYCLIC_LAYERS + 1):
        name = "base" if layer == 0 else f"layer {layer}"
        ops.reset_launches()
        t0 = time.perf_counter()
        if layer == 0:
            proof = seeded(lambda: ivc.base_proof(circuit, device=dev))
        else:
            proof = seeded(lambda: ivc.step(circuit, proofs[-1], device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        duplexes = ops.K5.batch1
        digest = pinned(proof, layer, name)
        if tp._LAST_TRANSCRIPT != "fused":
            failures.append(f"the cyclic {name} prove took the {tp._LAST_TRANSCRIPT} path")
        for label, n in launches.items():
            if n == 0 and label != ops.K5_CHUNK.label:
                failures.append(f"{label} was not launched on the cyclic {name} prove")
        t0 = time.perf_counter()
        try:
            check_cyclic_proof_verifier_data(proof, data.verifier_only, data.common)
            key_ok = True
        except ValueError as e:
            key_ok = False
            failures.append(f"the cyclic {name} proof's verifier data: {e}")
        t1 = time.perf_counter()
        try:
            data.verify(proof)
            accepted = True
        except ValueError as e:
            accepted = False
            failures.append(f"the port's verifier rejects the cyclic {name} proof: {e}")
        verify_s = time.perf_counter() - t1
        check_s = t1 - t0
        tip = list(ivc.INITIAL)
        for _ in range(layer + 1):
            tip = hash_no_pad(tip)
        pis = [int(v) for v in proof.public_inputs]
        chain_ok = pis[ivc.COUNTER] == layer + 1 and pis[4:8] == tip
        if not chain_ok:
            failures.append(f"the cyclic {name} proof's counter {pis[ivc.COUNTER]} and tip "
                            f"{pis[4:8]} are not {layer + 1} and {tip}")
        plan = data.prover_only.cache("host").get("last_plan")
        fallbacks = "all (the worklist ran)" if plan is None else plan.fallbacks
        print(f"cyclic {name} ({'the base proof built and proved, then ' if layer == 0 else ''}"
              f"witness + fused prove; {card}): {wall:.4f} s, sha256 {digest} (the "
              f"reference's: {CYCLIC_PROOF_SHA256S[layer]}); launches {launches} (K5 permutes "
              f"on one state: {duplexes}); generators run in Python: {fallbacks}; counter "
              f"{pis[ivc.COUNTER]}, tip = hash_no_pad^{layer + 1}(initial): {chain_ok}; "
              f"check_cyclic_proof_verifier_data {check_s:.4f} s, passed: {key_ok}; the "
              f"port's verifier {verify_s:.3f} s, accepted: {accepted}")
        if plan is None or set(plan.fallbacks) != {"DummyProofGenerator"}:
            failures.append(f"the cyclic {name} prove's witness ran {fallbacks} in Python")
        proofs.append(proof)
        layers.append(dict(wall_s=wall, sha256=digest, launches=launches, duplexes=duplexes,
                           verify_s=verify_s, counter=pis[ivc.COUNTER]))

    def layer_one(timing=None):
        return seeded(lambda: ivc.step(circuit, proofs[0], device=dev, timing=timing))

    timing = TimingTree("prove", sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    pinned(layer_one(timing), 1, "layer 1, synchronised")
    sync_wall = time.perf_counter() - t0
    split = timing.split()
    print(f"cyclic layer 1 prove phases ({card}), s, the device synchronised at each phase's "
          f"start and end ({sync_wall:.4f} s wall): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; outside the phases {sync_wall - sum(split.values()):.4f}")
    # no profile: a layer has the outer circuit's gates and launches (PERF.md §5)
    out = dict(fixpoint_s=fixpoint_s, fixpoint_sha256=fix_sha, build_wall_s=build_wall,
               build_cold_s=builds[0][0], build_split=build_split,
               build_outside_s=build_outside, build_launches=build_launches,
               cyclic_sha256=cyclic_sha, layers=layers, layer_split=split,
               layer_sync_wall_s=sync_wall, phase_s=time.perf_counter() - t_phase)
    print(f"cyclic phase ({card}): {out['phase_s']:.1f} s")
    return out


def keccak_phase(torch, dev, card, failures, middle, headline_bytes) -> dict:
    """The Keccak config on the card: `keccak_factorial` built and proved
    on the card and on the CPU (plain versions) to
    `fixtures/keccak_factorial.*` and verified; then the wrap, the
    bench_recursion outer layer over the headline's middle proof
    (`headline_bytes`, HEADLINE_PROOF_SHA256) on a builder under
    `keccak_goldilocks_config()`: built once cold and BUILD_REPEATS times
    timed (split by scope; verifier bytes KECCAK_WRAP_VERIFIER_SHA256),
    one warm-up and KECCAK_PROVES timed proves (witness + prove, seed 2026,
    the counts and the host trees' seconds set to 0 just before each and
    read just after, each KECCAK_WRAP_PROOF_SHA256, the host-transcript
    path recorded), one synchronised at each phase for the split with the
    host trees' leaf copies and hashing apart; the proof
    verified, compressed (KECCAK_WRAP_COMPRESSED_SHA256), decompressed to
    its bytes and accepted by `verify_compressed`; and the headline's proof
    compressed (KECCAK_HEADLINE_COMPRESSED_SHA256) and decompressed to its
    bytes. `middle` = (prover-only, common, verifier-only) of
    `bench_cache/middle14.circuit.bin`. Returns what the kernels line and
    the summary take; appends to `failures`."""
    from plonky2_torch import ops
    from plonky2_torch.examples import factorial
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.hash import merkle
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.compressed import compress, decompress, verify_compressed
    from plonky2_torch.plonk.config import CircuitConfig, keccak_goldilocks_config
    from plonky2_torch.plonk.serialization import (
        compressed_proof_from_bytes,
        compressed_proof_to_bytes,
        proof_from_bytes,
        proof_to_bytes,
    )
    from plonky2_torch.recursion import recursive_verifier as rv
    from plonky2_torch.util import TimingTree
    from plonky2_torch.util import rng as prover_rng

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    def want(what, got, pinned):
        if got != pinned:
            failures.append(f"{what}: sha256 {got}, not the reference's {pinned}")

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    fixture = {k: open(os.path.join(root, "fixtures", f"keccak_factorial.{k}.bin"), "rb").read()
               for k in ("verifier", "proof")}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        with one_cpu_thread(torch) if where == "cpu" else contextlib.nullcontext():
            data, proof = seeded(lambda: factorial.keccak_build_and_prove(device=where))
        wall = time.perf_counter() - t0
        same = (verifier_data_to_bytes(data.verifier_only, data.common) == fixture["verifier"],
                proof_to_bytes(proof) == fixture["proof"])
        data.verify(proof)
        print(f"keccak_factorial (2^5, KeccakGoldilocksConfig; {where}; {card}): built and "
              f"proved in {wall:.3f} s (first calls), verifier bytes = fixture: {same[0]}, "
              f"proof = fixture: {same[1]}, verified; transcript {tp._LAST_TRANSCRIPT}, FRI "
              f"path {fri_prover._LAST_PATH}")
        if not all(same):
            failures.append(f"keccak_factorial on {where} is not fixtures/keccak_factorial.*")
        if (tp._LAST_TRANSCRIPT, fri_prover._LAST_PATH) != ("host", "host"):
            failures.append(f"keccak_factorial on {where} did not take the host path")

    prover_only, common, verifier_only = middle
    headline = proof_from_bytes(headline_bytes, common)

    def wrap_circuit(timing):
        """The outer layer's in-circuit verifier over the middle circuit, on a
        builder under the Keccak config."""
        builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                                 gc=keccak_goldilocks_config())
        with timing.scope("in-circuit verifier"):
            pt = rv.add_virtual_proof_with_pis(builder, common)
            vdt = rv.add_virtual_verifier_data(builder, common.config.fri_config.cap_height)
            rv.verify_proof(builder, pt, vdt, common)
            builder.register_public_inputs(pt.public_inputs)
        return builder.build(device=dev, timing=timing), pt, vdt

    builds = []
    for _ in range(1 + BUILD_REPEATS):  # the first build is cold
        timing = TimingTree("build", sync=torch.cuda.synchronize)
        ops.reset_launches()
        merkle.reset_host_trees()
        t0 = time.perf_counter()
        data, pt, vdt = wrap_circuit(timing)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0, timing.split()))
        build_launches = ops.launch_counts()
        build_trees = dict(merkle.HOST_TREES)
    vd_sha = sha(verifier_data_to_bytes(data.verifier_only, data.common))
    want("the Keccak wrap's verifier data", vd_sha, KECCAK_WRAP_VERIFIER_SHA256)
    build_wall, build_split, build_outside = median_run(builds[1:])
    print(f"keccak wrap build (degree 2^{data.common.degree_bits}, "
          f"{len(data.prover_only.generators)} generators, over the headline's middle circuit; "
          f"{card}): {build_wall:.4f} s median of {[round(w, 4) for w, _ in builds[1:]]} (cold "
          f"{builds[0][0]:.4f} s); verifier sha256 {vd_sha}; launches {build_launches}; the "
          f"constants-sigmas Keccak tree: leaves to the host {build_trees['copy_s']:.4f} s, "
          f"hashed {build_trees['hash_s']:.4f} s")
    for k, v in build_split.items():
        print(f"keccak wrap build split, the median run ({card}): {k} {v:.4f} s")
    print(f"keccak wrap build split, the median run ({card}): outside the scopes "
          f"{build_outside:.4f} s")
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, pt, headline)
    rv.set_verifier_data_target(pw, vdt, verifier_only)

    def wrap_prove(timing=None):
        return seeded(lambda: data.prove(pw, device=dev, timing=timing))

    t0 = time.perf_counter()
    proof = wrap_prove()
    first_s = time.perf_counter() - t0
    want("the Keccak wrap's first proof", sha(proof_to_bytes(proof)), KECCAK_WRAP_PROOF_SHA256)
    walls, trees = [], []
    for _ in range(KECCAK_PROVES):
        ops.reset_launches()
        merkle.reset_host_trees()
        t0 = time.perf_counter()
        proof = wrap_prove()
        walls.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        trees.append(dict(merkle.HOST_TREES))
        digest = sha(proof_to_bytes(proof))
        want("the Keccak wrap's proof", digest, KECCAK_WRAP_PROOF_SHA256)
        paths = (tp._LAST_TRANSCRIPT, fri_prover._LAST_PATH)
        if paths != ("host", "host"):
            failures.append(f"the Keccak wrap's prove took the {paths} paths, not the host's")
    wall_s = statistics.median(walls)
    tree_s = statistics.median(t["copy_s"] + t["hash_s"] for t in trees)
    print(f"keccak wrap prove (witness + prove from the headline proof; host transcript, "
          f"Keccak trees on the host; {card}): {wall_s:.4f} s median, {min(walls):.4f} s min of "
          f"{[round(w, 4) for w in walls]} (first call {first_s:.3f} s); the host trees "
          f"{tree_s:.4f} s median a prove ({trees[-1]['trees']} trees; leaves to the host "
          f"{trees[-1]['copy_s']:.4f} s, hashed {trees[-1]['hash_s']:.4f} s in the last); "
          f"sha256 {digest}; transcript {paths[0]}, FRI path {paths[1]}; launches {launches}")
    for kernel in (ops.K2, ops.K3):
        if launches[kernel.label] == 0:
            failures.append(f"{kernel.label} was not launched on the Keccak wrap's prove")
    timing = TimingTree("prove", sync=torch.cuda.synchronize)
    merkle.reset_host_trees()
    t0 = time.perf_counter()
    want("the Keccak wrap's synchronised proof", sha(proof_to_bytes(wrap_prove(timing))),
         KECCAK_WRAP_PROOF_SHA256)
    sync_wall = time.perf_counter() - t0
    split = timing.split()
    sync_trees = dict(merkle.HOST_TREES)
    print(f"keccak wrap prove phases ({card}), s, the device synchronised at each phase's "
          f"start and end ({sync_wall:.4f} s wall): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; outside the phases {sync_wall - sum(split.values()):.4f}; within them the "
          f"host trees' leaves to the host {sync_trees['copy_s']:.4f} s (the copies wait for "
          f"the LDEs) and their Keccak hashing {sync_trees['hash_s']:.4f} s")

    t0 = time.perf_counter()
    data.verify(proof)
    verify_s = time.perf_counter() - t0
    native = native_verify(card, failures, "Keccak wrap's proof", ["--keccak"],
                           [verifier_data_to_bytes(data.verifier_only, data.common),
                            proof_to_bytes(proof)], verify_s)
    t0 = time.perf_counter()
    compressed = compressed_proof_to_bytes(compress(proof, data.verifier_only, data.common),
                                           data.common)
    compress_s = time.perf_counter() - t0
    want("the Keccak wrap's compressed proof", sha(compressed), KECCAK_WRAP_COMPRESSED_SHA256)
    t0 = time.perf_counter()
    read = compressed_proof_from_bytes(compressed, data.common)
    back = proof_to_bytes(decompress(read, data.verifier_only, data.common))
    decompress_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify_compressed(read, data.verifier_only, data.common)
    verify_compressed_s = time.perf_counter() - t0
    if back != proof_to_bytes(proof):
        failures.append("the Keccak wrap's proof does not decompress to its bytes")
    print(f"keccak wrap proof ({card}): {len(proof_to_bytes(proof))} bytes, verified in "
          f"{verify_s:.3f} s; compressed to {len(compressed)} bytes in {compress_s:.3f} s, "
          f"sha256 {sha(compressed)}; decompressed to the proof's bytes: "
          f"{back == proof_to_bytes(proof)} ({decompress_s:.3f} s); verify_compressed "
          f"{verify_compressed_s:.3f} s")

    t0 = time.perf_counter()
    head_compressed = compressed_proof_to_bytes(compress(headline, verifier_only, common), common)
    head_back = proof_to_bytes(decompress(compressed_proof_from_bytes(head_compressed, common),
                                          verifier_only, common))
    head_s = time.perf_counter() - t0
    want("the headline's compressed proof", sha(head_compressed),
         KECCAK_HEADLINE_COMPRESSED_SHA256)
    if head_back != headline_bytes:
        failures.append("the headline proof does not decompress to its bytes")
    print(f"headline proof compressed ({card}): {len(head_compressed)} of {len(headline_bytes)} "
          f"bytes, sha256 {sha(head_compressed)}; decompressed to its bytes: "
          f"{head_back == headline_bytes}; both in {head_s:.3f} s")
    out = dict(build_wall_s=build_wall, build_cold_s=builds[0][0], build_split=build_split,
               build_outside_s=build_outside, build_launches=build_launches,
               build_host_trees=build_trees, prove_s=wall_s, prove_walls=walls,
               prove_first_s=first_s, launches=launches, host_trees_s=tree_s,
               split=split, sync_wall_s=sync_wall, sync_host_trees=sync_trees,
               verify_s=verify_s, compressed_bytes=len(compressed),
               proof_bytes=len(proof_to_bytes(proof)), decompress_s=decompress_s,
               verify_compressed_s=verify_compressed_s, native=native,
               phase_s=time.perf_counter() - t_phase)
    print(f"keccak phase ({card}): {out['phase_s']:.1f} s")
    return out


def chain_layers(torch, dev, card, failures, label, size, config, verifier_shas, proof_shas,
                 proves, grind_inputs, lookup_type=0, prove_outer=True) -> list:
    """The bench_recursion chain at inner 2^size under `config` for every
    layer, as `examples/bench_recursion.py` `chain(size, config,
    lookup_type=lookup_type)` runs it (the inner circuit of noops, or the
    lookup circuit of `lookup_type`), layer by layer: each circuit built
    once (timed, split by scope, the
    counts set to 0 just before and read just after; its verifier bytes'
    sha256 `verifier_shas[i]`; a recursion layer's ExponentiationGate rows
    counted), then proved from the layer below under seed 2026 (a first
    call with the peak of allocated device memory, `proves[i]` timed proves
    with the counts set to 0 just before each and read just after, each
    `proof_shas[i]`; one synchronised for the split) and verified by the
    port's verifier. The inner layer's first call records its device
    grind's inputs in `grind_inputs`. With `prove_outer` false the outer
    layer is built and its verifier bytes checked, and not proved. Returns
    per proved layer a dict of its numbers, with "data", "proof" and
    "inputs" (the PartialWitness)."""
    from plonky2_torch import ops
    from plonky2_torch.examples import bench_recursion as br
    from plonky2_torch.gates.exponentiation import ExponentiationGenerator
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.ops import poseidon as kp
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import TimingTree
    from plonky2_torch.util import rng as prover_rng

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    grind_device = kp.grind_device

    def recording_grind(state, pending, pow_bits):
        grind_inputs.append((state.clone(), pending.clone(), pow_bits))
        return grind_device(state, pending, pow_bits)

    layers = []
    for i, name in enumerate(("inner", "middle", "outer")):
        timing = TimingTree("build", sync=torch.cuda.synchronize)
        ops.reset_launches()
        t0 = time.perf_counter()
        if i == 0 and lookup_type:
            data, pw = br.lookup_circuit(config, size, lookup_type, device=dev, timing=timing)
        elif i == 0:
            data = br.dummy_circuit(config, size, device=dev, timing=timing)
            pw = PartialWitness()
        else:
            below = layers[-1]
            data, pt, vdt = br.recursion_circuit(below["data"].common, config, device=dev,
                                                 timing=timing)
            pw = br.recursion_inputs(pt, vdt, (below["proof"], below["data"].verifier_only,
                                               below["data"].common))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = ops.launch_counts()
        vd_sha = sha(verifier_data_to_bytes(data.verifier_only, data.common))
        if vd_sha != verifier_shas[i]:
            failures.append(f"{label} {name}: verifier data sha256 {vd_sha}, not the "
                            f"reference's {verifier_shas[i]}")
        exp_rows = sum(isinstance(g_, ExponentiationGenerator)
                       for g_ in data.prover_only.generators)
        regular, pairs = data.build_info.get("blinding", (0, 0))
        split = timing.split()
        print(f"{label} {name} build (degree 2^{data.common.degree_bits}, "
              f"{len(data.prover_only.generators)} generators, {exp_rows} ExponentiationGate "
              f"rows, blinding {regular} rows and {pairs} Z pairs; {card}): {build_s:.4f} s; "
              f"verifier sha256 {vd_sha}; launches {build_launches}; split: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; outside the scopes {build_s - sum(split.values()):.4f}")
        if i == 2 and not prove_outer:
            break

        def prove(timing=None, data=data, pw=pw):
            return seeded(lambda: data.prove(pw, device=dev, timing=timing))

        def pinned(proof, what, i=i, name=name):
            digest = sha(proof_to_bytes(proof))
            if proof_shas[i] is not None and digest != proof_shas[i]:
                failures.append(f"{label} {name} {what}: proof sha256 {digest}, not the "
                                f"reference's {proof_shas[i]}")
            return digest

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if i == 0:
            kp.grind_device = recording_grind
        t0 = time.perf_counter()
        try:
            proof = prove()
        finally:
            kp.grind_device = grind_device
        first_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        digest = pinned(proof, "first call")
        walls, launches = [], {}
        for _ in range(proves[i]):
            ops.reset_launches()
            t0 = time.perf_counter()
            again = prove()
            walls.append(time.perf_counter() - t0)
            launches = ops.launch_counts()
            pinned(again, "prove")
            if tp._LAST_TRANSCRIPT != "fused":
                failures.append(f"the {label} {name} prove took the {tp._LAST_TRANSCRIPT} path")
        for kernel_label, n in launches.items():
            if n == 0 and kernel_label != ops.K5_CHUNK.label:  # the host path's grind
                failures.append(f"{kernel_label} was not launched on the {label} {name} prove")
        timing = TimingTree("prove", sync=torch.cuda.synchronize)
        t0 = time.perf_counter()
        pinned(prove(timing), "synchronised prove")
        sync_wall = time.perf_counter() - t0
        prove_split = timing.split()
        t0 = time.perf_counter()
        try:
            data.verify(proof)
            accepted = True
        except ValueError as e:
            accepted = False
            failures.append(f"the port's verifier rejects the {label} {name} proof: {e}")
        verify_s = time.perf_counter() - t0
        wall = statistics.median(walls) if walls else first_s
        timed = (f"{wall:.4f} s median of {[round(w, 4) for w in walls]} (first call "
                 f"{first_s:.3f} s" if walls else f"{first_s:.4f} s, one prove (the first call")
        print(f"{label} {name} prove (witness + fused prove; {card}): {timed}; peak device memory "
              f"allocated {peak_gib:.2f} GiB), {len(proof_to_bytes(proof))} bytes, sha256 "
              f"{digest} (the reference's: {proof_shas[i]}); launches {launches}; the port's "
              f"verifier {verify_s:.3f} s, accepted: {accepted}")
        print(f"{label} {name} prove phases ({card}), s, the device synchronised at each "
              f"phase's start and end ({sync_wall:.4f} s wall): "
              + ", ".join(f"{k} {v:.4f}" for k, v in prove_split.items())
              + f"; outside the phases {sync_wall - sum(prove_split.values()):.4f}")
        layers.append(dict(data=data, proof=proof, inputs=pw, prove=prove, build_s=build_s,
                           build_split=split, build_launches=build_launches,
                           exp_rows=exp_rows, blinding=(regular, pairs),
                           degree_bits=data.common.degree_bits, first_s=first_s,
                           peak_gib=peak_gib, wall_s=wall, walls=walls, launches=launches,
                           split=prove_split, sync_wall_s=sync_wall, verify_s=verify_s,
                           sha256=digest, verifier_sha256=vd_sha))
    return layers


def layer_summary(layers) -> list:
    """The JSON-able numbers of chain_layers' layers."""
    drop = ("data", "proof", "inputs", "prove")
    return [{k: v for k, v in layer.items() if k not in drop} for layer in layers]


def shape_checks(torch, failures, shapes) -> dict:
    """Each (kernel, key, kernel call, plain call, bytes, operations,
    timed kernel call or None): the kernel against its plain version on the
    same card input (exact), one plain run timed, the kernel timed (the
    timed call where given: the full shape, where the compared one is a
    slice), and the bound of the timed work. Returns {kernel label: {key:
    numbers}}."""
    out = {}
    for kernel, key, run_k, run_p, n_bytes, n_ops, timed in shapes:
        got = run_k()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = run_p()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if isinstance(got, (list, tuple)):  # a tree's levels
            mism = int(len(got) != len(want)) + sum(compare(a, b)[0] for a, b in zip(got, want))
        else:
            mism = compare(got, want)[0]
        del got, want
        ms = time_ms(torch, timed or run_k, reps=10, warmup=2)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        print(f"{kernel.label} {key}: {mism} mismatches; {ms:.4f} ms kernel, {plain_ms:.4f} ms "
              f"plain{' (on the compared slice)' if timed else ''}, bound {b_ms:.4f} ms ({b_by}, "
              f"share {b_ms / ms:.1%})")
        out.setdefault(kernel.label, {})[key] = dict(mismatches=mism, ms=ms, plain_ms=plain_ms,
                                                     plain_on_slice=timed is not None,
                                                     bound_ms=b_ms, bound_by=b_by)
        if mism:
            failures.append(f"{kernel.label} disagrees with its plain version at {key}")
    return out


def proof_walk_digest(x) -> str:
    """The sha256 of a proof object's field-by-field walk (a copy of
    tests/torch_proof_walk.py's `walk`): a dataclass's fields in order under
    their names, byte digests as bytes, ints as 8 little-endian bytes,
    lists with their lengths, each with a type tag."""
    import dataclasses

    h = hashlib.sha256()

    def walk(v):
        if v is None:
            h.update(b"N")
        elif isinstance(v, (bytes, bytearray)):
            h.update(b"B" + len(v).to_bytes(4, "little") + bytes(v))
        elif dataclasses.is_dataclass(v):
            h.update(b"D")
            for f in dataclasses.fields(v):
                h.update(b"F" + len(f.name).to_bytes(4, "little") + f.name.encode())
                walk(getattr(v, f.name))
        elif isinstance(v, (list, tuple)):
            h.update(b"L" + len(v).to_bytes(4, "little"))
            for item in v:
                walk(item)
        elif hasattr(v, "tolist"):
            walk(v.tolist())
        elif isinstance(v, int):
            h.update(b"I" + (int(v) % (1 << 64)).to_bytes(8, "little"))
        else:
            raise TypeError(f"no walk of {type(v).__name__}")

    walk(x)
    return h.hexdigest()


def native_verify(card, failures, what, flags, blobs, python_s) -> dict:
    """The port's `plonky2_verify` (plonky2_torch/native/src/verifier.cc) on
    `blobs` (verifier data and proof, or one STARK proof) under `flags`,
    timed as one process, its start included, beside the Python verifier's
    `python_s` on the same proof. Both are host times."""
    import tempfile

    from plonky2_torch import native

    binary = native.verifier_binary()
    with tempfile.TemporaryDirectory(dir=native.BUILD_ROOT) as d:
        paths = []
        for i, blob in enumerate(blobs):
            paths.append(os.path.join(d, f"{i}.bin"))
            with open(paths[-1], "wb") as f:
                f.write(blob)
        t0 = time.perf_counter()
        run = subprocess.run([binary, *flags, *paths], capture_output=True, text=True,
                             timeout=600)
        native_s = time.perf_counter() - t0
    ok = run.returncode == 0 and run.stdout.strip() == "OK"
    if not ok:
        failures.append(f"the port's native verifier refuses the {what}: rc {run.returncode} "
                        f"{run.stderr.strip()}")
    print(f"native verifier on the {what} ({' '.join(flags) or 'Poseidon'}; host of {card}): "
          f"{native_s:.4f} s, accepted: {ok}; the Python verifier on the same proof "
          f"{python_s:.4f} s")
    return dict(native_s=native_s, python_s=python_s, accepted=ok)


def sizes_phase(torch, dev, card, failures) -> dict:
    """The bench_recursion chain at inner 2^SIZES_LOG on the card
    (`chain_layers`: the inner circuit, the middle circuit over it, whose
    28 queries' exp_from_bits take ExponentiationGate rows, and the outer
    one; SIZES_PROVES timed proves of the inner and middle layers), every
    verifier data and proof the reference's
    (SIZES_VERIFIER_SHA256S, SIZES_PROOF_SHA256S); then the new kernel
    shapes of the inner layer against their plain versions: K3's LDE x8 of
    the wires [135, 2^18] -> [135, 2^21] and the constants-sigmas iFFT
    [83, 2^18], K4's wires tree of width 135 over 2^21 leaves (each
    compared on a slice, timed whole) and K5's device grind at the inner
    transcript. Returns what the kernels line and the summary take."""
    import numpy as np

    from plonky2_torch import ops
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.ops import ntt as kn
    from plonky2_torch.ops import poseidon as kp
    from plonky2_torch.plonk.config import CircuitConfig

    t_phase = time.perf_counter()
    grind_inputs = []
    layers = chain_layers(torch, dev, card, failures, "sizes", SIZES_LOG,
                          CircuitConfig.standard_recursion_config(), SIZES_VERIFIER_SHA256S,
                          SIZES_PROOF_SHA256S, (SIZES_PROVES, SIZES_PROVES, 0), grind_inputs)
    if layers[1]["exp_rows"] == 0:
        failures.append("the middle circuit over the 2^18 inner circuit has no "
                        "ExponentiationGate row")
    out = dict(layers=layer_summary(layers))
    del layers
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 30)

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    lg, gen = SIZES_LOG, fs.MULTIPLICATIVE_GROUP_GENERATOR
    n = 1 << lg
    wires = rand((135, n))
    cs = rand((83, n))
    table = ntt._lde_coset_scale_table(gen, lg, 3, str(dev))
    lde = kn.ntt_four_step(wires, scale=table, fan=8)
    n_lde = 8 * n
    lde_slice = lde[:, :1 << 15].contiguous()
    shapes = [
        (ops.K3, f"sizes_lde_135x2_{lg}_x8", lambda: kn.ntt_four_step(wires[:2], scale=table,
                                                                     fan=8),
         lambda: kn.ntt_four_step_plain(wires[:2], False, table, 8),
         8 * (wires.numel() + table.numel() + 8 * wires.numel()),
         OPS_PER_MODMUL * 135 * 8 * ((n // 2) * lg + n),
         lambda: kn.ntt_four_step(wires, scale=table, fan=8)),
        (ops.K3, f"sizes_ifft_83x2_{lg}", lambda: kn.ntt_four_step(cs[:2], inverse=True),
         lambda: kn.ntt_four_step_plain(cs[:2], inverse=True), 8 * 2 * cs.numel(),
         OPS_PER_MODMUL * 83 * ((n // 2) * lg + n), lambda: kn.ntt_four_step(cs, inverse=True)),
        (ops.K4, f"sizes_wires_tree_135x2_{lg + 3}", lambda: kp.sponge(lde_slice),
         lambda: kp.sponge_plain(lde_slice),
         8 * (lde.numel() + kp.tree_words(n_lde, lg + 3 - 4)),
         OPS_PER_PERMUTATION * (17 * n_lde + (n_lde - (n_lde >> (lg + 3 - 4)))),
         lambda: kp.merkle_tree(lde, 4, True)),
    ]
    if len(grind_inputs) == 1:
        state, pending, bits = grind_inputs[0]
        witness = g.u64(int(kp.grind_device(state, pending, bits)[0]))
        shapes.append((ops.K5_DEVICE, "sizes_grind_device",
                       lambda: kp.grind_device(state, pending, bits),
                       lambda: kp.grind_device_plain(state, pending, bits, chunk=GRIND_CHUNK),
                       8 * (12 + int(pending.shape[0]) + 1), OPS_PER_PERMUTATION * (witness + 1),
                       None))
        print(f"K5 device grind on the 2^{lg} inner transcript ({bits} bits): witness {witness}")
    else:
        failures.append(f"the 2^{lg} inner prove's first call ran {len(grind_inputs)} device "
                        "grinds, not 1")
    out["shapes"] = shape_checks(torch, failures, shapes)
    del wires, cs, lde, lde_slice
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"sizes phase ({card}): {out['phase_s']:.1f} s")
    return out


def zk_phase(torch, dev, card, failures) -> dict:
    """The bench_recursion chain at inner 2^14 under
    `standard_recursion_zk_config()` for every layer on the card
    (`chain_layers`: the inner circuit blinded to degree 2^15, the middle
    and outer layers verifying salted proofs in circuit; ZK_PROVES timed
    proves of the inner and middle layers), every verifier data and proof
    the reference's (ZK_VERIFIER_SHA256S, ZK_PROOF_SHA256S); the inner
    layer proved once on the host path to the same bytes; the host
    synchronisations of the middle layer's fused prove(_defer=True) (0
    before its fetch, and nothing raised under "error"); prove_many of
    ZK_BATCH_K middle proofs at threads 1 and 2, each equal to sequential
    proves, the pipeline recorded (zero knowledge keeps one stream); the
    middle proof compressed and decompressed to its bytes; then the new
    kernel shapes: K3's LDE x8 [135, 2^15] -> [135, 2^18], K4's salted
    trees over 2^18 leaves of width 139, 24 and 20 (each compared on a
    slice, timed whole) and K5's device grind at the inner transcript."""
    import numpy as np

    from plonky2_torch import ops
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.ops import ntt as kn
    from plonky2_torch.ops import poseidon as kp
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.compressed import compress, decompress
    from plonky2_torch.plonk.config import CircuitConfig
    from plonky2_torch.plonk.serialization import (
        compressed_proof_from_bytes,
        compressed_proof_to_bytes,
        proof_to_bytes,
    )
    from plonky2_torch.util import rng as prover_rng

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    t_phase = time.perf_counter()
    grind_inputs = []
    layers = chain_layers(torch, dev, card, failures, "zk", ZK_LOG,
                          CircuitConfig.standard_recursion_zk_config(), ZK_VERIFIER_SHA256S,
                          ZK_PROOF_SHA256S, (ZK_PROVES, ZK_PROVES, 0), grind_inputs)
    inner, middle = layers[0], layers[1]
    want_inner = proof_to_bytes(inner["proof"])
    with fri_prover.force_host_path():
        t0 = time.perf_counter()
        host = proof_to_bytes(inner["prove"]())
        host_s = time.perf_counter() - t0
    host_path = tp._LAST_TRANSCRIPT
    print(f"zk inner prove on the host path ({card}): {host_s:.4f} s, transcript {host_path}, "
          f"the fused path's bytes: {host == want_inner}")
    if host != want_inner or host_path != "host":
        failures.append("the zk inner prove on the host path is not the fused path's proof")

    data, pw = middle["data"], middle["inputs"]
    want_middle = proof_to_bytes(middle["proof"])
    prepared = seeded(lambda: tp.prepare_witness(data.prover_only, data.common, pw))

    def deferred():
        # the salts are drawn after the witness phase: the rng continues
        # from the prepared witness as a prove from the inputs continues
        prover_rng.seed(SEED)
        try:
            tp.prepare_witness(data.prover_only, data.common, pw)
            return tp.prove(data.prover_only, data.common, None, device=dev, _defer=True,
                            _prepared=prepared)
        finally:
            prover_rng.seed(None)

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            finish = deferred()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    same_deferred = proof_to_bytes(finish()) == want_middle
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = deferred()
        raised = None
    except RuntimeError as e:
        finish, raised = None, str(e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if finish is not None:
        same_deferred &= proof_to_bytes(finish()) == want_middle
    print(f"zk middle fused prove(_defer=True) from its prepared witness ({card}): "
          f"{len(syncs)} host synchronisations before its fetch "
          f"{[f'{os.path.basename(w.filename)}:{w.lineno}' for w in syncs][:6]}; under "
          f"set_sync_debug_mode('error'): {'raised ' + raised if raised else 'raised nothing'}; "
          f"proofs the middle proof: {same_deferred}")
    if syncs or raised:
        failures.append(f"the zk middle fused prove synchronised {len(syncs)} times before its "
                        f"fetch ({raised or 'nothing raised under error'})")
    if not same_deferred:
        failures.append("the zk middle deferred proves are not the middle proof")

    t0 = time.perf_counter()
    sequential = seeded(lambda: [proof_to_bytes(data.prove(pw, device=dev))
                                 for _ in range(ZK_BATCH_K)])
    sequential_s = time.perf_counter() - t0
    batched = {}
    for threads in (1, 2):
        t0 = time.perf_counter()
        got = seeded(lambda: tp.prove_many(data.prover_only, data.common, [pw] * ZK_BATCH_K,
                                           device=dev, window=BATCH_WINDOW, threads=threads))
        dt = time.perf_counter() - t0
        same = [proof_to_bytes(p) for p in got] == sequential
        batched[threads] = dict(proofs_per_s=ZK_BATCH_K / dt, seconds=dt, equal=same,
                                mode=tp._LAST_PROVE_MANY_MODE,
                                max_in_flight=tp._LAST_MAX_IN_FLIGHT)
        if not same:
            failures.append(f"zk prove_many (threads {threads}) differs from sequential proves")
        if tp._LAST_PROVE_MANY_MODE != "single-stream":
            failures.append(f"zk prove_many (threads {threads}) ran the "
                            f"{tp._LAST_PROVE_MANY_MODE} pipeline")
    print(f"zk prove_many K={ZK_BATCH_K}, window {BATCH_WINDOW}, middle layer ({card}): "
          + "; ".join(f"threads {t}: {v['proofs_per_s']:.3f} proofs/s ({v['seconds']:.2f} s), "
                      f"pipeline {v['mode']}, at most {v['max_in_flight']} in flight, proofs "
                      f"equal to the sequential: {v['equal']}" for t, v in batched.items())
          + f"; sequential {ZK_BATCH_K / sequential_s:.3f} proofs/s ({sequential_s:.2f} s)")

    t0 = time.perf_counter()
    compressed = compressed_proof_to_bytes(compress(middle["proof"], data.verifier_only,
                                                    data.common), data.common)
    back = proof_to_bytes(decompress(compressed_proof_from_bytes(compressed, data.common),
                                     data.verifier_only, data.common))
    compress_s = time.perf_counter() - t0
    print(f"zk middle proof compressed ({card}): {len(compressed)} of {len(want_middle)} bytes, "
          f"sha256 {hashlib.sha256(compressed).hexdigest()}; decompressed to its bytes: "
          f"{back == want_middle}; both in {compress_s:.3f} s")
    if back != want_middle:
        failures.append("the zk middle proof does not decompress to its bytes")
    out = dict(layers=layer_summary(layers), host_path_s=host_s, syncs_before_fetch=len(syncs),
               prove_many=batched, sequential_proofs_per_s=ZK_BATCH_K / sequential_s,
               compressed_bytes=len(compressed), proof_bytes=len(want_middle))
    del layers, inner, middle, data, prepared
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 40)

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    lg, gen = ZK_LOG + 1, fs.MULTIPLICATIVE_GROUP_GENERATOR  # the blinded inner degree
    n = 1 << lg
    wires = rand((135, n))
    table = ntt._lde_coset_scale_table(gen, lg, 3, str(dev))
    n_lde = 8 * n

    def salted_tree(width):
        cols = rand((width, n_lde))
        part = cols[:, :1 << 14].contiguous()
        levels = lg + 3
        return (ops.K4, f"zk_salted_tree_{width}x2_{levels}",
                lambda: kp.merkle_tree(part, 4, True),
                lambda: kp.merkle_tree_plain(part, 4, True),
                8 * (cols.numel() + kp.tree_words(n_lde, levels - 4)),
                OPS_PER_PERMUTATION * (-(-width // 8) * n_lde + (n_lde - (n_lde >> (levels - 4)))),
                lambda: kp.merkle_tree(cols, 4, True))

    shapes = [
        (ops.K3, f"zk_lde_135x2_{lg}_x8", lambda: kn.ntt_four_step(wires[:2], scale=table,
                                                                  fan=8),
         lambda: kn.ntt_four_step_plain(wires[:2], False, table, 8),
         8 * (wires.numel() + table.numel() + 8 * wires.numel()),
         OPS_PER_MODMUL * 135 * 8 * ((n // 2) * lg + n),
         lambda: kn.ntt_four_step(wires, scale=table, fan=8)),
        salted_tree(135 + 4), salted_tree(20 + 4), salted_tree(16 + 4),
    ]
    if len(grind_inputs) == 1:
        state, pending, bits = grind_inputs[0]
        witness = g.u64(int(kp.grind_device(state, pending, bits)[0]))
        shapes.append((ops.K5_DEVICE, "zk_grind_device",
                       lambda: kp.grind_device(state, pending, bits),
                       lambda: kp.grind_device_plain(state, pending, bits, chunk=GRIND_CHUNK),
                       8 * (12 + int(pending.shape[0]) + 1), OPS_PER_PERMUTATION * (witness + 1),
                       None))
        print(f"K5 device grind on the zk inner transcript ({bits} bits): witness {witness}")
    else:
        failures.append(f"the zk inner prove's first call ran {len(grind_inputs)} device "
                        "grinds, not 1")
    out["shapes"] = shape_checks(torch, failures, shapes)
    del wires, shapes
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"zk phase ({card}): {out['phase_s']:.1f} s")
    return out


def lookups_phase(torch, dev, card, failures) -> dict:
    """The bench_recursion chains at inner 2^LOOKUP_LOG over the two lookup
    inner circuits (`chain_layers` with lookup type 1, then 2: each layer
    built once, timed and split; the inner proved as a first call and
    LOOKUP_PROVES timed proves, split with "compute lookup polys", its
    peak memory; the middle and outer proved once and
    synchronised once, but the one-lookup chain's outer layer only built
    and its verifier bytes checked, for the script's time limit; every
    verifier data and proof the reference's, LOOKUP_VERIFIER_SHA256S and
    LOOKUP_PROOF_SHA256S, each proof verified by the port); then on the
    515-lookup inner: one prove on the host path to the fused proof's
    bytes; the device lookup columns and LUT evaluations of
    one fused prove against the host recurrence (`compute_lookup_polys`,
    `eval_lut_poly`) on its own draws; the host synchronisations of a
    fused prove(_defer=True) (0 before its fetch, nothing raised under
    "error"); prove_many at K = 4, threads 1, over four lookup inputs,
    equal to sequential proves; then the new kernel shapes: K3's LDE x8 of
    the Zs-partial-products-lookup batch [34, 2^14] -> [34, 2^17] and K4's
    tree of width 34 over 2^17 leaves against their plain versions (each
    compared on a slice, timed whole)."""
    import numpy as np

    from plonky2_torch import ops
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.ops import ntt as kn
    from plonky2_torch.ops import poseidon as kp
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.config import CircuitConfig
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.plonk.vanishing_poly import NUM_COINS_LOOKUP, eval_lut_poly
    from plonky2_torch.util import rng as prover_rng

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    t_phase = time.perf_counter()
    out = {}
    for lookup_type in (1, 2):
        layers = chain_layers(torch, dev, card, failures, f"lookup{lookup_type}", LOOKUP_LOG,
                              CircuitConfig.standard_recursion_config(),
                              LOOKUP_VERIFIER_SHA256S[lookup_type],
                              LOOKUP_PROOF_SHA256S[lookup_type], (LOOKUP_PROVES, 0, 0), [],
                              lookup_type=lookup_type, prove_outer=lookup_type == 2)
        out[f"lookup{lookup_type}"] = layer_summary(layers)
        if "compute lookup polys" not in layers[0]["split"]:
            failures.append(f"the lookup{lookup_type} inner prove has no 'compute lookup "
                            "polys' phase")
    inner = layers[0]  # the 515-lookup chain's
    data, pw, common = inner["data"], inner["inputs"], inner["data"].common
    want = proof_to_bytes(inner["proof"])

    with fri_prover.force_host_path():
        t0 = time.perf_counter()
        host = proof_to_bytes(inner["prove"]())
        host_s = time.perf_counter() - t0
    host_path = tp._LAST_TRANSCRIPT
    print(f"lookup2 inner prove on the host path ({card}): {host_s:.4f} s, transcript "
          f"{host_path}, the fused path's bytes: {host == want}")
    if host != want or host_path != "host":
        failures.append("the lookup2 inner prove on the host path is not the fused path's proof")

    # one fused prove with its device lookup columns and LUT evaluations
    # recorded, against the host recurrence on the same draws
    recorded = {}
    device_cols, device_evals = tp.lookup_polys_device, tp.lut_evals_device

    def cols_spy(witness, draws, prover_data, common_):
        got = device_cols(witness, draws, prover_data, common_)
        recorded["draws"], recorded["cols"] = draws.clone(), got.clone()
        return got

    def evals_spy(common_, draws, device):
        recorded["evals"] = device_evals(common_, draws, device).clone()
        return recorded["evals"]

    tp.lookup_polys_device, tp.lut_evals_device = cols_spy, evals_spy
    try:
        spied = proof_to_bytes(inner["prove"]())
    finally:
        tp.lookup_polys_device, tp.lut_evals_device = device_cols, device_evals
    prepared = seeded(lambda: tp.prepare_witness(data.prover_only, data.common, pw))
    draws = [int(v) for v in g.to_numpy(recorded["draws"])]
    nc = common.config.num_challenges
    t0 = time.perf_counter()
    host_cols = np.asarray([col for c in range(nc) for col in tp.compute_lookup_polys(
        prepared[0], draws[NUM_COINS_LOOKUP * c:NUM_COINS_LOOKUP * (c + 1)], data.prover_only,
        common)], dtype=np.uint64)
    host_evals = np.asarray([[eval_lut_poly(common, k, draws[NUM_COINS_LOOKUP * c:
                                                               NUM_COINS_LOOKUP * (c + 1)])
                              for k in range(len(common.luts))] for c in range(nc)],
                            dtype=np.uint64)
    recurrence_s = time.perf_counter() - t0
    cols_equal = bool((g.to_numpy(recorded["cols"]) == host_cols).all())
    evals_equal = bool((g.to_numpy(recorded["evals"]) == host_evals).all())
    print(f"lookup2 inner: the device lookup columns {tuple(host_cols.shape)} equal the host "
          f"recurrence on the prove's draws: {cols_equal}; the device LUT evaluations "
          f"{host_evals.tolist()} equal eval_lut_poly's: {evals_equal} (the host recurrence "
          f"{recurrence_s:.3f} s); the recorded prove is the proof: {spied == want}")
    if not (cols_equal and evals_equal and spied == want):
        failures.append("the lookup2 inner's device lookup columns or LUT evaluations differ "
                        "from the host recurrence")

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            finish = tp.prove(data.prover_only, common, None, device=dev, _defer=True,
                              _prepared=prepared)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    same_deferred = proof_to_bytes(finish()) == want
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = tp.prove(data.prover_only, common, None, device=dev, _defer=True,
                          _prepared=prepared)
        raised = None
    except RuntimeError as e:
        finish, raised = None, str(e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if finish is not None:
        same_deferred &= proof_to_bytes(finish()) == want
    print(f"lookup2 inner fused prove(_defer=True) from its prepared witness ({card}): "
          f"{len(syncs)} host synchronisations before its fetch "
          f"{[f'{os.path.basename(w.filename)}:{w.lineno}' for w in syncs][:6]}; under "
          f"set_sync_debug_mode('error'): {'raised ' + raised if raised else 'raised nothing'}; "
          f"proofs the inner proof: {same_deferred}")
    if syncs or raised:
        failures.append(f"the lookup2 inner fused prove synchronised {len(syncs)} times before "
                        f"its fetch ({raised or 'nothing raised under error'})")
    if not same_deferred:
        failures.append("the lookup2 inner deferred proves are not the inner proof")

    (initial_a,) = pw.target_values
    inputs = []
    for v in LOOKUP_BATCH_INPUTS:
        pw_v = PartialWitness()
        pw_v.set_target(initial_a, v)
        inputs.append(pw_v)
    t0 = time.perf_counter()
    sequential = seeded(lambda: [proof_to_bytes(data.prove(p, device=dev)) for p in inputs])
    sequential_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batched = seeded(lambda: tp.prove_many(data.prover_only, common, inputs, device=dev,
                                           window=BATCH_WINDOW, threads=1))
    batch_s = time.perf_counter() - t0
    batch_equal = [proof_to_bytes(p) for p in batched] == sequential
    k = len(inputs)
    print(f"lookup2 inner prove_many K={k} (inputs {LOOKUP_BATCH_INPUTS}), window "
          f"{BATCH_WINDOW}, threads 1 ({card}): {k / batch_s:.3f} proofs/s ({batch_s:.2f} s), "
          f"at most {tp._LAST_MAX_IN_FLIGHT} in flight, proofs equal to the sequential: "
          f"{batch_equal}; sequential {k / sequential_s:.3f} proofs/s ({sequential_s:.2f} s); "
          f"{len(set(sequential))} distinct proofs")
    if not batch_equal or len(set(sequential)) != k:
        failures.append("the lookup2 prove_many differs from sequential proves")
    out.update(host_path_s=host_s, columns_equal=cols_equal, lut_evals_equal=evals_equal,
               syncs_before_fetch=len(syncs),
               prove_many=dict(K=k, proofs_per_s=k / batch_s, seconds=batch_s,
                               equal=batch_equal, max_in_flight=tp._LAST_MAX_IN_FLIGHT,
                               sequential_proofs_per_s=k / sequential_s))
    width = common.num_zs_partial_products_polys() + common.num_all_lookup_polys()
    if width != 34:
        failures.append(f"the lookup inner's Zs-partial-products oracle is {width} wide, not 34")
    del layers, inner, data, prepared, batched
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 50)

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    lg, gen = LOOKUP_LOG, fs.MULTIPLICATIVE_GROUP_GENERATOR
    n, n_lde, levels = 1 << lg, 8 << lg, lg + 3
    zs = rand((width, n))
    table = ntt._lde_coset_scale_table(gen, lg, 3, str(dev))
    lde = kn.ntt_four_step(zs, scale=table, fan=8)
    part = lde[:, :1 << 14].contiguous()
    shapes = [
        (ops.K3, f"lookup_zs_lde_{width}x2_{lg}_x8",
         lambda: kn.ntt_four_step(zs[:2], scale=table, fan=8),
         lambda: kn.ntt_four_step_plain(zs[:2], False, table, 8),
         8 * (zs.numel() + table.numel() + 8 * zs.numel()),
         OPS_PER_MODMUL * width * 8 * ((n // 2) * lg + n),
         lambda: kn.ntt_four_step(zs, scale=table, fan=8)),
        (ops.K4, f"lookup_zs_tree_{width}x2_{levels}", lambda: kp.merkle_tree(part, 4, True),
         lambda: kp.merkle_tree_plain(part, 4, True),
         8 * (lde.numel() + kp.tree_words(n_lde, levels - 4)),
         OPS_PER_PERMUTATION * (-(-width // 8) * n_lde + (n_lde - (n_lde >> (levels - 4)))),
         lambda: kp.merkle_tree(lde, 4, True)),
    ]
    out["shapes"] = shape_checks(torch, failures, shapes)
    del zs, lde, part, shapes
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"lookups phase ({card}): {out['phase_s']:.1f} s")
    return out


def count_syncs_before_fetch(torch, run):
    """(host synchronisations before the fused FRI proof's one fetch, the
    result) of one `run()` under set_sync_debug_mode("warn"): the fetch is
    `fri.prover._fri_fused_finish`, where the count is read."""
    from plonky2_torch.fri import prover as fri_prover

    finish = fri_prover._fri_fused_finish
    at_fetch = []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def marked(*a, **k):
            at_fetch.append([w for w in caught
                             if "called a synchronizing CUDA operation" in str(w.message)])
            return finish(*a, **k)

        fri_prover._fri_fused_finish = marked
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            fri_prover._fri_fused_finish = finish
    if len(at_fetch) != 1:
        return None, result
    return at_fetch[0], result


def batch_fri_phase(torch, dev, card, failures) -> dict:
    """Batch FRI at full width (`examples/batch_fri.py`): three degree groups
    of 2^20, 2^16 and 2^12 coefficients (16, 8 and 4 polynomials from
    numpy seed 2026) committed in one BatchFriOracle under
    StarkConfig.standard_fast_config()'s FRI config (arities 4, 4, 4, 4;
    its K3 LDEs and K4 batch tree timed with the counts set to 0 just
    before and read just after), opened in one batch-FRI proof (the
    reference test's transcript, points (5, 7), (11, 13), (17, 19)): a
    first call and BATCH_FRI_PROVES timed proves on the fused path (counts
    as above, the peak of allocated device memory, each the reference's
    sha256), the host synchronisations before the fused proof's fetch, one
    prove on the host path (its bytes and challenger state the fused
    one's), the host verifier (a tampered opening refused),
    then its verifier circuit under standard_recursion_config() built (a
    first call, split by scope; the reference's verifier bytes) and proved
    (a first call and BATCH_FRI_PROVES timed, each the reference's sha256,
    one synchronised for the split) and verified; then each new kernel
    shape of the path against its plain version."""
    import numpy as np

    from plonky2_torch import ops
    from plonky2_torch.examples import batch_fri as bf
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.fri.batch_fri import batch_fri_proof
    from plonky2_torch.fri.oracle import _batch_quotient
    from plonky2_torch.iop.challenger import Challenger
    from plonky2_torch.ops import ntt as kn
    from plonky2_torch.ops import poseidon as kp
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.config import CircuitConfig
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.util import TimingTree
    from plonky2_torch.util import rng as prover_rng

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    t_phase = time.perf_counter()
    out = {}
    params = StarkConfig.standard_fast_config().fri_config.fri_params(bf.BITS[0], False)
    if tuple(params.reduction_arity_bits) != (4, 4, 4, 4):
        failures.append(f"the batch FRI arities are {params.reduction_arity_bits}")
    t0 = time.perf_counter()
    groups = bf.random_groups(seed=SEED)
    groups_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    oracle = bf.commit(groups, params, dev)
    torch.cuda.synchronize()
    commit_first_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    oracle = bf.commit(groups, params, dev)
    cap = oracle.batch_merkle_tree.cap  # the one fetch: the cap
    commit_s = time.perf_counter() - t0
    commit_launches = ops.launch_counts()

    def pinned(proof, what):
        digest = sha(bf.proof_bytes(proof))
        if digest != BATCH_FRI_PROOF_SHA256:
            failures.append(f"{what}: the batch FRI proof's sha256 is {digest}, not "
                            f"{BATCH_FRI_PROOF_SHA256}")
        return digest

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = bf.prove(groups, params, oracle=oracle)
    first_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pinned(run.proof, "first call")
    walls = []
    for _ in range(BATCH_FRI_PROVES):
        ops.reset_launches()
        t0 = time.perf_counter()
        run = bf.prove(groups, params, oracle=oracle)
        walls.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        duplexes = ops.K5.batch1
        digest = pinned(run.proof, "timed prove")
        if fri_prover._LAST_PATH != "batch_fused":
            failures.append(f"the batch FRI prove took the {fri_prover._LAST_PATH} path")
    wall = statistics.median(walls)
    state = (run.challenger.sponge_state, run.challenger.input_buffer,
             run.challenger.output_buffer)

    # the FRI argument alone, its inputs made first: the syncs before its fetch
    challenger = Challenger()
    challenger.observe_cap(cap)
    alpha = challenger.get_extension_challenge(2)
    comps = [_batch_quotient(c, alpha, bf.POINTS[i], params.config.rate_bits)
             for i, c in enumerate(oracle.polynomial_groups)]
    syncs, proof = count_syncs_before_fetch(
        torch, lambda: batch_fri_proof([oracle.batch_merkle_tree], comps, challenger, params))
    pinned(proof, "sync-counted prove")
    if syncs is None or syncs:
        failures.append(f"the fused batch FRI proof synchronised before its fetch: {syncs}")
    n_syncs = None if syncs is None else len(syncs)
    t0 = time.perf_counter()
    with fri_prover.force_host_path():
        host_run = bf.prove(groups, params, oracle=oracle)
        host_path = fri_prover._LAST_PATH
    host_s = time.perf_counter() - t0
    host_state = (host_run.challenger.sponge_state, host_run.challenger.input_buffer,
                  host_run.challenger.output_buffer)
    same_host = (bf.proof_bytes(host_run.proof) == bf.proof_bytes(run.proof)
                 and host_state == state and host_path == "batch_host")
    if not same_host:
        failures.append("the batch FRI host path differs from the fused path")

    t0 = time.perf_counter()
    values = bf.openings(run)
    openings_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        bf.verify(run, params, values)
        accepted = True
    except ValueError as e:
        accepted = False
        failures.append(f"the port's batch FRI verifier rejects the proof: {e}")
    verify_s = time.perf_counter() - t0
    bad = [list(v) for v in values]
    bad[2][3] = (fs.add(bad[2][3][0], 1), bad[2][3][1])
    try:
        bf.verify(run, params, bad)
        refused = False
        failures.append("the port's batch FRI verifier accepts a tampered opening")
    except ValueError:
        refused = True
    print(f"batch FRI ({card}): groups 2^{bf.BITS} x {bf.COUNTS} polynomials (drawn on the "
          f"host in {groups_s:.2f} s), arities {params.reduction_arity_bits}, "
          f"{params.config.num_query_rounds} queries; BatchFriOracle {commit_s:.4f} s (first "
          f"call {commit_first_s:.3f} s), launches {commit_launches}; fused prove "
          f"{wall:.4f} s median of {[round(w, 4) for w in walls]} (first call {first_s:.3f} s; "
          f"peak allocated {peak_gib:.2f} GiB), {len(bf.proof_bytes(run.proof))} proof "
          f"bytes, sha256 {digest} (the reference's: {BATCH_FRI_PROOF_SHA256}); launches "
          f"{launches} (K5 permutes on one state: {duplexes}); host synchronisations before "
          f"its fetch: {n_syncs}; host path {host_s:.3f} s, its proof and challenger state "
          f"the fused one's: {same_host}; openings {openings_s:.3f} s; the port's verifier "
          f"{verify_s:.3f} s, accepted: {accepted}, a tampered opening refused: {refused}")
    for label, count in launches.items():
        if count == 0 and label != ops.K5_CHUNK.label:
            failures.append(f"{label} was not launched on the batch FRI prove")

    config = CircuitConfig.standard_recursion_config()
    ops.reset_launches()
    timing = TimingTree("build", sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    data, targets = bf.circuit(run, params, config, values, device=dev, timing=timing)
    build_s, build_split, build_launches = (time.perf_counter() - t0, timing.split(),
                                            ops.launch_counts())
    vd = sha(verifier_data_to_bytes(data.verifier_only, data.common))
    if vd != BATCH_FRI_VERIFIER_SHA256:
        failures.append(f"the batch FRI verifier circuit's verifier data sha256 is {vd}, not "
                        f"{BATCH_FRI_VERIFIER_SHA256}")
    pw = bf.circuit_inputs(targets, run)

    def circuit_prove(timing=None):
        return seeded(lambda: data.prove(pw, device=dev, timing=timing))

    def circuit_pinned(proof, what):
        digest = sha(proof_to_bytes(proof))
        if digest != BATCH_FRI_CIRCUIT_PROOF_SHA256:
            failures.append(f"{what}: the batch FRI circuit's proof sha256 is {digest}, not "
                            f"{BATCH_FRI_CIRCUIT_PROOF_SHA256}")
        return digest

    t0 = time.perf_counter()
    circuit_proof = circuit_prove()
    circuit_first_s = time.perf_counter() - t0
    circuit_pinned(circuit_proof, "first call")
    circuit_walls = []
    for _ in range(BATCH_FRI_PROVES):
        ops.reset_launches()
        t0 = time.perf_counter()
        proof = circuit_prove()
        circuit_walls.append(time.perf_counter() - t0)
        circuit_launches = ops.launch_counts()
        circuit_digest = circuit_pinned(proof, "timed prove")
    timing = TimingTree("prove", sync=torch.cuda.synchronize)
    circuit_pinned(circuit_prove(timing), "synchronised prove")
    circuit_split = timing.split()
    t0 = time.perf_counter()
    try:
        data.verify(circuit_proof)
        circuit_ok = True
    except ValueError as e:
        circuit_ok = False
        failures.append(f"the port's verifier rejects the batch FRI circuit's proof: {e}")
    circuit_verify_s = time.perf_counter() - t0
    circuit_wall = statistics.median(circuit_walls)
    print(f"batch FRI verifier circuit ({card}): degree 2^{data.common.degree_bits}; build "
          f"{build_s:.4f} s (a first call), verifier data sha256 {vd}; split: "
          + ", ".join(f"{k} {v:.4f}" for k, v in build_split.items())
          + f"; build launches {build_launches}; prove (witness + fused prove) "
          f"{circuit_wall:.4f} s median of {[round(w, 4) for w in circuit_walls]} (first call "
          f"{circuit_first_s:.3f} s), sha256 {circuit_digest} (the reference's: "
          f"{BATCH_FRI_CIRCUIT_PROOF_SHA256}); launches {circuit_launches}; phases, "
          f"synchronised: " + ", ".join(f"{k} {v:.4f}" for k, v in circuit_split.items())
          + f"; the port's verifier {circuit_verify_s:.3f} s, accepted: {circuit_ok}")
    out.update(commit_s=commit_s, commit_first_s=commit_first_s,
               commit_launches=commit_launches, wall_s=wall, walls=walls, first_s=first_s,
               peak_gib=peak_gib, launches=launches, duplexes=duplexes, sha256=digest,
               syncs_before_fetch=n_syncs, host_path_s=host_s, host_equal=same_host,
               verify_s=verify_s, tampered_refused=refused,
               circuit=dict(degree_bits=data.common.degree_bits, build_s=build_s,
                            build_split=build_split,
                            build_launches=build_launches, prove_s=circuit_wall,
                            prove_walls=circuit_walls, first_s=circuit_first_s,
                            split=circuit_split, launches=circuit_launches,
                            verify_s=circuit_verify_s, sha256=circuit_digest,
                            verifier_sha256=vd))

    # each new kernel shape of the path against its plain version: the
    # groups' LDE x2 ([16, 2^20] and [8, 2^16] in K3, [4, 2^12] in K2), the
    # folds' coset FFT and iFFT at [2, 2^17] (K3), the batch tree's three
    # segments and the first fold's tree (K4), and K5's device grind at the
    # batch transcript's state (16 bits)
    grind_state = {}
    grind_device = kp.grind_device

    def recording_grind(state, pending, pow_bits):
        grind_state["args"] = (state.clone(), pending.clone(), pow_bits)
        return grind_device(state, pending, pow_bits)

    kp.grind_device = recording_grind
    try:
        bf.prove(groups, params, oracle=oracle)
    finally:
        kp.grind_device = grind_device
    del run, host_run, data, circuit_proof, proof
    gen = fs.MULTIPLICATIVE_GROUP_GENERATOR
    coeffs = oracle.polynomial_groups
    tables = [ntt._lde_coset_scale_table(gen, b, 1, str(dev)) for b in bf.BITS]
    rng = np.random.default_rng(SEED + 60)

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    n17 = 1 << 17
    fold = rand((2, n17))
    shift = fs.exp(gen, 16)
    fwd = ntt.shift_powers(shift, n17, dev).reshape(1, n17)
    seg0 = rand((1 << 21, 16))
    seg1 = rand((1 << 17, 12))
    seg2 = rand((1 << 13, 8))
    fold_leaves = rand((n17, 32))

    def lde_shape(kernel, k):
        c, t, lg = coeffs[k], tables[k], bf.BITS[k]
        m = 1 << lg
        rows = c.shape[0]
        part = c[:2]
        if kernel is ops.K3:
            run_k, run_p = (lambda: kn.ntt_four_step(part, scale=t, fan=2),
                            lambda: kn.ntt_four_step_plain(part, False, t, 2))
            timed = lambda: kn.ntt_four_step(c, scale=t, fan=2)  # noqa: E731
        else:
            run_k, run_p = (lambda: kn.ntt_rows(c, scale=t, fan=2),
                            lambda: kn.ntt_rows_plain(c, False, t, 2))
            timed = None
        return (kernel, f"batch_lde_{rows}x2_{lg}_x2", run_k, run_p,
                8 * (c.numel() + t.numel() + 2 * c.numel()),
                OPS_PER_MODMUL * rows * 2 * ((m // 2) * lg + m), timed)

    def tree_shape(key, leaves, stop):
        """A row-leaf tree stopped at height `stop`, compared on its first
        2^14 leaves compressed as many levels (or down to one digest)."""
        n, width = leaves.shape
        levels = (n.bit_length() - 1) - stop
        part = leaves[:min(n, 1 << 14)].contiguous()
        part_cap = max((part.shape[0].bit_length() - 1) - levels, 0)
        return (ops.K4, key, lambda: kp.merkle_tree(part, part_cap, False),
                lambda: kp.merkle_tree_plain(part, part_cap, False),
                8 * (leaves.numel() + kp.tree_words(n, levels)),
                OPS_PER_PERMUTATION * (-(-width // 8) * n + (n - (n >> levels))),
                lambda: kp.merkle_tree(leaves, stop, False))

    shapes = [
        lde_shape(ops.K3, 0), lde_shape(ops.K3, 1), lde_shape(ops.K2, 2),
        (ops.K3, "batch_fold_coset_fft_2x2_17", lambda: kn.ntt_four_step(fold, scale=fwd),
         lambda: kn.ntt_four_step_plain(fold, scale=fwd),
         8 * (2 * fold.numel() + n17), OPS_PER_MODMUL * 2 * ((n17 // 2) * 17 + 2 * n17), None),
        (ops.K3, "batch_fold_ifft_2x2_17", lambda: kn.ntt_four_step(fold, inverse=True),
         lambda: kn.ntt_four_step_plain(fold, inverse=True),
         8 * 2 * fold.numel(), OPS_PER_MODMUL * 2 * ((n17 // 2) * 17 + n17), None),
        # segments: leaves of width 16, then 4 + 8 and 4 + 4 (the running
        # digests beside the next group's rows)
        tree_shape("batch_tree_segment_16x2_21", seg0, 17),
        tree_shape("batch_tree_segment_12x2_17", seg1, 13),
        tree_shape("batch_tree_segment_8x2_13", seg2, 4),
        tree_shape("batch_fold_tree_32x2_17", fold_leaves, 4),
    ]
    if "args" in grind_state:
        state, pending, bits = grind_state["args"]
        witness = g.u64(int(kp.grind_device(state, pending, bits)[0]))
        shapes.append((ops.K5_DEVICE, "batch_grind_device",
                       lambda: kp.grind_device(state, pending, bits),
                       lambda: kp.grind_device_plain(state, pending, bits, chunk=GRIND_CHUNK),
                       8 * (12 + int(pending.shape[0]) + 1), OPS_PER_PERMUTATION * (witness + 1),
                       None))
        print(f"K5 device grind on the batch FRI transcript ({bits} bits, "
              f"{int(pending.shape[0])} pending): witness {witness}")
    else:
        failures.append("the batch FRI prove ran no device grind")
    out["shapes"] = shape_checks(torch, failures, shapes)
    del oracle, coeffs, tables, fold, seg0, seg1, seg2, fold_leaves, shapes
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"batch FRI phase ({card}): {out['phase_s']:.1f} s")
    return out


def stark_recursion_phase(torch, dev, card, failures, proofs=None) -> dict:
    """STARK -> SNARK recursion (`examples/stark_recursion.py`): the
    2^STARKY_LOG_ROWS-row FibonacciStark and LookupTestStark proofs of
    `starky_phase` (`proofs`; proved here when not given) each verified in a
    circuit under standard_recursion_config(): built (a first call, split
    by scope, the counts set to 0 just before and read just after; the
    reference's verifier bytes), proved (a first call with the peak of
    allocated device memory, STARK_WRAP_PROVES timed proves, counts as
    above, each the reference's sha256; Fibonacci's one synchronised for
    the split and one with its host synchronisations before the fetch
    counted) and verified, its public inputs the
    STARK's; then the variable-degree
    circuit (max 2^STARK_VAR[0], min 2^STARK_VAR[1], 84 queries) built
    once and timed, the FibonacciStark proofs of 2^STARK_VAR[2] and
    2^STARK_VAR[3] rows made on the card under verifier_circuit_fri_params
    = fri_params(STARK_VAR[0]) (each the reference's sha256 and accepted by
    the port's verifier under those params), and each wrapped (a first
    call, and for the larger one a timed prove and the port's verifier;
    each the reference's sha256), its public inputs the STARK's."""
    from plonky2_torch import ops
    from plonky2_torch.examples import stark_recursion as sr
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.config import CircuitConfig
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.starky import prover as sp
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_torch.starky.serialization import stark_proof_to_bytes
    from plonky2_torch.starky.test_starks import LookupTestStark
    from plonky2_torch.starky.verifier import verify_stark_proof
    from plonky2_torch.util import TimingTree
    from plonky2_torch.util import rng as prover_rng

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    def fib_case(n):
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        return stark, stark.generate_trace(pis[0], pis[1]), pis

    t_phase = time.perf_counter()
    stark_config = StarkConfig.standard_fast_config()
    config = CircuitConfig.standard_recursion_config()
    n = 1 << STARKY_LOG_ROWS
    out = {}
    for name in ("fibonacci", "lookup"):
        stark = FibonacciStark(n) if name == "fibonacci" else LookupTestStark(n)
        stark_proof = (proofs or {}).get(name)
        if stark_proof is None:
            s, trace, pis = (fib_case(n) if name == "fibonacci"
                             else (stark, stark.generate_trace(), []))
            stark_proof = sp.prove(stark, stark_config, trace, pis, device=dev)
        want_vd, want_proof = STARK_WRAP_VERIFIER_SHA256S[name], STARK_WRAP_PROOF_SHA256S[name]
        ops.reset_launches()
        timing = TimingTree("build", sync=torch.cuda.synchronize)
        t0 = time.perf_counter()
        data, pt = sr.wrap_circuit(stark, stark_config, STARKY_LOG_ROWS, config, device=dev,
                                   timing=timing)
        build_s, build_split, build_launches = (time.perf_counter() - t0, timing.split(),
                                                ops.launch_counts())
        vd = sha(verifier_data_to_bytes(data.verifier_only, data.common))
        if vd != want_vd:
            failures.append(f"the {name} 2^{STARKY_LOG_ROWS} wrap's verifier data sha256 is "
                            f"{vd}, not {want_vd}")
        pw = sr.wrap_inputs(pt, stark_proof)

        def prove(timing=None, data=data, pw=pw):
            return seeded(lambda: data.prove(pw, device=dev, timing=timing))

        def pinned(proof, what, name=name, want=want_proof, pis=stark_proof.public_inputs):
            digest = sha(proof_to_bytes(proof))
            if digest != want:
                failures.append(f"{what}: the {name} wrap proof's sha256 is {digest}, not {want}")
            if proof.public_inputs != list(pis):
                failures.append(f"{what}: the {name} wrap proof does not expose the STARK's "
                                "public inputs")
            return digest

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        proof = prove()
        first_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        pinned(proof, "first call")
        walls = []
        for _ in range(STARK_WRAP_PROVES):
            ops.reset_launches()
            t0 = time.perf_counter()
            proof = prove()
            walls.append(time.perf_counter() - t0)
            launches = ops.launch_counts()
            digest = pinned(proof, "timed prove")
        split, syncs = {}, None
        if name == "fibonacci":  # the split and the syncs: one wrap's
            timing = TimingTree("prove", sync=torch.cuda.synchronize)
            pinned(prove(timing), "synchronised prove")
            split = timing.split()
            caught, synced_proof = count_syncs_before_fetch(torch, prove)
            pinned(synced_proof, "sync-counted prove")
            syncs = None if caught is None else len(caught)
        t0 = time.perf_counter()
        try:
            data.verify(proof)
            ok = True
        except ValueError as e:
            ok = False
            failures.append(f"the port's verifier rejects the {name} wrap proof: {e}")
        verify_s = time.perf_counter() - t0
        wall = statistics.median(walls)
        print(f"stark wrap {name} 2^{STARKY_LOG_ROWS} ({card}): degree "
              f"2^{data.common.degree_bits}; build {build_s:.4f} s (a first call), "
              f"verifier data sha256 {vd}; split: "
              + ", ".join(f"{k} {v:.4f}" for k, v in build_split.items())
              + f"; build launches {build_launches}; prove (witness + fused prove) {wall:.4f} s "
              f"median of {[round(w, 4) for w in walls]} (first call {first_s:.3f} s, peak "
              f"allocated {peak_gib:.2f} GiB), sha256 {digest} (the reference's: {want_proof}); "
              f"launches {launches}; phases, synchronised: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; host synchronisations before the fetch (witness phase included): "
              f"{'not counted' if syncs is None else syncs}; public inputs "
              f"{proof.public_inputs}; the port's verifier {verify_s:.3f} s, accepted: {ok}")
        for label, count in launches.items():
            if count == 0 and label != ops.K5_CHUNK.label:
                failures.append(f"{label} was not launched on the {name} wrap prove")
        out[name] = dict(degree_bits=data.common.degree_bits, build_s=build_s,
                         build_split=build_split,
                         build_launches=build_launches, wall_s=wall, walls=walls,
                         first_s=first_s, peak_gib=peak_gib, launches=launches, split=split,
                         syncs_before_fetch=syncs, verify_s=verify_s, sha256=digest,
                         verifier_sha256=vd)
        del data, pt, pw, proof, stark_proof
        torch.cuda.empty_cache()

    max_bits, min_bits, *logs = STARK_VAR
    vc = stark_config.fri_params(max_bits)
    ops.reset_launches()
    timing = TimingTree("build", sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    data, pt = sr.wrap_circuit(FibonacciStark(1 << max_bits), stark_config, max_bits, config,
                               min_degree_bits=min_bits, device=dev, timing=timing)
    var_build_s = time.perf_counter() - t0
    var_build_launches = ops.launch_counts()
    var_build_split = timing.split()
    vd = sha(verifier_data_to_bytes(data.verifier_only, data.common))
    if vd != STARK_VAR_VERIFIER_SHA256:
        failures.append(f"the variable-degree wrap's verifier data sha256 is {vd}, not "
                        f"{STARK_VAR_VERIFIER_SHA256}")
    print(f"stark wrap variable degree (max 2^{max_bits}, min 2^{min_bits}; {card}): degree "
          f"2^{data.common.degree_bits}; build {var_build_s:.3f} s (a first call), verifier data "
          f"sha256 {vd}; split: " + ", ".join(f"{k} {v:.4f}" for k, v in var_build_split.items())
          + f"; launches {var_build_launches}")
    var = dict(degree_bits=data.common.degree_bits, build_s=var_build_s,
               build_split=var_build_split, build_launches=var_build_launches,
               verifier_sha256=vd, proofs={})
    for lg, want_stark, want_wrap in zip(logs, STARK_VAR_PROOF_SHA256S,
                                         STARK_VAR_WRAP_SHA256S):
        stark, trace, pis = fib_case(1 << lg)
        t0 = time.perf_counter()
        stark_proof = sp.prove(stark, stark_config, trace, pis, device=dev,
                               verifier_circuit_fri_params=vc)
        stark_s = time.perf_counter() - t0
        stark_digest = sha(stark_proof_to_bytes(stark_proof, stark_config))
        if stark_digest != want_stark:
            failures.append(f"the fibonacci 2^{lg} proof under fri_params({max_bits}) has sha256 "
                            f"{stark_digest}, not {want_stark}")
        try:
            verify_stark_proof(stark, stark_proof, stark_config, verifier_circuit_fri_params=vc)
            stark_ok = True
        except ValueError as e:
            stark_ok = False
            failures.append(f"the port's STARK verifier rejects the 2^{lg} proof: {e}")
        pw = sr.wrap_inputs(pt, stark_proof, lg)
        walls = []
        last = lg == logs[-1]
        torch.cuda.reset_peak_memory_stats()
        for i in range(2 if last else 1):  # a first call, then the last degree's one timed
            ops.reset_launches()
            t0 = time.perf_counter()
            proof = seeded(lambda: data.prove(pw, device=dev))
            walls.append(time.perf_counter() - t0)
            launches = ops.launch_counts()
            digest = sha(proof_to_bytes(proof))
            if digest != want_wrap:
                failures.append(f"the variable-degree wrap of 2^{lg} has sha256 {digest}, not "
                                f"{want_wrap}")
            if proof.public_inputs != pis:
                failures.append(f"the variable-degree wrap of 2^{lg} does not expose the "
                                "STARK's public inputs")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ok = None
        if last:  # the other wrap's bytes are the reference's, which plonky2_verify accepts
            try:
                data.verify(proof)
                ok = True
            except ValueError as e:
                ok = False
                failures.append(f"the port's verifier rejects the variable-degree wrap of "
                                f"2^{lg}: {e}")
        print(f"stark wrap variable degree, fibonacci 2^{lg} ({card}): the STARK prove under "
              f"fri_params({max_bits}) {stark_s:.3f} s, sha256 {stark_digest} (the reference's: "
              f"{want_stark}), the port's STARK verifier accepts it: {stark_ok}; wrap prove "
              f"{walls[-1]:.4f} s (first call {walls[0]:.3f} s; peak allocated "
              f"{peak_gib:.2f} GiB), sha256 {digest} (the reference's: {want_wrap}); launches "
              f"{launches}; public inputs "
              f"{proof.public_inputs}; the port's verifier accepts it: "
              f"{'not run' if ok is None else ok}")
        var["proofs"][lg] = dict(stark_s=stark_s, stark_sha256=stark_digest, wall_s=walls[-1],
                                 first_s=walls[0], peak_gib=peak_gib, launches=launches,
                                 sha256=digest)
    for label, count in var["proofs"][logs[-1]]["launches"].items():
        if count == 0 and label != ops.K5_CHUNK.label:
            failures.append(f"{label} was not launched on the variable-degree wrap prove")
    out["variable"] = var
    del data, pt
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"stark recursion phase ({card}): {out['phase_s']:.1f} s")
    return out


def ctl_phase(torch, dev, card, failures) -> dict:
    """Cross-table lookups (`examples/multi_table.py`): the three tables at
    2^CTL_LOG_ROWS rows proved under one transcript by prove_multi_table (a
    first call with the peak of allocated device memory, CTL_PROVES timed
    proves with the counts set to 0 just before and read just after, each
    table's proof the reference's sha256; one synchronised for the split by
    the reference's scope names, table by table; one with its host
    synchronisations counted, table by table; one profiled for the
    device's busy share), verify_multi_table on the host, the system with
    table 1's values shifted by 1 proved and rejected by verify_multi_table
    (at its CTL sums); then the circuit
    verifying the three proofs and the CTL sums built (a first call, split
    by scope; the reference's verifier bytes), proved (a first call and a
    warm prove, counts as above; the reference's sha256) and verified; then
    the new kernel shapes of the path against their plain versions."""
    import numpy as np

    from plonky2_torch import ops
    from plonky2_torch.examples import multi_table as mt
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.ops import ntt as kn
    from plonky2_torch.ops import poseidon as kp
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.config import CircuitConfig
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.starky import cross_table_lookup as ctl
    from plonky2_torch.starky import prover as sp
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.serialization import stark_proof_to_bytes
    from plonky2_torch.util import TimingTree
    from plonky2_torch.util import rng as prover_rng

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    t_phase = time.perf_counter()
    config = StarkConfig.standard_fast_config()
    starks, ctls = mt.system()
    t0 = time.perf_counter()
    traces, pis = mt.generate_traces(CTL_LOG_ROWS, seed=SEED)
    traces_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctl.check_ctls(traces, ctls)
    check_s = time.perf_counter() - t0
    dev_traces = [g.tensor(t, dev) for t in traces]
    torch.cuda.synchronize()

    def prove(timing=None, tr=None):
        return ctl.prove_multi_table(starks, config, tr or dev_traces, pis, ctls, device=dev,
                                     timing=timing)[0]

    def pinned(proofs, what, want=CTL_PROOF_SHA256S):
        digests = [sha(stark_proof_to_bytes(p, config)) for p in proofs]
        for i, (d, w) in enumerate(zip(digests, want)):
            if d != w:
                failures.append(f"{what}: the CTL table {i} proof's sha256 is {d}, not {w}")
        return digests

    grinds = []
    grind_device = kp.grind_device

    def recording_grind(state, pending, pow_bits):
        grinds.append((state.clone(), pending.clone(), pow_bits))
        return grind_device(state, pending, pow_bits)

    torch.cuda.reset_peak_memory_stats()
    kp.grind_device = recording_grind
    t0 = time.perf_counter()
    try:
        proofs = prove()
    finally:
        kp.grind_device = grind_device
    first_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pinned(proofs, "first call")
    walls = []
    for _ in range(CTL_PROVES):
        ops.reset_launches()
        t0 = time.perf_counter()
        proofs = prove()
        walls.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        duplexes = ops.K5.batch1
        digests = pinned(proofs, "timed prove")
    wall = statistics.median(walls)
    for label, count in launches.items():
        if count == 0 and label != ops.K5_CHUNK.label:  # the host path's grind
            failures.append(f"{label} was not launched on the multi-table prove")
    if fri_prover._LAST_PATH != "fused":
        failures.append(f"the last table's FRI took the {fri_prover._LAST_PATH} path")
    timing = TimingTree("prove multi table", sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    pinned(prove(timing), "synchronised prove")
    sync_wall = time.perf_counter() - t0
    split = {c.name: (c.duration if not c.children else
                      {k.name: k.duration for k in c.children}) for c in timing.children}
    # the host synchronisations of one prove, table by table
    per_table, real = [], sp.prove_with_commitment
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted(*a, **k):
            before = len(caught)
            out = real(*a, **k)
            per_table.append(sum("synchronizing CUDA operation" in str(w.message)
                                 for w in caught[before:]))
            return out

        sp.prove_with_commitment = counted
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pinned(prove(), "sync-counted prove")
        finally:
            torch.cuda.set_sync_debug_mode("default")
            sp.prove_with_commitment = real
        total_syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    # warmed up by a few small ops, not a second prove of ~450k launches
    prof = profile_line(torch, prove, wall, "multi-table prove",
                        warmup=lambda: [torch.ones(1, device=dev).add_(1) for _ in range(64)]
                        ) or {}
    t0 = time.perf_counter()
    try:
        ctl.verify_multi_table(starks, config, proofs, ctls)
        accepted = True
    except ValueError as e:
        accepted = False
        failures.append(f"the port's verify_multi_table rejects the proofs: {e}")
    verify_s = time.perf_counter() - t0
    # table 1 shifted by 1: each table's proof is valid on its own, so the
    # whole verify_multi_table runs and its last step, the CTL sums, rejects
    t0 = time.perf_counter()
    bad = prove(tr=[g.tensor(t, dev) for t in mt.shifted_memory(traces)])
    try:
        ctl.verify_multi_table(starks, config, bad, ctls)
        rejected = ""
        failures.append("the port's verify_multi_table accepts table 1 shifted by 1")
    except ValueError as e:
        rejected = str(e)
        if "Cross-table lookup 0" not in rejected:
            failures.append(f"the shifted table 1 was rejected for another reason: {e}")
    mismatch_s = time.perf_counter() - t0
    del bad
    sizes = [len(stark_proof_to_bytes(p, config)) for p in proofs]
    print(f"ctl ({card}): tables 2^{CTL_LOG_ROWS} rows x {[s.COLUMNS for s in starks]} "
          f"columns, constraint degree 3, {len(ctls)} CTLs (traces of {[t.nbytes for t in traces]} "
          f"bytes made on the host in {traces_s:.2f} s, check_ctls {check_s:.2f} s); "
          f"prove_multi_table {wall:.4f} s "
          f"median of {[round(w, 4) for w in walls]} (first call {first_s:.3f} s; peak "
          f"allocated {peak_gib:.2f} GiB), proof bytes {sizes}, sha256s {digests} (the "
          f"reference's: {list(CTL_PROOF_SHA256S)}); launches {launches} (K5 permutes on one "
          f"state: {duplexes}); device busy {prof.get('device_ms', 0):.1f} ms, "
          f"{prof.get('busy', 0):.1%} of the wall; host synchronisations {total_syncs} "
          f"(the table rounds: {per_table}); verify_multi_table {verify_s:.3f} s, accepted: "
          f"{accepted}; table 1 shifted by 1, proved and verify_multi_table run in "
          f"{mismatch_s:.3f} s: rejected with {rejected!r}")
    print(f"ctl prove phases ({card}), s, the device synchronised at each phase's start and "
          f"end ({sync_wall:.4f} s wall): " + "; ".join(
              f"{k} {v:.4f}" if not isinstance(v, dict) else
              f"{k}: " + ", ".join(f"{kk} {vv:.4f}" for kk, vv in v.items())
              for k, v in split.items()))
    out = dict(wall_s=wall, walls=walls, first_s=first_s, peak_gib=peak_gib, split=split,
               sync_wall_s=sync_wall, launches=launches, duplexes=duplexes, sha256s=digests,
               proof_bytes=sizes, syncs=total_syncs, syncs_per_table=per_table,
               device_ms=prof.get("device_ms"), busy=prof.get("busy"),
               profiled_launches=prof.get("launches"), verify_s=verify_s,
               rejected=rejected, traces_s=traces_s)

    # the circuit over the three proofs
    circuit_config = CircuitConfig.standard_recursion_config()
    ops.reset_launches()
    timing = TimingTree("build", sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    data, pts = mt.wrap_circuit(starks, config, list(CTL_LOG_ROWS), ctls, circuit_config,
                                device=dev, timing=timing)
    build_s, build_split, build_launches = (time.perf_counter() - t0, timing.split(),
                                            ops.launch_counts())
    vd = sha(verifier_data_to_bytes(data.verifier_only, data.common))
    if vd != CTL_WRAP_VERIFIER_SHA256:
        failures.append(f"the multi-table circuit's verifier data sha256 is {vd}, not "
                        f"{CTL_WRAP_VERIFIER_SHA256}")
    pw = mt.wrap_inputs(pts, proofs)

    def wrap_prove():
        prover_rng.seed(SEED)
        try:
            return data.prove(pw, device=dev)
        finally:
            prover_rng.seed(None)

    wrap_walls, wrap_digests = [], []
    for _ in range(2):  # a first call, then a warm prove
        ops.reset_launches()
        t0 = time.perf_counter()
        wrap_proof = wrap_prove()
        wrap_walls.append(time.perf_counter() - t0)
        wrap_launches = ops.launch_counts()
        wrap_digests.append(sha(proof_to_bytes(wrap_proof)))
        if wrap_digests[-1] != CTL_WRAP_PROOF_SHA256:
            failures.append(f"the multi-table circuit's proof sha256 is {wrap_digests[-1]}, "
                            f"not {CTL_WRAP_PROOF_SHA256}")
    for label, count in wrap_launches.items():
        if count == 0 and label != ops.K5_CHUNK.label:
            failures.append(f"{label} was not launched on the multi-table circuit's prove")
    if wrap_proof.public_inputs != [v for p in proofs for v in p.public_inputs]:
        failures.append("the multi-table circuit does not expose the tables' public inputs")
    t0 = time.perf_counter()
    try:
        data.verify(wrap_proof)
        wrap_ok = True
    except ValueError as e:
        wrap_ok = False
        failures.append(f"the port's verifier rejects the multi-table circuit's proof: {e}")
    wrap_verify_s = time.perf_counter() - t0
    print(f"ctl circuit over the three proofs ({card}): degree "
          f"2^{data.common.degree_bits}; build {build_s:.4f} s (a first call), verifier data "
          f"sha256 {vd} (the reference's: {CTL_WRAP_VERIFIER_SHA256}); split: "
          + ", ".join(f"{k} {v:.4f}" for k, v in build_split.items())
          + f"; build launches {build_launches}; prove (witness + fused prove) first call "
          f"{wrap_walls[0]:.4f} s, warm {wrap_walls[1]:.4f} s, sha256s {wrap_digests} (the "
          f"reference's: {CTL_WRAP_PROOF_SHA256}); launches {wrap_launches}; public inputs "
          f"{wrap_proof.public_inputs}; the port's verifier {wrap_verify_s:.3f} s, accepted: "
          f"{wrap_ok}")
    native = native_verify(card, failures, "multi-table circuit's proof", [],
                           [verifier_data_to_bytes(data.verifier_only, data.common),
                            proof_to_bytes(wrap_proof)], wrap_verify_s)
    out["circuit"] = dict(degree_bits=data.common.degree_bits,
                          build_s=build_s, build_split=build_split,
                          build_launches=build_launches, first_s=wrap_walls[0],
                          wall_s=wrap_walls[1], launches=wrap_launches, sha256=wrap_digests[-1],
                          verifier_sha256=vd, verify_s=wrap_verify_s, native=native)
    del data, pts, pw, wrap_proof, proofs
    torch.cuda.empty_cache()

    # each new kernel shape of the path against its plain version: K3's
    # table-0 trace iFFT [35, 2^20] and LDE x2 [35, 2^20] -> [35, 2^21], its
    # auxiliary LDE [12, 2^20] (4 logUp, 4 CTL helper, 4 CTL Z columns) and
    # quotient LDE [4, 2^20] (compared on two rows, timed whole); K4's trees
    # of width 35 and 12 over 2^21 leaves (compared on the first 2^14
    # leaves, timed whole); K2's re-LDE [2, 2^12] -> [2, 2^13] of table 0's
    # second FRI fold (arity 16: the coset shift is gen^256); K5's device
    # grind on table 0's transcript
    rng = np.random.default_rng(SEED + 80)
    lg = CTL_LOG_ROWS[0]
    n = 1 << lg
    gen = fs.MULTIPLICATIVE_GROUP_GENERATOR
    tab = ntt._lde_coset_scale_table(gen, lg, 1, str(dev))
    num_aux = (starks[0].num_lookup_helper_columns(config)
               + mt.ctl_target_counts(starks, config, ctls)[0][0])

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    def lde_shape(rows):
        x = rand((rows, n))
        part = x[:2].contiguous()
        return (ops.K3, f"ctl_lde_{rows}x2_{lg}_x2",
                lambda: kn.ntt_four_step(part, scale=tab, fan=2),
                lambda: kn.ntt_four_step_plain(part, False, tab, 2),
                8 * (x.numel() + tab.numel() + 2 * x.numel()),
                OPS_PER_MODMUL * rows * 2 * ((n // 2) * lg + n),
                lambda: kn.ntt_four_step(x, scale=tab, fan=2))

    def tree_shape(width):
        leaves = rand((width, 2 * n))
        part = leaves[:, :1 << 14].contiguous()
        levels = lg + 1 - 4
        return (ops.K4, f"ctl_tree_{width}x2_{lg + 1}", lambda: kp.merkle_tree(part, 4, True),
                lambda: kp.merkle_tree_plain(part, 4, True),
                8 * (leaves.numel() + kp.tree_words(2 * n, levels)),
                OPS_PER_PERMUTATION * (-(-width // 8) * 2 * n + (2 * n - (2 * n >> levels))),
                lambda: kp.merkle_tree(leaves, 4, True))

    x35 = rand((starks[0].COLUMNS, n))
    x35_part = x35[:2].contiguous()
    m12 = 1 << 12
    fold12 = rand((2, m12))
    tab12 = ntt._lde_coset_scale_table(fs.exp(gen, 1 << 8), 12, 1, str(dev))
    shapes = [
        (ops.K3, f"ctl_ifft_35x2_{lg}", lambda: kn.ntt_four_step(x35_part, inverse=True),
         lambda: kn.ntt_four_step_plain(x35_part, inverse=True), 8 * 2 * x35.numel(),
         OPS_PER_MODMUL * 35 * ((n // 2) * lg + n), lambda: kn.ntt_four_step(x35, inverse=True)),
        lde_shape(starks[0].COLUMNS), lde_shape(num_aux), lde_shape(4),
        tree_shape(starks[0].COLUMNS), tree_shape(num_aux),
        (ops.K2, "ctl_fri_relde_2x2_12_x2", lambda: kn.ntt_rows(fold12, scale=tab12, fan=2),
         lambda: kn.ntt_rows_plain(fold12, False, tab12, 2),
         8 * (fold12.numel() + tab12.numel() + 2 * fold12.numel()),
         OPS_PER_MODMUL * 2 * 2 * ((m12 // 2) * 12 + m12), None),
    ]
    if not grinds:
        failures.append("the multi-table prove ran no device grind")
    else:
        state, pending, bits = grinds[0]
        witness = g.u64(int(kp.grind_device(state, pending, bits)[0]))
        shapes.append((ops.K5_DEVICE, "ctl_grind_device",
                       lambda: kp.grind_device(state, pending, bits),
                       lambda: kp.grind_device_plain(state, pending, bits, chunk=GRIND_CHUNK),
                       8 * (12 + int(pending.shape[0]) + 1), OPS_PER_PERMUTATION * (witness + 1),
                       None))
        print(f"K5 device grind on the CTL table 0 transcript ({bits} bits, "
              f"{int(pending.shape[0])} pending): witness {witness}")
    out["shapes"] = shape_checks(torch, failures, shapes)
    del shapes, x35, dev_traces
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"ctl phase ({card}): {out['phase_s']:.1f} s")
    return out


def recorded_ntt_shapes(kn, calls):
    """Wrap K2's and K3's wrappers so that each distinct call (kernel,
    input shape, arguments) keeps a copy of its first inputs in `calls`.
    Returns the function that restores the wrappers."""
    import inspect

    originals = {"ntt_rows": kn.ntt_rows, "ntt_four_step": kn.ntt_four_step}

    def recording(name, fn):
        sig = inspect.signature(fn)

        def run(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = dict(bound.arguments)
            key = (name, tuple(a["x"].shape)) + tuple(
                (k, tuple(v.shape) if hasattr(v, "shape") else v)
                for k, v in a.items() if k != "x")
            if key not in calls:
                calls[key] = {k: (v.clone() if hasattr(v, "clone") else v)
                              for k, v in a.items()}
            return fn(*args, **kwargs)
        return run

    for name, fn in originals.items():
        setattr(kn, name, recording(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(kn, name, fn)
    return restore


def ntt_shape_checks(torch, failures, kn, ops, calls, prefix) -> dict:
    """Each recorded K2/K3 call against its plain version (`shape_checks`),
    with the bound of its work: each input and output word moved once, and
    the butterflies' and scalings' modular multiplications."""
    shapes = []
    for (name, shape, *_), a in sorted(calls.items(), key=lambda kv: str(kv[0])):
        b, m = shape
        lg_m = m.bit_length() - 1
        rb = a.get("repeat_bits", 0)
        lg = lg_m + rb
        big = 1 << lg
        fan = a["fan"]
        scale = a["scale"]
        n_bytes = 8 * (b * m + b * big * fan + (0 if scale is None else scale.numel()))
        n_ops = OPS_PER_MODMUL * b * fan * (big // 2 * lg + big + (0 if scale is None else m))
        key = (f"{prefix}_{'k3' if name == 'ntt_four_step' else 'k2'}_{b}x2^{lg_m}"
               + ("_inv" if a["inverse"] else "") + (f"_fan{fan}" if fan > 1 else "")
               + (f"_r{rb}" if rb else "") + ("" if scale is None else "_scaled"))
        kernel = ops.K3 if name == "ntt_four_step" else ops.K2
        fn, plain = ((kn.ntt_four_step, kn.ntt_four_step_plain) if kernel is ops.K3
                     else (kn.ntt_rows, kn.ntt_rows_plain))
        shapes.append((kernel, key, lambda fn=fn, a=a: fn(**a), lambda plain=plain, a=a: plain(**a),
                       n_bytes, n_ops, None))
    return shape_checks(torch, failures, shapes)


def stark_keccak_phase(torch, dev, card, failures) -> dict:
    """The Keccak-hashed Starky on the card: FibonacciStark and
    LookupTestStark at 2^STARKY_LOG_ROWS rows under `KeccakHasher`
    (standard_fast_config). The LDEs and iFFTs run on the card (K3, and K2
    for FRI's small re-LDEs); each commitment's leaves come to the host,
    whose trees and grind are Keccak (`hash/merkle.py` KeccakMerkleTree,
    the host FRI path). Each a first call (its K2/K3 calls recorded), its
    proof verified by the port's Keccak verifier and refused by a Poseidon
    one, STARK_KECCAK_PROVES timed proves (the counts set to 0 just before
    each and read just after, the host trees' seconds apart), one
    synchronised for the split; every proof's walk digest the reference's.
    Then each K2/K3 shape of the path against its plain version, timed."""
    from plonky2_torch import ops
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.hash import merkle
    from plonky2_torch.hash.hashers import KeccakHasher
    from plonky2_torch.ops import ntt as kn
    from plonky2_torch.starky import prover as sp
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_torch.starky.test_starks import LookupTestStark
    from plonky2_torch.starky.verifier import verify_stark_proof
    from plonky2_torch.util import TimingTree

    config = StarkConfig.standard_fast_config()
    n = 1 << STARKY_LOG_ROWS
    t_phase = time.perf_counter()

    def fib_case():
        stark = FibonacciStark(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)]
        return stark, stark.generate_trace(pis[0], pis[1]), pis

    def lookup_case():
        stark = LookupTestStark(n)
        return stark, stark.generate_trace(), []

    calls = {}
    out = {}
    for name, make, want in (("fibonacci", fib_case, STARK_KECCAK_FIB20_DIGEST),
                             ("lookup", lookup_case, STARK_KECCAK_LOOKUP20_DIGEST)):
        stark, trace, pis = make()
        trace_dev = g.tensor(trace, dev)

        def prove(timing=None, stark=stark, trace_dev=trace_dev, pis=pis):
            return sp.prove(stark, config, trace_dev, pis, device=dev, timing=timing,
                            hasher=KeccakHasher)

        def pinned(proof, what, name=name, want=want):
            digest = proof_walk_digest(proof)
            if digest != want:
                failures.append(f"{what}: the Keccak starky {name} 2^{STARKY_LOG_ROWS} proof's "
                                f"walk digest is {digest}, not {want}")
            return digest

        restore = recorded_ntt_shapes(kn, calls)
        t0 = time.perf_counter()
        try:
            proof = prove()
        finally:
            restore()
        first_s = time.perf_counter() - t0
        pinned(proof, "first call")
        t0 = time.perf_counter()
        try:
            verify_stark_proof(stark, proof, config, hasher=KeccakHasher)
            accepted = True
        except ValueError as e:
            accepted = False
            failures.append(f"the port's Keccak verifier rejects the {name} proof: {e}")
        verify_s = time.perf_counter() - t0
        try:
            verify_stark_proof(stark, proof, config)
            failures.append(f"a Poseidon verifier accepts the Keccak {name} proof")
            poseidon_refuses = False
        except ValueError:
            poseidon_refuses = True
        # the path is bound by the host's trees, whose leaf copies wait for
        # the LDEs anyway: each timed prove is the synchronised one
        walls = []
        for _ in range(STARK_KECCAK_PROVES):
            timing = TimingTree("starky prove", sync=torch.cuda.synchronize)
            merkle.reset_host_trees()
            ops.reset_launches()
            t0 = time.perf_counter()
            proof = prove(timing)
            walls.append(time.perf_counter() - t0)
            launches = ops.launch_counts()
            trees = dict(merkle.HOST_TREES)
            split = timing.split()
            digest = pinned(proof, "timed prove")
            if fri_prover._LAST_PATH != "host":
                failures.append(f"the Keccak starky {name} prove's FRI took the "
                                f"{fri_prover._LAST_PATH} path")
        for kernel in (ops.K2, ops.K3):
            if launches[kernel.label] == 0:
                failures.append(f"{kernel.label} was not launched on the Keccak starky {name} "
                                "prove")
        wall = statistics.median(walls)
        print(f"keccak starky {name} prove (2^{STARKY_LOG_ROWS} rows, {stark.COLUMNS} columns; "
              f"{card}): {wall:.4f} s median of {[round(w, 4) for w in walls]} (first call "
              f"{first_s:.3f} s), the host trees {trees['trees']}: leaves to the host "
              f"{trees['copy_s']:.4f} s, Keccak hashing {trees['hash_s']:.4f} s; walk digest "
              f"{digest} (the reference's: {want}); FRI on the {fri_prover._LAST_PATH} path; "
              f"launches {launches}; the port's Keccak verifier {verify_s:.3f} s, accepted: "
              f"{accepted}; a Poseidon verifier refuses it: {poseidon_refuses}")
        print(f"keccak starky {name} prove phases ({card}), s, the last timed prove, the device "
              f"synchronised at each phase's start and end: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; outside the phases {walls[-1] - sum(split.values()):.4f}")
        out[name] = dict(wall_s=wall, walls=walls, first_s=first_s, split=split,
                         launches=launches, host_trees=trees, verify_s=verify_s,
                         poseidon_refuses=poseidon_refuses, digest=digest)
        del trace_dev
    print(f"keccak starky: {len(calls)} distinct K2/K3 calls on the path")
    out["shapes"] = ntt_shape_checks(torch, failures, kn, ops, calls, "stark_keccak")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"stark_keccak phase ({card}): {out['phase_s']:.1f} s")
    return out


def gadgets_phase(torch, dev, card, failures) -> dict:
    """One circuit over the builder's whole gadget surface
    (`examples/gadgets.py`: boolean logic, the extension algebra,
    polynomial evaluation, Frobenius, random access over verifier data,
    base-B splits, `split_low_high` beside the other witness families) at
    the full 135-wire standard_recursion_config: built on the card (its
    verifier bytes the reference's), proved with the fused prove (rng seed
    2026; a first call, then one with the counts set to 0 just before and
    read just after; the reference's bytes), verified by the port's Python
    verifier and by its native binary."""
    from plonky2_torch import ops
    from plonky2_torch.examples import gadgets
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.serialization import proof_to_bytes
    from plonky2_torch.util import rng as prover_rng

    t_phase = time.perf_counter()
    ops.reset_launches()
    t0 = time.perf_counter()
    data, pw = gadgets.circuit(dev)
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    vd = verifier_data_to_bytes(data.verifier_only, data.common)
    vd_sha = hashlib.sha256(vd).hexdigest()
    if vd_sha != GADGETS_VERIFIER_SHA256:
        failures.append(f"the gadgets circuit's verifier data is {vd_sha}, not "
                        f"{GADGETS_VERIFIER_SHA256}")

    def prove():
        prover_rng.seed(SEED)
        try:
            return data.prove(pw, device=dev)
        finally:
            prover_rng.seed(None)

    t0 = time.perf_counter()
    first = proof_to_bytes(prove())
    first_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    proof = prove()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    transcript = tp._LAST_TRANSCRIPT
    proof_bytes = proof_to_bytes(proof)
    digest = hashlib.sha256(proof_bytes).hexdigest()
    if digest != GADGETS_PROOF_SHA256 or first != proof_bytes:
        failures.append(f"the gadgets proof is {digest} (first call "
                        f"{hashlib.sha256(first).hexdigest()}), not {GADGETS_PROOF_SHA256}")
    if transcript != "fused":
        failures.append(f"the gadgets prove took the {transcript} transcript")
    for label, count in launches.items():
        # every transform of a 2^7-row circuit fits K2's 2^13 points: no K3
        if count == 0 and label not in (ops.K3.label, ops.K5_CHUNK.label):
            failures.append(f"{label} was not launched on the gadgets prove")
    # the inverse and equality hints run in Python on both engines; the
    # LowHighGenerator of split_low_high runs on the plan's opcode
    plan = data.prover_only.cache("host")["last_plan"]
    if plan is None or "LowHighGenerator" in plan.fallbacks:
        failures.append(f"the gadgets witness did not run LowHighGenerator on the native "
                        f"plan: {None if plan is None else plan.fallbacks}")
    t0 = time.perf_counter()
    try:
        data.verify(proof)
        accepted = True
    except ValueError as e:
        accepted = False
        failures.append(f"the port's verifier rejects the gadgets proof: {e}")
    verify_s = time.perf_counter() - t0
    print(f"gadgets circuit ({card}): 2^{data.common.degree_bits} rows, "
          f"{len(data.common.gates)} gate kinds, {len(proof.public_inputs)} public inputs; "
          f"built in {build_s:.3f} s (launches {build_launches}), verifier sha256 {vd_sha} "
          f"(the reference's: {GADGETS_VERIFIER_SHA256}); proved in {wall:.4f} s (first call "
          f"{first_s:.3f} s) on the {transcript} transcript, sha256 {digest} (the reference's: "
          f"{GADGETS_PROOF_SHA256}); launches {launches}; the witness on the native plan, "
          f"generators run in Python: {plan.fallbacks or 'none'}; the port's "
          f"verifier {verify_s:.4f} s, accepted: {accepted}")
    native = native_verify(card, failures, "gadgets proof", [], [vd, proof_bytes], verify_s)
    out = dict(build_s=build_s, build_launches=build_launches, wall_s=wall, first_s=first_s,
               launches=launches, verify_s=verify_s, native=native, sha256=digest,
               verifier_sha256=vd_sha, phase_s=time.perf_counter() - t_phase)
    print(f"gadgets phase ({card}): {out['phase_s']:.1f} s")
    return out


# -- the multigpu phase -----------------------------------------------------------

def multigpu_cases(torch, dev, names, batch_k: int = MULTIGPU_BATCH_K) -> dict:
    """The proves of the multigpu phase on `dev`, built or read here: name
    -> (prove(timing) -> proof bytes, the pinned sha256, the transcript
    path). "middle fused"/"middle host": the middle circuit's seed-2026
    random-witness prove on each path (MIDDLE_PROVE_SHA256); "headline":
    witness + prove from `bench_cache/inner14.proof.bin`
    (HEADLINE_PROOF_SHA256); "inner18", "zk inner", "lookup1 inner": the
    first layers of the sizes, zk and lookup chains (SIZES_PROOF_SHA256S,
    ZK_PROOF_SHA256S, LOOKUP_PROOF_SHA256S); and `multigpu_path_cases`'
    MULTIGPU_PATHS (prove_many of `batch_k` proofs). Every prove seeds the
    rng to 2026; under a process group it runs over the group."""
    from plonky2_torch.examples import bench_recursion as br
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.fri import prover as fri_prover
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.plonk.circuit_serialization import verifier_data_from_bytes
    from plonky2_torch.plonk.config import CircuitConfig
    from plonky2_torch.plonk.prover_serialization import read_circuit_data
    from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
    from plonky2_torch.recursion import recursive_verifier as rv
    from plonky2_torch.util import rng as prover_rng

    root = os.path.dirname(os.path.abspath(__file__))

    def read(*parts) -> bytes:
        with open(os.path.join(root, *parts), "rb") as f:
            return f.read()

    def seeded(run, host=False):
        def prove(timing=None):
            prover_rng.seed(SEED)
            try:
                with fri_prover.force_host_path() if host else contextlib.nullcontext():
                    return proof_to_bytes(run(timing))
            finally:
                prover_rng.seed(None)
        return prove

    cases = {}
    if any(n.startswith("middle") or n in ("headline", "keccak wrap", "prove_many",
                                            "prove_many threads 2") for n in names):
        prover_only, common, verifier_only = read_circuit_data(
            read("bench_cache", "middle14.circuit.bin"))
        witness, pis, pi_hash = tp.random_witness(common, SEED)
        prepared = (g.tensor(witness, dev), pis, pi_hash)
        for path in ("fused", "host"):
            cases[f"middle {path}"] = (seeded(lambda timing: tp.prove(
                prover_only, common, None, device=dev, timing=timing, _prepared=prepared),
                host=path == "host"), MIDDLE_PROVE_SHA256, path)
        inner_vo, inner_common = verifier_data_from_bytes(read("bench_cache",
                                                               "inner14.verifier.bin"))
        builder = CircuitBuilder()
        proof_t = rv.add_virtual_proof_with_pis(builder, inner_common)
        vd_t = rv.add_virtual_verifier_data(builder, inner_common.config.fri_config.cap_height)
        pw = PartialWitness()
        rv.set_proof_with_pis_target(pw, proof_t, proof_from_bytes(
            read("bench_cache", "inner14.proof.bin"), inner_common))
        rv.set_verifier_data_target(pw, vd_t, inner_vo)
        cases["headline"] = (seeded(lambda timing, pw=pw: tp.prove(
            prover_only, common, pw, device=dev, timing=timing)), HEADLINE_PROOF_SHA256,
            "fused")
        middle = (prover_only, common, verifier_only, inner_vo, inner_common, pw)
    chains = {"inner18": (lambda: (br.dummy_circuit(
                  CircuitConfig.standard_recursion_config(), SIZES_LOG, device=dev),
                  PartialWitness()), SIZES_PROOF_SHA256S[0]),
              "zk inner": (lambda: (br.dummy_circuit(
                  CircuitConfig.standard_recursion_zk_config(), ZK_LOG, device=dev),
                  PartialWitness()), ZK_PROOF_SHA256S[0]),
              "lookup1 inner": (lambda: br.lookup_circuit(
                  CircuitConfig.standard_recursion_config(), LOOKUP_LOG, 1, device=dev),
                  LOOKUP_PROOF_SHA256S[1][0])}
    for name, (build, pin) in chains.items():
        if name in names:
            data, pw = build()
            cases[name] = (seeded(lambda timing, data=data, pw=pw: data.prove(
                pw, device=dev, timing=timing)), pin, "fused")
    if any(n in MULTIGPU_PATHS for n in names):
        cases.update(multigpu_path_cases(torch, dev, names, read,
                                         middle if "headline" in cases else None, batch_k))
    return {n: cases[n] for n in names}


def multigpu_path_cases(torch, dev, names, read, middle, batch_k) -> dict:
    """The MULTIGPU_PATHS cases of `multigpu_cases`, name -> (prove(timing)
    -> proof bytes or a digest, the pin, None: no PLONK transcript to
    check). "starky fibonacci"/"starky lookup": FIB20_PROOF_SHA256,
    LOOKUP20_PROOF_SHA256; "multi-table": the three tables' sha256s
    (CTL_PROOF_SHA256S, comma-joined); "batch FRI": BATCH_FRI_PROOF_SHA256;
    "keccak wrap": the Keccak outer layer over the headline proof (made
    here, outside any group), KECCAK_WRAP_PROOF_SHA256 (its path "host");
    "keccak starky fibonacci": the walk digest STARK_KECCAK_FIB20_DIGEST;
    "prove_many": `batch_k` proofs of the headline's inputs, each the
    sequential prove's on `dev` (made here; the first is
    HEADLINE_PROOF_SHA256), and at most BATCH_WINDOW in flight; "middle
    build": the middle circuit's verifier bytes, those of
    bench_cache/middle14.circuit.bin. middle: (prover data, common and
    verifier data of the middle circuit, the inner verifier data and
    common, the headline's PartialWitness)."""
    from plonky2_torch.examples import batch_fri as bf
    from plonky2_torch.examples import bench_recursion as br
    from plonky2_torch.examples import multi_table as mt
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.hash.hashers import KeccakHasher
    from plonky2_torch.iop.witness import PartialWitness
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_torch.plonk.circuit_serialization import verifier_data_to_bytes
    from plonky2_torch.plonk.config import CircuitConfig, keccak_goldilocks_config
    from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
    from plonky2_torch.recursion import recursive_verifier as rv
    from plonky2_torch.starky import cross_table_lookup as ctl
    from plonky2_torch.starky import prover as sp
    from plonky2_torch.starky.config import StarkConfig
    from plonky2_torch.starky.fibonacci_stark import FibonacciStark, fibonacci
    from plonky2_torch.starky.serialization import stark_proof_to_bytes
    from plonky2_torch.starky.test_starks import LookupTestStark
    from plonky2_torch.util import rng as prover_rng

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    config = StarkConfig.standard_fast_config()
    n = 1 << STARKY_LOG_ROWS
    cases = {}
    for name, pin, make, hasher in (
            ("starky fibonacci", FIB20_PROOF_SHA256, FibonacciStark, None),
            ("starky lookup", LOOKUP20_PROOF_SHA256, LookupTestStark, None),
            ("keccak starky fibonacci", STARK_KECCAK_FIB20_DIGEST, FibonacciStark,
             KeccakHasher)):
        if name not in names:
            continue
        stark = make(n)
        pis = [0, 1, fibonacci(n - 1, 0, 1)] if make is FibonacciStark else []
        trace = g.tensor(stark.generate_trace(*pis[:2]), dev)

        def prove(timing=None, stark=stark, trace=trace, pis=pis, hasher=hasher):
            proof = sp.prove(stark, config, trace, pis, device=dev, timing=timing,
                             hasher=hasher)
            return (proof_walk_digest(proof) if hasher is not None
                    else stark_proof_to_bytes(proof, config))
        cases[name] = (prove, pin, None)
    if "multi-table" in names:
        starks, ctls = mt.system()
        traces, ctl_pis = mt.generate_traces(CTL_LOG_ROWS, seed=SEED)
        traces = [g.tensor(t, dev) for t in traces]

        def prove_tables(timing=None):
            proofs = ctl.prove_multi_table(starks, config, traces, ctl_pis, ctls, device=dev,
                                           timing=timing)[0]
            return ",".join(sha(stark_proof_to_bytes(p, config)) for p in proofs)
        cases["multi-table"] = (prove_tables, ",".join(CTL_PROOF_SHA256S), None)
    if "batch FRI" in names:
        params = config.fri_config.fri_params(bf.BITS[0], False)
        groups = [g.tensor(c, dev) for c in bf.random_groups(seed=SEED)]

        def prove_batch(timing=None):
            return bf.proof_bytes(bf.prove(groups, params, dev).proof)
        cases["batch FRI"] = (prove_batch, BATCH_FRI_PROOF_SHA256, None)
    if middle is not None:
        prover_only, common, verifier_only, inner_vo, inner_common, pw = middle
    if "keccak wrap" in names:
        headline = proof_from_bytes(proof_to_bytes(seeded(
            lambda: tp.prove(prover_only, common, pw, device=dev))), common)
        builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                                 gc=keccak_goldilocks_config())
        pt = rv.add_virtual_proof_with_pis(builder, common)
        vdt = rv.add_virtual_verifier_data(builder, common.config.fri_config.cap_height)
        rv.verify_proof(builder, pt, vdt, common)
        builder.register_public_inputs(pt.public_inputs)
        wrap = builder.build(device=dev)
        wrap_pw = PartialWitness()
        rv.set_proof_with_pis_target(wrap_pw, pt, headline)
        rv.set_verifier_data_target(wrap_pw, vdt, verifier_only)
        cases["keccak wrap"] = (lambda timing=None: proof_to_bytes(seeded(
            lambda: wrap.prove(wrap_pw, device=dev, timing=timing))),
            KECCAK_WRAP_PROOF_SHA256, "host")
    if "prove_many" in names or "prove_many threads 2" in names:
        sequential = seeded(lambda: [sha(proof_to_bytes(tp.prove(
            prover_only, common, pw, device=dev))) for _ in range(batch_k)])
        pin = ",".join(sequential)
        if sequential[0] != HEADLINE_PROOF_SHA256:
            pin = "the first sequential proof is not the headline's"
        for name, threads in (("prove_many", 1), ("prove_many threads 2", 2)):
            def prove_batch_many(timing=None, threads=threads):
                proofs = seeded(lambda: tp.prove_many(
                    prover_only, common, [pw] * batch_k, device=dev, timing=timing,
                    window=BATCH_WINDOW, threads=threads))
                if tp._LAST_MAX_IN_FLIGHT > BATCH_WINDOW:
                    return f"{tp._LAST_MAX_IN_FLIGHT} proofs in flight, above {BATCH_WINDOW}"
                return ",".join(sha(proof_to_bytes(p)) for p in proofs)
            if name in names:
                cases[name] = (prove_batch_many, pin, None)
    if "middle build" in names:
        def build_middle(timing=None):
            data = br.recursion_circuit(inner_common, CircuitConfig.standard_recursion_config(),
                                        device=dev, timing=timing)[0]
            return verifier_data_to_bytes(data.verifier_only, data.common)
        cases["middle build"] = (build_middle,
                                 sha(verifier_data_to_bytes(verifier_only, common)), None)
    return cases


def multigpu_measure(torch, cases, proves: int, group=None, profiled=(), once=()) -> dict:
    """Each case proved once (the first call), `proves` times timed end to
    end (the launch counts, the collectives and the Keccak host trees set
    to 0 just before each and read just after), once with every phase
    synchronised (the split) and on the fused path once with its host
    synchronisations counted, and, for the cases named in `profiled`, once
    under the CUDA profiler (`profile_line`: device busy against the median
    wall); a case named in `once`, whose circuit the cases before it
    warmed, is proved once, timed, and nothing else. Under `group` if
    given, with the peak of allocated memory over the first call and the
    timed ones. A prove gives bytes (their sha256 is compared with the pin)
    or a digest. Returns name -> numbers and every run's digest."""
    from plonky2_torch import ops, parallel
    from plonky2_torch.hash import merkle
    from plonky2_torch.plonk import prover as tp
    from plonky2_torch.util import TimingTree

    def digest(got) -> str:
        return got if isinstance(got, str) else hashlib.sha256(got).hexdigest()

    out = {}
    for name, (prove, pin, path) in cases.items():
        with parallel.use_mesh(group):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_gib = torch.cuda.memory_allocated() / 2**30  # the other cases' circuits
            shas, first_s = [], None
            if name not in once:
                t0 = time.perf_counter()
                shas.append(digest(prove()))
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            walls = []
            for _ in range(1 if name in once else proves):
                ops.reset_launches()
                parallel.Collectives.reset()
                merkle.reset_host_trees()
                t0 = time.perf_counter()
                shas.append(digest(prove()))
                walls.append(time.perf_counter() - t0)
                launches = ops.launch_counts()
                collectives = (parallel.Collectives.count, parallel.Collectives.bytes)
                host_trees = dict(merkle.HOST_TREES)
                transcript = tp._LAST_TRANSCRIPT
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            first_s = walls[0] if first_s is None else first_s
            split, sync_wall, syncs = {}, None, None
            if name not in once:
                timing = TimingTree("prove", sync=torch.cuda.synchronize)
                t0 = time.perf_counter()
                shas.append(digest(prove(timing)))
                sync_wall = time.perf_counter() - t0
                split = timing.split()
                if path == "fused":
                    caught, proof = count_syncs_before_fetch(torch, prove)
                    syncs = None if caught is None else len(caught)
                    shas.append(digest(proof))
            profile = None
            if name in profiled:
                who = "one card" if group is None else f"rank {group.rank} of {group.world}"
                profile = profile_line(torch, prove, statistics.median(walls),
                                       f"multigpu {name}, {who}")
        out[name] = dict(first_s=first_s, walls=walls, wall_s=statistics.median(walls),
                         sync_wall_s=sync_wall, split=split, launches=launches,
                         collectives=collectives[0], collective_bytes=collectives[1],
                         host_trees=host_trees, peak_gib=peak_gib, base_gib=base_gib,
                         syncs_before_fetch=syncs, transcript=transcript, profile=profile,
                         path=path, pinned=pin, shas=sorted(set(shas)))
    return out


def lde_parts_plain(torch, x, rate_bits: int, own, count: int):
    """`ntt.coset_lde_parts` by the plain versions of K2 and K3 on x's
    device: each part v of `own` (of `count`) on its own, the LDE at rate
    rate_bits - lg count on the coset g w_N^v while count divides
    2^rate_bits, else the fold and a plain coset NTT."""
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.ops import ntt as kn

    lg_m, lg_count = x.shape[-1].bit_length() - 1, count.bit_length() - 1
    lg_n = lg_m + rate_bits
    out = []
    for v in own:
        shift = fs.mul(fs.MULTIPLICATIVE_GROUP_GENERATOR,
                       fs.exp(fs.primitive_root_of_unity(lg_n), v))
        if lg_count <= rate_bits:
            rate = rate_bits - lg_count
            y, scale, fan = x, ntt._lde_coset_scale_table(shift, lg_m, rate, str(x.device)), 1 << rate
        else:
            m = 1 << (lg_n - lg_count)
            slices = x.reshape(x.shape[0], -1, m)
            weights = g.powers(fs.exp(shift, m), slices.shape[1], x.device)
            y = g.sum_mod(g.mul(slices, weights[:, None]), 1)
            scale, fan = ntt.shift_powers(shift, m, x.device).reshape(1, m), 1
        lg = y.shape[-1].bit_length() - 1
        plain = kn.ntt_rows_plain if lg <= kn.MAX_SMEM_LG else kn.ntt_four_step_plain
        out.append(plain(y.contiguous(), False, scale, fan))
    return torch.stack(out)


def multigpu_kernel_checks(torch, group) -> dict:
    """On the rank's parts of the 2^18 inner circuit's wires (random
    [135, 2^18] coefficients, the same on every rank): K3's part LDEs
    (`ntt.coset_lde_parts`: one interleaved launch over the parts' fan
    rows while P divides 2^3, else the fold a part) of two rows against
    their plain version (`lde_parts_plain`) and against the parts' columns
    of the whole LDE x8, and K4's local tree (cap height 4) over 2^15 of
    the first part's columns of all 135 wires against `merkle_tree_plain`,
    level by level; then `parallel.sharded_prover_step` against
    PROVER_STEP_SHA256."""
    import numpy as np

    from plonky2_torch import parallel
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.ops import poseidon as kp

    dev, count, own = group.device, group.parts, group.own_parts
    rng = np.random.default_rng(SEED + 40)
    wires = g.tensor(rng.integers(0, fs.P, size=(135, 1 << SIZES_LOG), dtype=np.uint64), dev)
    x = wires[:2].contiguous()
    sub = ntt.coset_lde_parts(x, 3, own, count)
    whole = ntt.coset_lde(x, 3)
    k3 = (compare(sub, lde_parts_plain(torch, x, 3, own, count))[0],
          compare(sub, torch.stack([whole[:, v::count] for v in own]))[0])
    del whole
    local = ntt.coset_lde_parts(wires, 3, own, count)[0][:, :1 << 15].contiguous()
    got, want = kp.merkle_tree(local, 4, True), kp.merkle_tree_plain(local, 4, True)
    torch.cuda.synchronize()
    k4 = int(len(got) != len(want)) + sum(compare(a, b)[0] for a, b in zip(got, want))
    cap, z = parallel.sharded_prover_step(group)
    step = hashlib.sha256(g.to_numpy(cap).tobytes() + g.to_numpy(z).tobytes()).hexdigest()
    return dict(k3_sub_lde_mismatches=k3[0], k3_vs_whole_lde_mismatches=k3[1],
                k3_shape=list(sub.shape), parts=list(own), of=count,
                k4_local_tree_mismatches=k4, k4_shape=list(local.shape),
                prover_step_sha256=step)


def parts_check(torch, dev, card, failures) -> dict:
    """Every rank of the worlds PARTS_WORLDS played on this card: for each
    rank its parts' LDEs (`ntt.coset_lde_parts`, K3 or K2 by size: one
    launch a rank where the parts divide 2^3, else the fold a part) and
    each part's local K4 subtree (cap height PARTS_CAP_HEIGHT - p), held to
    the columns c = v (mod P) of the whole LDE and the digests at the same
    residues of the whole tree's levels; then the cap rebuilt from every
    part's root against the whole tree's. Prints the mismatches (0
    expected) and the launches a rank, at each of PARTS_SHAPES."""
    import numpy as np

    from plonky2_torch import ops, parallel
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt
    from plonky2_torch.field import scalar as fs
    from plonky2_torch.ops import poseidon as kp

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 41)
    out = {}
    for polys, lg in PARTS_SHAPES:
        x = g.tensor(rng.integers(0, fs.P, size=(polys, 1 << lg), dtype=np.uint64), dev)
        whole = ntt.coset_lde(x, 3)
        tree = kp.merkle_tree(whole, PARTS_CAP_HEIGHT, True)
        for k in PARTS_WORLDS:
            count = parallel.parts_count(k)
            p = count.bit_length() - 1
            local_cap = max(PARTS_CAP_HEIGHT - p, 0)
            levels = lg + 3 - p - local_cap
            lde_bad = tree_bad = 0
            roots, launches = [None] * count, []
            for rank in range(k):
                own = tuple(range(rank, count, k))
                ops.reset_launches()
                parts = ntt.coset_lde_parts(x, 3, own, count)
                lde_launches = ops.launch_counts()
                for t, v in enumerate(own):
                    lde_bad += compare(parts[t], whole[:, v::count])[0]
                    layers = kp.merkle_tree(parts[t].contiguous(), local_cap, True)
                    tree_bad += int(len(layers) != levels + 1) + sum(
                        compare(layers[l], tree[l][:, v::count].contiguous())[0]
                        for l in range(min(len(layers), levels + 1)))
                    roots[v] = layers[-1]
                launches.append({key: n for key, n in lde_launches.items() if n})
            layer = torch.stack(roots).permute(1, 2, 0).reshape(4, -1).contiguous()
            cap = (kp.merkle_tree(layer, PARTS_CAP_HEIGHT, True)[-1] if p > PARTS_CAP_HEIGHT
                   else layer)
            cap_bad = compare(cap, tree[-1])[0]
            kernel = "/".join(sorted({key.split()[0] for n in launches for key in n}))
            out[f"{k} ranks, [{polys}, 2^{lg}]"] = dict(
                parts=count, lde_mismatches=lde_bad, tree_mismatches=tree_bad,
                cap_mismatches=cap_bad, lde_launches_by_rank=launches)
            print(f"parts check ({card}): a world of {k} ({count} parts) on one card, LDE x8 of "
                  f"[{polys}, 2^{lg}] ({kernel}) and its trees: LDE {lde_bad} mismatches, "
                  f"subtrees {tree_bad}, cap {cap_bad}; each rank's LDE launches {launches}")
            if lde_bad or tree_bad or cap_bad:
                failures.append(f"parts check, {k} ranks, [{polys}, 2^{lg}]: {lde_bad} LDE, "
                                f"{tree_bad} subtree, {cap_bad} cap mismatches")
        del whole, tree
    out["seconds"] = time.perf_counter() - t0
    print(f"parts check ({card}): {out['seconds']:.1f} s")
    return out


def multigpu_rank(group, names) -> dict:
    """A rank of the multigpu phase: the kernels load (built by the parent),
    the circuits are read and built whole on the rank's card outside the
    group, then proved over it (`multigpu_measure`), and the rank's kernel
    checks run."""
    import torch

    from plonky2_torch.ops import build

    build.build_all()
    t0 = time.perf_counter()
    cases = multigpu_cases(torch, group.device, names)
    setup_s = time.perf_counter() - t0
    out = dict(rank=group.rank, setup_s=setup_s, threads=torch.get_num_threads(),
               cases=multigpu_measure(torch, cases, MULTIGPU_PROVES, group,
                                      MULTIGPU_PROFILED, MULTIGPU_ONCE))
    del cases
    torch.cuda.empty_cache()
    out["kernels"] = multigpu_kernel_checks(torch, group)
    return out


def multigpu_phase(torch, dev, card, failures, in_process: bool = False,
                   names=None, world=None) -> dict:
    """The proves over a process group (`plonky2_torch.parallel`), one
    rank a card over NCCL. in_process (the one-card run of the whole
    script): a group of one in this process, no spawn, the middle circuit's
    proves on both paths and the headline, each to its pin, and one run
    of each of MULTIGPU_PATHS (Starky, the multi-table prove, batch FRI,
    the Keccak wrap and Keccak Starky, prove_many, the middle build), each
    to its pin. Otherwise (the
    `--phases multigpu` run) a world of every card, or of the first `world`
    cards (`--world N`, any N from 1 to the cards there are): first each case of
    `multigpu_cases` on one card here, with no group, then `multigpu_rank`
    on every card; every rank's proofs must be the pinned ones, the fused
    proves must make no host synchronisation before their fetch, and each
    rank's kernel checks must show no mismatch; `names` picks some of
    MULTIGPU_CASES there (all by default). Prints each case's median
    wall on one card and on the group, its split, the collectives and
    their bytes a prove, rank 0's launches and every rank's peak memory;
    writes the whole record to chiprun_out/multigpu.json."""
    from plonky2_torch import parallel

    t_phase = time.perf_counter()
    world = 1 if in_process else world or torch.cuda.device_count()
    if not 1 <= world <= torch.cuda.device_count():
        failures.append(f"multigpu: a world of {world} on {torch.cuda.device_count()} cards")
        return {}
    print(f"multigpu: world {world}{' (a group of one in this process)' if in_process else ''}")
    names = MULTIGPU_IN_PROCESS if in_process else names or MULTIGPU_CASES

    def check_case(who, name, m):
        bad = [s for s in m["shas"] if s != m["pinned"]]
        if bad:
            failures.append(f"multigpu {who} {name}: proof sha256 {bad}, not {m['pinned']}")
        if m["path"] is not None and m["transcript"] != m["path"]:
            failures.append(f"multigpu {who} {name}: took the {m['transcript']} path")
        if m["path"] == "fused" and m["syncs_before_fetch"] != 0:
            failures.append(f"multigpu {who} {name}: {m['syncs_before_fetch']} host syncs "
                            "before the fetch")

    def line(m):
        split = ", ".join(f"{k} {v:.4f}" for k, v in m["split"].items())
        trees = m["host_trees"]
        return (f"{m['wall_s']:.4f} s median of {[round(w, 4) for w in m['walls']]} (first "
                f"call {m['first_s']:.3f} s), peak {m['peak_gib']:.2f} GiB allocated ("
                f"{m['base_gib']:.2f} before it), syncs before the fetch "
                f"{m['syncs_before_fetch']}; Keccak host trees {trees['trees']} (leaves to "
                f"the host {trees['copy_s']:.4f} s, hashed {trees['hash_s']:.4f} s); split ("
                f"{m['sync_wall_s'] or 0:.4f} s synchronised): {split}")

    if in_process:
        cases = multigpu_cases(torch, dev, names, BATCH_K // 2)
        with parallel.local_group("nccl") as group:
            # one prove of each path under a group, warm: the earlier phases
            # (and the headline, for prove_many and the Keccak wrap) proved
            # their circuits and shapes on this card before
            result = multigpu_measure(torch, cases, 1, group, once=MULTIGPU_PATHS)
        del cases
        for name, m in result.items():
            check_case("group of one", name, m)
            print(f"multigpu {name} ({card}; a group of one, NCCL): {line(m)}; "
                  f"collectives {m['collectives']} a prove, {m['collective_bytes']} bytes; "
                  f"launches {m['launches']}; sha256 {m['shas']}")
        out = dict(world=1, cases=result, launches=result["headline"]["launches"])
    else:
        if world > 1 and "prove_many threads 2" in names:
            names = tuple(n for n in names if n != "prove_many threads 2")
            print(f"multigpu prove_many threads 2 on {world} cards: not run; prove_many "
                  "refuses dispatch threads under an NCCL group of more than one rank")
        t0 = time.perf_counter()
        cases = multigpu_cases(torch, dev, names)
        print(f"multigpu one card ({card}): circuits read and built in "
              f"{time.perf_counter() - t0:.1f} s")
        one = multigpu_measure(torch, cases, MULTIGPU_PROVES, profiled=MULTIGPU_PROFILED,
                               once=MULTIGPU_ONCE)
        del cases
        torch.cuda.empty_cache()
        for name, m in one.items():
            check_case("one card", name, m)
        t0 = time.perf_counter()
        ranks = parallel.run_on_group(multigpu_rank, world, "nccl", names, timeout_s=1500)
        group_s = time.perf_counter() - t0
        for r in ranks:
            for name, m in r["cases"].items():
                check_case(f"rank {r['rank']}", name, m)
            kc = r["kernels"]
            if kc["k3_sub_lde_mismatches"] or kc["k3_vs_whole_lde_mismatches"] or kc[
                    "k4_local_tree_mismatches"]:
                failures.append(f"multigpu rank {r['rank']}: kernel checks {kc}")
            if kc["prover_step_sha256"] != PROVER_STEP_SHA256:
                failures.append(f"multigpu rank {r['rank']}: sharded_prover_step "
                                f"{kc['prover_step_sha256']}, not {PROVER_STEP_SHA256}")
            print(f"multigpu rank {r['rank']}: circuits read and built in {r['setup_s']:.1f} "
                  f"s ({r['threads']} intra-op threads); K3 part LDEs {kc['k3_shape']} (parts "
                  f"{kc['parts']} of {kc['of']}) {kc['k3_sub_lde_mismatches']} mismatches "
                  f"against its plain version, {kc['k3_vs_whole_lde_mismatches']} against its "
                  f"columns of the whole LDE; K4 local tree {kc['k4_shape']} "
                  f"{kc['k4_local_tree_mismatches']} mismatches; sharded_prover_step sha256 "
                  f"{kc['prover_step_sha256']}")
        for name in names:
            m1, m0 = one[name], ranks[0]["cases"][name]
            print(f"multigpu {name}, one card ({card}): {line(m1)}")
            print(f"multigpu {name}, {world} cards, rank 0: {line(m0)}; collectives "
                  f"{m0['collectives']} a prove, {m0['collective_bytes']} bytes; launches "
                  f"{m0['launches']} (one card: {m1['launches']}); every rank's median "
                  f"{[round(r['cases'][name]['wall_s'], 4) for r in ranks]} s, peak "
                  f"{[round(r['cases'][name]['peak_gib'], 2) for r in ranks]} GiB, Keccak "
                  f"host trees hashed (s) "
                  f"{[round(r['cases'][name]['host_trees']['hash_s'], 4) for r in ranks]}; "
                  f"sha256 {m0['shas']}")
        out = dict(world=world, one_card=one, ranks=ranks, group_s=group_s)
    out["phase_s"] = time.perf_counter() - t_phase
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"multigpu{'_one' if in_process else ''}.json"), "w") as f:
        json.dump(dict(card=card, **out), f, indent=1, default=str)
    print(f"multigpu phase ({card}): {out['phase_s']:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "plonky2_torch")):
        # the script alone, out of its checkout: nothing to drive
        return fail(f"no plonky2_torch/ beside {__file__}: run it from a checkout of the "
                    "repository")
    sys.path.insert(0, here)
    try:
        import numpy as np

        from plonky2_torch import native, ops
        from plonky2_torch.examples import bench_recursion as br
        from plonky2_torch.examples import commit_and_open as co
        from plonky2_torch.examples import factorial, fibonacci, range_check, square_root
        from plonky2_torch.field import goldilocks as g
        from plonky2_torch.field import ntt
        from plonky2_torch.field import scalar as fs
        from plonky2_torch.fri import prover as fri_prover
        from plonky2_torch.ops import build
        from plonky2_torch.ops import ntt as kn
        from plonky2_torch.ops import poseidon as kp
        from plonky2_torch.iop.witness import PartialWitness
        from plonky2_torch.plonk import prover as tp
        from plonky2_torch.plonk.circuit_builder import CircuitBuilder
        from plonky2_torch.plonk.circuit_serialization import (
            verifier_data_from_bytes,
            verifier_data_to_bytes,
        )
        from plonky2_torch.plonk.config import CircuitConfig
        from plonky2_torch.plonk.prover_serialization import read_circuit_data, read_prover_data
        from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
        from plonky2_torch.plonk.verifier import verify
        from plonky2_torch.recursion import recursive_verifier as rv
        from plonky2_torch.util import TimingTree
        from plonky2_torch.util import rng as prover_rng
    except ImportError as e:
        return fail(f"the port cannot be imported here ({e})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        return fail("nvidia-smi gave no card name and power limit")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds} s)")
    for src, log in build.ptxas_log.items():
        print(f"ptxas {src}: " + "; ".join(ptxas_lines(log)))
    t0 = time.perf_counter()
    print(f"native verifier: {native.verifier_binary()} built (g++) in "
          f"{time.perf_counter() - t0:.1f} s")
    native_lines = {}

    rng = np.random.default_rng(SEED)

    def rand(shape):
        return g.tensor(rng.integers(0, fs.P, size=shape, dtype=np.uint64), dev)

    results = {}
    failures = []

    def check(kernel, pairs, timed, n_bytes, n_ops, ms=None):
        """pairs: (label, kernel call, plain call) on the same inputs;
        timed: the (kernel, plain) pair timed at the main path's shape (the
        kernel's time is `ms` where given)."""
        mism, err = 0, 0.0
        for label, run_k, run_p in pairs:
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            m, e = compare(got, want)
            print(f"{kernel.label} {label}: {m} mismatches")
            mism += m
            err = max(err, e)
        if mism:
            failures.append(f"{kernel.label} disagrees with its plain version")
        if ms is None:
            ms = time_ms(torch, timed[0], reps=20, warmup=3)
        plain_ms = time_ms(torch, timed[1], reps=3, warmup=1)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        print(f"{kernel.label}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {b_ms:.4f} ms ({b_by})")
        results[kernel.label] = dict(mismatches=mism, max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    root = os.path.dirname(os.path.abspath(__file__))

    def read(*parts) -> bytes:
        with open(os.path.join(root, *parts), "rb") as f:
            return f.read()

    # the factorial circuit (degree 2^6, its real witness) on the card and
    # on the CPU, each to the fixture's bytes
    fact_prover, fact_common = read_prover_data(read("plonky2_torch", "data",
                                                     "factorial.prover.bin"))
    w = np.load(os.path.join(root, "plonky2_torch", "data", "factorial.witness.npz"))
    fact_prepared = (w["witness"], [int(v) for v in w["public_inputs"]],
                     [int(v) for v in w["public_inputs_hash"]])
    fixture = read("fixtures", "factorial.proof.bin")

    def fact_prove(device):
        return proof_to_bytes(tp.prove(fact_prover, fact_common, None, device=device,
                                       _prepared=fact_prepared))

    t0 = time.perf_counter()
    fact_card = fact_prove(dev)
    card_s = time.perf_counter() - t0
    if tp._LAST_TRANSCRIPT != "fused":
        failures.append("the factorial prove on the card did not take the fused path")
    with fri_prover.force_host_path():
        if fact_prove(dev) != fixture:
            failures.append("the factorial host-path proof on the card is not the fixture")
    t0 = time.perf_counter()
    with one_cpu_thread(torch):
        fact_cpu = fact_prove("cpu")
    cpu_s = time.perf_counter() - t0
    print(f"factorial prove (2^6, fused path; the host path's also checked): card "
          f"{card_s:.2f} s (first call), cpu {cpu_s:.1f} s; "
          f"card = fixture: {fact_card == fixture}, cpu = fixture: {fact_cpu == fixture} "
          f"(sha256 {hashlib.sha256(fact_card).hexdigest()[:16]})")
    if fact_card != fixture:
        failures.append("the factorial proof on the card is not fixtures/factorial.proof.bin")
    if fact_cpu != fixture:
        failures.append("the factorial proof on the CPU is not fixtures/factorial.proof.bin")

    # the main path: the bench_recursion middle circuit, proved on the card
    blob = read("bench_cache", "middle14.circuit.bin")
    t0 = time.perf_counter()
    prover_only, common, verifier_only = read_circuit_data(blob)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cap = prover_only.commitment(common, dev).merkle_tree.cap
    commit_s = time.perf_counter() - t0
    print(f"middle circuit: read {len(blob)} bytes in {read_s:.3f} s (its "
          f"{len(prover_only.generators)} generators, watch lists and representative map "
          f"included); constants-sigmas commitment {commit_s:.3f} s (first call, the "
          f"build-time work); its cap equals the file's verifier cap: "
          f"{cap == verifier_only.constants_sigmas_cap}")
    if cap != verifier_only.constants_sigmas_cap:
        failures.append("the middle circuit's constants-sigmas cap is not the file's")
    witness, public_inputs, pi_hash = tp.random_witness(common, SEED)
    witness_dev = g.tensor(witness, dev)  # the prove's input, already on the card

    def middle_prove(timing=None, defer=False):
        return tp.prove(prover_only, common, None, device=dev, timing=timing, _defer=defer,
                        _prepared=(witness_dev, public_inputs, pi_hash))

    def pinned(proof_bytes, what):
        digest = hashlib.sha256(proof_bytes).hexdigest()
        if digest != MIDDLE_PROVE_SHA256:
            failures.append(f"{what}: the middle proof's sha256 is {digest}, "
                            f"not {MIDDLE_PROVE_SHA256}")
        return digest

    # the main path: the fused transcript (the default prove); the host path
    # beside it under force_host_path(). Per path: a warm-up, MIDDLE_PROVES
    # proves timed end to end with no synchronised phase (launch counts set
    # to 0 just before each and read just after), then MIDDLE_PROVES proves
    # with the device synchronised at each phase's start and end for the
    # phase split. The fused warm-up records K5's device-grind inputs.
    grind_inputs = []
    grind_device = kp.grind_device

    def recording_grind(state, pending, pow_bits):
        grind_inputs.append((state.clone(), pending.clone(), pow_bits))
        return grind_device(state, pending, pow_bits)

    paths = {}
    for path in ("fused", "host"):
        def force(path=path):
            return fri_prover.force_host_path() if path == "host" else contextlib.nullcontext()

        with force():
            t0 = time.perf_counter()
            if path == "fused":
                kp.grind_device = recording_grind
            try:
                pinned(proof_to_bytes(middle_prove()), f"{path} warm-up")
            finally:
                kp.grind_device = grind_device
            torch.cuda.synchronize()
            warmup_s = time.perf_counter() - t0
            walls = []
            for _ in range(MIDDLE_PROVES):
                ops.reset_launches()
                t0 = time.perf_counter()
                proof = proof_to_bytes(middle_prove())
                walls.append(time.perf_counter() - t0)
                launches = ops.launch_counts()
                duplexes = ops.K5.batch1
                digest = pinned(proof, path)
                if tp._LAST_TRANSCRIPT != path:
                    failures.append(f"the {path} prove took the {tp._LAST_TRANSCRIPT} path")
            splits = []
            for _ in range(MIDDLE_PROVES):
                timing = TimingTree("prove", sync=torch.cuda.synchronize)
                t0 = time.perf_counter()
                pinned(proof_to_bytes(middle_prove(timing)), f"{path} synchronised")
                torch.cuda.synchronize()
                splits.append((time.perf_counter() - t0, timing.split()))
        wall_s = statistics.median(walls)
        sync_wall = statistics.median(w for w, _ in splits)
        split = {k: statistics.median(sp[k] for _, sp in splits) for k in splits[0][1]}
        paths[path] = dict(wall_s=wall_s, walls=walls, launches=launches, duplexes=duplexes,
                           split=split, sync_wall_s=sync_wall)
        print(f"middle prove, {path} path (2^13, 135 wires, 12 gates, Q = 2^16): "
              f"{wall_s:.4f} s median wall of {[round(x, 4) for x in walls]}, no phase "
              f"synchronised (warm-up {warmup_s:.3f} s), {len(proof)} proof bytes, sha256 "
              f"{digest}, launches {launches} (K5 permutes on one state, the transcript's "
              f"duplexes: {duplexes})")
        print(f"middle prove phases, {path} path, median s, the device synchronised at each "
              f"phase's start and end ({sync_wall:.4f} s median wall): "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; outside the phases {sync_wall - sum(split.values()):.4f}")
        must = ("K2", "K3", "K4") + (("K5 poseidon_permute", "K5 poseidon_grind_device")
                                     if path == "fused" else ("K5 poseidon_grind_chunk",))
        for label, n in launches.items():
            if n == 0 and (label.split()[0] in must or label in must):
                failures.append(f"{label} was not launched on the {path} middle prove")
        if path == "fused" and launches[ops.K5_DEVICE.label] != 1:
            failures.append("K5's device grind did not launch once on the fused prove")
        if path == "fused":  # the host path's profile: PERF.md §5 (PR 8)
            profile_line(torch, lambda: middle_prove(), wall_s, f"middle prove ({path})")
    prove_s = paths["fused"]["wall_s"]

    # host synchronisations: one warm prove per path under
    # set_sync_debug_mode("warn"), every warning counted; then the fused
    # prove(_defer=True) under "error" must raise nothing
    def count_syncs(run):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the mode's own notice that it is a prototype is not a synchronisation
        syncs = [w for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        where = {}
        for w in syncs:
            key = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
        return out, len(syncs), where

    finish, fused_syncs, fused_where = count_syncs(lambda: middle_prove(defer=True))
    proof, fetch_syncs, _ = count_syncs(lambda: proof_to_bytes(finish()))
    pinned(proof, "fused deferred prove")
    with fri_prover.force_host_path():
        proof, host_syncs, host_where = count_syncs(lambda: proof_to_bytes(middle_prove()))
    pinned(proof, "host prove under the sync count")
    top = sorted(host_where.items(), key=lambda kv: -kv[1])[:6]
    print(f"host synchronisations (set_sync_debug_mode warn, one warm middle prove): fused "
          f"path {fused_syncs} before its fetch, {fetch_syncs} in finish(); host path "
          f"{host_syncs} (most at {top})")
    if fused_syncs:
        failures.append(f"the fused prove synchronised {fused_syncs} times: {fused_where}")
    if not host_syncs or not fetch_syncs:  # the host path reads every cap back
        failures.append("the sync count saw no synchronisation where one must be")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = middle_prove(defer=True)
    except RuntimeError as e:
        finish = None
        failures.append(f"the fused prove(_defer=True) synchronised under 'error': {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if finish is not None:
        pinned(proof_to_bytes(finish()), "fused prove under 'error'")
        print("fused prove(_defer=True) under set_sync_debug_mode('error'): raised nothing")

    # the headline: bench.py's warm-start work, from the inner proof to the
    # middle proof. The inner proof and its verifier data fill the proof
    # and verifier-data targets rebuilt on a fresh builder; each prove runs
    # the witness phase (the native plan) and the device chain, the rng
    # seeded to 2026 before it, so every witness and proof is the pinned one.
    t0 = time.perf_counter()
    inner_vo, inner_common = verifier_data_from_bytes(read("bench_cache", "inner14.verifier.bin"))
    read_vd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inner_proof = proof_from_bytes(read("bench_cache", "inner14.proof.bin"), inner_common)
    read_proof_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    builder = CircuitBuilder()
    proof_t = rv.add_virtual_proof_with_pis(builder, inner_common)
    vd_t = rv.add_virtual_verifier_data(builder, inner_common.config.fri_config.cap_height)
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, inner_proof)
    rv.set_verifier_data_target(pw, vd_t, inner_vo)
    targets_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.library()
    native_s = time.perf_counter() - t0
    print(f"headline inputs ({card}): inner verifier data read in {read_vd_s:.4f} s, inner "
          f"proof in {read_proof_s:.4f} s, {len(pw.target_values)} targets rebuilt and filled "
          f"in {targets_s:.4f} s; the native witness executor built and loaded in "
          f"{native_s:.1f} s")

    def seeded(run):
        prover_rng.seed(SEED)
        try:
            return run()
        finally:
            prover_rng.seed(None)

    def headline_pinned(proof_bytes, what):
        digest = hashlib.sha256(proof_bytes).hexdigest()
        if digest != HEADLINE_PROOF_SHA256:
            failures.append(f"{what}: the headline proof's sha256 is {digest}, "
                            f"not {HEADLINE_PROOF_SHA256}")
        return digest

    def witness_sha(w):
        return hashlib.sha256(np.ascontiguousarray(w, dtype=np.uint64).tobytes()).hexdigest()

    timing = TimingTree("prepare")
    t0 = time.perf_counter()
    prepared = seeded(lambda: tp.prepare_witness(prover_only, common, pw, timing))
    first_prepare_s = time.perf_counter() - t0
    if witness_sha(prepared[0]) != HEADLINE_WITNESS_SHA256:
        failures.append(f"the headline's full witness sha256 is {witness_sha(prepared[0])}, "
                        f"not {HEADLINE_WITNESS_SHA256}")
    plan = prover_only.cache("host")["witness_plan"]
    print(f"headline witness phase, first call ({card}): {first_prepare_s:.3f} s (the level "
          f"schedule and the plan's compilation, once a circuit, included), "
          f"{len(plan.opcodes)} native ops in {len(plan.segments)} segments; generators run "
          f"in Python: {plan.fallbacks or 'none'}; full witness sha256 "
          f"{witness_sha(prepared[0])}")
    if plan.fallbacks:
        failures.append(f"generators without a native opcode: {plan.fallbacks}")

    def headline_prove(timing=None):
        return proof_to_bytes(seeded(lambda: tp.prove(prover_only, common, pw, device=dev,
                                                      timing=timing)))

    headline_bytes = headline_prove()
    headline_pinned(headline_bytes, "headline warm-up")
    t0 = time.perf_counter()
    try:
        verify(proof_from_bytes(headline_bytes, common), verifier_only, common)
    except ValueError as e:
        failures.append(f"the port's verifier rejects the headline proof: {e}")
    native_lines["headline"] = native_verify(
        card, failures, "headline proof", [],
        [verifier_data_to_bytes(verifier_only, common), headline_bytes],
        time.perf_counter() - t0)
    # each timed headline prove is paired with the random-witness fused
    # prove, from its witness on the card and from the host matrix (its
    # pinned upload), so that a drift of the shared host's load shows in
    # all three
    walls, prepare_walls, paired = [], [], {"card witness": [], "host witness": []}
    host_prepared = (witness, public_inputs, pi_hash)
    for _ in range(HEADLINE_PROVES):
        timing = TimingTree("prove")
        ops.reset_launches()
        t0 = time.perf_counter()
        proof = headline_prove(timing)
        walls.append(time.perf_counter() - t0)
        headline_launches = ops.launch_counts()
        headline_duplexes = ops.K5.batch1
        headline_digest = headline_pinned(proof, "headline")
        prepare_walls.append(sum(timing.split()[k] for k in ("generate partial witness",
                                                              "compute full witness")))
        if tp._LAST_TRANSCRIPT != "fused":
            failures.append(f"the headline prove took the {tp._LAST_TRANSCRIPT} path")
        for key, prep in (("card witness", None), ("host witness", host_prepared)):
            t0 = time.perf_counter()
            proof = proof_to_bytes(middle_prove() if prep is None else tp.prove(
                prover_only, common, None, device=dev, _prepared=prep))
            paired[key].append(time.perf_counter() - t0)
            pinned(proof, f"random-witness prove paired with the headline ({key})")
    splits = []
    for _ in range(HEADLINE_PROVES):
        timing = TimingTree("prove", sync=torch.cuda.synchronize)
        t0 = time.perf_counter()
        headline_pinned(headline_prove(timing), "headline synchronised")
        torch.cuda.synchronize()
        splits.append((time.perf_counter() - t0, timing.split()))
    headline_split = {k: statistics.median(sp[k] for _, sp in splits) for k in splits[0][1]}
    headline_sync_wall = statistics.median(w for w, _ in splits)
    headline = dict(wall_s=statistics.median(walls), min_s=min(walls), walls=walls,
                    witness_s=statistics.median(prepare_walls), split=headline_split,
                    sync_wall_s=headline_sync_wall, launches=headline_launches,
                    duplexes=headline_duplexes,
                    paired_random_witness_s={k: statistics.median(v) for k, v in paired.items()})
    print(f"headline prove, witness + prove from the inner proof ({card}; 2^13, fused path): "
          f"{headline['wall_s']:.4f} s median, {headline['min_s']:.4f} s min of "
          f"{[round(x, 4) for x in walls]}, no phase synchronised; the witness phase "
          f"{headline['witness_s']:.4f} s median of {[round(x, 4) for x in prepare_walls]}; "
          f"sha256 {headline_digest}; launches {headline_launches} (K5 permutes on one state: "
          f"{headline_duplexes}); paired with each, the random-witness fused prove "
          + ", ".join(f"from the {k} {statistics.median(v):.4f} s median of "
                      f"{[round(x, 4) for x in v]}" for k, v in paired.items()))
    print(f"headline prove phases ({card}), median s, the device synchronised at each phase's "
          f"start and end ({headline_sync_wall:.4f} s median wall): "
          + ", ".join(f"{k} {v:.4f}" for k, v in headline_split.items())
          + f"; outside the phases {headline_sync_wall - sum(headline_split.values()):.4f}")
    for label, n in headline_launches.items():
        if n == 0 and label != ops.K5_CHUNK.label:  # the host path's grind
            failures.append(f"{label} was not launched on the headline prove")
    # the fused prove(_defer=True) from a host witness (its pinned upload)
    # under "error": nothing synchronises before the one fetch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = tp.prove(prover_only, common, None, device=dev, _defer=True,
                          _prepared=prepared)
    except RuntimeError as e:
        finish = None
        failures.append(f"the headline prove(_defer=True) synchronised under 'error': {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if finish is not None:
        headline_pinned(proof_to_bytes(finish()), "headline prove under 'error'")
        print("headline prove(_defer=True) from the prepared host witness under "
              "set_sync_debug_mode('error'): raised nothing")

    # the second headline: prove_many, K proofs of the same inputs, against
    # K sequential proves under the same seed sequence
    witnesses = seeded(lambda: [witness_sha(tp.prepare_witness(prover_only, common, pw)[0])
                                for _ in range(BATCH_K)])
    if len(set(witnesses)) != BATCH_K:
        failures.append("the batch's witnesses are not pairwise distinct")
    t0 = time.perf_counter()
    sequential = seeded(lambda: [proof_to_bytes(tp.prove(prover_only, common, pw, device=dev))
                                 for _ in range(BATCH_K)])
    sequential_s = time.perf_counter() - t0
    if hashlib.sha256(sequential[0]).hexdigest() != HEADLINE_PROOF_SHA256:
        failures.append("the first sequential proof is not the pinned headline proof")
    batched = {}
    for threads in (1, 2):  # 3 threads ran slower than 2 on every call (PERF.md §2)
        t0 = time.perf_counter()
        got = seeded(lambda: tp.prove_many(prover_only, common, [pw] * BATCH_K, device=dev,
                                           window=BATCH_WINDOW, threads=threads))
        dt = time.perf_counter() - t0
        same = [proof_to_bytes(p) for p in got] == sequential
        batched[threads] = dict(proofs_per_s=BATCH_K / dt, seconds=dt,
                                max_in_flight=tp._LAST_MAX_IN_FLIGHT, equal=same)
        if not same:
            failures.append(f"prove_many (threads {threads}) differs from the sequential proofs")
        if tp._LAST_MAX_IN_FLIGHT > BATCH_WINDOW:
            failures.append(f"prove_many (threads {threads}) had {tp._LAST_MAX_IN_FLIGHT} "
                            f"proofs in flight, more than the window {BATCH_WINDOW}")
    print(f"prove_many K={BATCH_K}, window {BATCH_WINDOW} ({card}): "
          + "; ".join(f"threads {t}: {v['proofs_per_s']:.3f} proofs/s ({v['seconds']:.2f} s), "
                      f"at most {v['max_in_flight']} in flight, proofs equal to the sequential: "
                      f"{v['equal']}" for t, v in batched.items())
          + f"; sequential prove calls {BATCH_K / sequential_s:.3f} proofs/s "
          f"({sequential_s:.2f} s); {len(set(witnesses))} distinct witnesses of {BATCH_K}")

    # the build phase: the port builds the bench_recursion inner circuit at
    # 2^14 itself (to the bytes of bench_cache/inner14.verifier.bin), proves
    # it under seed 2026 and verifies it, proves the middle circuit from
    # that proof and verifies the middle proof against the circuit file's
    # verifier data; each run with the counts set to 0 just before it and
    # read just after. Then the four examples, built, proved and verified
    # on the card to their fixtures' bytes.
    inner_vd_file = read("bench_cache", "inner14.verifier.bin")
    config14 = CircuitConfig.standard_recursion_config()
    builds = []
    for _ in range(1 + BUILD_REPEATS):  # the first build is cold
        timing = TimingTree("build", sync=torch.cuda.synchronize)
        ops.reset_launches()
        t0 = time.perf_counter()
        inner_data = br.dummy_circuit(config14, 14, device=dev, timing=timing)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0, timing.split()))
        build_launches = ops.launch_counts()
        inner_vd = verifier_data_to_bytes(inner_data.verifier_only, inner_data.common)
        if inner_vd != inner_vd_file:
            failures.append("the port-built inner circuit's verifier bytes are not "
                            "bench_cache/inner14.verifier.bin")
    build_wall, build_split, build_outside = median_run(builds[1:])
    print(f"inner circuit build (2^14, 8,193 noop gates; {card}): {build_wall:.4f} s median of "
          f"{[round(w, 4) for w, _ in builds[1:]]} (cold {builds[0][0]:.4f} s); verifier bytes "
          f"sha256 {hashlib.sha256(inner_vd).hexdigest()}, bench_cache/inner14.verifier.bin "
          f"sha256 {hashlib.sha256(inner_vd_file).hexdigest()}; the iFFT by the dispatch rule: "
          f"{inner_data.build_info['constants_sigmas_ifft']}; launches {build_launches}")
    for k, v in build_split.items():
        print(f"inner circuit build split, the median run ({card}): {k} {v:.4f} s")
    print(f"inner circuit build split, the median run ({card}): outside the scopes "
          f"{build_outside:.4f} s")
    for label in (ops.K3.label, ops.K4.label):
        if build_launches[label] == 0:
            failures.append(f"{label} was not launched in the inner circuit's build")

    def inner_prove(timing=None):
        return seeded(lambda: inner_data.prove(PartialWitness(), device=dev, timing=timing))

    def inner_pinned(proof_bytes, what):
        digest = hashlib.sha256(proof_bytes).hexdigest()
        if digest != INNER14_PROOF_SHA256:
            failures.append(f"{what}: the inner proof's sha256 is {digest}, not "
                            f"{INNER14_PROOF_SHA256}")
        return digest

    t0 = time.perf_counter()
    inner_proof_port = inner_prove()
    inner_first_s = time.perf_counter() - t0
    inner_bytes = proof_to_bytes(inner_proof_port)
    inner_digest = inner_pinned(inner_bytes, "inner prove, first call")
    inner_walls = []
    for _ in range(INNER_PROVES):
        ops.reset_launches()
        t0 = time.perf_counter()
        proof = proof_to_bytes(inner_prove())
        inner_walls.append(time.perf_counter() - t0)
        inner_launches = ops.launch_counts()
        inner_duplexes = ops.K5.batch1
        inner_pinned(proof, "inner prove")
        if tp._LAST_TRANSCRIPT != "fused":
            failures.append(f"the inner prove took the {tp._LAST_TRANSCRIPT} path")
    timing = TimingTree("prove", sync=torch.cuda.synchronize)
    inner_pinned(proof_to_bytes(inner_prove(timing)), "inner prove, synchronised")
    inner_split = timing.split()
    for label, n in inner_launches.items():
        if n == 0 and label != ops.K5_CHUNK.label:  # the host path's grind
            failures.append(f"{label} was not launched on the inner prove")
    t0 = time.perf_counter()
    try:
        inner_data.verify(inner_proof_port)
        inner_ok = True
    except ValueError as e:
        inner_ok = False
        failures.append(f"the port's verifier rejects the port's inner proof: {e}")
    inner_verify_s = time.perf_counter() - t0
    print(f"inner prove (2^14, fused path; {card}): {statistics.median(inner_walls):.4f} s median "
          f"of {[round(w, 4) for w in inner_walls]} (first call {inner_first_s:.3f} s), "
          f"{len(inner_bytes)} proof bytes, sha256 {inner_digest} (the reference's: "
          f"{INNER14_PROOF_SHA256}); launches {inner_launches} (K5 permutes on one state: "
          f"{inner_duplexes}); phases, synchronised: "
          + ", ".join(f"{k} {v:.4f}" for k, v in inner_split.items()))
    print(f"inner verify (the port's verifier, host; {card}): {inner_verify_s:.3f} s, "
          f"accepted: {inner_ok}")

    # the middle circuit's proof over the port's own inner proof
    builder = CircuitBuilder()
    proof_t = rv.add_virtual_proof_with_pis(builder, inner_data.common)
    vd_t = rv.add_virtual_verifier_data(builder, inner_data.common.config.fri_config.cap_height)
    pw_own = PartialWitness()
    rv.set_proof_with_pis_target(pw_own, proof_t, inner_proof_port)
    rv.set_verifier_data_target(pw_own, vd_t, inner_data.verifier_only)
    ops.reset_launches()
    t0 = time.perf_counter()
    middle_own = seeded(lambda: tp.prove(prover_only, common, pw_own, device=dev))
    middle_own_s = time.perf_counter() - t0
    middle_own_launches = ops.launch_counts()
    middle_own_bytes = proof_to_bytes(middle_own)
    middle_own_digest = hashlib.sha256(middle_own_bytes).hexdigest()
    if middle_own_digest != MIDDLE_OVER_INNER14_SHA256:
        failures.append(f"the middle proof over the port's inner proof is {middle_own_digest}, "
                        f"not {MIDDLE_OVER_INNER14_SHA256}")
    t0 = time.perf_counter()
    try:
        verify(proof_from_bytes(middle_own_bytes, common), verifier_only, common)
        middle_ok = True
    except ValueError as e:
        middle_ok = False
        failures.append(f"the port's verifier rejects the middle proof: {e}")
    middle_verify_s = time.perf_counter() - t0
    for label, n in middle_own_launches.items():
        if n == 0 and label != ops.K5_CHUNK.label:
            failures.append(f"{label} was not launched on the middle prove over the inner proof")
    print(f"middle prove over the port's inner proof (witness + fused prove; {card}): "
          f"{middle_own_s:.4f} s, sha256 {middle_own_digest} (the reference's: "
          f"{MIDDLE_OVER_INNER14_SHA256}); launches {middle_own_launches}; the port's verifier "
          f"against the circuit file's verifier data: {middle_verify_s:.3f} s, accepted: "
          f"{middle_ok}")

    # the recursion layers built by the port. The middle circuit over the
    # port's inner circuit (once cold, BUILD_REPEATS times timed) must be
    # bench_cache/middle14.circuit.bin, the headline's input, cap and digest
    # included; proved from the port's inner proof and verified. The outer
    # circuit over it (built once, timed), proved from that middle proof (a
    # first call and INNER_PROVES timed proves, each the
    # reference's outer proof) and verified. Each build and prove with the
    # counts set to 0 just before it and read just after.
    def accepted(data, proof, name) -> bool:
        try:
            data.verify(proof)
        except ValueError as e:
            failures.append(f"the port's verifier rejects the {name} proof: {e}")
            return False
        print(f"{name} proof: the port's verifier accepts it")
        return True

    def timed_build(build):
        timing = TimingTree("build", sync=torch.cuda.synchronize)
        ops.reset_launches()
        t0 = time.perf_counter()
        out = build(timing)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, timing.split(), ops.launch_counts()

    def layer_print(name, runs, cold_s, launches, data) -> dict:
        """Prints the median wall of the timed builds `runs` [(wall,
        split)] and that run's split; returns the split."""
        wall, split, outside = median_run(runs)
        print(f"{name} circuit build (degree 2^{data.common.degree_bits}, "
              f"{len(data.prover_only.generators)} generators; {card}): {wall:.4f} s the median "
              f"run of "
              f"{[round(w, 4) for w, _ in runs]} (cold {cold_s:.4f} s); the iFFT by the "
              f"dispatch rule: {data.build_info['constants_sigmas_ifft']}; launches {launches}")
        for k, v in split.items():
            print(f"{name} circuit build split, the median run ({card}): {k} {v:.4f} s")
        print(f"{name} circuit build split, the median run ({card}): outside the scopes "
              f"{outside:.4f} s")
        for label in (ops.K2.label, ops.K4.label):
            if launches[label] == 0:
                failures.append(f"{label} was not launched in the {name} circuit's build")
        return split

    middle_builds = []
    for _ in range(1 + BUILD_REPEATS):  # the first build is cold
        (mid_data, mid_pt, mid_vdt), wall, split, middle_build_launches = timed_build(
            lambda timing: br.recursion_circuit(inner_data.common, config14, device=dev,
                                                timing=timing))
        middle_builds.append((wall, split))
        differ = circuit_differences(mid_data, prover_only, common, verifier_only)
        if differ:
            failures.append(f"the port-built middle circuit differs from "
                            f"bench_cache/middle14.circuit.bin in: {differ}")
    middle_build_split = layer_print("middle", middle_builds[1:], middle_builds[0][0],
                                     middle_build_launches, mid_data)
    print(f"middle circuit built by the port = bench_cache/middle14.circuit.bin (common data, "
          f"constants-sigmas coefficients, sigmas, generators, watch lists, public inputs, "
          f"representative map, cap and digest): {not differ}")
    middle_inner = (inner_proof_port, inner_data.verifier_only, inner_data.common)
    middle_pw = br.recursion_inputs(mid_pt, mid_vdt, middle_inner)

    def middle_built_pinned(proof, what):
        digest = hashlib.sha256(proof_to_bytes(proof)).hexdigest()
        if digest != MIDDLE_OVER_INNER14_SHA256:
            failures.append(f"{what}: the port-built middle circuit's proof is {digest}, not "
                            f"{MIDDLE_OVER_INNER14_SHA256}")
        return digest

    t0 = time.perf_counter()
    middle_built_proof = seeded(lambda: mid_data.prove(middle_pw, device=dev))
    middle_built_first_s = time.perf_counter() - t0
    middle_built_pinned(middle_built_proof, "middle prove on the built circuit, first call")
    middle_built_walls = []
    for _ in range(INNER_PROVES):
        ops.reset_launches()
        t0 = time.perf_counter()
        proof = seeded(lambda: mid_data.prove(middle_pw, device=dev))
        middle_built_walls.append(time.perf_counter() - t0)
        middle_built_launches = ops.launch_counts()
        middle_built_digest = middle_built_pinned(proof, "middle prove on the built circuit")
    middle_built_s = statistics.median(middle_built_walls)
    accepted(mid_data, middle_built_proof, "middle")
    print(f"middle prove on the port-built circuit (witness + fused prove from the port's inner "
          f"proof; {card}): {middle_built_s:.4f} s median of "
          f"{[round(w, 4) for w in middle_built_walls]} (first call {middle_built_first_s:.3f} s: "
          f"the witness plan's compilation included), sha256 {middle_built_digest}; launches "
          f"{middle_built_launches}")

    (outer_data, outer_pt, outer_vdt), outer_build_s, outer_build_split, \
        outer_build_launches = timed_build(
            lambda timing: br.recursion_circuit(mid_data.common, config14, device=dev,
                                                timing=timing))
    layer_print("outer", [(outer_build_s, outer_build_split)], outer_build_s,
                outer_build_launches, outer_data)
    outer_vd = verifier_data_to_bytes(outer_data.verifier_only, outer_data.common)
    if hashlib.sha256(outer_vd).hexdigest() != OUTER_VERIFIER_SHA256:
        failures.append("the outer circuit's verifier bytes are not the reference's")
    outer_pw = br.recursion_inputs(outer_pt, outer_vdt, (middle_built_proof,
                                                         mid_data.verifier_only,
                                                         mid_data.common))

    def outer_prove(timing=None):
        return seeded(lambda: outer_data.prove(outer_pw, device=dev, timing=timing))

    def outer_pinned(proof, what):
        digest = hashlib.sha256(proof_to_bytes(proof)).hexdigest()
        if digest != OUTER_OVER_INNER14_SHA256:
            failures.append(f"{what}: the outer proof's sha256 is {digest}, not "
                            f"{OUTER_OVER_INNER14_SHA256}")
        return digest

    t0 = time.perf_counter()
    outer_proof = outer_prove()
    outer_first_s = time.perf_counter() - t0
    outer_pinned(outer_proof, "outer prove, first call")
    outer_walls = []
    for _ in range(INNER_PROVES):
        ops.reset_launches()
        t0 = time.perf_counter()
        proof = outer_prove()
        outer_walls.append(time.perf_counter() - t0)
        outer_launches = ops.launch_counts()
        outer_duplexes = ops.K5.batch1
        outer_digest = outer_pinned(proof, "outer prove")
        if tp._LAST_TRANSCRIPT != "fused":
            failures.append(f"the outer prove took the {tp._LAST_TRANSCRIPT} path")
    timing = TimingTree("prove", sync=torch.cuda.synchronize)
    outer_pinned(outer_prove(timing), "outer prove, synchronised")
    outer_split = timing.split()
    for label, n in outer_launches.items():
        if n == 0 and label != ops.K5_CHUNK.label:  # the host path's grind
            failures.append(f"{label} was not launched on the outer prove")
    outer_plan = outer_data.prover_only.cache("host").get("witness_plan")
    outer_fallbacks = "all (the worklist ran)" if outer_plan is None else outer_plan.fallbacks
    if outer_fallbacks:
        failures.append(f"the outer circuit's generators without a native opcode: "
                        f"{outer_fallbacks}")
    t0 = time.perf_counter()
    outer_ok = accepted(outer_data, outer_proof, "outer")
    outer_verify_s = time.perf_counter() - t0
    print(f"outer prove (witness + fused prove from the middle proof; {card}): "
          f"{statistics.median(outer_walls):.4f} s median of "
          f"{[round(w, 4) for w in outer_walls]} (first call {outer_first_s:.3f} s), sha256 "
          f"{outer_digest} (the reference's: {OUTER_OVER_INNER14_SHA256}); launches "
          f"{outer_launches} (K5 permutes on one state: {outer_duplexes}); generators run in "
          f"Python: {outer_fallbacks or 'none'}; phases, "
          f"synchronised: " + ", ".join(f"{k} {v:.4f}" for k, v in outer_split.items()))
    print(f"outer verify (the port's verifier, host; {card}): {outer_verify_s:.3f} s, "
          f"accepted: {outer_ok}")
    # no profile: the outer circuit has the middle's gates and degree, profiled above

    # the fixture chain: inner 2^4, middle and outer, all built by the port
    t0 = time.perf_counter()
    chain4 = seeded(lambda: br.chain(4, device=dev))
    chain4_s = time.perf_counter() - t0
    chain4_proof, chain4_data = chain4[-1].proof, chain4[-1].data
    chain4_same = (proof_to_bytes(chain4_proof) == read("fixtures", "bench_recursion.proof.bin"),
                   verifier_data_to_bytes(chain4_data.verifier_only, chain4_data.common)
                   == read("fixtures", "bench_recursion.verifier.bin"))
    print(f"fixture chain (inner 2^4 -> middle -> outer, built, proved and verified; {card}): "
          f"{chain4_s:.3f} s (first calls), degrees "
          f"{[layer.data.common.degree_bits for layer in chain4]}; outer proof = "
          f"fixtures/bench_recursion.proof.bin: {chain4_same[0]}, verifier bytes = "
          f"fixtures/bench_recursion.verifier.bin: {chain4_same[1]}")
    if not all(chain4_same):
        failures.append("the fixture chain's outer proof or verifier bytes are not the fixture's")

    # the four examples: build, prove (seed 2026) and verify on the card
    examples = {}
    for name, module in (("factorial", factorial), ("fibonacci", fibonacci),
                         ("range_check", range_check), ("square_root", square_root)):
        ops.reset_launches()
        t0 = time.perf_counter()
        data, proof = seeded(lambda: module.build_and_prove(device=dev))[:2]
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        same_vd = verifier_data_to_bytes(data.verifier_only, data.common) == read(
            "fixtures", f"{name}.verifier.bin")
        same_proof = proof_to_bytes(proof) == read("fixtures", f"{name}.proof.bin")
        try:
            data.verify(proof)
            accepted = True
        except ValueError:
            accepted = False
        host_cache = data.prover_only.cache("host")
        plan = host_cache["last_plan"]
        engine = ("the worklist" if plan is None else
                  f"the native plan{'' if host_cache['levels'] else ' given the inputs'}, "
                  f"generators run in Python: {plan.fallbacks or 'none'}")
        examples[name] = dict(wall_s=wall, verifier_bytes=same_vd, proof=same_proof,
                              accepted=accepted, launches=launches)
        print(f"example {name} ({card}): built and proved in {wall:.3f} s (first calls), "
              f"verifier bytes = fixture: {same_vd}, proof = fixture: {same_proof}, verified: "
              f"{accepted}; the witness on {engine}; launches {launches}")
        if not (same_vd and same_proof and accepted):
            failures.append(f"the example {name} did not build, prove and verify to its "
                            "fixture")
    # the Starky prover: the fixtures, FibonacciStark and LookupTestStark at
    # 2^STARKY_LOG_ROWS rows, and the new kernel shapes of its path
    starky = starky_phase(torch, dev, card, failures, root)
    # the IVC hash chain: the fixpoint, the cyclic circuit, the base proof
    # and CYCLIC_LAYERS self-verifying layers
    cyclic = cyclic_phase(torch, dev, card, failures)
    # the Keccak config: keccak_factorial, and the headline proof wrapped in
    # a Keccak-transcript proof
    keccak = keccak_phase(torch, dev, card, failures, (prover_only, common, verifier_only),
                          headline_bytes)
    # the chain at inner 2^18 (ExponentiationGate rows in the middle layer),
    # then the chain under the zero-knowledge config
    sizes = sizes_phase(torch, dev, card, failures)
    zk = zk_phase(torch, dev, card, failures)
    # the chains over the two lookup inner circuits
    lookups = lookups_phase(torch, dev, card, failures)
    # batch FRI at 2^20, 2^16, 2^12; the 2^20 Starky proofs verified in
    # circuits, and the variable-degree wrap
    batch_fri = batch_fri_phase(torch, dev, card, failures)
    stark_wrap = stark_recursion_phase(torch, dev, card, failures, starky.pop("proofs"))
    # three STARK tables linked by cross-table lookups, proved under one
    # transcript, verified on the host and in one circuit
    ctl = ctl_phase(torch, dev, card, failures)
    # the Keccak-hashed Starky at 2^STARKY_LOG_ROWS rows, and one circuit
    # over the builder's whole gadget surface
    stark_keccak = stark_keccak_phase(torch, dev, card, failures)
    gadgets_out = gadgets_phase(torch, dev, card, failures)
    native_lines.update(keccak_wrap=keccak["native"], ctl_circuit=ctl["circuit"]["native"],
                        starky_fibonacci20=starky["native"], gadgets=gadgets_out["native"])

    build_phase = dict(build_wall_s=build_wall, build_cold_s=builds[0][0],
                       build_outside_s=build_outside,
                       build_split=build_split, build_launches=build_launches,
                       inner_prove_s=statistics.median(inner_walls),
                       inner_prove_walls=inner_walls, inner_split=inner_split,
                       inner_launches=inner_launches, inner_verify_s=inner_verify_s,
                       inner_sha256=inner_digest, middle_over_inner_s=middle_own_s,
                       middle_over_inner_sha256=middle_own_digest,
                       middle_verify_s=middle_verify_s, examples=examples,
                       middle_build_s=statistics.median(w for w, _ in middle_builds[1:]),
                       middle_build_cold_s=middle_builds[0][0],
                       middle_build_split=middle_build_split,
                       middle_build_launches=middle_build_launches,
                       middle_built_prove_s=middle_built_s,
                       middle_built_prove_walls=middle_built_walls,
                       middle_built_first_s=middle_built_first_s, outer_build_s=outer_build_s,
                       outer_build_split=outer_build_split,
                       outer_build_launches=outer_build_launches,
                       outer_prove_s=statistics.median(outer_walls),
                       outer_prove_walls=outer_walls, outer_split=outer_split,
                       outer_launches=outer_launches, outer_sha256=outer_digest,
                       outer_verify_s=outer_verify_s, chain4_s=chain4_s)

    # commit_and_open at the middle-circuit shapes
    config = co.middle_fri_config()
    inputs = co.random_inputs(co.MIDDLE_DEGREE_BITS, co.MIDDLE_COUNTS, seed=SEED)
    t0 = time.perf_counter()
    first = co.commit_and_open(inputs, config, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # the host's clock spreads widely on a shared host: several warm runs,
    # each with the counts set to 0 just before and read just after
    walls = []
    for _ in range(MIDDLE_RUNS):
        ops.reset_launches()
        t0 = time.perf_counter()
        proof = co.commit_and_open(inputs, config, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        if proof != first:
            failures.append("two middle-shape runs gave different proof bytes")
    wall_s = statistics.median(walls)
    print(f"commit_and_open middle (2^13; 85/135/20/16): {wall_s:.3f} s median of "
          f"{[round(w, 3) for w in walls]} (first call {first_s:.3f} s), {len(proof)} proof "
          f"bytes, sha256 {hashlib.sha256(proof).hexdigest()}, launches {launches}")
    if not hashlib.sha256(proof).hexdigest().startswith(MIDDLE_SHA256):
        failures.append(f"the middle-shape proof's sha256 is not {MIDDLE_SHA256}...")
    if fri_prover._LAST_PATH != "fused":
        failures.append("commit_and_open's FRI proof did not take the fused path")
    for label, n in launches.items():
        if n == 0 and label != ops.K5_CHUNK.label:  # the host path's grind
            failures.append(f"{label} was not launched on commit_and_open")
    profile_line(torch, lambda: co.commit_and_open(inputs, config, device=dev), wall_s,
                 "commit_and_open")

    # K2 at the main path's shapes: the 135-poly coset LDE (2^13 -> 2^16,
    # 8 cosets, fused scale + cluster epilogue), the iFFT, the zero tail
    gen = fs.MULTIPLICATIVE_GROUP_GENERATOR
    x = rand((135, 1 << 13))
    table = ntt._lde_coset_scale_table(gen, 13, 3, str(dev))
    small = rand((2, 1 << 5))
    tail = ntt.shift_powers(gen, 32, dev).reshape(1, 32)
    lde = (lambda: kn.ntt_rows(x, scale=table, fan=8),
           lambda: kn.ntt_rows_plain(x, scale=table, fan=8))
    rows = 135 * 8
    check(ops.K2, [("LDE [135, 2^13] x8", *lde),
                   ("iFFT [135, 2^13]", lambda: kn.ntt_rows(x, inverse=True),
                    lambda: kn.ntt_rows_plain(x, inverse=True)),
                   ("zero-tail LDE [2, 2^5] x8",
                    lambda: kn.ntt_rows(small, scale=tail, repeat_bits=3),
                    lambda: kn.ntt_rows_plain(small, scale=tail, repeat_bits=3))],
          lde, n_bytes=8 * (x.numel() + table.numel() + rows * (1 << 13)),
          n_ops=OPS_PER_MODMUL * rows * ((1 << 12) * 13 + (1 << 13)))
    # every fan (2..8 cluster epilogue, 1 and 16 contiguous / strided) at
    # every size, both directions, and the zero-tail form
    k2_mism = 0
    for fan in (1, 2, 4, 8, 16):
        rate_bits = fan.bit_length() - 1
        n_fan = 0
        for lg_m in range(1, kn.MAX_SMEM_LG - rate_bits + 1):
            xf = rand((3, 1 << lg_m))
            tab = ntt._lde_coset_scale_table(gen, lg_m, rate_bits, str(dev)) if fan > 1 else None
            for inverse in (False, True):
                n_fan += compare(kn.ntt_rows(xf, inverse, tab, fan),
                                 kn.ntt_rows_plain(xf, inverse, tab, fan))[0]
        print(f"K2 fan {fan}, 2^1..2^{kn.MAX_SMEM_LG - rate_bits} points, forward and inverse: "
              f"{n_fan} mismatches")
        k2_mism += n_fan
    n_tail = 0
    # (points, rate bits, rows); [2, 2^8] and [2, 2^4] at rate 1 are the
    # re-LDEs of FRI's folds on a 2^20-row Starky prove
    for lg_m, rb, n_rows in ((1, 3, 3), (5, 3, 3), (6, 3, 3), (9, 4, 3), (3, 1, 3),
                             (8, 1, 2), (4, 1, 2)):
        xt = rand((n_rows, 1 << lg_m))
        sc = ntt.shift_powers(gen, 1 << lg_m, dev).reshape(1, -1)
        for inverse in (False, True):
            n_tail += compare(kn.ntt_rows(xt, inverse, sc, 1, rb),
                              kn.ntt_rows_plain(xt, inverse, sc, 1, rb))[0]
    print(f"K2 zero-tail forms: {n_tail} mismatches")
    if k2_mism + n_tail:
        failures.append("K2 disagrees with its plain version at some fan, size or zero tail")

    # K3: every size 2^14..2^20 (odd and even splits), fans 1, 2 and 8,
    # batch 1 and 2, both directions, and batch 16 at 2^16
    k3_mism = 0
    for lg in range(14, 21):
        n_lg = 0
        for fan in (1, 2, 8):
            tab = (ntt._lde_coset_scale_table(gen, lg, fan.bit_length() - 1, str(dev))
                   if fan > 1 else None)
            for batch in (1, 2):
                xk = rand((batch, 1 << lg))
                for inverse in (False, True):
                    n_lg += compare(kn.ntt_four_step(xk, inverse, tab, fan),
                                    kn.ntt_four_step_plain(xk, inverse, tab, fan))[0]
        print(f"K3 2^{lg} points, fans 1/2/8, batch 1/2, forward and inverse: "
              f"{n_lg} mismatches")
        k3_mism += n_lg
    if k3_mism:
        failures.append("K3 disagrees with its plain version at some size, fan or batch")
    times = kernel_times(torch, dev, kn, kp, build, ops.stream_ptr, wrapper=True)
    # the 2^16-point coset iFFTs of the quotient and of prove_openings (two
    # rows each), and [16, 2^16], which no path runs
    y = rand((2, 1 << 16))
    y16 = rand((16, 1 << 16))
    inv = (lambda: kn.ntt_four_step(y, inverse=True),
           lambda: kn.ntt_four_step_plain(y, inverse=True))

    def k3_bound(batch, lg=16):
        """(bytes, operations): input and output once each; n/2 lg n
        butterfly multiplies and n twiddle multiplies a row."""
        n = 1 << lg
        return 8 * 2 * batch * n, OPS_PER_MODMUL * batch * (n // 2 * lg + n)

    check(ops.K3, [("inverse [2, 2^16]", *inv),
                   ("forward [2, 2^16]", lambda: kn.ntt_four_step(y),
                    lambda: kn.ntt_four_step_plain(y)),
                   ("inverse [16, 2^16]", lambda: kn.ntt_four_step(y16, inverse=True),
                    lambda: kn.ntt_four_step_plain(y16, inverse=True))],
          inv, *k3_bound(2), ms=times["k3_inverse_2x2^16"])
    b16 = bound_ms(*k3_bound(16))
    b20 = bound_ms(*k3_bound(1, 20))
    results[ops.K3.label].update(ms_16x2_16=times["k3_inverse_16x2^16"], bound_ms_16x2_16=b16[0],
                         bound_by_16x2_16=b16[1], device_ms=times["k3_inverse_2x2^16_device"],
                         device_ms_16x2_16=times["k3_inverse_16x2^16_device"],
                         ms_1x2_20=times["k3_inverse_1x2^20"],
                         device_ms_1x2_20=times["k3_inverse_1x2^20_device"],
                         bound_ms_1x2_20=b20[0], bound_by_1x2_20=b20[1])
    print(f"K3 inverse [16, 2^16]: {times['k3_inverse_16x2^16']:.4f} ms kernel, "
          f"bound {b16[0]:.4f} ms ({b16[1]}); inverse [1, 2^20]: "
          f"{times['k3_inverse_1x2^20']:.4f} ms, bound {b20[0]:.4f} ms ({b20[1]}); "
          f"profiler device time a call "
          f"{times['k3_inverse_2x2^16_device']} ms at [2, 2^16], "
          f"{times['k3_inverse_16x2^16_device']} ms at [16, 2^16], "
          f"{times['k3_inverse_1x2^20_device']} ms at [1, 2^20]")
    if k3_mism:
        results[ops.K3.label]["mismatches"] += k3_mism

    # K4: the 135-wide leaf step over 2^16 leaves (the wires leaves),
    # then whole trees level by level against the plain per-level tree
    cols = rand((135, 1 << 16))
    leaf = (lambda: kp.sponge(cols), lambda: kp.sponge_plain(cols))
    check(ops.K4, [("leaf step width 135 x 2^16", *leaf)],
          leaf, n_bytes=8 * (cols.numel() + 4 * (1 << 16)),
          n_ops=OPS_PER_PERMUTATION * 17 * (1 << 16))

    def tree_check(label, leaves, cap_height, natural):
        want = kp.merkle_tree_plain(leaves, cap_height, natural)
        got = kp.merkle_tree(leaves, cap_height, natural)
        torch.cuda.synchronize()
        bad = int(len(got) != len(want)) + sum(compare(a, b)[0] for a, b in zip(got, want))
        print(f"K4 tree {label}, cap height {cap_height}: {len(want)} levels, {bad} mismatches")
        return bad

    k4_mism = tree_check("wires 135 x 2^16", cols, 4, True)
    k4_mism += tree_check("fold 2^14 x 8", rand((1 << 14, 8)), 4, False)
    k4_mism += tree_check("fold 2^12 x 32", rand((1 << 12, 32)), 4, False)
    k4_mism += tree_check("natural 20 x 2^10", rand((20, 1 << 10)), 10, True)
    k4_mism += tree_check("natural 20 x 2^10", rand((20, 1 << 10)), 0, True)
    k4_mism += tree_check("natural 3 x 2^12 (width <= 4)", rand((3, 1 << 12)), 2, True)
    k4_mism += tree_check("rows 2^12 x 4 (width <= 4)", rand((1 << 12, 4)), 0, False)
    if k4_mism:
        failures.append("a K4 tree disagrees with the plain per-level tree")
    n_wires = 1 << 16
    tree_words = kp.tree_words(n_wires, 12)
    tree_ms = time_ms(torch, lambda: kp.merkle_tree(cols, 4, True), reps=20, warmup=3)
    tree_plain_ms = time_ms(torch, lambda: kp.merkle_tree_plain(cols, 4, True), reps=1, warmup=0)
    tree_bound = bound_ms(8 * (cols.numel() + tree_words),
                          OPS_PER_PERMUTATION * (17 * n_wires + (n_wires - (n_wires >> 12))))
    print(f"K4 wires tree (135 x 2^16, cap height 4): {tree_ms:.4f} ms kernel, "
          f"{tree_plain_ms:.4f} ms plain, bound {tree_bound[0]:.4f} ms ({tree_bound[1]}), "
          f"{len(kp.tree_launches(16, 12, True))} launches")
    results[ops.K4.label].update(tree_ms=tree_ms, tree_plain_ms=tree_plain_ms,
                         tree_bound_ms=tree_bound[0], tree_bound_by=tree_bound[1])
    # each launch of the wires tree: the leaf launch, then the chain of levels
    lib = build.library("poseidon")
    buf = torch.empty(tree_words, dtype=torch.int64, device=dev)
    plan = kp.tree_launches(16, 12, True)
    per_launch = []
    for i, (k0, depth, states) in enumerate(plan):
        def one(i=i, k0=k0, depth=depth, states=states):
            build.check(lib.k4_tree(cols.data_ptr() if i == 0 else None, buf.data_ptr(),
                                    n_wires, 135, k0, depth, states, 1, ops.stream_ptr(cols)),
                        "k4_tree")
        per_launch.append(time_ms(torch, one, reps=10, warmup=2))
    print(f"K4 wires tree by launch (first level, levels, states a block): "
          f"{[(p, round(t, 4)) for p, t in zip(plan, per_launch)]} ms")

    # K5 in its three modes. The permutation: one state (the transcript's
    # duplex, the main path's shape), [12, 2^17] and edge states.
    one_state = rand((12, 1))
    states = rand((12, GRIND_CHUNK))
    p = fs.P
    edge = [[0] * 12, [p - 1] * 12, [(1 << 32) - 1] * 12, [1 << 63] * 12,
            [p - 1 if i % 2 else (1 << 32) - 1 for i in range(12)]]
    edge_states = g.tensor([[c[i] for c in edge] for i in range(12)], dev)
    duplex = (lambda: kp.permute(one_state), lambda: kp.permute_plain(one_state))
    check(ops.K5, [("permute [12, 1] (a duplex)", *duplex),
                   ("permute [12, 2^17]", lambda: kp.permute(states),
                    lambda: kp.permute_plain(states)),
                   ("permute edge states", lambda: kp.permute(edge_states),
                    lambda: kp.permute_plain(edge_states))],
          duplex, n_bytes=8 * 24, n_ops=OPS_PER_PERMUTATION,
          ms=time_ms(torch, duplex[0], reps=20, warmup=3, per=20))
    perm_bound = bound_ms(8 * 2 * states.numel(), OPS_PER_PERMUTATION * GRIND_CHUNK)
    results[ops.K5.label].update(permute_ms_12x2_17=times["k5_permute_12x2^17"],
                                 permute_bound_ms_12x2_17=perm_bound[0])

    # the host path's grind: chunks of 2^17 candidates where none passes, at
    # 1 bit and at 16 bits (the main path's)
    inter = [int(v) for v in rng.integers(0, fs.P, size=12, dtype=np.uint64)]

    def grind_pair(threshold):
        return (lambda: kp.grind_chunk(inter, 5, 0, GRIND_CHUNK, threshold, dev),
                lambda: kp.grind_chunk_plain(inter, 5, 0, GRIND_CHUNK, threshold, dev))

    if kp.grind_chunk(inter, 5, 0, GRIND_CHUNK, 0, dev) is not None:
        failures.append("K5 found a witness below threshold 0")
    grind = grind_pair(1 << 48)
    check(ops.K5_CHUNK, [("grind 2^17, no candidate passes", *grind_pair(0)),
                         ("grind 2^17 at 1 bit", *grind_pair(1 << 63)),
                         ("grind 2^17 at 16 bits", *grind)],
          grind, n_bytes=8 * 13, n_ops=OPS_PER_PERMUTATION * GRIND_CHUNK,
          ms=times["k5_grind_bare_none"])
    results[ops.K5_CHUNK.label].update(ms_16bits=times["k5_grind_bare_16bits"],
                                       device_ms=times["k5_grind_bare_none_device"],
                                       wrapper_ms_16bits=times["k5_grind_wrapper_16bits"])
    print(f"K5 bare grind launch 2^17: {times['k5_grind_bare_none']:.4f} ms where no candidate "
          f"passes (profiler device time {times['k5_grind_bare_none_device']} ms), "
          f"{times['k5_grind_bare_16bits']:.4f} ms at 16 bits; grind_chunk wrapper "
          f"{times['k5_grind_wrapper_16bits']:.4f} ms; permute [12, 2^17] "
          f"{times['k5_permute_12x2^17']:.4f} ms (bound {perm_bound[0]:.4f} ms); "
          f"{OPS_PER_PERMUTATION} operations a permutation in the bounds (the frequency-domain "
          f"MDS), {OPS_PER_PERMUTATION_DENSE} in the dense count")

    # the fused path's device grind: the seed-2026 middle transcript's state
    # and pending inputs (recorded at the fused warm-up) and random states,
    # at 0, 1, 8 and 16 bits, against the plain version; the middle state's
    # witness also against the chunk-by-chunk grind_chunk kernel
    if len(grind_inputs) != 1:
        failures.append(f"the fused warm-up ran {len(grind_inputs)} device grinds, not 1")
    mid_state, mid_pending, mid_bits = grind_inputs[0]
    cases = [("middle transcript", mid_state, mid_pending)]
    for k in (0, 3, 7):
        cases.append((f"random, {k} pending", rand((12,)), rand((k,))))
    pairs = []
    for label, st, pend in cases:
        for bits in (0, 1, 8, 16):
            pairs.append((f"{label}, {bits} bits",
                          lambda st=st, pend=pend, bits=bits: kp.grind_device(st, pend, bits),
                          lambda st=st, pend=pend, bits=bits: kp.grind_device_plain(
                              st, pend, bits, chunk=GRIND_CHUNK)))
    mid_witness = g.u64(int(kp.grind_device(mid_state, mid_pending, mid_bits)[0]))
    mid_inter = [int(v) for v in g.to_numpy(mid_state)]
    mid_inter[:mid_pending.shape[0]] = [int(v) for v in g.to_numpy(mid_pending)]
    start = 0
    while (chunked := kp.grind_chunk(mid_inter, int(mid_pending.shape[0]), start,
                                     GRIND_CHUNK, 1 << (64 - mid_bits), dev)) is None:
        start += GRIND_CHUNK
    print(f"K5 device grind on the middle transcript ({mid_bits} bits, "
          f"{int(mid_pending.shape[0])} pending): witness {mid_witness}, chunk by chunk "
          f"{chunked}")
    if chunked != mid_witness:
        failures.append("K5's device grind and the chunked grind found different witnesses")
    dev_grind = (lambda: kp.grind_device(mid_state, mid_pending, mid_bits),
                 lambda: kp.grind_device_plain(mid_state, mid_pending, mid_bits,
                                               chunk=GRIND_CHUNK))
    check(ops.K5_DEVICE, pairs, dev_grind, n_bytes=8 * (12 + int(mid_pending.shape[0]) + 1),
          n_ops=OPS_PER_PERMUTATION * (mid_witness + 1),
          ms=time_ms(torch, dev_grind[0], reps=10, warmup=2))
    grind_device_ms = device_ms(torch, dev_grind[0], "k5_grind_device", calls=10)
    results[ops.K5_DEVICE.label].update(device_ms=grind_device_ms, witness=mid_witness,
                                        pow_bits=mid_bits)
    print(f"K5 device grind, middle transcript: profiler device time {grind_device_ms} ms a "
          f"launch; the bound counts the witness's rank, {mid_witness + 1} permutations")

    # the build path's shapes: the constants-sigmas batch's iFFT and LDE x8
    # at [83, 2^14] (K3 by the dispatch rule: 2^14 points) and its Merkle
    # tree, width 83 over 2^17 leaves (K4), each against its plain version
    cs = rand((83, 1 << 14))
    table14 = ntt._lde_coset_scale_table(gen, 14, 3, str(dev))
    cs_lde = kn.ntt_four_step(cs, scale=table14, fan=8)
    n17 = 1 << 17
    cm = rand((85, 1 << 13))
    table13 = ntt._lde_coset_scale_table(gen, 13, 3, str(dev))
    cm_lde = kn.ntt_rows(cm, scale=table13, fan=8)
    n16 = 1 << 16
    shapes = [
        (ops.K3, "build_ifft_83x2_14", lambda: kn.ntt_four_step(cs, inverse=True),
         lambda: kn.ntt_four_step_plain(cs, inverse=True), *k3_bound(83, 14)),
        (ops.K3, "build_lde_83x2_14_x8", lambda: kn.ntt_four_step(cs, scale=table14, fan=8),
         lambda: kn.ntt_four_step_plain(cs, False, table14, 8),
         8 * (cs.numel() + table14.numel() + 8 * cs.numel()),
         OPS_PER_MODMUL * 83 * 8 * ((1 << 13) * 14 + (1 << 14))),
        (ops.K4, "build_tree_83x2_17", lambda: kp.merkle_tree(cs_lde, 4, True),
         lambda: kp.merkle_tree_plain(cs_lde, 4, True),
         8 * (cs_lde.numel() + kp.tree_words(n17, 13)),
         OPS_PER_PERMUTATION * (-(-83 // 8) * n17 + (n17 - (n17 >> 13)))),
        # the recursion layers' builds: [85, 2^13] (K2 by the dispatch rule)
        (ops.K2, "build_ifft_85x2_13", lambda: kn.ntt_rows(cm, True),
         lambda: kn.ntt_rows_plain(cm, True), 8 * 2 * cm.numel(),
         OPS_PER_MODMUL * 85 * ((1 << 12) * 13 + (1 << 13))),
        (ops.K2, "build_lde_85x2_13_x8", lambda: kn.ntt_rows(cm, scale=table13, fan=8),
         lambda: kn.ntt_rows_plain(cm, False, table13, 8),
         8 * (cm.numel() + table13.numel() + 8 * cm.numel()),
         OPS_PER_MODMUL * 85 * 8 * ((1 << 12) * 13 + (1 << 13))),
        (ops.K4, "build_tree_85x2_16", lambda: kp.merkle_tree(cm_lde, 4, True),
         lambda: kp.merkle_tree_plain(cm_lde, 4, True),
         8 * (cm_lde.numel() + kp.tree_words(n16, 12)),
         OPS_PER_PERMUTATION * (-(-85 // 8) * n16 + (n16 - (n16 >> 12)))),
    ]
    for kernel, key, run_k, run_p, n_bytes, n_ops in shapes:
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        if isinstance(got, (list, tuple)):  # a tree's levels
            mism = int(len(got) != len(want)) + sum(compare(a, b)[0] for a, b in zip(got, want))
        else:
            mism = compare(got, want)[0]
        ms = time_ms(torch, run_k, reps=10, warmup=2)
        plain_ms = time_ms(torch, run_p, reps=1, warmup=0)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        print(f"{kernel.label} {key}: {mism} mismatches; {ms:.4f} ms kernel, {plain_ms:.4f} ms "
              f"plain, bound {b_ms:.4f} ms ({b_by})")
        results[kernel.label][key] = dict(mismatches=mism, ms=ms, plain_ms=plain_ms,
                                          bound_ms=b_ms, bound_by=b_by)
        results[kernel.label]["mismatches"] += mism
        if mism:
            failures.append(f"{kernel.label} disagrees with its plain version at {key}")

    # kernels vs plain versions end to end at degree 2^10
    small_inputs = co.random_inputs(10, co.MIDDLE_COUNTS, seed=SEED + 1)
    on_card = co.commit_and_open(small_inputs, config, device=dev)
    t0 = time.perf_counter()
    with one_cpu_thread(torch):
        on_cpu = co.commit_and_open(small_inputs, config, device="cpu")
    cpu_s = time.perf_counter() - t0
    h_card = hashlib.sha256(on_card).hexdigest()
    h_cpu = hashlib.sha256(on_cpu).hexdigest()
    print(f"degree 2^10: card sha256 {h_card}, cpu sha256 {h_cpu} (cpu run {cpu_s:.1f} s)")
    if on_card != on_cpu:
        failures.append("degree-2^10 proof bytes differ between the card and the CPU")

    # the PLONK prove over a process group of one, NCCL, in this process
    parts = parts_check(torch, dev, card, failures)
    multigpu = multigpu_phase(torch, dev, card, failures, in_process=True)

    for phase in (starky, sizes, zk, lookups, batch_fri, ctl, stark_keccak):
        for label, shape_results in phase["shapes"].items():
            results[label].update(shape_results)
            results[label]["mismatches"] += sum(r["mismatches"] for r in shape_results.values())

    if failures:
        for f in failures:
            print(f"chip_smoke: {f}", file=sys.stderr)
        return 1

    kernels = []
    for k in ops.KERNELS:
        # launches: the headline prove's (the main path: witness + fused
        # prove from the inner proof); the host path's grind mode runs only
        # on the host path, so the host-path middle prove's
        host = k is ops.K5_CHUNK
        kernels.append({"name": k.label, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": (paths["host"]["launches"] if host
                                     else headline["launches"])[k.label],
                        "launches_on": "host-path middle prove" if host else "headline prove",
                        "launches_fused_middle_prove": paths["fused"]["launches"][k.label],
                        "launches_build_inner14": build_phase["build_launches"][k.label],
                        "launches_prove_inner14": build_phase["inner_launches"][k.label],
                        "launches_build_middle": build_phase["middle_build_launches"][k.label],
                        "launches_build_outer": build_phase["outer_build_launches"][k.label],
                        "launches_prove_outer": build_phase["outer_launches"][k.label],
                        "launches_prove_starky": starky["fibonacci"]["launches"][k.label],
                        "launches_prove_starky_lookup": starky["lookup"]["launches"][k.label],
                        "launches_build_cyclic": cyclic["build_launches"][k.label],
                        "launches_prove_cyclic_layer": cyclic["layers"][1]["launches"][k.label],
                        "launches_build_keccak_wrap": keccak["build_launches"][k.label],
                        "launches_prove_keccak_wrap": keccak["launches"][k.label],
                        "launches_build_inner18": sizes["layers"][0]["build_launches"][k.label],
                        "launches_prove_inner18": sizes["layers"][0]["launches"][k.label],
                        "launches_build_middle18": sizes["layers"][1]["build_launches"][k.label],
                        "launches_prove_middle18": sizes["layers"][1]["launches"][k.label],
                        "launches_build_zk_inner": zk["layers"][0]["build_launches"][k.label],
                        "launches_prove_zk_inner": zk["layers"][0]["launches"][k.label],
                        "launches_prove_zk_middle": zk["layers"][1]["launches"][k.label],
                        **{f"launches_{what}_lookup{t}_inner": lookups[f"lookup{t}"][0][key]
                           .get(k.label, 0) for t in (1, 2)
                           for what, key in (("build", "build_launches"),
                                             ("prove", "launches"))},
                        "launches_batch_fri": batch_fri["launches"][k.label],
                        "launches_stark_wrap20": stark_wrap["fibonacci"]["launches"][k.label],
                        "launches_stark_wrap_var": stark_wrap["variable"]["proofs"][
                            STARK_VAR[3]]["launches"][k.label],
                        "launches_prove_ctl": ctl["launches"][k.label],
                        "launches_build_ctl_wrap": ctl["circuit"]["build_launches"][k.label],
                        "launches_prove_ctl_wrap": ctl["circuit"]["launches"][k.label],
                        "launches_prove_stark_keccak20":
                            stark_keccak["fibonacci"]["launches"][k.label],
                        "launches_prove_stark_keccak20_lookup":
                            stark_keccak["lookup"]["launches"][k.label],
                        "launches_prove_gadgets": gadgets_out["launches"][k.label],
                        "launches_prove_multigpu": multigpu["launches"][k.label],
                        **results[k.label], "library_ms": None})
    print(json.dumps({"kernels": kernels, "card": card, "headline": headline,
                      "prove_many": {"K": BATCH_K, "window": BATCH_WINDOW, "threads": batched,
                                     "sequential_proofs_per_s": BATCH_K / sequential_s},
                      "middle_prove_s": prove_s,
                      "middle_prove": {p: {k: v[k] for k in ("wall_s", "sync_wall_s", "split",
                                                             "launches", "duplexes")}
                                       for p, v in paths.items()},
                      "syncs": {"fused_before_fetch": fused_syncs, "fused_finish": fetch_syncs,
                                "host": host_syncs},
                      "commit_and_open_middle_s": wall_s,
                      "build_phase": build_phase,
                      "starky": {k: v for k, v in starky.items() if k != "shapes"},
                      "cyclic": cyclic, "keccak": keccak,
                      "sizes": {k: v for k, v in sizes.items() if k != "shapes"},
                      "zk": {k: v for k, v in zk.items() if k != "shapes"},
                      "lookups": {k: v for k, v in lookups.items() if k != "shapes"},
                      "batch_fri": {k: v for k, v in batch_fri.items() if k != "shapes"},
                      "stark_recursion": stark_wrap,
                      "ctl": {k: v for k, v in ctl.items() if k != "shapes"},
                      "stark_keccak": {k: v for k, v in stark_keccak.items() if k != "shapes"},
                      "gadgets": gadgets_out, "native_verifier": native_lines,
                      "parts_check": parts,
                      "multigpu": {name: {k: m[k] for k in ("wall_s", "first_s", "collectives",
                                                            "collective_bytes", "launches",
                                                            "syncs_before_fetch")}
                                   for name, m in multigpu["cases"].items()}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


PHASES = {"batch_fri": batch_fri_phase, "stark_recursion": stark_recursion_phase,
          "ctl": ctl_phase, "stark_keccak": stark_keccak_phase, "gadgets": gadgets_phase,
          "parts": parts_check, "multigpu": multigpu_phase}


def phases_only(names: list, cases=None, world=None) -> int:
    """Only the named phases (of PHASES), after the kernels' build: a quick
    check of a new path on the card; `cases`, only those of the multigpu
    phase (of MULTIGPU_CASES); `world`, the multigpu phase's ranks (every
    card by default). Prints what each phase prints, then the failures;
    exits non-zero on any."""
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    if not names or any(n not in PHASES for n in names):
        return fail(f"usage: chip_smoke.py --phases {' '.join(PHASES)}")
    if cases is not None and ("multigpu" not in names or not cases
                              or any(c not in MULTIGPU_CASES for c in cases)):
        return fail(f"usage: chip_smoke.py --phases multigpu --cases "
                    f"{' '.join(repr(c) for c in MULTIGPU_CASES)}")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from plonky2_torch.ops import build

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    if not cards:
        return fail("nvidia-smi gave no card name and power limit")
    for i, line in enumerate(cards):  # every card's, one line each
        print(line if len(cards) == 1 else f"card {i}: {line}")
    card = cards[0]
    t0 = time.perf_counter()
    build.build_all()  # once, before any phase spawns its ranks
    print(f"build: {time.perf_counter() - t0:.1f} s")
    failures = []
    for name in names:
        if name == "multigpu":
            multigpu_phase(torch, torch.device("cuda"), card, failures,
                           names=None if cases is None else tuple(cases), world=world)
        else:
            PHASES[name](torch, torch.device("cuda"), card, failures)
    for f in failures:
        print(f"chip_smoke: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--times":
        sys.exit(times_only(sys.argv[2]))
    if len(sys.argv) >= 2 and sys.argv[1] == "--phases":
        args, world, cases = sys.argv[2:], None, None
        if "--cases" in args:
            i = args.index("--cases")
            args, cases = args[:i], args[i + 1:]
        if "--world" in args:
            i = args.index("--world")
            if i + 1 >= len(args) or not args[i + 1].isdigit() or "multigpu" not in args:
                sys.exit(fail("usage: chip_smoke.py --phases multigpu --world N"))
            world = int(args[i + 1])
            args = args[:i] + args[i + 2:]
        sys.exit(phases_only(args, cases, world))
    if len(sys.argv) != 1:
        sys.exit(fail("usage: chip_smoke.py [--times DIR | --phases NAME ... [--world N] "
                      "[--cases NAME ...]]"))
    sys.exit(main())
