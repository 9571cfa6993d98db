"""Multi-GPU proving: one process a card, explicit collectives over
`torch.distributed` (NCCL on the card, gloo on the CPU), the counterpart of
the reference's `plonky2_tpu/parallel/__init__.py`.

The reference places its inputs on a device mesh and lets XLA insert the
collectives (GSPMD). The port writes its SPMD out: every rank runs the
same Python on the same inputs, holds the same values wherever the layout
below says "whole", and exchanges the rest by the collectives of `Group`.
Under a group every prover path gives the single device's proof bytes on
every rank: the PLONK prove (both transcript paths, zero knowledge,
lookups and the Keccak config), `prove_many`, circuit builds, the Starky
prove (Poseidon or Keccak), the multi-table prove with its cross-table
lookups, and batch FRI. With no group active (`active_mesh()` is None)
every module runs its single-device path, launch for launch. The world is
any power of two; nothing else constrains it.

The layout. Only three things are held in part on each rank:

- the LDE values of each committed batch: rank r of k holds the
  natural-order LDE columns c = r (mod k), as [num_polys, N / k] with local
  column i the global column r + k i (`fri/oracle.py`). These are the
  points shift w_N^r w_(N/k)^i: a coset of the subgroup of order N / k, so
  the rank computes them alone (`ntt.coset_lde_part`): the LDE at rate
  rate_bits - lg k on that coset while k divides 2^rate_bits, and for
  k > 2^rate_bits (N / k < n points) the coefficients folded first, mod
  x^(N/k) - (shift w_N^r)^(N/k), which is a weighted sum of their n k / N
  slices, and then the plain NTT of N / k points;
- the Merkle tree below the cap: the natural tree pairs (j, j + (N >> l)),
  so digest j of level l covers the columns = j (mod N >> l), and rank r's
  columns form whole subtrees; its local natural tree over [width, N / k],
  cut at cap height cap_height - lg k, holds the global level-l digests
  r + k i (`hash/merkle.py` `ShardedMerkleTree`). Where k > 2^cap_height
  the k local roots are all-gathered and the top levels hashed whole. A
  Keccak tree hashes bit-reversed row leaves on the host: rank r's columns
  are the contiguous block rev_{lg k}(r) of N / k row leaves, so each rank
  hashes its own subtree on its own host core and only the k local caps
  (or roots) are all-gathered (`ShardedKeccakMerkleTree`);
- the quotient's points (`QuotientPoints`). The quotient is evaluated on
  the Q = n 2^qd_bits points shift w_Q^j, which are the LDE columns
  c = j step with step = 2^(rate_bits - qd_bits). Rank r holds such
  columns only if r = 0 (mod min(step, k)), and those ranks, the holders,
  evaluate their points: holder h of K = k / min(step, k) holds the
  points j = h (mod K), every (step / k)-th of its local columns (every
  one where step <= k). The next row, g x, is point j + 2^qd_bits: while
  K divides 2^qd_bits it lies on the same holder, 2^qd_bits / K local
  points on; otherwise on holder h + 2^qd_bits (mod K), which sends it
  in one all-to-all a batch where each holder moves its values to one
  other and every rank takes part (`Group.exchange`; NCCL runs it on the
  group's own communicator). The ranks that hold no point (with step > 1
  and k > 1) skip the evaluation and add zeros to the all-gather of the
  holders' values. The alternative,
  spreading the points evenly over the ranks, would first move every
  batch's quotient columns through an all-to-all; PERF.md records the
  choice.

Everything else is whole on every rank: the witness, the coefficients (an
iFFT from values runs poly-sharded and its coefficients are all-gathered),
round 2's values after their gather, the quotient values after their
gather, the logUp and CTL columns of a Starky, the openings, FRI, batch
FRI (run whole with the group suspended, as the reference runs it
unsharded), and the transcript. The reference gives its rank r' the
bit-reversed leaves [r' N / k, (r' + 1) N / k), which are the natural
columns whose low lg k bits are rev_{lg k}(r'): the same column sets, so
the port's rank r holds what the reference's rank rev_{lg k}(r) holds. The
cap is all-gathered and put in the reference's order; a query's leaf and
Merkle path lie on the rank that owns its natural column, which gathers
them into zeros, and one SUM all-reduce gives every rank every opening
exactly (each value is added to zeros only). No other field value passes
through a reducing collective: the integer SUM of NCCL and gloo wraps mod
2^64, not mod p, so field values are all-gathered and then reduced with
the field's own arithmetic.

The round-2 scans run over contiguous blocks of the n points (`shard_lanes`)
with a cross-rank carry (`field/goldilocks.py` `cumprod_across`).
`prove_many` under a group dispatches its proofs from one thread, so every
rank issues their collectives in the same order; with dispatch threads it
raises (their collectives would leave several threads at once).

Nothing falls back: a world that is not a power of two raises (GSPMD pads
such a world; this layout does not), a failed collective raises, and a
rank that fails fails `run_on_group`.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_module
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


class Collectives:
    """What this process's collectives moved since `reset`: their count and
    bytes (an all-gather's gathered output, an all-reduce's tensor)."""

    count = 0
    bytes = 0

    @classmethod
    def reset(cls) -> None:
        cls.count = 0
        cls.bytes = 0

    @classmethod
    def add(cls, t: torch.Tensor) -> None:
        cls.count += 1
        cls.bytes += t.numel() * t.element_size()


def _all_gather_flat(out, x) -> None:
    single = getattr(dist, "all_gather_single", None)  # newer torch's name
    if single is not None:
        single(out, x)
    else:
        dist.all_gather_into_tensor(out, x)


@dataclass
class Group:
    """The default process group of `world` ranks, one device a rank: this
    process is `rank` and works on `device`."""

    rank: int
    world: int
    device: torch.device

    @property
    def lg(self) -> int:
        return self.world.bit_length() - 1

    def all_gather(self, x):
        """[world, *x.shape]: every rank's x, in rank order."""
        x = x.contiguous()
        out = torch.empty((self.world * x.numel(),), dtype=x.dtype, device=x.device)
        _all_gather_flat(out, x.reshape(-1))
        Collectives.add(out)
        return out.reshape((self.world,) + tuple(x.shape))

    def all_reduce_disjoint(self, x):
        """The SUM over ranks of x where, at each position, at most one rank
        holds a nonzero value: exact, since each value is added to zeros
        only. Reduces x in place and returns it."""
        dist.all_reduce(x)
        Collectives.add(x)
        return x

    def exchange(self, x, send_to, recv_from):
        """Send x to rank `send_to` and return what rank `recv_from` sends
        (a tensor of x's shape). Every rank calls it, as one all-to-all
        whose other pairs move nothing; a rank outside the pairing passes
        x = None and gets None."""
        sends, recvs = [0] * self.world, [0] * self.world
        if x is None:
            send = out = torch.empty((0,), dtype=torch.int64, device=self.device)
        else:
            send = x.contiguous()
            out = torch.empty_like(send)
            sends[send_to] = recvs[recv_from] = send.numel()
        dist.all_to_all_single(out.reshape(-1), send.reshape(-1), recvs, sends)
        Collectives.add(out)
        return None if x is None else out


# -- the active group ----------------------------------------------------------

_ACTIVE: list = []


class use_mesh:
    """Context manager: run the prover's phases over `group` (None: the
    single-device path, also inside an outer group)."""

    def __init__(self, group: Group | None):
        self.group = group

    def __enter__(self):
        _ACTIVE.append(self.group)
        return self.group

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def active_mesh() -> Group | None:
    return _ACTIVE[-1] if _ACTIVE else None


def placement(device=None):
    """(the active group, the device an entry point runs on): with no group
    `resolve_device(device)`; under a group its device, which a given
    device must agree with in kind."""
    from plonky2_torch import resolve_device

    group = active_mesh()
    if group is None:
        return None, resolve_device(device)
    if device is not None and torch.device(device).type != group.device.type:
        raise ValueError(f"device={device} under a group on {group.device}")
    return group, group.device


def check_world(world: int) -> None:
    if world < 1 or world & (world - 1):
        raise ValueError(f"a world of {world} ranks: it must be a power of two")


class QuotientPoints:
    """The quotient points a rank evaluates (the layout's third item). The
    quotient domain has 2^qd_bits points a row and is every `step`-th LDE
    column; with no group the one rank holds every point."""

    def __init__(self, group: Group | None, rate_bits: int, qd_bits: int):
        k, r = (1, 0) if group is None else (group.world, group.rank)
        step = 1 << (rate_bits - qd_bits)
        self.group = group
        self.spacing = min(step, k)  # the holders are the ranks = 0 (mod spacing)
        self.holds = r % self.spacing == 0
        self.holders = k // self.spacing
        self.index = r // self.spacing  # this rank's place among the holders
        self.stride = max(step // k, 1)  # over the holder's local LDE columns
        self.next = 1 << qd_bits  # g x is this many points on

    def points(self, lde):
        """The rank's LDE columns [..., N / k] -> its quotient points."""
        return lde[..., ::self.stride]

    def table(self, whole):
        """The rank's points of a table over the whole domain [..., Q]."""
        return whole[..., self.index::self.holders]

    def next_rows(self, x):
        """x at the rank's points [..., Q / K] -> x at their next rows (None
        on a rank holding no point): this holder's own values, or those of
        holder index + next (mod K), rolled where the next rows wrap past
        the last local point. Every rank calls it: the exchange, where the
        next rows lie on other holders (K > next, the same on every rank),
        is a collective."""
        K, a = self.holders, self.index
        src, shift = (a + self.next) % K, (a + self.next) // K
        if K > self.next:
            x = self.group.exchange(x if self.holds else None,
                                    ((a - self.next) % K) * self.spacing, src * self.spacing)
        return torch.roll(x, -shift, dims=-1) if self.holds else None

    def gather(self, values, shape):
        """The holders' values [c, Q / K] (None on a rank holding no point,
        which adds zeros of `shape`) -> [c, Q], whole on every rank."""
        if self.group is None:
            return values
        if values is None:
            values = torch.zeros(shape, dtype=torch.int64, device=self.group.device)
        parts = self.group.all_gather(values)[::self.spacing]  # [K, c, Q / K]
        return torch.movedim(parts, 0, -1).reshape(values.shape[0], -1)


# -- placements, each beside the gather that undoes it ---------------------------

def _group(group):
    return active_mesh() if group is None else group


def replicate(x, group=None):
    """Whole on every rank: every rank computes x from the same inputs, so
    there is nothing to place (the reference's fully replicated sharding)."""
    return x


def shard_rows(x, group=None):
    """[n, ...] -> rank's contiguous block of the leading axis (n a multiple
    of the world); `gather_rows` undoes it."""
    group = _group(group)
    if group is None:
        return x
    n = x.shape[0]
    if n % group.world:
        raise ValueError(f"{n} rows do not split over {group.world} ranks")
    b = n // group.world
    return x[group.rank * b:(group.rank + 1) * b]


def gather_rows(local, group=None):
    """Every rank's block of `shard_rows`, concatenated in rank order."""
    group = _group(group)
    if group is None:
        return local
    return group.all_gather(local).reshape((-1,) + tuple(local.shape[1:]))


# the polynomial axis of [num_polys, n] is the leading one
shard_polys = shard_rows
gather_polys = gather_rows


def pad_shard_polys(x, group=None):
    """[num_polys, n] -> (rank's block of the polynomial axis padded with
    zero rows to a multiple of the world, num_polys). A transform is per
    polynomial, so the padded rows change nothing in the real ones; the
    caller gathers (`gather_polys`) and slices back to num_polys (the
    standard config's 135 wires over 4 ranks: 136 rows, 34 a rank)."""
    group = _group(group)
    orig = x.shape[0]
    if group is None:
        return x, orig
    rem = orig % group.world
    if rem:
        x = torch.cat([x, x.new_zeros((group.world - rem,) + tuple(x.shape[1:]))])
    return shard_rows(x, group), orig


def shard_lanes(x, group=None):
    """[..., n] -> rank's contiguous block of the trailing (point) axis;
    `gather_lanes` undoes it."""
    group = _group(group)
    if group is None:
        return x
    n = x.shape[-1]
    if n % group.world:
        raise ValueError(f"{n} points do not split over {group.world} ranks")
    b = n // group.world
    return x[..., group.rank * b:(group.rank + 1) * b]


def gather_lanes(local, group=None):
    """Every rank's block of `shard_lanes`, concatenated along the last axis."""
    group = _group(group)
    if group is None:
        return local
    parts = group.all_gather(local)  # [k, ..., b]
    return torch.movedim(parts, 0, -2).reshape(tuple(local.shape[:-1]) + (-1,))


def shard_columns(x, group=None):
    """[..., N] -> rank's natural columns c = rank (mod world), the LDE
    layout; `gather_columns` undoes it."""
    group = _group(group)
    if group is None:
        return x
    return x[..., group.rank::group.world]


def gather_columns(local, group=None):
    """[..., N / k] of every rank's `shard_columns` -> [..., N]: global
    column r + k i is rank r's local column i."""
    group = _group(group)
    if group is None:
        return local
    parts = group.all_gather(local)  # [k, ..., N / k]
    return torch.movedim(parts, 0, -1).reshape(tuple(local.shape[:-1]) + (-1,))


# -- the reference's two entry points -------------------------------------------

def sharded_commit(values, rate_bits: int, cap_height: int, group: Group):
    """The round-1 commitment over `group` (reference `sharded_commit`):
    the poly-sharded iFFT, its coefficients all-gathered, each rank's LDE
    columns and local tree, the gathered cap. Returns (coefficients
    [num_polys, n], the LDE as the reference's bit-reversed row leaves
    [N, num_polys] (gathered from every rank), cap [2^cap_height, 4] in the
    reference's digest order), whole on every rank."""
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.fri.oracle import PolynomialBatch, _lde_leaves
    from plonky2_torch.ops.ntt import bit_reverse_index

    with use_mesh(group):
        batch = PolynomialBatch.from_values(g.tensor(values, group.device), rate_bits, False,
                                            cap_height)
        lde = gather_columns(batch.lde, group)
    cap = batch.merkle_tree.cap_dev
    return (batch.polynomials, _lde_leaves(lde),
            cap[:, bit_reverse_index(cap_height, cap.device)].T)


def sharded_prover_step(group: Group, num_polys: int = 8, degree_bits: int = 6,
                        rate_bits: int = 3, cap_height: int = 2):
    """One representative multi-rank prover step on the reference's tiny
    shapes and its `rng(0)` inputs (reference `sharded_prover_step`): the
    sharded commit, a point-sharded modular prefix product (round 2's Z,
    with the cross-rank carry) and the point-sharded quotient pattern (a
    transition constraint over each wire and its next point, the alpha
    fold, then the coset iFFT whole). Returns (cap [2^cap_height, 4], z
    [n]), whole on every rank."""
    from plonky2_torch.field import goldilocks as g
    from plonky2_torch.field import ntt

    n = 1 << degree_bits
    rng = np.random.default_rng(0)
    values = rng.integers(0, 1 << 63, size=(num_polys, n), dtype=np.uint64)
    _, _, cap = sharded_commit(values, rate_bits, cap_height, group)

    rows = g.tensor(rng.integers(1, 1 << 63, size=(n,), dtype=np.uint64), group.device)
    incl, carry = g.cumprod_across(shard_lanes(rows, group), group)
    z = gather_lanes(torch.cat([carry.reshape(1), incl[:-1]]), group)

    wires = shard_lanes(g.tensor(rng.integers(0, 1 << 63, size=(num_polys, n << 1),
                                              dtype=np.uint64), group.device), group)
    heads = group.all_gather(wires[:, 0])  # each block's first point, for its left neighbour
    nxt = torch.cat([wires[:, 1:], heads[(group.rank + 1) % group.world][:, None]], dim=1)
    c = g.mul(wires, nxt)
    acc = torch.zeros_like(c[0])
    for i in range(num_polys):
        acc = g.add(g.mul_scalar(acc, 7), c[i])
    ntt.coset_ifft(gather_lanes(acc, group)[None, :])
    return cap, z


# -- processes ---------------------------------------------------------------------

def init_group(rank: int, world: int, backend: str, store_path: str,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Group:
    """Join the default process group as `rank` of `world` through a
    FileStore at `store_path` (no TCP port, so concurrent groups on one host
    do not collide). Under NCCL the rank's card is cuda:rank, made current
    before anything touches CUDA; under gloo the CPU."""
    check_world(world)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"backend {backend!r}: nccl (the card) or gloo (the CPU)")
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Group(rank, world, device)


@contextlib.contextmanager
def local_group(backend: str = "nccl", timeout_s: float = DEFAULT_TIMEOUT_S):
    """A group of one rank in this process (no spawn): the multi-GPU path on
    one device, collectives included."""
    tmp = tempfile.mkdtemp(prefix="plonky2_group_")
    try:
        group = init_group(0, 1, backend, os.path.join(tmp, "store"), timeout_s)
        try:
            yield group
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, world, backend, store_path, timeout_s, fn, args, out) -> None:
    """A spawned rank: join the group, run fn(group, *args), send back
    (rank, True, result), or (rank, False, traceback) and re-raise."""
    try:
        if backend == "gloo":
            torch.set_num_threads(1)
        group = init_group(rank, world, backend, store_path, timeout_s)
        try:
            result = fn(group, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_on_group(fn, world: int, backend: str, *args, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Spawn `world` processes, rank r running fn(Group, *args) on cuda:r
    (NCCL) or the CPU (gloo, one intra-op thread), and return their results
    in rank order. fn must be importable by a spawned process (a module
    function). A rank that raises or dies, or a run past `timeout_s`,
    stops every rank and raises RuntimeError with the rank's traceback."""
    check_world(world)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="plonky2_group_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, os.path.join(tmp, "store"), timeout_s, fn,
                               args, out))
             for r in range(world)]
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(results) < world and not errors:
            try:
                # a rank that exits has sent its message: wait for it a while
                rank, ok, payload = out.get(timeout=1.0 if all(
                    p.exitcode is None for r, p in enumerate(procs) if r not in results)
                    else 10.0)
            except queue_module.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    errors.append(f"rank {dead[0]} exited with code "
                                  f"{procs[dead[0]].exitcode} and sent no result")
                elif time.monotonic() > deadline:
                    errors.append(f"the group ran past {timeout_s} s")
                continue
            if ok:
                results[rank] = payload
            else:
                errors.append(f"rank {rank} failed:\n{payload}")
        if errors:
            raise RuntimeError(errors[0])
        for p in procs:
            p.join(timeout=60)
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
