"""Multi-GPU proving: one process a card, explicit collectives over
`torch.distributed` (NCCL on the card, gloo on the CPU), the counterpart of
the reference's `plonky2_tpu/parallel/__init__.py`.

The reference places its inputs on a device mesh of any size and lets XLA
insert the collectives (GSPMD, which pads uneven axes). The port writes its
SPMD out: every rank runs the same Python on the same inputs, holds the
same values wherever the layout below says "whole", and exchanges the rest
by the collectives of `Group`. Under a group every prover path gives the
single device's proof bytes on every rank: the PLONK prove (both
transcript paths, zero knowledge, lookups and the Keccak config),
`prove_many`, circuit builds, the Starky prove (Poseidon or Keccak), the
multi-table prove with its cross-table lookups, and batch FRI. With no
group active (`active_mesh()` is None) every module runs its
single-device path, launch for launch. The world is any k >= 1.

Parts. The work is split into P = 2^p parts (`Group.parts`): P = k where
k is a power of two, else the least power of two >= 2k, so that the
busiest rank holds at most ceil(P / k) / P of it (3/8 at k = 3, 3/16 at
k = 5, 6 or 7; at P = k one rank could hold two of k + 1 parts). Part v
belongs to rank v mod k (`Group.own_parts`, ascending); a rank's parts are
stacked on a leading axis. A collective over parts pads every rank's to
ceil(P / k) (`Group.gather_parts`) and drops the padding after, as GSPMD
pads an uneven axis. At P = k each rank holds one part, and the
collectives and launches are those of a single part.

The layout. Only three things are held in part on each rank:

- the LDE values of each committed batch: part v is the natural-order LDE
  columns c = v (mod P), as [num_polys, N / P] with local column i the
  global column v + P i (`fri/oracle.py`; the rank's parts [L, num_polys,
  N / P]). These are the points shift w_N^v w_(N/P)^i: a coset of the
  subgroup of order N / P, so the rank computes them alone
  (`ntt.coset_lde_parts`): while P divides 2^rate_bits, part v is the fan
  rows j = v (mod P) of the interleaved LDE, so the rank's parts are one
  LDE launch over those rows of the scale table; for P > 2^rate_bits
  (N / P < n points) each part's coefficients are folded first, mod
  x^(N/P) - (shift w_N^v)^(N/P), a weighted sum of their n P / N slices,
  and take the plain NTT of N / P points;
- the Merkle tree below the cap: the natural tree pairs (j, j + (N >> l)),
  so digest j of level l covers the columns = j (mod N >> l), and each
  part's columns form whole subtrees; its local natural tree over
  [width, N / P], cut at cap height cap_height - p, holds the global
  level-l digests v + P i (`hash/merkle.py` `ShardedMerkleTree`). Where
  P > 2^cap_height the P local roots are all-gathered and the top levels
  hashed whole. A Keccak tree hashes bit-reversed row leaves on the host:
  part v's columns are the contiguous block rev_p(v) of N / P row leaves,
  so each rank hashes its parts' subtrees on its own host core and only
  the local caps (or roots) are all-gathered (`ShardedKeccakMerkleTree`);
- the quotient's points (`QuotientPoints`). The quotient is evaluated on
  the Q = n 2^qd_bits points shift w_Q^j, which are the LDE columns
  c = j step with step = 2^(rate_bits - qd_bits). Part v holds such
  columns only if v = 0 (mod min(step, P)), and those parts, the holders,
  are evaluated by their ranks: holder a of K = P / min(step, P) holds the
  points j = a (mod K), every (step / P)-th of its local columns (every
  one where step <= P). The next row, g x, is point j + 2^qd_bits: while
  K divides 2^qd_bits it lies in the same part, 2^qd_bits / K local points
  on; otherwise in holder a + 2^qd_bits (mod K), which is a local roll
  where that part is on the same rank and otherwise comes in one
  all-to-all a batch in which every rank takes part (`Group.exchange`;
  NCCL runs it on the group's own communicator). A rank holding no
  holder skips the evaluation and adds zeros to the all-gather of the
  holders' values. The alternative, spreading the points evenly over the
  ranks, would first move every batch's quotient columns through an
  all-to-all; PERF.md records the choice.

Everything else is whole on every rank: the witness, the coefficients (an
iFFT from values runs poly-sharded, padded to a multiple of k, and its
coefficients are all-gathered), round 2's values after their gather, the
quotient values after their gather, the logUp and CTL columns of a Starky,
the openings, FRI, batch FRI (run whole with the group suspended, as the
reference runs it unsharded), and the transcript. The reference's rank r'
of a power-of-two mesh holds the bit-reversed leaves [r' N / k,
(r' + 1) N / k), which are the natural columns whose low lg k bits are
rev_{lg k}(r'): the same column sets as the port's part rev_{lg k}(r'). The
cap is all-gathered and put in the reference's order; a query's leaf and
Merkle path lie on the rank that owns its natural column's part, which
gathers them into zeros, and one SUM all-reduce gives every rank every
opening exactly (each value is added to zeros only). No other field value
passes through a reducing collective: the integer SUM of NCCL and gloo
wraps mod 2^64, not mod p, so field values are all-gathered and then
reduced with the field's own arithmetic.

The round-2 scans run over the P contiguous blocks of n / P points, each
rank its parts' blocks (`shard_lanes`), with one total a block all-gathered
for the carries (`field/goldilocks.py` `cumprod_across`). `prove_many`
under a group with dispatch threads runs proof i on slot i mod threads,
each slot a thread with its own communicator (`Group.slots`), so every
communicator sees the same collectives in the same order on every rank;
over gloo. Over NCCL with more than one rank it raises: the slots'
communicators deadlocked against each other on the cards.

Nothing falls back: a world that a circuit cannot split (n not a multiple
of P) raises, naming both numbers, a failed collective raises, and a rank
that fails fails `run_on_group`.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_module
import shutil
import tempfile
import threading
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


def _all_gather_flat(out, x, pg=None) -> None:
    single = getattr(dist, "all_gather_single", None)  # newer torch's name
    if single is not None:
        single(out, x, group=pg)
    else:
        dist.all_gather_into_tensor(out, x, group=pg)


def parts_count(world: int) -> int:
    """P, the parts of a world of k ranks: k itself where k is a power of
    two, else the least power of two >= 2k."""
    if world < 1:
        raise ValueError(f"a world of {world} ranks")
    if world & (world - 1) == 0:
        return world
    return 1 << (2 * world - 1).bit_length()


SLOT_TIMEOUT_S = 120.0  # a slot communicator's collectives: a hang fails, not cut


@dataclass
class Group:
    """A process group of `world` ranks, one device a rank: this process is
    `rank` and works on `device`; `pg` is the communicator (None: the
    default group)."""

    rank: int
    world: int
    device: torch.device
    pg: object = None
    timeout_s: float = DEFAULT_TIMEOUT_S

    def __post_init__(self):
        self._slots = []

    # -- the parts layout (module docstring) --

    @property
    def parts(self) -> int:
        return parts_count(self.world)

    @property
    def lg_parts(self) -> int:
        return self.parts.bit_length() - 1

    @property
    def own_parts(self) -> tuple:
        """The parts v = rank (mod world), ascending: local part t is part
        rank + world t."""
        return tuple(range(self.rank, self.parts, self.world))

    @property
    def most(self) -> int:
        """The most parts a rank holds, ceil(P / world)."""
        return -(-self.parts // self.world)

    def check_parts(self, count: int, what: str) -> None:
        """Raise unless `count` (of `what`) splits into the P parts."""
        if count % self.parts:
            raise ValueError(f"{count} {what} do not split over a world of {self.world} "
                             f"ranks ({self.parts} parts)")

    # -- collectives --

    def all_gather(self, x):
        """[world, *x.shape]: every rank's x, in rank order."""
        x = x.contiguous()
        out = torch.empty((self.world * x.numel(),), dtype=x.dtype, device=x.device)
        _all_gather_flat(out, x.reshape(-1), self.pg)
        Collectives.add(out)
        return out.reshape((self.world,) + tuple(x.shape))

    def gather_parts(self, x):
        """x: this rank's parts stacked, [len(own_parts), ...] -> every
        part's, [P, ...] in part order. Each rank's parts are padded to
        `most` for the all-gather: part v = rank + world t lands at
        t world + rank of the gathered [world, most, ...] read slot-major."""
        if x.shape[0] < self.most:
            x = torch.cat([x, x.new_zeros((self.most - x.shape[0],) + tuple(x.shape[1:]))])
        out = self.all_gather(x)  # [world, most, ...]
        if self.most == 1:
            return out.reshape((self.world,) + tuple(x.shape[1:]))
        return out.transpose(0, 1).reshape((-1,) + tuple(x.shape[1:]))[:self.parts]

    def all_reduce_disjoint(self, x):
        """The SUM over ranks of x where, at each position, at most one rank
        holds a nonzero value: exact, since each value is added to zeros
        only. Reduces x in place and returns it."""
        dist.all_reduce(x, group=self.pg)
        Collectives.add(x)
        return x

    def exchange(self, sends: dict, recvs: dict) -> dict:
        """One all-to-all: send `sends[d]` to each rank d and receive from
        each rank s in `recvs` a tensor of shape `recvs[s]`; returns
        {s: tensor}. Every rank calls it; a rank with nothing to move passes
        two empty dicts."""
        sizes = [0] * self.world
        got = [0] * self.world
        for d, x in sends.items():
            sizes[d] = x.numel()
        for s, shape in recvs.items():
            got[s] = int(np.prod(shape))
        parts = [sends[d].contiguous().reshape(-1) for d in sorted(sends)]
        if not parts:
            send = torch.empty((0,), dtype=torch.int64, device=self.device)
        else:
            send = parts[0] if len(parts) == 1 else torch.cat(parts)
        out = torch.empty((sum(got),), dtype=torch.int64, device=self.device)
        dist.all_to_all_single(out, send, got, sizes, group=self.pg)
        Collectives.add(out)
        result, pos = {}, 0
        for s in sorted(recvs):
            result[s] = out[pos:pos + got[s]].reshape(recvs[s])
            pos += got[s]
        return result

    # -- dispatch slots --

    def slots(self, count: int) -> list:
        """`count` groups of the same ranks and device, each on a
        communicator of its own (made with `dist.new_group` in slot order on
        every rank, with a timeout of SLOT_TIMEOUT_S), for `prove_many`'s
        dispatch threads. Made once a count and started here, with one
        collective each in slot order, before any thread uses them."""
        while len(self._slots) < count:
            timeout = min(self.timeout_s, SLOT_TIMEOUT_S)
            pg = dist.new_group(list(range(self.world)),
                                timeout=datetime.timedelta(seconds=timeout))
            slot = Group(self.rank, self.world, self.device, pg, timeout)
            dist.all_reduce(torch.zeros(1, dtype=torch.int64, device=self.device), group=pg)
            self._slots.append(slot)
        return self._slots[:count]


# -- the active group ----------------------------------------------------------

_ACTIVE = threading.local()  # each thread's stack: prove_many's slots have their own


def _stack() -> list:
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    return stack


class use_mesh:
    """Context manager: run the prover's phases over `group` (None: the
    single-device path, also inside an outer group), on this thread."""

    def __init__(self, group: Group | None):
        self.group = group

    def __enter__(self):
        _stack().append(self.group)
        return self.group

    def __exit__(self, *exc):
        _stack().pop()
        return False


def active_mesh() -> Group | None:
    stack = _stack()
    return stack[-1] if stack else None


def communicator(group: Group) -> Group:
    """The group whose communicator a collective over `group`'s layout
    takes: the active group where it has the same rank and world (a
    prove_many slot, over a batch that another slot or the caller's
    group committed), else `group`."""
    active = active_mesh()
    if active is not None and (active.rank, active.world) == (group.rank, group.world):
        return active
    return group


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
    if world < 1:
        raise ValueError(f"a world of {world} ranks: it takes at least one")


class QuotientPoints:
    """The quotient points a rank evaluates (the layout's third item). The
    quotient domain has 2^qd_bits points a row and is every `step`-th LDE
    column; the holders are the parts v = 0 (mod spacing), K of them; with
    no group the one rank holds every point."""

    def __init__(self, group: Group | None, rate_bits: int, qd_bits: int):
        step = 1 << (rate_bits - qd_bits)
        count, own = (1, (0,)) if group is None else (group.parts, group.own_parts)
        k = 1 if group is None else group.world
        self.group = group
        self.spacing = min(step, count)  # the holders are the parts = 0 (mod spacing)
        self.holders = count // self.spacing
        # (local part, holder index) of each of this rank's holders
        self.mine = [(t, v // self.spacing) for t, v in enumerate(own) if v % self.spacing == 0]
        self.holds = bool(self.mine)
        # each holder's (rank, place among that rank's holders)
        self.where, places = [], {}
        for a in range(self.holders):
            r = (a * self.spacing) % k
            self.where.append((r, places.get(r, 0)))
            places[r] = places.get(r, 0) + 1
        self.most = max(places.values())
        self.stride = max(step // count, 1)  # over a holder's local LDE columns
        self.next = 1 << qd_bits  # g x is this many points on

    def points(self, batch):
        """A batch's LDE at the rank's points, [num_polys, points]: its
        holders' columns, every `stride`-th, side by side."""
        if self.group is None:
            return batch.lde[..., ::self.stride]
        parts = batch.lde_parts
        if len(self.mine) == 1:
            return parts[self.mine[0][0]][..., ::self.stride]
        if not self.mine:
            return parts[0][..., :0]
        return torch.cat([parts[t][..., ::self.stride] for t, _ in self.mine], dim=-1)

    def table(self, whole):
        """The rank's points of a table over the whole domain [..., Q]."""
        if len(self.mine) == 1:
            return whole[..., self.mine[0][1]::self.holders]
        return torch.cat([whole[..., a::self.holders] for _, a in self.mine], dim=-1)

    def next_rows(self, x):
        """x at the rank's points [..., H Q / K] (H blocks of Q / K, one a
        holder) -> x at their next rows (None on a rank holding no point):
        holder a's next rows are holder (a + next) mod K's values, rolled
        where they wrap past its last point: the same block, another of
        this rank's, or one from another rank. Every rank calls it: the
        exchange, where next rows lie in other holders (K > next, the same
        on every rank), is a collective."""
        K = self.holders
        if K <= self.next:  # K divides next: every holder's next rows are its own
            if not self.holds:
                return None
            shift = self.next // K
            if len(self.mine) == 1:
                return torch.roll(x, -shift, dims=-1)
            blocks = x.reshape(tuple(x.shape[:-1]) + (len(self.mine), -1))
            return torch.roll(blocks, -shift, dims=-1).reshape(x.shape)
        group = self.group
        blocks = {}
        if self.holds:
            b = x.shape[-1] // len(self.mine)
            blocks = {a: x[..., i * b:(i + 1) * b] for i, (_, a) in enumerate(self.mine)}
        # holder a needs holder (a + next) mod K; send each block to its reader
        sends, recvs = {}, {}
        for c, block in sorted(blocks.items(), key=lambda ab: (ab[0] - self.next) % K):
            reader = (c - self.next) % K
            d = self.where[reader][0]
            if d != group.rank:
                sends.setdefault(d, []).append(block)
        for _, a in self.mine:
            s = self.where[(a + self.next) % K][0]
            if s != group.rank:
                recvs.setdefault(s, []).append(a)
        shape = None if not blocks else next(iter(blocks.values())).shape
        got = {}
        moved = group.exchange(
            {d: (v[0] if len(v) == 1 else torch.cat(v, dim=-1)) for d, v in sends.items()},
            {s: tuple(shape[:-1]) + (len(v) * shape[-1],) for s, v in recvs.items()})
        for s, readers in recvs.items():
            for i, a in enumerate(readers):
                got[a] = moved[s][..., i * shape[-1]:(i + 1) * shape[-1]]
        if not self.holds:
            return None
        out = []
        for _, a in self.mine:
            src = (a + self.next) % K
            y = blocks[src] if self.where[src][0] == group.rank else got[a]
            out.append(torch.roll(y, -((a + self.next) // K), dims=-1))
        return out[0] if len(out) == 1 else torch.cat(out, dim=-1)

    def gather(self, values, shape):
        """The holders' values [c, H Q / K] (None on a rank holding no
        point) -> [c, Q], whole on every rank. shape: one holder's block,
        (c, Q / K); each rank's blocks are padded to the most a rank holds."""
        if self.group is None:
            return values
        c, b = shape[0], shape[-1]
        held = 0 if values is None else values.shape[-1] // b
        if held < self.most:
            pad = torch.zeros((c, (self.most - held) * b), dtype=torch.int64,
                              device=self.group.device)
            values = pad if values is None else torch.cat([values, pad], dim=-1)
        ranks = self.group.all_gather(values)  # [k, c, most * Q / K]
        if self.most == 1 and all(r == a * self.spacing for a, (r, _) in enumerate(self.where)):
            parts = ranks[::self.spacing]  # [K, c, Q / K]
        else:
            parts = torch.stack([ranks[r, :, j * b:(j + 1) * b] for r, j in self.where])
        return torch.movedim(parts, 0, -1).reshape(c, -1)


# -- placements, each beside the gather that undoes it ---------------------------

def _group(group):
    return active_mesh() if group is None else group


def _cat(blocks, axis: int):
    if len(blocks) == 1:
        return blocks[0]
    if isinstance(blocks[0], torch.Tensor):
        return torch.cat(blocks, dim=axis)
    return np.concatenate(blocks, axis=axis)


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
    """[..., n] (a tensor or a numpy array) -> the rank's blocks of the
    trailing (point) axis side by side: the n points split into P
    contiguous blocks, block v the rank's where v is one of its parts;
    `gather_lanes` undoes it."""
    group = _group(group)
    if group is None:
        return x
    n = x.shape[-1]
    group.check_parts(n, "points")
    b = n // group.parts
    return _cat([x[..., v * b:(v + 1) * b] for v in group.own_parts], -1)


def gather_lanes(local, group=None):
    """Every rank's blocks of `shard_lanes`, concatenated along the last axis."""
    group = _group(group)
    if group is None:
        return local
    L = len(group.own_parts)
    blocks = local.reshape(tuple(local.shape[:-1]) + (L, -1)).movedim(-2, 0)
    parts = group.gather_parts(blocks)  # [P, ..., b]
    return torch.movedim(parts, 0, -2).reshape(tuple(local.shape[:-1]) + (-1,))


def shard_parts(x, group=None):
    """[..., N] -> the rank's parts [L, ..., N / P]: part v the natural
    columns c = v (mod P), local column i the global column v + P i; at
    P = world a view of the one part."""
    group = _group(group)
    if group is None:
        return x[None]
    count = group.parts
    own = group.own_parts
    if len(own) == 1:
        return x[..., own[0]::count][None]
    return torch.stack([x[..., v::count] for v in own])


def gather_parts(local, group=None):
    """The rank's parts [L, ..., N / P] of every rank -> [..., N]."""
    group = _group(group)
    if group is None:
        return local[0]
    parts = group.gather_parts(local)  # [P, ..., N / P]
    return torch.movedim(parts, 0, -1).reshape(tuple(local.shape[1:-1]) + (-1,))


def shard_columns(x, group=None):
    """[..., N] -> the rank's parts side by side, [..., L N / P] (the LDE
    layout, part-major: local column t N / P + i is the global column
    own_parts[t] + P i); `gather_columns` undoes it."""
    group = _group(group)
    if group is None:
        return x
    parts = shard_parts(x, group)
    if parts.shape[0] == 1:
        return parts[0]
    return torch.movedim(parts, 0, -2).reshape(tuple(x.shape[:-1]) + (-1,))


def gather_columns(local, group=None):
    """[..., L N / P] of every rank's `shard_columns` -> [..., N]."""
    group = _group(group)
    if group is None:
        return local
    L = len(group.own_parts)
    parts = local.reshape(tuple(local.shape[:-1]) + (L, -1)).movedim(-2, 0)
    return gather_parts(parts, group)


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
        lde = gather_parts(batch.lde_parts, group)
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
    z = gather_lanes(g.exclusive_blocks(incl, carry), group)

    wires = shard_lanes(g.tensor(rng.integers(0, 1 << 63, size=(num_polys, n << 1),
                                              dtype=np.uint64), group.device), group)
    own, count = group.own_parts, group.parts
    blocks = wires.reshape(num_polys, len(own), -1)
    # each block's first point, for the block before it
    heads = group.gather_parts(blocks[:, :, 0].T.contiguous())  # [P, num_polys]
    nxt = torch.cat([blocks[:, :, 1:], heads[[(v + 1) % count for v in own]].T[:, :, None]],
                    dim=2).reshape(wires.shape)
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
    return Group(rank, world, device, timeout_s=timeout_s)


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
