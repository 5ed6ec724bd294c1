"""Σ over the ranks of a group, in rank order, the same bits on every rank.

The counterpart of XLA's all-reduce behind JAX's ``psum`` and the gathered
reductions of its ``shard_map``s (``nislam_tpu/parallel/solver.py:106-154``,
``nislam_tpu/parallel/loop_search.py:130``), which JAX runs inside its
compiled programs at any device count.  On the card it is the hand-written
kernel ``nislam_torch/csrc/all_reduce.cu`` over a region of each rank's,
which every peer maps over CUDA IPC (:class:`PeerRegion`): small payloads
in one shot (each rank pushes its payload, a flag beside every element,
into every peer's inbox and polls its own), large ones in two (each owner
sums its range in rank order, then pushes it to every peer).  The call is
one plain kernel node that a conditional graph body holds, with the same
bits eager and captured; at one rank it launches nothing, as XLA
launches nothing for a ``psum`` over one device.  :func:`launch_plan`,
here on the host, picks the protocol, the grid and each owner's range.
On the CPU it is :func:`all_reduce_reference`, the plain version the
kernel is held against: every rank's payload gathered exactly through the
process group, then summed in rank order.

``out[i] = ((x_0[i] + x_1[i]) + x_2[i]) + …``: float32 summed in float32
with adds only, int32 exactly.  Those are the dtypes the port's
collectives carry: float32 (the GN-CG gradient block, its CG vectors and
cost, the loop search's winner record, the canvas delta, the fleet's
gathered outputs) and int32 (the bits of an evicted keyframe image and of
a gathered bank leaf, ``parallel/engine.py::_exact_sum``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import weakref
from typing import Callable, Iterator, Optional, Tuple

import torch

# The kernel's dtype codes (csrc/all_reduce.cu's DType) and protocols.
DTYPES = {torch.float32: 0, torch.int32: 1}
NONE, ONE_SHOT, TWO_SHOT = 0, 1, 2
# Bytes of one two-shot round (a larger payload moves in rounds of a slot
# each, within one launch), and the largest payload the one shot takes
# across cards.
SLOT_BYTES = 8 << 20
ONE_SHOT_BYTES = 256 << 10
# The region's one-shot inbox holds payloads up to this size: the
# threshold of ranks that share one card, where every wait for a peer is
# a time slice of the other process's and the one shot waits once where
# the two shot waits twice (an evicted 480x640 image's bits go in one).
ONE_SHOT_CAPACITY = 2 << 20
# csrc/all_reduce.cu's constants: threads of a block, the most ranks and
# the most blocks of each protocol.
THREADS = 512
MAX_RANKS = 8
ONE_SHOT_BLOCKS = 64
TWO_SHOT_BLOCKS = 132
# The two shot's grid: at least this many elements in a block's piece.
TWO_SHOT_MIN_PIECE = 4 * THREADS


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call runs (``csrc/all_reduce.cu``'s plan): ``protocol``,
    ``blocks``, ``block_elems`` (one shot: a block's elements; two shot: a
    block's piece of each owner's range), ``per_round`` and ``rounds`` (two
    shot: elements of a full round, and how many), ``count``, and the
    owners' bounds of a full round (``full``) and of the last (``last``),
    ``size + 1`` each."""

    protocol: int
    blocks: int
    block_elems: int
    per_round: int
    rounds: int
    count: int
    full: Tuple[int, ...]
    last: Tuple[int, ...]

    def words(self) -> Tuple[int, ...]:
        """The kernel's int64 plan words."""
        pad = lambda b: tuple(b) + (0,) * (MAX_RANKS + 1 - len(b))
        return (self.protocol, self.blocks, self.block_elems, self.per_round, self.rounds, self.count,
                *pad(self.full), *pad(self.last))

    @functools.cached_property
    def c_words(self) -> ctypes.Array:
        """:meth:`words` as the ``long long`` array ``nislam_ar_launch`` reads."""
        words = self.words()
        return (ctypes.c_longlong * len(words))(*words)

    def pieces(self) -> Iterator[Tuple[int, int, int, int]]:
        """``(owner, block, start, stop)`` of every non-empty piece, in
        payload elements, as the kernel cuts them (owner -1: the one shot,
        whose blocks take whole ranges)."""
        if self.protocol == ONE_SHOT:
            for b in range(self.blocks):
                lo = b * self.block_elems
                yield -1, b, lo, min(self.count, lo + self.block_elems)
        elif self.protocol == TWO_SHOT:
            for r in range(self.rounds):
                bounds = self.last if r == self.rounds - 1 else self.full
                for j in range(len(bounds) - 1):
                    for b in range(self.blocks):
                        s0 = min(bounds[j] + b * self.block_elems, bounds[j + 1])
                        s1 = min(s0 + self.block_elems, bounds[j + 1])
                        if s1 > s0:
                            yield j, b, r * self.per_round + s0, r * self.per_round + s1


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def owner_bounds(n: int, size: int) -> Tuple[int, ...]:
    """``n`` elements cut into ``size`` owner ranges that start on 4
    elements (16 bytes), but for empty ranges at the tail: ``size + 1``
    bounds."""
    chunk = 4 * _ceil(_ceil(n, size), 4)
    return tuple(min(j * chunk, n) for j in range(size + 1))


@functools.lru_cache(maxsize=256)
def launch_plan(count: int, itemsize: int, size: int, slot_bytes: int = SLOT_BYTES,
                one_shot_bytes: int = ONE_SHOT_BYTES) -> LaunchPlan:
    """The plan of one all-reduce of ``count`` elements of ``itemsize``
    bytes over ``size`` ranks: at one rank none (nothing to launch); the
    one shot up to ``one_shot_bytes`` (blocks of at least one pair per
    thread, at most ``ONE_SHOT_BLOCKS``); else the two shot in rounds of
    ``slot_bytes``, each round's elements cut among the owners, a grid of
    up to ``TWO_SHOT_BLOCKS`` (one per SM) taking pieces of at least
    ``TWO_SHOT_MIN_PIECE`` elements of each range."""
    if count < 1 or size < 1 or itemsize != 4:
        raise ValueError(f"a plan takes count >= 1, size >= 1 and 4-byte elements, got {count}, {size}, {itemsize}")
    if size == 1:
        return LaunchPlan(NONE, 0, 0, count, 1, count, (0, count), (0, count))
    if count * itemsize <= min(one_shot_bytes, ONE_SHOT_CAPACITY):
        per_block = 2 * _ceil(max(2 * THREADS, _ceil(count, ONE_SHOT_BLOCKS)), 2)
        bounds = (0, count)
        return LaunchPlan(ONE_SHOT, _ceil(count, per_block), per_block, count, 1, count, bounds, bounds)
    per_round = min(slot_bytes // itemsize, 4 * _ceil(count, 4))
    rounds = _ceil(count, per_round)
    full = owner_bounds(per_round, size)
    last = owner_bounds(count - (rounds - 1) * per_round, size)
    widest = max(full[1] - full[0], last[1] - last[0])
    blocks = max(1, min(TWO_SHOT_BLOCKS, _ceil(widest, TWO_SHOT_MIN_PIECE)))
    block_elems = 4 * _ceil(_ceil(widest, blocks), 4)
    return LaunchPlan(TWO_SHOT, blocks, block_elems, per_round, rounds, count, full, last)


def all_reduce_reference(x: torch.Tensor, gather: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Plain version: ``gather(x)`` (every rank's ``x`` stacked in rank
    order, bit for bit) summed in rank order, ``((x_0 + x_1) + x_2) + …``,
    in ``x``'s dtype → a new tensor."""
    if x.dtype not in DTYPES:
        raise TypeError(f"all_reduce takes {sorted(map(str, DTYPES))}, got {x.dtype}")
    rows = gather(x)
    out = rows[0].clone()
    for row in rows[1:]:
        out = out + row
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound at the first call."""
    from nislam_torch.kernels.build import load_library
    from nislam_torch.kernels.launch import bind_all_reduce

    return load_library("all_reduce", bind_all_reduce)


class PeerRegion:
    """This rank's exchange region on its card and its peers' regions, as
    ``csrc/all_reduce.cu`` lays them out: the epochs and flags, the one
    shot's inbox, the two shot's inbox and gather slots, and a mapped host
    error word.  :meth:`open` makes it: a collective of the group (every
    rank calls it once, in the same order).  ``shared``: every rank on
    this card.  ``one_shot_bytes``: the plan's threshold between the
    protocols (``ONE_SHOT_BYTES`` across cards, the inbox's whole
    ``ONE_SHOT_CAPACITY`` on a shared card); :meth:`tuned` moves it for a
    while (every rank must hold the same)."""

    def __init__(self, ctx: int, device: torch.device, size: int, timeout_s: float):
        self._lib = _library()
        self._ctx = ctx
        self.device = device
        self.size = size
        self.shared = False
        self.timeout_ns = int(timeout_s * 1e9)
        self.one_shot_bytes = ONE_SHOT_BYTES
        self._finalizer = weakref.finalize(self, self._lib.nislam_ar_destroy, ctx)
        self._finalizer.atexit = False  # freed with the process at exit

    @classmethod
    def open(cls, rank: int, size: int, device: torch.device, gather: Callable[[torch.Tensor], torch.Tensor],
             timeout_s: float) -> "PeerRegion":
        """The region of ``rank`` of ``size`` on ``device``: allocated with
        ``cudaMalloc``, its IPC handle and card exchanged once through
        ``gather`` (the process group's exact gather of an int32 row), every
        peer's region opened (peer access enabled across cards).  Raises if
        any step is refused: nothing falls back to another collective."""
        lib = _library()
        limits = (lib.nislam_ar_max_ranks(), lib.nislam_ar_threads(), lib.nislam_ar_max_blocks(ONE_SHOT),
                  lib.nislam_ar_max_blocks(TWO_SHOT), lib.nislam_ar_plan_words())
        if limits != (MAX_RANKS, THREADS, ONE_SHOT_BLOCKS, TWO_SHOT_BLOCKS, len(launch_plan(1, 4, 1).words())):
            raise RuntimeError(f"csrc/all_reduce.cu's limits {limits} differ from the plan's")
        if size > MAX_RANKS:
            raise ValueError(f"the peer all-reduce takes at most {MAX_RANKS} ranks, got {size}")
        row = (ctypes.c_char * lib.nislam_ar_row_bytes())()
        ctx = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(lib.nislam_ar_create(rank, size, SLOT_BYTES, ONE_SHOT_CAPACITY, ctypes.byref(ctx), row),
                   "allocating the all-reduce's peer region")
            region = cls(ctx.value, device, size, timeout_s)
            mine = torch.frombuffer(bytearray(row.raw), dtype=torch.int32)
            rows = gather(mine).to("cpu", torch.int32).contiguous()
            _check(lib.nislam_ar_open(ctx, rows.data_ptr()),
                   "opening the peers' all-reduce regions (CUDA IPC and peer access)")
        # The cards' PCI bus ids, after each row's IPC handle.
        cards = {r.numpy().tobytes()[64:].split(b"\0")[0] for r in rows}
        if size > 1 and len(cards) == 1:
            region.shared, region.one_shot_bytes = True, ONE_SHOT_CAPACITY
        return region

    @contextlib.contextmanager
    def tuned(self, one_shot_bytes: Optional[int] = None) -> Iterator[None]:
        """The plan's threshold set (None: as it is) for the block, then
        put back."""
        saved = self.one_shot_bytes
        if one_shot_bytes is not None:
            self.one_shot_bytes = one_shot_bytes
        try:
            yield
        finally:
            self.one_shot_bytes = saved

    def plan(self, count: int) -> LaunchPlan:
        """The plan of a call of ``count`` 4-byte elements on this group."""
        return launch_plan(count, 4, self.size, SLOT_BYTES, self.one_shot_bytes)

    def launch(self, x: torch.Tensor) -> bool:
        """One all-reduce of ``x`` in place on the current stream → whether
        a kernel was launched: at one rank the sum is ``x`` itself and
        nothing is."""
        code = DTYPES.get(x.dtype)
        if code is None:
            raise TypeError(f"the all_reduce kernel takes {sorted(map(str, DTYPES))}, got {x.dtype}")
        if x.device != self.device or not x.is_contiguous() or x.numel() == 0:
            raise ValueError(f"the all_reduce kernel takes a contiguous non-empty tensor on {self.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
        if self.size == 1:
            return False
        words = self.plan(x.numel()).c_words
        index = x.device.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        with torch.cuda.device(index):
            _check(self._lib.nislam_ar_launch(self._ctx, x.data_ptr(), x.data_ptr(), x.numel(), code, words,
                                              len(words), self.timeout_ns, stream), "launching the all_reduce kernel")
        return True

    def check(self) -> None:
        """Raise if a launch that has ended waited past the group's timeout
        for a peer (the mapped error word: no sync)."""
        if self._lib.nislam_ar_error(self._ctx):
            raise RuntimeError(f"all_reduce: a peer did not arrive within {self.timeout_ns / 1e9:g} s (the ranks "
                               "diverged, or one stopped); the group is broken")


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def all_reduce(x: torch.Tensor, group, force: Optional[str] = None) -> torch.Tensor:
    """Σ of ``x`` over ``group``'s ranks, in rank order, in place; returns
    ``x``.  A CUDA tensor goes to the kernel over ``group.peers`` (a
    :class:`PeerRegion`; it raises if the group has none), a CPU tensor to
    :func:`all_reduce_reference` over ``group.gather_exact``.  ``force`` ∈
    {"kernel", "reference"} pins the choice; ``all_reduce.counts["launches"]``
    counts kernel launches (Python calls: a captured graph adds them per
    replay, ``core/track_graph.py``), none at one rank, where the kernel's
    sum is the payload in place."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and x.is_cuda):
        if group.peers is None:
            raise RuntimeError("the group has no peer region: its all-reduce on a card needs one (world_group "
                               "opens it for a CUDA device)")
        if group.peers.launch(x):
            all_reduce.counts["launches"] += 1
        return x
    return x.copy_(all_reduce_reference(x, group.gather_exact))


all_reduce.counts = collections.Counter()


def launches() -> int:
    """The kernel's launches that this process counted."""
    return all_reduce.counts["launches"]


def device_launches(device: torch.device) -> int:
    """The kernel's launches that have run on ``device`` (inside graphs
    too), as it counts them.  Waits for the device."""
    n = ctypes.c_ulonglong()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        _check(_library().nislam_ar_device_launches(ctypes.byref(n)), "reading the all_reduce kernel's launches")
    return n.value
