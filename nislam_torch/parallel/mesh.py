"""Ranks and their collectives: the port's communication layer.

Counterpart of ``nislam_tpu.parallel.mesh``.  Where the JAX package builds
a device mesh and lets ``shard_map``/``psum`` move the data, here one
process is one rank with one explicit device, and :class:`RankGroup` (a
one-axis group: process group, rank, world size, axis name, device) takes
the place of the mesh.  Each engine takes one group, on its ``bank`` axis
(the sharded keyframe bank) or its ``data`` axis (lanes over ranks).

The group owns every collective call of the port and counts each by its
operation and payload bytes (:attr:`RankGroup.counts`): the scaling
figures (``nislam_torch.utils.scaling``) read the counts, and the fleet's
lane body is checked to make none.  The only collective is
``all_reduce``, the port's own (``ops/all_reduce.py``): on a card the
peer-memory kernel ``csrc/all_reduce.cu`` over the group's
:class:`~nislam_torch.ops.all_reduce.PeerRegion` (one card per rank, or
ranks sharing one card), which a graph captures as one kernel node
(:attr:`RankGroup.capturable`) and which launches nothing at one rank
(the sum is the payload; the call is still counted); on CPU tensors its
plain version.  Either
sums in rank order and leaves the same bits on every rank.  An
all-gather is one ``all_reduce`` of a zero-filled (n, ...) record in which
each rank writes its own row (:meth:`RankGroup.gather_rows`); summing a
value with zeros is exact (but for the sign of a zero), so every rank
reads back the bits that the rank that wrote them had.  The process group
(``torch.distributed``, gloo or NCCL) carries only
:meth:`RankGroup.gather_exact`: the regions' one-time handle exchange and
the plain version's gather.

Importing this module starts nothing; :func:`init_distributed` does.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

from nislam_torch.core.track_graph import register_counts
from nislam_torch.ops.all_reduce import PeerRegion, all_reduce


@dataclasses.dataclass
class RankGroup:
    """This process's place in a group of ranks along one axis.

    ``process_group`` None is the default (world) group.  ``counts`` maps
    ``(operation, payload bytes)`` to the number of such calls run
    through this object: a call in a captured graph counts once per
    execution on the device (a capture puts back what it added, each
    replay adds it: ``core/track_graph.py``).  ``backend``: the process group's
    (``"nccl"``, ``"gloo"``; None: no process group, as a test's stub).
    ``peers``: the peer region of a group on a card (:func:`world_group`
    opens it).  ``timeout_s``: how long a collective waits for a peer
    before it raises.  ``host_route``: keep this group's all-reduces out
    of graphs (the measuring scripts' reference route)."""

    rank: int
    size: int
    axis: str
    device: torch.device
    process_group: Optional[dist.ProcessGroup] = None
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    backend: Optional[str] = None
    peers: Optional[PeerRegion] = None
    timeout_s: float = 600.0
    host_route: bool = False

    def __post_init__(self) -> None:
        register_counts(self.counts)

    @property
    def capturable(self) -> bool:
        """Whether a conditional CUDA graph body can hold this group's
        all-reduce: on a card with the peer region open, at any rank count
        (the kernel is one kernel node, ``scripts/captureprobe.py
        --peer``), unless :attr:`host_route`.  On CPU tensors the plain
        version goes through the host."""
        return self.device.type == "cuda" and self.peers is not None and not self.host_route

    def _record(self, op: str, t: torch.Tensor) -> None:
        self.counts[(op, t.numel() * t.element_size())] += 1

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in rank order, in place; returns ``t``:
        the kernel for a CUDA tensor (never ``dist.all_reduce``), the plain
        version for a CPU one."""
        self._record("all_reduce", t)
        self.check()
        return all_reduce(t, self)

    def check(self) -> None:
        """Raise if one of this group's kernels waited past its timeout for a
        peer (a host read of mapped memory, no sync): at the reads that the
        graphs' routes make anyway."""
        if self.peers is not None:
            self.peers.check()

    def gather_exact(self, row: torch.Tensor) -> torch.Tensor:
        """Every rank's ``row`` (4-byte elements) stacked in rank order →
        (size, *row.shape), bit for bit on every rank, through the process
        group itself: one ``dist.all_reduce`` of the bits as int32 in a
        zero-filled record (on the card for NCCL, on the host for gloo).
        The peer regions' handle exchange and the plain all-reduce's
        gather; not counted."""
        if row.element_size() != 4:
            raise TypeError(f"gather_exact takes 4-byte elements, got {row.dtype}")
        bits = row.contiguous().view(torch.int32)
        if self.size == 1:
            return bits[None].clone().view(row.dtype)
        where = self.device if self.backend == "nccl" else torch.device("cpu")
        rec = torch.zeros((self.size,) + tuple(row.shape), dtype=torch.int32, device=where)
        rec[self.rank] = bits
        dist.all_reduce(rec, op=dist.ReduceOp.SUM, group=self.process_group)
        return rec.to(row.device).view(row.dtype)

    def gather_rows(self, row: torch.Tensor) -> torch.Tensor:
        """Every rank's ``row`` stacked in rank order → (size, *row.shape),
        the same on every rank: one ``all_reduce`` of a zero-filled record."""
        rec = torch.zeros((self.size,) + tuple(row.shape), dtype=row.dtype, device=row.device)
        rec[self.rank] = row
        return self.all_reduce(rec)

    def collective_bytes(self) -> int:
        """Payload bytes of every collective counted so far."""
        return sum(n * nbytes for (_, nbytes), n in self.counts.items())

    def collective_calls(self) -> int:
        return sum(self.counts.values())


def world_group(axis: str, device, timeout_s: float = 600.0) -> RankGroup:
    """A :class:`RankGroup` over the initialized default process group.  On
    a CUDA device it opens the group's peer region (a collective: every
    rank calls it, in the same order), and raises if CUDA IPC or peer
    access is refused."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    group = RankGroup(rank=dist.get_rank(), size=dist.get_world_size(), axis=axis, device=torch.device(device),
                      backend=str(dist.get_backend()), timeout_s=timeout_s)
    if group.device.type == "cuda":
        device = group.device if group.device.index is not None else torch.device("cuda", torch.cuda.current_device())
        group.device = device
        group.peers = PeerRegion.open(group.rank, group.size, device, group.gather_exact, timeout_s)
    return group


def init_distributed(
    address: str, world_size: int, rank: int, backend: str, device, *,
    axis: str = "bank", timeout_s: float = 600.0,
) -> RankGroup:
    """Join ``world_size`` ranks as ``rank`` through
    ``torch.distributed.init_process_group`` → this rank's group on
    ``axis``.  Every argument is explicit: ``address`` is the rendezvous
    (``tcp://host:port``, the same on every rank), ``backend`` ``"nccl"``
    (one card per rank) or ``"gloo"`` (CPU tensors, or CUDA tensors of
    ranks that share a card), ``device`` this rank's device.  A collective
    that waits longer than ``timeout_s`` raises instead of hanging: the
    process group's, and the peer all-reduce kernel's clock bound."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL's communicator follows the current device
    dist.init_process_group(
        backend=backend, init_method=address, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return world_group(axis, device, timeout_s)
