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
``all_reduce``: an all-gather is one ``all_reduce`` of a zero-filled
(n, ...) record in which each rank writes its own row
(:meth:`RankGroup.gather_rows`): that runs unchanged on gloo with CPU
tensors, on gloo with CUDA tensors (ranks sharing one card) and on NCCL.
Summing a value with zeros is exact, so every rank reads back the same
bits as the rank that wrote them.

Importing this module starts nothing; :func:`init_distributed` does.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class RankGroup:
    """This process's place in a group of ranks along one axis.

    ``process_group`` None is the default (world) group.  ``counts`` maps
    ``(operation, payload bytes)`` to the number of such calls run
    through this object: a call in a captured graph counts once per
    execution on the device (:meth:`count_executions`).  ``backend``:
    the process group's (``"nccl"``, ``"gloo"``; None: no process group,
    as a test's stub)."""

    rank: int
    size: int
    axis: str
    device: torch.device
    process_group: Optional[dist.ProcessGroup] = None
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    backend: Optional[str] = None

    @property
    def capturable(self) -> bool:
        """Whether a conditional CUDA graph body can hold this group's
        all-reduce: on one NCCL rank its capture is one memcpy node, which
        a body takes; at more ranks it holds event record and wait nodes
        besides its kernel, which a body refuses; gloo's goes through the
        host (``scripts/captureprobe.py --nccl [--ranks N]``)."""
        return self.backend == "nccl" and self.size == 1

    def _record(self, op: str, t: torch.Tensor, n: int = 1) -> None:
        if n:
            self.counts[(op, t.numel() * t.element_size())] += n

    def count_executions(self, t: torch.Tensor, n: int) -> None:
        """Count ``n`` device executions of a captured all-reduce of ``t``."""
        self._record("all_reduce", t, n)

    def all_reduce(self, t: torch.Tensor, record: bool = True) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``.  ``record``
        False: not counted here (a call that a graph captures, whose
        executions the caller counts)."""
        if record:
            self._record("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.process_group)
        return t

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


def world_group(axis: str, device) -> RankGroup:
    """A :class:`RankGroup` over the initialized default process group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    return RankGroup(rank=dist.get_rank(), size=dist.get_world_size(), axis=axis,
                     device=torch.device(device), backend=str(dist.get_backend()))


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
    that waits longer than ``timeout_s`` raises instead of hanging."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL's communicator follows the current device
    dist.init_process_group(
        backend=backend, init_method=address, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return world_group(axis, device)
