"""Σ over the ranks of a group, in rank order, the same bits on every rank.

The counterpart of XLA's all-reduce behind JAX's ``psum`` and the gathered
reductions of its ``shard_map``s (``nislam_tpu/parallel/solver.py:106-154``,
``nislam_tpu/parallel/loop_search.py:130``), which JAX runs inside its
compiled programs at any device count.  On the card it is the hand-written
kernel ``nislam_torch/csrc/all_reduce.cu``: each rank copies its payload
into a slot of a region of its own, which every peer maps over CUDA IPC
(:class:`PeerRegion`), and sums the peers' slots in rank order, so the
call is one plain kernel node that a conditional graph body holds, with
the same bits eager and captured.  On the CPU it is
:func:`all_reduce_reference`, the plain version the kernel is held
against: every rank's payload gathered exactly through the process group,
then summed in rank order.

``out[i] = ((x_0[i] + x_1[i]) + x_2[i]) + …``: float32 summed in float32
with adds only, int32 exactly.  Those are the dtypes the port's
collectives carry: float32 (the GN-CG gradient block, its CG vectors and
cost, the loop search's winner record, the canvas delta, the fleet's
gathered outputs) and int32 (the bits of an evicted keyframe image and of
a gathered bank leaf, ``parallel/engine.py::_exact_sum``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import Callable, Optional

import torch

# The kernel's dtype codes (csrc/all_reduce.cu's DType).
DTYPES = {torch.float32: 0, torch.int32: 1}
# Bytes of one payload slot (two per rank): a larger payload moves in
# rounds of a slot each, within one launch.
SLOT_BYTES = 8 << 20

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
    ``csrc/all_reduce.cu`` lays them out: two payload slots, arrival
    words, the epoch, and a mapped host error word.  :meth:`open` makes it:
    a collective of the group (every rank calls it once, in the same
    order)."""

    def __init__(self, ctx: int, device: torch.device, size: int, timeout_s: float):
        self._lib = _library()
        self._ctx = ctx
        self.device = device
        self.size = size
        self.timeout_ns = int(timeout_s * 1e9)
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
        if size > lib.nislam_ar_max_ranks():
            raise ValueError(f"the peer all-reduce takes at most {lib.nislam_ar_max_ranks()} ranks, got {size}")
        row = (ctypes.c_char * lib.nislam_ar_row_bytes())()
        ctx = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(lib.nislam_ar_create(rank, size, SLOT_BYTES, ctypes.byref(ctx), row),
                   "allocating the all-reduce's peer region")
            region = cls(ctx.value, device, size, timeout_s)
            mine = torch.frombuffer(bytearray(row.raw), dtype=torch.int32)
            rows = gather(mine).to("cpu", torch.int32).contiguous()
            _check(lib.nislam_ar_open(ctx, rows.data_ptr()),
                   "opening the peers' all-reduce regions (CUDA IPC and peer access)")
        return region

    def launch(self, x: torch.Tensor) -> None:
        """One all-reduce of ``x`` in place on the current stream."""
        code = DTYPES.get(x.dtype)
        if code is None:
            raise TypeError(f"the all_reduce kernel takes {sorted(map(str, DTYPES))}, got {x.dtype}")
        if not x.is_cuda or x.device != self.device or not x.is_contiguous() or x.numel() == 0:
            raise ValueError(f"the all_reduce kernel takes a contiguous non-empty tensor on {self.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
        index = x.device.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        with torch.cuda.device(index):
            _check(self._lib.nislam_ar_launch(self._ctx, x.data_ptr(), x.data_ptr(), x.numel(), code,
                                              self.timeout_ns, stream), "launching the all_reduce kernel")

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
    replay, ``core/track_graph.py``)."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and x.is_cuda):
        if group.peers is None:
            raise RuntimeError("the group has no peer region: its all-reduce on a card needs one (world_group "
                               "opens it for a CUDA device)")
        group.peers.launch(x)
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
