"""What the reduction kernels' wrappers share: the launch geometry and
the persistent workspace.

Both ``peak_stats`` and ``sum_only`` read each (H, W) array once, spread
over many blocks, and merge the blocks' partial results in the block that
finishes last (one launch, see ``csrc/peak_stats.cu``).  The geometry says
which block reads what; the workspace holds the partial results and the
per-array ticket counters between launches.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import torch

THREADS = 256
# Units one block consumes per loop iteration: every thread starts four
# independent loads before it uses the first.
TILE = 4 * THREADS
# Blocks a launch aims for over the whole batch: what the H100 holds at
# once, eight blocks of 256 threads on each of its 132 SMs.
TARGET_BLOCKS = 8 * 132
# Most blocks one array gets: the partials that the merging warp loads in
# one round (32 lanes, eight loads in flight each; the kernels' kMergeLoads).
MERGE_WIDTH = 32 * 8
# Ticket counters at the front of the workspace, one per array of a batch
# (32-bit words); the kernels' kCounters.
COUNTERS = 65536


def block_ranges(b: int, h: int, w: int, rows: int | None = None,
                 aligned: bool = True) -> Tuple[int, int, int]:
    """Launch geometry for ``b`` arrays of (h, w) → ``(blocks per array,
    units per block, unit)``.

    Block ``k`` of an array reads the flat elements ``[k·chunk·unit,
    min(h·w, (k+1)·chunk·unit))``.  ``unit`` is 4 (16-byte loads) when
    every array and every range starts on a 16-byte boundary (``aligned``
    says that the base pointer does), else 1.  Without ``rows`` a range is
    a whole number of ``TILE``s, sized so that the batch gets about
    ``TARGET_BLOCKS`` blocks, an array at most ``MERGE_WIDTH``, and never
    more blocks than it holds tiles; ``rows`` pins a range to that many
    rows instead."""
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"need a non-empty batch of non-empty arrays, got {b} x ({h}, {w})")
    n = h * w
    if rows is None:
        unit = 4 if aligned and n % 4 == 0 else 1
        u = n // unit
        tiles = -(-u // TILE)
        per_array = max(1, min(tiles, MERGE_WIDTH, TARGET_BLOCKS // b))
        chunk = min(u, -(-tiles // per_array) * TILE)
    else:
        if rows < 1:
            raise ValueError(f"rows must be positive, got {rows}")
        span = min(rows, h) * w
        unit = 4 if aligned and n % 4 == 0 and span % 4 == 0 else 1
        u, chunk = n // unit, span // unit
    return -(-u // chunk), chunk, unit


class Workspace:
    """One zero-initialised int32 buffer per (device, stream), grown on
    demand: ``COUNTERS`` ticket counters, then room for partial results.

    A kernel leaves every counter at 0 when it ends, and kernels on one
    stream run in order, so the next launch on that stream can use the
    same buffer with no memset and no allocation.  A buffer that is
    outgrown is replaced by a larger zeroed one; launches already queued
    keep the old one, which the caching allocator hands out again only to
    work queued later on the same stream.  ``drop`` forgets a buffer whose
    launch failed, so that a counter left dirty cannot reach a later call."""

    def __init__(self) -> None:
        self._buffers: dict = {}

    def get(self, device: torch.device, stream: int, words: int) -> torch.Tensor:
        """The buffer of ``stream`` on ``device`` with room for ``words``
        32-bit words of partial results after the counters."""
        key = (device.index, stream)
        buf = self._buffers.get(key)
        need = COUNTERS + words
        if buf is None or buf.numel() < need:
            size = max(need, COUNTERS + 16 * TARGET_BLOCKS)
            if buf is not None:
                size = max(size, 2 * buf.numel())
            buf = torch.zeros(size, dtype=torch.int32, device=device)
            self._buffers[key] = buf
        return buf

    def drop(self, device: torch.device, stream: int) -> None:
        self._buffers.pop((device.index, stream), None)


workspace = Workspace()


def check_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """Checks what the kernels take (a non-empty float32 CUDA (..., H, W),
    one array indexed with int32, at most ``COUNTERS - 1`` arrays) →
    contiguous ``x``."""
    if not x.is_cuda:
        raise ValueError(f"the {name} kernel takes a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"{name} needs a non-empty (..., H, W), got {tuple(x.shape)}")
    h, w = x.shape[-2], x.shape[-1]
    if h * w >= 2**31:
        raise ValueError(f"{name} kernel indexes one array with int32")
    b = x.numel() // (h * w)
    if b >= COUNTERS:
        raise ValueError(f"{name} kernel takes fewer than {COUNTERS} arrays, got {b}")
    return x.contiguous()


def launch_reduction(entry: Callable[..., int], name: str, x: torch.Tensor, rows: int | None,
                     words_per_block: int, out: torch.Tensor) -> None:
    """Launches a reduction kernel's C entry point ``entry`` over ``x`` (as
    :func:`check_input` returned it) into ``out`` on the current stream of
    ``x``'s device, with the geometry of :func:`block_ranges` and the
    stream's workspace (``words_per_block`` words of partial result per
    block).  Raises if the launch is refused, and drops the workspace then.

    A plain C launch goes to the calling thread's current device, so a
    device context is entered, but only when ``x``'s device is not current
    already."""
    h, w = x.shape[-2], x.shape[-1]
    b = x.numel() // (h * w)
    s, chunk, unit = block_ranges(b, h, w, rows, aligned=x.data_ptr() % 16 == 0)
    index = x.device.index
    with contextlib.nullcontext() if index == torch.cuda.current_device() else torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        ws = workspace.get(x.device, stream, words_per_block * b * s)
        err = entry(x.data_ptr(), b, h, w, s, chunk, int(unit == 4), ws.data_ptr(), ws.numel(),
                    out.data_ptr(), stream)
    if err != 0:
        workspace.drop(x.device, stream)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
