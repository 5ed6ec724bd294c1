"""What the reduction kernels' wrappers share: the launch geometry and
the persistent workspace; and the binding of the conditional-graph
library.

Both ``peak_stats`` and ``sum_only`` read each (H, W) array once, spread
over many blocks, and merge the blocks' partial results in the block that
finishes last (one launch, see ``csrc/peak_stats.cu``).  The geometry says
which block reads what; the workspace holds the partial results and the
per-array ticket counters between launches.

:func:`cond_graph_library` is ``csrc/cond_graph.cu``, the library that
builds and launches a chunk of frames as one conditional CUDA graph over
graphs that PyTorch captured (``nislam_torch/core/chunk_graph.py``), and
the deferred pose-graph trigger as another (``core/solve_graph.py``), and
the distributed engine's GN-CG trigger as a third
(``parallel/solver.py::CGTrigger``); :func:`launch_trigger`,
:func:`launch_lm_step` and :func:`launch_cg_step` launch their kernels
outside a graph.  :func:`bind_all_reduce` declares ``csrc/all_reduce.cu``'s
entry points (the peer-memory all-reduce, ``ops/all_reduce.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Optional, Tuple

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
                 aligned: bool = True, blocks: int | None = None) -> Tuple[int, int, int]:
    """Launch geometry for ``b`` arrays of (h, w) → ``(blocks per array,
    units per block, unit)``.

    Block ``k`` of an array reads the flat elements ``[k·chunk·unit,
    min(h·w, (k+1)·chunk·unit))``.  ``unit`` is 4 (16-byte loads) when
    every array and every range starts on a 16-byte boundary (``aligned``
    says that the base pointer does), else 1.  Without ``rows`` a range is
    a whole number of ``TILE``s, sized so that the batch gets about
    ``TARGET_BLOCKS`` blocks, an array at most ``MERGE_WIDTH``, and never
    more blocks than it holds tiles; ``blocks`` pins the blocks an array
    aims for in place of the batch's share of ``TARGET_BLOCKS`` (so an
    array is split as it would be in a launch of another batch size);
    ``rows`` pins a range to that many rows instead."""
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"need a non-empty batch of non-empty arrays, got {b} x ({h}, {w})")
    n = h * w
    if rows is None:
        unit = 4 if aligned and n % 4 == 0 else 1
        u = n // unit
        tiles = -(-u // TILE)
        share = TARGET_BLOCKS // b if blocks is None else blocks
        per_array = max(1, min(tiles, MERGE_WIDTH, share))
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
                     words_per_block: int, out: torch.Tensor, blocks: int | None = None) -> None:
    """Launches a reduction kernel's C entry point ``entry`` over ``x`` (as
    :func:`check_input` returned it) into ``out`` on the current stream of
    ``x``'s device, with the geometry of :func:`block_ranges` (``blocks``:
    its pin of the blocks per array) and the
    stream's workspace (``words_per_block`` words of partial result per
    block).  Raises if the launch is refused, and drops the workspace then.

    A plain C launch goes to the calling thread's current device, so a
    device context is entered, but only when ``x``'s device is not current
    already."""
    h, w = x.shape[-2], x.shape[-1]
    b = x.numel() // (h * w)
    s, chunk, unit = block_ranges(b, h, w, rows, aligned=x.data_ptr() % 16 == 0, blocks=blocks)
    index = x.device.index
    with contextlib.nullcontext() if index == torch.cuda.current_device() else torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        ws = workspace.get(x.device, stream, words_per_block * b * s)
        err = entry(x.data_ptr(), b, h, w, s, chunk, int(unit == 4), ws.data_ptr(), ws.numel(),
                    out.data_ptr(), stream)
    if err != 0:
        workspace.drop(x.device, stream)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@functools.cache
def cond_graph_library() -> ctypes.CDLL:
    """``csrc/cond_graph.cu``'s library, built and bound at the first call."""
    from nislam_torch.kernels.build import load_library

    return load_library("cond_graph", _bind_cond_graph)


def cuda_check(err: int, what: str) -> None:
    """Raise unless the C entry point returned 0 (a cudaError_t)."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _bind_cond_graph(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of the conditional-graph library."""
    p, i, q, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    pp = ctypes.POINTER(ctypes.c_void_p)
    f, d = ctypes.c_float, ctypes.c_double
    table = [p, q, p, q, p, q, p, q, p]  # the three sources and strides, the output and its lane stride, the stream
    # control, pending count and slots, run, active, mu, lanes, schedule, gate and its stride
    trigger = [p, p, p, i, p, p, p, i, f, f, i, p, i]
    lm_step = [p, p, p, p, p, i, f, f, f, i]  # control, mu, active, accept, small, lanes, schedule
    signatures = {
        "nislam_graph_node_types": [p, p, i],
        "nislam_cg_create": [pp, p, i, p, q, p, q],
        "nislam_cg_add_child": [p, p],
        "nislam_cg_add_flags": [p, p, u, i],
        "nislam_cg_add_switch": [p, pp, p, q],
        "nislam_cg_add_advance": [p, p, i],
        "nislam_cg_instantiate": [p],
        "nislam_cg_begin": [p, i, i, *table],
        "nislam_cg_launch": [p, i, i, *table],
        "nislam_cg_add_inline": [p, *trigger, p, p, p, *lm_step],
        "nislam_cg_describe": [p, p, i],
        "nislam_cg_destroy": [p],
        "nislam_cg_empty_graph": [pp, i],
        "nislam_graph_destroy": [p],
        "nislam_trigger_launch": [*trigger, p],
        "nislam_lm_step_launch": [*lm_step, p],
        "nislam_sg_create": [pp, *trigger, p, p, p, *lm_step],
        "nislam_sg_instantiate": [p],
        "nislam_sg_launch": [p, p],
        "nislam_sg_describe": [p, p, i],
        "nislam_sg_destroy": [p],
        "nislam_solve_device_launches": [p],
        "nislam_cg_step_launch": [p, p, i, i, i, d, p],
        "nislam_cg_step_device_launches": [p],
        "nislam_tg_create": [pp, *trigger, p, p, p, p, p, p, i, i, d],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int


def trigger_args(ctl: torch.Tensor, count: torch.Tensor, loop_slot: torch.Tensor, run: torch.Tensor, control,
                 cfg, gate: Optional[torch.Tensor] = None) -> list:
    """The trigger kernel's arguments (``nislam_trigger_launch``,
    ``nislam_sg_create``, ``nislam_cg_add_inline``): the control words,
    the lanes' pending counts (R,) and loop slots (R, P), the (R,) bool
    run flags, ``control``'s lane mask and μ (an ``LMControl``), the
    schedule of ``cfg``, and for the inline trigger ``gate``: each lane's
    ``loop_found`` field, float32 (R,) (a view with any stride; None: no
    gate)."""
    for x, what in ((ctl, "control words"), (count, "pending count"), (loop_slot, "pending loop slots")):
        if x.dtype != torch.int32 or not x.is_contiguous() or not x.is_cuda:
            raise ValueError(f"the trigger kernel takes a contiguous int32 CUDA tensor of {what}")
    lanes = control.mu.shape[0]
    if run.dtype != torch.bool or control.active.dtype != torch.bool or run.numel() != lanes or lanes > 32:
        raise ValueError(f"the trigger kernel takes (R,) bool run flags and lane mask, R <= 32, got {lanes} lanes")
    if count.numel() != lanes or loop_slot.numel() % lanes:
        raise ValueError(f"the trigger's pending buffer {tuple(loop_slot.shape)} does not fit {lanes} lanes")
    if gate is not None and (gate.dtype != torch.float32 or not gate.is_cuda or gate.numel() != lanes):
        raise ValueError(f"the trigger's gate must be {lanes} float32 CUDA values, got {tuple(gate.shape)} "
                         f"{gate.dtype}")
    stride = 0 if gate is None or gate.dim() == 0 else gate.stride(0)
    return [ctl.data_ptr(), count.data_ptr(), loop_slot.data_ptr(), loop_slot.numel() // lanes,
            run.data_ptr(), control.active.data_ptr(), control.mu.data_ptr(), lanes, cfg.mu_init,
            cfg.mu_max, cfg.max_iterations, None if gate is None else gate.data_ptr(), stride]


def lm_step_args(control, cfg) -> list:
    """The ``lm_step`` kernel's arguments (``nislam_lm_step_launch``,
    ``nislam_sg_create``, ``nislam_cg_add_inline``) over ``control``'s buffers (an
    ``LMControl``)."""
    lanes = control.mu.shape[0]
    bufs = (control.ctl, control.mu, control.active, control.accept, control.small)
    if not all(x.is_cuda and x.is_contiguous() for x in bufs) or control.mu.dtype != torch.float32:
        raise ValueError("the lm_step kernel takes contiguous CUDA buffers (f32 mu, bool flags, int32 control)")
    if lanes > 32:
        raise ValueError(f"the lm_step kernel takes at most 32 lanes, got {lanes}")
    return [*(x.data_ptr() for x in bufs), lanes, cfg.mu_factor, cfg.mu_min, cfg.mu_max, cfg.max_iterations]


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_trigger(ctl: torch.Tensor, count: torch.Tensor, loop_slot: torch.Tensor, run: torch.Tensor, control,
                   cfg, gate: Optional[torch.Tensor] = None) -> None:
    """The trigger kernel on the current stream, outside a graph."""
    args = trigger_args(ctl, count, loop_slot, run, control, cfg, gate)
    cuda_check(cond_graph_library().nislam_trigger_launch(*args, _stream(ctl.device)), "launching the trigger kernel")


def launch_lm_step(control, cfg) -> None:
    """The ``lm_step`` kernel on the current stream, outside a graph."""
    cuda_check(cond_graph_library().nislam_lm_step_launch(*lm_step_args(control, cfg), _stream(control.mu.device)),
               "launching the lm_step kernel")


def solve_device_launches(device: torch.device) -> Tuple[int, int]:
    """The trigger's and ``lm_step``'s launches that have run on ``device``,
    as the kernels count them (inside graphs too).  Waits for the device."""
    n = (ctypes.c_ulonglong * 2)()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        cuda_check(cond_graph_library().nislam_solve_device_launches(n), "reading the solve kernels' launch counts")
    return n[0], n[1]


def cg_step_args(ctl: torch.Tensor, r2: torch.Tensor, cfg) -> list:
    """The ``cg_step`` kernel's arguments after its mode
    (``nislam_cg_step_launch``, ``nislam_tg_create``): the control words'
    and ‖r‖²'s addresses (a contiguous int32 and a one-element float32
    CUDA tensor), ``cfg``'s CG and Gauss-Newton iterations (a
    ``CGSolverConfig``), and ``cfg.cg_tol ** 2`` as a double."""
    if ctl.dtype != torch.int32 or not ctl.is_contiguous() or not ctl.is_cuda:
        raise ValueError("the cg_step kernel takes contiguous int32 CUDA control words")
    if r2.dtype != torch.float32 or r2.numel() != 1 or not r2.is_cuda:
        raise ValueError(f"the cg_step kernel takes one float32 CUDA |r|^2, got {tuple(r2.shape)} {r2.dtype}")
    return [ctl.data_ptr(), r2.data_ptr(), cfg.cg_iterations, cfg.outer_iterations, cfg.cg_tol ** 2]


def launch_cg_step(ctl: torch.Tensor, r2: torch.Tensor, mode: int, cfg) -> None:
    """The ``cg_step`` kernel on the current stream, outside a graph."""
    ptr, r2p, cg, outer, tol2 = cg_step_args(ctl, r2, cfg)
    cuda_check(cond_graph_library().nislam_cg_step_launch(ptr, r2p, mode, cg, outer, tol2, _stream(ctl.device)),
               "launching the cg_step kernel")


def cg_step_device_launches(device: torch.device) -> int:
    """The ``cg_step`` kernel's launches that have run on ``device`` (inside
    graphs too).  Waits for the device."""
    n = ctypes.c_ulonglong()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        cuda_check(cond_graph_library().nislam_cg_step_device_launches(ctypes.byref(n)),
                   "reading the cg_step kernel's launch count")
    return n.value


def bind_all_reduce(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of ``csrc/all_reduce.cu``'s library: the
    region's set-up (create, open the peers', destroy), the launch with the
    host's plan (``ops/all_reduce.py::launch_plan``), the mapped error
    word, the device count and the limits the plan reads."""
    p, i, q, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    signatures = {
        "nislam_ar_create": [i, i, q, q, ctypes.POINTER(ctypes.c_void_p), p],
        "nislam_ar_open": [p, p],
        "nislam_ar_launch": [p, p, p, q, i, ctypes.POINTER(q), i, u, p],
        "nislam_ar_error": [p],
        "nislam_ar_device_launches": [ctypes.POINTER(ctypes.c_ulonglong)],
        "nislam_ar_row_bytes": [],
        "nislam_ar_max_ranks": [],
        "nislam_ar_plan_words": [],
        "nislam_ar_threads": [],
        "nislam_ar_max_blocks": [i],
        "nislam_ar_destroy": [p],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
