"""Distributed SLAM engine: a keyframe bank sharded over ranks, edge-sharded solve.

Counterpart of ``nislam_tpu.parallel.engine``: the single engine's step
(``nislam_torch.core.slam``) on every rank, on the same frames, with its
three plug points set —

- **loop search** → :class:`~nislam_torch.parallel.loop_search.ShardedSearch`
  (:func:`~nislam_torch.parallel.loop_search.find_loop_closure_sharded`):
  each rank holds its block of the bank's spectra and cached filters and
  registers the query against its own candidates; one all-reduce of the
  per-rank winners picks the loop;
- **pose-graph solve** → :class:`~nislam_torch.parallel.solver.CGGraph`
  (:func:`~nislam_torch.parallel.solver.solve_pose_graph_cg` as captured
  steps between the collectives; the host loop's), and inside the
  trigger program the same steps: each rank takes its block of the
  edges; every CG iteration costs one all-reduce of a (K, 3) vector;
- **the online canvas** (``map_stitcher.online``) → :class:`ShardedCanvas`:
  the canvas is replicated and stays bit-equal on every rank.  Each rank
  rasterizes the current frame itself (every rank holds it, and the
  scatter is fixed-order); the frame that an insert evicts lives in one
  rank's block and reaches the others through one exact all-reduce of its
  bits; a recompute after a solve is one all-reduce of the canvas deltas
  that each rank rasterizes from the slots it owns (in the trigger
  program, every slot of its block masked by ``slot < count`` on the
  device).

Everything else (tracking, keyframe decisions, the stores, the deferred
driver) is the single engine's code, replicated: each rank tracks every
frame.  A chunk's tracked frames run through the single engine's chunk
graph over this rank's placed state, as JAX's ``run_chunk`` is one
``lax.scan`` with the sharded search inside it.  The keyframe branch is
``core/slam.py``'s :func:`~nislam_torch.core.slam.staged_branch_parts`
over the search's and the canvas's staged forms: for a stored keyframe
the filters (and, with the online canvas over a ring, the evicted slot
and its owner's image staged), the image's all-reduce, the insert with
the search's local part, the record's all-reduce, the merge; a dropped
keyframe makes no collective.  On a card (``RankGroup.capturable``: the
peer all-reduce kernel, at any rank count) the whole branch is one
captured step per kind in the chunk graph's SWITCH
(:class:`~nislam_torch.core.frame_graph.CollectiveFrameGraph`), so a
chunk is one launch, the image all-reduced at every stored keyframe (all
zeros when nothing is evicted) and the launch's one read taking the
merge's frame-id check.  On gloo with CPU tensors
(``SlamEngine.branch_on_host``) a frame that inserts stops the launch
after its track graph, and the host runs the branch as captured steps
between the collectives, reading the evicted slot before the image's
all-reduce; the next launch resumes at the next frame and its read takes
the check with the control block.
The deferred trigger and ``finalize`` run the engine's trigger program
(:meth:`DistributedSlamEngine.make_trigger`,
:class:`~nislam_torch.parallel.solver.CGTrigger`), as JAX's ``optimize``
compiles ``maybe_optimize`` around the sharded GN-CG solve: the trigger
kernel, the masked pending-edge loop and the problem, the GN-CG solve,
the poses, the pending clear, the chain and the masked sharded recompute,
all on the device, with no read of the pending count or slots or of the
bank's count.  On a card the whole trigger is one graph launch with the
all-reduces and the CG stop test inside it, at any rank count; on gloo
with CPU tensors the host makes the all-reduces between captured steps
and reads ‖r‖² once per CG check, as ``CGGraph`` does.  ``optimize_host_loop`` (with
:class:`CGGraph` and the count-read :meth:`ShardedCanvas.recompute`)
stays as its reference.  Device memory for the map's O(K·H·W) leaves
shrinks 1/n per rank; the per-slot tables (poses, cells, ids) stay
replicated.  The solve is always deferred to the chunk boundaries, as
JAX's engine has it: the engine's config is the caller's with
``optimizer.inline`` off.

Every rank must take the same host branch at every frame, or one rank
enters a collective that the others never join.  They do as long as each
rank's kernels are deterministic (cuFFT, ``peak_stats`` and
``scatter_add`` are: no float atomics, sums in a fixed order) and the
replicated state stays equal
(an all-reduce leaves the same bits on every rank).  The loop search
raises if the ranks searched for different frames (the staged search at
the read that follows its branch, before any later collective).

A sharded state is saved by :meth:`DistributedSlamEngine.gather` into a
full one first.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import torch

from nislam_torch.core.map_store import KeyframeBank
from nislam_torch.core.slam import (
    CanvasOps, SlamEngine, SlamState, _map_problem, _stitch_online, init_state, make_engine, map_state,
    trigger_finish, trigger_problem,
)
from nislam_torch.core.stitcher import _RECOMPUTE_BATCH, StitchCanvas, _scatter, insert_frame
from nislam_torch.parallel.loop_search import ShardedSearch
from nislam_torch.parallel.mesh import RankGroup
from nislam_torch.parallel.solver import CGGraph, CGSolverConfig, CGTrigger

# The bank leaves sharded over ranks; the others are replicated.
SHARDED = ("fft", "polar_fft", "filt", "filt_polar", "images")


def _exact_sum(group: RankGroup, part: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks of ``part`` (float32 or bf16), where at most one
    rank holds non-zero bits at each element: one all-reduce of the bits
    as int32, so every rank reads back the owner's bits exactly (a float
    sum would turn −0.0 into +0.0)."""
    bits = part.view(torch.int32 if part.element_size() == 4 else torch.int16)
    return group.all_reduce(bits.to(torch.int32)).to(bits.dtype).view(part.dtype)


class ShardedCanvas:
    """The online canvas of a bank whose images are split in blocks over
    ``group`` (this rank's block starts at ``bank.shard_base``): the
    :class:`~nislam_torch.core.slam.CanvasOps` of the distributed engine.
    Every rank runs the same calls with the same replicated state, and
    each leaves the canvas with the same bits."""

    def __init__(self, group: RankGroup):
        self.group = group

    def retire(self, canvas: StitchCanvas, bank: KeyframeBank, evicted, camera) -> None:
        """Subtract the frame of slot ``evicted`` (replicated, -1: none):
        one host read, then, on an eviction, one all-reduce of the (H, W)
        image's bits from the rank that owns the slot."""
        ev = int(evicted)
        if ev < 0:
            return
        rows = bank.images.shape[0]
        local = ev - bank.shard_base
        image = torch.zeros(bank.images.shape[1:], dtype=bank.images.dtype, device=bank.images.device)
        if 0 <= local < rows:
            image = bank.images[local].clone()
        image = _exact_sum(self.group, image)
        insert_frame(canvas, image, bank.poses[ev], camera, sign=-1.0)

    # The retire split at its collective, for a keyframe branch of captured
    # steps: ``stage`` and ``finish`` run on the device, ``exchange`` on the
    # host between them; the bits and the all-reduce are :meth:`retire`'s.

    @staticmethod
    def buffer(bank: KeyframeBank) -> torch.Tensor:
        """A buffer for the evicted image's bits: (H, W) int32."""
        return torch.zeros(bank.images.shape[1:], dtype=torch.int32, device=bank.images.device)

    @staticmethod
    def stage(buf: torch.Tensor, bank: KeyframeBank, evicted: torch.Tensor) -> None:
        """The bits of slot ``evicted``'s image into ``buf`` on the rank
        that owns the slot, zeros on the others (and for -1: none)."""
        rows = bank.images.shape[0]
        local = evicted - bank.shard_base
        own = (local >= 0) & (local < rows)
        image = bank.images.index_select(0, torch.clamp(local, 0, rows - 1).reshape(1).long())[0]
        buf.copy_(torch.where(own, image.view(torch.int32), 0))

    def exchange(self, evicted: torch.Tensor, buf: torch.Tensor) -> None:
        """On the host: one read of ``evicted``, then, on an eviction, the
        all-reduce of ``buf``'s bits, in place."""
        if int(evicted) >= 0:
            self.group.all_reduce(buf)

    def exchange_all(self, evicted: torch.Tensor, buf: torch.Tensor) -> None:
        """On the device, in a graph: the all-reduce of ``buf``'s bits, in
        place, whatever ``evicted`` holds (no read): with no eviction every
        rank staged zeros, which the exact int32 sum keeps, and
        :meth:`finish` is masked."""
        self.group.all_reduce(buf)

    @staticmethod
    def finish(canvas: StitchCanvas, bank: KeyframeBank, evicted: torch.Tensor, buf: torch.Tensor, camera) -> None:
        """Subtract the all-reduced image at slot ``evicted``'s pose; a
        masked write for -1."""
        pose = bank.poses.index_select(0, torch.clamp(evicted, min=0).reshape(1).long())[0]
        insert_frame(canvas, buf.view(torch.float32), pose, camera, enabled=evicted >= 0, sign=-1.0)

    def recompute(self, canvas: StitchCanvas, bank: KeyframeBank, camera) -> StitchCanvas:
        """Each rank rasterizes the live slots of its block into a zero
        (2, S, S) delta (data, weight), ``_RECOMPUTE_BATCH`` at a time; one
        all-reduce of the deltas is the canvas."""
        if bank.images.shape[1] == 0:
            raise ValueError("keyframe bank stores no images (MapConfig.store_images=False); "
                             "the stitcher needs raw frames to rasterize")
        base, rows = bank.shard_base, bank.images.shape[0]
        live = max(0, min(rows, int(bank.count) - base))
        s = canvas.size
        delta = torch.zeros((2, s, s), dtype=torch.float32, device=canvas.data.device)
        part = StitchCanvas(data=delta[0], weight=delta[1], center_x=canvas.center_x, center_y=canvas.center_y)
        for start in range(0, live, _RECOMPUTE_BATCH):
            sl = slice(start, min(start + _RECOMPUTE_BATCH, live))
            _scatter(part, bank.images[sl], bank.poses[base + sl.start:base + sl.stop], camera, True, 1.0)
        self.group.all_reduce(delta)
        canvas.data.copy_(delta[0])
        canvas.weight.copy_(delta[1])
        return canvas

    # The recompute staged as the trigger program runs it, with no read of
    # the bank's count: ``recompute_stage`` and ``recompute_finish`` on the
    # device, the delta's all-reduce between them (captured on a card); the
    # bits are :meth:`recompute`'s.

    @staticmethod
    def recompute_buffer(canvas: StitchCanvas) -> torch.Tensor:
        """A buffer for the (2, S, S) delta (data, weight)."""
        s = canvas.size
        return torch.zeros((2, s, s), dtype=torch.float32, device=canvas.data.device)

    @staticmethod
    def recompute_stage(delta: torch.Tensor, canvas: StitchCanvas, bank: KeyframeBank, camera) -> None:
        """This rank's part: ``delta`` zeroed, then every slot of its block
        rasterized, ``_RECOMPUTE_BATCH`` at a time, each masked by ``slot <
        count`` on the device, as ``core/stitcher.py::recompute`` masks the
        single engine's.  A masked frame adds nothing (the kernel skips it;
        its plain version adds +0 to a cell that is never −0), so the delta
        is :meth:`recompute`'s bit for bit."""
        if bank.images.shape[1] == 0:
            raise ValueError("keyframe bank stores no images (MapConfig.store_images=False); "
                             "the stitcher needs raw frames to rasterize")
        base, rows = bank.shard_base, bank.images.shape[0]
        live = base + torch.arange(rows, device=bank.count.device) < bank.count
        delta.zero_()
        part = StitchCanvas(data=delta[0], weight=delta[1], center_x=canvas.center_x, center_y=canvas.center_y)
        for start in range(0, rows, _RECOMPUTE_BATCH):
            sl = slice(start, min(start + _RECOMPUTE_BATCH, rows))
            _scatter(part, bank.images[sl], bank.poses[base + sl.start:base + sl.stop], camera, live[sl], 1.0)

    @staticmethod
    def recompute_finish(canvas: StitchCanvas, delta: torch.Tensor) -> None:
        """The all-reduced delta into the canvas."""
        canvas.data.copy_(delta[0])
        canvas.weight.copy_(delta[1])

    def ops(self) -> CanvasOps:
        return CanvasOps(retire=self.retire, recompute=self.recompute, stages=self)


class DistributedSlamEngine(SlamEngine):
    """One SLAM instance whose keyframe bank spans the ranks of ``group``;
    this object is one rank's part of it.  Its ``run_chunk`` and ``step``
    are the single engine's: each rank launches its own chunk graph over
    its tracked frames, the keyframe branch and its collectives inside it
    on a card (on gloo with CPU tensors the branch runs between launches
    as captured steps, the host making the plug points' collectives
    between them).  Every rank takes the same branch at the same frame:
    the flags come from replicated state, with the same bits on every
    rank."""

    def __init__(self, config, cf_ops, camera, group: RankGroup, cg: CGSolverConfig):
        super().__init__(config, cf_ops, camera, group.device)
        self.group = group
        self.loop_search_fn = ShardedSearch(group)
        self.solver_fn = CGGraph(group, cg)
        self.canvas_ops = ShardedCanvas(group).ops()
        self.check_collectives = group.check

    @property
    def collectives_in_graph(self) -> bool:
        """Whether graphs hold the group's all-reduces: on a card."""
        return self.group.capturable

    def make_trigger(self, frame_graph) -> CGTrigger:
        """The deferred trigger over ``frame_graph``'s buffers: the trigger
        kernel, the masked pending-edge loop and the problem
        (``core/slam.py::trigger_problem``), the GN-CG solve of
        :attr:`solver_fn`'s configuration, the poses, the pending clear and
        the chain (``trigger_finish``), and with the online canvas the
        sharded masked recompute (:class:`ShardedCanvas`' staged form)."""
        state, kw = frame_graph.state, dict(config=self.config, camera=self.camera)
        canvas = None
        if _stitch_online(self.config):
            delta = ShardedCanvas.recompute_buffer(state.canvas)
            canvas = SimpleNamespace(
                delta=delta,
                stage=functools.partial(ShardedCanvas.recompute_stage, delta, state.canvas, state.bank, self.camera),
                commit=functools.partial(ShardedCanvas.recompute_finish, state.canvas, delta))
        return CGTrigger(state, self.group, self.solver_fn.cfg, _map_problem(state.bank, state.edges, self.camera),
                         functools.partial(trigger_problem, **kw), functools.partial(trigger_finish, **kw), canvas,
                         frame_graph._stream)

    def _block(self) -> slice:
        k = self.config.map.keyframe_capacity // self.group.size
        return slice(self.group.rank * k, (self.group.rank + 1) * k)

    def init_state(self) -> SlamState:
        return self.place(init_state(self.config, self.device))

    def place(self, state: SlamState) -> SlamState:
        """This rank's copy of a full single-engine state (e.g. from
        ``io.checkpoint.load_state``, or :meth:`gather`): its block of the
        sharded bank leaves, every other leaf whole, on this rank's device.
        Every rank must be given the same state."""
        blk = self._block()
        bank = dataclasses.replace(state.bank, **{name: getattr(state.bank, name)[blk] for name in SHARDED})
        out = map_state(dataclasses.replace(state, bank=bank), lambda x: x.to(self.device, copy=True))
        out.bank.shard_base = blk.start
        return out

    def gather(self, state: SlamState) -> SlamState:
        """The full single-engine state from every rank's sharded one (one
        all-reduce of the bits of each sharded leaf: exact), e.g. to save a
        checkpoint; the same on every rank."""
        blk = self._block()
        k = self.config.map.keyframe_capacity
        full = {}
        for name in SHARDED:
            part = getattr(state.bank, name)
            whole = torch.zeros((k,) + tuple(part.shape[1:]), dtype=part.dtype, device=part.device)
            if part.numel():
                whole[blk] = part
                whole = _exact_sum(self.group, whole)
            full[name] = whole
        return dataclasses.replace(state, bank=dataclasses.replace(state.bank, **full))


def make_distributed_engine(config, group: RankGroup, cg: CGSolverConfig = CGSolverConfig()) -> DistributedSlamEngine:
    """This rank's part of a distributed engine over ``group`` (its
    ``bank`` axis), on ``group.device``.  The keyframe and edge capacities
    must divide by the group size."""
    if group.axis != "bank":
        raise ValueError(f"the distributed engine shards its bank over a 'bank' group, not {group.axis!r}")
    n = group.size
    for name in ("keyframe_capacity", "edge_capacity"):
        if getattr(config.map, name) % n:
            raise ValueError(f"{name} {getattr(config.map, name)} not divisible by {n} 'bank' ranks")
    config = dataclasses.replace(config, optimizer=dataclasses.replace(config.optimizer, inline=False))
    single = make_engine(config, group.device)
    return DistributedSlamEngine(config, single.cf_ops, single.camera, group, cg)
