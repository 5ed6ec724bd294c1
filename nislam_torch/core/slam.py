"""The SLAM engine: per-frame step, chunked sequence loops, pose-graph solve.

Counterpart of ``nislam_tpu.core.slam``: the deferred solve between chunks
(default) or the inline solve inside the step (``optimizer.inline``), and
the online stitcher (``map_stitcher.online``).  Where the JAX step is one
branch-free program with ``lax.cond``, compiled with the chunk's loop into
one XLA program:

- the front end (undistort + KCC features) runs batched over a chunk;
- a tracked frame runs on the device as captured CUDA graphs on a card,
  the same bodies run eagerly on the same buffers on the CPU.  The single
  engine's path (deferred solve, no plug points) is the
  :class:`~nislam_torch.core.chunk_graph.ChunkGraph`: the state's every
  leaf at fixed addresses (the
  :class:`~nislam_torch.core.frame_graph.FrameGraph`'s), and a chunk's
  tracked frames as ONE graph launch, a WHILE over the frames whose body
  runs the track graph (tracking, the keyframe decision, the output of a
  frame that inserts nothing), under a SWITCH node set from the packed
  ``[insert, stored]`` flags on the device the keyframe branch's graph
  of that kind, after the frame's spectrum is copied in (filters,
  insert, edge, pending invalidation, online canvas, loop search with
  its pending append: :func:`_branch_body`), as JAX's ``lax.cond`` does,
  then copies the next frame's features in.  With ``optimizer.inline``
  the stored branch's body then runs the inline trigger, JAX's
  ``lax.cond`` over ``_flush_pending_loops``: the solve graph's trigger
  gated by the frame's ``loop_found``, and under an IF its setup, the LM
  loop and :func:`_inline_finish` (the poses, the online canvas, the
  pending clear, the chain and the frame's output).  A step is a chunk
  of one.  :func:`run_chunk_frame_graph` runs the same graphs frame by
  frame with one flag read each, the reference.  The distributed
  engine's plug points (its sharded search and canvas) make collectives:
  on a card they are the peer all-reduce kernel (``ops/all_reduce.py``),
  which a graph holds, so its chunk graph holds its branch too (a
  :class:`~nislam_torch.core.frame_graph.CollectiveFrameGraph`: each
  kind's :func:`staged_branch_parts` as one captured step under the
  SWITCH), as JAX's distributed engine runs its sharded search inside the
  scan; on gloo with CPU tensors the host makes them
  (:attr:`SlamEngine.branch_on_host`): the chunk graph holds the track
  graph alone over its placed state's buffers (a
  :class:`~nislam_torch.core.frame_graph.HostBranchFrameGraph`), a frame
  that inserts stops the launch after its track graph, the branch runs
  as captured steps on those buffers with the host making the plug
  points' collectives between them, and the next launch resumes at the
  next frame.  :func:`run_chunk_track_graph`
  (the track-graph path: the
  :class:`~nislam_torch.core.track_graph.TrackGraph` over a copy of the
  tracking chain, a flag read per frame, the branch eager on the
  caller's state) is kept as its reference.

:func:`run_chunk_eager` and :func:`slam_step` are the same loop with every
operation launched eagerly, the reference that the graphs are held
against.

The deferred trigger (:meth:`SlamEngine.optimize`, :meth:`SlamEngine.
finalize`) of the same engines is the
:class:`~nislam_torch.core.solve_graph.SolveGraph` over the frame graph's
buffers: one graph launch (the pending edges, the LM loop as a WHILE node
with its damping on the device, the poses, the online canvas, the
pending clear and the chain: :func:`_solve_setup`, :func:`_solve_finish`)
and one read of its run flags.  The distributed engine's (a
``solver_fn`` and canvas hook) is its trigger program over the same
buffers (``parallel/solver.py::CGTrigger``, made by
:meth:`SlamEngine.make_trigger`: the trigger kernel, the masked
pending-edge loop and the problem (:func:`trigger_problem`), the GN-CG
solve, the poses, the pending clear and the chain
(:func:`trigger_finish`) and the sharded masked recompute, all on the
device; on a card, at any rank count, one graph launch with the
all-reduces and the CG stop test inside).
:func:`optimize_host_loop` and :func:`finalize_host_loop` keep the
trigger as a host loop (:func:`maybe_optimize`), the reference; a state
before its first frame takes it.

Host syncs: one read of the chunk graph's control block per chunk (and
per step; with the inline solve, the solve graph's growing counts in the
same read), and ``state.track.initialized`` unless the state is the one
the graph lent last; the flag read per tracked frame on the other paths
(and one read of the inline trigger's counts per chunk through the frame
graph); one read of the solve graph's run flags per trigger; on the host
loop's path the live pending count (once per trigger, and once per
stored keyframe with the inline solve), after it the pending count and
slots (once) and the LM loop's condition once per iteration.  The
distributed engine's chunk graph makes one read per launch (the control
block and the search's frame-id check): on a card one launch per chunk;
on gloo with CPU tensors one launch more than its frames that insert
(none more when its last frame inserts: one read of the check after its
branch instead), the stopped frame's flags in each read, and its canvas
hook reads the evicted slot per stored keyframe; its trigger program
makes one read after its launch on a card, and else one read of the run
flag and one of ‖r‖² per CG check.

The state is mutated in place (the bank, edge store and pending buffer are
written slot by slot), or, through the frame graph, is the graph's own
buffers (see :class:`~nislam_torch.core.frame_graph.FrameGraph`); JAX
donates it instead.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nislam_torch.core.camera import CameraOps, make_camera_ops
from nislam_torch.core.chunk_graph import ChunkGraph
from nislam_torch.core.frame_graph import (
    CollectiveFrameGraph, FrameGraph, HostBranchFrameGraph, lane_view, write_back,
)
from nislam_torch.core.loop_closure import LoopResult, find_loop_closure, find_loop_closure_lanes, no_loop_result
from nislam_torch.core.map_store import (
    EDGE_KCC,
    EDGE_LOOP,
    EdgeStore,
    KeyframeBank,
    _write_lanes,
    write_slot,
    add_edge,
    add_edge_lanes,
    add_keyframe,
    add_keyframe_lanes,
    gather_lanes,
    invalidate_edges,
    invalidate_edges_lanes,
    make_edge_store,
    make_keyframe_bank,
    plan_insert,
    plan_insert_lanes,
    scatter_lanes,
)
from nislam_torch.core.pose_graph import (
    PoseGraphProblem,
    SolverConfig,
    solve_pose_graph,
    sqrt_information,
)
from nislam_torch.core.se2 import absolute_pose, relative_pose
from nislam_torch.core.solve_graph import SolveGraph, lanes_first
from nislam_torch.core.stitcher import StitchCanvas, insert_frame, make_canvas, recompute
from nislam_torch.core.track_graph import TrackGraph
from nislam_torch.ops.fft import c2r, r2c
from nislam_torch.ops.registration import (
    CFOps,
    compute_intermedium,
    compute_keyframe_filters,
    compute_pose,
    make_cf_ops,
)


@dataclasses.dataclass
class TrackState:
    """Keyframe-relative tracking chain; ``last_*`` advance on insert."""

    last_fft: torch.Tensor  # (H, W//2+1, 2) f32 pair
    last_polar: torch.Tensor  # (D, C//2+1, 2) f32 pair
    last_filt: torch.Tensor  # (H, W//2+1, 2) f32 pair
    last_filt_polar: torch.Tensor  # (D, C//2+1, 2) f32 pair
    last_cf_pose: torch.Tensor  # (3,) image-plane (principal) chain
    last_cf_real_pose: torch.Tensor  # (3,) camera frame
    last_pose: torch.Tensor  # (3,) robot frame
    last_slot: torch.Tensor  # () i32
    distance: torch.Tensor  # () f32
    next_frame_id: torch.Tensor  # () i32
    initialized: torch.Tensor  # () bool


@dataclasses.dataclass
class PendingLoops:
    """Loop matches awaiting the ≥2-matches optimize trigger."""

    loop_slot: torch.Tensor  # (P,) i32
    cur_slot: torch.Tensor  # (P,) i32
    rel_pose: torch.Tensor  # (P, 3) image plane, principal-based
    count: torch.Tensor  # () i32


@dataclasses.dataclass
class SlamState:
    bank: KeyframeBank
    edges: EdgeStore
    track: TrackState
    pending: PendingLoops
    # Occupancy mosaic, live only with map_stitcher.online (else (0, 0)
    # placeholders): insert on keyframe, recompute after every solve.
    canvas: StitchCanvas


class StepOutput(NamedTuple):
    tracked: torch.Tensor  # bool
    inserted: torch.Tensor  # bool
    loop_found: torch.Tensor  # bool
    optimized: torch.Tensor  # bool: the inline solve ran this frame
    response: torch.Tensor  # (3,) PSR confidences
    cf_pose: torch.Tensor  # (3,) raw KCC odometry, robot frame
    pose: torch.Tensor  # (3,) robot pose
    frame_id: torch.Tensor  # i32
    keyframe_slot: torch.Tensor  # i32, -1 unless inserted
    loop_slot: torch.Tensor  # i32, -1 unless loop_found
    loop_eligible: torch.Tensor  # i32 candidates the loop search saw

    def pack(self) -> torch.Tensor:
        """All fields as one (..., 17) f32 vector (ids are exact below 2^24)."""
        f = lambda x: x.to(torch.float32)
        return torch.stack(
            [
                f(self.tracked), f(self.inserted), f(self.loop_found), f(self.optimized),
                self.response[..., 0], self.response[..., 1], self.response[..., 2],
                self.cf_pose[..., 0], self.cf_pose[..., 1], self.cf_pose[..., 2],
                self.pose[..., 0], self.pose[..., 1], self.pose[..., 2],
                f(self.frame_id), f(self.keyframe_slot), f(self.loop_slot),
                f(self.loop_eligible),
            ],
            dim=-1,
        )


def unpack_step_output(v) -> StepOutput:
    """Inverse of :meth:`StepOutput.pack`, for a tensor or a numpy array."""
    if isinstance(v, torch.Tensor):
        i = lambda x: x.to(torch.int32)
    else:
        v = np.asarray(v)
        i = lambda x: x.astype(np.int32)
    return StepOutput(
        tracked=v[..., 0] > 0.5,
        inserted=v[..., 1] > 0.5,
        loop_found=v[..., 2] > 0.5,
        optimized=v[..., 3] > 0.5,
        response=v[..., 4:7],
        cf_pose=v[..., 7:10],
        pose=v[..., 10:13],
        frame_id=i(v[..., 13]),
        keyframe_slot=i(v[..., 14]),
        loop_slot=i(v[..., 15]),
        loop_eligible=i(v[..., 16]),
    )


def pack_outputs(outs: StepOutput) -> np.ndarray:
    """Numpy (or host) per-frame outputs packed as :meth:`StepOutput.pack`
    does → a (..., 17) f32 numpy array (inverse of :func:`unpack_step_output`)."""
    return StepOutput(*(torch.as_tensor(np.asarray(x)) for x in outs)).pack().numpy()


def dead_step_output(batch: Tuple[int, ...] = (), device: torch.device = torch.device("cpu")) -> StepOutput:
    """An inert per-frame output (empty drivers)."""
    b = torch.zeros(batch, dtype=torch.bool, device=device)
    i = torch.full(batch, -1, dtype=torch.int32, device=device)
    v3 = torch.zeros(batch + (3,), dtype=torch.float32, device=device)
    return StepOutput(
        tracked=b, inserted=b, loop_found=b, optimized=b,
        response=v3, cf_pose=v3, pose=v3,
        frame_id=i, keyframe_slot=i, loop_slot=i,
        loop_eligible=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def empty_step_output(device: torch.device = torch.device("cpu")) -> StepOutput:
    """A zero-frame ``StepOutput``."""
    return dead_step_output((0,), device)


def _stitch_online(config) -> bool:
    ms = config.map_stitcher
    if ms.stitch_map and ms.online and not config.map.store_images:
        raise ValueError(
            "map_stitcher.online requires map.store_images (the recompute "
            "after optimization re-rasterizes stored keyframe images)"
        )
    return ms.stitch_map and ms.online


def _no_canvas(device: torch.device) -> StitchCanvas:
    zeros = torch.zeros((0, 0), dtype=torch.float32, device=device)
    return StitchCanvas(data=zeros, weight=zeros.clone())


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def retire_evicted(canvas: StitchCanvas, bank: KeyframeBank, evicted, camera: CameraOps) -> None:
    """Subtract from ``canvas`` the stored frame of slot ``evicted`` (() i32,
    -1: none) at its pose, in place, with no host read."""
    ei = torch.clamp(evicted, min=0).reshape(1).long()
    insert_frame(canvas, bank.images.index_select(0, ei)[0], bank.poses.index_select(0, ei)[0], camera,
                 enabled=evicted >= 0, sign=-1.0)


class CanvasOps(NamedTuple):
    """The online canvas's reads of stored keyframe images, a plug point of
    the step and the solve: ``retire(canvas, bank, evicted, camera)``
    subtracts the frame that an insert is about to evict (see
    :func:`retire_evicted`); ``recompute(canvas, bank, camera)``
    rasterizes every live keyframe anew after a solve.  The distributed
    engine, whose ranks each hold a block of the images, sets its own,
    with ``stages``: its retire split at its collective (``buffer``,
    ``stage``, ``exchange`` or, in a graph, ``exchange_all``, ``finish``:
    ``parallel/engine.py``'s ``ShardedCanvas``), for a keyframe branch of
    captured steps (:func:`staged_branch_parts`)."""

    retire: Callable
    recompute: Callable
    stages: Optional[object] = None


# The single engine's canvas: every image is in the bank.
LOCAL_CANVAS = CanvasOps(retire=retire_evicted, recompute=recompute)


def init_state(config, device: torch.device) -> SlamState:
    cf = config.cf
    p = config.loop_closure.pending_capacity
    f32, i32 = torch.float32, torch.int32
    ishape = (cf.height, cf.width // 2 + 1, 2)
    pshape = (cf.polar_shape[0], cf.polar_shape[1] // 2 + 1, 2)
    zeros = lambda shape, dt=f32: torch.zeros(shape, dtype=dt, device=device)
    return SlamState(
        bank=make_keyframe_bank(cf, config.map, device),
        edges=make_edge_store(config.map, device),
        track=TrackState(
            last_fft=zeros(ishape),
            last_polar=zeros(pshape),
            last_filt=zeros(ishape),
            last_filt_polar=zeros(pshape),
            last_cf_pose=zeros(3),
            last_cf_real_pose=zeros(3),
            last_pose=zeros(3),
            last_slot=zeros((), i32),
            distance=zeros(()),
            next_frame_id=zeros((), i32),
            initialized=zeros((), torch.bool),
        ),
        pending=PendingLoops(
            loop_slot=zeros((p,), i32),
            cur_slot=zeros((p,), i32),
            rel_pose=zeros((p, 3)),
            count=zeros((), i32),
        ),
        canvas=make_canvas(config.map_stitcher, device) if _stitch_online(config) else _no_canvas(device),
    )


# ---------------------------------------------------------------------------
# State exchange with the JAX engine
# ---------------------------------------------------------------------------


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16; the f32 detour is exact.
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(cls, tree, fn):
    return cls(**{f.name: fn(getattr(tree, f.name)) for f in dataclasses.fields(cls)})


def _canvas_like(canvas, fn) -> StitchCanvas:
    return StitchCanvas(
        data=fn(canvas.data), weight=fn(canvas.weight),
        center_x=int(getattr(canvas, "center_x", 0)),
        center_y=int(getattr(canvas, "center_y", 0)),
    )


def state_from_numpy(tree, device: torch.device) -> SlamState:
    """A :class:`SlamState` from any object with the JAX ``SlamState``'s
    attribute layout (``bank.fft``, ``track.last_filt``, ``canvas.data``,
    ...) whose leaves convert with ``np.asarray`` — e.g. a JAX state mapped
    to numpy.  bf16 leaves stay bf16; a tree without a canvas gets the
    (0, 0) placeholders."""
    leaf = lambda x: _leaf_to_torch(x, device)
    canvas = getattr(tree, "canvas", None)
    return SlamState(
        bank=_convert(KeyframeBank, tree.bank, leaf),
        edges=_convert(EdgeStore, tree.edges, leaf),
        track=_convert(TrackState, tree.track, leaf),
        pending=_convert(PendingLoops, tree.pending, leaf),
        canvas=_no_canvas(device) if canvas is None else _canvas_like(canvas, leaf),
    )


def map_state(state: SlamState, fn) -> SlamState:
    """A :class:`SlamState` with ``fn`` applied to every tensor leaf."""
    return SlamState(
        bank=_convert(KeyframeBank, state.bank, fn),
        edges=_convert(EdgeStore, state.edges, fn),
        track=_convert(TrackState, state.track, fn),
        pending=_convert(PendingLoops, state.pending, fn),
        canvas=_canvas_like(state.canvas, fn),
    )


def state_leaves(state: SlamState) -> List[torch.Tensor]:
    """Every tensor leaf of ``state``, in the order :func:`map_state` visits them."""
    parts = (state.bank, state.edges, state.track, state.pending)
    return [getattr(p, f.name) for p in parts for f in dataclasses.fields(p)] + [
        state.canvas.data, state.canvas.weight]


def state_to_numpy(state: SlamState) -> SlamState:
    """The same dataclasses with numpy leaves (bf16 leaves as exact float32)."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()

    return map_state(state, leaf)


# ---------------------------------------------------------------------------
# Pose-graph triggers
# ---------------------------------------------------------------------------


def _map_problem(bank: KeyframeBank, edges: EdgeStore, camera: CameraOps) -> PoseGraphProblem:
    """The pose graph over the whole bank.  Edge measurements are converted
    camera→robot; dead edges get identity information (their residuals
    are masked)."""
    mask = edges.valid_mask()
    eye = torch.eye(3, dtype=torch.float32, device=mask.device)
    safe_info = torch.where(mask[:, None, None], edges.info, eye)
    return PoseGraphProblem(
        poses=bank.poses,
        pose_mask=bank.valid_mask(),
        from_slot=edges.from_slot,
        to_slot=edges.to_slot,
        T=camera.camera_to_robot(edges.T),
        sqrt_info=sqrt_information(safe_info),
        edge_mask=mask,
    )


def _solver_config(config) -> SolverConfig:
    return SolverConfig(max_iterations=config.optimizer.max_iterations, estimate_scale=config.optimizer.with_scale)


def _optimize_map(bank: KeyframeBank, edges: EdgeStore, config, camera: CameraOps, solver_fn=None):
    """Solve the pose graph over the whole bank (:func:`_map_problem`) →
    (poses, cost).  ``solver_fn(prob) → (poses, cost)`` replaces the dense
    LM solve: the distributed engine passes the edge-sharded GN-CG solve
    (``nislam_torch.parallel.solver``)."""
    prob = _map_problem(bank, edges, camera)
    if solver_fn is not None:
        return solver_fn(prob)
    poses, _, cost = solve_pose_graph(
        prob, _solver_config(config), init_scale=1.0, scale_free=not config.camera.accurate_height
    )
    return poses, cost


def _invalidate_pending(pending: PendingLoops, evicted) -> PendingLoops:
    """Drop pending matches that reference an evicted slot (-1: no-op) and
    compact the survivors to the front in their original order."""
    p = pending.loop_slot.shape[0]
    live = torch.arange(p, device=pending.count.device) < pending.count
    ref = (pending.loop_slot == evicted) | (pending.cur_slot == evicted)
    kill = ref & live & (torch.as_tensor(evicted, device=live.device) >= 0)
    keep = live & ~kill
    # Stable: kept entries first, original order preserved.
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    return PendingLoops(
        loop_slot=pending.loop_slot[order],
        cur_slot=pending.cur_slot[order],
        rel_pose=pending.rel_pose[order],
        count=keep.to(torch.int32).sum().to(torch.int32),
    )


def _invalidate_pending_lanes(pending: PendingLoops, evicted: torch.Tensor) -> PendingLoops:
    """:func:`_invalidate_pending` in every lane of a lane-stacked buffer
    (leaves (k, P, ...), counts (k,)), lane j's evicted slot ``evicted[j]``:
    each lane's survivors compacted by its own stable sort."""
    p = pending.loop_slot.shape[-1]
    ev = evicted[:, None]
    live = torch.arange(p, device=pending.count.device) < pending.count[:, None]
    ref = (pending.loop_slot == ev) | (pending.cur_slot == ev)
    keep = live & ~(ref & live & (ev >= 0))
    order = torch.argsort((~keep).to(torch.int32), dim=-1, stable=True)
    return PendingLoops(
        loop_slot=pending.loop_slot.gather(1, order),
        cur_slot=pending.cur_slot.gather(1, order),
        rel_pose=pending.rel_pose.gather(1, order[:, :, None].expand(-1, -1, 3)),
        count=keep.to(torch.int32).sum(-1).to(torch.int32),
    )


def _live_pending_count(pending: PendingLoops) -> torch.Tensor:
    """Live pending matches, per lane for a batched buffer."""
    p = pending.loop_slot.shape[-1]
    live = (torch.arange(p, device=pending.count.device) < pending.count[..., None]) & (
        pending.loop_slot >= 0
    )
    return live.to(torch.int32).sum(-1)


def _add_pending_edges(state: SlamState, camera: CameraOps, loop_slots: List[int]) -> None:
    """Add the pending loop edges in place; ``loop_slots``: the host's
    copy of the first ``count`` pending loop slots."""
    pending = state.pending
    rel_cam = camera.image_plane_to_camera(pending.rel_pose)
    for i, loop_slot in enumerate(loop_slots):
        add_edge(
            state.edges,
            from_slot=pending.loop_slot[i],
            to_slot=pending.cur_slot[i],
            T=rel_cam[i],
            edge_type=EDGE_LOOP,
            enabled=loop_slot >= 0,  # -1 marks a match voided by eviction
        )


def _take_solution(state: SlamState, poses: torch.Tensor, config, camera: CameraOps,
                   canvas_ops: Optional[CanvasOps] = None) -> None:
    """Write the optimized poses, recompute the online canvas
    (``canvas_ops``, None: the bank's own images) and clear the pending
    buffer."""
    state.bank.poses = poses
    if _stitch_online(config):
        (canvas_ops or LOCAL_CANVAS).recompute(state.canvas, state.bank, camera)
    state.pending.count.zero_()


def _add_loop_edges_and_solve(state: SlamState, config, camera: CameraOps, solver_fn=None,
                              canvas_ops: Optional[CanvasOps] = None) -> SlamState:
    """Add the pending loop edges, solve, write the optimized poses,
    recompute the online canvas and clear the pending buffer."""
    pending = state.pending
    _add_pending_edges(state, camera, pending.loop_slot[:int(pending.count)].tolist())
    poses, _ = _optimize_map(state.bank, state.edges, config, camera, solver_fn)
    _take_solution(state, poses, config, camera, canvas_ops)
    return state


def _flush_pending_loops(state: SlamState, trigger, config, camera: CameraOps,
                         solver_fn=None, canvas_ops: Optional[CanvasOps] = None) -> Tuple[SlamState, bool]:
    """Inline trigger (a stored keyframe, ``trigger`` = no loop found on
    it): solve iff ≥2 live matches are pending, and clear the pending
    buffer either way — a single unconfirmed match is discarded, as the
    reference does.  One host read → (state, ran)."""
    run = bool(trigger & (_live_pending_count(state.pending) >= 2))
    if run:
        state = _add_loop_edges_and_solve(state, config, camera, solver_fn, canvas_ops)
    else:
        count = state.pending.count
        count.copy_(torch.where(trigger, 0, count))
    return state, run


def maybe_optimize(state: SlamState, *, config, camera: CameraOps, solver_fn=None,
                   canvas_ops: Optional[CanvasOps] = None) -> Tuple[SlamState, bool]:
    """Deferred trigger: solve iff ≥2 live matches are pending (single
    matches are kept), then re-derive the tracking chain from the optimized
    pose of the current target."""
    run = bool(_live_pending_count(state.pending) >= 2)
    if run:
        state = solve_and_rederive(state, config=config, camera=camera, solver_fn=solver_fn,
                                   canvas_ops=canvas_ops)
    return state, run


def solve_and_rederive(state: SlamState, *, config, camera: CameraOps, solver_fn=None,
                       canvas_ops: Optional[CanvasOps] = None) -> SlamState:
    """The deferred solve once triggered: add the pending loop edges,
    solve, clear the pending buffer, and re-derive the tracking chain from
    the optimized pose of the current target."""
    return _rederive_chain(_add_loop_edges_and_solve(state, config, camera, solver_fn, canvas_ops), camera)


def _chain_values(state: SlamState, camera: CameraOps) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain's ``(last_pose, last_cf_real_pose, last_cf_pose)`` from
    the bank's pose of the current target."""
    opt = state.bank.poses.index_select(0, state.track.last_slot.reshape(1).long())[0]
    opt_cam = camera.robot_to_camera(opt)
    return opt, opt_cam, camera.camera_to_image_plane(opt_cam)


def _rederive_chain(state: SlamState, camera: CameraOps) -> SlamState:
    """The tracking chain re-derived from the optimized pose of the
    current target."""
    opt, opt_cam, cf = _chain_values(state, camera)
    state.track = dataclasses.replace(state.track, last_pose=opt, last_cf_real_pose=opt_cam, last_cf_pose=cf)
    return state


def _lanes(state: SlamState) -> List[SlamState]:
    """Each lane of a lanes-first state, as a state of views."""
    return [lane_view(state, b) for b in range(state.bank.count.shape[0])]


def _add_pending_edges_masked(state: SlamState, run: torch.Tensor, camera: CameraOps) -> None:
    """The pending loop edges of the lanes that ``run`` (B,) of a
    lanes-first state (every leaf with a leading lane axis) added with no
    host read, by a masked loop over the whole pending buffer, as JAX's
    ``fori_loop`` adds them (slot i where it lies below the count and its
    match was not voided by eviction; the edge store bit for bit
    :func:`_add_pending_edges`')."""
    pending = state.pending
    p = pending.loop_slot.shape[-1]
    live = torch.arange(p, device=run.device) < pending.count[:, None]
    rel_cam = camera.image_plane_to_camera(pending.rel_pose)
    for i in range(p):
        add_edge_lanes(state.edges, from_slot=pending.loop_slot[:, i], to_slot=pending.cur_slot[:, i],
                       T=rel_cam[:, i], edge_type=EDGE_LOOP,
                       enabled=run & live[:, i] & (pending.loop_slot[:, i] >= 0))


def _solve_setup(state: SlamState, run: torch.Tensor, *, config, camera: CameraOps) -> PoseGraphProblem:
    """The solve graph's setup over a lanes-first state, with no host read:
    the masked pending-edge loop (:func:`_add_pending_edges_masked`), then
    each lane's problem (:func:`_map_problem`, the host loop's own
    operations), stacked."""
    _add_pending_edges_masked(state, run, camera)
    probs = [_map_problem(lane.bank, lane.edges, camera) for lane in _lanes(state)]
    return PoseGraphProblem(*(torch.stack(leaf) for leaf in zip(*probs)))


def trigger_problem(state: SlamState, run: torch.Tensor, *, config, camera: CameraOps) -> PoseGraphProblem:
    """The distributed trigger's setup over a one-lane state (the frame
    graph's buffers), with no host read: the masked pending-edge loop,
    then the map's problem (:func:`_map_problem`)."""
    _add_pending_edges_masked(lanes_first(state), run, camera)
    return _map_problem(state.bank, state.edges, camera)


def trigger_finish(state: SlamState, run: torch.Tensor, poses: torch.Tensor, *, config, camera: CameraOps) -> None:
    """The distributed trigger's finish over a one-lane state, with no host
    read: :func:`_solve_finish`'s operations for one lane but the canvas
    (the sharded recompute follows it): the solved ``poses`` into the
    bank, the pending count zeroed, the chain re-derived."""
    _solve_finish(lanes_first(state), run, (poses[None],), config=config, camera=camera, canvas=False)


def _solve_finish(state: SlamState, run: torch.Tensor, result, *, config, camera: CameraOps,
                  canvas: bool = True) -> None:
    """The solve graph's finish over a lanes-first state, for the lanes
    that ``run``: the solved poses (``result``: the LM loop's (poses,
    scale, cost)) into the bank, with the online canvas (unless
    ``canvas`` is false) each lane's canvas
    recomputed on the device (:func:`~nislam_torch.core.stitcher.
    recompute`, masked by the lane's run flag: no read of the bank's
    count), the pending count zeroed, the chain re-derived
    (:func:`_chain_values`, lane by lane as the host loop derives it)."""
    poses = result[0]
    state.bank.poses.copy_(torch.where(run[:, None, None], poses, state.bank.poses))
    lanes = _lanes(state)
    if canvas and _stitch_online(config):
        for b, lane in enumerate(lanes):
            recompute(lane.canvas, lane.bank, camera, enabled=run[b])
    state.pending.count.copy_(torch.where(run, 0, state.pending.count))
    for b, lane in enumerate(lanes):
        track = lane.track
        for buf, value in zip((track.last_pose, track.last_cf_real_pose, track.last_cf_pose),
                              _chain_values(lane, camera)):
            buf.copy_(torch.where(run[b], value, buf))


def _inline_finish(state: SlamState, run: torch.Tensor, result, packed: torch.Tensor, *, config,
                   camera: CameraOps) -> None:
    """The inline trigger's finish over the frame graph's buffers (a
    lanes-first state) and the frame's packed output, for the lanes that
    ``run``: :func:`_solve_finish` (the poses, the canvas, the pending
    count, and the chain from ``last_slot``, which is the new keyframe's
    slot: the branch stored it), then the output fields that
    :func:`_insert_keyframe`'s inline solve changes, by
    :func:`_step_output`'s operations: ``optimized`` (field 3), ``cf_pose``
    (7–9) and ``pose`` (10–12), the keyframe's optimized pose."""
    _solve_finish(state, run, result, config=config, camera=camera)
    rows = packed.reshape(-1, packed.shape[-1])
    origin = camera.image_plane_to_robot(torch.zeros(3, dtype=torch.float32, device=rows.device))
    for b, lane in enumerate(_lanes(state)):
        track, row = lane.track, rows[b]
        cf_pose = relative_pose(origin, camera.image_plane_to_robot(track.last_cf_pose))
        row[3].copy_(torch.where(run[b], 1.0, row[3]))
        row[7:10].copy_(torch.where(run[b], cf_pose, row[7:10]))
        row[10:13].copy_(torch.where(run[b], track.last_pose, row[10:13]))


def check_and_optimize_final(state: SlamState, *, config, camera: CameraOps,
                             solver_fn=None, canvas_ops: Optional[CanvasOps] = None) -> Tuple[SlamState, bool]:
    """End-of-sequence trigger; clears the pending buffer either way."""
    state, ran = maybe_optimize(state, config=config, camera=camera, solver_fn=solver_fn,
                                canvas_ops=canvas_ops)
    state.pending.count.zero_()
    return state, ran


def optimize_host_loop(engine, state: SlamState) -> Tuple[SlamState, bool]:
    """:meth:`SlamEngine.optimize` as a host loop (:func:`maybe_optimize`:
    the pending count read, the loop edges added one by one, the solve's
    loop condition read once per iteration, with a ``solver_fn`` and
    canvas hook the distributed engine's GN-CG and count-read sharded
    recompute): the reference that the solve graph and the distributed
    engine's trigger program are held against."""
    return maybe_optimize(state, config=engine.config, camera=engine.camera, solver_fn=engine.solver_fn,
                          canvas_ops=engine.canvas_ops)


def finalize_host_loop(engine, state: SlamState) -> Tuple[SlamState, bool]:
    """:meth:`SlamEngine.finalize` as a host loop (see :func:`optimize_host_loop`)."""
    return check_and_optimize_final(state, config=engine.config, camera=engine.camera, solver_fn=engine.solver_fn,
                                    canvas_ops=engine.canvas_ops)


# ---------------------------------------------------------------------------
# The per-frame step
# ---------------------------------------------------------------------------


def frontend(image: torch.Tensor, *, cf_ops: CFOps, camera: CameraOps):
    """Carry-independent work → ``(img_u, fft, polar_fft)``; batched over
    leading axes.  u8 input is normalized to [0, 1] on the device."""
    if image.dtype == torch.uint8:
        image = image.to(torch.float32) / 255.0
    img_u = camera.undistort(image)
    fft, polar = compute_intermedium(img_u, cf_ops)
    return img_u, fft, polar


def _init_step(state: SlamState, features, *, config, cf_ops: CFOps, camera: CameraOps):
    """First frame: pose 0 in every frame, inserted as keyframe."""
    img_u, fft, polar = features
    dev = fft.device
    frame_id = state.track.next_frame_id
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    robot0 = camera.image_plane_to_robot(zero)
    fi, fp = compute_keyframe_filters(fft, polar, cf_ops)
    _, slot, _, _ = add_keyframe(
        state.bank, fft=fft, polar_fft=polar, filt=fi, filt_polar=fp, image=img_u,
        pose=robot0, frame_id=frame_id, distance=_scalar(0.0, torch.float32, dev),
        grid_scale=config.map.grid_scale, enabled=True,
        evict=config.map.eviction == "ring",
    )
    if _stitch_online(config):
        insert_frame(state.canvas, img_u, robot0, camera)
    state.track = TrackState(
        last_fft=c2r(fft),
        last_polar=c2r(polar),
        last_filt=c2r(fi),
        last_filt_polar=c2r(fp),
        last_cf_pose=zero,
        last_cf_real_pose=camera.image_plane_to_camera(zero),
        last_pose=robot0,
        last_slot=slot,
        distance=_scalar(0.0, torch.float32, dev),
        next_frame_id=frame_id + 1,
        initialized=_scalar(True, torch.bool, dev),
    )
    false = _scalar(False, torch.bool, dev)
    out = StepOutput(
        tracked=_scalar(True, torch.bool, dev), inserted=_scalar(True, torch.bool, dev),
        loop_found=false, optimized=false,
        response=torch.full((3,), torch.inf, dtype=torch.float32, device=dev),
        cf_pose=robot0, pose=robot0, frame_id=frame_id, keyframe_slot=slot,
        loop_slot=_scalar(-1, torch.int32, dev),
        loop_eligible=_scalar(0, torch.int32, dev),
    )
    return state, out


class _Tracked(NamedTuple):
    """Device results of tracking a frame and deciding on a keyframe; each
    field carries the lane axes of the state it came from."""

    good: torch.Tensor  # bool: both PSRs clear the tracking gates
    insert: torch.Tensor  # bool: a keyframe
    will_store: torch.Tensor  # bool: a keyframe the bank takes
    response: torch.Tensor  # (3,) PSR confidences
    cur_cf_pose: torch.Tensor  # (3,) image-plane chain
    cur_cf_real: torch.Tensor  # (3,) camera frame
    cur_pose: torch.Tensor  # (3,) robot frame
    new_distance: torch.Tensor  # () travel distance after this frame


def _track(track, bank_count, features, *, config, cf_ops: CFOps, camera: CameraOps) -> _Tracked:
    """Tracking and the keyframe decision, on the device with no host
    branch, from the tracking chain ``track`` (a :class:`TrackState`, or
    any object with its ``last_*`` and ``distance`` leaves) and the bank's
    ``count``.  Batched over leading lane axes of the chain and the
    features: the batch engine tracks all its lanes in one ``compute_pose``."""
    kfs = config.keyframe_selection
    img_u, _, polar = features
    rel_center, response = compute_pose(
        r2c(track.last_fft), img_u, r2c(track.last_polar), polar, cf_ops,
        large_rotation=False,
        filters=(r2c(track.last_filt), r2c(track.last_filt_polar)),
    )
    rel_principal = camera.center_to_principal(rel_center)
    good = (response[..., 0] > kfs.lower_response_thr) & (response[..., 2] > kfs.lower_rot)
    cur_cf_pose = absolute_pose(track.last_cf_pose, rel_principal)
    cur_cf_real = camera.image_plane_to_camera(cur_cf_pose)
    rel_robot = relative_pose(
        camera.image_plane_to_robot(track.last_cf_pose),
        camera.image_plane_to_robot(cur_cf_pose),
    )
    cur_pose = absolute_pose(track.last_pose, rel_robot)

    da_cam = camera.image_plane_to_camera(cur_cf_pose - track.last_cf_pose)
    d = torch.linalg.vector_norm(da_cam[..., :2], dim=-1)
    a = torch.abs(da_cam[..., 2])
    c3 = (response[..., 0] > kfs.lower_response_thr) & (response[..., 0] < kfs.upper_response_thr)
    c4 = (response[..., 2] > kfs.lower_rot) & (response[..., 2] < kfs.upper_rot)
    insert = good & ((d > kfs.max_distance) | (a > kfs.max_angle) | c3 | c4)
    capacity = config.map.keyframe_capacity
    ring = config.map.eviction == "ring" and capacity > 2
    return _Tracked(
        good=good, insert=insert,
        will_store=insert & (ring | (bank_count < capacity)),
        response=response, cur_cf_pose=cur_cf_pose, cur_cf_real=cur_cf_real, cur_pose=cur_pose,
        new_distance=track.distance + torch.where(insert, d, 0.0),
    )


def _pack_tracked(t: _Tracked) -> torch.Tensor:
    """A frame's :class:`_Tracked` as one (..., 16) f32 vector per lane (the
    flags as 0/1): the graph's output, read by the keyframe branch."""
    flags = torch.stack([t.good, t.insert, t.will_store], dim=-1).to(torch.float32)
    return torch.cat([flags, t.response, t.cur_cf_pose, t.cur_cf_real, t.cur_pose, t.new_distance[..., None]],
                     dim=-1)


def _unpack_tracked(v: torch.Tensor) -> _Tracked:
    """Inverse of :func:`_pack_tracked` (the fields are views of ``v``)."""
    return _Tracked(
        good=v[..., 0] > 0.5, insert=v[..., 1] > 0.5, will_store=v[..., 2] > 0.5, response=v[..., 3:6],
        cur_cf_pose=v[..., 6:9], cur_cf_real=v[..., 9:12], cur_pose=v[..., 12:15], new_distance=v[..., 15],
    )


def _append_pending(pending: PendingLoops, lc, cur_slot, found, camera: CameraOps) -> None:
    """In place: append the loop match ``lc`` of keyframe ``cur_slot`` to
    the pending buffer if ``found`` and the buffer has room."""
    cap = pending.loop_slot.shape[0]
    pslot = torch.clamp(pending.count, max=cap - 1)
    padd = found & (pending.count < cap)
    write_slot(pending.loop_slot, pslot, lc.loop_slot, padd)
    write_slot(pending.cur_slot, pslot, cur_slot, padd)
    write_slot(pending.rel_pose, pslot, camera.center_to_principal(lc.relative_pose), padd)
    pending.count += padd.to(torch.int32)


def _append_pending_lanes(pending: PendingLoops, rel_pose: torch.Tensor, lc: LoopResult, cur_slot) -> None:
    """:func:`_append_pending` in every lane of a lane-stacked buffer, in
    place: lane j appends its match where ``lc.found[j]`` and its buffer
    has room; ``rel_pose`` (k, 3): the matches in the principal frame."""
    cap = pending.loop_slot.shape[-1]
    pslot = torch.clamp(pending.count, max=cap - 1)
    padd = lc.found & (pending.count < cap)
    _write_lanes(pending.loop_slot, pslot, lc.loop_slot, padd)
    _write_lanes(pending.cur_slot, pslot, cur_slot, padd)
    _write_lanes(pending.rel_pose, pslot, rel_pose, padd)
    pending.count += padd.to(torch.int32)


def _per_lane(fn, *args) -> torch.Tensor:
    """``fn`` on each lane's slice of ``args`` (k, ...), stacked: the pose
    arithmetic whose einsum would take a batched matrix product over k
    lanes, kept in one lane's shapes so its bits are a lane branch's."""
    return torch.stack([fn(*(a[j] for a in args)) for j in range(args[0].shape[0])])


def _store_keyframe(state: SlamState, features, t: _Tracked, fi, fp, frame_id, online: bool, *, config,
                    camera: CameraOps):
    """The bank insert of a keyframe whose filters are ``fi``, ``fp`` (an
    evicted keyframe retired from the online canvas already), the odometry
    edge, the canvas insert (``online``) and the pending invalidation, in
    place → ``(slot, stored, keyframe_slot)``."""
    img_u, fft, polar = features
    track = state.track
    _, slot, stored, evicted = add_keyframe(
        state.bank, fft=fft, polar_fft=polar, filt=fi, filt_polar=fp,
        image=img_u, pose=t.cur_pose, frame_id=frame_id, distance=t.new_distance,
        grid_scale=config.map.grid_scale, enabled=True,
        evict=config.map.eviction == "ring", protect_slot=track.last_slot,
    )
    # Edges to the evicted slot are void; invalidate BEFORE the new edge,
    # which legitimately targets the reused slot.
    invalidate_edges(state.edges, evicted)
    add_edge(
        state.edges, from_slot=track.last_slot, to_slot=slot,
        T=relative_pose(track.last_cf_real_pose, t.cur_cf_real),
        edge_type=EDGE_KCC, enabled=stored,
    )
    if online:
        insert_frame(state.canvas, img_u, t.cur_pose, camera)
    state.pending = _invalidate_pending(state.pending, evicted)
    return slot, stored, torch.where(stored, slot, _scalar(-1, torch.int32, fft.device))


def _keyframe_chain(track: TrackState, fft, polar, fi, fp, slot, stored, pose, cf_pose, cf_real) -> TrackState:
    """The tracking chain with the new keyframe as its target."""
    return dataclasses.replace(
        track,
        last_fft=c2r(fft),
        last_polar=c2r(polar),
        last_filt=c2r(fi),
        last_filt_polar=c2r(fp),
        last_cf_pose=cf_pose,
        last_cf_real_pose=cf_real,
        last_pose=pose,
        last_slot=torch.where(stored, slot, track.last_slot),
    )


def _insert_keyframe(
    state: SlamState, features, t: _Tracked, stored_h: bool, frame_id, *, config,
    cf_ops: CFOps, camera: CameraOps, search: bool, inline: bool,
    loop_search_fn=None, solver_fn=None, canvas_ops: Optional[CanvasOps] = None,
):
    """The host branch of one lane whose frame is a keyframe: its filters,
    the bank insert (retiring an evicted keyframe from the online canvas),
    the odometry edge, pending invalidation, then, for a stored keyframe,
    the loop search with its pending append (``search``) and the inline
    solve (``inline``); the keyframe becomes the tracking target.  The
    batch engine passes ``search=False`` (it runs
    :func:`deferred_loop_search` after the step) and ``inline=False``.
    ``loop_search_fn`` (signature of :func:`find_loop_closure`),
    ``solver_fn`` (see :func:`_optimize_map`) and ``canvas_ops`` (see
    :class:`CanvasOps`) replace the single-card search, solve and canvas
    reads; None keeps them.

    Returns ``(state, cur_pose, cur_cf_pose, keyframe_slot, loop result,
    optimized)``; the poses change only when the inline solve ran."""
    img_u, fft, polar = features
    dev = fft.device
    cur_pose, cur_cf_pose, cur_cf_real = t.cur_pose, t.cur_cf_pose, t.cur_cf_real
    fi, fp = compute_keyframe_filters(fft, polar, cf_ops)
    online = stored_h and _stitch_online(config)  # implies stored images
    if online and config.map.eviction == "ring":
        # Retire the keyframe this insert evicts (the negated scatter of
        # its record, read before the insert overwrites it), so the
        # canvas stays equal to recompute(bank).
        _, _, ev, _ = plan_insert(state.bank, True, True, state.track.last_slot)
        (canvas_ops or LOCAL_CANVAS).retire(state.canvas, state.bank, ev, camera)
    slot, stored, keyframe_slot = _store_keyframe(state, features, t, fi, fp, frame_id, online, config=config,
                                                  camera=camera)

    lc = no_loop_result(dev)
    if stored_h and search and config.loop_closure.to_find_loop:
        search_fn = find_loop_closure if loop_search_fn is None else loop_search_fn
        lc = search_fn(
            state.bank, img_u, polar, frame_id, t.new_distance, cur_pose,
            cf_ops, config.loop_closure, config.map.grid_scale, cur_fft=fft,
        )
        _append_pending(state.pending, lc, slot, lc.found, camera)

    optimized = False
    if stored_h and inline:
        # Inline solve: a stored keyframe that found no loop.
        state, optimized = _flush_pending_loops(state, ~lc.found, config, camera, solver_fn, canvas_ops)
        if optimized:
            # Re-derive the chain from the new keyframe's optimized pose.
            cur_pose = state.bank.poses.index_select(0, slot.reshape(1).long())[0]
            cur_cf_real = camera.robot_to_camera(cur_pose)
            cur_cf_pose = camera.camera_to_image_plane(cur_cf_real)

    state.track = _keyframe_chain(state.track, fft, polar, fi, fp, slot, stored, cur_pose, cur_cf_pose, cur_cf_real)
    return state, cur_pose, cur_cf_pose, keyframe_slot, lc, optimized


def _step_output(t: _Tracked, frame_id, camera: CameraOps, *, pose, cf_pose, keyframe_slot,
                 loop_found, loop_slot, loop_eligible, optimized) -> StepOutput:
    """A tracked frame's :class:`StepOutput`; ``cf_pose`` is the frame's
    image-plane chain pose, reported as raw odometry in the robot frame
    relative to the cf origin's pose."""
    origin = camera.image_plane_to_robot(torch.zeros(3, dtype=torch.float32, device=pose.device))
    return StepOutput(
        tracked=t.good,
        inserted=t.insert,
        loop_found=loop_found,
        optimized=optimized,
        response=t.response,
        cf_pose=relative_pose(origin, camera.image_plane_to_robot(cf_pose)),
        pose=pose,
        frame_id=frame_id,
        keyframe_slot=keyframe_slot,
        loop_slot=loop_slot,
        loop_eligible=loop_eligible,
    )


def _frame_output(t: _Tracked, frame_id, camera: CameraOps, *, pose, cf_pose, keyframe_slot, lc,
                  optimized: bool) -> StepOutput:
    """A tracked frame's :class:`StepOutput` after its keyframe branch (or
    none): the loop fields from the loop search's result ``lc``."""
    return _step_output(
        t, frame_id, camera, pose=pose, cf_pose=cf_pose, keyframe_slot=keyframe_slot,
        loop_found=lc.found, loop_slot=torch.where(lc.found, lc.loop_slot, -1),
        loop_eligible=lc.eligible_count, optimized=_scalar(optimized, torch.bool, pose.device),
    )


def _track_step(state: SlamState, features, *, config, cf_ops: CFOps, camera: CameraOps,
                loop_search_fn=None, solver_fn=None, canvas_ops: Optional[CanvasOps] = None):
    """One tracked frame, every operation launched eagerly."""
    dev = features[1].device
    frame_id = state.track.next_frame_id
    t = _track(state.track, state.bank.count, features, config=config, cf_ops=cf_ops, camera=camera)
    # The one host read of a tracked frame.
    insert_h, stored_h = torch.stack([t.insert, t.will_store]).tolist()

    pose, cf_pose = t.cur_pose, t.cur_cf_pose
    keyframe_slot = _scalar(-1, torch.int32, dev)
    lc = no_loop_result(dev)
    optimized = False
    if insert_h:
        state, pose, cf_pose, keyframe_slot, lc, optimized = _insert_keyframe(
            state, features, t, stored_h, frame_id, config=config, cf_ops=cf_ops,
            camera=camera, search=True, inline=config.optimizer.inline,
            loop_search_fn=loop_search_fn, solver_fn=solver_fn, canvas_ops=canvas_ops,
        )
    state.track = dataclasses.replace(
        state.track,
        distance=t.new_distance,
        next_frame_id=frame_id + 1,
        initialized=_scalar(True, torch.bool, dev),
    )
    out = _frame_output(t, frame_id, camera, pose=pose, cf_pose=cf_pose, keyframe_slot=keyframe_slot,
                        lc=lc, optimized=optimized)
    return state, out


def _track_body(b: SimpleNamespace, *, config, cf_ops: CFOps, camera: CameraOps):
    """The device part of a tracked frame on a :class:`TrackGraph`'s
    inputs ``b``: :func:`_track`, then what :func:`_track_step` makes of a
    frame that inserts no keyframe (its output, the distance and the next
    frame id) → ``(carry, outputs)``: the packed ``[insert, stored]``
    flags, the packed output and the packed :class:`_Tracked`.  Batched
    over the lane axes of the inputs (those of ``bank_count``): the batch
    engine's lanes get the outputs that its eager step gives them.  It
    reads nothing back to the host and builds no tensor from host data."""
    dev = b.img_u.device
    lanes = b.bank_count.shape
    t = _track(b, b.bank_count, (b.img_u, None, b.polar), config=config, cf_ops=cf_ops, camera=camera)
    none = torch.full(lanes, -1, dtype=torch.int32, device=dev)
    false = torch.zeros(lanes, dtype=torch.bool, device=dev)
    zero = torch.zeros(lanes, dtype=torch.int32, device=dev)
    out = _step_output(t, b.next_frame_id, camera, pose=t.cur_pose, cf_pose=t.cur_cf_pose, keyframe_slot=none,
                       loop_found=false, loop_slot=none, loop_eligible=zero, optimized=false)
    carry = {"distance": t.new_distance, "next_frame_id": b.next_frame_id + 1}
    return carry, {"flags": torch.stack([t.insert, t.will_store], dim=-1), "packed": out.pack(),
                   "tracked": _pack_tracked(t)}


def _graph_track_step(state: SlamState, features, graph: TrackGraph, *, config, cf_ops: CFOps,
                      camera: CameraOps, loop_search_fn=None, solver_fn=None,
                      canvas_ops: Optional[CanvasOps] = None) -> Tuple[SlamState, torch.Tensor]:
    """One tracked frame through ``graph``, which holds ``state``'s chain
    (:meth:`TrackGraph.load`) → (state, the packed output).  The same
    results as :func:`_track_step`: the graph's body runs the same
    operations, and a keyframe takes the same eager branch on a copy of
    the graph's :class:`_Tracked`; the graph is loaded again after it."""
    img_u, _, polar = features
    frame_id = state.track.next_frame_id
    outs = graph.run(img_u, polar)
    state.track = dataclasses.replace(
        state.track, distance=graph.inputs.distance.clone(), next_frame_id=graph.inputs.next_frame_id.clone(),
    )
    # The one host read of a tracked frame.
    insert_h, stored_h = outs.flags.tolist()
    if not insert_h:
        return state, outs.packed.clone()
    packed = _eager_branch(state, features, outs.tracked, stored_h, frame_id, config=config, cf_ops=cf_ops,
                           camera=camera, loop_search_fn=loop_search_fn, solver_fn=solver_fn, canvas_ops=canvas_ops)
    graph.load(state)
    return state, packed


def _eager_branch(state: SlamState, features, tracked: torch.Tensor, stored: bool, frame_id, *, config,
                  cf_ops: CFOps, camera: CameraOps, loop_search_fn=None, solver_fn=None,
                  canvas_ops: Optional[CanvasOps] = None) -> torch.Tensor:
    """The keyframe branch of a tracked frame, launched eagerly on ``state``
    (updated in place, its replaced leaves set on it) from the track
    graph's packed :class:`_Tracked` (``tracked``) and the host's
    ``stored`` flag, with the plug points → the frame's packed output."""
    t = _unpack_tracked(tracked.clone())
    state, pose, cf_pose, keyframe_slot, lc, optimized = _insert_keyframe(
        state, features, t, stored, frame_id, config=config, cf_ops=cf_ops,
        camera=camera, search=True, inline=config.optimizer.inline,
        loop_search_fn=loop_search_fn, solver_fn=solver_fn, canvas_ops=canvas_ops,
    )
    out = _frame_output(t, frame_id, camera, pose=pose, cf_pose=cf_pose, keyframe_slot=keyframe_slot,
                        lc=lc, optimized=optimized)
    return out.pack()


def staged_branch_parts(s: SlamState, x: SimpleNamespace, stored: bool, *, config, cf_ops: CFOps,
                        camera: CameraOps, search, canvas: CanvasOps, captured: bool = False) -> list:
    """The distributed engine's keyframe branch as parts on a
    :class:`~nislam_torch.core.frame_graph.CollectiveFrameGraph`'s buffers:
    ``("device", fn)``, a function over fixed buffers that reads nothing
    back, or ``("host", fn)``, a plug point's collective and the read that
    decides it.  With ``captured`` (a group whose all-reduce a graph
    holds: the peer kernel) the collectives are device parts too and the
    frame graph captures the whole branch as one step, which the chunk
    graph nests; else (:attr:`SlamEngine.branch_on_host`, a
    :class:`~nislam_torch.core.frame_graph.HostBranchFrameGraph`) it runs
    the device parts between two host parts as one captured step.  ``s``
    is its state, ``x`` holds the frame's features (``img_u``, ``fft``,
    ``polar``), the track graph's packed :class:`_Tracked` (``tracked``)
    and packed output (``packed``), and the frame graph's ``diverged``
    word; ``stored`` is the kind.  ``search`` (the distributed engine's ``loop_search_fn``,
    ``parallel/loop_search.py``'s ``ShardedSearch``) and ``canvas.stages``
    are the plug points' staged forms.  For a stored keyframe, in
    :func:`_insert_keyframe`'s order:

    1. ``pre``: the filters; with the online canvas over a ring, the slot
       that the insert evicts and its owner's image staged (zeros on every
       rank when none is evicted);
    2. the host: the evicted slot's read and, on an eviction, the image's
       all-reduce; ``captured``: the image's all-reduce on the device at
       every stored keyframe (zeros stay zeros: the int32 sum is exact, and
       the retire is masked by ``evicted >= 0``), so the graph route
       all-reduces the image once per stored keyframe where the host route
       does once per eviction;
    3. ``local``: the evicted keyframe retired from the canvas, the
       insert, the edges, the canvas insert, the pending invalidation, the
       chain, the search's local part into its record;
    4. the record's all-reduce (on the host, or ``captured`` on the device);
    5. ``merge``: the frame-id check into ``x.diverged``, the winner, the
       pending append, and of the packed output the fields that the branch
       sets (2, 14, 15, 16), as :func:`_branch_body` writes them.

    A dropped keyframe makes no collective: its parts are one step.  Each
    device part runs on a view of ``s`` and copies back the leaves that it
    replaced, so the bits are the eager branch's (:func:`_eager_branch`).
    The buffers that carry values from one part to the next are made
    here."""
    if config.optimizer.inline:
        raise ValueError("a staged keyframe branch runs no inline solve: its engine defers the solve")
    dev = x.fft.device
    b = SimpleNamespace(fi=torch.zeros_like(x.fft), fp=torch.zeros_like(x.polar),
                        slot=torch.zeros((), dtype=torch.int32, device=dev),
                        keyframe_slot=torch.zeros((), dtype=torch.int32, device=dev))
    online = stored and _stitch_online(config)
    retire = online and config.map.eviction == "ring"
    searches = stored and config.loop_closure.to_find_loop
    if retire:
        b.ev = torch.zeros((), dtype=torch.int32, device=dev)
        b.image = canvas.stages.buffer(s.bank)
    if searches:
        b.rec = search.record(dev)
    kw = dict(config=config, cf_ops=cf_ops, camera=camera, stages=canvas.stages if retire else None,
              search=search if searches else None)
    parts = [("device", functools.partial(_branch_pre, s, x, b, **kw))]
    collective = "device" if captured else "host"
    if retire:
        exchange = canvas.stages.exchange_all if captured else canvas.stages.exchange
        parts.append((collective, functools.partial(exchange, b.ev, b.image)))
    parts.append(("device", functools.partial(_branch_local, s, x, b, online, **kw)))
    if searches:
        parts.append((collective, functools.partial(search.exchange, b.rec)))
    parts.append(("device", functools.partial(_branch_merge, s, x, b, **kw)))
    return parts


def _branch_pre(s: SlamState, x: SimpleNamespace, b: SimpleNamespace, *, config, cf_ops: CFOps,
                camera: CameraOps, stages, search) -> None:
    """:func:`staged_branch_parts`' ``pre``."""
    fi, fp = compute_keyframe_filters(x.fft, x.polar, cf_ops)
    b.fi.copy_(fi)
    b.fp.copy_(fp)
    if stages is not None:
        _, _, ev, _ = plan_insert(s.bank, True, True, s.track.last_slot)
        b.ev.copy_(ev)
        stages.stage(b.image, s.bank, ev)


def _branch_local(s: SlamState, x: SimpleNamespace, b: SimpleNamespace, online: bool, *, config, cf_ops: CFOps,
                  camera: CameraOps, stages, search) -> None:
    """:func:`staged_branch_parts`' ``local``."""
    t = _unpack_tracked(x.tracked)
    frame_id = s.track.next_frame_id - 1  # the track graph's carry advanced it
    view = dataclasses.replace(s, track=dataclasses.replace(s.track), pending=dataclasses.replace(s.pending))
    if stages is not None:
        stages.finish(view.canvas, view.bank, b.ev, b.image, camera)
    features = (x.img_u, x.fft, x.polar)
    slot, stored, keyframe_slot = _store_keyframe(view, features, t, b.fi, b.fp, frame_id, online, config=config,
                                                  camera=camera)
    view.track = _keyframe_chain(view.track, x.fft, x.polar, b.fi, b.fp, slot, stored, t.cur_pose, t.cur_cf_pose,
                                 t.cur_cf_real)
    if search is not None:
        search.local(b.rec, view.bank, x.img_u, x.polar, frame_id, t.new_distance, t.cur_pose, cf_ops,
                     config.loop_closure, config.map.grid_scale)
    b.slot.copy_(slot)
    b.keyframe_slot.copy_(keyframe_slot)
    write_back(s, view)


def _branch_merge(s: SlamState, x: SimpleNamespace, b: SimpleNamespace, *, config, cf_ops: CFOps,
                  camera: CameraOps, stages, search) -> None:
    """:func:`staged_branch_parts`' ``merge``."""
    lc = no_loop_result(x.fft.device)
    if search is not None:
        frame_id = s.track.next_frame_id - 1
        lc = search.merge(b.rec, frame_id, config.loop_closure, x.diverged)
        _append_pending(s.pending, lc, b.slot, lc.found, camera)
    # StepOutput.pack's fields 2, 14, 15 and 16.
    x.packed[2].copy_(lc.found)
    x.packed[14].copy_(b.keyframe_slot)
    x.packed[15].copy_(torch.where(lc.found, lc.loop_slot, -1))
    x.packed[16].copy_(lc.eligible_count)


def _branch_body(s: SlamState, x: SimpleNamespace, stored: bool, *, config, cf_ops: CFOps,
                 camera: CameraOps) -> None:
    """The keyframe branch of a tracked frame on a :class:`FrameGraph`'s
    buffers, in place: ``s`` is its state (or one lane of a batch's, as
    ``stagebench`` replays it beside the batch's body k),
    ``x`` holds the frame's features (``img_u``, ``fft``, ``polar``), the
    track graph's packed :class:`_Tracked` (``tracked``) and the packed
    output (``packed``); ``stored`` is the flag that the host read.  It
    runs :func:`_insert_keyframe` itself (its loop search, no inline
    solve) on a view of ``s`` and copies back the leaves that it replaced
    (the chain, the pending buffer), so its bits are the eager branch's.
    Of the packed output it rewrites the fields that the branch sets
    (``loop_found``, ``keyframe_slot``, ``loop_slot``, ``loop_eligible``):
    without the inline solve the poses are the track graph's, whose
    arithmetic, batched over a batch's lanes, is kept.  It reads nothing
    back to the host and builds no tensor from host data."""
    t = _unpack_tracked(x.tracked)
    frame_id = s.track.next_frame_id - 1  # the track graph's carry advanced it
    view = dataclasses.replace(s, track=dataclasses.replace(s.track), pending=dataclasses.replace(s.pending))
    view, _, _, keyframe_slot, lc, _ = _insert_keyframe(
        view, (x.img_u, x.fft, x.polar), t, stored, frame_id, config=config, cf_ops=cf_ops,
        camera=camera, search=True, inline=False,
    )
    write_back(s, view)
    # StepOutput.pack's fields 2, 14, 15 and 16.
    x.packed[2].copy_(lc.found)
    x.packed[14].copy_(keyframe_slot)
    x.packed[15].copy_(torch.where(lc.found, lc.loop_slot, -1))
    x.packed[16].copy_(lc.eligible_count)


def _branch_body_lanes(s: SlamState, x: SimpleNamespace, k: int, *, config, cf_ops: CFOps,
                       camera: CameraOps) -> None:
    """The batch engine's keyframe branch over the ``k`` lanes that insert
    a keyframe in a frame, as one batched program on a
    :class:`~nislam_torch.core.frame_graph.BatchFrameGraph`'s buffers, in
    place: JAX's vmapped insert and vmapped loop search.  ``s`` is its
    lanes-first state, ``x`` holds every lane's features (``img_u``,
    ``fft``, ``polar``), packed :class:`_Tracked` (``tracked``) and packed
    output (``packed``).  The inserting lanes are found on the device in
    ascending order (a stable sort of their insert flags; ``k`` of them,
    so every shape is static) and gathered; then, in
    :func:`_insert_keyframe`'s order: the filters, with the online canvas
    the evicted keyframe's retirement, the insert
    (:func:`~nislam_torch.core.map_store.add_keyframe_lanes`), the edges
    (invalidation, then the odometry edge), the canvas insert, the pending
    invalidation, for the lanes that stored the loop search
    (:func:`~nislam_torch.core.loop_closure.find_loop_closure_lanes`) and
    its pending append, and the chain; of the packed output it rewrites
    fields 2, 14, 15 and 16 of each gathered lane.  Lanes share no state,
    so each lane's bits are those of its own branch (:func:`_branch_body`)
    where the batched search's transforms give a lane's results as one
    lane's do; its keyframe filters, the lane's tracking target, are
    computed lane by lane, so they always are.
    Each lane's canvas is its own (S, S) buffer, so the retire and insert
    run per lane of the batch with the lane's flag as the kernel's
    ``enabled``.  On the CPU the search's transforms run lane by lane
    (``lanes=k``: :func:`~nislam_torch.ops.fft.by_lane`), the plain version
    that is held bit for bit against the lane branches.  It reads nothing
    back to the host and builds no tensor from host data."""
    t_all = _unpack_tracked(x.tracked)
    lanes = torch.argsort((~t_all.insert).to(torch.int32), stable=True)[:k]
    t = _unpack_tracked(x.tracked[lanes])
    img_u, fft, polar = (v[lanes] for v in (x.img_u, x.fft, x.polar))
    # What the branch reads of the chain (the rest it only writes).
    last_slot, last_cf_real_pose = s.track.last_slot[lanes], s.track.last_cf_real_pose[lanes]
    frame_id = s.track.next_frame_id[lanes] - 1  # the track graph's carry advanced it
    # Each lane's keyframe filters at one lane's shapes: they are its next
    # frames' tracking target, and cuFFT rounds a lane's transforms in a
    # batch otherwise than alone (chip_smoke.py phase 11 prints the gap),
    # which would move every later PSR of the lane.
    fi, fp = (torch.stack(f) for f in zip(*(compute_keyframe_filters(fft[j], polar[j], cf_ops) for j in range(k))))
    evict = config.map.eviction == "ring"
    online = _stitch_online(config)
    nb = x.tracked.shape[0]

    def per_batch_lane(values: torch.Tensor, fill) -> torch.Tensor:
        """(k,) values of the gathered lanes at their place in a (B,) vector."""
        return torch.full((nb,), fill, dtype=values.dtype, device=values.device).index_copy(0, lanes, values)

    if online and evict:
        _, _, ev, _ = plan_insert_lanes(s.bank, lanes, evict, last_slot)
        retire = per_batch_lane(torch.where(t.will_store, ev, -1), -1)
        for b in range(nb):
            lane = lane_view(s, b)
            retire_evicted(lane.canvas, lane.bank, retire[b], camera)
    slot, stored, evicted = add_keyframe_lanes(
        s.bank, lanes, fft=fft, polar_fft=polar, filt=fi, filt_polar=fp, image=img_u, pose=t.cur_pose,
        frame_id=frame_id, distance=t.new_distance, grid_scale=config.map.grid_scale, evict=evict,
        protect_slot=last_slot,
    )[1:]
    edges = gather_lanes(s.edges, lanes)
    invalidate_edges_lanes(edges, evicted)
    add_edge_lanes(edges, from_slot=last_slot, to_slot=slot,
                   T=_per_lane(relative_pose, last_cf_real_pose, t.cur_cf_real),
                   edge_type=EDGE_KCC, enabled=stored)
    scatter_lanes(s.edges, lanes, edges)
    if online:
        insert = per_batch_lane(t.will_store, False)
        for b in range(nb):
            insert_frame(lane_view(s, b).canvas, x.img_u[b], t_all.cur_pose[b], camera, enabled=insert[b])
    pending = _invalidate_pending_lanes(gather_lanes(s.pending, lanes), evicted)
    keyframe_slot = torch.where(stored, slot, -1)
    if config.loop_closure.to_find_loop:
        lc = find_loop_closure_lanes(s.bank, lanes, img_u, polar, fft, frame_id, t.new_distance, t.cur_pose,
                                     stored, cf_ops, config.loop_closure, config.map.grid_scale)
        _append_pending_lanes(pending, _per_lane(camera.center_to_principal, lc.relative_pose), lc, slot)
        found, loop_slot, eligible = lc.found, torch.where(lc.found, lc.loop_slot, -1), lc.eligible_count
    else:
        found = torch.zeros_like(stored)
        loop_slot, eligible = torch.full_like(slot, -1), torch.zeros_like(slot)
    scatter_lanes(s.pending, lanes, pending)
    chain = dict(last_fft=c2r(fft), last_polar=c2r(polar), last_filt=c2r(fi), last_filt_polar=c2r(fp),
                 last_cf_pose=t.cur_cf_pose, last_cf_real_pose=t.cur_cf_real, last_pose=t.cur_pose,
                 last_slot=torch.where(stored, slot, last_slot))
    for name, value in chain.items():
        getattr(s.track, name).index_copy_(0, lanes, value)
    rows = x.packed[lanes]
    for field, value in ((2, found), (14, keyframe_slot), (15, loop_slot), (16, eligible)):
        rows[:, field] = value
    x.packed.index_copy_(0, lanes, rows)


def deferred_loop_search(state: SlamState, features, out: StepOutput, *, config,
                         cf_ops: CFOps, camera: CameraOps) -> Tuple[SlamState, StepOutput]:
    """The loop search and pending append that the batch engine's step
    (``_insert_keyframe(search=False)``) skipped, for one lane after its
    step: the same inputs as the in-step search (the keyframe is in the
    bank, evicted pendings are gone, the distance is updated).  The search
    runs unconditionally; its result counts only if the frame stored a
    keyframe and is not the initialization frame, as JAX's cond has it.
    The batch engine calls it only for lanes whose flag read said stored,
    behind one any-lane-stored check."""
    img_u, fft, polar = features
    stored = (out.keyframe_slot >= 0) & (out.frame_id > 0)
    lc = find_loop_closure(
        state.bank, img_u, polar, out.frame_id, state.track.distance, out.pose,
        cf_ops, config.loop_closure, config.map.grid_scale, cur_fft=fft,
    )
    found = stored & lc.found
    _append_pending(state.pending, lc, out.keyframe_slot, found, camera)
    return state, out._replace(
        loop_found=found,
        loop_slot=torch.where(found, lc.loop_slot, -1),
        loop_eligible=torch.where(stored, lc.eligible_count, 0),
    )


def slam_step(state: SlamState, features, *, config, cf_ops: CFOps, camera: CameraOps,
              loop_search_fn=None, solver_fn=None, canvas_ops: Optional[CanvasOps] = None):
    """One frame from precomputed :func:`frontend` features → (state,
    StepOutput), every operation launched eagerly: the reference of
    :meth:`SlamEngine.step`.  The plug points are :func:`_insert_keyframe`'s."""
    if not bool(state.track.initialized):
        return _init_step(state, features, config=config, cf_ops=cf_ops, camera=camera)
    return _track_step(state, features, config=config, cf_ops=cf_ops, camera=camera,
                       loop_search_fn=loop_search_fn, solver_fn=solver_fn, canvas_ops=canvas_ops)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class SlamEngine:
    """Config + device tables (``cf_ops``, ``camera``) + the sequence entry points."""

    # The step's plug points (see _insert_keyframe); the distributed engine
    # sets all three.
    loop_search_fn = None
    solver_fn = None
    canvas_ops: Optional[CanvasOps] = None
    # Whether a graph holds the plug points' collectives (the distributed
    # engine's on a card: the peer all-reduce kernel), and the check of
    # their failure that the graphs' reads run (its group's ``check``).
    collectives_in_graph = False
    check_collectives: Optional[Callable[[], None]] = None

    def __init__(self, config, cf_ops: CFOps, camera: CameraOps, device: torch.device):
        self.config = config
        self.cf_ops = cf_ops
        self.camera = camera
        self.device = device
        self._track_graph: Optional[TrackGraph] = None
        self._frame_graph: Optional[FrameGraph] = None
        self._chunk_graph: Optional[ChunkGraph] = None
        self._solve_graph: Optional[SolveGraph] = None
        self._trigger_program = None

    @property
    def track_graph(self) -> TrackGraph:
        """The track graph of a tracked frame (:func:`run_chunk_track_graph`),
        made at its first use and captured at its first run on a card:
        once per engine."""
        if self._track_graph is None:
            self._track_graph = TrackGraph(self.config, self.device, functools.partial(
                _track_body, config=self.config, cf_ops=self.cf_ops, camera=self.camera))
        return self._track_graph

    def _make_graphs(self) -> None:
        """The frame graph over one more state's buffers (this engine's
        :meth:`init_state`: a distributed engine's holds its block of the
        bank) and its solve graph, made together at the first use of
        either; with the inline solve the frame graph is given the solve
        graph as its inline trigger.  With :attr:`branch_on_host` the
        frame graph runs the branch between launches, as captured steps
        between the plug points' collectives (:func:`staged_branch_parts`);
        with plug points whose collectives a graph holds
        (:attr:`collectives_in_graph`) it captures each branch kind whole,
        its collectives inside, for the chunk graph's SWITCH; without
        :attr:`uses_solve_graph` there is no solve graph."""
        kw = dict(config=self.config, cf_ops=self.cf_ops, camera=self.camera)
        track = functools.partial(_track_body, **kw)
        staged = functools.partial(staged_branch_parts, **kw, search=self.loop_search_fn, canvas=self.canvas_ops)
        if self.branch_on_host:
            frame_graph = HostBranchFrameGraph(self.config, self.init_state(), track, staged,
                                               self.check_collectives)
        elif self.loop_search_fn is not None or self.canvas_ops is not None:
            frame_graph = CollectiveFrameGraph(self.config, self.init_state(), track,
                                               functools.partial(staged, captured=True), self.check_collectives)
        else:
            frame_graph = FrameGraph(self.config, self.init_state(), track, functools.partial(_branch_body, **kw))
        solve_graph = None
        if self.uses_solve_graph:
            inline = self.config.optimizer.inline
            solve_graph = make_solve_graph(frame_graph, self.config, self.camera, inline=inline)
            if inline:
                frame_graph.inline = solve_graph
        self._frame_graph, self._solve_graph = frame_graph, solve_graph

    @property
    def frame_graph(self) -> FrameGraph:
        """The whole tracked frame's graphs over the state's own buffers,
        each captured at its first run on a card; with the inline solve,
        :attr:`solve_graph`'s inline trigger follows each stored branch."""
        if self._frame_graph is None:
            self._make_graphs()
        return self._frame_graph

    @property
    def chunk_graph(self) -> ChunkGraph:
        """A chunk's tracked frames as one graph launch over
        :attr:`frame_graph`'s buffers, built at its first launch and again
        when a branch kind was added."""
        if self._chunk_graph is None:
            self._chunk_graph = ChunkGraph(self.frame_graph)
        return self._chunk_graph

    @property
    def solve_graph(self) -> SolveGraph:
        """The deferred trigger as one graph launch over :attr:`frame_graph`'s
        buffers (and, with the inline solve, the inline trigger), its steps
        captured at the first trigger that solves."""
        if not self.uses_solve_graph:
            raise RuntimeError("this engine's trigger is its trigger program (a solver_fn and canvas hook): "
                               "it has no solve graph")
        if self._solve_graph is None:
            self._make_graphs()
        return self._solve_graph

    def _initialized(self, state: SlamState) -> bool:
        """Whether ``state`` has had its first frame: known without a read
        for the state that the frame graph lent last (it holds tracked
        frames), else one host read."""
        lent = self._frame_graph is not None and state is self._frame_graph._lent_state()
        return lent or bool(state.track.initialized)

    @property
    def branch_on_host(self) -> bool:
        """Whether a frame that inserts a keyframe leaves the chunk graph
        for a branch whose collectives the host makes: when the branch makes
        one that a graph cannot capture (the distributed engine's sharded
        search and canvas on gloo with CPU tensors, or its solve with the
        inline solve).  The branch runs as captured steps between them
        (:func:`staged_branch_parts`; the plug points must offer their
        staged forms, as the distributed engine's do).  Its tracked frames
        go through the chunk graph all the same.  With
        :attr:`collectives_in_graph` (a card) the branch stays in the chunk
        graph.  The configuration decides, never a failure."""
        plugs = self.loop_search_fn is not None or self.canvas_ops is not None
        return ((plugs and not self.collectives_in_graph)
                or (self.solver_fn is not None and self.config.optimizer.inline))

    @property
    def uses_solve_graph(self) -> bool:
        """Whether :meth:`optimize` and :meth:`finalize` launch
        :attr:`solve_graph` (the dense LM and the local canvas on the
        device).  Not with a ``solver_fn`` or canvas hook: the distributed
        engine's trigger is :attr:`trigger_program` (its GN-CG solve and
        sharded recompute, JAX's ``optimize`` around ``shard_map``), over
        the same buffers.  The configuration decides, never a failure."""
        return self.solver_fn is None and self.canvas_ops is None

    @property
    def trigger_program(self):
        """The deferred trigger of an engine without :attr:`uses_solve_graph`
        over :attr:`frame_graph`'s buffers (:meth:`make_trigger`), made at
        its first use."""
        if self.uses_solve_graph:
            raise RuntimeError("this engine's trigger is its solve graph")
        if self._trigger_program is None:
            self._trigger_program = self.make_trigger(self.frame_graph)
        return self._trigger_program

    def make_trigger(self, frame_graph: FrameGraph):
        """The trigger program over ``frame_graph``'s buffers, for an engine
        whose plug points bring one (the distributed engine's)."""
        raise NotImplementedError("a solver_fn or canvas hook brings its trigger program (make_trigger)")

    def init_state(self) -> SlamState:
        return init_state(self.config, self.device)

    def _features(self, images) -> tuple:
        images = torch.as_tensor(images).to(self.device)
        return frontend(images, cf_ops=self.cf_ops, camera=self.camera)

    def _steps(self) -> dict:
        """The keywords of the per-frame step functions."""
        return dict(config=self.config, cf_ops=self.cf_ops, camera=self.camera,
                    loop_search_fn=self.loop_search_fn, solver_fn=self.solver_fn, canvas_ops=self.canvas_ops)

    def _init(self, state: SlamState, feats) -> Tuple[SlamState, torch.Tensor]:
        """The first frame of a state, eagerly → (state, packed output)."""
        state, out = _init_step(state, feats, config=self.config, cf_ops=self.cf_ops, camera=self.camera)
        return state, out.pack()

    def step(self, state: SlamState, image) -> Tuple[SlamState, StepOutput]:
        """One (H, W) frame (u8, or f32 in [0, 1])."""
        state, packed = self.step_packed(state, image)
        return state, unpack_step_output(packed)

    def step_packed(self, state: SlamState, image) -> Tuple[SlamState, torch.Tensor]:
        """:meth:`step` with the output packed into one (17,) f32 device
        vector, unread: a live caller reads one small tensor per frame.  A
        tracked frame is a chunk of one through :attr:`chunk_graph`."""
        feats = self._features(image)
        if not self._initialized(state):
            return self._init(state, feats)
        packed = torch.empty((1, 17), dtype=torch.float32, device=self.device)
        self.frame_graph.load(state)
        self.chunk_graph.run(tuple(x[None] for x in feats), packed, 0)
        return self.frame_graph.lend(state), packed[0]

    def run_chunk(self, state: SlamState, images) -> Tuple[SlamState, StepOutput]:
        """(N, H, W) frames: the front end batched over the chunk, then the
        sequential steps: the tracked frames as one launch of
        :attr:`chunk_graph` (no host read between them, the inline solve
        included; one after the chunk), or, with :attr:`branch_on_host`,
        one launch more for each frame that inserts, whose branch the host
        runs between them.
        Returns stacked per-frame outputs (device)."""
        if len(images) == 0:
            return state, empty_step_output(self.device)
        img_u, fft, polar = self._features(images)
        n = fft.shape[0]
        packed = torch.empty((n, 17), dtype=torch.float32, device=self.device)
        start = 0
        if not self._initialized(state):
            state, p = self._init(state, (img_u[0], fft[0], polar[0]))
            packed[0].copy_(p)
            start = 1
        if start < n:
            self.frame_graph.load(state)
            self.chunk_graph.run((img_u, fft, polar), packed, start)
            state = self.frame_graph.lend(state)
        return state, unpack_step_output(packed)

    def optimize(self, state: SlamState) -> Tuple[SlamState, bool]:
        """The deferred pose-graph trigger → (state, ran), over the frame
        graph's buffers (the state loaded first, unless it is the one lent
        last): one launch of :attr:`solve_graph` and one read, or, without
        :attr:`uses_solve_graph`, :attr:`trigger_program` (the distributed
        engine's); for a state before its first frame, the host loop
        (:func:`optimize_host_loop`)."""
        if not self._initialized(state):
            return optimize_host_loop(self, state)
        if self.uses_solve_graph:
            state, ran = solve_lanes(self, state)
            return state, ran[0]
        graph = self.frame_graph
        graph.load(state)
        ran = self.trigger_program.run()
        return graph.lend(state), ran

    def finalize(self, state: SlamState) -> Tuple[SlamState, bool]:
        """End-of-sequence trigger: :meth:`optimize`, then the pending
        buffer cleared either way."""
        state, ran = self.optimize(state)
        state.pending.count.zero_()
        return state, ran

    def recompute_canvas(self, canvas: StitchCanvas, bank: KeyframeBank) -> StitchCanvas:
        """``canvas`` zeroed, then every live keyframe of ``bank`` (this
        engine's, sharded or not) rasterized at its pose."""
        return (self.canvas_ops or LOCAL_CANVAS).recompute(canvas, bank, self.camera)

    def run_sequence(
        self, state: SlamState, images, *, chunk_frames: int = 64,
        solve_tally: Optional[List[bool]] = None,
    ):
        """Whole (N, H, W) sequence, on the host or the device, in chunks of
        ``chunk_frames`` through :func:`streamed_deferred_drive`;
        ``solve_tally`` collects one bool per between-chunk trigger.
        Returns ``(state, StepOutput[N])`` as numpy arrays."""
        n = len(images)
        c = max(1, min(chunk_frames, n))
        chunks = ((images[start:start + c], None) for start in range(0, n, c))
        state, outs, _, ran = streamed_deferred_drive(self, state, chunks)
        if solve_tally is not None:
            solve_tally.extend(ran)
        return state, outs


def make_solve_graph(frame_graph: FrameGraph, config, camera: CameraOps, inline: bool = False) -> SolveGraph:
    """The solve graph of an engine's frame graph (one lane or a batch);
    ``inline``: with the inline trigger (the single engine's, with
    ``optimizer.inline``)."""
    kw = dict(config=config, camera=camera)
    return SolveGraph(frame_graph, _solver_config(config), functools.partial(_solve_setup, **kw),
                      functools.partial(_solve_finish, **kw), scale_free=not config.camera.accurate_height,
                      inline_finish=functools.partial(_inline_finish, **kw) if inline else None)


def solve_lanes(engine, state: SlamState) -> Tuple[SlamState, List[bool]]:
    """One launch of ``engine.solve_graph`` over ``state`` (loaded into the
    frame graph's buffers, then lent) → (state, ran per lane); the online
    canvas is recomputed inside the launch."""
    graph = engine.frame_graph
    graph.load(state)
    ran = engine.solve_graph.run()
    return graph.lend(state), ran


def run_chunk_frame_graph(engine: SlamEngine, state: SlamState, images) -> Tuple[SlamState, StepOutput]:
    """:meth:`SlamEngine.run_chunk` through the frame graph frame by frame,
    with its flag read: per tracked frame three feature copies, the track
    graph's replay, the flag read, for a keyframe the branch graph's
    replay (for a stored one with the inline solve, one launch of the
    inline trigger's graph), one copy of the packed output into row i.
    The reference that the chunk graph is held and timed against."""
    if len(images) == 0:
        return state, empty_step_output(engine.device)
    img_u, fft, polar = engine._features(images)
    n = fft.shape[0]
    packed = torch.empty((n, 17), dtype=torch.float32, device=engine.device)
    start = 0
    if not engine._initialized(state):
        state, p = engine._init(state, (img_u[0], fft[0], polar[0]))
        packed[0].copy_(p)
        start = 1
    if start < n:
        graph = engine.frame_graph
        graph.load(state)
        for i in range(start, n):
            packed[i].copy_(graph.run(img_u[i], fft[i], polar[i]))
        if graph.inline is not None:
            graph.inline.collect()  # what the inline graphs ran: one read
        state = graph.lend(state)
    return state, unpack_step_output(packed)


def run_chunk_track_graph(engine: SlamEngine, state: SlamState, images) -> Tuple[SlamState, StepOutput]:
    """:meth:`SlamEngine.run_chunk` through the track-graph path: each
    tracked frame one run of ``engine.track_graph`` over a copy of the
    tracking chain, the flag read, and the keyframe branch launched
    eagerly on the caller's state (:func:`_graph_track_step`, the inline
    solve's host loop in it).  A reference that the chunk graph is held
    and timed against (with plug points too: the distributed engine's
    branch on the host)."""
    if len(images) == 0:
        return state, empty_step_output(engine.device)
    img_u, fft, polar = engine._features(images)
    packed, start = [], 0
    if not bool(state.track.initialized):
        state, p = engine._init(state, (img_u[0], fft[0], polar[0]))
        packed.append(p)
        start = 1
    if start < fft.shape[0]:
        engine.track_graph.load(state)
    for i in range(start, fft.shape[0]):
        state, p = _graph_track_step(state, (img_u[i], fft[i], polar[i]), engine.track_graph, **engine._steps())
        packed.append(p)
    return state, unpack_step_output(torch.stack(packed))


def run_chunk_eager(engine: SlamEngine, state: SlamState, images) -> Tuple[SlamState, StepOutput]:
    """:meth:`SlamEngine.run_chunk` with every operation of every frame
    launched eagerly (:func:`_track_step`): the reference that the captured
    graph is held against, on the card and on the CPU."""
    if len(images) == 0:
        return state, empty_step_output(engine.device)
    img_u, fft, polar = engine._features(images)
    steps = engine._steps()
    initialized = bool(state.track.initialized)
    packed = []
    for i in range(fft.shape[0]):
        feats = (img_u[i], fft[i], polar[i])
        if initialized:
            state, out = _track_step(state, feats, **steps)
        else:
            state, out = _init_step(state, feats, config=engine.config, cf_ops=engine.cf_ops, camera=engine.camera)
            initialized = True
        packed.append(out.pack())
    return state, unpack_step_output(torch.stack(packed))


def outputs_to_numpy(outs: List[StepOutput], dim: int = 0) -> StepOutput:
    """Per-chunk device outputs concatenated along the frame axis ``dim``
    and brought to the host in one read (packed, see
    :meth:`StepOutput.pack`) → numpy fields."""
    return unpack_step_output(torch.cat([o.pack() for o in outs], dim=dim).cpu().numpy())


def streamed_deferred_drive(
    engine: SlamEngine, state: SlamState, chunk_iter, *, max_frames: int = 0,
):
    """The sequence loop, over chunks ``(images (m, H, W), times (m,) or
    None)``: the CLI's datasets and NISF reader, and
    :meth:`SlamEngine.run_sequence`'s slices.

    Each chunk runs as it comes (the short tail needs no padding in eager
    mode).  With the deferred solve, :meth:`SlamEngine.optimize` runs after
    every chunk, the tail included — the cadence of the JAX
    ``chunked_deferred_drive``; with ``optimizer.inline`` the step solves
    and no trigger runs between chunks.  ``max_frames`` (0: all) truncates.
    On a CUDA device a host chunk is staged in pinned memory (unless its
    reader pinned it already) and copied on a side stream with
    ``non_blocking=True`` before the current chunk runs, so the copy
    overlaps its compute; chunks already on the card run as they are.
    Per-frame outputs stay on the device until the end (one read).

    Returns ``(state, outs (numpy, N frames), times (N,), ran)``: ``times``
    is empty when the chunks carry none, and ``ran`` holds one bool per
    trigger (:meth:`SlamEngine.optimize`'s)."""
    dev = engine.device
    deferred = not engine.config.optimizer.inline
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    it = iter(chunk_iter)
    done = 0

    def fetch():
        nonlocal done
        if max_frames and done >= max_frames:
            return None
        try:
            imgs, ts = next(it)
        except StopIteration:
            return None
        m = len(imgs) if not max_frames else min(len(imgs), max_frames - done)
        if m == 0:
            return None
        done += m
        imgs = imgs[:m]
        ts = None if ts is None else np.asarray(ts)[:m]
        if copy_stream is None or (isinstance(imgs, torch.Tensor) and imgs.is_cuda):
            return imgs, None, ts
        host = torch.as_tensor(np.ascontiguousarray(imgs)) if isinstance(imgs, np.ndarray) else imgs
        if not host.is_pinned():
            host = host.pin_memory()
        with torch.cuda.stream(copy_stream):
            dev_imgs = host.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return dev_imgs, ready, ts

    outs, times, ran_flags = [], [], []
    cur = fetch()
    while cur is not None:
        imgs, ready, ts = cur
        if ready is not None:
            torch.cuda.current_stream(dev).wait_event(ready)
            imgs.record_stream(torch.cuda.current_stream(dev))
        cur = fetch()  # staged and copying while this chunk runs
        state, o = engine.run_chunk(state, imgs)
        outs.append(o)
        if ts is not None:
            times.append(ts)
        if deferred:
            state, ran = engine.optimize(state)
            ran_flags.append(ran)
    merged = outputs_to_numpy(outs if outs else [empty_step_output(dev)])
    return state, merged, np.concatenate(times) if times else np.zeros((0,)), ran_flags


def make_engine(config, device: torch.device) -> SlamEngine:
    """Engine for ``config`` on ``device`` (explicit: nothing picks a
    device).  Turns TF32 off for the process: the KCC filter solve spans the
    full f32 range, and reduced-precision operands collapse the PSR below
    the tracking gates."""
    _stitch_online(config)  # refuses an online canvas without stored images
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    return SlamEngine(
        config,
        make_cf_ops(config.cf).to(device),
        make_camera_ops(config.camera).to(device),
        device,
    )
