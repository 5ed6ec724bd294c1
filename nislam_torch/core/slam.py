"""The SLAM engine: per-frame step, chunked sequence loop, deferred pose-graph solve.

Counterpart of ``nislam_tpu.core.slam`` on its main path (deferred
optimize, no online stitcher).  Where the JAX step is one branch-free
program with ``lax.cond``, this engine runs eagerly:

- the front end (undistort + KCC features) runs batched over a chunk;
- tracking, the keyframe decision and the pose bookkeeping run on the
  device with no host branch;
- ONE packed flag tensor per tracked frame, ``[insert, stored]``, is read
  to decide on the host whether to compute the keyframe filters, insert
  into the bank, add the edge and run the loop search.  The pending-match
  append stays masked on the device.

Host syncs, recorded for a later CUDA-graph capture of tracking: the flag
read above (every tracked frame); ``state.track.initialized`` (once per
chunk or step); the live pending count (once per :meth:`SlamEngine.optimize`);
after a trigger, the pending count and slots (once) and (accept, converged)
once per LM iteration.

The state is mutated in place (the bank, edge store and pending buffer are
written slot by slot); JAX donates it instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nislam_torch.core.camera import CameraOps, make_camera_ops
from nislam_torch.core.loop_closure import find_loop_closure, no_loop_result
from nislam_torch.core.map_store import (
    EDGE_KCC,
    EDGE_LOOP,
    EdgeStore,
    KeyframeBank,
    write_slot,
    add_edge,
    add_keyframe,
    invalidate_edges,
    make_edge_store,
    make_keyframe_bank,
)
from nislam_torch.core.pose_graph import (
    PoseGraphProblem,
    SolverConfig,
    solve_pose_graph,
    sqrt_information,
)
from nislam_torch.core.se2 import absolute_pose, relative_pose
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


class StepOutput(NamedTuple):
    tracked: torch.Tensor  # bool
    inserted: torch.Tensor  # bool
    loop_found: torch.Tensor  # bool
    optimized: torch.Tensor  # bool (always False with the deferred solve)
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


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


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


def state_from_numpy(tree, device: torch.device) -> SlamState:
    """A :class:`SlamState` from any object with the JAX ``SlamState``'s
    attribute layout (``bank.fft``, ``track.last_filt``, ...) whose leaves
    convert with ``np.asarray`` — e.g. a JAX state mapped to numpy.  bf16
    leaves stay bf16; the JAX state's stitcher canvas is ignored."""
    leaf = lambda x: _leaf_to_torch(x, device)
    return SlamState(
        bank=_convert(KeyframeBank, tree.bank, leaf),
        edges=_convert(EdgeStore, tree.edges, leaf),
        track=_convert(TrackState, tree.track, leaf),
        pending=_convert(PendingLoops, tree.pending, leaf),
    )


def state_to_numpy(state: SlamState) -> SlamState:
    """The same dataclasses with numpy leaves (bf16 leaves as exact float32)."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()

    return SlamState(
        bank=_convert(KeyframeBank, state.bank, leaf),
        edges=_convert(EdgeStore, state.edges, leaf),
        track=_convert(TrackState, state.track, leaf),
        pending=_convert(PendingLoops, state.pending, leaf),
    )


# ---------------------------------------------------------------------------
# Pose-graph trigger (deferred: between chunks)
# ---------------------------------------------------------------------------


def _optimize_map(bank: KeyframeBank, edges: EdgeStore, config, camera: CameraOps):
    """Solve the pose graph over the whole bank → (poses, cost).  Edge
    measurements are converted camera→robot; dead edges get identity
    information (their residuals are masked)."""
    mask = edges.valid_mask()
    eye = torch.eye(3, dtype=torch.float32, device=mask.device)
    safe_info = torch.where(mask[:, None, None], edges.info, eye)
    prob = PoseGraphProblem(
        poses=bank.poses,
        pose_mask=bank.valid_mask(),
        from_slot=edges.from_slot,
        to_slot=edges.to_slot,
        T=camera.camera_to_robot(edges.T),
        sqrt_info=sqrt_information(safe_info),
        edge_mask=mask,
    )
    cfg = SolverConfig(
        max_iterations=config.optimizer.max_iterations,
        estimate_scale=config.optimizer.with_scale,
    )
    poses, _, cost = solve_pose_graph(
        prob, cfg, init_scale=1.0, scale_free=not config.camera.accurate_height
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


def _live_pending_count(pending: PendingLoops) -> torch.Tensor:
    p = pending.loop_slot.shape[0]
    live = (torch.arange(p, device=pending.count.device) < pending.count) & (
        pending.loop_slot >= 0
    )
    return live.to(torch.int32).sum()


def _add_loop_edges_and_solve(state: SlamState, config, camera: CameraOps) -> SlamState:
    """Add the pending loop edges, solve, write the optimized poses and
    clear the pending buffer."""
    pending = state.pending
    count = int(pending.count)
    loop_slots = pending.loop_slot[:count].tolist()
    rel_cam = camera.image_plane_to_camera(pending.rel_pose)
    for i in range(count):
        add_edge(
            state.edges,
            from_slot=pending.loop_slot[i],
            to_slot=pending.cur_slot[i],
            T=rel_cam[i],
            edge_type=EDGE_LOOP,
            enabled=loop_slots[i] >= 0,  # -1 marks a match voided by eviction
        )
    poses, _ = _optimize_map(state.bank, state.edges, config, camera)
    state.bank.poses = poses
    pending.count.zero_()
    return state


def maybe_optimize(state: SlamState, *, config, camera: CameraOps) -> Tuple[SlamState, bool]:
    """Deferred trigger: solve iff ≥2 live matches are pending (single
    matches are kept), then re-derive the tracking chain from the optimized
    pose of the current target."""
    run = bool(_live_pending_count(state.pending) >= 2)
    if run:
        state = _add_loop_edges_and_solve(state, config, camera)
        opt = state.bank.poses.index_select(0, state.track.last_slot.reshape(1).long())[0]
        opt_cam = camera.robot_to_camera(opt)
        state.track = dataclasses.replace(
            state.track,
            last_pose=opt,
            last_cf_real_pose=opt_cam,
            last_cf_pose=camera.camera_to_image_plane(opt_cam),
        )
    return state, run


def check_and_optimize_final(state: SlamState, *, config, camera: CameraOps) -> Tuple[SlamState, bool]:
    """End-of-sequence trigger; clears the pending buffer either way."""
    state, ran = maybe_optimize(state, config=config, camera=camera)
    state.pending.count.zero_()
    return state, ran


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


def _track_step(state: SlamState, features, *, config, cf_ops: CFOps, camera: CameraOps):
    kfs = config.keyframe_selection
    lc_cfg = config.loop_closure
    img_u, fft, polar = features
    dev = fft.device
    track = state.track
    frame_id = track.next_frame_id

    # --- Tracking ------------------------------------------------------
    rel_center, response = compute_pose(
        r2c(track.last_fft), img_u, r2c(track.last_polar), polar, cf_ops,
        large_rotation=False,
        filters=(r2c(track.last_filt), r2c(track.last_filt_polar)),
    )
    rel_principal = camera.center_to_principal(rel_center)
    good = (response[0] > kfs.lower_response_thr) & (response[2] > kfs.lower_rot)
    cur_cf_pose = absolute_pose(track.last_cf_pose, rel_principal)
    cur_cf_real = camera.image_plane_to_camera(cur_cf_pose)
    rel_robot = relative_pose(
        camera.image_plane_to_robot(track.last_cf_pose),
        camera.image_plane_to_robot(cur_cf_pose),
    )
    cur_pose = absolute_pose(track.last_pose, rel_robot)

    # --- Keyframe decision ---------------------------------------------
    da_cam = camera.image_plane_to_camera(cur_cf_pose - track.last_cf_pose)
    d = torch.linalg.vector_norm(da_cam[:2])
    a = torch.abs(da_cam[2])
    c3 = (response[0] > kfs.lower_response_thr) & (response[0] < kfs.upper_response_thr)
    c4 = (response[2] > kfs.lower_rot) & (response[2] < kfs.upper_rot)
    insert = good & ((d > kfs.max_distance) | (a > kfs.max_angle) | c3 | c4)
    new_distance = track.distance + torch.where(insert, d, 0.0)
    ring = config.map.eviction == "ring" and state.bank.capacity > 2
    will_store = insert & (ring | (state.bank.count < state.bank.capacity))
    # The one host read of a tracked frame.
    insert_h, stored_h = torch.stack([insert, will_store]).tolist()

    no_slot = _scalar(-1, torch.int32, dev)
    keyframe_slot = no_slot
    lc = no_loop_result(dev)
    loop_found = _scalar(False, torch.bool, dev)
    if insert_h:
        # --- Edge + bank insert ------------------------------------------
        fi, fp = compute_keyframe_filters(fft, polar, cf_ops)
        _, slot, stored, evicted = add_keyframe(
            state.bank, fft=fft, polar_fft=polar, filt=fi, filt_polar=fp,
            image=img_u, pose=cur_pose, frame_id=frame_id, distance=new_distance,
            grid_scale=config.map.grid_scale, enabled=True,
            evict=config.map.eviction == "ring", protect_slot=track.last_slot,
        )
        # Edges to the evicted slot are void; invalidate BEFORE the new edge,
        # which legitimately targets the reused slot.
        invalidate_edges(state.edges, evicted)
        add_edge(
            state.edges, from_slot=track.last_slot, to_slot=slot,
            T=relative_pose(track.last_cf_real_pose, cur_cf_real),
            edge_type=EDGE_KCC, enabled=stored,
        )
        state.pending = _invalidate_pending(state.pending, evicted)
        keyframe_slot = torch.where(stored, slot, no_slot)

        # --- Loop closure --------------------------------------------------
        if stored_h and lc_cfg.to_find_loop:
            lc = find_loop_closure(
                state.bank, img_u, polar, frame_id, new_distance, cur_pose,
                cf_ops, lc_cfg, config.map.grid_scale,
            )
            loop_found = lc.found
            pending = state.pending
            cap = pending.loop_slot.shape[0]
            pslot = torch.clamp(pending.count, max=cap - 1)
            padd = loop_found & (pending.count < cap)
            write_slot(pending.loop_slot, pslot, lc.loop_slot, padd)
            write_slot(pending.cur_slot, pslot, slot, padd)
            write_slot(pending.rel_pose, pslot, camera.center_to_principal(lc.relative_pose), padd)
            pending.count += padd.to(torch.int32)

        track = dataclasses.replace(
            track,
            last_fft=c2r(fft),
            last_polar=c2r(polar),
            last_filt=c2r(fi),
            last_filt_polar=c2r(fp),
            last_cf_pose=cur_cf_pose,
            last_cf_real_pose=cur_cf_real,
            last_pose=cur_pose,
            last_slot=torch.where(stored, slot, track.last_slot),
        )
    state.track = dataclasses.replace(
        track,
        distance=new_distance,
        next_frame_id=frame_id + 1,
        initialized=_scalar(True, torch.bool, dev),
    )

    # Raw odometry in the robot frame, relative to the cf origin's pose.
    cf_pose = relative_pose(
        camera.image_plane_to_robot(torch.zeros(3, dtype=torch.float32, device=dev)),
        camera.image_plane_to_robot(cur_cf_pose),
    )
    out = StepOutput(
        tracked=good,
        inserted=insert,
        loop_found=loop_found,
        optimized=_scalar(False, torch.bool, dev),
        response=response,
        cf_pose=cf_pose,
        pose=cur_pose,
        frame_id=frame_id,
        keyframe_slot=keyframe_slot,
        loop_slot=torch.where(loop_found, lc.loop_slot, no_slot),
        loop_eligible=lc.eligible_count,
    )
    return state, out


def slam_step(state: SlamState, features, *, config, cf_ops: CFOps, camera: CameraOps):
    """One frame from precomputed :func:`frontend` features → (state, StepOutput)."""
    step = _track_step if bool(state.track.initialized) else _init_step
    return step(state, features, config=config, cf_ops=cf_ops, camera=camera)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class SlamEngine:
    """Config + device tables (``cf_ops``, ``camera``) + the sequence entry points."""

    def __init__(self, config, cf_ops: CFOps, camera: CameraOps, device: torch.device):
        self.config = config
        self.cf_ops = cf_ops
        self.camera = camera
        self.device = device

    def init_state(self) -> SlamState:
        return init_state(self.config, self.device)

    def _features(self, images) -> tuple:
        images = torch.as_tensor(images).to(self.device)
        return frontend(images, cf_ops=self.cf_ops, camera=self.camera)

    def step(self, state: SlamState, image) -> Tuple[SlamState, StepOutput]:
        """One (H, W) frame (u8, or f32 in [0, 1])."""
        return slam_step(
            state, self._features(image), config=self.config,
            cf_ops=self.cf_ops, camera=self.camera,
        )

    def run_chunk(self, state: SlamState, images) -> Tuple[SlamState, StepOutput]:
        """(N, H, W) frames: the front end batched over the chunk, then the
        sequential steps.  Returns stacked per-frame outputs (device)."""
        img_u, fft, polar = self._features(images)
        kw = dict(config=self.config, cf_ops=self.cf_ops, camera=self.camera)
        initialized = bool(state.track.initialized)
        packed = []
        for i in range(fft.shape[0]):
            feats = (img_u[i], fft[i], polar[i])
            if initialized:
                state, out = _track_step(state, feats, **kw)
            else:
                state, out = _init_step(state, feats, **kw)
                initialized = True
            packed.append(out.pack())
        if not packed:
            return state, unpack_step_output(torch.zeros((0, 17), device=self.device))
        return state, unpack_step_output(torch.stack(packed))

    def optimize(self, state: SlamState) -> Tuple[SlamState, bool]:
        """The deferred pose-graph trigger → (state, ran)."""
        return maybe_optimize(state, config=self.config, camera=self.camera)

    def finalize(self, state: SlamState) -> Tuple[SlamState, bool]:
        """End-of-sequence trigger."""
        return check_and_optimize_final(state, config=self.config, camera=self.camera)

    def run_sequence(
        self, state: SlamState, images, *, numpy_outputs: bool = True,
        chunk_frames: int = 64, solve_tally: Optional[List[bool]] = None,
    ):
        """Whole (N, H, W) sequence in chunks of ``chunk_frames`` with
        :meth:`optimize` after every chunk, the short tail chunk included —
        the cadence of the JAX ``chunked_deferred_drive``.  ``solve_tally``
        collects one bool per trigger.  Returns ``(state, StepOutput[N])``."""
        n = len(images)
        outs = []
        c = max(1, min(chunk_frames, n))
        for start in range(0, n, c):
            state, o = self.run_chunk(state, images[start:start + c])
            outs.append(o)
            state, ran = self.optimize(state)
            if solve_tally is not None:
                solve_tally.append(ran)
        if not outs:
            outs = [unpack_step_output(torch.zeros((0, 17), device=self.device))]
        merged = StepOutput(*(torch.cat(xs) for xs in zip(*outs)))
        if numpy_outputs:
            merged = StepOutput(*(x.cpu().numpy() for x in merged))
        return state, merged


def streamed_deferred_drive(*args, **kwargs):
    """The JAX engine's streaming sequence loop: not ported yet."""
    raise NotImplementedError("streamed_deferred_drive is not ported yet")


def make_engine(config, device: torch.device) -> SlamEngine:
    """Engine for ``config`` on ``device`` (explicit: nothing picks a
    device).  Turns TF32 off for the process: the KCC filter solve spans the
    full f32 range, and reduced-precision operands collapse the PSR below
    the tracking gates."""
    if config.optimizer.inline:
        raise NotImplementedError("optimizer.inline is not ported yet")
    if config.map_stitcher.stitch_map and config.map_stitcher.online:
        raise NotImplementedError("map_stitcher.online is not ported yet")
    if config.loop_closure.coarse_scale > 1:
        raise NotImplementedError("loop_closure.coarse_scale > 1 is not ported yet")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    return SlamEngine(
        config,
        make_cf_ops(config.cf).to(device),
        make_camera_ops(config.camera).to(device),
        device,
    )
