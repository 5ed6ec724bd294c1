"""Full SLAM model: tracking, loop closure, pose graph and map stitching.

Counterpart of ``nislam_tpu.models.slam``: the complete system behind one
object, with the occupancy mosaic produced on demand from the keyframe
bank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from nislam_torch.core.slam import SlamEngine, SlamState, StepOutput, make_engine
from nislam_torch.core.stitcher import (
    StitchCanvas,
    make_canvas,
    map_resolution,
    occupancy_grid,
    occupancy_origin,
)


class FullSlam:
    """The engine for ``config`` on ``device``, the card unless the caller
    asks for another."""

    def __init__(self, config, device="cuda"):
        self.config = config
        self.engine: SlamEngine = make_engine(config, torch.device(device))

    def init_state(self) -> SlamState:
        return self.engine.init_state()

    def step(self, state: SlamState, image) -> Tuple[SlamState, StepOutput]:
        return self.engine.step(state, image)

    def run(self, images, state: Optional[SlamState] = None):
        """An (N, H, W) sequence and the final optimize → ``(state,
        outputs (numpy), final_optimize_ran)``."""
        if state is None:
            state = self.engine.init_state()
        state, outs = self.engine.run_sequence(state, images)
        state, ran = self.engine.finalize(state)
        return state, outs, ran

    def stitch(self, state: SlamState) -> StitchCanvas:
        """The occupancy canvas: the live one when stitching online, else
        rasterized from the bank.

        With ``map.store_images`` the online engine subtracts an evicted
        keyframe's pixels when it evicts it, so the live canvas equals
        ``recompute(bank)`` and is returned.  Without stored images it
        cannot: once a ring eviction has happened the live canvas still
        holds evicted keyframes' pixels, and the export rasterizes the
        live bank instead."""
        if not self.config.map_stitcher.stitch_map:
            raise ValueError("map_stitcher.stitch_map is disabled in config")
        stale_inclusive = (
            self.config.map.eviction == "ring"
            and not self.config.map.store_images
            and int(state.bank.overflow) > 0
        )
        if self.config.map_stitcher.online and state.canvas.data.numel() and not stale_inclusive:
            return state.canvas
        return self.engine.recompute_canvas(make_canvas(self.config.map_stitcher, self.engine.device),
                                            state.bank)

    def occupancy(self, state: SlamState):
        """``(grid int8, origin_xy (2,), resolution)``, the occupancy-grid
        triple."""
        canvas = self.stitch(state)
        camera = self.engine.camera
        return (
            occupancy_grid(canvas).cpu().numpy(),
            occupancy_origin(camera, canvas).cpu().numpy(),
            float(map_resolution(camera)),
        )

    def keyframe_poses(self, state: SlamState) -> np.ndarray:
        """(K, 3) optimized keyframe poses."""
        return state.bank.poses[: int(state.bank.count)].cpu().numpy()

    def evaluate(self, images, *, times=None, gt_xy=None, gt_times=None,
                 chunk_frames: int = 64) -> "SlamEvalResult":
        """The full system on an (N, H, W) sequence, scored on the
        OPTIMIZED keyframe poses: :meth:`SlamEngine.run_sequence` (which
        tallies its between-chunk solves) and ``finalize``, timed until the
        bank's poses are on the host.  ``gt_xy`` (N, 2) is associated with
        the keyframes by frame index (or by ``gt_times``)."""
        from nislam_torch.io.trajectory import ate_rmse

        n = len(images)
        state = self.engine.init_state()
        tally: list = []
        t0 = time.perf_counter()
        state, outs = self.engine.run_sequence(state, images, chunk_frames=chunk_frames,
                                               solve_tally=tally)
        state, ran = self.engine.finalize(state)
        kf_poses = state.bank.poses.cpu().numpy()
        dt = time.perf_counter() - t0
        t = np.asarray(times) if times is not None else np.arange(n) / 30.0
        idx = np.where(outs.keyframe_slot >= 0)[0]
        slots = outs.keyframe_slot[idx]
        # Ring eviction reuses slots: a slot still holds a keyframe's pose
        # only if the bank's frame id there is the frame that inserted it.
        live = state.bank.frame_ids.cpu().numpy()[slots] == outs.frame_id[idx]
        idx, slots = idx[live], slots[live]
        traj = kf_poses[slots]
        ate = None
        if gt_xy is not None:
            gt_xy = np.asarray(gt_xy)
            gt_t = np.asarray(gt_times) if gt_times is not None else t[: len(gt_xy)]
            keep = idx < len(gt_xy) if gt_times is None else np.ones(len(idx), bool)
            try:
                ate = ate_rmse(t[idx[keep]], traj[keep][:, :2], gt_t, gt_xy)
            except ValueError:
                ate = None
        return SlamEvalResult(
            frames=n,
            fps=n / dt if dt > 0 else float("inf"),
            ate_rmse_m=ate,
            tracked_frac=float(outs.tracked.mean()),
            keyframes=int(state.bank.count),
            loops=int(outs.loop_found.sum()),
            solves=int(outs.optimized.sum()) + sum(tally) + int(ran),
            keyframe_trajectory=traj,
        )


@dataclasses.dataclass(frozen=True)
class SlamEvalResult:
    """Full-system evaluation record."""

    frames: int
    fps: float
    ate_rmse_m: Optional[float]
    tracked_frac: float
    keyframes: int
    loops: int
    solves: int
    keyframe_trajectory: np.ndarray  # (K_used, 3) optimized keyframe poses
