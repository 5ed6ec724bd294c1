"""Offline visualization: trajectory plots and occupancy-map images.

Counterpart of ``nislam_tpu.io.visualization``: a trajectory figure
(matplotlib, imported at first use) and the stitched occupancy map as a
PNG (cv2 or PIL), written at the end of a run or every N frames.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Sequence

import numpy as np


def save_trajectory_plot(
    path: str,
    kcc_xy: np.ndarray,
    optimized_xy: Optional[np.ndarray] = None,
    gt_xy: Optional[np.ndarray] = None,
    loop_pairs: Optional[Sequence[tuple]] = None,
) -> str:
    """Plot raw KCC odometry vs optimized keyframe path (vs ground truth)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    if gt_xy is not None:
        ax.plot(gt_xy[:, 0], gt_xy[:, 1], "-", color="0.6", lw=1.5, label="ground truth")
    ax.plot(kcc_xy[:, 0], kcc_xy[:, 1], "-", lw=1.0, label="KCC odometry")
    if optimized_xy is not None:
        ax.plot(
            optimized_xy[:, 0], optimized_xy[:, 1], "-", lw=1.0,
            label="optimized keyframes",
        )
    if loop_pairs:
        for (a, b) in loop_pairs:
            ax.plot([a[0], b[0]], [a[1], b[1]], "r-", lw=0.5, alpha=0.6)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def save_occupancy_png(path: str, grid: np.ndarray) -> str:
    """Occupancy grid (int8, −1 unseen / 0..100) → grayscale PNG.

    Unseen → mid-gray 128 (rviz-like), occupancy 0..100 → 255..0.
    """
    g = np.asarray(grid, np.int16)
    img = np.where(g < 0, 128, (100 - np.clip(g, 0, 100)) * 255 // 100).astype(
        np.uint8
    )
    try:
        import cv2

        cv2.imwrite(path, img)
    except ImportError:
        from PIL import Image

        Image.fromarray(img).save(path)
    return path


class RunSnapshotter:
    """Writes ``snapshots/trajectory_NNNNNN.png`` (and
    ``occupancy_NNNNNN.png`` when the stitcher is on and images are stored)
    under ``saving_root`` every call, and refreshes
    ``trajectory_latest.png`` / ``occupancy_latest.png`` beside them, so a
    long step-mode run can be watched while it runs."""

    def __init__(self, saving_root: str, engine, config):
        self.dir = os.path.join(saving_root, "snapshots")
        os.makedirs(self.dir, exist_ok=True)
        self.engine = engine
        self.config = config

    def emit(self, state, outs_list, frame_no: int) -> None:
        """``outs_list``: the per-frame ``StepOutput``s so far (numpy)."""
        from nislam_torch.core.stitcher import make_canvas, occupancy_grid

        kf = [o for o in outs_list if o.keyframe_slot >= 0]
        if not kf:
            return
        kcc_xy = np.stack([o.cf_pose[:2] for o in kf])
        slots = np.asarray([int(o.keyframe_slot) for o in kf])
        bank_poses = state.bank.poses.cpu().numpy()
        p = save_trajectory_plot(
            os.path.join(self.dir, f"trajectory_{frame_no:06d}.png"),
            kcc_xy, bank_poses[slots][:, :2],
        )
        shutil.copyfile(p, os.path.join(os.path.dirname(self.dir), "trajectory_latest.png"))
        if self.config.map_stitcher.stitch_map and self.config.map.store_images:
            canvas = self.engine.recompute_canvas(
                make_canvas(self.config.map_stitcher, self.engine.device), state.bank)
            p = save_occupancy_png(
                os.path.join(self.dir, f"occupancy_{frame_no:06d}.png"),
                occupancy_grid(canvas).cpu().numpy(),
            )
            shutil.copyfile(p, os.path.join(os.path.dirname(self.dir), "occupancy_latest.png"))
