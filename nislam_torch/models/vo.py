"""Visual odometry model: frame-to-keyframe KCC tracking, no back end.

Counterpart of ``nislam_tpu.models.vo``: the engine with loop closure
pinned off, so the pose chain is the front end's closed-form output.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from nislam_torch.core.slam import SlamEngine, SlamState, StepOutput, make_engine


class VisualOdometry:
    """The engine for ``config`` on ``device`` (the card unless the caller
    asks for another) with ``loop_closure.to_find_loop`` off."""

    def __init__(self, config, device="cuda"):
        self.config = config
        cfg = dataclasses.replace(
            config, loop_closure=dataclasses.replace(config.loop_closure, to_find_loop=False)
        )
        self.engine: SlamEngine = make_engine(cfg, torch.device(device))

    def init_state(self) -> SlamState:
        return self.engine.init_state()

    def step(self, state: SlamState, image) -> Tuple[SlamState, StepOutput]:
        return self.engine.step(state, image)

    def run(self, images) -> Tuple[SlamState, StepOutput]:
        """Track a whole (N, H, W) sequence as one chunk; outputs stay on
        the device."""
        return self.engine.run_chunk(self.engine.init_state(), images)

    def trajectory(self, outs: StepOutput) -> np.ndarray:
        """(N, 3) raw KCC odometry in the robot frame."""
        cf = outs.cf_pose
        return cf.cpu().numpy() if isinstance(cf, torch.Tensor) else np.asarray(cf)

    def evaluate(self, images, *, times=None, gt_xy=None, gt_times=None,
                 chunk_frames: int = 64) -> "EvalResult":
        """Throughput, tracking and ATE of the raw odometry chain on an
        (N, H, W) sequence: :meth:`SlamEngine.run_sequence` in chunks of
        ``chunk_frames``, timed until its outputs and the keyframe count
        are on the host.  ``gt_xy`` (N, 2) scores the chain when given."""
        n = len(images)
        state = self.engine.init_state()
        t0 = time.perf_counter()
        state, outs = self.engine.run_sequence(state, images, chunk_frames=chunk_frames)
        n_kf = int(state.bank.count)
        dt = time.perf_counter() - t0
        return _evaluate_outputs(outs, n, dt, times, gt_xy, outs.cf_pose, n_kf, gt_times=gt_times)


@dataclasses.dataclass(frozen=True)
class EvalResult:
    """One evaluation record: frames/s, ATE, tracking."""

    frames: int
    fps: float
    ate_rmse_m: Optional[float]
    tracked_frac: float
    keyframes: int
    trajectory: np.ndarray  # (N, 3) estimated poses (robot frame)


def _evaluate_outputs(outs, n, dt, times, gt_xy, traj, n_kf, gt_times=None) -> EvalResult:
    from nislam_torch.io.trajectory import ate_rmse

    ate = None
    if gt_xy is not None:
        t = np.asarray(times) if times is not None else np.arange(n) / 30.0
        gt_xy = np.asarray(gt_xy)
        # Real ground-truth timestamps when given (association by time),
        # else index alignment (synthetic ground truth, one pose per frame).
        gt_t = np.asarray(gt_times) if gt_times is not None else t[: len(gt_xy)]
        try:
            ate = ate_rmse(t[: len(traj)], traj[:, :2], gt_t, gt_xy)
        except ValueError:
            ate = None
    return EvalResult(
        frames=n,
        fps=n / dt if dt > 0 else float("inf"),
        ate_rmse_m=ate,
        tracked_frac=float(np.asarray(outs.tracked).mean()),
        keyframes=n_kf,
        trajectory=traj,
    )
