"""The torch models layer against ``nislam_tpu.models``, on the CPU.

The same numpy-rendered frames go through both packages at 96×128.
Decisions and integer counts must be equal; poses within 2e-3; PSRs at
rtol 5e-4 (two f32 FFT chains, see test_torch_ops.py).  JAX's
``peak_stats`` takes its plain path on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nislam_torch.models import FullSlam, KCCRegistration, VisualOdometry
from nislam_tpu import models as jm
from nislam_tpu.core.config import (
    CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig, MapConfig,
    MapStitcherConfig, SlamConfig,
)
from nislam_tpu.utils.synthetic import make_world, render_sequence, square_loop_path, straight_path

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

H, W = 96, 128
POSE_ATOL = 2e-3
PSR_RTOL = 5e-4
CF = CFConfig(width=W, height=H, rotation_divisor=180, rotation_channel=96)


@pytest.fixture(scope="module")
def world():
    return make_world(1024, 3.0)


def _config():
    return SlamConfig(
        cf=CF,
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=0.10, max_angle=0.05, lower_response_thr=4.0, upper_response_thr=6.0,
        ),
        map=MapConfig(grid_scale=0.15, keyframe_capacity=128, edge_capacity=512),
        loop_closure=LoopClosureConfig(
            to_find_loop=True, position_response_thr=8.0, angle_response_thr=8.0,
            frame_gap_thr=30, distance_thr=1.0, max_candidates=8,
        ),
        map_stitcher=MapStitcherConfig(canvas_size=1024),
        camera=CameraConfig(image_width=W, image_height=H, height=1.0,
                            intrinsics=(100.0, W / 2.0, 100.0, H / 2.0)),
    )


def _square(world):
    poses = square_loop_path(side_steps=20, step=5.7, tail=6)
    gt = np.array([(p[0] - 512.0, p[1] - 512.0) for p in poses]) * 0.01
    return render_sequence(world, H, W, poses), gt


@pytest.mark.parametrize("large_rotation", [False, True])
def test_register_matches_jax(world, large_rotation):
    """``register`` and ``register_batch`` on shifted and rotated views:
    pose within 2e-3, PSRs at rtol 5e-4."""
    a = render_sequence(world, H, W, [(512.0, 512.0, 0.0)])[0]
    views = render_sequence(world, H, W, [(522.0, 505.0, 0.0), (515.0, 509.0, 0.2),
                                          (508.0, 514.0, 3.0)])
    model = KCCRegistration(CF, device="cpu")
    jmodel = jm.KCCRegistration(CF)
    pose, resp = model.register(a, views[0], large_rotation=large_rotation)
    jpose, jresp = jmodel.register(jnp.asarray(a), jnp.asarray(views[0]),
                                   large_rotation=large_rotation)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=POSE_ATOL)
    np.testing.assert_allclose(resp.numpy(), np.asarray(jresp), rtol=PSR_RTOL)
    refs = np.stack([a] * len(views))
    poses, resps = model.register_batch(refs, views, large_rotation=large_rotation)
    jposes, jresps = jmodel.register_batch(jnp.asarray(refs), jnp.asarray(views),
                                           large_rotation=large_rotation)
    assert poses.shape == (3, 3)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=POSE_ATOL)
    np.testing.assert_allclose(resps.numpy(), np.asarray(jresps), rtol=PSR_RTOL)
    np.testing.assert_allclose(pose.numpy(), poses[0].numpy(), atol=1e-5)


def test_vo_evaluate_matches_jax(world):
    poses = straight_path(24, step=6.0)
    frames = render_sequence(world, H, W, poses)
    gt = np.array([(p[0] - 512.0, p[1] - 512.0) for p in poses]) * 0.01
    vo = VisualOdometry(_config(), device="cpu")
    assert not vo.engine.config.loop_closure.to_find_loop
    res = vo.evaluate(frames, gt_xy=gt, chunk_frames=16)
    want = jm.VisualOdometry(_config()).evaluate(frames, gt_xy=gt, chunk_frames=16)
    assert (res.frames, res.tracked_frac, res.keyframes) == (want.frames, want.tracked_frac, want.keyframes)
    assert res.tracked_frac == 1.0 and res.fps > 0
    np.testing.assert_allclose(res.trajectory, want.trajectory, atol=POSE_ATOL)
    np.testing.assert_allclose(res.ate_rmse_m, want.ate_rmse_m, atol=POSE_ATOL)
    _, outs = vo.run(frames[:8])
    np.testing.assert_allclose(vo.trajectory(outs), res.trajectory[:8], atol=1e-5)


def test_full_slam_evaluate_matches_jax(world):
    """Loops, mid-run chunk solves and finalize: counts equal, the scored
    keyframe trajectory within 2e-3."""
    frames, gt = _square(world)
    res = FullSlam(_config(), device="cpu").evaluate(frames, gt_xy=gt, chunk_frames=32)
    want = jm.FullSlam(_config()).evaluate(frames, gt_xy=gt, chunk_frames=32)
    for key in ("frames", "tracked_frac", "keyframes", "loops", "solves"):
        assert getattr(res, key) == getattr(want, key), key
    assert res.loops >= 1 and res.solves >= 1
    np.testing.assert_allclose(res.keyframe_trajectory, want.keyframe_trajectory, atol=POSE_ATOL)
    np.testing.assert_allclose(res.ate_rmse_m, want.ate_rmse_m, atol=POSE_ATOL)


def test_full_slam_occupancy_matches_jax(world):
    """``run``, ``keyframe_poses`` and ``occupancy``: the same keyframes,
    and a mosaic with JAX's pixel count and intensity total.  Cell by cell
    the grids agree to 1 %: a pixel on a cell boundary truncates to either
    neighbour under a pose difference of ~1e-6."""
    frames, _ = _square(world)
    slam = FullSlam(_config(), device="cpu")
    jslam = jm.FullSlam(_config())
    state, outs, _ = slam.run(frames)
    jstate, jouts, _ = jslam.run(jnp.asarray(frames))
    np.testing.assert_array_equal(outs.keyframe_slot, np.asarray(jouts.keyframe_slot))
    np.testing.assert_allclose(slam.keyframe_poses(state), jslam.keyframe_poses(jstate), atol=POSE_ATOL)
    canvas, jcanvas = slam.stitch(state), jslam.stitch(jstate)
    assert float(canvas.weight.double().sum()) == float(np.asarray(jcanvas.weight, np.float64).sum()) > 0
    np.testing.assert_allclose(float(canvas.data.double().sum()),
                               float(np.asarray(jcanvas.data, np.float64).sum()), rtol=1e-5)
    grid, origin, res = slam.occupancy(state)
    jgrid, jorigin, jres = jslam.occupancy(jstate)
    assert grid.shape == jgrid.shape == (1024, 1024) and grid.dtype == np.int8
    assert (grid != jgrid).sum() <= 1e-2 * (jgrid >= 0).sum()
    np.testing.assert_allclose(origin, jorigin, atol=1e-5)
    assert res == pytest.approx(jres)
