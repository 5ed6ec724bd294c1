"""The port's occupancy stitcher against ``nislam_tpu.core.stitcher``, on the CPU.

The same frames and poses (numpy, from a seed) go through both packages.
Weights hold small integers and compare exactly; ``data`` sums the same
intensities, in another order on the card, so it compares at rtol 1e-5;
the int8 occupancy compares exactly on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nislam_torch.core.camera as tcam
import nislam_torch.core.map_store as tms
import nislam_torch.core.stitcher as tst
import nislam_tpu.core.camera as jcam
import nislam_tpu.core.map_store as jms
import nislam_tpu.core.stitcher as jst
from nislam_tpu.core.config import CameraConfig, CFConfig, MapConfig, MapStitcherConfig

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

CPU = torch.device("cpu")
H, W = 48, 64
CAMERA = CameraConfig(image_width=W, image_height=H, height=1.0, intrinsics=(60.0, 31.0, 62.0, 24.5))
# A small canvas, off-centre, so that some frames land partly outside it.
STITCH = MapStitcherConfig(canvas_size=192, canvas_center=(20, -10))


@pytest.fixture(scope="module")
def cameras():
    return tcam.make_camera_ops(CAMERA), jcam.make_camera_ops(CAMERA)


def _frames(rng, n):
    imgs = rng.random((n, H, W)).astype(np.float32)
    poses = (rng.standard_normal((n, 3)) * [0.6, 0.6, 2.0]).astype(np.float32)
    return imgs, poses


def assert_canvas_equal(t, j):
    np.testing.assert_array_equal(t.weight.numpy(), np.asarray(j.weight))
    np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        tst.occupancy_grid(t).numpy(), np.asarray(jst.occupancy_grid(j))
    )


def test_insert_frame_matches(rng, cameras):
    """Inserts (one masked off, one negated) accumulate like JAX's
    scatter: repeated cells add up, out-of-canvas pixels weigh nothing."""
    tc, jc = tst.make_canvas(STITCH, CPU), jst.make_canvas(STITCH)
    assert (tc.size, tc.center_x, tc.center_y) == (jc.size, jc.center_x, jc.center_y)
    imgs, poses = _frames(rng, 6)
    ops = [dict(), dict(), dict(enabled=False), dict(), dict(sign=-1.0), dict()]
    for img, pose, kw in zip(imgs, poses, ops):
        tc = tst.insert_frame(tc, torch.from_numpy(img), torch.from_numpy(pose), cameras[0], **kw)
        jc = jst.insert_frame(jc, jnp.asarray(img), jnp.asarray(pose), cameras[1], **kw)
    assert_canvas_equal(tc, jc)
    w = tc.weight.numpy()
    assert w.max() >= 2 and w.min() < 0  # overlaps, and the negated frame
    assert 0 < (w != 0).sum() < 5 * H * W  # partly outside the canvas


def test_device_mask_and_negated_scatter_cancel(rng, cameras):
    """``enabled`` as a device bool, and insert followed by the negated
    insert restores the canvas (weights exactly)."""
    tc = tst.make_canvas(STITCH, CPU)
    imgs, poses = _frames(rng, 2)
    tst.insert_frame(tc, torch.from_numpy(imgs[0]), torch.from_numpy(poses[0]), cameras[0])
    before = (tc.data.clone(), tc.weight.clone())
    img, pose = torch.from_numpy(imgs[1]), torch.from_numpy(poses[1])
    tst.insert_frame(tc, img, pose, cameras[0], enabled=torch.tensor(False))
    assert torch.equal(tc.weight, before[1]) and torch.equal(tc.data, before[0])
    tst.insert_frame(tc, img, pose, cameras[0], enabled=torch.tensor(True))
    assert not torch.equal(tc.weight, before[1])
    tst.insert_frame(tc, img, pose, cameras[0], sign=-1.0)
    assert torch.equal(tc.weight, before[1])
    torch.testing.assert_close(tc.data, before[0], rtol=0, atol=1e-3)


@pytest.mark.parametrize("count", [0, 5, 20])
def test_recompute_matches(rng, cameras, count):
    """``recompute`` over a bank of ``count`` live keyframes (more than
    one rasterization batch at 20) equals JAX's."""
    cf = CFConfig(width=W, height=H, rotation_divisor=20, rotation_channel=8)
    mc = MapConfig(keyframe_capacity=24, edge_capacity=4)
    imgs, poses = _frames(rng, 24)
    tb = tms.make_keyframe_bank(cf, mc, CPU)
    tb.images.copy_(torch.from_numpy(imgs))
    tb.poses.copy_(torch.from_numpy(poses))
    tb.count.fill_(count)
    jb = dataclasses.replace(
        jms.make_keyframe_bank(cf, mc), images=jnp.asarray(imgs), poses=jnp.asarray(poses),
        count=jnp.int32(count),
    )
    tc = tst.make_canvas(STITCH, CPU)
    tst.insert_frame(tc, torch.from_numpy(imgs[0]), torch.from_numpy(poses[0]), cameras[0])
    tc = tst.recompute(tc, tb, cameras[0])  # zeroes the canvas first
    jc = jst.recompute(jst.make_canvas(STITCH), jb, cameras[1])
    assert_canvas_equal(tc, jc)
    assert (tc.weight.sum() > 0) == (count > 0)


def test_recompute_needs_stored_images(cameras):
    cf = CFConfig(width=W, height=H, rotation_divisor=20, rotation_channel=8)
    bank = tms.make_keyframe_bank(cf, MapConfig(keyframe_capacity=4, store_images=False), CPU)
    with pytest.raises(ValueError, match="store_images"):
        tst.recompute(tst.make_canvas(STITCH, CPU), bank, cameras[0])


def test_occupancy_grid_levels_and_geometry(cameras):
    """``100 − mean`` clipped to 0…100, −1 where unseen; the canvas origin
    and pixel size match JAX."""
    data = np.array([[0.0, 250.0, 55.5], [310.0, -5.0, 0.0]], np.float32)
    weight = np.array([[0.0, 3.0, 1.0], [3.0, 1.0, 0.5]], np.float32)
    t = tst.StitchCanvas(data=torch.from_numpy(data), weight=torch.from_numpy(weight))
    j = jst.StitchCanvas(data=jnp.asarray(data), weight=jnp.asarray(weight))
    got = tst.occupancy_grid(t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jst.occupancy_grid(j)))
    np.testing.assert_array_equal(got, [[-1, 16, 44], [0, 100, -1]])
    tc, jc = tst.make_canvas(STITCH, CPU), jst.make_canvas(STITCH)
    np.testing.assert_allclose(
        tst.occupancy_origin(cameras[0], tc).numpy(),
        np.asarray(jst.occupancy_origin(cameras[1], jc)), rtol=1e-6,
    )
    assert float(tst.map_resolution(cameras[0])) == pytest.approx(
        float(jst.map_resolution(cameras[1])), rel=1e-6
    )
