"""The stitcher's sort-free rasterisation (``ops/stitch_raster.py``) and the
scatter-add's run table, on the CPU; the kernels on the card.

The CUDA kernel ``csrc/stitch_raster.cu`` rests on two facts that are
checked here with its plain version's own arithmetic: every two pixels
that reach one canvas cell lie within 2 rows and 2 columns (the window
premise), and letting the first pixel of a cell in its 5×5 window sum
the window's pixels of that cell in flat order gives the bits of the
sequential scatter (the ownership rule, emulated in numpy).  Frames of a
batch are launched one after another, which must equal one flat scatter
of the batch.  Every comparison is bit for bit.  The cases marked ``gpu``
run both kernels on the card against their plain versions on CPU copies
of the same inputs, and skip without a CUDA device.
"""

import math

import numpy as np
import pytest
import torch

import nislam_torch.core.camera as tcam
import nislam_torch.core.stitcher as tst
from nislam_torch.core.config import CameraConfig, MapStitcherConfig
from nislam_torch.core.se2 import rotation2d
from nislam_torch.ops import scatter_add as tsa
from nislam_torch.ops import stitch_raster as tsr

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

H, W = 48, 64
CAMERA = CameraConfig(image_width=W, image_height=H, height=1.0, intrinsics=(60.0, 31.0, 62.0, 24.5))
# Before: the 12 pixels of a 5×5 window ahead of its centre in flat order;
# after: the 12 behind it, in flat order.
BEFORE = [(dj, di) for dj in (-2, -1) for di in range(-2, 3)] + [(0, -2), (0, -1)]
AFTER = [(0, 1), (0, 2)] + [(dj, di) for dj in (1, 2) for di in range(-2, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def consts_of(theta: float, px: float, py: float) -> torch.Tensor:
    """Frame constants straight from an image-plane pose."""
    r = rotation2d(torch.tensor(theta, dtype=torch.float32))
    return torch.cat([r.flatten(), torch.tensor([px, py], dtype=torch.float32)])


def premise_poses(rng) -> list:
    """Image-plane poses: the axes, 45° and its multiples, frames centred
    near the origin (straddling x = 0 and y = 0, where cells are two
    pixels wide), and random ones."""
    poses = [(a, px, py) for a in (0.0, math.pi / 4, math.pi / 2, 3 * math.pi / 4, -math.pi / 4, math.pi)
             for px, py in ((0.0, 0.0), (0.5, -0.5), (0.999, 0.001), (-1.0, 1.0), (37.25, -12.75))]
    poses += [(float(a), float(x), float(y)) for a, x, y in
              zip(rng.uniform(-math.pi, math.pi, 40), rng.uniform(-3, 3, 40), rng.uniform(-3, 3, 40))]
    return poses


def test_frame_targets_keep_their_arithmetic(rng):
    """``_frame_targets`` (through the frame constants) equals the
    arithmetic it had before the constants were split out, bit for bit."""
    camera = tcam.make_camera_ops(CAMERA)
    poses = torch.from_numpy((rng.standard_normal((6, 3)) * [0.6, 0.6, 2.0]).astype(np.float32))
    image_pose = camera.principal_to_center(camera.robot_to_image_plane(poses))
    r = rotation2d(image_pose[..., 2])[..., None, None, :, :]
    iw = torch.arange(W, dtype=torch.float32) - W / 2.0
    ih = torch.arange(H, dtype=torch.float32)[:, None] - H / 2.0
    x = r[..., 0, 0] * iw + r[..., 0, 1] * ih + image_pose[..., 0, None, None]
    y = r[..., 1, 0] * iw + r[..., 1, 1] * ih + image_pose[..., 1, None, None]
    xi, yi = tst._frame_targets((H, W), poses, camera)
    assert torch.equal(xi, torch.trunc(x).to(torch.int32)) and torch.equal(yi, torch.trunc(y).to(torch.int32))


def cell_spans(cells: np.ndarray):
    """Per distinct cell of an (H, W) array of cells: the spread of its
    pixels' rows and columns (max − min)."""
    flat = cells.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rows, cols = np.divmod(order, cells.shape[1])
    starts = np.flatnonzero(np.r_[True, flat[order][1:] != flat[order][:-1]])
    return (np.maximum.reduceat(rows, starts) - np.minimum.reduceat(rows, starts),
            np.maximum.reduceat(cols, starts) - np.minimum.reduceat(cols, starts))


@pytest.mark.parametrize("size", [(H, W), (W, H), (31, 45)])
def test_window_premise(rng, size):
    """Every two pixels that reach one cell lie within 2 rows and 2
    columns, at every pose; cells of two pixels or more do occur."""
    h, w = size
    most = 0
    for theta, px, py in premise_poses(rng):
        xi, yi = tsr.image_targets(consts_of(theta, px, py), (h, w))
        cells = yi.numpy().astype(np.int64) * (1 << 20) + xi.numpy()
        dr, dc = cell_spans(cells)
        assert dr.max() <= 2 and dc.max() <= 2, (theta, px, py)
        most = max(most, int(dr.max()), int(dc.max()))
    assert most == 2


def owner_raster(data: np.ndarray, weight: np.ndarray, cells: np.ndarray, ok: np.ndarray,
                 values: np.ndarray, wsign: np.float32) -> None:
    """The kernel's ownership rule in numpy, in place: a pixel on the
    canvas owns its cell when no pixel before it in its 5×5 window reaches
    the same cell; the owner adds its window's pixels of that cell in flat
    order (float32, one rounding per add) to the cell's value."""
    h, w = cells.shape
    c = np.pad(np.where(ok, cells, -1), 2, constant_values=-1)
    v = np.pad(values, 2)
    at = lambda dj, di: (c[2 + dj:2 + dj + h, 2 + di:2 + di + w], v[2 + dj:2 + dj + h, 2 + di:2 + di + w])
    own = ok.copy()
    for dj, di in BEFORE:
        own &= at(dj, di)[0] != cells
    key = cells[own]
    d = data.reshape(-1)[key] + values[own]
    wt = weight.reshape(-1)[key] + wsign
    for dj, di in AFTER:
        nc, nv = at(dj, di)
        hit = nc[own] == key
        d = np.where(hit, d + nv[own], d)
        wt = np.where(hit, wt + wsign, wt)
    assert len(np.unique(key)) == len(key)  # one owner per cell
    data.reshape(-1)[key] = d
    weight.reshape(-1)[key] = wt


CANVAS = MapStitcherConfig(canvas_size=192, canvas_center=(4, -3))


@pytest.mark.parametrize("case", ["inserts", "disabled", "negated", "off the canvas", "straddling the origin"])
def test_ownership_rule_equals_the_sequential_scatter(rng, case):
    """The numpy emulation of the kernel's rule leaves both canvases with
    the bits of the plain version's two ``index_add_``, frame after frame,
    from canvases that already hold earlier frames."""
    camera = tcam.make_camera_ops(CAMERA)
    cfg = MapStitcherConfig(canvas_size=96, canvas_center=(4, -3)) if case == "off the canvas" else CANVAS
    s, center = cfg.canvas_size, cfg.canvas_center
    want = tst.make_canvas(cfg, torch.device("cpu"))
    data, weight = want.data.numpy().copy(), want.weight.numpy().copy()
    spread = {"off the canvas": 1.6, "straddling the origin": 0.0}.get(case, 0.3)
    masked = 0
    for f in range(6):
        theta = float(rng.uniform(-math.pi, math.pi)) if f != 2 else math.pi / 4
        if case == "straddling the origin":
            k = consts_of(theta, *rng.uniform(-1.0, 1.0, 2))
        else:
            pose = torch.from_numpy((np.r_[rng.standard_normal(2) * spread, theta]).astype(np.float32))
            k = tst._frame_constants(pose, camera)
        img = torch.from_numpy(rng.random((H, W)).astype(np.float32))
        enabled = not (case == "disabled" and f % 2 == 1)
        sign = -1.0 if case == "negated" and f >= 3 else 1.0
        tsr.stitch_raster(want.data, want.weight, img, k, enabled, sign * 100.0, sign, center)
        idx, ok = tsr.frame_cells(k, (H, W), s, center, enabled)
        values = (img * (sign * 100.0)).numpy()
        owner_raster(data, weight, idx.numpy(), ok.numpy(), values, np.float32(sign))
        masked += int((~ok).sum())
        assert bits_equal(torch.from_numpy(data), want.data) and bits_equal(torch.from_numpy(weight), want.weight)
    touched = int((want.weight != 0).sum())
    assert 0 < touched < s * s
    assert (masked > 0) == (case in ("disabled", "off the canvas"))


def test_frames_one_after_another_equal_one_flat_batch(rng):
    """Per-frame rasterisation, frame-major, equals one flat scatter of
    the batch (what a recompute batch computed before) bit for bit."""
    camera = tcam.make_camera_ops(CAMERA)
    imgs = torch.from_numpy(rng.random((5, H, W)).astype(np.float32))
    poses = torch.from_numpy((rng.standard_normal((5, 3)) * [0.2, 0.2, 2.0]).astype(np.float32))
    k = tst._frame_constants(poses, camera)
    one, each = tst.make_canvas(CANVAS, torch.device("cpu")), tst.make_canvas(CANVAS, torch.device("cpu"))
    tsr.stitch_raster_reference(one.data, one.weight, imgs, k, True, 100.0, 1.0, CANVAS.canvas_center)
    for f in range(5):
        tsr.stitch_raster_reference(each.data, each.weight, imgs[f], k[f], True, 100.0, 1.0, CANVAS.canvas_center)
    assert bits_equal(one.data, each.data) and bits_equal(one.weight, each.weight)
    assert float(one.weight.max()) >= 5  # the frames overlap


def test_stitch_raster_routing():
    data, weight = torch.zeros(8, 8), torch.zeros(8, 8)
    img, k = torch.ones(4, 4), consts_of(0.0, 0.0, 0.0)
    before = tsr.stitch_raster.launches
    tsr.stitch_raster(data, weight, img, k, True, 100.0, 1.0, (0, 0))
    assert tsr.stitch_raster.launches == before and float(weight.sum()) == 16.0
    with pytest.raises(ValueError, match="CUDA"):
        tsr.stitch_raster(data, weight, img, k, True, 100.0, 1.0, (0, 0), force="kernel")
    with pytest.raises(ValueError):
        tsr.stitch_raster(data, weight, img, k, True, 100.0, 1.0, (0, 0), force="atomics")


def loop_runs(sorted_keys: np.ndarray):
    """Runs of equal keys, one position at a time: (starts, lengths, rows)."""
    starts, lengths, rows = [], [], []
    for i, key in enumerate(sorted_keys):
        if i == 0 or key != sorted_keys[i - 1]:
            starts.append(i)
            lengths.append(0)
            rows.append(key)
        lengths[-1] += 1
    return np.array(starts, np.int64), np.array(lengths, np.int64), np.array(rows, np.int64)


@pytest.mark.parametrize("keys", ["ragged", "one run", "distinct", "single", "empty", "runs of 33"])
def test_run_table(rng, keys):
    """Heads, starts, lengths and rows of the plan's run table against a
    loop."""
    k = {"ragged": rng.integers(0, 40, 300), "one run": np.full(100, 7), "distinct": rng.permutation(64),
         "single": np.array([5]), "empty": np.zeros(0, np.int64), "runs of 33": np.repeat(np.arange(9), 33)}[keys]
    sk = np.sort(k, kind="stable")
    run_end = tsa.run_table(torch.from_numpy(sk).long()).numpy()
    starts, lengths, rows = loop_runs(sk)
    assert run_end.shape == sk.shape
    heads = np.flatnonzero(run_end)
    np.testing.assert_array_equal(heads, starts)
    np.testing.assert_array_equal(run_end[heads] - heads, lengths)
    np.testing.assert_array_equal(sk[heads], rows)


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------


def card_cases(dev, rng):
    """(label, canvas config, images (..., H, W), poses (..., 3), enabled,
    sign) on the card."""
    s = MapStitcherConfig(canvas_size=512, canvas_center=(10, -20))
    imgs = lambda *shape: torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
    pose = lambda *p: torch.tensor(p, dtype=torch.float32, device=dev)
    yield "insert", s, imgs(H, W), pose(0.31, -0.17, 0.6), True, 1.0
    yield "disabled", s, imgs(H, W), pose(0.31, -0.17, 0.6), torch.tensor(False, device=dev), -1.0
    yield "negated", s, imgs(H, W), pose(-0.2, 0.4, 2.5), torch.tensor(True, device=dev), -1.0
    yield "straddling the origin", s, imgs(H, W), pose(0.0, 0.0, math.pi / 4), True, 1.0
    yield "off the canvas", MapStitcherConfig(canvas_size=64), imgs(H, W), pose(0.5, 0.3, 1.0), True, 1.0
    yield "batch of 5", s, imgs(5, H, W), torch.from_numpy(
        (rng.standard_normal((5, 3)) * [0.2, 0.2, 2.0]).astype(np.float32)).to(dev), True, 1.0


@pytest.mark.gpu
def test_stitch_kernel_matches_plain_version_bit_for_bit(cuda):
    """Each case on a canvas that already holds a frame: the kernel against
    the plain version on CPU copies of the card's constants, bit for bit,
    one launch per frame, and the same bits on a second run."""
    rng = np.random.default_rng(11)  # no conftest on the card
    camera = tcam.make_camera_ops(CAMERA).to(cuda)
    for label, cfg, images, poses, enabled, sign in card_cases(cuda, rng):
        base = tst.make_canvas(cfg, cuda)
        tst.insert_frame(base, images.reshape(-1, H, W)[0], poses.reshape(-1, 3)[0], camera)
        k = tst._frame_constants(poses, camera)
        en = enabled.cpu() if isinstance(enabled, torch.Tensor) else enabled
        want = (base.data.cpu(), base.weight.cpu())
        tsr.stitch_raster_reference(*want, images.cpu(), k.cpu(), en, sign * 100.0, sign, cfg.canvas_center)
        got = []
        for _ in range(2):
            canvas = tst.StitchCanvas(base.data.clone(), base.weight.clone(), base.center_x, base.center_y)
            before = tsr.stitch_raster.launches
            tst._scatter(canvas, images, poses, camera, enabled, sign)
            assert tsr.stitch_raster.launches == before + images.numel() // (H * W), label
            got.append(canvas)
        torch.cuda.synchronize()
        assert bits_equal(got[0].data.cpu(), want[0]) and bits_equal(got[0].weight.cpu(), want[1]), label
        assert bits_equal(got[0].data, got[1].data) and bits_equal(got[0].weight, got[1].weight), label


@pytest.mark.gpu
def test_stitch_kernel_refuses_what_it_does_not_take(cuda):
    k = consts_of(0.0, 0.0, 0.0).to(cuda)
    img = torch.ones(4, 4, device=cuda)
    with pytest.raises(ValueError):
        tsr.stitch_raster(torch.zeros(8, 6, device=cuda), torch.zeros(8, 6, device=cuda), img, k, True, 1.0, 1.0,
                          (0, 0))
    with pytest.raises(TypeError):
        tsr.stitch_raster(torch.zeros(8, 8, device=cuda), torch.zeros(8, 8, device=cuda), img.double(), k, True,
                          1.0, 1.0, (0, 0))
    with pytest.raises(ValueError, match="2\\^16"):
        tsr.stitch_raster(torch.zeros(8, 8, device=cuda), torch.zeros(8, 8, device=cuda), img, k, True, 1.0, 1.0,
                          (70000, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1, 31, 32, 33, 1000, 100_000])
@pytest.mark.parametrize("c", [None, 3, 9])
def test_scatter_kernel_runs_of_every_length(cuda, length, c):
    """Runs of one length (shuffled keys) against the plain version on the
    CPU, bit for bit; values of mixed magnitudes, so the order shows."""
    rng = np.random.default_rng(length)
    n = max(length, 3000) // length * length
    rows = n // length
    keys = rng.permutation(np.repeat(rng.permutation(2 * rows)[:rows], length))
    shape = (2 * rows,) if c is None else (2 * rows, c)
    out = rng.standard_normal(shape).astype(np.float32)
    src = (rng.standard_normal((n,) + shape[1:]) * 10.0 ** rng.integers(-3, 4, (n,) + shape[1:])).astype(np.float32)
    want = tsa.index_add_reference(torch.from_numpy(out.copy()), torch.from_numpy(keys), torch.from_numpy(src))
    plan = tsa.ScatterPlan.of(torch.from_numpy(keys).to(cuda))
    got = tsa.index_add_ordered(torch.from_numpy(out.copy()).to(cuda), plan, torch.from_numpy(src).to(cuda))
    tsa.raise_on_bad_keys(cuda)
    assert bits_equal(got.cpu(), want)
