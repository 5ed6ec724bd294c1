"""The port's host-side copies equal the JAX package's originals.

``nislam_torch`` carries numpy copies of the table functions, the config
dataclasses, the synthetic-sequence generators and the ATE metric, so it
runs without JAX.  Each copy must give bit-equal results.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nislam_torch.core.camera as tcam
import nislam_torch.core.config as tconfig
import nislam_torch.io.trajectory as ttraj
import nislam_torch.ops.fft as tfft
import nislam_torch.ops.registration as treg
import nislam_torch.ops.warp as twarp
import nislam_torch.utils.synthetic as tsyn
import nislam_tpu.core.camera as jcam
import nislam_tpu.core.config as jconfig
import nislam_tpu.io.trajectory as jtraj
import nislam_tpu.ops.fft as jfft
import nislam_tpu.ops.registration as jreg
import nislam_tpu.ops.warp as jwarp
import nislam_tpu.utils.synthetic as jsyn

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)


@pytest.mark.parametrize("fold_dc", [True, False])
@pytest.mark.parametrize("h,w,d,c", [(96, 128, 360, 96), (21, 30, 90, 16)])
def test_polar_tap_constants_bit_equal(h, w, d, c, fold_dc):
    ti, tw = twarp.polar_tap_constants(h, w, d, c, fold_dc=fold_dc)
    ji, jw = jwarp.polar_tap_constants(h, w, d, c, fold_dc=fold_dc)
    assert ti.dtype == ji.dtype and tw.dtype == jw.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("h,w", [(96, 128), (45, 31), (360, 96)])
def test_impulse_spectrum_pair_bit_equal(h, w):
    np.testing.assert_array_equal(
        tfft.impulse_spectrum_pair(h, w), jfft.impulse_spectrum_pair(h, w)
    )


def test_half_polar_psr_affine_equal():
    args = (96, 128, 360, 96, 0, 0.1, 3, 0.2, 0.1)
    assert treg.half_polar_psr_affine(*args) == jreg.half_polar_psr_affine(*args)


@pytest.mark.parametrize("distortion", [(0.0,) * 5, (-0.2, 0.05, 0.001, -0.002, 0.0)])
def test_undistort_maps_bit_equal(distortion):
    cam = jconfig.CameraConfig(
        image_width=64, image_height=48, intrinsics=(50.0, 31.5, 52.0, 24.2),
        distortion=distortion,
    )
    for t, j in zip(tcam._undistort_maps_numpy(cam), jcam._undistort_maps_numpy(cam)):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tcam._undistort_maps(cam), jcam._undistort_maps(cam)):
        np.testing.assert_array_equal(t, j)


def test_config_dataclasses_match():
    names = [
        "DatasetConfig", "CFConfig", "KeyframeSelectionConfig", "MapConfig",
        "LoopClosureConfig", "MapStitcherConfig", "OptimizerConfig",
        "SavingConfig", "CameraConfig", "SlamConfig",
    ]
    for name in names:
        tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
        assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
        assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls()), name
    cf = tconfig.CFConfig(rotation_divisor=361)
    assert cf.polar_shape == jconfig.CFConfig(rotation_divisor=361).polar_shape
    kf = tconfig.KeyframeSelectionConfig(lower_rotation_response_thr=3.0)
    assert (kf.lower_rot, kf.upper_rot) == (3.0, 90.0)
    assert tconfig.derive_response_thresholds(128, 96, 360, 96) == (
        jconfig.derive_response_thresholds(128, 96, 360, 96)
    )


def test_synthetic_generators_equal():
    np.testing.assert_array_equal(tsyn.make_world(128, 3.0, seed=5), jsyn.make_world(128, 3.0, seed=5))
    path = tsyn.heading_loop_path(40, step=4.0, start=(64.0, 64.0), tail=5)
    assert path == jsyn.heading_loop_path(40, step=4.0, start=(64.0, 64.0), tail=5)
    world = jsyn.make_world(128, 3.0, seed=5)
    seq = tsyn.render_sequence(world, 24, 32, path[:6])
    np.testing.assert_array_equal(seq, jsyn.render_sequence(world, 24, 32, path[:6]))
    np.testing.assert_array_equal(tsyn.add_sensor_noise(seq), jsyn.add_sensor_noise(seq))
    for kw in (dict(), dict(side_steps=7, step=3.5, start=(9.0, 4.0), tail=2, yaw_rate=0.1)):
        assert tsyn.square_loop_path(**kw) == jsyn.square_loop_path(**kw)
    assert tsyn.straight_path(9, step=2.5, start=(3.0, 1.0)) == jsyn.straight_path(9, step=2.5, start=(3.0, 1.0))


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rmse_equal(rng, with_scale):
    t = np.arange(30) / 30.0
    est = rng.standard_normal((30, 2))
    gt = est @ np.array([[0.8, -0.6], [0.6, 0.8]]) + 0.01 * rng.standard_normal((30, 2))
    assert ttraj.ate_rmse(t, est, t + 0.001, gt, with_scale=with_scale) == jtraj.ate_rmse(
        t, est, t + 0.001, gt, with_scale=with_scale
    )


def test_port_imports_neither_jax_nor_the_jax_package():
    import os
    import subprocess
    import sys

    # Every module of the package, found by walking it, and chip_smoke.
    code = (
        "import importlib, pkgutil, sys, chip_smoke, nislam_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(nislam_torch.__path__, 'nislam_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'nislam_torch.__main__', 'nislam_torch.parallel.batch', 'nislam_torch.models.slam',\n"
        "        'nislam_torch.scripts.pkbench', 'nislam_torch.ops.sum_only', 'nislam_torch.parallel.mesh',\n"
        "        'nislam_torch.parallel.solver', 'nislam_torch.parallel.loop_search',\n"
        "        'nislam_torch.parallel.engine', 'nislam_torch.parallel.fleet',\n"
        "        'nislam_torch.utils.scaling', 'nislam_torch.ops.scatter_add',\n"
        "        'nislam_torch.scripts.stepbench', 'nislam_torch.utils.profiling',\n"
        "        'nislam_torch.scripts.bench', 'nislam_torch.scripts.stagebench',\n"
        "        'nislam_torch.scripts.traceparse', 'nislam_torch.scripts.hdprofile',\n"
        "        'nislam_torch.scripts.hdbench', 'nislam_torch.scripts.opbench',\n"
        "        'nislam_torch.scripts.polarbench', 'nislam_torch.scripts.psrcal',\n"
        "        'nislam_torch.scripts.rotstudy'} <= set(names), names\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # importing starts no process group\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nislam_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
