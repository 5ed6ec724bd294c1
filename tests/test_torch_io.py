"""The port's I/O, config loading and calibration against the JAX package, on the CPU.

- ``load_config`` equal field for field to JAX's on every file of
  ``configs/`` and on a generated config with its camera file;
- datasets, ``pack`` and the NISF reader byte-equal to JAX's;
- TUM trajectory files byte-equal;
- checkpoints: a JAX-written state resumes in the torch engine and the
  continuation matches JAX's (decisions exactly, poses atol 2e-3), and the
  other way round, bf16 bank and online canvas included;
- ``calibrate_thresholds`` within one rounding step (0.01) plus rtol 1e-3
  of JAX's: its inputs are PSRs, which agree to 5e-4 (test_torch_ops.py).
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nislam_torch.core.calibrate as tcal
import nislam_torch.core.config as tconfig
import nislam_torch.io.checkpoint as tck
import nislam_torch.io.dataset as tds
import nislam_torch.io.native_loader as tnl
import nislam_torch.io.trajectory as ttraj
import nislam_tpu.core.calibrate as jcal
import nislam_tpu.core.config as jconfig
import nislam_tpu.io.checkpoint as jck
import nislam_tpu.io.dataset as jds
import nislam_tpu.io.native_loader as jnl
import nislam_tpu.io.trajectory as jtraj
from nislam_torch.core.slam import make_engine
from nislam_torch.io.synth_dataset import generate_synthetic_dataset
from nislam_tpu.core.slam import chunked_deferred_drive
from nislam_tpu.core.slam import make_engine as make_jax_engine
from nislam_tpu.utils.synthetic import heading_loop_path, make_world, render_sequence

from test_torch_engine import _assert_outputs_match, _golden_config

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

CPU = torch.device("cpu")
CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))


# --- config ---------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches(path):
    t = tconfig.load_config(path, load_camera=False)
    j = jconfig.load_config(path, load_camera=False)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    """A 10-frame 24×32 dataset in the reference layout, with its config."""
    root = str(tmp_path_factory.mktemp("ds"))
    cfg = generate_synthetic_dataset(root, n_frames=10, height=24, width=32, path_kind="loop",
                                     noise=True)
    return root, cfg


def test_load_config_with_camera_and_spellings(small_dataset, tmp_path):
    """The camera file is read; the stitcher block under either spelling;
    unknown keys are ignored; a bad ``polar_taps`` is refused."""
    _, cfg = small_dataset
    t, j = tconfig.load_config(cfg), jconfig.load_config(cfg)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.camera.image_width == 32 and t.map_stitcher.canvas_size % 1024 == 0
    with open(cfg) as f:
        text = f.read()
    other = tmp_path / "c.yaml"
    other.write_text(text.replace("map_sticther:", "map_stitcher:") + "unknown_block:\n  x: 1\n")
    assert tconfig.load_config(str(other)) == t
    bad = tmp_path / "bad.yaml"
    bad.write_text(text.replace("rotation_divisor", "polar_taps: bogus\n  rotation_divisor"))
    with pytest.raises(ValueError, match="polar_taps"):
        tconfig.load_config(str(bad))
    cam = os.path.join(os.path.dirname(cfg), "camera.yaml")
    assert dataclasses.asdict(tconfig.load_camera_config(cam)) == dataclasses.asdict(
        jconfig.load_camera_config(cam))


# --- datasets, NISF, trajectories ------------------------------------------


def test_datasets_match(small_dataset, tmp_path):
    root, _ = small_dataset
    t, j = tds.open_dataset(root), jds.open_dataset(root)
    assert isinstance(t, tds.ImageFolderDataset) and len(t) == len(j) == 10
    for raw in (False, True):
        for (ta, tt), (ja, jt) in zip(t.chunks(4, raw=raw), j.chunks(4, raw=raw)):
            assert ta.dtype == ja.dtype
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tt, jt)
    # The TUM layout over the same images, and a dataset without times.
    with open(os.path.join(root, "image_names.txt")) as f:
        names = f.read().split()
    tum = tmp_path / "tum"
    tum.mkdir()
    (tum / "rgb.txt").write_text("# comment\n" + "".join(
        f"{0.5 * i} {os.path.join(root, 'rgb', n)}\n" for i, n in enumerate(names)))
    a, b = tds.open_dataset(str(tum)), jds.open_dataset(str(tum))
    assert isinstance(a, tds.TumRgbdDataset)
    for i in (0, 9):
        for x, y in zip(a.get(i), b.get(i)):
            np.testing.assert_array_equal(x, y)
    frames = np.random.default_rng(0).random((3, 5, 6)).astype(np.float32)
    s = tds.SyntheticDataset(frames, rate_hz=10.0)
    assert [x[1] for x in s] == [x[1] for x in jds.SyntheticDataset(frames, rate_hz=10.0)]
    with pytest.raises(FileNotFoundError):
        tds.open_dataset(str(tmp_path))


@pytest.fixture(scope="module")
def packed(small_dataset, tmp_path_factory):
    """Each package's NISF files: v2 (u8, from the PNGs) and v1 (f32)."""
    root, _ = small_dataset
    out = tmp_path_factory.mktemp("nisf")
    frames = np.random.default_rng(1).random((11, 6, 7)).astype(np.float32)
    files = {}
    for name, mod in (("torch", tds), ("jax", jds)):
        files[name, 2] = mod.open_dataset(root).pack(str(out / f"{name}_v2.nisf"))
        files[name, 1] = mod.SyntheticDataset(frames, rate_hz=7.0).pack(str(out / f"{name}_v1.nisf"))
    return files


@pytest.mark.parametrize("version", [1, 2])
def test_pack_and_nisf_reader_match(packed, version):
    """``pack`` writes the same bytes; the reader's chunks, timestamps and
    single frames are byte-equal to the JAX reader's (the C++ library)."""
    path = packed["torch", version]
    with open(path, "rb") as f, open(packed["jax", version], "rb") as g:
        assert f.read() == g.read()
    if not jnl.NativeChunkReader.available():
        pytest.skip("the JAX package's native reader did not build")
    for chunk, threads in ((4, 0), (3, 2), (64, 1)):
        t = tnl.NativeChunkReader(path, chunk, threads=threads, ring=2)
        j = jnl.NativeChunkReader(path, chunk, threads=1, ring=2)
        assert (len(t), t.height, t.width, t.dtype) == (len(j), j.height, j.width, j.dtype)
        got, want = list(t), list(j)
        assert [len(x[0]) for x in got] == [len(x[0]) for x in want]
        for (ta, tt), (ja, jt) in zip(got, want):
            assert ta.dtype == ja.dtype and ta.tobytes() == ja.tobytes()
            assert tt.tobytes() == jt.tobytes()
        assert t.timestamps().tobytes() == j.timestamps().tobytes()
        for i in (0, len(t) - 1):
            assert t.frame(i).tobytes() == j.frame(i).tobytes()
        with pytest.raises(IndexError):
            t.frame(len(t))
        t.close()
        j.close()


def test_nisf_reader_refuses_bad_files(tmp_path):
    assert tnl.NativeChunkReader.available()
    with pytest.raises(FileNotFoundError):
        tnl.NativeChunkReader(str(tmp_path / "missing.nisf"), 4)
    bad = tmp_path / "bad.nisf"
    bad.write_bytes(b"NOPE" + bytes(16))
    with pytest.raises(ValueError):
        tnl.NativeChunkReader(str(bad), 4)


def test_tum_files_match(rng, tmp_path):
    times = np.arange(7) / 30.0
    poses = rng.standard_normal((7, 3)) * [2.0, 2.0, 3.0]
    a = ttraj.write_tum(str(tmp_path / "t.txt"), times, poses)
    b = jtraj.write_tum(str(tmp_path / "j.txt"), times, poses)
    with open(a) as f, open(b) as g:
        assert f.read() == g.read()
    for x, y in zip(ttraj.read_tum(a), jtraj.read_tum(a)):
        np.testing.assert_array_equal(x, y)
    assert ttraj.pose2d_to_tum_line(1.5, poses[0]) == jtraj.pose2d_to_tum_line(1.5, poses[0])


# --- checkpoints -------------------------------------------------------------


def _variant(name):
    config = _golden_config()
    if name == "bf16_online":
        config = dataclasses.replace(
            config,
            map=dataclasses.replace(config.map, bank_dtype="bf16"),
            map_stitcher=dataclasses.replace(config.map_stitcher, online=True, canvas_size=512),
        )
    return config


@pytest.fixture(scope="module")
def golden_frames():
    world = make_world(1024, 3.0, seed=1234)
    return render_sequence(world, 96, 128, heading_loop_path(100, step=5.5, tail=10))


@pytest.mark.parametrize("variant", ["f32", "bf16_online"])
def test_checkpoint_resumes_across_engines(golden_frames, tmp_path, variant):
    """JAX saves after 32 frames, the torch engine resumes and runs frames
    32–64 as JAX does; then the torch engine saves, JAX resumes and runs
    frames 64–96 as the torch engine does."""
    config = _variant(variant)
    frames = golden_frames
    je, te = make_jax_engine(config), make_engine(config, CPU)
    js, _ = chunked_deferred_drive(je, je.init_state(), jnp.asarray(frames[:32]), chunk_frames=32)
    jpath = jck.save_state(str(tmp_path / "jax.npz"), js)
    ts = tck.load_state(jpath, te.init_state())
    assert int(ts.bank.count) == int(js.bank.count)
    assert ts.bank.fft.dtype == (torch.bfloat16 if variant == "bf16_online" else torch.float32)
    js, jo = chunked_deferred_drive(je, js, jnp.asarray(frames[32:64]), chunk_frames=32)
    ts, to = te.run_sequence(ts, frames[32:64], chunk_frames=32)
    _assert_outputs_match(to, jo)

    tpath = tck.save_state(str(tmp_path / "torch.npz"), ts)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert list(a["paths"]) == list(b["paths"]) and list(a["dtypes"]) == list(b["dtypes"])
    js = jck.load_state(tpath, je.init_state())
    js, jo = chunked_deferred_drive(je, js, jnp.asarray(frames[64:96]), chunk_frames=32)
    ts, to = te.run_sequence(ts, frames[64:96], chunk_frames=32)
    _assert_outputs_match(to, jo)
    np.testing.assert_allclose(ts.bank.poses.numpy(), np.asarray(js.bank.poses), atol=2e-3)
    if variant == "bf16_online":
        assert ts.canvas.weight.sum() > 0
        assert abs(float(ts.canvas.weight.sum()) - float(np.asarray(js.canvas.weight).sum())) < 1.0


def test_checkpoint_refuses_another_config(tmp_path):
    te = make_engine(_golden_config(), CPU)
    path = tck.save_state(str(tmp_path / "s.npz"), te.init_state())
    with np.load(path) as data:
        leaves = dict(data)
    leaves["paths"] = np.asarray([".bank.images"] + list(leaves["paths"][1:]))
    np.savez(str(tmp_path / "renamed.npz"), **leaves)
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.load_state(str(tmp_path / "renamed.npz"), te.init_state())
    small = _golden_config()
    small = dataclasses.replace(small, map=dataclasses.replace(small.map, keyframe_capacity=64))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, make_engine(small, CPU).init_state())
    bf16 = _golden_config()
    bf16 = dataclasses.replace(bf16, map=dataclasses.replace(bf16.map, bank_dtype="bf16"))
    with pytest.raises(ValueError, match="dtype"):
        tck.load_state(path, make_engine(bf16, CPU).init_state())


# --- calibration ---------------------------------------------------------------


def test_calibrate_thresholds_match(golden_frames):
    config = _golden_config()
    probe = (golden_frames[:12] * 255).astype(np.uint8)
    tthr, tdiag = tcal.calibrate_thresholds(config, probe, CPU)
    jthr, jdiag = jcal.calibrate_thresholds(config, probe)
    assert tthr.keys() == jthr.keys()
    for k in tthr:
        assert abs(tthr[k] - jthr[k]) <= 0.01 + 1e-3 * abs(jthr[k]), k
    for k in ("texture_ratio_translation", "texture_ratio_rotation", "margin_tracking"):
        assert abs(tdiag[k] - jdiag[k]) <= 0.01 + 1e-3 * abs(jdiag[k]), k
    assert tdiag["data_nomatch_suspect"] == jdiag["data_nomatch_suspect"]
    applied = tcal.apply_thresholds(config, tthr)
    assert applied.loop_closure.position_response_thr == tthr["position_response_thr"]
    assert applied.keyframe_selection.lower_rot == tthr["lower_rotation_response_thr"]
    with pytest.raises(ValueError):
        tcal.measure_psr_anchors(config, probe[:3], CPU)
