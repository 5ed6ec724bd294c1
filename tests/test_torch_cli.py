"""``python -m nislam_torch`` against ``python -m nislam_tpu``, on the CPU.

Both CLIs write a synthetic dataset (120×160, 60 frames) and run SLAM over
it; the trajectory files they write must hold the same keyframes, with
poses within 2e-3.  The dataset is the ``loop`` path (full 360° of yaw)
with sensor noise and seed 6: a sequence whose registration peaks have no
near-ties between the two packages' f32 FFT chains, in scan and in step
mode.  Other seeds have them: with the default seed-42 square path the
rotation peak of frame 17 lies between two polar bins whose PSRs differ by
4e-3, and the packages pick different bins (1° apart).
"""

import contextlib
import filecmp
import io
import os

import numpy as np
import pytest
import torch

from nislam_torch.cli import main as torch_cli
from nislam_torch.io.trajectory import read_tum

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

SYNTH = ["--frames", "60", "--height", "120", "--width", "160", "--path", "loop",
         "--noise", "--seed", "6"]
POSE_ATOL = 2e-3


def run_cli(main, argv):
    """``main(argv)`` in this process → (exit code, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def stat(out: str, key: str) -> str:
    """The token after ``key`` in a CLI's output."""
    return out.split(key)[1].split()[0]


def trajectories(root):
    return [read_tum(os.path.join(root, name)) for name in ("KCC_Keyframe.txt", "optimized_keyframe.txt")]


def assert_trajectories_match(a, b):
    for (ta, pa), (tb, pb) in zip(trajectories(a), trajectories(b)):
        np.testing.assert_array_equal(ta, tb)  # the same keyframes
        np.testing.assert_allclose(pa, pb, atol=POSE_ATOL)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """One dataset written by each CLI, and each CLI's scan-mode run."""
    from nislam_tpu.cli import main as jax_cli

    root = tmp_path_factory.mktemp("cli")
    tds, jds = str(root / "torch"), str(root / "jax")
    assert run_cli(torch_cli, ["synth", "--out", tds] + SYNTH)[0] == 0
    assert run_cli(jax_cli, ["synth", "--out", jds] + SYNTH)[0] == 0
    runs = {}
    for name, main, ds, extra in (("torch", torch_cli, tds, ["--device", "cpu"]),
                                  ("jax", jax_cli, jds, [])):
        rc, out = run_cli(main, ["run", "--config", f"{ds}/config.yaml", "--groundtruth",
                                 f"{ds}/groundtruth.txt", "--saving-root", f"{ds}/scan"] + extra)
        assert rc == 0, out
        runs[name] = out
    return tds, jds, runs


def test_synth_writes_the_same_dataset(data):
    tds, jds, _ = data
    names = ["image_names.txt", "times.txt", "groundtruth.txt", "camera.yaml"]
    pngs = sorted(os.listdir(os.path.join(tds, "rgb")))
    assert pngs == sorted(os.listdir(os.path.join(jds, "rgb"))) and len(pngs) == 60
    names += [os.path.join("rgb", p) for p in pngs]
    _, mismatch, errors = filecmp.cmpfiles(tds, jds, names, shallow=False)
    assert not mismatch and not errors
    with open(os.path.join(tds, "config.yaml")) as f, open(os.path.join(jds, "config.yaml")) as g:
        assert f.read().replace(tds, "@") == g.read().replace(jds, "@")


def test_scan_run_matches_jax(data):
    tds, jds, runs = data
    t, j = runs["torch"], runs["jax"]
    for key in ("keyframes", "loops", "optimized"):
        assert stat(t, key) == stat(j, key), key
    assert stat(t, "tracked") == "60/60"
    assert int(stat(t, "loops")) >= 1 and stat(t, "optimized") != "0x"
    assert float(stat(t, "(optimized keyframes):")) < 0.02
    assert_trajectories_match(f"{tds}/scan", f"{jds}/scan")


def test_step_mode_matches_scan_and_jax(data):
    """Step mode (one packed output per frame, the deferred trigger after
    every frame) equals scan mode with one-frame chunks, which has the
    same trigger cadence, and JAX's step mode."""
    from nislam_tpu.cli import main as jax_cli

    tds, jds, _ = data
    base = ["run", "--config", f"{tds}/config.yaml", "--device", "cpu"]
    rc, step = run_cli(torch_cli, base + ["--mode", "step", "--saving-root", f"{tds}/step"])
    assert rc == 0 and "step latency over 60 frames: p50" in step
    assert step.count("processing for one frame is") == 60
    rc, _ = run_cli(torch_cli, base + ["--chunk", "1", "--saving-root", f"{tds}/chunk1"])
    assert rc == 0
    for (ta, pa), (tb, pb) in zip(trajectories(f"{tds}/step"), trajectories(f"{tds}/chunk1")):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_allclose(pa, pb, atol=1e-5)
    rc, jstep = run_cli(jax_cli, ["run", "--config", f"{jds}/config.yaml", "--mode", "step",
                                  "--saving-root", f"{jds}/step"])
    assert rc == 0
    assert stat(step, "optimized") == stat(jstep, "optimized")
    assert_trajectories_match(f"{tds}/step", f"{jds}/step")


def test_checkpoint_resume_and_nisf(data, tmp_path):
    """``--save-state`` after 30 frames, ``--load-state`` resumes with its
    keyframes; ``pack`` writes the NISF file and ``--nisf`` streams it
    with the same result as the image reader."""
    tds, _, runs = data
    base = ["run", "--config", f"{tds}/config.yaml", "--device", "cpu"]
    ck = str(tmp_path / "state.npz")
    rc, out = run_cli(torch_cli, base + ["--max-frames", "30", "--save-state", ck,
                                         "--saving-root", str(tmp_path / "a")])
    assert rc == 0 and os.path.exists(ck)
    kf = stat(out, "keyframes")
    rc, out = run_cli(torch_cli, base + ["--load-state", ck, "--max-frames", "4",
                                         "--saving-root", str(tmp_path / "b")])
    assert rc == 0 and f"({kf} keyframes)" in out
    nisf = str(tmp_path / "frames.nisf")
    rc, out = run_cli(torch_cli, ["pack", "--dataroot", tds, "--out", nisf])
    assert rc == 0 and os.path.getsize(nisf) == 20 + 60 * 8 + 60 * 120 * 160
    rc, out = run_cli(torch_cli, base + ["--nisf", nisf, "--saving-root", str(tmp_path / "n")])
    assert rc == 0 and "NISF reader" in out
    for (ta, pa), (tb, pb) in zip(trajectories(str(tmp_path / "n")), trajectories(f"{tds}/scan")):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(pa, pb)
    assert stat(out, "loops") == stat(runs["torch"], "loops")


def test_artifacts_calibrate_and_profile(data, tmp_path):
    """``--plot --stitch`` write the PNGs, ``--snapshot-every`` writes
    snapshots in step mode, ``--calibrate`` rescales the thresholds before
    the run, ``--profile`` writes a trace."""
    tds, _, _ = data
    base = ["run", "--config", f"{tds}/config.yaml", "--device", "cpu"]
    out_dir = tmp_path / "art"
    rc, out = run_cli(torch_cli, base + ["--plot", "--stitch", "--calibrate", "8",
                                         "--groundtruth", f"{tds}/groundtruth.txt",
                                         "--profile", str(tmp_path / "prof"),
                                         "--saving-root", str(out_dir)])
    assert rc == 0 and "calibrated thresholds on 8 frames" in out
    for name in ("trajectory.png", "occupancy.png", "KCC_Keyframe.txt"):
        assert os.path.getsize(out_dir / name) > 0, name
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    rc, out = run_cli(torch_cli, base + ["--mode", "step", "--max-frames", "12",
                                         "--snapshot-every", "6", "--saving-root", str(out_dir)])
    assert rc == 0
    assert sorted(os.listdir(out_dir / "snapshots"))[:2] == [
        "occupancy_000006.png", "occupancy_000012.png"]
    rc, out = run_cli(torch_cli, ["calibrate", "--config", f"{tds}/config.yaml", "--device", "cpu",
                                  "--frames", "8"])
    assert rc == 0 and "position_response_thr:" in out


@pytest.mark.parametrize("model", ["vo", "slam"])
def test_eval_matches_jax(data, model):
    """``eval`` prints one JSON line with the keys of ``python -m
    nislam_tpu eval`` and, frames/s and the device aside, its values."""
    import json

    from nislam_tpu.cli import main as jax_cli

    tds, jds, _ = data
    lines = {}
    for name, main, ds, extra in (("torch", torch_cli, tds, ["--device", "cpu"]),
                                  ("jax", jax_cli, jds, [])):
        rc, out = run_cli(main, ["eval", "--config", f"{ds}/config.yaml", "--model", model,
                                 "--groundtruth", f"{ds}/groundtruth.txt"] + extra)
        assert rc == 0, out
        lines[name] = json.loads(out.strip().splitlines()[-1])
    got, want = lines["torch"], lines["jax"]
    assert set(got) == set(want)
    assert got["device"] == "cpu" and got["fps"] > 0
    for key in set(want) - {"fps", "device"}:
        assert got[key] == want[key], key
    assert got["tracked_frac"] == 1.0
    if model == "slam":  # the loop-closed keyframes; vo scores the raw odometry
        assert got["loops"] >= 1 and got["ate_rmse_m"] < 0.02


def test_eval_and_missing_device_fail_clearly(data, capsys):
    tds, _, _ = data
    for cmd in ("eval", "run"):
        with pytest.raises(SystemExit) as exc:
            torch_cli([cmd, "--config", f"{tds}/config.yaml"])
        assert exc.value.code == 2
        assert "--device" in capsys.readouterr().err
