"""The port's study and timing scripts against the JAX scripts, on the CPU.

- ``psrcal.run_size`` against ``scripts/psrcal.py``'s at 64² and 96² over
  16 frames: the tracked counts equal, every PSR quantile within rtol
  5e-4 (two f32 FFT chains agree to ~3e-4 in PSR; ROADMAP, Traps), and
  the fitted exponents of both within 5e-3;
- ``rotstudy.sweep`` against the JAX script's sweep (``compute_pose`` with
  ``large_rotation=True`` of each turned view against the unturned one)
  at 96×128, divisor 720, 64 channels, six off-grid angles of seed 42:
  errors within 1e-3°, acceptance equal;
- ``make_world``'s four texture families bit for bit against JAX's;
- ``utils.profiling.top_kernels`` on a hand-made Chrome trace: totals,
  counts and shares exact (a copy overlapping a kernel counts once in
  the busy time);
- every timing script with ``--device cpu`` at its smallest size and a
  small R prints every stage or variant label.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nislam_torch.scripts import hdbench, hdprofile, opbench, polarbench, psrcal, rotstudy, stagebench, traceparse
from nislam_torch.utils.profiling import top_kernels

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSR_RTOL = 5e-4
ANGLE_ATOL = 1e-3  # degrees


def jax_script(name: str):
    """``scripts/<name>.py`` as a module (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_main(main, argv) -> str:
    """``main(argv)`` in this process → its stdout (it must exit 0)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def psr_rows():
    jax_psrcal = jax_script("psrcal")
    sizes = (64, 96)
    return ([psrcal.run_size(s, s, 16, device="cpu") for s in sizes],
            [jax_psrcal.run_size(s, s, 16) for s in sizes])


@pytest.mark.parametrize("i", [0, 1])
def test_psrcal_run_size_matches_jax(psr_rows, i):
    got, want = psr_rows[0][i], psr_rows[1][i]
    for key in ("h", "w", "rd", "rc", "n"):
        assert got[key] == want[key], key
    for key in ("trans_q10", "trans_med", "trans_q90", "rot_q10", "rot_med", "rot_q90"):
        np.testing.assert_allclose(got[key], want[key], rtol=PSR_RTOL, err_msg=key)


def test_psrcal_fit_matches_jax(psr_rows):
    got, want = psr_rows
    logn = np.log([r["h"] * r["w"] for r in want])
    want_fit = [np.polyfit(logn, np.log([r[k] for r in want]), 1)[0] for k in ("trans_med", "rot_med")]
    np.testing.assert_allclose(psrcal.fit_exponents(got), want_fit, atol=5e-3)


def jax_sweep(h, w, divisor, channel, seed, angles):
    """``scripts/rotstudy.py``'s loop body for one channel count and seed."""
    from nislam_tpu.core.config import CFConfig, derive_response_thresholds
    from nislam_tpu.ops.registration import compute_intermedium, compute_pose, make_cf_ops
    from nislam_tpu.utils.synthetic import make_world, render_frame

    cfg = CFConfig(width=w, height=h, rotation_divisor=divisor, rotation_channel=channel)
    ops = make_cf_ops(cfg)
    thr = derive_response_thresholds(w, h, divisor, channel)["angle_response_thr"]
    world = make_world(2048, 3.0, seed=seed)
    kf_fft, kf_polar = compute_intermedium(jnp.asarray(render_frame(world, h, w, 1024.0, 1024.0, 0.0)), ops)
    fn = jax.jit(lambda img, cp: compute_pose(kf_fft, img, kf_polar, cp, ops, large_rotation=True))
    errs, accepts = [], []
    for a in angles:
        cur = render_frame(world, h, w, 1024.0, 1024.0, np.deg2rad(a))
        _, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
        pose, info = fn(jnp.asarray(cur), cur_polar)
        e = abs(np.degrees(float(pose[2])) - a) % 360.0
        errs.append(min(e, 360.0 - e))
        accepts.append(float(info[2]) > thr)
    return np.asarray(errs), np.asarray(accepts)


def test_rotstudy_sweep_matches_jax():
    angles = rotstudy.sweep_angles(6)
    got = rotstudy.sweep(96, 128, 720, 64, [42], angles, "cpu")
    want_err, want_accept = jax_sweep(96, 128, 720, 64, 42, angles)
    np.testing.assert_allclose(got["err"], want_err, atol=ANGLE_ATOL)
    np.testing.assert_array_equal(got["accept"], want_accept)
    row = rotstudy.channel_row(64, 720, got)
    assert row["max_err"] == got["err"].max() and 0.0 <= row["accept"] <= 1.0


@pytest.mark.parametrize("family", ["gaussian", "powerlaw", "blobs", "fibrous"])
def test_make_world_families_match_jax(family):
    from nislam_tpu.utils.synthetic import make_world as jax_world
    from nislam_torch.utils.synthetic import make_world

    sigma = 1.5 if family == "powerlaw" else 3.0
    np.testing.assert_array_equal(make_world(256, sigma, 5, family), jax_world(256, sigma, 5, family))


def hand_made_trace(path: str) -> None:
    """Kernels a (3 launches: 10 + 20 + 30 µs) and b (1: 15 µs), a copy of
    10 µs that overlaps a's first launch by 4, a memset of 5 µs apart,
    host events that are not device work."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 100, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 120, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 150, "dur": 15},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 200, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 106, "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 300, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 90, "dur": 3},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 80, "dur": 400},
        {"ph": "i", "cat": "kernel", "name": "a", "ts": 400},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_top_kernels_on_a_hand_made_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    hand_made_trace(path)
    # busy: [100, 116) from a and the copy, then 20 + 15 + 30 + 5 → 86 µs
    busy = 86.0
    top = top_kernels(path)
    assert top["busy_ms"] == busy / 1e3
    assert top["kernels"] == [
        {"name": "a", "ms": 60 / 1e3, "launches": 3, "share": 60 / busy},
        {"name": "b", "ms": 15 / 1e3, "launches": 1, "share": 15 / busy},
    ]
    assert top_kernels(path, 1)["kernels"] == top["kernels"][:1]
    out = run_main(traceparse.main, [str(tmp_path), "1"])
    assert "device busy: 0.086 ms | top 1 kernels: 0.060 ms, 69.8% of it" in out
    assert out.splitlines()[1].endswith("  a")


@pytest.mark.parametrize("script,argv,labels", [
    (stagebench, ["--size", "256", "--r", "2"],
     [label + " " for label in ("undistort gather", "compute_intermedium (3 xforms+polar)",
                                "polar registration (incl rfft2)", "rotate_wrap_fft (3 shears)",
                                "image registration (incl rfft2)", "peak_stats",
                                "keyframe_filter (2 xforms, img size)", "tracked frame, graph replay",
                                "frame graph, no keyframe", "frame graph, keyframe stored + loop search",
                                "batch x8 frame graph, no keyframe",
                                "batch x8, body 1: 1 of 8 lanes store + search, one replay",
                                "batch x8, 2 lane branch graphs (store + search) one after another",
                                "chunk graph, no keyframe (per frame of 16)",
                                "chunk graph, keyframe stored + loop search (per frame of 16)",
                                "chunk graph, keyframe stored + inline solve of two written-in matches "
                                "(one frame per launch, the state written back first)",
                                "distributed branch, stored keyframe + sharded search (1 rank), eager",
                                "distributed branch, stored keyframe + sharded search (1 rank), captured steps")]
     + ['{"stagebench": ']),
    (hdbench, ["--r", "1"],
     ["peak_stats kernel", "peak_stats plain (peak_stats_reference)", "rfft2+irfft2 roundtrip (cuFFT)",
      "irfft2 of magnitude (cuFFT)", "rotate_wrap_fft 3 shears", "shear_x only", "shear phase sincos only",
      "polar_resample 4-tap (720x480 out)", "undistort bilinear_sample (4 taps)"]),
    (opbench, ["--h", "96", "--w", "128", "--k", "1", "2"],
     ["fft rt cuFFT", "rotate 3-shear", "rotate gather", "peak_stats kernel", "peak_stats plain",
      "roll+add (bandwidth ref)"]),
    (polarbench, ["--size", "256", "--batch", "2", "--r", "2"],
     ["--- batch 1", "--- batch 2", "4-tap half_polar (production)", "literal chain",
      "half gather -> rfft2 (engine ctx)", "crop -> rfft2 (no gather bound)"]),
    (hdprofile, ["--size", "96", "128", "--frames", "8"],
     ["one chunk of 8 frames (7 tracked)", "busy share", "kernel launches per frame", "device busy: "]),
    (psrcal, ["--sizes", "64", "96", "--frames", "8"],
     ["64x64 (n=8)", "96x96 (n=8)", "fitted [gaussian]: median translation PSR ~ (W*H)^",
      "(derive_response_thresholds assumes 0.5)", "median rotation PSR ~ (W*H)^"]),
    (rotstudy, ["--size", "96", "128", "--channels", "64", "--angles", "4", "--seeds", "42"],
     ["C=64: mean ", "| channel | mean err ° |", "| 64 | "]),
], ids=["stagebench", "hdbench", "opbench", "polarbench", "hdprofile", "psrcal", "rotstudy"])
def test_timing_script_on_the_cpu(script, argv, labels):
    out = run_main(script.main, [*argv, "--device", "cpu"])
    assert out.startswith("device: cpu")
    for label in labels:
        assert label in out, label
    if script is stagebench:
        rows = json.loads(out.splitlines()[-1])["stagebench"]
        # the empty-body chunk-graph rows need the card
        assert len(rows) == 20 and all(r["equal"] and r["cpu_us"] > 0 for r in rows.values())
