"""``python -m nislam_torch.scripts.bench`` against ``bench.py``, on the CPU.

``bench.py --quick`` (JAX, in a subprocess of its own) and the port's bench with ``--device cpu`` and the same flags
run the 128-frame quick workload (120×160, chunks of 64) and must print
JSON lines with the same keys and the same decisions: image, polar grid,
semantics, tracked_frac and truncated loop searches equal, ATE within
2e-4 (both rounded to 4 places), and the same keyframes and loops on the
stderr summary line.  That workload's registration peaks have no
near-ties between the two packages' f32 FFT chains (41 keyframes and 8
loops in both); a near-tie would flip a decision (ROADMAP, Traps).  The
batch and scaling keys, and every computing script's refusal to run on a
card that is not there, are checked on the port alone, and so is the
warm-up: a kernel that loads at the first solve (as ``scatter_add`` does
on the card) loads before the timed window.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from nislam_torch.scripts import bench

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = ["--quick", "--frames", "128", "--chunk", "64"]
JAX_TIMEOUT_S = 300
ATE_ATOL = 2e-4
KEYS = {"metric", "value", "unit", "vs_baseline", "ate_rmse_m", "tracked_frac", "device", "image",
        "polar", "semantics", "loop_truncated_frames"}


def summary(stderr: str) -> dict:
    """``{tracked, keyframes, loops}`` from a bench's "N frames in …" line."""
    line = next(ln for ln in stderr.splitlines() if " frames in " in ln)
    fields = dict(part.split()[:2] for part in line.split("|")[1:4])
    return {k: int(v) for k, v in fields.items()}


def run_port(argv):
    """The port's bench in this process → (JSON dict, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert bench.main(argv) == 0
    return json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


@pytest.fixture(scope="module")
def jax_bench():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "bench.py", *QUICK, "--scaling", "0"], capture_output=True, text=True,
                          timeout=JAX_TIMEOUT_S, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1]), proc.stderr


def test_bench_matches_jax(jax_bench):
    want, want_err = jax_bench
    got, got_err = run_port([*QUICK, "--scaling", "0", "--device", "cpu"])
    assert set(got) == set(want) == KEYS
    for key in ("image", "polar", "semantics", "tracked_frac", "loop_truncated_frames", "unit", "metric"):
        assert got[key] == want[key], key
    assert got["tracked_frac"] == 1.0
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) <= ATE_ATOL
    assert summary(got_err) == summary(want_err)
    assert got["device"] == "cpu"
    for line in ("device: cpu", "data gen: ", "warm-up (2 chunks with optimize", "in the timed window: "):
        assert line in got_err


def test_bench_warm_up_reaches_the_first_solve(monkeypatch):
    """The quick workload's solves come after its first chunk; a kernel
    library that the first solve loads must load in the warm-up, so the
    timed window loads none."""
    import nislam_torch.core.solve_graph as solve_graph
    from nislam_torch.kernels import build

    real = solve_graph.lm_setup  # the setup of every solve of the engine's trigger

    def first_solve_loads(*args, **kwargs):
        build._loaded.setdefault("solver", None)  # what load_library records on the card
        return real(*args, **kwargs)

    monkeypatch.setattr(build, "_loaded", {})  # a fresh process's
    monkeypatch.setattr(solve_graph, "lm_setup", first_solve_loads)
    with contextlib.redirect_stderr(io.StringIO()) as err:
        res = bench.run(bench.parse([*QUICK, "--device", "cpu"]))
    assert build.loaded() == ("solver",)
    assert res["window"] == {"loaded_before": ["solver"], "loaded": [], "fft_plans_before": None, "fft_plans": None,
                             "graphs_before": None, "graphs": None}
    assert ("in the timed window: kernel libraries loaded before it ['solver'], 0 inside it [] | cuFFT plans n/a"
            " | CUDA graphs captured n/a" in err.getvalue())


def test_bench_batch_and_scaling_keys():
    from nislam_tpu.utils.scaling import shard_work_stats

    got, err = run_port(["--quick", "--frames", "64", "--batch", "2", "--scaling", "4", "--device", "cpu"])
    scaling = {"scaling_devices", "scaling_slots_per_shard", "scaling_registrations_per_shard",
               "scaling_work_balance"}
    assert set(got) == KEYS | {"batch_size", "batch_frames_per_sec_per_chip"} | scaling
    assert got["batch_size"] == 2 and got["batch_frames_per_sec_per_chip"] > 0
    # 64 frames: 16 per lane (bench.py's min(chunk, frames // 4)), each tracked.
    line = next(ln for ln in err.splitlines() if ln.startswith("batch: 2 lanes x 16 frames"))
    assert line.endswith("tracked per lane [16, 16]")
    want = shard_work_stats(keyframe_capacity=256, nshards=4, max_candidates=8)
    assert got["scaling_devices"] == 4
    assert got["scaling_slots_per_shard"] == want["slots_per_shard"]
    assert got["scaling_registrations_per_shard"] == want["registrations_per_shard"]
    assert got["scaling_work_balance"] == want["balance"]


@pytest.mark.parametrize("name,argv", [
    ("bench", ["--quick"]),
    ("stagebench", []),
    ("hdprofile", []),
    ("hdbench", []),
    ("opbench", []),
    ("polarbench", []),
    ("psrcal", []),
    ("rotstudy", []),
])
def test_no_card_no_run(name, argv, monkeypatch):
    """``--device cuda`` (the default) without a card ends the run before it
    starts, with a message that names ``--device cpu``."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"nislam_torch.scripts.{name}")
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
