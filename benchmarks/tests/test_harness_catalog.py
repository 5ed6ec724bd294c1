"""Discovery by name: a later cell, configuration, mix or per-layer metric
is new files and new entries, with no file of the benchmark edited."""

import argparse
import hashlib
import json
import os
import shutil

import pytest
import torch

from benchmarks import run as bench_run
from benchmarks.harness import catalog
from benchmarks.tests import tiny

REPO = os.path.dirname(tiny.BENCH)


def _digests(folder):
    out = {}
    for base, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, folder)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_every_cell_of_the_benchmark_finds_its_files():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = catalog.load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"frames_per_s", "setup_s"}
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            reader = catalog.metric_reader(m["name"])
            assert reader.UNIT == m["unit"]
            assert getattr(reader, "MOVES", m.get("moves")) == m.get("moves")
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert set(c["reduced"]) == set(json.load(open(os.path.join(REPO, c["file"])))["reduced"])


DUMMY_METRIC = '''"""Frames in the window (a test's metric)."""

UNIT = "frames"
LAYER = "end to end"
MOVES = "frames_per_s"


def read(record):
    return record.window.frames
'''


def test_a_mix_a_metric_and_a_cell_added_as_files_and_entries(tmp_path):
    root = str(tmp_path)
    shutil.copytree(tiny.BENCH, os.path.join(root, "benchmarks"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    before = _digests(os.path.join(root, "benchmarks"))

    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    with open(os.path.join(root, "benchmarks", "configs", "tiny-160x120.json"), "w") as f:
        json.dump({"name": "tiny-160x120", "slam": tiny.SLAM}, f)
    with open(os.path.join(root, "benchmarks", "traffic", "vo-dummy.json"), "w") as f:
        json.dump(dict(tiny.MIX, name="vo-dummy", model="vo", world_seeds=[5]), f)
    with open(os.path.join(root, "benchmarks", "checks", "tiny-vo.json"), "w") as f:
        json.dump({"cell": "tiny-vo", "limits": tiny.LIMITS}, f)
    with open(os.path.join(root, "benchmarks", "metrics", "window_frames.py"), "w") as f:
        f.write(DUMMY_METRIC)
    bench["configs"].append({"name": "tiny-160x120", "source": "test", "file": "benchmarks/configs/tiny-160x120.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-vo", "config": "tiny-160x120", "traffic": "vo-dummy", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "window_frames", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "end to end", "moves": "frames_per_s",
                               "workloads": ["tiny-vo"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = catalog.load_cell("tiny-vo", root)
    assert cell.traffic["model"] == "vo" and cell.config["slam"]["cf"]["width"] == 160
    assert "window_frames" in {m["name"] for m in cell.per_layer}
    assert "window_frames" not in {m["name"] for m in catalog.load_cell("ntu-seq512", root).per_layer}

    torch.set_num_threads(4)
    args = argparse.Namespace(workload="tiny-vo", seed=2**31 + 99, seconds=1.0, trace=0)
    result = bench_run.run(args, torch.device("cpu"), root=root)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"frames_per_s", "chunk_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"

    class Rec:
        window = type("W", (), {"frames": 96})()

    got = catalog.read_metrics([m for m in cell.per_layer if m["name"] == "window_frames"], Rec(), root)
    assert got == {"window_frames": {"value": 96.0, "unit": "frames"}}
    after = _digests(os.path.join(root, "benchmarks"))
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited


STEP_MIX = '''"""Step mode (a test's mix with code of its own): one frame per request,
the deferred trigger after every ``chunk`` frames, finalize at the end."""

import time

import torch

from benchmarks.harness.window import Request, Window, keyframe_table


def _sequence(engine, frames, chunk, on_frame=None):
    state = engine.init_state()
    n = frames.shape[0]
    for i in range(n):
        t0 = time.perf_counter()
        state, packed = engine.step_packed(state, frames[i])
        solved = 0
        if (i + 1) % chunk == 0 or i == n - 1:
            state, ran = (engine.finalize if i == n - 1 else engine.optimize)(state)
            solved = int(ran)
        if on_frame is not None and on_frame(i, t0, packed, solved, state):
            break
    return state


def run_sequence(engine, frames, chunk):
    rows = []

    def keep(i, t0, packed, solved, state):
        rows.append(packed)
        return False

    bank = _sequence(engine, frames, chunk, keep).bank
    return torch.stack(rows), keyframe_table(bank.poses, bank.frame_ids, bank.count)


def run_window(engine, seqs, seconds, *, keep, trace):
    requests, kept, kept_keyframes, kept_sequence = [], {}, {}, {}
    t_start = time.perf_counter()
    instance = 0
    while not requests or requests[-1].t1 - t_start < seconds:
        j = seqs.order[instance % seqs.distinct]
        if j in keep:
            kept[instance], kept_sequence[instance] = [], j

        def on_frame(i, t0, packed, solved, state):
            row = packed.cpu()
            requests.append(Request(t0, time.perf_counter(), 1, int(row[0] > 0.5), solved))
            if j in keep:
                kept[instance].append((i, packed[None]))
                if i == seqs.length - 1:
                    b = state.bank
                    kept_keyframes[instance] = (b.poses.clone(), b.frame_ids.clone(), b.count.clone())
            return requests[-1].t1 - t_start >= seconds

        _sequence(engine, seqs.frames[j], seqs.chunk, on_frame)
        instance += 1
    return Window(t_start, requests[-1].t1, requests, kept, kept_keyframes, kept_sequence, [], None)
'''


def test_a_mix_with_code_of_its_own_added_as_files_and_entries(tmp_path):
    """A step-mode mix: its loop in ``traffic/<mix>.py`` beside its
    parameters, found by name; the engine and the reference the default's."""
    root = tiny.make_root(str(tmp_path))
    before = _digests(os.path.join(root, "benchmarks"))
    with open(os.path.join(root, "benchmarks", "traffic", "step-tiny.json"), "w") as f:
        json.dump(dict(tiny.MIX, name="step-tiny", frames_per_sequence=64, world_seeds=[13]), f)
    with open(os.path.join(root, "benchmarks", "traffic", "step-tiny.py"), "w") as f:
        f.write(STEP_MIX)
    with open(os.path.join(root, "benchmarks", "checks", "tiny-step.json"), "w") as f:
        json.dump({"cell": "tiny-step", "limits": tiny.LIMITS}, f)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "tiny-step", "config": "tiny", "traffic": "step-tiny", "chips": 1,
                               "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = catalog.load_cell("tiny-step", root)
    assert cell.driver.module.endswith(os.path.join("traffic", "step-tiny.py"))
    assert cell.driver.run_window.__module__ != "benchmarks.harness.window"
    assert catalog.load_cell("tiny", root).driver.module == ""

    torch.set_num_threads(4)
    args = argparse.Namespace(workload="tiny-step", seed=2**31 + 5, seconds=1.0, trace=0)
    result = bench_run.run(args, torch.device("cpu"), root=root)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 1 and result["failed"] == 0
    after = _digests(os.path.join(root, "benchmarks"))
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited


def test_a_reader_whose_unit_differs_is_refused(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    m = dict(bench["end_to_end"][0], unit="frames/min")
    with pytest.raises(ValueError, match="unit"):
        catalog.read_metrics([m], None, root)
