"""The output check: the plain reference agrees with the port at a small
size, and the check comes out false for the bfloat16 control and for each
fault a cell of this benchmark can have, planted under the timed path.
(One chip: no exchange between chips to leave out.)"""

import argparse

import pytest
import torch

from benchmarks import run as bench_run
from benchmarks.harness import catalog, check, traffic
from benchmarks.tests import tiny

SEED = 2**31 + 7


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(root, seconds=2.0, device="cpu"):
    args = argparse.Namespace(workload="tiny", seed=SEED, seconds=seconds, trace=0)
    return bench_run.run(args, torch.device(device), root=root)


@pytest.mark.parametrize("model,coarse", [("slam", 1), ("slam", 2), ("vo", 1)])
def test_the_reference_agrees_with_the_port(tmp_path, model, coarse):
    result = _run(tiny.make_root(str(tmp_path), model=model, coarse=coarse))
    assert result["correct"] is True
    assert result["checks"]["mismatched_decisions"]["value"] == 0
    assert result["failed"] == 0 and result["attempted"] > 0


def test_the_reference_follows_tracking_loops_and_solves(tmp_path):
    cell = catalog.load_cell("tiny", tiny.make_root(str(tmp_path)))
    seqs = traffic.make_sequences(cell.traffic, 120, 160, SEED, "cpu")
    ref = check.reference(cell, "cpu").run(seqs.frames[0], seqs.chunk)
    assert ref["tracked"].all() and ref["loop_found"].sum() >= 2 and ref["solves"] >= 1
    assert 0 < ref["inserted"].sum() < len(ref["inserted"])


def test_the_bf16_control_fails_the_check(tmp_path):
    cell = catalog.load_cell("tiny", tiny.make_root(str(tmp_path)))
    seqs = traffic.make_sequences(cell.traffic, 120, 160, SEED, "cpu")
    numbers = check.check_control(seqs, cell, "cpu", [0])
    assert not check.verdict(numbers, cell.limits["limits"])


def _faulty(monkeypatch, fault):
    from nislam_torch.core.slam import SlamEngine

    run_chunk, optimize = SlamEngine.run_chunk, SlamEngine.optimize
    if fault == "trigger returns its state unchanged":
        monkeypatch.setattr(SlamEngine, "optimize", lambda self, state: (state, False))
    elif fault == "half the chunk left out":
        def half(self, state, images):
            n = len(images)
            state, outs = run_chunk(self, state, images[: n // 2])
            return state, type(outs)(*(torch.cat([x, x])[:n] for x in outs))
        monkeypatch.setattr(SlamEngine, "run_chunk", half)
    elif fault == "a pose altered where it is produced":
        def altered(self, state, images):
            state, outs = run_chunk(self, state, images)
            outs.pose[len(images) // 2, 0] += 1.0 / 160.0  # one pixel
            return state, outs
        monkeypatch.setattr(SlamEngine, "run_chunk", altered)
    return optimize


@pytest.mark.parametrize("fault", ["trigger returns its state unchanged", "half the chunk left out",
                                   "a pose altered where it is produced"])
def test_a_planted_fault_makes_the_run_incorrect(tmp_path, monkeypatch, fault):
    root = tiny.make_root(str(tmp_path))
    _faulty(monkeypatch, fault)
    result = _run(root)
    assert result["correct"] is False, result["checks"]


@pytest.mark.gpu
def test_on_the_card_the_port_agrees_and_the_control_fails(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tiny.make_root(str(tmp_path))
    assert _run(root, device="cuda")["correct"] is True
    cell = catalog.load_cell("tiny", root)
    seqs = traffic.make_sequences(cell.traffic, 120, 160, SEED, "cuda")
    assert not check.verdict(check.check_control(seqs, cell, "cuda", [0]), cell.limits["limits"])
