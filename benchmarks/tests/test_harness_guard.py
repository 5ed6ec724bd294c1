"""Nothing the benchmark runs loads JAX or the JAX package, by top-level
module name compared whole."""

import os
import sys

import pytest

from benchmarks import run as bench_run
from benchmarks.harness import guard
from benchmarks.tests import tiny


def test_top_level_names_are_compared_whole():
    assert guard.forbidden(["nislam_torch", "nislam_torch.core.slam", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden(["jax.numpy", "jaxlib", "flax.linen", "nislam_tpu.core"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "nislam_tpu.core"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    assert guard.scan(tiny.BENCH) == []


def test_the_scan_sees_an_import(tmp_path):
    (tmp_path / "bad.py").write_text("import numpy\nfrom jax import numpy as jnp\nimport nislam_tpu.core\n")
    found = guard.scan(str(tmp_path))
    assert [f.split(": ")[1] for f in found] == ["jax", "nislam_tpu.core"]


def test_a_run_that_finds_the_jax_package_loaded_stops(monkeypatch):
    monkeypatch.setitem(sys.modules, "nislam_tpu", type(sys)("nislam_tpu"))
    with pytest.raises(SystemExit) as e:
        bench_run.no_jax("test")
    assert e.value.code == 3


def test_the_run_and_the_port_load_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); import benchmarks.run, benchmarks.calibrate, "
            "nislam_torch.models, nislam_torch.core.slam; "
            "from benchmarks.harness import guard; print(guard.loaded_forbidden())") % os.path.dirname(tiny.BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_prints_nothing_and_fails(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = bench_run.main(["--workload", "ntu-seq512", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
