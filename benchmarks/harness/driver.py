"""How a traffic mix drives the system under test, found by the mix's name.

A mix is its file of parameters, ``benchmarks/traffic/<mix>.json``.  Where
a mix needs code (another engine, another loop, another reference), a
module beside it of the same name, ``benchmarks/traffic/<mix>.py``,
defines any of the pieces below under the same name, and the harness uses
its own for the rest.  Without a module a mix runs the default loop
(:mod:`benchmarks.harness.window`): ``models.FullSlam`` or
``models.VisualOdometry`` by the mix's ``model``; per sequence a fresh
state; per chunk ``run_chunk``, the deferred ``optimize`` and, at the
end, ``finalize``; the single-lane plain reference.

The pieces, with the signatures a module's own have to keep:

- ``make_engine(slam, mix, device)``: the system under test;
- ``make_sequences(mix, height, width, seed, device, world_seeds=None)``:
  the rendered traffic (:class:`~benchmarks.harness.traffic.Sequences`);
- ``run_sequence(engine, frames, chunk)``: one whole sequence as the
  window runs it (warm-up, calibration, the profiled sequence) →
  (packed per-frame outputs (n, 17), keyframe poses after the end);
- ``run_window(engine, seqs, seconds, *, keep, trace)``: the measured
  window (:class:`~benchmarks.harness.window.Window`);
- ``reference(cell, device, precision="f32")``: the plain reference, an
  object whose ``run(frames, chunk)`` gives the outputs the check compares;
- ``compile_counts(engine, device)`` and ``counters(engine)``: what the
  program has loaded, planned, captured and left early, and its own
  counters.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Callable

PIECES = ("make_engine", "make_sequences", "run_sequence", "run_window", "reference", "compile_counts",
          "counters")


@dataclasses.dataclass(frozen=True)
class Driver:
    make_engine: Callable
    make_sequences: Callable
    run_sequence: Callable
    run_window: Callable
    reference: Callable
    compile_counts: Callable
    counters: Callable
    module: str  # the mix's module, or "" where it has none


def default_pieces() -> dict:
    from benchmarks.harness import check, traffic, window

    return {"make_engine": window.make_engine, "make_sequences": traffic.make_sequences,
            "run_sequence": window.run_sequence, "run_window": window.run_window, "reference": check.reference,
            "compile_counts": window.compile_counts, "counters": window.counters}


def load(mix: str, bench_dir: str) -> Driver:
    """The driver of mix ``mix`` under the benchmark folder ``bench_dir``."""
    pieces = default_pieces()
    path = os.path.join(bench_dir, "traffic", f"{mix}.py")
    if not os.path.exists(path):
        return Driver(module="", **pieces)
    spec = importlib.util.spec_from_file_location(f"benchmarks.traffic.{mix.replace('-', '_').replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for name in PIECES:
        pieces[name] = getattr(module, name, pieces[name])
    return Driver(module=path, **pieces)
