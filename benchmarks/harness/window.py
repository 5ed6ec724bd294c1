"""The system under test and the measured window.

The window drives ``nislam_torch`` through its public entry points only:
``models.FullSlam`` (or ``models.VisualOdometry`` for a ``vo`` mix) for
the engine, then per sequence a fresh ``init_state`` and per chunk
``run_chunk``, the deferred ``optimize`` and, at a sequence's last chunk,
``finalize``.  A request is one chunk: timed on the host's clock from the
``run_chunk`` call to the host's read of that chunk's poses (and tracked
flags), its triggers included.  The window starts at the first request
after set-up and ends at the first chunk boundary at or after
``seconds``.

With ``trace`` the same loop also records a CUDA-event pair around every
engine call, the host syncs that ``torch.cuda``'s sync debug mode reports,
and the gaps between the calls by what the host did in them.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import warnings
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Request:
    t0: float
    t1: float
    frames: int
    tracked: int  # frames of the chunk that tracked
    solved: int  # triggers of the request that solved


@dataclasses.dataclass
class Call:
    kind: str  # "run_chunk", "optimize", "finalize"
    start: object  # torch.cuda.Event
    end: object
    ran: bool  # a trigger that solved
    gap: str  # what the host did between the previous call and this one


@dataclasses.dataclass
class Window:
    t_start: float
    t_end: float
    requests: List[Request]
    kept: Dict[int, list]  # instance → [(first frame, packed outputs (n, 17) on the device)]
    kept_keyframes: Dict[int, tuple]  # completed instance → (keyframe poses, frame ids, count) after finalize
    kept_sequence: Dict[int, int]  # instance → distinct sequence
    calls: List[Call]
    syncs: Optional[int]

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    @property
    def frames(self) -> int:
        return sum(r.frames for r in self.requests)


def make_engine(slam: dict, mix: dict, device: torch.device):
    """The engine of ``slam`` (a configuration file's ``slam`` block) as the
    model layer builds the mix's ``model``: ``slam`` or ``vo``."""
    from nislam_torch.core import config as c
    from nislam_torch.models import FullSlam, VisualOdometry

    sections = dict(cf=c.CFConfig, keyframe_selection=c.KeyframeSelectionConfig, map=c.MapConfig,
                    loop_closure=c.LoopClosureConfig, map_stitcher=c.MapStitcherConfig,
                    optimizer=c.OptimizerConfig, camera=c.CameraConfig)
    kw = {}
    for key, cls in sections.items():
        fields = dict(slam[key])
        for name, value in fields.items():
            if isinstance(value, list):
                fields[name] = tuple(value)
        kw[key] = cls(**fields)
    config = c.SlamConfig(**kw)
    models = {"slam": FullSlam, "vo": VisualOdometry}
    if mix["model"] not in models:
        raise ValueError(f"traffic {mix['name']}: model {mix['model']!r} is not slam or vo, and the mix has no "
                         f"module of its own with a make_engine")
    return models[mix["model"]](config, device=device).engine


def run_sequence(engine, frames: torch.Tensor, chunk: int) -> tuple:
    """One whole sequence as the window runs it (warm-up, calibration and
    the profiled sequence) → (packed per-frame outputs (n, 17), the
    keyframes after ``finalize``: :func:`keyframe_table`), on the device."""
    state = engine.init_state()
    parts = []
    for c in range(frames.shape[0] // chunk):
        state, outs = engine.run_chunk(state, frames[c * chunk:(c + 1) * chunk])
        state, _ = engine.optimize(state)
        parts.append(outs.pack())
    state, _ = engine.finalize(state)
    bank = state.bank
    return torch.cat(parts), keyframe_table(bank.poses, bank.frame_ids, bank.count)


def keyframe_table(poses: torch.Tensor, frame_ids: torch.Tensor, count) -> torch.Tensor:
    """A bank's live keyframes as one (count, 4) float64 table: x, y,
    heading and the frame that stored each."""
    n = int(count)
    return torch.cat([poses[:n].double(), frame_ids[:n, None].double()], dim=1)


def compile_counts(engine, device: torch.device) -> dict:
    """What the program has loaded, planned, captured and left early so far."""
    from nislam_torch.core.track_graph import CapturedStep
    from nislam_torch.kernels.build import loaded

    plans = None
    if device.type == "cuda":
        plans = torch.backends.cuda.cufft_plan_cache[device.index or 0].size
    return {"libraries": set(loaded()), "plans": plans, "graphs": CapturedStep.captures,
            "early_exits": engine.chunk_graph.early_exits}


def counters(engine) -> dict:
    """The program's own counts: the stored body's runs in the chunk graph,
    and the solve graph's deferred solves and LM iterations."""
    out = {"stored_runs": engine.chunk_graph.runs.get(0, 0)}
    counts = engine.solve_graph.counts.tolist()  # triggers, deferred IF bodies, inline IF bodies, LM iterations
    out["solves"], out["lm_iterations"] = counts[1], counts[3]
    return out


class _Syncs:
    """``torch.cuda``'s sync debug mode over a block: the synchronizing
    calls it reports."""

    def __enter__(self):
        torch.cuda.synchronize()
        self._catch = warnings.catch_warnings(record=True)
        self.seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        self.count = sum("synchroniz" in str(w.message) and "prototype" not in str(w.message) for w in self.seen)
        return False


def run_window(engine, seqs, seconds: float, *, keep: set, trace: bool) -> Window:
    """The measured window over the cycled sequences ``seqs``
    (:class:`~benchmarks.harness.traffic.Sequences`).  ``keep``: the
    distinct sequences whose outputs (every instance in the window) and
    keyframe poses after ``finalize`` are kept on the device for the
    output check."""
    chunk, n_chunks = seqs.chunk, seqs.chunks
    requests: List[Request] = []
    calls: List[Call] = []
    kept, kept_keyframes, kept_sequence = {}, {}, {}
    gap = ["window start"]

    def call(kind, fn, *args):
        if not trace:
            return fn(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        ran = kind != "run_chunk" and bool(out[1])
        calls.append(Call(kind, start, end, ran, gap[0]))
        return out

    syncs = _Syncs() if trace else None
    if syncs is not None:
        syncs.__enter__()
    # No collector pass inside the window: its pauses land on random
    # requests.  The engine frees its buffers by reference counting.
    gc.collect()
    gc.disable()
    try:
        t_start = time.perf_counter()
        instance, done = 0, False
        while not done:
            j = seqs.order[instance % seqs.distinct]
            state = None  # the last sequence's state released before the fresh one is made
            gap[0] = "a fresh state"
            state = engine.init_state()
            if j in keep:
                kept[instance], kept_sequence[instance] = [], j
            for c in range(n_chunks):
                t0 = time.perf_counter()
                state, outs = call("run_chunk", engine.run_chunk, state, seqs.frames[j, c * chunk:(c + 1) * chunk])
                gap[0] = "between run_chunk and optimize"
                state, ran = call("optimize", engine.optimize, state)
                solved = int(ran)
                if c == n_chunks - 1:
                    gap[0] = "between optimize and finalize"
                    state, ran = call("finalize", engine.finalize, state)
                    solved += int(ran)
                    if j in keep:
                        bank = state.bank
                        kept_keyframes[instance] = (bank.poses.clone(), bank.frame_ids.clone(), bank.count.clone())
                read = torch.cat([outs.pose, outs.tracked[:, None].to(outs.pose.dtype)], dim=1).cpu()
                t1 = time.perf_counter()
                gap[0] = "the read of the chunk's poses, then the host's loop"
                requests.append(Request(t0, t1, read.shape[0], int(read[:, 3].sum()), solved))
                if j in keep:
                    kept[instance].append((c * chunk, outs.pack()))
                if t1 - t_start >= seconds:
                    done = True
                    break
            instance += 1
        t_end = requests[-1].t1
    finally:
        gc.enable()
        if syncs is not None:
            syncs.__exit__(None, None, None)
    return Window(t_start, t_end, requests, kept, kept_keyframes, kept_sequence, calls,
                  syncs.count if syncs is not None else None)
