#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nislam_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``nislam_torch/csrc`` (one nvcc per source, all started together) and
   prints the build time.
2. Holds the ``peak_stats`` kernel against its plain PyTorch version at
   every response shape of the main path (the 480×640 flagship and the
   1200×1600 HD size, tracking and loop-search batches), on constructed
   ties and on a ragged shape; the ``(trans, psr)`` that the kernel's last
   step derives (``registration_stats``) must equal, bit for bit, the plain
   arithmetic on the kernel's own four statistics.  Times the kernel and
   the plain version as device time per launch (100 back-to-back launches
   between one pair of CUDA events, over input copies that exceed the L2
   cache) beside the launch floor (an empty kernel in the same harness)
   and, beside it, the kernel's time per call with the host's share (one
   event pair around one call).  Then 1200 back-to-back launches that
   alternate shapes and batch sizes on one stream must reproduce the first
   results (the workspace's counters return to zero, and it grows), a
   short profiled window must show one kernel per call under each
   kernel's name, and a call must make one allocation.
   2b. ``scatter_add`` (the fixed-order ``index_add``) at every shape the
   solvers give it (the dense LM's H blocks and gradient at K = 272 / E =
   1024 and K = 1024 / E = 4096, a GN-CG rank's (K, 3) sums), at the flat
   scatters the stitcher made before it had its own kernel, on a ragged
   case and on runs of one length from 1 to 100,000, against its plain
   version on CPU copies of the same inputs and against itself, bit for
   bit; a key out of range must be reported and never written.  Times it
   as above, beside its plan (``torch.sort`` and the run table), the plain
   version and ``index_add_`` on the card, and per call with the host.
   Then ``stitch_raster``, the stitcher's kernel (one launch per frame,
   no sort), at inserts of 480×640 and 1200×1600 frames on 4096² and
   8192² canvases, a retire that evicts nothing, a negated insert, a
   frame centred on the image-plane origin and recompute batches of 16
   frames at both sizes: bit for bit against ``index_add_`` of the card's
   own targets and values on the CPU, and against itself; timed as
   launches alone and as the whole op, beside the op it replaced (targets,
   sort, two ``scatter_add`` launches) and ``index_add_``.
3. Drives the flagship workload (480×640 frames, 720×480 polar grid, bf16
   bank with cached filters, 8 loop candidates, the 512-frame heading loop)
   through ``make_engine(config, cuda)`` and ``run_sequence(chunk_frames=128)``
   and ``finalize``: one warm-up run, one timed run with the kernel's launch
   count reset before it.  Checks tracking, loops, solves, ATE and that the
   run went through the kernels.  The same run again must repeat every
   solve's cost, every output and the final poses bit for bit.  Then a
   profiled scan over the first 64 frames: the busy share and the kernel
   launches per frame in its trace.
4. Runs the first 96 frames again on the CPU (plain path) and holds the
   card's per-frame decisions and poses against it.
5. The HD deployment through the command line: writes a synthetic
   1200×1600 dataset (``heading_loop_path`` with sensor noise, u8 frames in
   a NISF file, no PNGs) with a config that takes every field of
   ``configs/config_HD.yaml`` (720×480 polar grid, ``coarse_scale: 4``,
   bf16 bank without cached filters or images, 1024 keyframe slots, 4096
   edges) and changes only the paths and the texture-dependent thresholds
   and distances, then runs ``python -m nislam_torch run --device cuda``
   on it in this process: a short warm-up, then the timed run with
   ``--save-state``.  Checks every frame tracked, ATE, loops, solves, the
   kernel's launches and the trajectory files; prints frames/s.
6. Resumes from that checkpoint (``--load-state``).
7. Step mode on the HD set (``--mode step --max-frames 64``): p50 and p90
   per-frame latency.  Then a profiled scan over 64 HD frames
   (``--profile``): the device's busy share within that one trace and the
   kernel launches per frame.
8. The inline solve and the online stitcher (``store_images: true``) at
   the flagship size over a 96-frame loop, card against CPU: decisions
   equal, poses within 2e-3, the online canvas equal to ``recompute`` of
   the bank on the card; against the CPU's scatter of the same bank, all
   but 1 % of the cells equal; against both it and the CPU's own canvas,
   the same pixel count and intensity total.  A second pass on the card
   must give the same canvas, outputs and poses bit for bit.  Then
   ``nislam_torch.scripts.stepbench --size 640`` over 200 frames: p50, p90,
   p99 and max per-frame latency of the deferred and the inline step,
   beside the dispatch+fence floor.

9. ``sum_only``: the kernel against ``torch.sum`` at (1200, 1600),
   (480, 640), (8, 2, 1200, 1600), a ragged (20, 130) and a constant
   array, within 1e-5 of Σ|x|, and bit for bit against itself; then
   pkbench's interleaved A/B (``nislam_torch.scripts.pkbench``): µs per
   launch of each variant, ``torch.sum``'s, the HBM bound and its share.
10. The models: ``KCCRegistration.register`` and ``register_batch`` on
    the card against the CPU; inside phase 5, while the HD set exists,
    ``python -m nislam_torch eval --model vo`` and ``--model slam`` over it
    (tracked_frac 1.0; for slam ATE < 0.02 m and ≥ 1 loop; vo's raw
    odometry, with no loop closure, is held below 0.1 m).
11. The batch engine: 8 lanes of the flagship config, each its own world,
    through ``make_batch_engine(config, 8, cuda)``, ``run_sequences`` and
    ``finalize``: every lane tracks every frame with ATE < 0.02 m, loops
    and solves happen, and lanes 0 and 7 equal single-engine runs of their
    sequences on the card.  Prints aggregate lane-frames/s and one lane's
    frames/s through the single engine.
12. Multi-rank on the one card (``nislam_torch.parallel``).  a: one rank
    over NCCL on ``cuda:0``: the distributed engine over the first 128
    flagship frames equals phase 3 (decisions; poses within 5e-3, GN-CG
    against dense LM), and the sharded search on a loop frame equals
    ``find_loop_closure``.  d (same group): ms per solve of dense LM and
    GN-CG on the flagship's final graph (K = 272, within 2e-3) and on a
    K = 1024 / E = 4096 chain; two GN-CG solves of one graph must give the
    same poses, cost and CG iteration count.  b: two spawned ranks sharing the card over
    gloo with CUDA tensors (NCCL needs a card per rank): the flagship at
    full width, 272 slots split 136 + 136, 4 candidates per rank, the 512
    frames read from a ``.npy`` this process writes; both ranks equal, with
    phase 3's decisions, poses within 5e-3, ATE < 0.02 m, ≥ 1 loop and
    solve, ``peak_stats`` at (4, 2, 480, 640) on each rank; frames/s per
    rank and collective bytes per frame.  c: the same two ranks as a fleet
    on lanes 0 and 7 of phase 11, each equal to phase 11's single-engine
    run of its lane (poses within 2e-3).  e: the same two ranks run the
    online stitcher on stored images through the distributed engine, over
    lane 0 of phase 11 with a ring of 32 slots that evicts: both ranks'
    canvases equal bit for bit; decisions equal to a single-engine run of
    the same config (inline off), poses within 5e-3; pixel count and
    intensity total equal to its canvas (within 1e-5); the canvas equal to
    a fresh recompute; one all-reduce per eviction and per recompute, whose
    bytes it prints.  Two ranks on one card measure the sharded path's
    overhead, not scaling.

Every phase prints its time, and the script its total.  Prints one JSON line of per-kernel results,
then, as the last line, ``{"ok": true, "device": {...}}``.  Exits non-zero
at the first failed check, and when no CUDA device is available.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

N_FRAMES = 512
CHUNK = 128
N_CPU_FRAMES = 96
N_HD_FRAMES = 192
N_STEP_FRAMES = 64
N_PROFILE_FRAMES = 64
N_OPTION_FRAMES = 96
N_BATCH = 8
N_BATCH_FRAMES = 256
BATCH_CHUNK = 64
N_DIST_FRAMES = 128  # phase 12a: the first chunk of the flagship
N_STEPBENCH_FRAMES = 200
# 12e: the online canvas over two ranks, on lane 0 of phase 11 (256 frames
# that close a loop) with a ring of 32 slots, which that lane overflows.
CANVAS_SLOTS = 32
RANKS = 2
RANK_TIMEOUT_S = 420
# 12a's backend: NCCL, one rank on the card.  12b/c's ranks share the card,
# which NCCL cannot (one GPU per rank): they use gloo with CUDA tensors.
ONE_RANK_BACKEND = "nccl"
SHARED_CARD_BACKEND = "gloo"
DIST_POSE_ATOL = 5e-3  # GN-CG against dense LM
SUM_RTOL = 1e-5  # sum / sumsq: f32 sums in another order than torch.sum
POSE_ATOL = 2e-3
# Two canvases that hold the same pixels: intensity totals summed in
# another order (phase 8, 12e).
CANVAS_RTOL = 1e-5
REPS = 100  # launches per many-launch timing
# Phase 2b: scatter_add cases whose runs all have one length.
RUN_LENGTHS = (1, 31, 32, 33, 1000, 100_000)
STITCH_REPS = 20  # stitcher ops, and scatter plans, per many-launch timing
ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def host_syncs(fn) -> int:
    """The synchronizing CUDA calls that one call of ``fn`` makes, as
    ``torch.cuda``'s sync debug mode reports them (a prototype that does
    not see every kind)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) and "prototype" not in str(w.message) for w in seen)


def kernel_times(fn, plain, x) -> dict:
    """Device ms per launch of the kernel ``fn`` and of its ``plain``
    version on ``x`` (many launches, cold inputs), and the kernel's ms per
    call with the host's share."""
    from nislam_torch.utils.profiling import call_ms, cold_copies, device_ms_per_launch

    inputs = cold_copies(x, REPS)
    return {
        "ms": device_ms_per_launch(fn, inputs, REPS),
        "plain_ms": device_ms_per_launch(plain, inputs, REPS),
        "call_ms": call_ms(lambda: fn(x)),
    }


def kernel_cases(dev: torch.device):
    """(label, response) pairs: path shapes with random data, then ties."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [
        (360, 480), (480, 640), (8, 360, 480), (8, 2, 480, 640),
        # a rank's share of the flagship's loop search over 2 ranks
        (4, 360, 480), (4, 2, 480, 640),
        (1200, 1600), (8, 2, 1200, 1600), (20, 130),
        # the HD coarse-to-fine loop search: two hypotheses of 8 candidates
        # at 1/4 resolution, then the winner's two at full resolution
        (8, 2, 300, 400), (2, 1200, 1600),
    ]
    for shape in shapes:
        yield str(shape), torch.randn(shape, generator=gen, device=dev)
    # Equal maxima: within one row, and in row bands far apart (different
    # pass-1 blocks).  Column-major first wins: (300, 0) before (5, 1), and
    # (2, 1) before (2, 3).
    t = torch.zeros((480, 640), device=dev)
    t[5, 1] = t[300, 0] = t[2, 3] = t[2, 1] = 7.0
    yield "ties (480, 640)", t
    t = torch.zeros((1200, 1600), device=dev)
    t[10, 5] = t[1100, 4] = 3.0
    yield "ties (1200, 1600)", t
    t = torch.zeros((8, 2, 480, 640), device=dev)
    t[3, 1, 400, 9] = t[3, 1, 7, 9] = t[3, 1, 7, 10] = 2.0
    yield "ties (8, 2, 480, 640)", t
    t = torch.full((20, 130), -1.0, device=dev)
    t[19, 0] = t[0, 129] = 5.0
    yield "ties (20, 130)", t
    t = torch.zeros((300, 400), device=dev)
    t[10, 7] = t[299, 3] = t[250, 3] = 4.0  # column-major first: (250, 3)
    yield "ties (300, 400)", t


def check_fused(got, shape, label: str) -> None:
    """The kernel's ``trans`` and ``psr`` against the plain arithmetic
    (``registration_epilogue`` on the CPU: IEEE f32, one operation at a
    time) applied to the kernel's own four statistics: equal bit for bit."""
    from nislam_torch.ops.peak_stats import registration_epilogue

    trans, info, *stats = (t.cpu() for t in got)
    want_trans, want_psr = registration_epilogue(*stats, shape)
    check(trans.shape == want_trans.shape and info.shape == want_psr.shape,
          f"fused outputs have the wrong shape at {label}")
    check(torch.equal(trans.view(torch.int32), want_trans.view(torch.int32)),
          f"fused trans differs from the plain arithmetic at {label}")
    check(torch.equal(info.view(torch.int32), want_psr.view(torch.int32)),
          f"fused psr differs from the plain arithmetic at {label}")


def check_many_launches(dev: torch.device) -> None:
    """1200 back-to-back launches on one stream, alternating two shapes and
    two batch sizes, against each input's first result; then a batch that
    outgrows the workspace, and the first input once more."""
    from nislam_torch.ops.peak_stats import peak_stats_reference, registration_stats

    gen = torch.Generator(device=dev).manual_seed(7)
    inputs = [torch.randn(shape, generator=gen, device=dev)
              for shape in ((480, 640), (8, 2, 480, 640), (360, 480), (8, 360, 480))]
    first = [registration_stats(g, g.shape[-2:], force="kernel") for g in inputs]
    n = 1200
    later = [registration_stats(inputs[i % 4], inputs[i % 4].shape[-2:], force="kernel") for i in range(n)]
    wide = torch.randn((6000, 4, 8), generator=gen, device=dev)  # one block per array: the workspace grows
    got_wide = registration_stats(wide, (4, 8), force="kernel")
    last = registration_stats(inputs[0], (480, 640), force="kernel")
    torch.cuda.synchronize()
    for i, got in enumerate(later + [last]):
        check(all(torch.equal(a, b) for a, b in zip(got, first[i % 4])),
              f"launch {i} of {n} back-to-back launches differs from the first result")
    want = peak_stats_reference(wide)
    check(torch.equal(got_wide[2], want[0]) and torch.equal(got_wide[3], want[1]),
          "peak or argmax differs at (6000, 4, 8)")
    print(f"peak_stats: {n} back-to-back launches over 2 shapes x 2 batch sizes equal the first "
          f"results; (6000, 4, 8) after a workspace growth equal to the plain version")


def check_one_launch_per_call(dev: torch.device) -> dict:
    """A profiled window of 20 calls of each kernel: its trace must hold
    one device kernel per call under each kernel's name, and a call must
    allocate one tensor.  Returns ``{kernel: {name in the trace: count}}``."""
    from nislam_torch.ops.peak_stats import registration_stats
    from nislam_torch.ops.sum_only import sum_only
    from nislam_torch.utils.profiling import kernel_counts, trace

    g = torch.randn((480, 640), device=dev)
    calls = {"peak_stats": lambda: registration_stats(g, (480, 640), force="kernel"),
             "sum_only": lambda: sum_only(g, force="kernel")}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    for name, fn in calls.items():
        before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        for _ in range(10):
            fn()
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - before
        check(allocs == 10, f"{name}: {allocs} allocations in 10 calls, not one per call")
    names = {}
    with tempfile.TemporaryDirectory(prefix="nislam_prof_") as d:
        with trace(d):
            for fn in calls.values():
                for _ in range(20):
                    fn()
            torch.cuda.synchronize()
        for name in calls:
            names[name] = kernel_counts(os.path.join(d, "trace.json"), name)
            check(sum(names[name].values()) == 20 and len(names[name]) == 1,
                  f"{name}: 20 calls show as {names[name]} in the trace, not one kernel per call")
    print(f"one launch and one allocation per call; kernels in a profiled window of 20 calls each: {names}")
    return names


def check_kernel(dev: torch.device) -> dict:
    from nislam_torch.ops.peak_stats import peak_stats, registration_stats
    from nislam_torch.utils.profiling import bound_ms, launch_floor_ms

    floor_ms = launch_floor_ms(REPS)
    print(f"launch floor: an empty kernel takes {1e3 * floor_ms:.2f} us per launch in the many-launch harness")
    worst = 0.0
    times = {}
    for label, g in kernel_cases(dev):
        shape = tuple(g.shape[-2:])
        got = registration_stats(g, shape, force="kernel")
        want = peak_stats(g, force="reference")
        torch.cuda.synchronize()
        check(torch.equal(got[2], want[0]), f"peak differs at {label}")
        check(torch.equal(got[3], want[1]), f"argmax differs at {label}")
        atol = 1e-5 * g.abs().sum(dim=(-2, -1))
        for k, name in ((2, "sum"), (3, "sumsq")):
            err = (got[k + 2] - want[k]).abs()
            check(bool((err <= SUM_RTOL * want[k].abs() + atol).all()), f"{name} differs at {label}")
            worst = max(worst, float(err.max()))
        check_fused(got, shape, label)
        four = peak_stats(g, force="kernel")
        check(all(torch.equal(a, b) for a, b in zip(four, got[2:])),
              f"peak_stats and registration_stats disagree at {label}")
        if not label.startswith("ties") and label != "(20, 130)":
            t = kernel_times(lambda x: peak_stats(x, force="kernel"),
                             lambda x: peak_stats(x, force="reference"), g)
            # Reads each value once, writes 32 bytes per response; a max,
            # an add and a multiply-add per value.
            n_resp = g.numel() // (g.shape[-2] * g.shape[-1])
            t["bound_ms"], t["bound_by"] = bound_ms(4 * g.numel() + 32 * n_resp, 4 * g.numel())
            times[label] = t
            print(f"peak_stats {label}: kernel {1e3 * t['ms']:.2f} us per launch "
                  f"(bound {1e3 * t['bound_ms']:.2f} us by {t['bound_by']}, share "
                  f"{t['bound_ms'] / t['ms']:.3f}; launch floor {1e3 * floor_ms:.2f} us, share of "
                  f"max(bound, floor) {max(t['bound_ms'], floor_ms) / t['ms']:.3f}), plain "
                  f"{1e3 * t['plain_ms']:.2f} us per launch; "
                  f"per call, host included: {1e3 * t['call_ms']:.2f} us")
        print(f"peak_stats {label}: equal to the plain version; fused trans and psr equal, bit for "
              f"bit, the plain arithmetic on the kernel's statistics")
    check_many_launches(dev)
    return {"max_abs_err": worst, "times": times, "floor_ms": floor_ms,
            "trace_names": check_one_launch_per_call(dev)}


def check_scatter_add(dev: torch.device, floor_ms: float) -> dict:
    """Phase 2b: the ``scatter_add`` kernel at the solvers' shapes, a
    ragged case and runs of every length in :data:`RUN_LENGTHS`
    (``nislam_torch.scripts.kernel_ab.scatter_cases``) against its
    plain version (``index_add_``) on CPU copies of the same inputs, bit
    for bit, and against itself on a second run; a bad key reported;
    device µs per launch over cold inputs, beside the launch floor, the
    bound, the plan (``torch.sort`` of the keys and the run table), the
    plain version and ``index_add_`` on the card (the library call; the
    port never makes it on the card), and µs per call with the host."""
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.scripts.kernel_ab import scatter_bound_bytes, scatter_cases, scatter_inputs
    from nislam_torch.utils.profiling import bound_ms, call_ms, device_ms_per_launch

    t0 = time.perf_counter()
    rows = {}
    for label, out, keys, src in scatter_cases(dev, RUN_LENGTHS):
        t_case = time.perf_counter()
        plan = sa.ScatterPlan.of(keys)
        got = sa.index_add_ordered(out.clone(), plan, src, force="kernel")
        again = sa.index_add_ordered(out.clone(), plan, src, force="kernel")
        want = sa.index_add_reference(out.cpu(), keys.cpu(), src.cpu())
        sa.raise_on_bad_keys(dev)
        check(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)),
              f"scatter_add differs from the plain version at {label}")
        err = float((got.cpu() - want).abs().max())
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)), f"scatter_add repeats no bits at {label}")
        inputs = scatter_inputs(out, plan, src, REPS)
        c = out.shape[1] if out.dim() == 2 else 1
        distinct = int(torch.unique(keys).numel())
        r = {
            "ms": device_ms_per_launch(lambda x: sa.index_add_ordered(x[0], x[1], x[2], force="kernel"), inputs, REPS),
            "plan_ms": device_ms_per_launch(lambda x: sa.ScatterPlan.of(x[1].keys), inputs, STITCH_REPS),
            "library_ms": device_ms_per_launch(lambda x: x[0].index_add_(0, x[1].keys, x[2]), inputs, REPS),
            "call_ms": call_ms(lambda: sa.index_add_ordered(out, plan, src, force="kernel")),
            "n": keys.numel(), "channels": c, "distinct": distinct, "max_abs_err": err,
        }
        r["plain_ms"] = r["library_ms"]  # the plain version is index_add_ itself
        r["plan_syncs"] = host_syncs(lambda: sa.index_add_ordered(out.clone(), sa.ScatterPlan.of(keys), src))
        r["bound_ms"], r["bound_by"] = bound_ms(scatter_bound_bytes(out, keys), keys.numel() * c)
        rows[label] = r
        print(f"scatter_add {label}: N={keys.numel()}, {distinct} distinct keys; equal to the plain version "
              f"on the CPU bit for bit and to itself | kernel {1e3 * r['ms']:.2f} us per launch (bound "
              f"{1e3 * r['bound_ms']:.3f} us by {r['bound_by']}, share {r['bound_ms'] / r['ms']:.3f}; launch "
              f"floor {1e3 * floor_ms:.2f} us), per call with the host {1e3 * r['call_ms']:.2f} us | plan "
              f"(torch.sort + run table) {1e3 * r['plan_ms']:.2f} us, host syncs of plan and launch "
              f"{r['plan_syncs']} | plain version = library index_add_ "
              f"(atomics) {1e3 * r['library_ms']:.2f} us | {time.perf_counter() - t_case:.1f} s")
    bad = torch.zeros((8, 3), device=dev)
    sa.index_add_ordered(bad, torch.tensor([1, 9, 2, -4], device=dev), torch.ones((4, 3), device=dev))
    try:
        sa.raise_on_bad_keys(dev)
        reported = False
    except IndexError:
        reported = True
    check(reported, "scatter_add: keys 9 and -4 of 8 rows were not reported")
    want = torch.zeros((8, 3))
    want[1] = want[2] = 1.0
    check(torch.equal(bad.cpu(), want), "scatter_add: a bad key was written, or a good one lost")
    sa.raise_on_bad_keys(dev)  # the report was taken
    print(f"scatter_add: keys outside [0, 8) reported and never written | {time.perf_counter() - t0:.1f} s")
    return rows


def stitch_cases():
    """(label, (H, W), canvas size, poses, enabled, sign): the stitcher's
    calls at the path shapes.  An insert at 480×640 on a 4096² canvas and
    at 1200×1600 on an 8192² one (configs/config_geekplus.yaml,
    config_HD.yaml), the retire of an insert that evicts nothing (its
    device flag off), a negated insert, a frame centred on the image-plane
    origin, where the cells along x = 0 and y = 0 are two pixels wide, and
    one recompute batch of 16 frames at each size, partly off the canvas."""
    n = 16
    path = [[2.2 * np.cos(a), 1.6 * np.sin(a), a] for a in np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)]
    yield "insert 480x640 on 4096^2", (480, 640), 4096, [0.31, -0.17, 0.6], True, 1.0
    yield "insert 1200x1600 on 8192^2", (1200, 1600), 8192, [0.31, -0.17, 0.6], True, 1.0
    yield "retire, nothing evicted, 480x640 on 4096^2", (480, 640), 4096, [0.31, -0.17, 0.6], False, -1.0
    yield "negated insert, 480x640 on 4096^2", (480, 640), 4096, [-0.42, 0.25, 2.2], True, -1.0
    yield "straddling x = 0 and y = 0, 1200x1600 on 8192^2", (1200, 1600), 8192, [0.0003, -0.0002, 0.7], True, 1.0
    yield f"recompute batch {n} x 480x640 on 2048^2", (480, 640), 2048, path, True, 1.0
    yield f"recompute batch {n} x 1200x1600 on 8192^2", (1200, 1600), 8192, path, True, 1.0


def check_stitch_raster(dev: torch.device, floor_ms: float) -> dict:
    """Phase 2b: the ``stitch_raster`` kernel at every stitcher case
    (:func:`stitch_cases`), on canvases that already hold values, against
    its plain version: the flat targets and values computed on the card,
    copied to the CPU and added there by ``index_add_``, bit for bit; and
    against itself on a second run, with one launch per frame.  Then, over
    frames that cycle through shifted poses (cold inputs): device µs of the
    kernel's launches alone and of the whole op (frame constants, then the
    launches; what ``core/stitcher.py`` runs), beside the op as it was
    before (targets, the plan's sort and run table, two ``scatter_add``
    launches), the plain version on the card (targets and two
    ``index_add_``), and ``index_add_`` twice on ready targets (the library
    call); and one whole op per call with the host."""
    from nislam_torch.core.camera import make_camera_ops
    from nislam_torch.core.config import CameraConfig
    from nislam_torch.core.stitcher import StitchCanvas, _frame_constants, _scatter, flat_targets
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.ops import stitch_raster as sr
    from nislam_torch.utils.profiling import COLD_BYTES, bound_ms, call_ms, device_ms_per_launch

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    for label, (h, w), s, pose, enabled, sign in stitch_cases():
        cam = make_camera_ops(CameraConfig(image_width=w, image_height=h, height=1.0,
                                           intrinsics=(float(w), w / 2.0, float(w), h / 2.0))).to(dev)
        poses = torch.tensor(pose, dtype=torch.float32, device=dev)
        f = poses.numel() // 3
        lead = poses.shape[:-1]
        en = torch.tensor(enabled, device=dev) if not enabled or sign < 0 else True  # a retire's device flag
        # The plain version and the op it replaced take the flag as a device
        # tensor made once: from a host bool they copy it to the card at
        # every call, which waits for the device.
        en_t = en if isinstance(en, torch.Tensor) else torch.tensor(en, device=dev)
        data0 = torch.rand((s, s), generator=gen, device=dev) * 100.0
        weight0 = torch.randint(0, 4, (s, s), generator=gen, device=dev).float()
        images = torch.rand(lead + (h, w), generator=gen, device=dev)
        canvas = StitchCanvas(data0.clone(), weight0.clone())
        idx, ok = flat_targets(canvas, (h, w), poses, cam, en_t)
        vals = torch.where(ok, images * (sign * 100.0), 0.0).reshape(-1)
        wts = (sign * ok.to(torch.float32)).reshape(-1)
        want_d = sa.index_add_reference(data0.cpu().view(-1), idx.cpu().reshape(-1), vals.cpu())
        want_w = sa.index_add_reference(weight0.cpu().view(-1), idx.cpu().reshape(-1), wts.cpu())
        got = []
        for _ in range(2):
            c = StitchCanvas(data0.clone(), weight0.clone())
            before = sr.stitch_raster.launches
            syncs = host_syncs(lambda: _scatter(c, images, poses, cam, en, sign))
            check(syncs == 0, f"stitch_raster: the op at {label} waits for the device {syncs} times")
            check(sr.stitch_raster.launches - before == f, f"stitch_raster: not one launch per frame at {label}")
            got.append(c)
        torch.cuda.synchronize()
        check(same_bits([got[0].data.cpu().view(-1), got[0].weight.cpu().view(-1)], [want_d, want_w]),
              f"stitch_raster differs from the plain version at {label}")
        check(same_bits([got[0].data, got[0].weight], [got[1].data, got[1].weight]),
              f"stitch_raster repeats no bits at {label}")
        err = max(float((got[0].data.cpu().view(-1) - want_d).abs().max()),
                  float((got[0].weight.cpu().view(-1) - want_w).abs().max()))
        touched = int(torch.unique(idx[ok]).numel())
        del got, want_d, want_w

        # Cold inputs: frames at poses shifted over a grid of 0.15 m steps.
        n_var = int(min(16, max(2, -(-COLD_BYTES // (4 * images.numel())))))
        step = torch.tensor([0.15, 0.15, 0.0], device=dev)
        var = []
        for v in range(n_var):
            p = poses + step * torch.tensor([v % 6 - 2.5, v // 6 - 2.5, 0.0], device=dev)
            im = torch.rand(images.shape, generator=gen, device=dev)
            i, o = flat_targets(canvas, (h, w), p, cam, en_t)
            var.append(SimpleNamespace(poses=p, images=im, consts=_frame_constants(p, cam), idx=i.reshape(-1),
                                       vals=torch.where(o, im * (sign * 100.0), 0.0).reshape(-1),
                                       wts=(sign * o.to(torch.float32)).reshape(-1)))
        center = (canvas.center_x, canvas.center_y)

        def old_op(v):
            i, o = flat_targets(canvas, (h, w), v.poses, cam, en_t)
            plan = sa.ScatterPlan.of(i)
            sa.index_add_ordered(canvas.data.view(-1), plan, torch.where(o, v.images * (sign * 100.0), 0.0).reshape(-1),
                                 force="kernel")
            sa.index_add_ordered(canvas.weight.view(-1), plan, (sign * o.to(torch.float32)).reshape(-1), force="kernel")

        def library(v):
            canvas.data.view(-1).index_add_(0, v.idx, v.vals)
            canvas.weight.view(-1).index_add_(0, v.idx, v.wts)

        timed = {
            "ms": lambda v: sr.stitch_raster(canvas.data, canvas.weight, v.images, v.consts, en, sign * 100.0, sign,
                                             center, force="kernel"),
            "op_ms": lambda v: _scatter(canvas, v.images, v.poses, cam, en, sign),
            "old_op_ms": old_op,
            "plan_ms": lambda v: sa.ScatterPlan.of(v.idx),
            "plain_ms": lambda v: sr.stitch_raster(canvas.data, canvas.weight, v.images, v.consts, en_t,
                                                   sign * 100.0, sign, center, force="reference"),
            "library_ms": library,
        }
        r = {name: device_ms_per_launch(fn, var, STITCH_REPS) for name, fn in timed.items()}
        r["call_ms"] = call_ms(lambda: _scatter(canvas, var[0].images, var[0].poses, cam, en, sign))
        r["old_op_syncs"] = host_syncs(lambda: old_op(var[0]))
        # The frames read once, each touched cell's data and weight read
        # and written once, the targets' eight operations per pixel; a
        # disabled frame needs its flag alone.
        if touched:
            r["bound_ms"], r["bound_by"] = bound_ms(4 * images.numel() + 16 * touched, 8 * images.numel())
        else:
            r["bound_ms"], r["bound_by"] = bound_ms(f)
        r.update(frames=f, touched=touched, max_abs_err=err, launches_per_op=f)
        rows[label] = r
        del var, canvas, data0, weight0, images, idx, ok, vals, wts
        us = {k: 1e3 * v for k, v in r.items() if k == "ms" or k.endswith("_ms")}
        print(f"stitch_raster {label}: {f} frame(s), {touched} cells touched; equal to the plain version on the "
              f"CPU (the card's targets and values) bit for bit and to itself, {f} launch(es) per op | kernel "
              f"{us['ms']:.2f} us (bound {us['bound_ms']:.3f} us by {r['bound_by']}, share "
              f"{r['bound_ms'] / r['ms']:.3f}; launch floor {1e3 * floor_ms:.2f} us) | whole op {us['op_ms']:.2f} "
              f"us, per call with the host {us['call_ms']:.2f} us | before: targets + sort + 2 scatter_add "
              f"{us['old_op_ms']:.2f} us (plan alone {us['plan_ms']:.2f}; host syncs {r['old_op_syncs']}) | plain "
              f"(targets + 2 index_add_) "
              f"{us['plain_ms']:.2f} us | library 2 x index_add_ on ready targets {us['library_ms']:.2f} us")
    print(f"stitch_raster: {time.perf_counter() - t0:.1f} s")
    return rows


@contextlib.contextmanager
def recorded_solves():
    """The final cost of every dense LM solve that the engine makes inside
    the block, in order (``core/slam.py``'s ``solve_pose_graph``, wrapped)."""
    import nislam_torch.core.slam as slam

    real, costs = slam.solve_pose_graph, []

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        costs.append(out[2].clone())
        return out

    slam.solve_pose_graph = recording
    try:
        yield costs
    finally:
        slam.solve_pose_graph = real


@contextlib.contextmanager
def recorded_runs():
    """The longest run of equal keys in every scatter plan made inside the
    block (``ScatterPlan.of``, wrapped: two per dense LM solve, H and g;
    one per GN-CG solve), in order, read once the block ends: how often the
    solvers give ``scatter_add`` a run longer than a warp."""
    from nislam_torch.ops.scatter_add import ScatterPlan

    real, longest = ScatterPlan.__dict__["of"], []

    def recording(cls, keys):
        plan = real.__func__(cls, keys)
        if plan.run_end is not None and plan.keys.numel() > 0:
            # run_end holds a run's end at its start and 0 elsewhere.
            longest.append((plan.run_end - torch.arange(plan.keys.numel(), device=plan.keys.device)).max())
        return plan

    ScatterPlan.of = classmethod(recording)
    runs = []
    try:
        yield runs
    finally:
        ScatterPlan.of = real
        runs.extend(int(x) for x in longest)


def runs_line(runs) -> str:
    """The longest runs of :func:`recorded_runs`, summed up."""
    runs = [int(r) for r in runs]
    return (f"longest run of equal keys per scatter plan: max {max(runs, default=0)} over {len(runs)} plans, "
            f"{sum(r > 32 for r in runs)} of them over 32 (counts by length "
            f"{dict(sorted(collections.Counter(runs).items()))})")


def same_bits(a, b) -> bool:
    """Two tensors or arrays (or lists of them) equal bit for bit."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def flagship_config():
    from nislam_torch.core.config import (
        CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig,
        MapConfig, SlamConfig, derive_response_thresholds,
    )

    h, w, rd, rc = 480, 640, 720, 480
    step_px = 8.0
    px = 1.0 / w
    thr = derive_response_thresholds(w, h, rd, rc)
    return SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=rd, rotation_channel=rc),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=10.0 * step_px * px, max_angle=0.05236,
            lower_response_thr=thr["lower_response_thr"],
            upper_response_thr=thr["upper_response_thr"],
            lower_rotation_response_thr=thr["lower_rotation_response_thr"],
            upper_rotation_response_thr=thr["upper_rotation_response_thr"],
        ),
        map=MapConfig(
            grid_scale=0.3 * h * px, keyframe_capacity=max(256, N_FRAMES // 2 + 16),
            edge_capacity=2 * N_FRAMES, store_images=False, cache_filters=True,
            bank_dtype="bf16",
        ),
        loop_closure=LoopClosureConfig(
            position_response_thr=thr["position_response_thr"],
            angle_response_thr=thr["angle_response_thr"],
            frame_gap_thr=30, distance_thr=16 * step_px * px, max_candidates=8,
            coarse_scale=1,
        ),
        camera=CameraConfig(image_width=w, image_height=h, height=1.0,
                            intrinsics=(float(w), w / 2.0, float(w), h / 2.0)),
    )


def flagship_frames():
    from nislam_torch.utils.synthetic import (
        add_sensor_noise, heading_loop_path, make_world, render_sequence,
    )

    world_n, step_px, w = 4096, 8.0, 640
    world = make_world(world_n, 3.0)
    poses = heading_loop_path(N_FRAMES, step=step_px, start=(world_n / 2.0, world_n / 2.0))
    frames = add_sensor_noise(render_sequence(world, 480, w, poses))
    gt = np.array([(p[0] - world_n / 2.0, p[1] - world_n / 2.0) for p in poses]) / w
    return frames, gt


def run_slice(engine, frames_d):
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), frames_d, chunk_frames=CHUNK,
                                      solve_tally=tally)
    state, ran = engine.finalize(state)
    return state, outs, sum(tally) + int(ran)


def profile_flagship(engine, frames_d, ps) -> float:
    """A profiled scan over the flagship's first frames: prints the busy
    share within the trace and returns its kernel launches per frame."""
    from nislam_torch.utils.profiling import device_activity, kernel_counts, trace

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nislam_prof_") as d:
        torch.cuda.synchronize()
        calls = ps.peak_stats.launches
        with trace(d):
            engine.run_sequence(engine.init_state(), frames_d[:N_PROFILE_FRAMES], chunk_frames=CHUNK)
            torch.cuda.synchronize()
        calls = ps.peak_stats.launches - calls
        act = device_activity(os.path.join(d, "trace.json"))
        names = kernel_counts(os.path.join(d, "trace.json"), "peak_stats")
    check(act["busy_ms"] > 0, "flagship profile: no device activity in the trace")
    check(sum(names.values()) == calls and len(names) == 1,
          f"flagship profile: {calls} peak_stats calls show as {names} in the trace")
    print(f"flagship profiled scan over {N_PROFILE_FRAMES} frames: device busy {act['busy_ms']:.1f} ms of "
          f"the trace's {act['window_ms']:.1f} ms window = busy share {act['busy_share']:.4f} (under the "
          f"profiler) | {act['launches'] / N_PROFILE_FRAMES:.0f} kernel launches per frame | {calls} "
          f"peak_stats calls, one kernel each | {time.perf_counter() - t0:.1f} s")
    return act["launches"] / N_PROFILE_FRAMES


def run_cli(argv) -> str:
    """``python -m nislam_torch`` in this process; prints and returns its
    output (without the per-frame lines of step mode)."""
    from nislam_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        if "processing for one frame" not in line and "Insert a keyframe" not in line:
            print(f"  | {line}")
    check(rc == 0, f"nislam_torch {' '.join(argv[:1])} exited {rc}")
    return out


RUN_LINE = re.compile(
    r"(\d+) frames in ([\d.]+)s = ([\d.]+) frames/s \| tracked (\d+)/\d+ \| keyframes (\d+) "
    r"\| edges \d+ \| loops (\d+) \| optimized (\d+)x"
)


def parse_run(out: str) -> dict:
    m = RUN_LINE.search(out)
    check(m is not None, "no summary line in the CLI's output")
    keys = ("frames", "seconds", "fps", "tracked", "keyframes", "loops", "solves")
    vals = dict(zip(keys, (float(x) if "." in x else int(x) for x in m.groups())))
    ate = re.search(r"ATE RMSE \(optimized keyframes\): ([\d.]+) m", out)
    vals["ate"] = float(ate.group(1)) if ate else None
    return vals


def write_hd_dataset(root: str) -> str:
    """A synthetic HD sequence at ``root`` (names, times, ground truth,
    camera, u8 NISF frames) and its config; returns the config path.

    The config is ``configs/config_HD.yaml`` with the dataset paths, the
    saving root and the texture-dependent thresholds and distances
    replaced, sized as ``nislam_torch.io.synth_dataset`` sizes them."""
    import yaml

    from nislam_torch.core.config import load_config
    from nislam_torch.io.synth_dataset import synthetic_sizing
    from nislam_torch.io.trajectory import write_tum
    from nislam_torch.utils.synthetic import add_sensor_noise, heading_loop_path, make_world, render_frame

    with open(os.path.join(ROOT, "configs", "config_HD.yaml")) as f:
        node = yaml.safe_load(f)
    cf = node["correlation_flow"]
    h, w = cf["height"], cf["width"]
    world_n = 1 << int(np.ceil(np.log2(4 * max(h, w))))
    # Steps of w/16 as the synthetic dataset writer takes; fx = width and
    # the camera 1 m above the floor, so one pixel is 1/w m.
    step_px, px = w / 16.0, 1.0 / w
    start = (world_n / 2.0, world_n / 2.0)
    poses = heading_loop_path(N_HD_FRAMES, step=step_px, start=start)
    world = make_world(world_n, 3.0, seed=11)
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        frames = np.stack(list(ex.map(lambda p: render_frame(world, h, w, *p), poses)))
    frames = (np.clip(add_sensor_noise(frames), 0.0, 1.0) * 255.0).astype(np.uint8)
    times = np.arange(N_HD_FRAMES) / 30.0

    with open(os.path.join(root, "frames.nisf"), "wb") as f:
        f.write(struct.pack("<4sIIII", b"NISF", 2, N_HD_FRAMES, h, w))  # v2: u8 frames
        f.write(times.astype("<f8").tobytes())
        f.write(frames.tobytes())
    with open(os.path.join(root, "image_names.txt"), "w") as f:
        f.write("".join(f"{i:06d}.png\n" for i in range(N_HD_FRAMES)))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("".join(f"{t:.6f}\n" for t in times))
    gt = np.array([((p[0] - start[0]) * px, (p[1] - start[1]) * px, p[2]) for p in poses])
    write_tum(os.path.join(root, "groundtruth.txt"), times, gt)
    camera = os.path.join(root, "camera.yaml")
    with open(camera, "w") as f:
        yaml.safe_dump({
            "image_size": [w, h], "height": 1.0, "accurate_height": True,
            "intrinsics": {"data": [float(w), w / 2.0, float(w), h / 2.0]},
            "distortion": {"data": [0.0] * 5},
            "extrinsics": {"data": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]},
        }, f)

    sz = synthetic_sizing(w, h, cf["rotation_divisor"], cf["rotation_channel"],
                          N_HD_FRAMES, step_px, px)
    node["dataset"].update(dataroot=root, camera_config=camera)
    kfs = node["keyframe_selection"]
    kfs["max_distance"] = sz["max_distance"]
    for k in ("lower_response_thr", "upper_response_thr", "lower_rotation_response_thr",
              "upper_rotation_response_thr"):
        kfs[k] = sz[k]
    node["map"]["grid_scale"] = sz["grid_scale"]
    lc = node["loop_closure"]
    lc.update(position_response_thr=sz["position_response_thr"],
              angle_response_thr=sz["angle_response_thr"], distance_thr=sz["distance_thr"])
    node["saving"]["saving_root"] = os.path.join(root, "saving")
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(node, f, sort_keys=False)
    c = load_config(path)
    check((c.cf.height, c.cf.width, c.cf.polar_shape) == (1200, 1600, (360, 480))
          and c.loop_closure.coarse_scale == 4 and c.loop_closure.max_candidates == 8
          and c.map.bank_dtype == "bf16" and not c.map.cache_filters and not c.map.store_images
          and (c.map.keyframe_capacity, c.map.edge_capacity) == (1024, 4096),
          f"the HD config lost a field of configs/config_HD.yaml: {c}")
    return path


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_hd(ps, dev) -> dict:
    """Phases 5–7: the HD deployment through the command line."""
    with tempfile.TemporaryDirectory(prefix="nislam_hd_") as root:
        return _run_hd(ps, dev, root)


def _run_hd(ps, dev, root: str) -> dict:
    from nislam_torch.utils.profiling import kernel_counts

    t0 = time.perf_counter()
    cfg = write_hd_dataset(root)
    print(f"HD dataset: {N_HD_FRAMES} frames written in {time.perf_counter() - t0:.1f} s")
    base = ["run", "--config", cfg, "--device", dev.type, "--nisf", os.path.join(root, "frames.nisf")]
    ck = os.path.join(root, "state.npz")

    t0 = time.perf_counter()
    run_cli(base + ["--max-frames", "24", "--saving-root", os.path.join(root, "warm")])
    print(f"HD warm-up run (24 frames): {time.perf_counter() - t0:.1f} s")

    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--groundtruth", os.path.join(root, "groundtruth.txt"),
                          "--save-state", ck, "--saving-root", os.path.join(root, "saving")])
    launches = ps.peak_stats.launches
    hd = parse_run(out)
    print(f"HD via the CLI: {hd['frames']} frames at {hd['fps']} frames/s (the CLI's clock, "
          f"deferred solves and finalize included) | tracked {hd['tracked']} | keyframes "
          f"{hd['keyframes']} | loops {hd['loops']} | solves {hd['solves']} | ATE {hd['ate']} m | "
          f"peak_stats launches {launches} | phase {time.perf_counter() - t0:.1f} s incl. checkpoint")
    check(hd["frames"] == N_HD_FRAMES and hd["tracked"] == N_HD_FRAMES,
          f"HD: tracked {hd['tracked']} of {hd['frames']} frames")
    check(hd["ate"] is not None and hd["ate"] < 0.02, f"HD: ATE {hd['ate']} m >= 0.02 m")
    check(hd["loops"] >= 1, "HD: no loop found")
    check(hd["solves"] >= 1, "HD: no pose-graph solve ran")
    check(launches >= 2 * hd["tracked"], f"HD: {launches} kernel launches < 2 x {hd['tracked']}")
    for name in ("KCC_Keyframe.txt", "optimized_keyframe.txt"):
        path = os.path.join(root, "saving", name)
        with open(path) as f:
            rows = [ln.split() for ln in f if ln.strip()]
        check(len(rows) == hd["keyframes"] and all(np.isfinite(float(v)) for r in rows for v in r),
              f"HD: {name} does not hold {hd['keyframes']} finite keyframe poses")

    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--load-state", ck, "--max-frames", "16",
                          "--saving-root", os.path.join(root, "resume")])
    resume_launches = ps.peak_stats.launches
    check(f"({hd['keyframes']} keyframes)" in out, "HD: the resumed state lost its keyframes")
    print(f"HD resume: {hd['keyframes']} keyframes loaded, 16 frames run | peak_stats launches "
          f"{resume_launches} | {time.perf_counter() - t0:.1f} s")

    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--mode", "step", "--max-frames", str(N_STEP_FRAMES),
                          "--saving-root", os.path.join(root, "step")])
    step_launches = ps.peak_stats.launches
    m = re.search(r"step latency over (\d+) frames: p50 ([\d.]+) ms, p90 ([\d.]+) ms", out)
    check(m is not None and int(m.group(1)) == N_STEP_FRAMES, "HD step mode: no latency line")
    step = parse_run(out)
    check(step["tracked"] == N_STEP_FRAMES, f"HD step mode: tracked {step['tracked']}")
    check(step_launches >= 2 * step["tracked"], f"HD step mode: {step_launches} launches")
    print(f"HD step mode: {N_STEP_FRAMES} frames, per-frame latency p50 {m.group(2)} ms, "
          f"p90 {m.group(3)} ms | peak_stats launches {step_launches} | "
          f"{time.perf_counter() - t0:.1f} s")

    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--max-frames", str(N_PROFILE_FRAMES), "--profile", os.path.join(root, "prof"),
                          "--saving-root", os.path.join(root, "prof_out")])
    prof_launches = ps.peak_stats.launches
    b = re.search(r"profiled window ([\d.]+) ms: device busy ([\d.]+) ms \(share ([\d.]+)\), "
                  r"(\d+) kernel launches", out)
    check(b is not None and float(b.group(2)) > 0, "HD profile: no device activity in the trace")
    check(prof_launches >= 2 * N_PROFILE_FRAMES, f"HD profile: {prof_launches} launches")
    names = kernel_counts(os.path.join(root, "prof", "trace.json"), "peak_stats")
    check(sum(names.values()) == prof_launches and len(names) == 1,
          f"HD profile: {prof_launches} peak_stats calls show as {names} in the trace")
    print(f"HD profiled scan over {N_PROFILE_FRAMES} frames: device busy {b.group(2)} ms of the "
          f"trace's {b.group(1)} ms window = busy share {b.group(3)} (under the profiler) | "
          f"{int(b.group(4)) / N_PROFILE_FRAMES:.0f} kernel launches per frame | {prof_launches} "
          f"peak_stats calls, kernels in the trace: {names} | {time.perf_counter() - t0:.1f} s")

    # --- 10b. the models layer's eval over the same set ------------------
    sync(dev)
    ps.peak_stats.launches = 0
    evals = run_eval(root, cfg, dev)
    eval_launches = ps.peak_stats.launches
    check(eval_launches >= 4 * N_HD_FRAMES, f"eval: {eval_launches} kernel launches")
    return {"launches": launches + resume_launches + step_launches + prof_launches + eval_launches,
            **hd, "step_p50_ms": float(m.group(2)), "step_p90_ms": float(m.group(3)), "evals": evals,
            "launches_per_frame": int(b.group(4)) / N_PROFILE_FRAMES}


def option_frames(h: int, w: int):
    """A 96-frame loop that closes early (steps of w/23 px): a 24-frame
    tail back over the start gives loops on consecutive keyframes, then the
    keyframe that finds none fires the inline solve."""
    from nislam_torch.utils.synthetic import add_sensor_noise, heading_loop_path, make_world, render_sequence

    world_n = 4 * w
    poses = heading_loop_path(N_OPTION_FRAMES, step=w / 23.0, start=(world_n / 2.0, world_n / 2.0),
                              tail=24)
    frames = add_sensor_noise(render_sequence(make_world(world_n, 3.0, seed=5), h, w, poses))
    return frames, [(p[0] - world_n / 2.0, p[1] - world_n / 2.0) for p in poses]


def option_config(config, offsets):
    """``config`` with ``optimizer.inline`` and the online stitcher on
    stored keyframe images, the canvas sized and centred to the path as the
    synthetic dataset writer does."""
    import dataclasses

    xs, ys = [p[0] for p in offsets], [p[1] for p in offsets]
    extent = max(max(xs) - min(xs), max(ys) - min(ys)) + 2 * config.cf.width
    size = int(-(-extent // 1024) * 1024)
    center = (int(round((max(xs) + min(xs)) / 2)), int(round((max(ys) + min(ys)) / 2)))
    return dataclasses.replace(
        config,
        map=dataclasses.replace(config.map, store_images=True),
        optimizer=dataclasses.replace(config.optimizer, inline=True),
        map_stitcher=dataclasses.replace(config.map_stitcher, online=True, canvas_size=size,
                                         canvas_center=center),
    )


def run_options(ps, dev) -> tuple:
    """Phase 8: inline solve and online stitcher, card against CPU, and
    the same pass again on the card, bit for bit → (peak_stats launches,
    scatter_add launches, stitch_raster launches) of the first pass."""
    from nislam_torch.core.slam import make_engine, pack_outputs
    from nislam_torch.core.stitcher import make_canvas, recompute
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.ops import stitch_raster as sr

    t0 = time.perf_counter()
    config = flagship_config()
    frames, offsets = option_frames(config.cf.height, config.cf.width)
    config = option_config(config, offsets)
    engine = make_engine(config, dev)
    frames_d = torch.from_numpy(frames).to(dev)
    engine.run_sequence(engine.init_state(), frames_d[:8], chunk_frames=CHUNK)  # warm-up
    sync(dev)
    ps.peak_stats.launches = 0
    sa.index_add_ordered.launches = 0
    sr.stitch_raster.launches = 0
    gstate, gouts = engine.run_sequence(engine.init_state(), frames_d, chunk_frames=CHUNK)
    gstate, _ = engine.finalize(gstate)
    sync(dev)
    launches = ps.peak_stats.launches
    sa_launches = sa.index_add_ordered.launches
    sr_launches = sr.stitch_raster.launches
    check(sa_launches > 0, "inline/online: the solves launched no scatter_add kernel")
    check(sr_launches > 0, "inline/online: the stitcher launched no stitch_raster kernel")
    with recorded_runs() as runs:
        again, again_outs = engine.run_sequence(engine.init_state(), frames_d, chunk_frames=CHUNK)
        again, _ = engine.finalize(again)
    check(same_bits([gstate.canvas.data, gstate.canvas.weight], [again.canvas.data, again.canvas.weight]),
          "inline/online again: the canvases differ")
    check(same_bits(pack_outputs(gouts), pack_outputs(again_outs)) and same_bits(gstate.bank.poses, again.bank.poses),
          "inline/online again: the outputs or poses differ")
    del again
    cpu = make_engine(config, torch.device("cpu"))
    cstate, couts = cpu.run_sequence(cpu.init_state(), frames, chunk_frames=CHUNK)
    cstate, _ = cpu.finalize(cstate)
    tracked, loops, solves = int(gouts.tracked.sum()), int(gouts.loop_found.sum()), int(gouts.optimized.sum())
    check(tracked == N_OPTION_FRAMES and loops >= 1 and solves >= 1,
          f"inline/online: tracked {tracked}, loops {loops}, inline solves {solves}")
    check(launches >= 2 * tracked, f"inline/online: {launches} kernel launches")
    for name in ("tracked", "inserted", "loop_found", "optimized", "keyframe_slot", "loop_slot"):
        check(np.array_equal(getattr(gouts, name), getattr(couts, name)),
              f"inline/online: card and CPU disagree on {name}")
    pose_err = float(np.abs(gouts.pose - couts.pose).max())
    check(pose_err <= POSE_ATOL, f"inline/online: pose differs by {pose_err}")
    fresh = recompute(make_canvas(config.map_stitcher, dev), gstate.bank, engine.camera)
    check(torch.equal(fresh.weight, gstate.canvas.weight), "online canvas weights != recompute(bank)")
    data_err = float((fresh.data - gstate.canvas.data).abs().max())
    check(data_err <= CANVAS_RTOL * float(fresh.data.abs().max()) + 1e-3, f"online canvas data off by {data_err}")
    # The card's scatter against the CPU's on the same inputs: the card's
    # stored images at the card's poses, rasterized on the CPU.  The two
    # devices round the pixel coordinates (cos, sin, the pose chain)
    # differently in the last bit, so a pixel lying on a cell boundary may
    # truncate into the neighbouring cell: all but a few cells agree, and
    # the pixel count and intensity total are the same.
    bank = gstate.bank
    on_cpu = SimpleNamespace(images=bank.images.cpu(), poses=bank.poses.cpu(), count=bank.count.cpu())
    ref = recompute(make_canvas(config.map_stitcher, torch.device("cpu")), on_cpu, cpu.camera)
    gw, gd = gstate.canvas.weight.cpu(), gstate.canvas.data.cpu()
    touched = int((ref.weight != 0).sum())
    flipped = int((gw != ref.weight).sum())
    check(flipped <= 1e-2 * touched, f"card scatter: {flipped} of {touched} cells differ from the CPU's")
    # Against the CPU's own run the poses differ by up to pose_err, which
    # moves whole frames by a fraction of a pixel; again the same pixels
    # and intensities land on the canvas.
    cw, cd = cstate.canvas.weight, cstate.canvas.data
    moved = int((gw != cw).sum())
    total = float(ref.data.double().sum())
    for w, d, what in ((ref.weight, ref.data, "the CPU's scatter of the card's bank"),
                       (cw, cd, "the CPU's run")):
        check(float(gw.double().sum()) == float(w.double().sum()) > 0,
              f"the card's canvas and {what} hold different pixel counts")
        check(abs(float(gd.double().sum()) - float(d.double().sum())) <= CANVAS_RTOL * total,
              f"the card's canvas and {what} hold different intensity totals")
    print(f"inline + online at {config.cf.height}x{config.cf.width}, {N_OPTION_FRAMES} frames, card vs CPU: "
          f"decisions equal, {loops} loops, {solves} inline solves, max pose diff {pose_err:.2e}; "
          f"online canvas = recompute(bank) (data within {data_err:.2e}); the card's scatter vs the "
          f"CPU's: {flipped} of {touched} cells differ; card vs CPU run: {moved} cells differ; "
          f"same pixel count and intensity total; a second pass on the card gives the same canvas, outputs "
          f"and poses bit for bit | peak_stats launches {launches}, scatter_add launches {sa_launches}, "
          f"stitch_raster launches {sr_launches} | {time.perf_counter() - t0:.1f} s")
    print(f"inline + online again: {runs_line(runs)}")
    return launches, sa_launches, sr_launches, runs


def run_stepbench() -> None:
    """``python -m nislam_torch.scripts.stepbench --size 640`` in this
    process: per-frame latency of the deferred and the inline step."""
    from nislam_torch.scripts import stepbench

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stepbench.main(["--size", "640", "--frames", str(N_STEPBENCH_FRAMES), "--device", "cuda"])
    check(rc == 0, f"stepbench exited {rc}")
    lines = buf.getvalue().splitlines()
    stats = [ln for ln in lines if " p50 " in ln or "floor: p50" in ln]
    check(len(stats) == 3 and all(f"tracked {N_STEPBENCH_FRAMES}/{N_STEPBENCH_FRAMES}" in ln for ln in stats[1:]),
          f"stepbench: {lines}")
    for ln in stats:
        print(f"stepbench 480x640, {N_STEPBENCH_FRAMES} frames: {ln}")
    print(f"stepbench: {time.perf_counter() - t0:.1f} s")


def check_sum_only(dev: torch.device, ps, floor_ms: float) -> dict:
    """Phase 9: the ``sum_only`` kernel against its plain version, then
    pkbench's interleaved A/B (the counts are read over the A/B alone)."""
    from nislam_torch.ops import sum_only as so
    from nislam_torch.scripts import pkbench
    from nislam_torch.utils.profiling import bound_ms

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(str(shape), torch.randn(shape, generator=gen, device=dev))
             for shape in ((1200, 1600), (480, 640), (8, 2, 1200, 1600), (20, 130))]
    cases.append(("constant (1200, 1600)", torch.full((1200, 1600), 0.37, device=dev)))
    worst = 0.0
    for label, x in cases:
        got = so.sum_only(x, force="kernel")
        again = so.sum_only(x, force="kernel")
        want = so.sum_only(x, force="reference")
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool((err <= 1e-5 * x.abs().sum(dim=(-2, -1))).all()), f"sum_only differs at {label}")
        check(torch.equal(got, again), f"sum_only is not deterministic at {label}")
        worst = max(worst, float(err.max()))
        print(f"sum_only {label}: within 1e-5 of sum|x| of the plain version (max abs err "
              f"{float(err.max()):.3e}), equal bit for bit across two runs")
    x = cases[0][1]
    t = kernel_times(lambda v: so.sum_only(v, force="kernel"), so.sum_only_reference, x)
    t["bound_ms"], t["bound_by"] = bound_ms(4 * x.numel() + 4, x.numel())

    pkbench.check(pkbench.make_input(dev))
    so.sum_only.launches = 0
    ps.peak_stats.launches = 0
    res = pkbench.run(dev, reps=REPS)
    launches = so.sum_only.launches
    check(launches > 0 and ps.peak_stats.launches > 0, "pkbench did not launch the kernels")
    pkbench.report(res)
    v = res["variants"]
    t.update(launches=launches, max_abs_err=worst, pk_ms=v["sumonly"]["med_us"] / 1e3,
             library_ms=v["torch.sum"]["med_us"] / 1e3, pkbench=res)
    print(f"pkbench (1200, 1600): sum_only launches {launches}, peak_stats launches "
          f"{ps.peak_stats.launches} | sum_only kernel {1e3 * t['ms']:.2f} us per launch (bound "
          f"{1e3 * t['bound_ms']:.2f} us, share {t['bound_ms'] / t['ms']:.3f}; launch floor "
          f"{1e3 * floor_ms:.2f} us), plain {1e3 * t['plain_ms']:.2f} us, per call host included "
          f"{1e3 * t['call_ms']:.2f} us | {time.perf_counter() - t0:.1f} s")
    return t


def check_registration_model(dev: torch.device) -> None:
    """Phase 10a: ``KCCRegistration`` on the card against the CPU at the
    flagship size: poses within 2e-3, PSRs at rtol 1e-3."""
    from nislam_torch.models import KCCRegistration
    from nislam_torch.utils.synthetic import make_world, render_sequence

    t0 = time.perf_counter()
    cf = flagship_config().cf
    world = make_world(2048, 3.0, seed=3)
    a = render_sequence(world, cf.height, cf.width, [(1024.0, 1024.0, 0.0)])[0]
    # Shifted views, and (loop mode only: tracking folds a turn past 90°)
    # a view turned by 3 rad.
    poses = [(1060.0, 1001.0, 0.0), (1040.0, 1030.0, 0.1), (990.0, 1040.0, 3.0)]
    views = render_sequence(world, cf.height, cf.width, poses)
    for large in (False, True):
        v = views if large else views[:2]
        refs = np.stack([a] * len(v))
        got = [KCCRegistration(cf, dev).register(a, v[0], large_rotation=large),
               KCCRegistration(cf, dev).register_batch(refs, v, large_rotation=large)]
        want = [KCCRegistration(cf, "cpu").register(a, v[0], large_rotation=large),
                KCCRegistration(cf, "cpu").register_batch(refs, v, large_rotation=large)]
        for (gp, gr), (wp, wr) in zip(got, want):
            err = float((gp.cpu() - wp).abs().max())
            check(err <= POSE_ATOL, f"KCCRegistration large_rotation={large}: pose differs by {err}")
            check(bool(torch.allclose(gr.cpu(), wr, rtol=1e-3, atol=0)),
                  f"KCCRegistration large_rotation={large}: PSRs differ: card {gr.tolist()}, "
                  f"CPU {wr.tolist()}")
    print(f"KCCRegistration register / register_batch at {cf.height}x{cf.width}, card vs CPU: "
          f"poses within {POSE_ATOL}, PSRs within rtol 1e-3 | {time.perf_counter() - t0:.1f} s")


def run_eval(root: str, cfg: str, dev: torch.device) -> dict:
    """Phase 10b: ``python -m nislam_torch eval`` over the HD set."""
    recs = {}
    for model in ("vo", "slam"):
        t0 = time.perf_counter()
        out = run_cli(["eval", "--config", cfg, "--device", dev.type, "--model", model,
                       "--groundtruth", os.path.join(root, "groundtruth.txt")])
        rec = json.loads(out.strip().splitlines()[-1])
        check(rec["frames"] == N_HD_FRAMES and rec["tracked_frac"] == 1.0,
              f"eval {model}: tracked_frac {rec['tracked_frac']} over {rec['frames']} frames")
        # The 0.02 m limit holds the loop-closed keyframes of slam; vo
        # scores the raw odometry of every frame, which drifts over the
        # loop with nothing to correct it (0.0477 m on this set, H100).
        limit = 0.02 if model == "slam" else 0.1
        check(rec["ate_rmse_m"] is not None and rec["ate_rmse_m"] < limit,
              f"eval {model}: ATE {rec['ate_rmse_m']} m >= {limit} m")
        check(model == "vo" or rec["loops"] >= 1, "eval slam: no loop found")
        check(rec["device"] == torch.cuda.get_device_name(dev), f"eval {model}: device {rec['device']}")
        print(f"eval --model {model} over the HD set: {rec['fps']} frames/s (timed run after a full "
              f"warm-up) | {time.perf_counter() - t0:.1f} s")
        recs[model] = rec
    return recs


def batch_path():
    """Phase 11's path: one heading loop (steps of 8 px) on a 2048² world
    with a 32-frame tail back over its start → (poses in px, start)."""
    from nislam_torch.utils.synthetic import heading_loop_path

    start = (1024.0, 1024.0)
    return heading_loop_path(N_BATCH_FRAMES, step=8.0, start=start, tail=32), start


def canvas_ring_config():
    """12e: the flagship config with the online stitcher on stored images
    (the canvas sized to phase 11's path, as phase 8 sizes it) over a ring
    of ``CANVAS_SLOTS`` slots, and the inline solve off, as the distributed
    engine runs it."""
    import dataclasses

    poses, start = batch_path()
    config = option_config(flagship_config(), [(p[0] - start[0], p[1] - start[1]) for p in poses])
    return dataclasses.replace(
        config, map=dataclasses.replace(config.map, keyframe_capacity=CANVAS_SLOTS),
        optimizer=dataclasses.replace(config.optimizer, inline=False))


def batch_frames():
    """(B, N, 480, 640) f32 sequences, lane b on a world of seed b along
    :func:`batch_path`, with sensor noise; and (N, 2) ground truth in m."""
    from nislam_torch.utils.synthetic import add_sensor_noise, make_world, render_frame

    world_n, w, h = 2048, 640, 480
    poses, start = batch_path()
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        worlds = list(ex.map(lambda b: make_world(world_n, 3.0, seed=b), range(N_BATCH)))
        frames = np.stack([
            add_sensor_noise(np.stack(list(ex.map(lambda p: render_frame(worlds[b], h, w, *p), poses))), seed=b)
            for b in range(N_BATCH)
        ])
    gt = np.array([(p[0] - start[0], p[1] - start[1]) for p in poses]) / w
    return frames, gt


def _wrapped(d: np.ndarray) -> np.ndarray:
    """Pose differences with the angle taken modulo 2π."""
    d = np.array(d)
    d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return d


def run_batch(ps, dev: torch.device):
    """Phase 11: the batch engine, 8 flagship lanes, against single-engine
    runs of lanes 0 and 7 → (launches, {lane: (its frames on the host, the
    single engine's outputs, its bank's poses)}) for phase 12c."""
    from nislam_torch.core.slam import make_engine
    from nislam_torch.io.trajectory import ate_rmse
    from nislam_torch.parallel import make_batch_engine

    t0 = time.perf_counter()
    config = flagship_config()
    frames, gt = batch_frames()
    frames_d = torch.from_numpy(frames).to(dev)
    del frames
    engine = make_batch_engine(config, N_BATCH, dev)
    print(f"batch set-up ({N_BATCH} lanes x {N_BATCH_FRAMES} frames rendered): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine.run_sequences(engine.init_states(), frames_d[:, :16], chunk_frames=BATCH_CHUNK)
    print(f"batch warm-up (16 frames): {time.perf_counter() - t0:.1f} s")

    sync(dev)
    ps.peak_stats.launches = 0
    tally = []
    t0 = time.perf_counter()
    states, outs = engine.run_sequences(engine.init_states(), frames_d, chunk_frames=BATCH_CHUNK,
                                        solve_tally=tally)
    states, ran = engine.finalize(states)
    sync(dev)
    dt = time.perf_counter() - t0
    launches = ps.peak_stats.launches
    solves = sum(map(sum, tally)) + sum(ran)
    loops = int(outs.loop_found.sum())
    times = np.arange(N_BATCH_FRAMES) / 30.0
    ates = [ate_rmse(times, outs.pose[b, :, :2], times, gt) for b in range(N_BATCH)]
    tracked = outs.tracked.sum(axis=1)
    print(f"batch: {N_BATCH} lanes x {N_BATCH_FRAMES} frames in {dt:.3f} s = "
          f"{N_BATCH * N_BATCH_FRAMES / dt:.1f} lane-frames/s (finalize included) | tracked per lane "
          f"{tracked.tolist()} | keyframes {states.bank.count.tolist()} | loops {loops} | solves "
          f"{solves} | ATE per lane {[round(a, 5) for a in ates]} m | peak_stats launches {launches}")
    check(bool((tracked == N_BATCH_FRAMES).all()), f"batch: tracked per lane {tracked.tolist()}")
    check(max(ates) < 0.02, f"batch: ATE {max(ates)} m >= 0.02 m")
    check(loops >= 1 and solves >= 1, f"batch: {loops} loops, {solves} solves")
    check(launches >= N_BATCH_FRAMES, f"batch: {launches} kernel launches")

    single = make_engine(config, dev)
    refs = {}
    for b in (0, N_BATCH - 1):
        sync(dev)
        t0 = time.perf_counter()
        st, so = single.run_sequence(single.init_state(), frames_d[b], chunk_frames=BATCH_CHUNK)
        st, _ = single.finalize(st)
        sync(dev)
        dt1 = time.perf_counter() - t0
        for name in ("tracked", "inserted", "loop_found", "keyframe_slot", "loop_slot"):
            check(np.array_equal(getattr(so, name), getattr(outs, name)[b]),
                  f"batch lane {b} and the single engine disagree on {name}")
        err = float(np.abs(_wrapped(so.pose - outs.pose[b])).max())
        kerr = float(np.abs(_wrapped(st.bank.poses.cpu().numpy() - states.bank.poses[b].cpu().numpy())).max())
        check(max(err, kerr) <= POSE_ATOL, f"batch lane {b}: poses differ from the single engine by {err}, {kerr}")
        print(f"batch lane {b} vs the single engine on the card: decisions equal, max pose diff "
              f"{err:.2e}, bank {kerr:.2e} | the lane alone through the single engine: "
              f"{N_BATCH_FRAMES / dt1:.1f} frames/s{' (warm-up run)' if b == 0 else ''}")
        refs[b] = (frames_d[b].cpu().numpy(), so, st.bank.poses.cpu().numpy())
    return launches, refs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _decisions_equal(got, want, names, what: str) -> None:
    for name in names:
        check(np.array_equal(getattr(got, name), getattr(want, name)), f"{what}: {name} differs")


def _solve_ms(fn, reps: int = 3):
    """(result, ms per call: the median of ``reps`` timed calls after one
    warm-up), host clock around synchronized calls."""
    out = fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return out, float(np.median(ts))


def run_solve_costs(dev, config, engine, state, outs, group, backend: str) -> dict:
    """Phase 12d: dense LM against GN-CG, ms per solve, on the flagship's
    final graph (its keyframes at the poses reported when they were
    inserted) and on a chain the size of config_HD."""
    import dataclasses

    from nislam_torch.core.pose_graph import solve_pose_graph
    from nislam_torch.core.slam import _optimize_map
    from nislam_torch.parallel.solver import CGSolverConfig, solve_pose_graph_cg
    from nislam_torch.utils.scaling import chain_problem

    bank = state.bank
    k = int(bank.count)
    inserted = torch.from_numpy(outs.pose[bank.frame_ids[:k].cpu().numpy()]).to(dev)
    start = dataclasses.replace(bank, poses=torch.cat([inserted, bank.poses[k:]]))
    (dense, dense_cost), dense_ms = _solve_ms(lambda: _optimize_map(start, state.edges, config, engine.camera))
    before = group.collective_calls()
    (cg, cg_cost), cg_ms = _solve_ms(lambda: _optimize_map(start, state.edges, config, engine.camera,
                                                           lambda p: solve_pose_graph_cg(p, group)))
    cg_calls = (group.collective_calls() - before) // 4  # a warm-up and 3 timed solves

    def cg_once():
        before = group.collective_calls()
        poses, cost = _optimize_map(start, state.edges, config, engine.camera, lambda p: solve_pose_graph_cg(p, group))
        torch.cuda.synchronize()
        return poses, cost, group.collective_calls() - before

    with recorded_runs() as runs:
        (p1, c1, n1), (p2, c2, n2) = cg_once(), cg_once()
    # Collectives of one solve: one per GN step, one per CG iteration, one for the cost.
    cg_iters = n1 - CGSolverConfig().outer_iterations - 1
    check(same_bits([p1, c1], [p2, c2]) and n1 == n2,
          f"solve: two GN-CG solves of one graph differ (CG iterations {cg_iters} and "
          f"{n2 - CGSolverConfig().outer_iterations - 1})")
    print(f"GN-CG twice on the flagship's final graph: poses and cost equal bit for bit, {cg_iters} CG "
          f"iterations both times | {runs_line(runs)}")
    diff = lambda a, b: float(np.abs(_wrapped((a - b).cpu().numpy())).max())
    err = diff(cg[:k], dense[:k])
    moved = diff(dense[:k], inserted)
    check(err <= POSE_ATOL, f"solve: GN-CG differs from dense LM by {err} on the flagship's graph")
    edges = int(state.edges.alive.sum())
    print(f"solve, flagship final graph (K = {bank.capacity}, {k} live poses, {edges} live edges of "
          f"{state.edges.capacity}): dense LM {dense_ms:.2f} ms, GN-CG ({backend}, 1 rank) "
          f"{cg_ms:.2f} ms per solve ({cg_calls} all-reduces each, {cg_ms / cg_calls:.3f} ms per CG "
          f"iteration or GN step); cost {float(dense_cost):.6g} vs {float(cg_cost):.6g}; max |GN-CG - LM| "
          f"{err:.2e} (the solve moves poses by up to {moved:.3f})")

    prob = chain_problem(1024, 4096, device=dev)
    (hd_dense, _, hd_dense_cost), hd_dense_ms = _solve_ms(lambda: solve_pose_graph(prob), reps=2)
    before = group.collective_calls()
    (hd_cg, hd_cg_cost), hd_cg_ms = _solve_ms(lambda: solve_pose_graph_cg(prob, group), reps=2)
    calls = (group.collective_calls() - before) // 3  # a warm-up and 2 timed solves
    hd_err = diff(hd_cg, hd_dense)
    print(f"solve, chain K = {prob.poses.shape[0]} / E = {prob.from_slot.shape[0]} "
          f"({int(prob.edge_mask.sum())} live edges): dense LM "
          f"{hd_dense_ms:.2f} ms, GN-CG {hd_cg_ms:.2f} ms per solve ({calls} all-reduces each, "
          f"{hd_cg_ms / calls:.3f} ms per CG iteration or GN step); cost "
          f"{float(hd_dense_cost):.6g} vs {float(hd_cg_cost):.6g}; max |GN-CG - LM| {hd_err:.2e} (a long "
          f"chain's soft directions: 64 CG iterations per step do not reach LM's optimum there)")
    return {"flagship_dense_ms": dense_ms, "flagship_cg_ms": cg_ms, "flagship_err": err, "cg_calls": cg_calls,
            "cg_iterations": cg_iters,
            "hd_dense_ms": hd_dense_ms, "hd_cg_ms": hd_cg_ms, "hd_err": hd_err, "runs_12d": runs}


def run_one_rank(ps, dev, config, engine, frames_d, state, outs):
    """Phases 12a and 12d: one rank over NCCL on the card."""
    import torch.distributed as dist

    from nislam_torch.core.loop_closure import find_loop_closure
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.parallel import init_distributed, make_distributed_engine

    t0 = time.perf_counter()
    group = init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, ONE_RANK_BACKEND, dev)
    backend = dist.get_backend()
    check(backend == ONE_RANK_BACKEND, f"12a: backend {backend}")
    try:
        deng = make_distributed_engine(config, group)
        sync(dev)
        ps.peak_stats.launches = 0
        sa.index_add_ordered.launches = 0
        with recorded_runs() as runs:
            st, o = deng.run_sequence(deng.init_state(), frames_d[:N_DIST_FRAMES], chunk_frames=CHUNK)
            st, _ = deng.finalize(st)
            sync(dev)
        launches = ps.peak_stats.launches
        sa_launches = sa.index_add_ordered.launches
        want = type(outs)(*(x[:N_DIST_FRAMES] for x in outs))
        _decisions_equal(o, want, ("tracked", "inserted", "loop_found", "keyframe_slot", "loop_slot"),
                         "12a, one rank vs phase 3")
        err = float(np.abs(_wrapped(o.pose - want.pose)).max())
        check(err <= DIST_POSE_ATOL, f"12a: poses differ from phase 3 by {err}")
        check(launches >= 2 * N_DIST_FRAMES, f"12a: {launches} kernel launches")

        # The sharded search against the single search on phase 3's final bank.
        i = int(np.flatnonzero(outs.loop_found)[0])
        s = int(outs.keyframe_slot[i])
        img_u, fft, polar = engine._features(frames_d[i])
        args = (img_u, polar, state.bank.frame_ids[s], state.bank.distances[s], state.bank.poses[s],
                engine.cf_ops, config.loop_closure, config.map.grid_scale)
        single = find_loop_closure(state.bank, *args, cur_fft=fft)
        sharded = deng.loop_search_fn(deng.place(state).bank, *args)
        check(bool(single.found) and bool(sharded.found), f"12a: no loop at frame {i}")
        for name in ("found", "loop_slot", "eligible_count"):
            check(torch.equal(getattr(single, name), getattr(sharded, name)), f"12a search: {name} differs")
        serr = max(float((single.relative_pose - sharded.relative_pose).abs().max()),
                   float(((single.response - sharded.response) / single.response).abs().max()))
        check(serr <= 1e-5, f"12a search: pose or response differs by {serr}")
        print(f"12a: 1 rank, backend {backend}, {dev}: {N_DIST_FRAMES} flagship frames through the "
              f"distributed engine, decisions equal to phase 3, max pose diff {err:.2e} | sharded search "
              f"at loop frame {i} = find_loop_closure (slot {int(sharded.loop_slot)}, "
              f"{int(sharded.eligible_count)} eligible; max diff {serr:.1e}) | peak_stats launches "
              f"{launches} | {time.perf_counter() - t0:.1f} s")
        print(f"12a: {runs_line(runs)}")
        t0 = time.perf_counter()
        costs = run_solve_costs(dev, config, engine, state, outs, group, backend)
        costs["runs_12a"] = runs
        print(f"12d: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    return launches, sa_launches, costs


def rank_canvas(group, workdir: str, dev: torch.device) -> dict:
    """12e on one rank: the distributed engine with the online canvas
    (:func:`canvas_ring_config`) over lane 0 of phase 11 → its outputs,
    poses, canvas, a fresh distributed recompute of its final bank, and the
    canvas hook's all-reduces (an image per eviction, the (2, S, S) canvas
    per recompute) by payload bytes."""
    from nislam_torch.core.slam import pack_outputs
    from nislam_torch.core.stitcher import make_canvas
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.ops import stitch_raster as sr
    from nislam_torch.parallel import make_distributed_engine

    config = canvas_ring_config()
    seq = torch.from_numpy(np.load(os.path.join(workdir, "lanes.npy"), mmap_mode="r")[0].copy()).to(dev)
    engine = make_distributed_engine(config, group)
    sync(dev)
    sa.index_add_ordered.launches = 0
    sr.stitch_raster.launches = 0
    before = group.counts.copy()
    tally = []
    t0 = time.perf_counter()
    with recorded_runs() as runs:
        state, outs = engine.run_sequence(engine.init_state(), seq, chunk_frames=BATCH_CHUNK, solve_tally=tally)
        state, ran = engine.finalize(state)
        sync(dev)
        dt = time.perf_counter() - t0
    delta = group.counts - before
    launches = sa.index_add_ordered.launches
    sr_launches = sr.stitch_raster.launches
    fresh = engine.recompute_canvas(make_canvas(config.map_stitcher, dev), state.bank)
    image_bytes = config.cf.height * config.cf.width * 4
    canvas_bytes = 2 * config.map_stitcher.canvas_size ** 2 * 4
    return {
        "canvas_outs": pack_outputs(outs), "canvas_poses": state.bank.poses.cpu().numpy(),
        "canvas_count": state.bank.count.cpu().numpy(), "canvas_overflow": state.bank.overflow.cpu().numpy(),
        "canvas_solves": np.int32(sum(tally) + ran), "canvas_seconds": np.float64(dt),
        "canvas_data": state.canvas.data.cpu().numpy(), "canvas_weight": state.canvas.weight.cpu().numpy(),
        "canvas_fresh_data": fresh.data.cpu().numpy(), "canvas_fresh_weight": fresh.weight.cpu().numpy(),
        "canvas_retires": np.int64(delta[("all_reduce", image_bytes)]),
        "canvas_recomputes": np.int64(delta[("all_reduce", canvas_bytes)]),
        "canvas_image_bytes": np.int64(image_bytes), "canvas_bytes": np.int64(canvas_bytes),
        "canvas_coll_bytes": np.int64(sum(n * b for (_, b), n in delta.items())),
        "canvas_sa_launches": np.int64(launches), "canvas_sr_launches": np.int64(sr_launches),
        "canvas_runs": np.array(runs, dtype=np.int64),
    }


def canvas_reference(dev: torch.device, frames: np.ndarray) -> dict:
    """12e's reference: the single engine, the same config and frames."""
    from nislam_torch.core.slam import make_engine

    engine = make_engine(canvas_ring_config(), dev)
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), torch.from_numpy(frames).to(dev),
                                      chunk_frames=BATCH_CHUNK, solve_tally=tally)
    state, ran = engine.finalize(state)
    return {"outs": outs, "poses": state.bank.poses.cpu().numpy(), "count": int(state.bank.count),
            "solves": sum(tally) + int(ran), "data": state.canvas.data.cpu(), "weight": state.canvas.weight.cpu()}


def check_canvas_ranks(res: list, ref: dict) -> tuple:
    """12e's checks and line → the ranks' scatter_add and stitch_raster
    launches."""
    from nislam_torch.core.slam import unpack_step_output

    config = canvas_ring_config()
    for key in ("canvas_data", "canvas_weight", "canvas_fresh_data", "canvas_fresh_weight"):
        check(same_bits(res[0][key], res[1][key]), f"12e: the ranks' {key} differ in their bits")
    for key in ("canvas_outs", "canvas_poses", "canvas_count", "canvas_overflow", "canvas_solves"):
        check(np.array_equal(res[0][key], res[1][key]), f"12e: the ranks' {key} differ")
    r0 = res[0]
    o = unpack_step_output(r0["canvas_outs"])
    _decisions_equal(o, ref["outs"], ("tracked", "inserted", "loop_found"), "12e, 2 ranks vs the single engine")
    err = float(np.abs(_wrapped(o.pose - ref["outs"].pose)).max())
    check(err <= DIST_POSE_ATOL, f"12e: poses differ from the single engine by {err}")
    k, evictions, solves = int(r0["canvas_count"]), int(r0["canvas_overflow"]), int(r0["canvas_solves"])
    check(k == ref["count"], f"12e: {k} keyframes, the single engine {ref['count']}")
    check(evictions > 0 and solves >= 1 and int(o.loop_found.sum()) >= 1,
          f"12e: {evictions} evictions, {solves} solves, {int(o.loop_found.sum())} loops")
    weight, data = r0["canvas_weight"], r0["canvas_data"]
    pixels = float(weight.sum(dtype=np.float64))
    check(pixels == float(ref["weight"].double().sum()) > 0, "12e: the canvas and the single engine's hold "
          "different pixel counts")
    total = float(ref["data"].double().sum())
    check(abs(float(data.sum(dtype=np.float64)) - total) <= CANVAS_RTOL * total,
          "12e: the canvas and the single engine's hold different intensity totals")
    check(np.array_equal(r0["canvas_fresh_weight"], weight), "12e: canvas weights != a fresh recompute")
    fresh = r0["canvas_fresh_data"]
    data_err = float(np.abs(fresh - data).max())
    check(data_err <= CANVAS_RTOL * float(np.abs(fresh).max()) + 1e-3, f"12e: canvas data off by {data_err}")
    retires, recomputes = int(r0["canvas_retires"]), int(r0["canvas_recomputes"])
    check(retires == evictions and recomputes == solves,
          f"12e: {retires} image all-reduces for {evictions} evictions, {recomputes} canvas all-reduces for "
          f"{solves} solves")
    launches = [int(x["canvas_sa_launches"]) for x in res]
    check(min(launches) > 0, f"12e: scatter_add launches per rank {launches}")
    sr_launches = [int(x["canvas_sr_launches"]) for x in res]
    check(min(sr_launches) > 0, f"12e: stitch_raster launches per rank {sr_launches}")
    n = o.tracked.shape[0]
    print(f"12e: online canvas over {RANKS} ranks sharing the card ({config.map.keyframe_capacity}-slot ring, "
          f"{config.map_stitcher.canvas_size}^2 canvas, lane 0 of phase 11): {int(o.tracked.sum())}/{n} tracked, "
          f"{k} keyframes, {evictions} evictions, {int(o.loop_found.sum())} loops, {solves} GN-CG solves; "
          f"decisions equal to the single engine (inline off), max pose diff {err:.2e}; both ranks' canvases "
          f"equal bit for bit; pixel count {pixels:.0f} equal and intensity total within {CANVAS_RTOL} of the "
          f"single engine's; canvas = a fresh recompute (data within {data_err:.2e}) | collective bytes: "
          f"{int(r0['canvas_image_bytes'])} per eviction (one all-reduce of the image's bits), "
          f"{int(r0['canvas_bytes'])} per recompute (one all-reduce of the (2, S, S) delta), "
          f"{int(r0['canvas_coll_bytes']) / n:.1f} per frame in all | frames/s per rank "
          f"{[round(n / float(x['canvas_seconds']), 1) for x in res]} | scatter_add launches per rank {launches}, "
          f"stitch_raster {sr_launches}")
    for r in range(RANKS):
        print(f"12e, rank {r}: {runs_line(res[r]['canvas_runs'])}")
    return sum(launches), sum(sr_launches)


def rank_main(argv) -> int:
    """One rank of phases 12b and 12c (``chip_smoke.py --rank R PORT DIR
    DEVICE``): writes its results to DIR/rankR.npz."""
    import torch.distributed as dist

    from nislam_torch.core.slam import pack_outputs
    from nislam_torch.ops import peak_stats as ps
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.parallel import init_distributed, make_distributed_engine, make_fleet_engine
    from nislam_torch.parallel.mesh import world_group

    rank, port, workdir, dev = int(argv[0]), argv[1], argv[2], torch.device(argv[3])
    group = init_distributed(f"tcp://127.0.0.1:{port}", RANKS, rank, SHARED_CARD_BACKEND, dev,
                             timeout_s=RANK_TIMEOUT_S)
    res = {"backend": np.array(dist.get_backend())}
    config = flagship_config()
    cf = config.cf
    c = -(-config.loop_closure.max_candidates // RANKS)  # a rank's share of the candidates
    search_shape = (c, 2, cf.height, cf.width)
    frames_d = torch.from_numpy(np.load(os.path.join(workdir, "flagship.npy"))).to(dev)
    engine = make_distributed_engine(config, group)
    engine.run_sequence(engine.init_state(), frames_d[:16], chunk_frames=CHUNK)  # warm-up
    sync(dev)
    ps.peak_stats.launches = 0
    ps.peak_stats.shapes.clear()
    sa.index_add_ordered.launches = 0
    before = group.counts.copy()
    tally = []
    t0 = time.perf_counter()
    with recorded_runs() as runs:
        state, outs = engine.run_sequence(engine.init_state(), frames_d, chunk_frames=CHUNK, solve_tally=tally)
        state, ran = engine.finalize(state)
        sync(dev)
        dt = time.perf_counter() - t0
    delta = group.counts - before
    res.update(runs=np.array(runs, dtype=np.int64),
        outs=pack_outputs(outs), poses=state.bank.poses.cpu().numpy(),
        count=state.bank.count.cpu().numpy(), solves=np.int32(sum(tally) + ran), seconds=np.float64(dt),
        launches=np.int64(ps.peak_stats.launches), sa_launches=np.int64(sa.index_add_ordered.launches),
        search_shape=np.int64(ps.peak_stats.shapes[search_shape]),
        search_polar_shape=np.int64(ps.peak_stats.shapes[(c,) + tuple(cf.polar_shape)]),
        bank_rows=np.int64(state.bank.fft.shape[0]),
        coll_bytes=np.int64(sum(n * b for (_, b), n in delta.items())),
        coll_calls=np.int64(sum(delta.values())),
    )
    del frames_d, engine, state

    lanes = world_group("data", dev)
    seq = torch.from_numpy(np.load(os.path.join(workdir, "lanes.npy"), mmap_mode="r")[rank].copy()).to(dev)
    fleet = make_fleet_engine(config, lanes)
    sync(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    st, fo = fleet.run_sequences(fleet.init_states(), seq, chunk_frames=BATCH_CHUNK)
    st, _ = fleet.finalize(st)
    sync(dev)
    res.update(fleet_outs=pack_outputs(fo), fleet_poses=st.bank.poses.cpu().numpy(),
               fleet_seconds=np.float64(time.perf_counter() - t0),
               fleet_launches=np.int64(ps.peak_stats.launches))
    del seq, fleet, st
    res.update(rank_canvas(group, workdir, dev))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    return 0


def run_two_ranks(dev, config, frames, gt, outs, lane_refs) -> tuple:
    """Phases 12b, 12c and 12e: two spawned ranks sharing the card over
    gloo → (peak_stats, scatter_add, stitch_raster launches) of their path
    runs."""
    with tempfile.TemporaryDirectory(prefix="nislam_ranks_") as workdir:
        return _run_two_ranks(dev, config, frames, gt, outs, lane_refs, workdir)


def _run_two_ranks(dev, config, frames, gt, outs, lane_refs, workdir: str) -> tuple:
    from nislam_torch.core.slam import unpack_step_output
    from nislam_torch.io.trajectory import ate_rmse

    t0 = time.perf_counter()
    np.save(os.path.join(workdir, "flagship.npy"), frames)
    lanes = (0, N_BATCH - 1)
    np.save(os.path.join(workdir, "lanes.npy"), np.stack([lane_refs[b][0] for b in lanes]))
    canvas_ref = canvas_reference(dev, lane_refs[0][0])
    sync(dev)
    port = free_port()
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), str(port), workdir,
                               str(dev)],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT) for r in range(RANKS)]
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                print(f"rank {r}'s output:\n{f.read()[-6000:]}", file=sys.stderr)
            check(False, f"12b/c/e: rank {r} exited {p.returncode} (killed after {RANK_TIMEOUT_S} s if negative)")
    res = []
    for r in range(RANKS):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
            res.append(dict(f))
    print(f"12b/c/e: {RANKS} ranks on {dev}, backend {res[0]['backend']}, ran in "
          f"{time.perf_counter() - t0:.1f} s (spawn, frames from .npy, warm-up included)")

    # 12b: the sharded flagship
    for key in ("outs", "poses", "count", "solves"):
        check(np.array_equal(res[0][key], res[1][key]), f"12b: the ranks' {key} differ")
    o = unpack_step_output(res[0]["outs"])
    tracked, loops, solves = int(o.tracked.sum()), int(o.loop_found.sum()), int(res[0]["solves"])
    check(tracked == N_FRAMES, f"12b: tracked {tracked} of {N_FRAMES}")
    _decisions_equal(o, outs, ("tracked", "inserted", "loop_found"), "12b, 2 ranks vs phase 3")
    err = float(np.abs(_wrapped(o.pose - outs.pose)).max())
    check(err <= DIST_POSE_ATOL, f"12b: poses differ from phase 3 by {err}")
    times = np.arange(N_FRAMES) / 30.0
    ate = ate_rmse(times, o.pose[:, :2], times, gt)
    check(ate < 0.02 and loops >= 1 and solves >= 1, f"12b: ATE {ate} m, {loops} loops, {solves} solves")
    for r in range(RANKS):
        check(int(res[r]["bank_rows"]) == config.map.keyframe_capacity // RANKS, f"12b: rank {r}'s bank rows")
        check(int(res[r]["search_shape"]) > 0 and int(res[r]["search_polar_shape"]) > 0,
              f"12b: rank {r} launched no peak_stats at (4, 2, 480, 640) and (4, 360, 480)")
    fps = [N_FRAMES / float(x["seconds"]) for x in res]
    print(f"12b: flagship over {RANKS} ranks sharing the card ({config.map.keyframe_capacity} slots as "
          f"{int(res[0]['bank_rows'])} per rank, 4 candidates per rank): {N_FRAMES}/{N_FRAMES} tracked, "
          f"{int(res[0]['count'])} keyframes, {loops} loops, {solves} GN-CG solves, ATE {ate:.5f} m; "
          f"decisions equal to phase 3, max pose diff {err:.2e}; both ranks equal | frames/s per rank "
          f"{[round(f, 1) for f in fps]} (two processes time-sharing one card: the sharded path's "
          f"overhead, not scaling) | collective bytes per frame {int(res[0]['coll_bytes']) / N_FRAMES:.1f} "
          f"({int(res[0]['coll_calls'])} all-reduces) | peak_stats per rank: "
          f"{[int(x['launches']) for x in res]} launches, at (4, 2, 480, 640): "
          f"{[int(x['search_shape']) for x in res]}")
    for r in range(RANKS):
        print(f"12b, rank {r}: {runs_line(res[r]['runs'])}")

    # 12c: the fleet, lane r on rank r
    check(np.array_equal(res[0]["fleet_outs"], res[1]["fleet_outs"]), "12c: the ranks' gathered outputs differ")
    fo = unpack_step_output(res[0]["fleet_outs"])
    for r, b in enumerate(lanes):
        _, so, sposes = lane_refs[b]
        lane = type(fo)(*(x[r] for x in fo))
        _decisions_equal(lane, so, ("tracked", "inserted", "loop_found", "keyframe_slot", "loop_slot"),
                         f"12c, lane {b} on rank {r} vs phase 11's single engine")
        perr = float(np.abs(_wrapped(lane.pose - so.pose)).max())
        kerr = float(np.abs(_wrapped(res[r]["fleet_poses"] - sposes)).max())
        check(max(perr, kerr) <= POSE_ATOL, f"12c: lane {b} differs by {perr}, bank {kerr}")
    print(f"12c: fleet over {RANKS} ranks (lanes {list(lanes)} of phase 11): each lane equal to its "
          f"single-engine run (decisions; poses within {POSE_ATOL}); frames/s per rank "
          f"{[round(N_BATCH_FRAMES / float(x['fleet_seconds']), 1) for x in res]}")

    # 12e: the online canvas
    canvas_sa, sr_launches = check_canvas_ranks(res, canvas_ref)
    sa_launches = canvas_sa + sum(int(x["sa_launches"]) for x in res)
    runs = {"12b": [int(v) for x in res for v in x["runs"]], "12e": [int(v) for x in res for v in x["canvas_runs"]]}
    return sum(int(x["launches"]) + int(x["fleet_launches"]) for x in res), sa_launches, sr_launches, runs


def run_multi_rank(ps, dev, config, engine, frames, gt, state, outs, lane_refs) -> dict:
    """Phase 12; returns the kernel launches of its path runs, the ranks' included."""
    frames_d = torch.from_numpy(frames).to(dev)
    launches, sa_launches, costs = run_one_rank(ps, dev, config, engine, frames_d, state, outs)
    del frames_d
    more, sa_more, sr_launches, runs = run_two_ranks(dev, config, frames, gt, outs, lane_refs)
    costs.update({f"runs_{k}": v for k, v in runs.items()})
    return {"launches": launches + more, "sa_launches": sa_launches + sa_more, "sr_launches": sr_launches, **costs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nislam_torch.core.slam import make_engine
    from nislam_torch.io.trajectory import ate_rmse
    from nislam_torch.core.slam import pack_outputs
    from nislam_torch.kernels.build import build
    from nislam_torch.ops import peak_stats as ps
    from nislam_torch.ops import scatter_add as sa

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    kernels = ("peak_stats", "sum_only", "scatter_add", "stitch_raster")
    with ThreadPoolExecutor(len(kernels)) as ex:  # one nvcc per source, together
        list(ex.map(build, kernels))
    print(f"kernel builds ({', '.join(kernels)}): {time.perf_counter() - t0:.2f} s")

    # --- 2. kernel against the plain version ---------------------------
    t0 = time.perf_counter()
    kres = check_kernel(dev)
    print(f"kernel checks and timings: {time.perf_counter() - t0:.1f} s")
    scatter_rows = check_scatter_add(dev, kres["floor_ms"])
    stitch_rows = check_stitch_raster(dev, kres["floor_ms"])

    # --- 9. sum_only and pkbench ---------------------------------------
    sres = check_sum_only(dev, ps, kres["floor_ms"])

    # --- 3. the slice on the card --------------------------------------
    t0 = time.perf_counter()
    config = flagship_config()
    frames, gt = flagship_frames()
    engine = make_engine(config, dev)
    frames_d = torch.from_numpy(frames).to(dev)
    print(f"set-up (data, tables): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_slice(engine, frames_d)
    print(f"warm-up run: {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    ps.peak_stats.launches = 0
    sa.index_add_ordered.launches = 0
    t0 = time.perf_counter()
    with recorded_solves() as costs:
        state, outs, solves = run_slice(engine, frames_d)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ps.peak_stats.launches
    sa_launches = sa.index_add_ordered.launches
    tracked = int(outs.tracked.sum())
    loops = int(outs.loop_found.sum())
    times = np.arange(N_FRAMES) / 30.0
    ate = ate_rmse(times, outs.pose[:, :2], times, gt)
    print(f"slice: {N_FRAMES} frames in {dt:.3f} s = {N_FRAMES / dt:.1f} frames/s "
          f"(incl. deferred solves and finalize) | tracked {tracked} | keyframes "
          f"{int(state.bank.count)} | loops {loops} | solves {solves} | ATE {ate:.5f} m "
          f"| peak_stats launches {launches}")
    check(tracked == N_FRAMES, f"tracked_frac {tracked / N_FRAMES} != 1.0")
    check(loops >= 1, "no loop found")
    check(solves >= 1, "no pose-graph solve ran")
    check(ate < 0.02, f"ATE {ate} m >= 0.02 m")
    check(launches >= 2 * tracked, f"{launches} kernel launches < 2 x {tracked} tracked frames")
    check(bool(np.isfinite(outs.pose).all()), "non-finite poses")
    check(sa_launches > 0, "the solves launched no scatter_add kernel")
    # The same run again: every solve's cost, the outputs and the final
    # bank's poses repeat bit for bit.
    t0 = time.perf_counter()
    with recorded_solves() as costs2, recorded_runs() as runs3:
        state2, outs2, _ = run_slice(engine, frames_d)
    check(len(costs) == solves and same_bits(costs, costs2), "phase 3 again: the solves' costs differ")
    check(same_bits(pack_outputs(outs), pack_outputs(outs2)), "phase 3 again: the outputs differ")
    check(same_bits(state.bank.poses, state2.bank.poses), "phase 3 again: the bank's poses differ")
    print(f"slice again: {solves} solves' costs {[float(c) for c in costs]}, {N_FRAMES} frames' outputs and "
          f"the final bank poses equal bit for bit | scatter_add launches in the timed run {sa_launches} | "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"slice again: {runs_line(runs3)}")
    del state2, outs2
    flag_lpf = profile_flagship(engine, frames_d, ps)

    # --- 4. card against CPU ---------------------------------------------
    t0 = time.perf_counter()
    cpu_engine = make_engine(config, torch.device("cpu"))
    _, cpu_outs = cpu_engine.run_sequence(cpu_engine.init_state(), frames[:N_CPU_FRAMES],
                                          chunk_frames=CHUNK)
    _, gpu_outs = engine.run_sequence(engine.init_state(), frames_d[:N_CPU_FRAMES],
                                      chunk_frames=CHUNK)
    for name in ("tracked", "inserted", "keyframe_slot"):
        check(np.array_equal(getattr(cpu_outs, name), getattr(gpu_outs, name)),
              f"card and CPU disagree on {name}")
    resp_err = np.abs(gpu_outs.response[1:] - cpu_outs.response[1:])  # frame 0: inf
    check(bool(np.allclose(gpu_outs.response, cpu_outs.response, rtol=1e-3, atol=0)),
          f"response differs (max abs {resp_err.max()})")
    pose_err = float(np.abs(gpu_outs.pose - cpu_outs.pose).max())
    check(pose_err <= 2e-3, f"pose differs by {pose_err}")
    print(f"card vs CPU over {N_CPU_FRAMES} frames: decisions equal, max pose diff "
          f"{pose_err:.2e}, max response rel diff "
          f"{float((resp_err / np.abs(cpu_outs.response[1:])).max()):.2e} "
          f"({time.perf_counter() - t0:.1f} s)")

    # --- 5-7. the HD deployment through the CLI ----------------------------
    t0 = time.perf_counter()
    hd = run_hd(ps, dev)
    print(f"HD phases: {time.perf_counter() - t0:.1f} s")

    # --- 8. inline solve + online stitcher, card against CPU -------------------
    option_launches, option_sa_launches, option_sr_launches, runs8 = run_options(ps, dev)

    # --- step-mode latency (nislam_torch.scripts.stepbench) -------------------
    run_stepbench()

    # --- 10a. the registration model -----------------------------------------
    check_registration_model(dev)

    # --- 11. the batch engine ----------------------------------------------------
    batch_launches, lane_refs = run_batch(ps, dev)

    # --- 12. multi-rank on the one card -------------------------------------
    t0 = time.perf_counter()
    multi = run_multi_rank(ps, dev, config, engine, frames, gt, state, outs, lane_refs)
    print(f"multi-rank phases: {time.perf_counter() - t0:.1f} s")

    flag = kres["times"]["(480, 640)"]
    sa_main = scatter_rows["dense LM H (K*K, 9), K=272 E=1024"]
    sr_main = stitch_rows["insert 480x640 on 4096^2"]
    # One CUDA kernel replaces both Pallas kernels (pallas_kernels.py:49
    # and :88, the row-blocked variant for responses over 4 MB), one launch
    # per call.  Its
    # launches are those of every path run above, each counted from 0; its
    # times are at the flagship's tracking response (480, 640).  No one
    # PyTorch call gives the peak, the column-major-first argmax, Σ and Σ².
    print(f"kernel launches per frame in a profiled trace: flagship {flag_lpf:.0f}, HD "
          f"{hd['launches_per_frame']:.0f}")
    longest_runs = {"3": runs3, "8": runs8, **{k[5:]: multi[k] for k in ("runs_12a", "runs_12d", "runs_12b", "runs_12e")}}
    print(f"scatter_add on the main path (phases 3, 8, 12a, 12d's GN-CG, 12b, 12e): "
          f"{runs_line(r for v in longest_runs.values() for r in v)}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(f"kernels on {card}:")
    print(json.dumps({"kernels": [
        {
            "name": "peak_stats",
            "route": "cuda",
            "source": "nislam_torch/csrc/peak_stats.cu",
            "replaces": "nislam_tpu/ops/pallas_kernels.py:49 and nislam_tpu/ops/pallas_kernels.py:88",
            "launches": launches + hd["launches"] + option_launches + batch_launches + multi["launches"],
            "max_abs_err": kres["max_abs_err"],
            "ms": flag["ms"],
            "plain_ms": flag["plain_ms"],
            "bound_ms": flag["bound_ms"],
            "bound_by": flag["bound_by"],
            "library_ms": None,
            "call_ms": flag["call_ms"],
            "launch_floor_ms": kres["floor_ms"],
            "shape": [480, 640],
        },
        {
            "name": "sum_only",
            "route": "cuda",
            "source": "nislam_torch/csrc/sum_only.cu",
            "replaces": "scripts/pkbench.py:46",
            "launches": sres["launches"],
            "max_abs_err": sres["max_abs_err"],
            "ms": sres["ms"],
            "plain_ms": sres["plain_ms"],
            "bound_ms": sres["bound_ms"],
            "bound_by": sres["bound_by"],
            "library_ms": sres["library_ms"],
            "call_ms": sres["call_ms"],
            "launch_floor_ms": kres["floor_ms"],
            "shape": [1200, 1600],
        },
        {
            # The port's own kernel: no Pallas kernel is replaced; it is the
            # counterpart of XLA's deterministic scatter-adds in the solvers.
            # Its launches are those of phases 3, 8, 12a, 12b and 12e; its
            # times at the flagship's dense LM H blocks, every shape's under
            # "shapes".
            "name": "scatter_add",
            "route": "cuda",
            "source": "nislam_torch/csrc/scatter_add.cu",
            "replaces": "no Pallas kernel: the XLA scatter-adds at nislam_tpu/core/pose_graph.py:157 and "
                        "nislam_tpu/parallel/solver.py:52",
            "launches": sa_launches + option_sa_launches + multi["sa_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in scatter_rows.values()),
            "ms": sa_main["ms"],
            "plain_ms": sa_main["plain_ms"],
            "bound_ms": sa_main["bound_ms"],
            "bound_by": sa_main["bound_by"],
            "library_ms": sa_main["library_ms"],
            "call_ms": sa_main["call_ms"],
            "plan_ms": sa_main["plan_ms"],
            "launch_floor_ms": kres["floor_ms"],
            "longest_runs": longest_runs,
            "shape": [272 * 272, 9],
            "shapes": scatter_rows,
        },
        {
            # The port's own kernel: the counterpart of the stitcher's XLA
            # scatter-add.  Its launches are those of phases 8 and 12e, one
            # per frame; its times at a 480x640 insert, every case's under
            # "shapes" (op_ms: the whole op; old_op_ms: the sort and two
            # scatter_add launches it replaced; library_ms: index_add_ twice).
            "name": "stitch_raster",
            "route": "cuda",
            "source": "nislam_torch/csrc/stitch_raster.cu",
            "replaces": "no Pallas kernel: the XLA scatter-add at nislam_tpu/core/stitcher.py:123",
            "launches": option_sr_launches + multi["sr_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in stitch_rows.values()),
            "ms": sr_main["ms"],
            "plain_ms": sr_main["plain_ms"],
            "bound_ms": sr_main["bound_ms"],
            "bound_by": sr_main["bound_by"],
            "library_ms": sr_main["library_ms"],
            "call_ms": sr_main["call_ms"],
            "op_ms": sr_main["op_ms"],
            "old_op_ms": sr_main["old_op_ms"],
            "launch_floor_ms": kres["floor_ms"],
            "shape": [480, 640],
            "shapes": stitch_rows,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
