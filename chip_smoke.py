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
   1024 and K = 1024 / E = 4096, the batch engine's LM over 8 lanes at
   K = 272 / E = 1024 in one plan with each lane's keys offset, a GN-CG
   rank's (K, 3) sums), at the flat
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
   sort, two ``scatter_add`` launches) and ``index_add_``.  Then the solve
   graph's two kernels (``cond_graph.cu``'s ``trigger`` and ``lm_step``)
   against their plain versions at 1, 8 and 32 lanes, bit for bit, timed
   beside them, and the solve graph with empty steps (µs per launch, per
   WHILE iteration).
3. Drives the flagship workload (480×640 frames, 720×480 polar grid, bf16
   bank with cached filters, 8 loop candidates, the 512-frame heading loop)
   through ``make_engine(config, cuda)`` and ``run_sequence(chunk_frames=128)``
   and ``finalize`` (each chunk's tracked frames one launch of the engine's
   chunk graph: a WHILE over the frames whose body nests the captured track
   graph and, under one SWITCH node, the keyframe branch's graphs; each
   deferred trigger one launch of the engine's solve graph: the trigger
   kernel, an IF over the setup, a WHILE over the LM iteration and
   ``lm_step``, the finish): one warm-up run, which captures and builds
   them, one timed run with the kernels' launch counts reset before it
   (the trigger's and ``lm_step``'s equal to their own device counts).  Checks tracking, loops, solves, ATE,
   that the run went through the kernels (one chunk-graph launch per
   chunk, no early exit, and as many ``peak_stats`` launches ran on the
   device, by the kernel's own count, as the wrapper counted).  The same
   run again must repeat every solve's
   cost, every output and the final poses bit for bit.
   3g. Five paths of one engine: its chunk graph (phase 3's run), its
   frame graph frame by frame (``run_chunk_frame_graph``: the track
   graph, one flag read, the keyframe branch's graph, over the same
   buffers), the track-graph path (``run_chunk_track_graph``: the track
   graph, the flag read, the keyframe branch launched eagerly), the
   eager per-frame loop (``run_chunk_eager``), each with the solve graph
   as its trigger, and the chunk graph with the host-loop trigger
   (``optimize_host_loop``).  Prints the route the chunk
   graph took (PyTorch 2.11 has no ``begin_capture_to_if_node``; the
   captures come out as ``raw_cuda_graph()`` and ``csrc/cond_graph.cu``
   nests them under the CUDA runtime's conditional nodes), the node types
   it found in them and its early exits.  The 512 frames through the
   other four must repeat the chunk graph's outputs, solve costs, final
   bank poses and every other state leaf bit for bit, with as many
   ``peak_stats`` launches; every replay of a captured graph, every
   chunk launch and every solve-graph launch runs under ``torch.cuda``'s
   sync debug mode "error"; the host syncs and ms of each trigger that
   solves, through the solve graph (at most 1) and the host loop; the
   host syncs of one whole chunk (frames 128–255, keyframe frames among
   them) after a first chunk: at most 3 through the chunk graph, one flag
   read per frame through the frame graph;
   the host's launch calls (kernel launches and graph launches, below 0.5
   per frame through the chunk graph), the device's kernels per frame, the
   busy share and the counted kernels' launches in one profiled 64-frame
   chunk of the chunk graph and of the frame graph; frames/s of the five,
   one after another (chunk graph, frame graph, track graph, eager,
   host-loop trigger); the cuFFT plan cache below its limit (a captured
   plan is never evicted).  The same at HD inside phase 5, through the
   CLI's drive (``streamed_deferred_drive`` over the NISF reader's pinned
   chunks): bits (every state leaf, compared on the card), frames/s one
   after another, one profiled 64-frame drive of the chunk graph and of
   the frame graph.
   Then ``cond_graph``, the chunk graph's outer body alone (the nested
   graphs empty kernels) over a 128-frame flagship chunk, 64 frames of
   HD-size features and 64 frames of 8 lanes, with no branch and with
   every lane's stored branch taken: the copies bit for bit (``img_u``
   and ``polar`` by the advance, the spectrum only in a taken branch),
   device µs per frame beside the bound by the bytes each needs, the
   flagship's against the same work as a host loop on the card; the
   empty bodies' µs per WHILE iteration (no branch, the stored branch
   taken, 8 lanes), and the copies' share of their bytes bound (the
   copying runs less the empty one); the per-node probe (µs per empty
   kernel node, from track graphs of 1–4 empty kernels); the engine's
   built graph walked (at most 4 nodes per WHILE iteration, no count node
   in a body).
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
    ``finalize``: each chunk's tracked frames one launch of the batch's
    chunk graph (the batched track graph, then ONE SWITCH node whose body
    k is the keyframe branch over the k lanes that insert, gathered on the
    device), each trigger one launch of the batch's solve graph: one
    batched LM over every lane under the lane mask.  The chunk graph, the
    flag-read frame graph (``run_chunk_frame_graph``: the batched track
    graph's replay, one (8, 2) flag read, body k's replay) and the kept
    eager loop (``run_chunk_eager``, each lane's branch on its own) run in
    turns (twice) after a warm-up that captures: every run's outputs,
    solve tallies, batched solves' costs and state leaves bit for bit (a
    difference reported: a flipped decision with its responses beside the
    thresholds, else the first leaf apart), the chunk graph and the frame
    graph with as many ``peak_stats`` launches (the eager loop makes one
    search per lane that stores, body k one per frame); every path's
    ``peak_stats`` launches equal to the kernel's own device count; a
    histogram of frames by k against each body's runs as the chunk
    graph's control block and the frame graph's replays count them; every
    replay and chunk launch under sync debug mode "error", no capture
    after the warm-up; lane-frames/s of each; the bodies and graphs
    captured and the memory reserved after them; the
    host syncs of one 64-frame chunk of each path (at most 3 through the
    chunk graph, 64 through the frame graph).  The lanes follow one path,
    so they mostly insert together; the same frames with lane b held
    5·b frames at its start (``offset_lanes``) insert apart, and run
    through the chunk graph, the eager loop and the chunk graph: bits,
    frames by k against body k's runs, ``peak_stats`` against its device
    count, tracking and ATE, lane-frames/s.  The host syncs of a trigger
    through the solve graph (at most 1, bit for bit
    against the host loop), the host loop and per-lane solves of the same
    states (bits and each lane's LM iterations reported, its poses within
    1e-4 and its final cost within 1e-4 relative; the first iteration
    stage by stage: assembly, factor, solve; the same solve over its lanes
    permuted bit for bit); one profiled chunk of each
    path (a quarter of one for the eager loop, whose trace is long: host
    launch calls and device kernels per lane-frame, busy share).  Every lane tracks every frame with ATE < 0.02 m, loops and
    solves happen, and lanes 0 and 7 equal single-engine runs of their
    sequences on the card.  Prints one lane's frames/s through the single
    engine, and a summary line before the kernels JSON.
12. Multi-rank on the one card (``nislam_torch.parallel``), every
    collective the port's peer all-reduce kernel (``csrc/all_reduce.cu``:
    a sum in rank order over peer memory, one shot for small payloads and
    two for large, one kernel node that a graph body holds; at one rank no
    launch: the sum is the payload).  a: one rank over NCCL on ``cuda:0``:
    the call at each of the distributed engine's payloads (the (K, 3) CG
    vector, the (2, K, 3) block, the (1,) cost, the (n, 11) search record,
    the (2, S, S) canvas delta, an evicted image's int32 bits) and at each
    protocol edge against its plain version bit for bit, a capture (the
    copy of its payload in, no kernel node) whose replay gives the eager
    bits, beside NCCL's own all-reduce; then the distributed engine over the 512 flagship frames
    through its chunk graph (the graph route: the keyframe branch and its
    all-reduces one captured step per kind under the chunk graph's
    SWITCH, a chunk one launch; its trigger program one launch per
    trigger), through the track-graph path (``run_chunk_track_graph``:
    the eager branch) and through the chunk graph with the host-loop
    trigger, one warm-up each, then in turns: every run bit for bit
    (outputs, solve tallies, every state leaf, collectives by payload), no
    capture after the warm-up, ``peak_stats``, ``scatter_add``,
    ``cg_step`` and ``all_reduce`` launches equal to their own device
    counts (the all-reduce's none at one rank, the group's 386 collectives
    per run counted all the same; at two ranks equal to them), 4 chunk
    launches per run and no host or early exit, each branch kind's runs
    its frames; frames/s of each; the host syncs of one 128-frame chunk
    (one); one profiled chunk of each; the host syncs and ms of each
    solving trigger (one).  512/512 tracked, ATE < 0.02 m, decisions
    equal to phase 3 (poses within 5e-3, GN-CG against dense LM), and the
    sharded search on a loop frame equals ``find_loop_closure``.  d (same
    group): ms per solve of dense LM (through the host loop and as one
    solve-graph launch) and of GN-CG on the flagship's final graph
    (K = 272, within 2e-3) and on a K = 1024 / E = 4096 chain, GN-CG as
    the eager solve, as the graph program (``CGGraph``) and as one launch
    in turns: every solve bit for bit (poses, cost, all-reduces), ms per
    solve and per CG iteration of each.  b: two spawned ranks sharing the
    card over gloo with CUDA tensors (NCCL needs a card per rank; the
    process group only carries the peer regions' handle exchange): the
    kernel's probe on both ranks at every payload and protocol edge (bits
    against the plain version, every rank equal, captured replays), then
    the flagship at full width, 272 slots split
    136 + 136, 4 candidates per rank, the 512 frames read from a ``.npy``
    this process writes, through the three paths as in a on each rank
    (the graph route: 4 chunk launches per run, one host sync per chunk
    and per solving trigger); both ranks equal, with phase 3's
    decisions, poses within 5e-3, ATE < 0.02 m, ≥ 1 loop and solve,
    ``peak_stats`` at (4, 2, 480, 640) on each rank; frames/s per rank of
    each path and collective bytes per frame.  c: the same two ranks as a
    fleet on lanes 0 and 7 of phase 11, each equal to phase 11's
    single-engine run of its lane (poses within 2e-3).  e: the same two
    ranks run the online stitcher on stored images through the
    distributed engine, over lane 0 of phase 11 with a ring of 32 slots
    that evicts, through the three paths in turns on each rank, as in b
    (the graph route all-reduces the evicted image's bits at every stored
    keyframe, zeros when nothing is evicted; the eager branch at every
    eviction): both ranks' canvases equal bit for bit; decisions equal to
    a single-engine run of the same config (inline off), poses within
    5e-3; pixel count and intensity total equal to its canvas (within
    1e-5); the canvas equal to a fresh recompute; one all-reduce per
    recompute.  Two ranks on one card time-slice it: a kernel that waits
    for its peer waits for the other process's slice, so their figures
    are the sharded path's overhead, not scaling.
13. The measuring entry points (``nislam_torch.scripts``), in this
    process.  a: ``bench`` at the flagship: its JSON line has exactly
    ``bench.py``'s keys, its decisions, poses and ATE equal phase 3's, and
    ``peak_stats`` launched inside its timed window; then ``bench --quick``
    in a fresh process: its warm-up loads the kernels of its path and
    makes the cuFFT plans, its timed window loads and makes none.  b:
    ``bench --batch 8`` over 128 frames: the batch keys, every lane
    tracked, no graph captured in its timed chunk.  c:
    ``stagebench --size 640`` and ``--size 1200``: each stage's output
    equal to one plain call's, the ``peak_stats`` stage through the
    kernel, the graph rows (the batch's at 8 lanes among them, the chunk
    graph's per frame, and at 640 the distributed branch per stored
    keyframe at one NCCL rank, eager and as captured steps) counting their
    replays' launches, the chunk
    graph's empty-body rows; ``stagebench --solve``: the dense LM's rows,
    each solve equal to itself, the solve graph's ms; the GN-CG rows at one
    rank, the graph program equal to the eager solve.  d: ``hdprofile`` over one HD chunk of 24 frames: every frame
    tracked, its top kernels' total within the trace's busy time.  e: ``hdbench``, ``opbench``,
    ``polarbench``, ``psrcal`` over 3 sizes and ``rotstudy`` over a cut
    sweep, once each with short settings.  Prints each sub-phase's time.

Every phase prints its time, and the script its total.  Prints a summary
line (phase 3's, 3g's, HD's, 12a's, 12b's, 12d's, 13's, stepbench's and
phase 11's figures), one JSON line of per-kernel results (``peak_stats``,
``sum_only``, ``scatter_add``, ``stitch_raster``, ``cond_graph``,
``trigger``, ``lm_step``, ``cg_step``, ``all_reduce``), then, as the last
line, ``{"ok": true,
"device": {...}}``.  Exits non-zero
at the first failed check, and when no CUDA device is available.

Other modes: ``--nccl-ranks N`` (the flagship through the distributed
engine at N NCCL ranks, a card each) and ``--rank-loop SECONDS VARIANTS``
(12b's start alone, again and again: the shared-card ranks' probe and
first distributed run, with and without gloo's all-reduce timing before
it).
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
HD_CHUNK = 64  # the CLI's --chunk
N_STEP_FRAMES = 64
N_PROFILE_FRAMES = 64
N_OPTION_FRAMES = 96
N_BATCH = 8
N_BATCH_FRAMES = 256
BATCH_OFFSET = 5  # phase 11's offset run: frames between one lane's start and the next's
BATCH_CHUNK = 64
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
# Phase 11: the batched LM against per-lane solves of the same states.  On
# the card the batched Cholesky factor and solve round otherwise than one
# lane's, so a lane near its minimum may stop at another iteration: poses
# 3.81e-06 apart at most, final costs 5.82e-06 relative, on an H100.
LANE_POSE_ATOL = 1e-4
LANE_COST_RTOL = 1e-4
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


def solve_kernel_cases(lanes: int, seed: int):
    """Inputs of the solve graph's two kernels for ``lanes`` lanes over the
    pending buffer's 32 slots: pending counts and loop slots (voided ones
    among them), then 6 steps' (μ at the start, accept, small), μ at both
    ends of its range, and each lane's packed output row (17 floats) whose
    ``loop_found`` field gates the inline trigger."""
    rng = np.random.default_rng(seed)
    count = torch.from_numpy(rng.integers(0, 6, lanes).astype(np.int32))
    slots = torch.from_numpy(rng.integers(-1, 5, (lanes, 32)).astype(np.int32))
    mu = torch.from_numpy(rng.choice(np.array([1e-9, 1e-8, 1.1e-8, 1e-4, 1e7, 1.2e7, 1e8], np.float32), lanes))
    steps = [(torch.from_numpy(rng.random(lanes) < 0.6), torch.from_numpy(rng.random(lanes) < 0.3)) for _ in range(6)]
    packed = torch.from_numpy((rng.random((lanes, 17)) < 0.4).astype(np.float32))
    return count, slots, mu, steps, packed


def run_solve_kernels(dev: torch.device, case, force: str, gated: bool = False):
    """The trigger (``gated``: the inline trigger, gated by each lane's
    ``loop_found`` field, a strided view of the packed rows), then μ set,
    then ``lm_step`` per step, through the kernels or their plain versions
    (``force``) → (control words, run flags, lane mask, μ, pending counts)
    on the host."""
    import nislam_torch.core.pose_graph as pg
    import nislam_torch.core.solve_graph as sg

    count, slots, mu, steps, packed = case
    cfg = pg.SolverConfig()
    ctl = torch.zeros(sg.CTL_WORDS, dtype=torch.int32, device=dev)
    run = torch.zeros(count.shape[0], dtype=torch.bool, device=dev)
    control = pg.lm_control(count.shape[0], dev, ctl)
    count = count.to(dev)
    sg.trigger(ctl, count, slots.to(dev), run, control, cfg, packed.to(dev)[:, 2] if gated else None, force=force)
    control.mu.copy_(mu.to(dev))
    control.active.copy_(run)
    for accept, small in steps:
        control.accept.copy_(accept.to(dev))
        control.small.copy_(small.to(dev))
        pg.lm_step(control, cfg, force=force)
    return [x.cpu() for x in (ctl, run, control.active, control.mu, count)]


def check_solve_kernels(dev: torch.device, floor_ms: float) -> dict:
    """The solve graph's two kernels (``csrc/cond_graph.cu``'s trigger and
    lm_step, launched outside a graph) against their plain versions on the
    card, on the same inputs, at the main path's lanes (1: the single
    engine; 8: phase 11's batch) and at 32, the most a graph holds, 20
    cases each: every control word, run flag, lane mask and μ bit for bit.
    Times each kernel at 1 and 8 lanes (device µs per launch over REPS
    launches) beside its plain version (CUDA events around REPS calls, the
    host's launches of its small operations included) and the bound by the bytes it
    moves (the pending buffer, μ, the flags and the control words) → one
    row per kernel (its times at 1 lane, the main path's) and the 8-lane
    times under "shapes"."""
    import nislam_torch.core.pose_graph as pg
    import nislam_torch.core.solve_graph as sg
    from nislam_torch.utils.profiling import bound_ms, device_ms_per_launch

    t0 = time.perf_counter()
    worst = 0.0
    for lanes in (1, N_BATCH, sg.MAX_LANES):
        for seed in range(20):
            case = solve_kernel_cases(lanes, seed)
            for gated in (False, True):
                got, want = (run_solve_kernels(dev, case, force, gated) for force in ("kernel", "reference"))
                check(all(torch.equal(got[k], want[k]) for k in (0, 1, 2, 4))
                      and torch.equal(got[3].view(torch.int32), want[3].view(torch.int32)),
                      f"trigger / lm_step: the kernels differ from their plain versions at {lanes} lanes, case "
                      f"{seed}{', gated' if gated else ''}: {got} against {want}")
                worst = max(worst, float((got[3] - want[3]).abs().max()))
    rows = {"trigger": {"shapes": {}}, "lm_step": {"shapes": {}}}
    cfg = pg.SolverConfig()
    for lanes in (1, N_BATCH):
        count, slots, mu, steps, packed = solve_kernel_cases(lanes, 0)
        ctl = torch.zeros(sg.CTL_WORDS, dtype=torch.int32, device=dev)
        run = torch.zeros(lanes, dtype=torch.bool, device=dev)
        control = pg.lm_control(lanes, dev, ctl)
        count, slots, gate = count.to(dev), slots.to(dev), packed.to(dev)[:, 2]
        control.accept.copy_(steps[0][0].to(dev))
        # The gated trigger last: it clears the counts of gated lanes that do
        # not solve (each later call reads the whole buffer all the same).
        calls = {
            "trigger": (lambda force: lambda _: sg.trigger(ctl, count, slots, run, control, cfg, force=force),
                        lanes * (4 + 4 * 32 + 1 + 1 + 4 + 4) + 12),
            "lm_step": (lambda force: lambda _: pg.lm_step(control, cfg, force=force), lanes * 12 + 12),
            # + the gate read and the count written
            "trigger (gated)": (lambda force: lambda _: sg.trigger(ctl, count, slots, run, control, cfg, gate,
                                                                   force=force),
                                lanes * (4 + 4 * 32 + 1 + 1 + 4 + 4 + 4 + 4) + 12),
        }
        for label, (fn, nbytes) in calls.items():
            name = label.split(" ")[0]
            bound, by = bound_ms(nbytes)
            # The plain version's ~20 small operations: CUDA events around
            # back-to-back calls (its host launches included).
            plain = fn("reference")
            times = {"ms": device_ms_per_launch(fn("kernel"), [None], REPS),
                     "plain_ms": event_ms(lambda: plain(None), REPS, dev),
                     "bound_ms": bound, "bound_by": by, "launch_floor_ms": floor_ms}
            rows[name]["shapes"][f"{lanes} lanes" + label[len(name):]] = times
            if lanes == 1 and label == name:
                rows[name].update(times)
            print(f"{label}, {lanes} lanes: {1e3 * times['ms']:.2f} us per launch (plain version "
                  f"{1e3 * times['plain_ms']:.2f} us; bound by {by} {1e3 * bound:.4f} us; launch floor "
                  f"{1e3 * floor_ms:.2f} us, share of max(bound, floor) {max(bound, floor_ms) / times['ms']:.3f})")
    for row in rows.values():
        row["max_abs_err"] = worst
    # The structure alone: empty steps, the WHILE run 1 and 129 times.
    empty = {}
    for lanes in (1, N_BATCH):
        ms = {n: event_ms(sg.EmptySolveBodies(dev, n, lanes).launch, 20, dev) for n in (1, 129)}
        empty[f"{lanes} lanes"] = {"launch_us": 1e3 * ms[1], "while_iteration_us": 1e3 * (ms[129] - ms[1]) / 128}
    rows["trigger"]["empty_solve_graph"] = empty
    print(f"trigger (deferred and gated) and lm_step: equal to their plain versions bit for bit at 1, {N_BATCH} and "
          f"{sg.MAX_LANES} lanes, 20 cases each (control words, run flags, lane mask, mu, pending counts) | the solve "
          f"graph with empty steps: "
          + "; ".join(f"{k}: {v['launch_us']:.2f} us per launch of one WHILE iteration, {v['while_iteration_us']:.2f} "
                      f"us per further empty WHILE iteration (an empty child graph and lm_step)" for k, v in empty.items())
          + f" | {time.perf_counter() - t0:.1f} s")
    return rows


def check_cg_step_kernel(dev: torch.device, floor_ms: float) -> dict:
    """The GN-CG trigger's ``cg_step`` kernel (``csrc/cond_graph.cu``,
    launched outside a graph) against ``cg_step_reference`` on the card,
    on the same control words: every mode; r² the float32 values next to
    ``cg_tol ** 2`` on both sides and at it, 0, 1, inf and nan; the
    iteration counters at and beside their caps; every word bit for bit.
    Timed as a CG step (device µs per launch over REPS launches) beside its
    plain version (CUDA events around REPS calls, its host launches
    included) and its bound by the bytes it moves (‖r‖², the counter read
    and written, the condition, and inside a graph the growing count)."""
    from nislam_torch.parallel import solver as sv
    from nislam_torch.utils.profiling import bound_ms, device_ms_per_launch

    t0 = time.perf_counter()
    cfg = sv.CGSolverConfig()
    near = np.float32(cfg.cg_tol ** 2)
    values = (np.nextafter(near, np.float32(0)), near, np.nextafter(near, np.float32(1)), np.float32(0),
              np.float32(1), np.float32(np.inf), np.float32(np.nan))
    modes = ((sv.CG_BEGIN, 5), (sv.CG_STEP, 0), (sv.CG_STEP, cfg.cg_iterations - 2),
             (sv.CG_STEP, cfg.cg_iterations - 1), (sv.CG_STEP, cfg.cg_iterations), (sv.GN_BEGIN, 3),
             (sv.GN_STEP, 0), (sv.GN_STEP, cfg.outer_iterations - 2), (sv.GN_STEP, cfg.outer_iterations - 1))
    for r2 in values:
        for mode, it in modes:
            words = torch.zeros(sv.TRIGGER_WORDS, dtype=torch.int32)
            words[sv.CG_IT], words[sv.GN] = it, it
            got, want = words.to(dev), words.clone()
            sv.cg_step(got, torch.tensor([r2], device=dev), mode, cfg, force="kernel")
            sv.cg_step(want, torch.tensor([r2]), mode, cfg, force="reference")
            check(torch.equal(got.cpu(), want), f"cg_step: the kernel differs from its plain version at r2 {r2!r}, "
                  f"mode {mode}, counter {it}: {got.cpu().tolist()} against {want.tolist()}")
    ctl = torch.zeros(sv.TRIGGER_WORDS, dtype=torch.int32, device=dev)
    r2 = torch.ones(1, device=dev)
    bound, by = bound_ms(4 + 4 + 4 + 4 + 8)
    row = {"ms": device_ms_per_launch(lambda _: sv.cg_step(ctl, r2, sv.CG_STEP, cfg, force="kernel"), [None], REPS),
           "plain_ms": event_ms(lambda: sv.cg_step(ctl, r2, sv.CG_STEP, cfg, force="reference"), REPS, dev),
           "bound_ms": bound, "bound_by": by, "launch_floor_ms": floor_ms, "max_abs_err": 0.0,
           "cases": len(values) * len(modes)}
    print(f"cg_step: equal to its plain version in every control word over {row['cases']} cases (r2 next to "
          f"cg_tol^2 = {cfg.cg_tol ** 2!r} as float32, 0, 1, inf, nan; each mode; counters at their caps) | "
          f"{1e3 * row['ms']:.2f} us per launch (plain version {1e3 * row['plain_ms']:.2f} us; bound by {by} "
          f"{1e3 * bound:.5f} us; launch floor {1e3 * floor_ms:.2f} us, share of max(bound, floor) "
          f"{max(bound, floor_ms) / row['ms']:.3f}) | {time.perf_counter() - t0:.1f} s")
    return row


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
        # The old op's plan: its longest run of equal keys (masked pixels
        # all target cell 0) sets what its two scatter_add launches cost.
        plan = sa.ScatterPlan.of(var[0].idx)
        r["old_op_longest_run"] = int((plan.run_end - torch.arange(plan.keys.numel(), device=dev)).max())
        del plan
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
              f"{us['old_op_ms']:.2f} us (plan alone {us['plan_ms']:.2f}; longest run of equal keys "
              f"{r['old_op_longest_run']}; host syncs {r['old_op_syncs']}) | plain "
              f"(targets + 2 index_add_) "
              f"{us['plain_ms']:.2f} us | library 2 x index_add_ on ready targets {us['library_ms']:.2f} us")
    print(f"stitch_raster: {time.perf_counter() - t0:.1f} s")
    return rows


@contextlib.contextmanager
def recorded_solves():
    """The final cost of every dense LM solve that a single engine makes
    inside the block, in order: the host loop's (``core/slam.py``'s
    ``solve_pose_graph``, wrapped) and the solve graph's (its ``finish``
    writes the final cost of each lane into a buffer, read after each
    trigger that ran)."""
    import nislam_torch.core.slam as slam
    from nislam_torch.core.solve_graph import SolveGraph

    real, real_run, costs = slam.solve_pose_graph, SolveGraph.run, []

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        costs.append(out[2].clone())
        return out

    def graph_run(self):
        ran = real_run(self)
        costs.extend(self.final_cost[b].clone() for b, r in enumerate(ran) if r)
        return ran

    slam.solve_pose_graph, SolveGraph.run = recording, graph_run
    try:
        yield costs
    finally:
        slam.solve_pose_graph, SolveGraph.run = real, real_run


@contextlib.contextmanager
def recorded_runs():
    """The longest run of equal keys in every scatter plan made inside the
    block (``ScatterPlan.of``, wrapped: two per dense LM solve, H and g;
    one per GN-CG solve; a solve graph's two, made inside its launch, read
    from its carry after each launch that solved; a GN-CG graph program's,
    made by its replayed setup, read from its buffers after the solve), in
    order, read once the block ends: how often the solvers give
    ``scatter_add`` a run longer than a warp."""
    from nislam_torch.core.solve_graph import SolveGraph
    from nislam_torch.ops.scatter_add import ScatterPlan
    from nislam_torch.parallel.solver import CGGraph

    real, real_run, real_cg, longest = ScatterPlan.__dict__["of"], SolveGraph.run, CGGraph.__call__, []

    def record(plan):
        if torch.cuda.is_current_stream_capturing():  # a plan made inside a capture holds no values yet
            return
        if plan.run_end is not None and plan.keys.numel() > 0:
            # run_end holds a run's end at its start and 0 elsewhere.
            longest.append((plan.run_end - torch.arange(plan.keys.numel(), device=plan.keys.device)).max())

    def recording(cls, keys):
        plan = real.__func__(cls, keys)
        record(plan)
        return plan

    def graph_run(self):
        ran = real_run(self)
        if self.built and any(ran):
            for plan in self.carry.plan:
                record(plan)
        return ran

    def cg_call(self, prob):  # a replayed setup makes its plan in its buffers
        replay = self.program(prob).steps["setup"].captured
        out = real_cg(self, prob)
        if replay:
            record(self.program(prob).b.plan)
        return out

    ScatterPlan.of, SolveGraph.run, CGGraph.__call__ = classmethod(recording), graph_run, cg_call
    runs = []
    try:
        yield runs
    finally:
        ScatterPlan.of, SolveGraph.run, CGGraph.__call__ = real, real_run, real_cg
        runs.extend(int(x) for x in longest)


def runs_line(runs) -> str:
    """The longest runs of :func:`recorded_runs`, summed up."""
    runs = [int(r) for r in runs]
    return (f"longest run of equal keys per scatter plan: max {max(runs, default=0)} over {len(runs)} plans, "
            f"{sum(r > 32 for r in runs)} of them over 32 (counts by length "
            f"{dict(sorted(collections.Counter(runs).items()))})")


def same_bits(a, b) -> bool:
    """Two tensors or arrays (or lists of them) equal bit for bit (bf16
    tensors as their 16-bit words)."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    a, b = (x.view(torch.int16) if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else x for x in (a, b))
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


class EagerEngine:
    """``engine`` with the eager per-frame loop (``run_chunk_eager``) in
    place of its captured graphs: phase 3g's reference."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def run_chunk(self, state, images):
        from nislam_torch.core.slam import run_chunk_eager

        return run_chunk_eager(self.engine, state, images)

    def run_sequence(self, *args, **kwargs):
        from nislam_torch.core.slam import SlamEngine

        return SlamEngine.run_sequence(self, *args, **kwargs)


class HostLoopTriggerEngine(EagerEngine):
    """``engine`` (its chunk graph) with its triggers as the host loop
    (``optimize_host_loop``, ``finalize_host_loop``: the pending read, the
    edges one by one, the LM loop's condition read per iteration) in place
    of its solve graph: the reference that the solve graph is held
    against."""

    def run_chunk(self, state, images):
        return self.engine.run_chunk(state, images)

    def optimize(self, state):
        from nislam_torch.core.slam import optimize_host_loop

        return optimize_host_loop(self.engine, state)

    def finalize(self, state):
        from nislam_torch.core.slam import finalize_host_loop

        return finalize_host_loop(self.engine, state)


class EagerHostLoopEngine(HostLoopTriggerEngine):
    """``engine`` with the eager per-frame loop and the host-loop triggers:
    every trigger decided and every LM iteration launched and counted from
    the host, the reference that the device-written counts of phase 3i's
    graph paths are held against."""

    run_chunk = EagerEngine.run_chunk


class TriggerSyncs(EagerEngine):
    """An engine-like (``engine``) whose triggers each count their host
    syncs (sync debug mode "warn"): ``syncs`` holds (ran, syncs) per
    trigger, and ``ms`` each trigger's time (host clock around a
    synchronized call)."""

    def __init__(self, engine):
        super().__init__(engine)
        self.syncs, self.ms = [], []

    def run_chunk(self, state, images):
        return self.engine.run_chunk(state, images)

    def _counted(self, trigger, state):
        got = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = host_syncs(lambda: got.update(out=trigger(state)))
        self.ms.append(1e3 * (time.perf_counter() - t0))
        self.syncs.append((got["out"][1], n))
        return got["out"]

    def optimize(self, state):
        return self._counted(self.engine.optimize, state)

    def finalize(self, state):
        return self._counted(self.engine.finalize, state)


class TrackGraphEngine(EagerEngine):
    """``engine`` with the track-graph path (``run_chunk_track_graph``: the track
    graph, the flag read, the keyframe branch launched eagerly) in place of
    its chunk graph."""

    def run_chunk(self, state, images):
        from nislam_torch.core.slam import run_chunk_track_graph

        return run_chunk_track_graph(self.engine, state, images)


class FrameGraphEngine(EagerEngine):
    """``engine`` with its frame graph frame by frame (``run_chunk_frame_graph``:
    the track graph's replay, one flag read, the branch graph's replay) in
    place of its chunk graph."""

    def run_chunk(self, state, images):
        from nislam_torch.core.slam import run_chunk_frame_graph

        return run_chunk_frame_graph(self.engine, state, images)


FOUR = ("chunk graph", "frame graph", "track graph", "eager")  # the paths of a chunk's frames
# The paths that 3g profiles (at the flagship and at HD): the two graphs
# whose launch calls per frame are in question; the track-graph path's and
# the eager loop's figures stand in PERF.md from earlier runs.
PROFILED = ("chunk graph", "frame graph")


def five_paths(engine) -> dict:
    """Phase 3g's paths of one engine: ``{label: engine-like}``: the four
    paths of a chunk's frames, each with the engine's solve graph as its
    trigger, and the chunk graph with the host-loop trigger."""
    return {"chunk graph": engine, "frame graph": FrameGraphEngine(engine), "track graph": TrackGraphEngine(engine),
            "eager": EagerEngine(engine), "host-loop trigger": HostLoopTriggerEngine(engine)}


def chunk_route_line(chunk) -> str:
    """How the chunk graph was built: the route, the node types it found in
    the graphs it nests, and its early exits so far."""
    have = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    return (f"torch {torch.__version__}: CUDAGraph.begin_capture_to_if_node {'present' if have else 'absent'}; "
            f"the route taken: CUDAGraph(keep_graph=True).raw_cuda_graph() of the track and branch graphs nested "
            f"as child graph nodes under the CUDA runtime's WHILE and SWITCH conditional nodes by "
            f"nislam_torch/csrc/cond_graph.cu | node types in the nested graphs: {chunk.node_types} | "
            f"early exits (a branch kind not yet captured) so far: {chunk.early_exits}")


@contextlib.contextmanager
def replays_without_sync():
    """Every replay of a captured step inside the block (a track graph's, a
    keyframe branch's), every chunk-graph launch and every solve-graph
    launch under ``torch.cuda``'s sync debug mode "error": a host sync
    there raises.  Yields a Counter of ``"replays"``, ``"chunks"`` and
    ``"solves"`` that holds their numbers once the block ends."""
    from nislam_torch.core.chunk_graph import _CardGraph
    from nislam_torch.core.solve_graph import _CardSolveGraph
    from nislam_torch.core.track_graph import CapturedStep

    real, real_launch, seen = CapturedStep.run, _CardGraph.launch, collections.Counter()
    real_solve = _CardSolveGraph.launch

    def checked(self):
        if not self.captured:
            return real(self)
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(self)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seen["replays"] += 1

    def checked_launch(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real_launch(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seen["chunks"] += 1

    def checked_solve(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real_solve(self)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seen["solves"] += 1

    CapturedStep.run, _CardGraph.launch, _CardSolveGraph.launch = checked, checked_launch, checked_solve
    try:
        yield seen
    finally:
        CapturedStep.run, _CardGraph.launch, _CardSolveGraph.launch = real, real_launch, real_solve


def per_frame(counts: dict, frames: int) -> str:
    """``launch_counts`` of a trace over ``frames`` frames, per frame."""
    return (f"from the host {counts['host_launches'] / frames:.1f} launch calls per frame "
            f"({counts['kernel_launches'] / frames:.1f} kernel launches + {counts['graph_launches'] / frames:.1f} "
            f"graph launches) | on the device {counts['kernels'] / frames:.1f} kernels per frame")


def most_kernels(trace_path: str, n: int = 5) -> str:
    """The kernel records of one trace and its ``n`` most frequent kernel
    names, for a failing trace check."""
    from nislam_torch.utils.profiling import kernel_counts

    every = kernel_counts(trace_path, "")
    top = sorted(every.items(), key=lambda kv: -kv[1])[:n]
    return f"{sum(every.values())} kernel records, most often " + ", ".join(f"{k[:60]} {v}" for k, v in top)


def profiled(fn, ps, label: str, frames: int) -> dict:
    """``fn()`` under the profiler: prints the busy share within the trace,
    the host's launch calls apart from the device's kernels per frame over
    ``frames`` frames and the kernels' launch counts, and checks that each
    ``peak_stats`` call shows as one kernel → ``launch_counts`` of the
    trace, with its busy share.

    First, on every path, the kernel's own count of the launches that ran
    (``device_launches``) must equal the calls: that check is exact.  The
    profiler's records of the kernels inside a conditional node's body
    are mixed up (CUPTI, driver 580: 125 to 154 of 154 ``peak_stats``
    kernels of one run shown, with grids of other launches, and 243 for
    207 calls in another), so for a run that launches chunk graphs the
    trace must show the kernel under one name at least once, its busy
    share is a lower bound, and CUDA events around each chunk-graph
    launch give its device span, an upper bound (the device's gaps inside
    the graph included), over the host's clock.  CUPTI also drops a record
    now and then outside conditional bodies (335 of 336 shown), so on the
    other paths the trace must show the kernel under one name between
    once and as many times as calls, and the shortfall is printed.  A
    failing trace check names the trace's most frequent kernels.

    Each keyframe branch that runs on the host (the distributed engine's
    staged branch, ``HostBranchFrameGraph.finish``, and the track-graph
    path's eager branch, ``_eager_branch``) is a host range of its own in
    the trace: the launch calls inside those ranges per branch are printed
    (``branch_launches``), and CUDA events around each staged branch join
    the chunk-graph launches' device span."""
    from nislam_torch.core import slam
    from nislam_torch.core.chunk_graph import _CardGraph
    from nislam_torch.core.frame_graph import HostBranchFrameGraph
    from nislam_torch.ops.scatter_add import index_add_ordered
    from nislam_torch.ops.stitch_raster import stitch_raster
    from nislam_torch.utils.profiling import device_activity, kernel_counts, launch_counts, trace

    t0 = time.perf_counter()
    real, real_finish, real_eager, spans = _CardGraph.launch, HostBranchFrameGraph.finish, slam._eager_branch, []

    def timed(fn):
        def call(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans.append((a, b))
            return out
        return call

    def marked(fn):
        def call(*args, **kw):
            with torch.profiler.record_function(BRANCH_RANGE):
                return fn(*args, **kw)
        return call

    with tempfile.TemporaryDirectory(prefix="nislam_prof_") as d:
        ran = ps.device_launches(torch.device("cuda"))
        before = (ps.peak_stats.launches, stitch_raster.launches, index_add_ordered.launches)
        _CardGraph.launch, HostBranchFrameGraph.finish = timed(real), marked(timed(real_finish))
        slam._eager_branch = marked(real_eager)
        try:
            with trace(d):
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t1)
        finally:
            _CardGraph.launch, HostBranchFrameGraph.finish, slam._eager_branch = real, real_finish, real_eager
        calls = [b - a for a, b in zip(before, (ps.peak_stats.launches, stitch_raster.launches,
                                                index_add_ordered.launches))]
        ran = ps.device_launches(torch.device("cuda")) - ran
        path = os.path.join(d, "trace.json")
        act, counts = device_activity(path), launch_counts(path)
        branch = launch_counts(path, within=BRANCH_RANGE)
        names, trace_kernels = kernel_counts(path, "peak_stats"), most_kernels(path)
    check(ran == calls[0], f"{label}: {calls[0]} peak_stats calls counted, {ran} launches ran on the device")
    check(act["busy_ms"] > 0, f"{label}: no device activity in the trace")
    shown = sum(names.values())
    check(len(names) == 1 and 0 < shown and (spans or shown <= calls[0]),
          f"{label}: {calls[0]} peak_stats calls (as many ran on the device) show as {names} in the trace, "
          f"which holds {trace_kernels}")
    span_ms = sum(a.elapsed_time(b) for a, b in spans)
    graph = (f" | {len(spans)} chunk-graph launches and staged branches: device span {span_ms:.1f} ms of the call's "
             f"{wall_ms:.1f} ms on the host's clock = {span_ms / wall_ms:.4f} (CUDA events; the trace shows {shown} "
             f"peak_stats kernels for {calls[0]} calls, so its busy share is a lower bound)" if spans else "")
    per_branch = branch["host_launches"] / branch["ranges"] if branch["ranges"] else None
    if per_branch is not None:
        graph += (f" | {branch['ranges']} keyframe branches on the host: {branch['host_launches']} launch calls in "
                  f"them ({branch['kernel_launches']} kernel + {branch['graph_launches']} graph launches), "
                  f"{per_branch:.1f} per branch")
    print(f"{label}, profiled over {frames} frames: device busy {act['busy_ms']:.1f} ms of the trace's "
          f"{act['window_ms']:.1f} ms window = busy share {act['busy_share']:.4f} (under the profiler) | "
          f"{per_frame(counts, frames)} | launches: peak_stats {calls[0]} (as many ran on the device; "
          f"{f'{shown} in the trace, {calls[0] - shown} records short' if not spans else f'{shown} in the trace, which records a conditional body in part'}), "
          f"stitch_raster {calls[1]}, scatter_add {calls[2]}{graph} | {time.perf_counter() - t0:.1f} s")
    return {**counts, "busy_share": act["busy_share"], "span_share": span_ms / wall_ms if spans else None,
            "branches": branch["ranges"], "branch_launches": per_branch, "frames": frames}


# The host range of a keyframe branch that runs on the host, in a profiled trace.
BRANCH_RANGE = "nislam::keyframe_branch"


def profile_flagship(engine, frames_d, ps, label: str, frames: int = N_PROFILE_FRAMES) -> dict:
    """A profiled chunk of the flagship's frames 64–127 (keyframe frames
    among them; its front end, its tracked frames and its output) through
    ``engine`` (``label`` names its path), after a first chunk of 64
    unprofiled (the init step and the chunk graph's first use out of the
    window) and with no trigger in it → :func:`profiled`'s counts."""
    state, _ = engine.run_chunk(engine.init_state(), frames_d[:N_PROFILE_FRAMES])
    end = N_PROFILE_FRAMES + frames
    return profiled(lambda: engine.run_chunk(state, frames_d[N_PROFILE_FRAMES:end]), ps,
                    f"flagship, {label}, one chunk of frames {N_PROFILE_FRAMES}-{end - 1}", frames)


PROBE_NODES = (1, 2, 3, 4)  # empty kernel nodes in the probe's track graph: the per-node slope


def event_ms(fn, reps: int, dev: torch.device) -> float:
    """Device ms per call of ``fn`` over ``reps`` back-to-back calls after
    one warm-up (one pair of CUDA events)."""
    fn()
    sync(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def frame_bytes(feats, spectrum: bool) -> int:
    """Bytes one frame of the outer body needs moved, each read once and
    written once: ``img_u`` and ``polar``, and the spectrum on a frame
    that inserts; the flags and the output row."""
    lanes = feats[0][0].numel() // feats[0][0].shape[-1] // feats[0][0].shape[-2]
    moved = [0, 2] + ([1] if spectrum else [])
    return 2 * sum(feats[k][0].numel() * feats[k].element_size() for k in moved) + lanes * (2 + 8 * 17)


def outer_body_case(dev, label: str, feats, frames: int, lanes: int = 1) -> dict:
    """``EmptyBodies`` over ``feats``' frames, no branch taken, then every
    lane's stored branch taken: the copied targets bit for bit against the
    last frame (``img_u`` and ``polar`` by the advance; the spectrum only
    by a taken branch, untouched otherwise), µs per frame of each and the
    bound by the bytes each needs."""
    from nislam_torch.core.chunk_graph import EmptyBodies
    from nislam_torch.utils.profiling import bound_ms

    def abs_err(a, b):
        return float((torch.view_as_real(a) - torch.view_as_real(b) if a.is_complex() else a - b).abs().max())

    res = {}
    for taken in (False, True):
        graph = EmptyBodies(dev, frames, feats, taken=taken, lanes=lanes)
        graph.launch()
        sync(dev)
        img_u, fft, polar = graph.targets
        copied = device_bits_equal([img_u, polar], [feats[0][-1], feats[2][-1]])
        spectrum = device_bits_equal([fft], [feats[1][-1]]) if taken else not bool(torch.view_as_real(fft).any())
        err = max(abs_err(img_u, feats[0][-1]), abs_err(polar, feats[2][-1]),
                  abs_err(fft, feats[1][-1] if taken else torch.zeros_like(fft)))
        ctl = graph.ctl[:4].tolist()
        check(copied and spectrum and err == 0.0 and ctl[0] == frames and ctl[3] == frames,
              f"cond_graph {label}: copies (img_u and polar {copied}, spectrum {spectrum}, max abs err {err}) or "
              f"control {ctl} wrong, taken {taken}")
        ms = event_ms(graph.launch, 10, dev)
        bound = bound_ms(frames * frame_bytes(feats, taken))[0]
        res[taken] = {"ms": ms, "us_per_frame": 1e3 * ms / frames, "bound_ms": bound, "max_abs_err": err,
                      "bound_us_per_frame": 1e3 * bound / frames, "nodes": graph.structure["iteration_nodes"],
                      "graph": graph}
    return res


def node_probe(dev, frames: int = CHUNK) -> dict:
    """The per-node probe: µs per WHILE iteration of ``EmptyBodies`` (no
    copy, no branch) whose track graph is a chain of 1–4 empty kernels →
    the µs one empty node adds (the slope, least squares) and the
    iteration's own (the intercept)."""
    from nislam_torch.core.chunk_graph import EmptyBodies

    us = {k: 1e3 * event_ms(EmptyBodies(dev, frames, track_kernels=k).launch, 10, dev) / frames
          for k in PROBE_NODES}
    slope, icept = np.polyfit(np.array(PROBE_NODES, float), np.array([us[k] for k in PROBE_NODES]), 1)
    return {"iteration_us_by_track_kernels": us, "node_us": float(slope), "iteration_fixed_us": float(icept)}


def check_cond_graph(dev: torch.device, engine, frames_d) -> dict:
    """The chunk graph's outer body alone (``cond_graph``): ``EmptyBodies``
    over a 128-frame flagship chunk's real features, over 64 frames of
    HD-size features and over 64 frames of 8 flagship lanes (each lane its
    own frames; the batch engine's one SWITCH over bodies keyed by k), each
    without a branch and with the stored branch (every lane's: body 8)
    taken, the copies bit for bit (:func:`outer_body_case`); the flagship's
    against its plain program on the card (the same copies, the flag read
    and the row copy, frame by frame); the empty bodies with no copies,
    whose difference from the copying runs is the copy's time beside its
    bytes bound; the per-node probe (:func:`node_probe`); the engine's
    built graph's nodes (four per WHILE iteration, one conditional node,
    no count node in a branch body) → the kernels-line figures (ms per
    128-frame launch)."""
    from nislam_torch.core.chunk_graph import EmptyBodies

    t0 = time.perf_counter()
    feats = tuple(x.contiguous() for x in engine._features(frames_d[:CHUNK]))
    flag = outer_body_case(dev, "flagship", feats, CHUNK)
    graph = flag[False]["graph"]

    def plain():
        for i in range(CHUNK):
            graph.targets[0].copy_(feats[0][i])
            graph.targets[2].copy_(feats[2][i])
            graph.flags.tolist()
            graph.out[i].copy_(graph.packed[0])

    plain_ms = event_ms(plain, 3, dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    hd_shapes = ((1200, 1600), (1200, 801), (360, 241))
    hd_feats = tuple(torch.rand((HD_CHUNK, *s), generator=gen, device=dev, dtype=torch.float32) if k == 0 else
                     torch.view_as_complex(torch.rand((HD_CHUNK, *s, 2), generator=gen, device=dev))
                     for k, s in enumerate(hd_shapes))
    hd = outer_body_case(dev, "HD segments", hd_feats, HD_CHUNK)
    del hd_feats
    pick = torch.arange(BATCH_CHUNK * N_BATCH, device=dev).reshape(BATCH_CHUNK, N_BATCH) % CHUNK
    lane_feats = tuple(x[pick].contiguous() for x in feats)
    lanes8 = outer_body_case(dev, f"{N_BATCH} lanes", lane_feats, BATCH_CHUNK, N_BATCH)
    del lane_feats
    empty = {taken: 1e3 * event_ms(EmptyBodies(dev, CHUNK, taken=taken).launch, 10, dev) / CHUNK
             for taken in (False, True)}
    empty8 = 1e3 * event_ms(EmptyBodies(dev, CHUNK, lanes=N_BATCH).launch, 10, dev) / CHUNK
    probe = node_probe(dev)
    st = engine.chunk_graph.structure
    check(st["iteration_nodes"] <= 4 and st["branch_kernels"] == st["branch_copies"]
          and st["iteration_conditionals"] <= 1,
          f"cond_graph: the engine's chunk graph {st}: more than 4 nodes per WHILE iteration, a conditional node per "
          f"kind or a kernel other than the spectrum copy in a branch body")
    nodes = flag[False]["nodes"]
    floor_ms = 1e-3 * CHUNK * nodes * probe["node_us"]
    ms, bound_ms = flag[False]["ms"], flag[False]["bound_ms"]
    # The copies' own time: the copying run less the same graph copying nothing.
    copy_share = {label: case[False]["bound_us_per_frame"] / (case[False]["us_per_frame"] - empty[False])
                  for label, case in (("flagship", flag), ("hd", hd))}

    def row(label, case):
        return (f"{label}: {case[False]['us_per_frame']:.2f} us per frame, no branch (bound "
                f"{case[False]['bound_us_per_frame']:.3f}, share "
                f"{case[False]['bound_us_per_frame'] / case[False]['us_per_frame']:.3f}), "
                f"{case[True]['us_per_frame']:.2f} with every lane's stored branch (its spectrum copied too; bound "
                f"{case[True]['bound_us_per_frame']:.3f}), {case[False]['nodes']} nodes per WHILE iteration")

    print(f"cond_graph on the engine's chunk graph: {st}")
    print(f"cond_graph outer body (nested graphs empty, the copies bit for bit against the last frame: img_u and polar "
          f"by the advance, the spectrum only by a taken branch) | " + " | ".join(
              row(label, case) for label, case in (("flagship 128 frames", flag), ("HD segments 64 frames", hd),
                                                   (f"{N_BATCH} flagship lanes 64 frames", lanes8))))
    print(f"cond_graph flagship: {ms:.4f} ms per 128-frame launch, the plain program on the card {plain_ms:.4f} ms, "
          f"bound by needed bytes {bound_ms:.4f} ms (share {bound_ms / ms:.3f}), structure floor {floor_ms:.4f} ms "
          f"({nodes} nodes x {probe['node_us']:.3f} us)")
    print(f"cond_graph empty bodies, no copy: {empty[False]:.2f} us per WHILE iteration with no branch taken, "
          f"{empty[True]:.2f} with the stored branch taken; one SWITCH over {N_BATCH} bodies ({N_BATCH} lanes) "
          f"{empty8:.2f} | the copies' share of "
          f"their bytes bound (bound over the copying run less the empty one): flagship {copy_share['flagship']:.3f}, "
          f"HD {copy_share['hd']:.3f}")
    print(f"cond_graph per-node probe: us per WHILE iteration by empty kernels in the track graph "
          f"{ {k: round(v, 3) for k, v in probe['iteration_us_by_track_kernels'].items()} } -> "
          f"{probe['node_us']:.3f} us per node + {probe['iteration_fixed_us']:.3f}")
    print(f"cond_graph phase: {time.perf_counter() - t0:.1f} s")
    cases = {label: {str(k): {kk: vv for kk, vv in v.items() if kk != "graph"} for k, v in case.items()}
             for label, case in (("flagship", flag), ("hd", hd), ("lanes8", lanes8))}
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "max_abs_err": max(v["max_abs_err"] for case in cases.values() for v in case.values()),
            "empty_us": empty, "empty8_us": empty8, "probe": probe, "floor_ms": floor_ms, "nodes": nodes,
            "copy_share": copy_share, "structure": st, "cases": cases}


def chunk_syncs(eng, frames_d) -> tuple:
    """The host syncs of one whole chunk (frames CHUNK to 2·CHUNK, keyframe
    frames among them) after a first chunk through ``eng`` → (syncs,
    frames, keyframe frames)."""
    state, _ = eng.run_chunk(eng.init_state(), frames_d[:CHUNK])
    got = {}

    def chunk():
        got["out"] = eng.run_chunk(state, frames_d[CHUNK:2 * CHUNK])

    syncs = host_syncs(chunk)
    return syncs, CHUNK, int(got["out"][1].inserted.sum())


def check_graph(ps, dev, card: str, engine, frames_d, state, outs, costs, launches: int) -> dict:
    """Phase 3g: the flagship through the engine's chunk graph (phase 3's
    run: ``state``, ``outs``, the solves' ``costs``, its ``peak_stats``
    ``launches``) against the flag-read frame graph, the track-graph path
    and the eager per-frame loop, bit for bit, with as many ``peak_stats``
    launches; every replay and chunk launch without a host sync, and the
    host syncs of one whole chunk; launch calls and kernels per frame of
    the chunk graph and the frame graph in a profiled trace; frames/s of
    each, one after another →
    ``{path: profile counts, "fps": {path: [frames/s, ...]}, "syncs"}``."""
    from nislam_torch.core.slam import pack_outputs, state_leaves

    t0 = time.perf_counter()
    print(f"3g on {card}")
    print(f"3g: {chunk_route_line(engine.chunk_graph)}")
    print(f"3g: {solve_route_line(engine.solve_graph)}")
    paths = five_paths(engine)
    for label in ("frame graph", "track graph", "eager", "host-loop trigger"):
        sync(dev)
        calls = ps.peak_stats.launches
        with recorded_solves() as other_costs:
            ostate, oouts, _ = run_slice(paths[label], frames_d)
        calls = ps.peak_stats.launches - calls
        check(calls == launches, f"3g: {calls} peak_stats launches through the {label}, {launches} through the "
                                 f"chunk graph")
        check(len(costs) == len(other_costs) and same_bits(costs, other_costs),
              f"3g: the {label}'s solve costs differ from the chunk graph's")
        check(same_bits(pack_outputs(outs), pack_outputs(oouts)), f"3g: the {label}'s outputs differ from the "
                                                                   f"chunk graph's")
        check(same_bits(state.bank.poses, ostate.bank.poses), f"3g: the {label}'s bank poses differ")
        check(same_bits(state_leaves(ostate), state_leaves(state)),
              f"3g: the {label}'s final state differs from the chunk graph's")
        del ostate, oouts
    inserted = int(outs.inserted[1:].sum())
    fps = {label: [] for label in paths}
    exits = engine.chunk_graph.early_exits
    for label, eng in paths.items():
        sync(dev)
        t1 = time.perf_counter()
        with replays_without_sync() as seen:
            _, o, _ = run_slice(eng, frames_d)
        sync(dev)
        fps[label].append(N_FRAMES / (time.perf_counter() - t1))
        check(same_bits(pack_outputs(o), pack_outputs(outs)), f"3g: a {label} run's outputs differ")
        # a tracked frame replays its track graph, a keyframe frame its branch
        # too, or every tracked frame of a chunk is one chunk-graph launch;
        # every trigger (4 between chunks, finalize) one solve-graph launch
        want = {"chunk graph": (0, N_FRAMES // CHUNK), "frame graph": (N_FRAMES - 1 + inserted, 0),
                "track graph": (N_FRAMES - 1, 0), "eager": (0, 0),
                "host-loop trigger": (0, N_FRAMES // CHUNK)}[label]
        triggers = 0 if label == "host-loop trigger" else N_FRAMES // CHUNK + 1
        check((seen["replays"], seen["chunks"], seen["solves"]) == (*want, triggers),
              f"3g: {seen['replays']} replays, {seen['chunks']} chunk launches and {seen['solves']} solve-graph "
              f"launches checked in a {label} run, {(*want, triggers)} expected")
    check(engine.chunk_graph.early_exits == exits, "3g: the chunk graph exited early after its warm-up")
    print(f"3g flagship, {N_FRAMES} frames: the flag-read frame graph, the track-graph path, the eager loop and the "
          f"host-loop trigger equal the chunk graph with its solve graph bit for bit ({len(costs)} solves' costs, "
          f"outputs, bank poses, every state leaf) with as many peak_stats launches ({launches}); no host sync in "
          f"any chunk launch, solve-graph launch or replay (sync debug mode error: {N_FRAMES // CHUNK} chunk "
          f"launches and {N_FRAMES // CHUNK + 1} solve-graph launches per chunk-graph run, {N_FRAMES - 1} track "
          f"graph replays and {inserted} keyframe branch replays per frame-graph run); every run in turns below "
          f"equal to these bit for bit; early exits in them 0")
    print("3g flagship frames/s in turns (chunk graph, frame graph, track graph, eager, host-loop trigger, once; "
          "deferred solves and finalize included): "
          + ", ".join(f"{label} {fps[label][0]:.1f}" for label in paths)
          + " | chunk graph / frame graph "
          f"{np.mean(fps['chunk graph']) / np.mean(fps['frame graph']):.2f}x, chunk graph / eager "
          f"{np.mean(fps['chunk graph']) / np.mean(fps['eager']):.2f}x, solve graph / host-loop trigger "
          f"{np.mean(fps['chunk graph']) / np.mean(fps['host-loop trigger']):.2f}x")
    trig = trigger_syncs(paths, frames_d, "3g flagship")
    syncs = {}
    for label in FOUR:
        syncs[label] = chunk_syncs(paths[label], frames_d)
    n_sync, n, n_kf = syncs["chunk graph"]
    check(n_kf > 0, "3g: the checked chunk has no keyframe frame")
    check(n_sync <= 3, f"3g: {n_sync} host syncs in one chunk of {n} frames through the chunk graph, at most 3")
    check(syncs["frame graph"][0] == n, f"3g: {syncs['frame graph'][0]} host syncs in one chunk of {n} frames "
                                        f"through the frame graph, {n} expected (one flag read per frame)")
    print("3g host syncs in one whole chunk of " + f"{n} frames ({n_kf} keyframe frames) after a first chunk: "
          + ", ".join(f"{label} {v[0]}" for label, v in syncs.items())
          + " (the chunk graph's: the read of its control block after the launch; the frame graph's: one flag "
            "read per frame; both skip the initialized read for the state their graph lent; the others: the "
            "initialized read and one flag read per frame)")
    prof = {label: profile_flagship(paths[label], frames_d, ps, label, N_PROFILE_FRAMES) for label in PROFILED}
    check(prof["chunk graph"]["host_launches"] / N_PROFILE_FRAMES < 0.5,
          f"3g: {prof['chunk graph']['host_launches'] / N_PROFILE_FRAMES:.2f} host launch calls per frame through "
          f"the chunk graph, not below 0.5")
    cache = torch.backends.cuda.cufft_plan_cache[dev.index]
    check(cache.size < cache.max_size, f"3g: cuFFT plan cache at {cache.size} of {cache.max_size}: plans evicted")
    print(f"3g: cuFFT plan cache {cache.size} plans of at most {cache.max_size} (none evicted) | "
          f"{time.perf_counter() - t0:.1f} s")
    return {**prof, "fps": fps, "syncs": {label: v[0] for label, v in syncs.items()}, "trigger": trig}


def inline_config():
    """The flagship with the inline solve (``optimizer.inline``)."""
    import dataclasses

    config = flagship_config()
    return dataclasses.replace(config, optimizer=dataclasses.replace(config.optimizer, inline=True))


def inline_slice(eng, frames_d, sg):
    """The flagship through ``eng`` with the inline solve:
    ``run_sequence`` (no trigger between chunks), then ``finalize`` (the
    deferred solve graph ``sg``) → (state, outputs, the last inline
    solve's final cost, the finalize's costs).  The graphs' inline solves
    leave their cost in ``sg``'s buffer (read after the sequence); the
    host loop's are recorded as they come."""
    with recorded_solves() as costs:
        state, outs = eng.run_sequence(eng.init_state(), frames_d, chunk_frames=CHUNK)
        n = len(costs)
        last = costs[-1].clone() if costs else sg.final_cost[0].clone()
        state, _ = eng.finalize(state)
    return state, outs, last, costs[n:]


def inline_paths(ps, dev, engine, frames_d, turns: int, what: str) -> tuple:
    """``frames_d`` with the inline solve through ``engine``'s chunk graph
    (the inline trigger nested in its stored body), its flag-read frame
    graph (the inline trigger one graph launch after the stored branch),
    the track-graph path and the eager loop (both the host loop's
    ``_flush_pending_loops``; the eager loop's finalize the host loop's
    too), each after a warm-up that captures, in turns, ``turns`` times:
    outputs, the last inline solve's cost, the finalize's, every state
    leaf bit for bit, as many ``peak_stats`` and ``scatter_add`` launches
    (``peak_stats``' device count equal), ``trigger`` and ``lm_step``
    launches equal to their device counts, the trigger's launches equal to
    what the outputs show (on the graph paths one after each stored
    keyframe, and one for the finalize but on the eager loop, whose host
    loop launches none), ``lm_step``'s equal on every path to the eager
    loop's, which the host launched and counted, no host sync in a replay
    or a graph launch → ({path: (state, outputs, last inline cost,
    finalize costs, counts)} of the first turn, {path: [frames/s]})."""
    from nislam_torch.core.chunk_graph import ChunkGraph
    from nislam_torch.core.pose_graph import lm_step
    from nislam_torch.core.slam import pack_outputs, state_leaves
    from nislam_torch.core.solve_graph import SolveGraph, trigger
    from nislam_torch.kernels.launch import solve_device_launches
    from nislam_torch.ops import scatter_add as sa

    sg = engine.solve_graph
    paths = {"chunk graph": engine, "frame graph": FrameGraphEngine(engine), "track graph": TrackGraphEngine(engine),
             "eager": EagerHostLoopEngine(engine)}
    for eng in paths.values():
        inline_slice(eng, frames_d, sg)  # captures and builds
    first, fps = {}, {label: [] for label in paths}
    for turn in range(turns):
        lm_steps = {}
        for label, eng in paths.items():
            sync(dev)
            ran, sran = ps.device_launches(dev), solve_device_launches(dev)
            ps.peak_stats.launches = sa.index_add_ordered.launches = 0
            ChunkGraph.launches = SolveGraph.launches = SolveGraph.inline_launches = 0
            trigger.launches = lm_step.launches = 0
            t1 = time.perf_counter()
            with replays_without_sync() as seen:
                state, outs, last, fcosts = inline_slice(eng, frames_d, sg)
            sync(dev)
            fps[label].append(len(frames_d) / (time.perf_counter() - t1))
            counts = {"peak_stats": ps.peak_stats.launches, "scatter_add": sa.index_add_ordered.launches,
                      "trigger": trigger.launches, "lm_step": lm_step.launches, "chunk_graph": ChunkGraph.launches,
                      "inline_graph": SolveGraph.inline_launches, "solve_graph": SolveGraph.launches,
                      "checked": dict(seen)}
            ran = ps.device_launches(dev) - ran
            sran = [b - a for a, b in zip(sran, solve_device_launches(dev))]
            check(ran == counts["peak_stats"] > 0, f"{what} {label}: {counts['peak_stats']} peak_stats calls "
                                                   f"counted, {ran} launches ran on the device")
            check([counts["trigger"], counts["lm_step"]] == sran,
                  f"{what} {label}: trigger and lm_step launches counted {counts['trigger']}, {counts['lm_step']}, "
                  f"run on the device {sran}")
            stored = int(((outs.keyframe_slot >= 0) & (outs.frame_id > 0)).sum())
            want = (stored if label in ("chunk graph", "frame graph") else 0) + (label != "eager")
            check(counts["trigger"] == want, f"{what} {label}: {counts['trigger']} trigger launches, {want} expected "
                                             f"from {stored} stored keyframes and the finalize")
            lm_steps[label] = counts["lm_step"]
            solves = int(outs.optimized.sum())
            if label not in first:
                first[label] = (state, outs, last, fcosts, counts)
            ref = first["chunk graph"]
            check(same_bits(pack_outputs(outs), pack_outputs(ref[1])), f"{what}: the {label}'s outputs differ from "
                                                                       f"the chunk graph's")
            check(not solves or same_bits(last, ref[2]), f"{what}: the {label}'s last inline solve's cost {last} "
                                                         f"differs from the chunk graph's {ref[2]}")
            check(len(fcosts) == len(ref[3]) and same_bits(fcosts, ref[3]),
                  f"{what}: the {label}'s finalize costs differ from the chunk graph's")
            check(same_bits(state_leaves(state), state_leaves(ref[0])),
                  f"{what}: the {label}'s final state differs from the chunk graph's")
            check(counts["peak_stats"] == ref[4]["peak_stats"] and counts["scatter_add"] == ref[4]["scatter_add"],
                  f"{what}: the {label}'s counted launches {counts} differ from the chunk graph's {ref[4]}")
            del state
        check(len(set(lm_steps.values())) == 1, f"{what}: lm_step launches per path {lm_steps}, the eager loop's "
                                                f"counted by the host")
    return first, fps


def check_inline(ps, dev, card: str, frames_d) -> dict:
    """Phase 3i: the flagship with the inline solve through the four paths
    (:func:`inline_paths`), in turns, twice; the host syncs of one whole
    chunk; the built graph's nodes and conditional depth; frames/s of
    each.  Then phase 8's loop (the inline solve and the online canvas,
    96 frames, whose inline trigger solves) through the same four paths
    once, bit for bit (the canvas among the leaves) → the chunk graph's
    figures."""
    from nislam_torch.core.slam import make_engine

    t0 = time.perf_counter()
    engine = make_engine(inline_config(), dev)
    exits = engine.chunk_graph.early_exits
    first, fps = inline_paths(ps, dev, engine, frames_d, 2, "3i")
    paths = {label: eng for label, eng in zip(first, (engine, FrameGraphEngine(engine),
                                                      TrackGraphEngine(engine), EagerHostLoopEngine(engine)))}
    exits = engine.chunk_graph.early_exits - exits
    state, outs, last, fcosts, counts = first["chunk graph"]
    solves, loops = int(outs.optimized.sum()), int(outs.loop_found.sum())
    check(int(outs.tracked.sum()) == N_FRAMES, "3i: a frame was not tracked")
    check(counts["chunk_graph"] == N_FRAMES // CHUNK and counts["inline_graph"] == 0 and counts["trigger"] > 0
          and exits == 1,
          f"3i: the chunk graph's run {counts}, early exits {exits}: want {N_FRAMES // CHUNK} chunk launches, no "
          f"inline graph launch outside them, the trigger launched, one early exit (the warm-up's stored kind)")
    check(not solves or (counts["lm_step"] > 0 and counts["scatter_add"] > 0),
          f"3i: {solves} inline solves, but lm_step and scatter_add launches {counts}")
    check(first["frame graph"][4]["inline_graph"] > 0, "3i: the frame graph launched no inline trigger graph")
    syncs = {label: chunk_syncs(paths[label], frames_d) for label in ("chunk graph", "frame graph")}
    n_sync, n, n_kf = syncs["chunk graph"]
    check(n_sync <= 3, f"3i: {n_sync} host syncs in one chunk of {n} frames through the chunk graph, at most 3")
    st, types_ = engine.chunk_graph.structure, engine.chunk_graph.node_types
    check(st["depth"] == 4 and st["inline_ifs"] == 1 and set(types_) <= {"kernel", "memcpy", "memset"},
          f"3i: the built graph {st}, node types {types_}: want WHILE -> SWITCH -> IF -> WHILE")
    print(f"3i on {card}: the flagship with the inline solve, {N_FRAMES} frames: {loops} loops, {solves} inline "
          f"solves (last cost {float(last) if solves else None}), finalize {len(fcosts)} solve(s) | the frame graph, "
          f"the track-graph path and the eager loop equal the chunk graph bit for bit (outputs, the last inline solve's cost, the "
          f"finalize's, every state leaf), with as many peak_stats ({counts['peak_stats']}, equal to its device "
          f"count) and scatter_add launches ({counts['scatter_add']}); no host sync in a replay or a graph launch; "
          f"the chunk graph's run: {counts['chunk_graph']} chunk launches, trigger {counts['trigger']} and lm_step "
          f"{counts['lm_step']} launches (as many ran on the device), early exits 1 (the warm-up's stored kind) | per "
          f"path {dict((k, v[4]) for k, v in first.items())}")
    print(f"3i built graph: {st} | node types in the nested graphs {types_}")
    print("3i frames/s in turns (chunk graph, frame graph, track graph, eager, twice; finalize included): "
          + ", ".join(f"{label} {fps[label][i]:.1f}" for i in range(2) for label in paths)
          + f" | chunk graph / frame graph {np.mean(fps['chunk graph']) / np.mean(fps['frame graph']):.2f}x, "
          f"chunk graph / track graph {np.mean(fps['chunk graph']) / np.mean(fps['track graph']):.2f}x, "
          f"chunk graph / eager {np.mean(fps['chunk graph']) / np.mean(fps['eager']):.2f}x")
    print(f"3i host syncs in one whole chunk of {n} frames ({n_kf} keyframe frames) after a first chunk: "
          + ", ".join(f"{label} {v[0]}" for label, v in syncs.items())
          + " (the frame graph: one flag read per frame and one read of the inline trigger's counts)")
    del first
    # Phase 8's loop, whose inline trigger solves: the same four paths.
    config = flagship_config()
    frames8, offsets = option_frames(config.cf.height, config.cf.width)
    oengine = make_engine(option_config(config, offsets), dev)
    frames8_d = torch.from_numpy(frames8).to(dev)
    ofirst, ofps = inline_paths(ps, dev, oengine, frames8_d, 2, "3i, phase 8's loop")
    _, oouts, olast, _, ocounts = ofirst["chunk graph"]
    osolves = int(oouts.optimized.sum())
    check(osolves >= 1 and ocounts["lm_step"] > 0 and ocounts["inline_graph"] == 0,
          f"3i, phase 8's loop: {osolves} inline solves, launches {ocounts}")
    print(f"3i, phase 8's loop (the inline solve and the online canvas, {len(frames8)} frames): {osolves} inline "
          f"solve(s), the last one's cost {float(olast)} | the frame graph, the track-graph path and the eager loop equal the "
          f"chunk graph bit for bit (outputs, the inline solve's cost, every state leaf, the canvas among them), "
          f"trigger and lm_step launches equal to their device counts and to what the outputs and the eager loop's "
          f"host count show | per path {dict((k, v[4]) for k, v in ofirst.items())}")
    print("3i, phase 8's loop, frames/s in turns (chunk graph, frame graph, track graph, eager, twice; finalize "
          "included): " + ", ".join(f"{label} {ofps[label][i]:.1f}" for i in range(2) for label in ofps))
    solve_launch = inline_solve_launch(oengine, frames8_d, oouts)
    print(f"3i, phase 8's loop: frame {solve_launch['frame']}, whose inline trigger solves, as a chunk of one "
          f"through the chunk graph, from a fresh state each time: CUDA events around the launch "
          f"{', '.join(f'{x:.3f}' for x in solve_launch['ms'])} ms, host clock with its read "
          f"{', '.join(f'{x:.3f}' for x in solve_launch['host_ms'])} ms; frame {solve_launch['frame'] - 1} before "
          f"it ({solve_launch['before']}) {', '.join(f'{x:.3f}' for x in solve_launch['before_ms'])} ms "
          f"| 3i: {time.perf_counter() - t0:.1f} s")
    del ofirst, oengine
    return {"fps": fps, "syncs": {label: v[0] for label, v in syncs.items()}, "counts": counts, "solves": solves,
            "structure": st, "node_types": types_, "loop8_solves": osolves, "loop8_fps": ofps,
            "solve_launch": solve_launch}


def inline_solve_launch(engine, frames_d, outs, runs: int = 3) -> dict:
    """The chunk launch that holds a real inline solve: ``frames_d``
    through ``engine``'s chunk graph up to the first frame whose inline
    trigger solved in ``outs``, then the frame before it and that frame,
    each as a chunk of its own, timed with CUDA events around the launch
    and on the host's clock with the chunk's one read, ``runs`` times from
    a fresh state (each run must solve at that frame) → {"frame", "ms",
    "host_ms", "before" (the frame before: its flags), "before_ms"}."""
    solved = outs.optimized
    i = int(np.flatnonzero(solved.cpu().numpy() if isinstance(solved, torch.Tensor) else np.asarray(solved))[0])
    res = {"frame": i, "ms": [], "host_ms": [], "before_ms": []}
    for _ in range(runs):
        state, _ = engine.run_chunk(engine.init_state(), frames_d[:i - 1])
        for j in (i - 1, i):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            sync(frames_d.device)
            t1 = time.perf_counter()
            a.record()
            state, o = engine.run_chunk(state, frames_d[j:j + 1])
            b.record()
            host_ms = 1e3 * (time.perf_counter() - t1)
            b.synchronize()
            if j == i:
                check(bool(o.optimized.reshape(-1)[0]), f"3i: frame {i} run as a chunk of one did not solve")
                res["ms"].append(a.elapsed_time(b))
                res["host_ms"].append(host_ms)
            else:
                res["before_ms"].append(a.elapsed_time(b))
                res["before"] = {k: bool(getattr(o, k).reshape(-1)[0]) for k in ("inserted", "loop_found")}
                res["before"]["stored"] = bool(o.keyframe_slot.reshape(-1)[0] >= 0)
        del state
    return res


def solve_route_line(sg) -> str:
    """How the solve graph was built: the node types in its captured
    steps and its nodes at each level."""
    return (f"the solve graph: the trigger kernel and an IF node; under the IF the setup's captured graph, a WHILE "
            f"node (the LM iteration's captured graph, the lm_step kernel) and the finish's captured graph, built "
            f"by nislam_torch/csrc/cond_graph.cu | built {sg.built} | node types in the captured steps "
            f"{sg.node_types} | nodes {sg.structure}")


def trigger_syncs(paths: dict, frames_d, what: str) -> dict:
    """The host syncs and ms of each trigger of one flagship run through the
    chunk graph with its solve graph and with the host-loop trigger →
    {label: {"syncs": [...], "ms": [...]} of the triggers that ran}."""
    res = {}
    for label in ("chunk graph", "host-loop trigger"):
        eng = TriggerSyncs(paths[label])
        run_slice(eng, frames_d)
        ran = [i for i, (r, _) in enumerate(eng.syncs) if r]
        res[label] = {"syncs": [eng.syncs[i][1] for i in ran], "ms": [eng.ms[i] for i in ran],
                      "idle": [n for r, n in eng.syncs if not r]}
    graph = res["chunk graph"]
    check(graph["syncs"] and max(graph["syncs"] + graph["idle"]) <= 1,
          f"{what}: host syncs per trigger through the solve graph {graph}, at most 1 expected")
    print(f"{what} host syncs per trigger that solved (sync debug mode warn): " + "; ".join(
        f"{label} {v['syncs']} (ms per trigger {', '.join(f'{x:.2f}' for x in v['ms'])}; triggers that did not "
        f"solve: {v['idle']})" for label, v in res.items()))
    return res


def device_bits_equal(a, b) -> bool:
    """Two lists of tensors on the card equal bit for bit, compared there
    (floats as integers of their width)."""
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        if x.is_floating_point():
            width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
            x, y = x.view(width), y.view(width)
        if not torch.equal(x, y):
            return False
    return True


def graph_hd(ps, dev, root: str, cfg: str) -> dict:
    """Phase 3g at HD: the CLI's drive (``streamed_deferred_drive`` over
    the NISF reader's pinned chunks, ``finalize``) through the engine's
    chunk graph, its flag-read frame graph, the track-graph path and the
    eager loop, one after another after a warm-up that captures: outputs,
    solve costs, bank poses, every state leaf and the peak_stats launches
    bit for bit, every replay and chunk launch without a host sync; one
    profiled 64-frame chunk of the chunk graph and of the frame graph
    after a first, in a process of its own
    (:func:`hd_profiles_main`) → ``{"fps": {path: [frames/s, ...]}, path:
    profile counts, "early_exits": in the warm-up}``."""
    from nislam_torch.core.config import load_config
    from nislam_torch.core.slam import make_engine, pack_outputs, state_leaves, streamed_deferred_drive
    from nislam_torch.io.native_loader import NativeChunkReader

    t0 = time.perf_counter()
    engine = make_engine(load_config(cfg), dev)
    paths = five_paths(engine)

    def drive(eng, max_frames=0):
        reader = NativeChunkReader(os.path.join(root, "frames.nisf"), HD_CHUNK, pin=True)
        try:
            with recorded_solves() as costs:
                state, outs, _, _ = streamed_deferred_drive(eng, eng.init_state(), iter(reader),
                                                            max_frames=max_frames)
                state, _ = eng.finalize(state)
        finally:
            reader.close()
        return state, outs, costs

    for label in ("chunk graph", "frame graph", "track graph"):
        drive(paths[label])  # warm-up: the captures
    exits = engine.chunk_graph.early_exits
    fps, runs, ref = {label: [] for label in paths}, {}, None
    for label, eng in paths.items():
        sync(dev)
        calls = ps.peak_stats.launches
        t1 = time.perf_counter()
        with replays_without_sync() as seen:
            state, outs, costs = drive(eng)
        sync(dev)
        fps[label].append(len(outs.tracked) / (time.perf_counter() - t1))
        check(label == "eager" or seen["replays"] + seen["chunks"] > 0, f"3g HD: no replay through the {label}")
        if label not in runs:
            runs[label] = (state.bank.poses.cpu(), outs, costs, ps.peak_stats.launches - calls)
            if ref is None:
                ref = state  # the chunk graph's: every other path's first run against it
            else:
                check(device_bits_equal(state_leaves(state), state_leaves(ref)),
                      f"3g HD: the {label}'s final state differs from the chunk graph's")
        del state
    del ref
    check(engine.chunk_graph.early_exits == exits, "3g HD: the chunk graph exited early after its warm-up")
    gp, go, gc, gl = runs["chunk graph"]
    check(int(go.tracked.sum()) == N_HD_FRAMES, f"3g HD: tracked {int(go.tracked.sum())} of {N_HD_FRAMES}")
    check(len(gc) > 0, "3g HD: no solve")
    for label in ("frame graph", "track graph", "eager", "host-loop trigger"):
        p, o, c, n = runs[label]
        check(same_bits(gc, c), f"3g HD: the solve costs differ between the chunk graph and the {label}")
        check(same_bits(pack_outputs(go), pack_outputs(o)), f"3g HD: the outputs differ between the chunk graph "
                                                             f"and the {label}")
        check(same_bits(gp, p), f"3g HD: the bank poses differ between the chunk graph and the {label}")
        check(n == gl, f"3g HD: {n} peak_stats launches through the {label}, {gl} through the chunk graph")
    print(f"3g HD via the CLI's drive, {N_HD_FRAMES} frames ({int(go.inserted.sum())} keyframe frames): the "
          f"flag-read frame graph, the track-graph path, the eager loop and the host-loop trigger equal the chunk "
          f"graph with its solve graph bit for bit "
          f"({len(gc)} solves' costs, outputs, bank poses, every state leaf, {gl} peak_stats launches each); no "
          f"host sync in any chunk launch or replay; early exits {exits} in the warm-up, 0 after it | frames/s in "
          f"turns (once): " + ", ".join(f"{label} {fps[label][0]:.1f}" for label in paths)
          + f" | chunk graph / frame graph {np.mean(fps['chunk graph']) / np.mean(fps['frame graph']):.2f}x, "
            f"chunk graph / eager {np.mean(fps['chunk graph']) / np.mean(fps['eager']):.2f}x, solve graph / "
            f"host-loop trigger {np.mean(fps['chunk graph']) / np.mean(fps['host-loop trigger']):.2f}x | "
            f"{time.perf_counter() - t0:.1f} s")
    # One profiled chunk of each path in a process of its own
    # (hd_profiles_main).
    out = os.path.join(root, "hd_profiles.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--hd-profiles", root, cfg, out],
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="")
    check(proc.returncode == 0, f"3g HD profiles: exit {proc.returncode}: {proc.stderr[-3000:]}")
    with open(out) as f:
        prof = json.load(f)
    return {"fps": fps, **prof, "early_exits": exits}


def hd_profiles_main(argv) -> int:
    """Phase 3g's HD profiles (``chip_smoke.py --hd-profiles ROOT CFG
    OUT``): one profiled chunk of frames 64-127 (the second chunk of the
    CLI's drive) through the chunk graph and the frame graph of one
    engine (:data:`PROFILED`), after its
    warm-up and a first chunk unprofiled (:func:`profiled`'s checks) →
    their counts, as JSON in OUT.  It runs in a process of its own, whose
    profiler starts before any graph is made: CUPTI names the kernels of a
    conditional body from what it saw of the graphs, and in the smoke's
    own process, after many graphs were made and freed, an HD chunk
    graph's trace named none of its 215 ``peak_stats`` kernels, all of
    which ran."""
    from nislam_torch.core.config import load_config
    from nislam_torch.core.slam import make_engine
    from nislam_torch.io.native_loader import NativeChunkReader
    from nislam_torch.ops import peak_stats as ps
    from nislam_torch.utils.profiling import trace

    root, cfg, out = argv
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="nislam_prof_") as d:
        with trace(d):
            torch.ones(1, device=dev).sum().item()
    reader = NativeChunkReader(os.path.join(root, "frames.nisf"), HD_CHUNK)
    try:
        chunks = [torch.from_numpy(np.stack([reader.frame(i) for i in range(a, a + HD_CHUNK)])).to(dev)
                  for a in (0, HD_CHUNK)]
    finally:
        reader.close()
    engine = make_engine(load_config(cfg), dev)
    paths = five_paths(engine)
    prof = {}
    for label in PROFILED:
        eng = paths[label]
        for _ in range(2):  # captures, and the chunk graph built again after a branch kind's first use
            first, _ = eng.run_chunk(eng.init_state(), chunks[0])
            eng.run_chunk(first, chunks[1])
        first, _ = eng.run_chunk(eng.init_state(), chunks[0])
        prof[label] = profiled(lambda: eng.run_chunk(first, chunks[1]), ps,
                               f"HD, {label}, one chunk of frames {HD_CHUNK}-{2 * HD_CHUNK - 1}", HD_CHUNK)
        del first
    with open(out, "w") as f:
        json.dump(prof, f)
    return 0


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

    ran = ps.device_launches(dev)
    ps.peak_stats.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["--max-frames", str(N_PROFILE_FRAMES), "--profile", os.path.join(root, "prof"),
                          "--saving-root", os.path.join(root, "prof_out")])
    prof_launches = ps.peak_stats.launches
    ran = ps.device_launches(dev) - ran
    b = re.search(r"profiled window ([\d.]+) ms: device busy ([\d.]+) ms \(share ([\d.]+)\), "
                  r"(\d+) kernel launches \(\d+ per frame\) and (\d+) graph launches \([\d.]+ per frame\) "
                  r"from the host, (\d+) device kernels", out)
    # The run's chunk graphs hold the kernels inside conditional bodies,
    # whose records the trace keeps in part (see profiled): the device's
    # count is held exactly first, then one kernel name shown at least once.
    check(ran == prof_launches, f"HD profile: {prof_launches} peak_stats calls counted, {ran} launches ran on the "
                                f"device")
    check(prof_launches >= 2 * N_PROFILE_FRAMES, f"HD profile: {prof_launches} launches")
    check(b is not None and float(b.group(2)) > 0, "HD profile: no device activity in the trace")
    prof_trace = os.path.join(root, "prof", "trace.json")
    names = kernel_counts(prof_trace, "peak_stats")
    check(len(names) == 1 and sum(names.values()) > 0,
          f"HD profile: {prof_launches} peak_stats calls (as many ran on the device) show as {names} in the trace, "
          f"which holds {most_kernels(prof_trace)}")
    counts = {"kernel_launches": int(b.group(4)), "graph_launches": int(b.group(5)),
              "host_launches": int(b.group(4)) + int(b.group(5)), "kernels": int(b.group(6))}
    print(f"HD profiled scan over {N_PROFILE_FRAMES} frames: device busy {b.group(2)} ms of the "
          f"trace's {b.group(1)} ms window = busy share {b.group(3)} (under the profiler) | "
          f"{per_frame(counts, N_PROFILE_FRAMES)} | {prof_launches} "
          f"peak_stats calls, as many ran on the device, kernels in the trace: {names} (CUPTI mixes up the "
          f"records of the kernels "
          f"inside conditional bodies) | {time.perf_counter() - t0:.1f} s")

    # --- 3g at HD: the three paths through the CLI's drive -----------------
    graph_3g = graph_hd(ps, dev, root, cfg)

    # --- 10b. the models layer's eval over the same set ------------------
    sync(dev)
    ps.peak_stats.launches = 0
    evals = run_eval(root, cfg, dev)
    eval_launches = ps.peak_stats.launches
    check(eval_launches >= 4 * N_HD_FRAMES, f"eval: {eval_launches} kernel launches")
    return {"launches": launches + resume_launches + step_launches + prof_launches + eval_launches,
            **hd, "step_p50_ms": float(m.group(2)), "step_p90_ms": float(m.group(3)), "evals": evals,
            "profile": counts, "graph_3g": graph_3g}


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
    """Phase 8: inline solve and online stitcher through the chunk graph
    (the inline trigger and its canvas recompute nested in its stored
    body), card against CPU, and the same pass again on the card, bit for
    bit; the canvas right after the last inline solve equal to
    ``recompute(bank)`` bit for bit, and the masked recompute equal to the
    loop that reads the count → (peak_stats launches, scatter_add
    launches, stitch_raster launches, the longest runs, the chunk graph's
    launches and the trigger's and lm_step's) of the first pass."""
    from nislam_torch.core.chunk_graph import ChunkGraph
    from nislam_torch.core.pose_graph import lm_step
    from nislam_torch.core.slam import make_engine, pack_outputs
    from nislam_torch.core.solve_graph import trigger
    from nislam_torch.core.stitcher import make_canvas, recompute, recompute_reference
    from nislam_torch.kernels.launch import solve_device_launches
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
    sran = solve_device_launches(dev)
    ps.peak_stats.launches = 0
    sa.index_add_ordered.launches = 0
    sr.stitch_raster.launches = 0
    ChunkGraph.launches = trigger.launches = lm_step.launches = 0
    gstate, gouts = engine.run_sequence(engine.init_state(), frames_d, chunk_frames=CHUNK)
    gstate, _ = engine.finalize(gstate)
    sync(dev)
    launches = ps.peak_stats.launches
    sa_launches = sa.index_add_ordered.launches
    sr_launches = sr.stitch_raster.launches
    graph_launches = {"cond_graph": ChunkGraph.launches, "trigger": trigger.launches, "lm_step": lm_step.launches}
    sran = [b - a for a, b in zip(sran, solve_device_launches(dev))]
    check(sa_launches > 0, "inline/online: the solves launched no scatter_add kernel")
    check(sr_launches > 0, "inline/online: the stitcher launched no stitch_raster kernel")
    check(graph_launches["cond_graph"] > 0 and graph_launches["trigger"] > 0 and graph_launches["lm_step"] > 0
          and [graph_launches["trigger"], graph_launches["lm_step"]] == sran,
          f"inline/online: launches {graph_launches} (trigger and lm_step run on the device {sran}): the chunk "
          f"graph, its inline trigger and the LM loop must each run")
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
    counted = recompute_reference(make_canvas(config.map_stitcher, dev), gstate.bank, engine.camera)
    check(same_bits([fresh.data, fresh.weight], [counted.data, counted.weight]),
          "the masked recompute differs from the loop that reads the bank's count")
    # Right after the last inline solve (its finish recomputed the canvas
    # inside the chunk graph), the canvas is recompute(bank) bit for bit;
    # the keyframes inserted after it add in another order.
    last = int(np.flatnonzero(gouts.optimized)[-1])
    at, _ = engine.run_sequence(engine.init_state(), frames_d[:last + 1], chunk_frames=CHUNK)
    at_fresh = recompute(make_canvas(config.map_stitcher, dev), at.bank, engine.camera)
    check(same_bits([at.canvas.data, at.canvas.weight], [at_fresh.data, at_fresh.weight]),
          f"inline/online: the canvas after the last inline solve (frame {last}) differs from recompute(bank)")
    del at, at_fresh, counted
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
          f"decisions equal, {loops} loops, {solves} inline solves, max pose diff {pose_err:.2e}; through the chunk "
          f"graph: {graph_launches} launches (trigger and lm_step as many ran on the device); the canvas right after "
          f"the last inline solve (frame {last}) = recompute(bank) bit for bit, the masked recompute = the loop that "
          f"reads the count bit for bit; at the end "
          f"online canvas = recompute(bank) (data within {data_err:.2e}); the card's scatter vs the "
          f"CPU's: {flipped} of {touched} cells differ; card vs CPU run: {moved} cells differ; "
          f"same pixel count and intensity total; a second pass on the card gives the same canvas, outputs "
          f"and poses bit for bit | peak_stats launches {launches}, scatter_add launches {sa_launches}, "
          f"stitch_raster launches {sr_launches} | {time.perf_counter() - t0:.1f} s")
    print(f"inline + online again: {runs_line(runs)}")
    return launches, sa_launches, sr_launches, runs, graph_launches


def run_stepbench() -> dict:
    """``python -m nislam_torch.scripts.stepbench --size 640`` in this
    process: per-frame latency of the deferred step (through the solve
    graph and the host-loop trigger) and the inline step (through the
    chunk graph and the track-graph path) → their p50 and p99 ms."""
    from nislam_torch.scripts import stepbench

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stepbench.main(["--size", "640", "--frames", str(N_STEPBENCH_FRAMES), "--device", "cuda"])
    check(rc == 0, f"stepbench exited {rc}")
    lines = buf.getvalue().splitlines()
    stats = [ln for ln in lines if " p50 " in ln or "floor: p50" in ln]
    check(len(stats) == 5 and all(f"tracked {N_STEPBENCH_FRAMES}/{N_STEPBENCH_FRAMES}" in ln for ln in stats[1:]),
          f"stepbench: {lines}")
    for ln in stats:
        print(f"stepbench 480x640, {N_STEPBENCH_FRAMES} frames: {ln}")
    print(f"stepbench: {time.perf_counter() - t0:.1f} s")
    p50, p99 = ([float(re.search(rf"{q}\s+([\d.]+) ms", ln).group(1)) for ln in stats[1:]] for q in ("p50", "p99"))
    return {"deferred_p99_ms": p99[0], "host_loop_p99_ms": p99[1], "inline_p99_ms": p99[2],
            "inline_track_p99_ms": p99[3], "deferred_p50_ms": p50[0], "host_loop_p50_ms": p50[1],
            "inline_p50_ms": p50[2], "inline_track_p50_ms": p50[3]}


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


@contextlib.contextmanager
def recorded_lane_solves():
    """Every batched LM solve that the batch engine makes inside the block,
    in order: the host loop's (``solve_pose_graph_lanes``, wrapped: its
    stacked problem and options, its results, its final (R,) costs and
    its trace, each iteration's flags) and the solve graph's (a launch in
    which a lane ran: its final (B,) costs, from the finish's buffer)."""
    import nislam_torch.parallel.batch as batch
    from nislam_torch.core.solve_graph import SolveGraph

    real, real_run, solves = batch.solve_pose_graph_lanes, SolveGraph.run, []

    def recording(prob, *args, **kwargs):
        trace = []
        out = real(prob, *args, trace=trace, **kwargs)
        solves.append(SimpleNamespace(prob=prob, args=args, kwargs=kwargs, out=tuple(x.clone() for x in out),
                                      cost=out[2].clone(), trace=trace))
        return out

    def graph_run(self):
        ran = real_run(self)
        if self.lanes > 1 and any(ran):
            solves.append(SimpleNamespace(prob=None, cost=self.final_cost.clone(), trace=None))
        return ran

    batch.solve_pose_graph_lanes, SolveGraph.run = recording, graph_run
    try:
        yield solves
    finally:
        batch.solve_pose_graph_lanes, SolveGraph.run = real, real_run


@contextlib.contextmanager
def counted_iterations():
    """The LM iterations of every dense solve (``solve_pose_graph``) made
    inside the block, one count per solve: it assembles its normal
    equations once per iteration (``_assemble_lanes``, its one lane)."""
    import nislam_torch.core.pose_graph as pg
    import nislam_torch.core.slam as slam

    real_solve, real_assemble, counts = slam.solve_pose_graph, pg._assemble_lanes, []

    def solve(*args, **kwargs):
        counts.append(0)
        return real_solve(*args, **kwargs)

    def assemble(*args, **kwargs):
        counts[-1] += 1
        return real_assemble(*args, **kwargs)

    slam.solve_pose_graph, pg._assemble_lanes = solve, assemble
    try:
        yield counts
    finally:
        slam.solve_pose_graph, pg._assemble_lanes = real_solve, real_assemble


def run_lanes(eng, frames_d):
    """``run_sequences`` + ``finalize`` of the batch through ``eng`` →
    (states, outputs, solve tally with finalize's flags last, the batched
    solves' costs)."""
    tally = []
    with recorded_lane_solves() as solves:
        states, outs = eng.run_sequences(eng.init_states(), frames_d, chunk_frames=BATCH_CHUNK, solve_tally=tally)
        states, ran = eng.finalize(states)
    return states, outs, tally + [ran], [s.cost for s in solves]


def lanes_to(eng, frames_d, chunks: int):
    """The batch's states after its first ``chunks`` chunks (each with its
    ``optimize``) through ``eng``."""
    states = eng.init_states()
    for c in range(chunks):
        states, _ = eng.run_chunk(states, frames_d[:, c * BATCH_CHUNK:(c + 1) * BATCH_CHUNK])
        states, _ = eng.optimize(states)
    return states


def lane_solve_stages(prob, cfg, init_scale: float, scale_free: bool) -> dict:
    """The first LM iteration of a batched solve over the stacked ``prob``,
    stage by stage, against each lane's own operations (those of
    ``solve_pose_graph``), each stage on the same inputs: the normal
    equations (``_assemble_lanes`` against ``_assemble_normal_eqs``: H, g,
    cost), the batched ``cholesky_ex`` of the lanes' own damped H against
    one factor per lane, and the batched triangular solves on that batched
    factor against one solve per lane → {stage: (every lane equal bit for
    bit, max abs diff)}."""
    import nislam_torch.core.pose_graph as pg
    from nislam_torch.core.se2 import normalize_angle

    r_ = prob.poses.shape[0]
    norm = lambda p: torch.cat([p[..., :2], normalize_angle(p[..., 2:3])], dim=-1)
    scale = torch.full((r_,), init_scale, dtype=torch.float32, device=prob.poses.device)
    cusolver = pg._cusolver(prob.poses.device)  # the port's linear algebra library
    cusolver.__enter__()
    h, g, cost = pg._assemble_lanes(norm(prob.poses), pg._flat_edges(prob), scale, cfg.estimate_scale,
                                    pg._lane_plan(prob))
    lanes = [pg.PoseGraphProblem(*(x[i] for x in prob)) for i in range(r_)]
    single = [pg._assemble_normal_eqs(norm(p.poses), p, scale[i], cfg.estimate_scale) for i, p in enumerate(lanes)]
    damped, grads = [], []
    for p, (hi, gi, _) in zip(lanes, single):
        free = p.pose_mask.repeat_interleave(3).clone()
        free[:3] = False
        if cfg.estimate_scale:
            free = torch.cat([free, torch.tensor([bool(scale_free)], device=free.device)])
        hp, gp = pg._pin(hi, gi, free)
        damped.append(hp + float(np.float32(cfg.mu_init)) * torch.diag(torch.diag(hp)))
        grads.append(-gp[:, None])
    hd, rhs = torch.stack(damped), torch.stack(grads)
    chol, _ = torch.linalg.cholesky_ex(hd)
    step = pg._lm_solve(chol, -rhs[..., 0])
    pairs = {
        "H": (h, [x[0] for x in single]), "g": (g, [x[1] for x in single]), "cost": (cost, [x[2] for x in single]),
        "factor": (chol, [torch.linalg.cholesky_ex(x)[0] for x in damped]),
        "solve": (step, [pg._lm_solve(c[None], -b[None, :, 0])[0] for b, c in zip(grads, chol)]),
    }
    cusolver.__exit__(None, None, None)
    return {name: (all(same_bits(a[i], w) for i, w in enumerate(want)),
                   max(float((a[i] - w).abs().max()) for i, w in enumerate(want)))
            for name, (a, want) in pairs.items()}


def lanes_permuted(solve) -> bool:
    """The recorded batched solve run again with its first three lanes
    rotated (lane order 1, 2, 0, 3, …) gives each lane its poses, scale,
    final cost and trace bit for bit: a lane's result does not depend on
    its place or on the lanes beside it (which stop at other iterations).
    A rotation of three commutes with neither a reversal nor a shift of
    the lanes, so a per-lane value applied to the wrong lane shows."""
    from nislam_torch.core.pose_graph import PoseGraphProblem, solve_pose_graph_lanes

    order = list(range(solve.prob.poses.shape[0]))
    order[:3] = order[1:3] + order[:1]
    trace = []
    kwargs = {k: v[order] if isinstance(v, torch.Tensor) else v for k, v in solve.kwargs.items()}  # the run mask
    out = solve_pose_graph_lanes(PoseGraphProblem(*(x[order] for x in solve.prob)), *solve.args, trace=trace,
                                 **kwargs)
    return (same_bits(list(out), [x[order] for x in solve.out])
            and trace == [[f[j] for j in order] for f in solve.trace])


def lane_solve_check(engine, frames_d, c: int) -> dict:
    """Chunk ``c``, whose trigger solves, through the graphs; then its
    trigger three ways on copies of the same states: the engine's solve
    graph (one launch, every lane in one batched LM under the lane mask),
    the host loop (``optimize_host_loop``: the same batched LM, one read
    per iteration) and ``solve_and_rederive`` of each lane that triggers
    → host syncs of each, whether the graph equals the host loop bit for
    bit, each triggered lane's LM iterations and final cost batched and
    alone, the largest pose and relative cost differences, the host loop's
    first iteration stage by stage (:func:`lane_solve_stages`) and its
    solve over its lanes permuted (:func:`lanes_permuted`)."""
    from nislam_torch.core.slam import map_state, solve_and_rederive, state_leaves
    from nislam_torch.parallel.batch import _lane, _store_lane, optimize_host_loop

    states = lanes_to(engine, frames_d, c)
    states, _ = engine.run_chunk(states, frames_d[:, c * BATCH_CHUNK:(c + 1) * BATCH_CHUNK])
    single, host = map_state(states, torch.clone), map_state(states, torch.clone)
    got = {}

    def graph():
        got["states"], got["ran"] = engine.optimize(states)

    def host_loop():
        got["host"], got["host_ran"] = optimize_host_loop(engine, host)

    def per_lane():
        for b in (b for b in range(N_BATCH) if got["ran"][b]):
            lane, before = _lane(single, b)
            _store_lane(single, b, before, solve_and_rederive(lane, config=engine.config, camera=engine.camera))

    syncs = host_syncs(graph)
    with recorded_lane_solves() as solves:
        host_syncs_n = host_syncs(host_loop)
    with recorded_solves() as costs, counted_iterations() as iterations:
        lane_syncs = host_syncs(per_lane)
    (solve,) = solves
    check(got["host_ran"] == got["ran"], f"batch: the solve graph ran {got['ran']}, the host loop {got['host_ran']}")
    ran = [i for i, r in enumerate(got["ran"]) if r]
    lane_iterations = [sum(f[i] is not None for f in solve.trace) for i in ran]
    cost = solve.cost[ran].cpu().numpy()
    cost_single = np.array([float(x) for x in costs], np.float32)
    pose_diff = float(np.abs(_wrapped((got["states"].bank.poses - single.bank.poses).cpu().numpy())).max())
    chain_diff = float(np.abs(_wrapped((got["states"].track.last_pose - single.track.last_pose).cpu().numpy())).max())
    sub = type(solve.prob)(*(x[ran] for x in solve.prob))
    return {"lanes": sum(got["ran"]), "syncs": syncs, "host_syncs": host_syncs_n, "lane_syncs": lane_syncs,
            "graph_bits": same_bits(state_leaves(got["states"]), state_leaves(got["host"])),
            "bits": same_bits(state_leaves(got["states"]), state_leaves(single)),
            "pose_diff": max(pose_diff, chain_diff),
            "iterations": lane_iterations, "iterations_single": iterations,
            "cost": cost.tolist(), "cost_single": cost_single.tolist(),
            "cost_rdiff": float(np.max(np.abs(cost - cost_single) / np.abs(cost_single))),
            "stages": lane_solve_stages(sub, *solve.args, init_scale=solve.kwargs["init_scale"],
                                        scale_free=solve.kwargs["scale_free"]),
            "permuted": lanes_permuted(solve)}


def batch_chunk_syncs(eng, frames_d) -> int:
    """The host syncs of the batch's second chunk (64 frames of 8 lanes,
    keyframes among them) through ``eng``, its ``optimize`` apart."""
    states, _ = eng.run_chunk(eng.init_states(), frames_d[:, :BATCH_CHUNK])
    return host_syncs(lambda: eng.run_chunk(states, frames_d[:, BATCH_CHUNK:2 * BATCH_CHUNK]))


def batch_bits_check(got, want, config) -> None:
    """Phase 11's chunk graph (body k over the gathered lanes) ``got``
    against the eager loop (each lane's branch on its own) ``want``, each
    (states, outputs, tally, costs, ...), bit for bit: a difference is
    reported, a flipped decision with its responses beside the
    thresholds, else the first leaf apart and by how much."""
    from nislam_torch.core.slam import pack_outputs, state_leaves

    (gs, go, gt, gc), (ws, wo, wt, wc) = got[:4], want[:4]
    kfs, lc = config.keyframe_selection, config.loop_closure
    for name in ("tracked", "inserted", "loop_found", "keyframe_slot", "loop_slot", "loop_eligible"):
        bad = np.argwhere(getattr(go, name) != getattr(wo, name))
        if len(bad):
            b, i = bad[0]
            check(False, f"batch: {name} of lane {b} frame {i} differs between body k and the lane branches "
                         f"({getattr(go, name)[b, i]} / {getattr(wo, name)[b, i]}): responses {go.response[b, i]} / "
                         f"{wo.response[b, i]} against the tracking thresholds {kfs.lower_response_thr} / "
                         f"{kfs.upper_response_thr}, loop {lc.position_response_thr} / {lc.angle_response_thr}")
    check(gt == wt, f"batch: solve tallies differ: body k {gt}, lane branches {wt}")
    po, pw = pack_outputs(go), pack_outputs(wo)
    if po.tobytes() != pw.tobytes():
        check(False, f"batch: outputs differ from the lane branches' by {np.nanmax(np.abs(po - pw))}")
    check(len(gc) == len(wc) and same_bits(gc, wc), "batch: the solves' costs differ from the lane branches'")
    for i, (x, y) in enumerate(zip(state_leaves(gs), state_leaves(ws), strict=True)):
        if not device_bits_equal([x], [y]):
            check(False, f"batch: state leaf {i} {tuple(x.shape)} {x.dtype} differs between body k and the lane "
                         f"branches by {float((x.double() - y.double()).abs().max())}")


def offset_lanes(frames_d: torch.Tensor) -> tuple:
    """Phase 11's frames with lane b held at its first frame for
    ``b · BATCH_OFFSET`` frames, then on its path (the rest cut at the
    sequence's end): the lanes move alike, apart in time, so they insert
    at other frames than each other, as robots that started at different
    times do → (the frames, (B, N) index of each lane's frame on the path)."""
    n = frames_d.shape[1]
    idx = torch.stack([torch.clamp(torch.arange(n) - BATCH_OFFSET * b, min=0) for b in range(N_BATCH)])
    idx = idx.to(frames_d.device)
    return frames_d[torch.arange(N_BATCH, device=frames_d.device)[:, None], idx], idx


def run_batch_offset(ps, dev, paths: dict, frames_d, gt, config) -> dict:
    """Phase 11's lanes offset in time (:func:`offset_lanes`): a warm-up
    run through the chunk graph (body k captured for each new k), then the
    chunk graph, the eager loop (each lane's branch on its own) and the
    chunk graph again: bits, frames by k, body k's runs against them,
    ``peak_stats``' device count, tracking and ATE per lane, lane-frames/s."""
    from nislam_torch.io.trajectory import ate_rmse

    t0 = time.perf_counter()
    engine = paths["chunk graph"]
    frames_o, idx = offset_lanes(frames_d)
    run_lanes(engine, frames_o)
    exits = engine.chunk_graph.early_exits
    runs, fps = {}, {"chunk graph": [], "eager": []}
    for label in ("chunk graph", "eager", "chunk graph"):
        sync(dev)
        ps.peak_stats.launches = 0
        device_before = ps.device_launches(dev)
        device_runs = collections.Counter(engine.chunk_graph.runs)
        t1 = time.perf_counter()
        states, outs, tally, costs = run_lanes(paths[label], frames_o)
        sync(dev)
        fps[label].append(N_BATCH * N_BATCH_FRAMES / (time.perf_counter() - t1))
        launches = ps.peak_stats.launches
        check(ps.device_launches(dev) - device_before == launches,
              f"batch offset: peak_stats launches on the device differ from the wrapper's {launches} ({label})")
        if label not in runs:
            runs[label] = (states, outs, tally, costs, launches, engine.chunk_graph.runs - device_runs)
        del states
    check(engine.chunk_graph.early_exits == exits, "batch offset: the chunk graph exited early after its warm-up")
    batch_bits_check(runs["chunk graph"], runs["eager"], config)
    outs, body = runs["chunk graph"][1], runs["chunk graph"][5]
    hist = np.bincount(outs.inserted[:, 1:].sum(axis=0), minlength=N_BATCH + 1).tolist()
    by_k = {k: hist[k] for k in range(1, N_BATCH + 1) if hist[k]}
    check({s + 1: n for s, n in body.items() if n} == by_k,
          f"batch offset: body runs {dict(body)} (slot k - 1), frames by k {by_k}")
    tracked = outs.tracked.sum(axis=1)
    check(bool((tracked == N_BATCH_FRAMES).all()), f"batch offset: tracked per lane {tracked.tolist()}")
    times = np.arange(N_BATCH_FRAMES) / 30.0
    ates = [ate_rmse(times, outs.pose[b, :, :2], times, gt[idx[b].cpu().numpy()]) for b in range(N_BATCH)]
    check(max(ates) < 0.02, f"batch offset: ATE {max(ates)} m >= 0.02 m")
    inserting = int(outs.inserted[:, 1:].sum())
    print(f"batch, lanes offset in time (lane b held {BATCH_OFFSET}·b frames at its start): frames by k lanes "
          f"inserting (k = 0..{N_BATCH}, frames 1..{N_BATCH_FRAMES - 1}) {hist}, {inserting} inserting lane-frames "
          f"({inserting / (N_BATCH * (N_BATCH_FRAMES - 1)):.3f} of them) | body k's runs (control block) "
          f"{dict(sorted((s + 1, n) for s, n in body.items() if n))} | the chunk graph equals the eager loop (each "
          f"lane's branch on its own) bit for bit, peak_stats launches {runs['chunk graph'][4]} / {runs['eager'][4]} "
          f"(each the kernel's device count) | ATE per lane {[round(a, 5) for a in ates]} m | lane-frames/s in "
          f"turns: chunk graph {fps['chunk graph'][0]:.1f}, eager {fps['eager'][0]:.1f}, chunk graph "
          f"{fps['chunk graph'][1]:.1f}"
          + f" | chunk graph / eager {np.mean(fps['chunk graph']) / np.mean(fps['eager']):.2f}x | "
          f"{time.perf_counter() - t0:.1f} s")
    return {"fps": fps, "hist": hist, "launches": runs["chunk graph"][4], "eager_launches": runs["eager"][4]}


def batched_filter_gap(engine, frames_d) -> dict:
    """Why body k computes each lane's keyframe filters at one lane's
    shapes: the filters of frame 1 of every lane computed as one (8, H,
    W') batch, and of lane 0 as a (1, H, W') batch, against each lane's
    own (H, W') computation → the largest difference over each filter's
    scale (image, polar)."""
    from nislam_torch.ops.registration import compute_keyframe_filters

    _, fft, polar = (x[0] for x in engine._features(frames_d[:, 1:2]))
    own = [compute_keyframe_filters(fft[b], polar[b], engine.cf_ops) for b in range(fft.shape[0])]

    def gap(got, lanes):
        return [max(float((g[b] - own[b][i]).abs().max() / own[b][i].abs().max()) for b in range(lanes))
                for i, g in enumerate(got)]

    return {"batch of 8": gap(compute_keyframe_filters(fft, polar, engine.cf_ops), fft.shape[0]),
            "batch of 1": gap(compute_keyframe_filters(fft[:1], polar[:1], engine.cf_ops), 1)}


def run_batch(ps, dev: torch.device):
    """Phase 11: the batch engine, 8 flagship lanes, through its graphs and
    its kept eager loop in turns, and against single-engine runs of lanes 0
    and 7 → (launches of its first graph run, {lane: (its frames on the
    host, the single engine's outputs, its bank's poses)} for phase 12c,
    the figures of the summary line)."""
    from nislam_torch.core.slam import make_engine, pack_outputs, state_leaves
    from nislam_torch.core.track_graph import CapturedStep
    from nislam_torch.io.trajectory import ate_rmse
    from nislam_torch.parallel import make_batch_engine
    from nislam_torch.parallel.batch import eager_engine, run_chunk_frame_graph

    t0 = time.perf_counter()
    config = flagship_config()
    frames, gt = batch_frames()
    frames_d = torch.from_numpy(frames).to(dev)
    del frames
    engine = make_batch_engine(config, N_BATCH, dev)
    paths = {"chunk graph": engine, "eager": eager_engine(engine)}
    print(f"batch set-up ({N_BATCH} lanes x {N_BATCH_FRAMES} frames rendered): "
          f"{time.perf_counter() - t0:.1f} s")
    gaps = batched_filter_gap(engine, frames_d)
    print("batch: keyframe filters computed in a batch against each lane's own, largest difference over the "
          "filter's scale (image, polar): " + ", ".join(f"{k} {v[0]:.3e}, {v[1]:.3e}" for k, v in gaps.items())
          + " (why body k computes each lane's filters at one lane's shapes)")
    t0 = time.perf_counter()
    sync(dev)
    torch.cuda.empty_cache()
    mem, captures = {"before": torch.cuda.memory_reserved(dev)}, CapturedStep.captures
    allocated = torch.cuda.memory_allocated(dev)
    engine.frame_graph  # its own states
    sync(dev)
    mem["buffers"] = torch.cuda.memory_allocated(dev) - allocated
    # The flag-read frame graph over the same graphs and states.
    paths = {"chunk graph": engine, "frame graph": eager_engine(engine, run_chunk_frame_graph), "eager": paths["eager"]}
    for eng in paths.values():
        eng.run_sequences(eng.init_states(), frames_d[:, :16], chunk_frames=BATCH_CHUNK)
    run_lanes(engine, frames_d)  # the whole run: its triggers capture the solve graph's steps and build it
    sync(dev)
    torch.cuda.empty_cache()  # what stays reserved: live tensors and the graphs' pools
    captured = CapturedStep.captures - captures
    mem["after"], mem["allocated"] = torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev)
    bodies = sorted(s + 1 for s in engine.frame_graph.branch_slots())
    print(f"batch warm-up (16 frames, each path, then one whole run): {captured} CUDA graphs captured (the track "
          f"graph, body k for k in {bodies} (the keyframe branch over the k lanes that insert, in one shared pool), "
          f"the solve graph's steps, and the chunk graph's builds over them; early exits "
          f"{engine.chunk_graph.early_exits}) | memory reserved {mem['before'] / 2**30:.2f} GiB "
          f"before the engine, {mem['after'] / 2**30:.2f} GiB after the captures: allocated "
          f"{mem['allocated'] / 2**30:.2f} GiB (the graphs' own {N_BATCH} states "
          f"{mem['buffers'] / 2**30:.2f} GiB among them), the rest "
          f"{(mem['after'] - mem['allocated']) / 2**30:.2f} GiB the graphs' pools and the cache | "
          f"{time.perf_counter() - t0:.1f} s")

    runs, fps, t_turns = {}, {label: [] for label in paths}, time.perf_counter()
    exits = engine.chunk_graph.early_exits
    from nislam_torch.core.chunk_graph import ChunkGraph

    for label, eng in list(paths.items()) * 2:
        sync(dev)
        ps.peak_stats.launches = 0
        device_before = ps.device_launches(dev)
        device_runs = collections.Counter(engine.chunk_graph.runs)
        host_runs = collections.Counter(engine.frame_graph.body_runs)
        ChunkGraph.launches = 0
        t1 = time.perf_counter()
        with replays_without_sync() as seen:
            states, outs, tally, costs = run_lanes(eng, frames_d)
        sync(dev)
        dt = time.perf_counter() - t1
        fps[label].append(N_BATCH * N_BATCH_FRAMES / dt)
        launches = ps.peak_stats.launches
        on_device = ps.device_launches(dev) - device_before
        check(on_device == launches, f"batch: {on_device} peak_stats launches ran on the device through the {label}, "
                                     f"its wrapper counted {launches}")
        body = {"device": engine.chunk_graph.runs - device_runs, "host": engine.frame_graph.body_runs - host_runs,
                "chunk_launches": ChunkGraph.launches}
        want = {"chunk graph": "chunks", "frame graph": "replays"}.get(label)
        check(all((seen[k] > 0) == (k == want) for k in ("replays", "chunks"))
              and (seen["solves"] > 0) == (label != "eager"), f"batch: {dict(seen)} through the {label}")
        if label not in runs:
            runs[label] = (states, outs, tally, costs, launches, dt, dict(seen), body)
            if label == "frame graph":  # against the chunk graph's, on the card
                check(device_bits_equal(state_leaves(states), state_leaves(runs["chunk graph"][0])),
                      f"batch: the {label}'s final states differ from the chunk graph's")
        else:
            check(same_bits(pack_outputs(outs), pack_outputs(runs[label][1])), f"batch: a {label} run's outputs differ")
        if label != "frame graph":
            del states
    check(CapturedStep.captures - captures == captured,
          f"batch: {CapturedStep.captures - captures - captured} graphs captured after the warm-up")
    check(engine.chunk_graph.early_exits == exits, "batch: the chunk graph exited early after its warm-up")
    states, outs, tally, costs, launches, dt, seen, body = runs["chunk graph"]
    replays = runs["frame graph"][6]["replays"]
    _, fo, ft, fc, fl, _, _, fbody = runs["frame graph"]
    check(same_bits(pack_outputs(outs), pack_outputs(fo)), "batch: the frame graph's outputs differ from the chunk "
                                                           "graph's")
    check(tally == ft, f"batch: solve tallies differ: chunk graph {tally}, frame graph {ft}")
    check(len(costs) == len(fc) and same_bits(costs, fc), "batch: the solves' costs differ (frame graph)")
    check(launches == fl, f"batch: {launches} peak_stats launches through the chunk graph, {fl} frame graph")
    # Frames by the number k of lanes that insert (frame 0 is the eager first frame).
    per_frame = outs.inserted[:, 1:].sum(axis=0)
    hist = np.bincount(per_frame, minlength=N_BATCH + 1).tolist()
    by_k = {k: hist[k] for k in range(1, N_BATCH + 1) if hist[k]}
    check({s + 1: n for s, n in body["device"].items() if n} == by_k,
          f"batch: body runs as the chunk graph's control block counted them {dict(body['device'])} (slot k - 1), "
          f"frames by k {by_k}")
    check(dict(fbody["host"]) == by_k, f"batch: body replays through the frame graph {dict(fbody['host'])}, "
                                       f"frames by k {by_k}")
    batch_bits_check(runs["chunk graph"], runs["eager"], config)
    eager_launches = runs["eager"][4]
    del fo, runs
    solves = sum(map(sum, tally))
    loops = int(outs.loop_found.sum())
    times = np.arange(N_BATCH_FRAMES) / 30.0
    ates = [ate_rmse(times, outs.pose[b, :, :2], times, gt) for b in range(N_BATCH)]
    tracked = outs.tracked.sum(axis=1)
    inserted = int(outs.inserted[:, 1:].sum())
    print(f"batch: {N_BATCH} lanes x {N_BATCH_FRAMES} frames in {dt:.3f} s = "
          f"{N_BATCH * N_BATCH_FRAMES / dt:.1f} lane-frames/s through the graphs (finalize included) | tracked per "
          f"lane {tracked.tolist()} | keyframes {states.bank.count.tolist()} | loops {loops} | solves {solves} "
          f"({len(costs)} batched LM solves) | ATE per lane {[round(a, 5) for a in ates]} m | peak_stats launches "
          f"{launches}")
    check(bool((tracked == N_BATCH_FRAMES).all()), f"batch: tracked per lane {tracked.tolist()}")
    check(max(ates) < 0.02, f"batch: ATE {max(ates)} m >= 0.02 m")
    check(loops >= 1 and solves >= 1, f"batch: {loops} loops, {solves} solves")
    check(launches >= N_BATCH_FRAMES, f"batch: {launches} kernel launches")
    print(f"batch: the flag-read frame graph equals the chunk graph with its solve graph bit for bit (outputs, "
          f"solve tallies {tally}, {len(costs)} batched solves' costs, every state leaf) with as many peak_stats "
          f"launches ({launches}, each run on the device by its own count); so does the eager loop (each lane's "
          f"branch on its own, its triggers the host loop), with {eager_launches} peak_stats launches (one search "
          f"per lane that stored); no host sync in any chunk "
          f"launch, solve-graph launch or replay (sync debug mode error: {seen['chunks']} chunk launches and "
          f"{seen['solves']} solve-graph launches per chunk-graph run; {replays} replays per frame-graph run: "
          f"{N_BATCH_FRAMES - 1} track replays and {sum(by_k.values())} body replays for {inserted} inserting "
          f"lane-frames); early exits in them 0")
    print(f"batch frames by k lanes inserting (k = 0..{N_BATCH}, frames 1..{N_BATCH_FRAMES - 1}): {hist} | body k's "
          f"runs, chunk graph (its control block's count) {dict(sorted((s + 1, n) for s, n in body['device'].items()))}"
          f", frame graph (replays) {dict(sorted(fbody['host'].items()))} | bodies held {bodies} | "
          f"{body['chunk_launches']} chunk-graph launches per run")
    print("batch lane-frames/s in turns (chunk graph, frame graph, eager, twice; solves and finalize included): "
          + ", ".join(f"{label} {fps[label][i]:.1f}" for i in range(2) for label in paths)
          + f" | chunk graph / frame graph {np.mean(fps['chunk graph']) / np.mean(fps['frame graph']):.2f}x, "
          f"chunk graph / eager {np.mean(fps['chunk graph']) / np.mean(fps['eager']):.2f}x | "
          f"{time.perf_counter() - t_turns:.1f} s")
    offset = run_batch_offset(ps, dev, paths, frames_d, gt, config)

    t0 = time.perf_counter()
    syncs = {label: batch_chunk_syncs(eng, frames_d) for label, eng in paths.items()}
    check(syncs["chunk graph"] <= 3, f"batch: {syncs['chunk graph']} host syncs in one chunk of {BATCH_CHUNK} "
                                     f"frames through the chunk graph, at most 3")
    check(syncs["frame graph"] == BATCH_CHUNK, f"batch: {syncs['frame graph']} host syncs in one chunk of "
                                               f"{BATCH_CHUNK} frames through the frame graph, {BATCH_CHUNK} "
                                               f"expected (one (B, 2) flag read per frame)")
    c = max(range(len(tally) - 1), key=lambda i: sum(tally[i]))  # the chunk whose trigger solves most lanes
    solve = lane_solve_check(engine, frames_d, c)
    print(f"batch host syncs: one chunk of {BATCH_CHUNK} frames x {N_BATCH} lanes after a first chunk: "
          + ", ".join(f"{label} {v}" for label, v in syncs.items())
          + f" (the chunk graph's: its control block's read; the frame graph's: one (B, 2) flag read per frame; "
            f"both skip the initialized read for the states their graph lent; the eager loop's: the initialized "
            f"read and one flag read per frame) | chunk {c}'s trigger with {solve['lanes']} triggered lanes: "
          f"{solve['syncs']} host syncs through the solve graph (its run flags' read), {solve['host_syncs']} "
          f"through the host loop (the pending read and one read per LM iteration), {solve['lane_syncs']} as "
          f"per-lane solves | the solve graph equals the host loop "
          f"{'bit for bit' if solve['graph_bits'] else 'NOT bit for bit'} (every state leaf); the batched solve "
          f"equals the per-lane solves {'bit for bit' if solve['bits'] else 'NOT bit for bit'}, max pose diff "
          f"{solve['pose_diff']:.2e} | {time.perf_counter() - t0:.1f} s")
    print(f"batch solve per triggered lane: LM iterations batched {solve['iterations']}, per-lane "
          f"{solve['iterations_single']} | final costs batched {solve['cost']}, per-lane {solve['cost_single']}, "
          f"max relative diff {solve['cost_rdiff']:.2e} | the first iteration stage by stage, every lane against "
          f"its own operations: " + ", ".join(f"{name} {'equal' if eq else 'apart'} (max abs diff {d:.2e})"
                                              for name, (eq, d) in solve["stages"].items())
          + f" | its lanes permuted: {'each lane bit for bit, trace equal' if solve['permuted'] else 'APART'}")
    check(solve["permuted"], "batch: the batched solve over its lanes permuted gives other bits or another trace")
    check(solve["graph_bits"], "batch: the solve graph's trigger differs from the host loop's")
    check(solve["syncs"] <= 1, f"batch: {solve['syncs']} host syncs in one trigger through the solve graph")
    check(solve["pose_diff"] <= LANE_POSE_ATOL, f"batch: the batched solve's poses differ from the per-lane solves' "
                                                f"by {solve['pose_diff']}")
    check(solve["cost_rdiff"] <= LANE_COST_RTOL, f"batch: the batched solve's final costs differ from the per-lane "
                                                 f"solves' by {solve['cost_rdiff']} (relative)")

    prof = {}
    for label, eng in paths.items():
        # The eager loop's trace of a whole chunk holds ~60,000 kernels and
        # takes over a minute to record and read: a quarter chunk does.
        n = BATCH_CHUNK // 4 if label == "eager" else BATCH_CHUNK
        first, _ = eng.run_chunk(eng.init_states(), frames_d[:, :BATCH_CHUNK])
        prof[label] = profiled(lambda: eng.run_chunk(first, frames_d[:, BATCH_CHUNK:BATCH_CHUNK + n]), ps,
                               f"batch, {label}, frames {BATCH_CHUNK}-{BATCH_CHUNK + n - 1} (per lane-frame)",
                               N_BATCH * n)
        prof[label]["lane_frames"] = N_BATCH * n
        del first

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
    summary = {"fps": fps, "launches": launches, "syncs": syncs, "solve": solve, "captured": captured, "mem": mem,
               "prof": prof, "hist": hist, "bodies": bodies, "eager_launches": eager_launches,
               "chunk_launches": body["chunk_launches"], "filter_gaps": gaps, "offset": offset}
    return launches, refs, summary


def batch_summary(res: dict) -> str:
    """Phase 11's figures on one line."""
    fps, prof, solve = res["fps"], res["prof"], res["solve"]
    return ("phase 11 summary: lane-frames/s in turns "
            + ", ".join(f"{label} " + "/".join(f"{v:.1f}" for v in vals) for label, vals in fps.items())
            + " | chunk graph = frame graph = eager loop (the lane branches) bit for bit, peak_stats launches "
            + f"{res['launches']} / {res['launches']} / {res['eager_launches']} | frames by k inserting lanes "
            + f"{res['hist']} (lanes that insert together), {res['offset']['hist']} with lanes offset in time, "
            + f"lane-frames/s there chunk graph " + "/".join(f"{v:.1f}" for v in res["offset"]["fps"]["chunk graph"])
            + ", eager " + "/".join(f"{v:.1f}" for v in res["offset"]["fps"]["eager"])
            + f", bodies {res['bodies']}"
            + f" | host syncs per {BATCH_CHUNK}-frame chunk " + ", ".join(f"{k} {v}" for k, v in res["syncs"].items())
            + f"; per trigger: solve graph {solve['syncs']}, host loop {solve['host_syncs']}, per-lane "
            + f"{solve['lane_syncs']} ("
            + ("bit for bit" if solve["bits"] else f"max pose diff {solve['pose_diff']:.2e}")
            + f", LM iterations per lane {solve['iterations']} / {solve['iterations_single']}, final costs within "
            + f"{solve['cost_rdiff']:.2e} relative; first iteration apart at: "
            + (", ".join(name for name, (eq, _) in solve["stages"].items() if not eq) or "none") + ")"
            + " | per lane-frame " + "; ".join(
                f"{label} {p['host_launches'] / p['lane_frames']:.2f} host launch calls, "
                f"{p['kernels'] / p['lane_frames']:.1f} device kernels, busy {p['busy_share']:.4f}"
                for label, p in prof.items())
            + f" | {res['captured']} graphs captured, reserved {res['mem']['after'] / 2**30:.2f} GiB after them")


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


# The distributed engine's paths: its own (the chunk graph and the trigger
# program), its frames' reference (the track-graph path), its trigger's
# reference (the chunk graph with the host-loop trigger).
DIST_PATHS = ("chunk graph", "track graph", "host-loop trigger")
# The flagship's collectives per 512-frame distributed run (12a, 12b): 250
# CG vectors, 60 gradient blocks, 3 costs and 73 search records.
DIST_COLLECTIVES = 386
DIST_TURNS = ("chunk graph", "track graph", "host-loop trigger", "host-loop trigger", "track graph", "chunk graph")


def dist_run(eng, frames_d, chunk: int = CHUNK) -> tuple:
    """``run_sequence`` (chunks of ``chunk``) and ``finalize`` of ``eng``
    → (state, outputs, solve tally with the finalize's)."""
    tally = []
    state, outs = eng.run_sequence(eng.init_state(), frames_d, chunk_frames=chunk, solve_tally=tally)
    state, ran = eng.finalize(state)
    return state, outs, tally + [bool(ran)]


BRANCH_KINDS = ((True, "stored"), (False, "dropped"))  # the branch kinds, as the frame graphs key them


def dist_counts(engine, dev) -> dict:
    """The counters that :func:`dist_paths` reads before and after a run
    (the kernels' own device counts synchronize): the kernels' launches,
    the chunk graph's launches and exits, the branch's runs per kind (the
    chunk graph's SWITCH bodies, as its control block counts them, and the
    step's own replays), the collectives."""
    from nislam_torch.core.chunk_graph import ChunkGraph
    from nislam_torch.core.frame_graph import branch_slot
    from nislam_torch.core.track_graph import CapturedStep
    from nislam_torch.kernels.launch import cg_step_device_launches
    from nislam_torch.ops import all_reduce as ar
    from nislam_torch.ops import peak_stats as ps
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.ops import stitch_raster as sr
    from nislam_torch.parallel import solver as sv

    chunk, fg = engine.chunk_graph, engine.frame_graph
    out = {"peak_stats": ps.peak_stats.launches, "peak_stats_device": ps.device_launches(dev),
           "scatter_add": sa.index_add_ordered.launches, "scatter_add_device": sa.device_launches(dev),
           "stitch_raster": sr.stitch_raster.launches, "cg_step": sv.cg_step.launches,
           "cg_step_device": cg_step_device_launches(dev), "trigger_launches": sv.CGTrigger.launches,
           "chunk_launches": ChunkGraph.launches, "host_exits": chunk.host_exits,
           "early_exits": chunk.early_exits, "captures": CapturedStep.captures,
           "all_reduce": engine.group.collective_calls(), "all_reduce_bytes": engine.group.collective_bytes(),
           "all_reduce_launches": ar.launches(), "all_reduce_device": ar.device_launches(dev)}
    for kind, name in BRANCH_KINDS:
        step = fg.branch_slots().get(branch_slot(kind))
        out[f"{name}_runs"] = chunk.runs[branch_slot(kind)] + (step.replays if step else 0)
    return out


def dist_chunk_syncs(engine, eng, frames_d, chunk: int = CHUNK) -> dict:
    """The host syncs of one whole chunk (frames ``chunk`` to 2·``chunk``)
    after a first chunk through ``eng`` (``engine`` or a path of it), with
    the chunk graph's launches and host exits in it, its frames that insert
    and store, and whether its last frame inserts."""
    from nislam_torch.core.chunk_graph import ChunkGraph

    state, _ = eng.run_chunk(eng.init_state(), frames_d[:chunk])
    launches, exits = ChunkGraph.launches, engine.chunk_graph.host_exits
    got = {}
    syncs = host_syncs(lambda: got.update(out=eng.run_chunk(state, frames_d[chunk:2 * chunk])))
    outs = got["out"][1]
    return {"syncs": syncs, "launches": ChunkGraph.launches - launches,
            "host_exits": engine.chunk_graph.host_exits - exits, "inserting": int(outs.inserted.sum()),
            "stored": int((outs.keyframe_slot >= 0).sum()), "last_inserts": bool(outs.inserted[-1])}


def dist_paths(engine, frames_d, dev, what: str, chunk: int = CHUNK, image_bytes: int = 0,
               collectives: int = 0) -> dict:
    """The distributed engine over ``frames_d`` (chunks of ``chunk``)
    through its chunk graph (``run_chunk``; on a card, its group
    capturable, the graph route: the keyframe branch and its peer
    all-reduces one captured step per kind in the chunk graph's SWITCH, a
    chunk one launch) with its trigger program (``CGTrigger``: one launch
    per trigger), through the track-graph path (``run_chunk_track_graph``:
    the eager branch, the host making its collectives) and through the
    chunk graph with the host-loop trigger (``optimize_host_loop``: the
    pending reads, the edges one by one, ``CGGraph``, the count-read
    recompute), one warm-up run each (captures, the early exits of a fresh
    engine), then in turns (:data:`DIST_TURNS`): every run bit for bit with
    the first (outputs, solve tallies, every state leaf, compared on the
    card, and the collectives by payload: ``image_bytes``, an evicted
    image's all-reduce, which the graph route makes at every stored
    keyframe (zeros when nothing is evicted) and the eager branch at every
    eviction, is held to those counts instead), no capture after the
    warm-up, the counted kernels' launches equal to their own device counts
    (``cg_step``'s and ``all_reduce``'s too, the all-reduce's equal to the
    group's collectives at n ranks and 0 at one, where the sum is the
    payload and nothing launches; the collectives ``collectives`` per run
    where given), ``cg_step`` launched by the trigger program's
    graph only, no host exit and no early exit, each branch kind's runs its
    frames; then the host syncs of one whole chunk through each (the chunk
    graph's: its one launch and one read) → {"fps", "runs" (counts per
    timed run), "result" (the first chunk-graph run's state, outputs,
    tally), "syncs"}."""
    from nislam_torch.core.slam import pack_outputs, state_leaves

    check(engine.group.capturable and not engine.branch_on_host,
          f"{what}: the group on the card is not capturable: the branch would leave the chunk graph")
    paths = {"chunk graph": engine, "track graph": TrackGraphEngine(engine),
             "host-loop trigger": HostLoopTriggerEngine(engine)}
    for eng in paths.values():
        dist_run(eng, frames_d, chunk)
    fps = {label: [] for label in DIST_PATHS}
    runs, first = [], {}
    launches_per_run = -(-len(frames_d) // chunk)
    for label in DIST_TURNS:
        sync(dev)
        before, coll = dist_counts(engine, dev), engine.group.counts.copy()
        t0 = time.perf_counter()
        state, outs, tally = dist_run(paths[label], frames_d, chunk)
        sync(dev)
        dt = time.perf_counter() - t0
        after = dist_counts(engine, dev)
        coll = engine.group.counts - coll
        n = {k: after[k] - before[k] for k in after}
        fps[label].append(len(frames_d) / dt)
        inserting = int(outs.inserted[1:].sum())
        stored = int(((outs.keyframe_slot >= 0) & outs.inserted)[1:].sum())
        check(n["captures"] == 0, f"{what} {label}: {n['captures']} graphs captured after the warm-up")
        check(n["peak_stats"] == n["peak_stats_device"] > 0 and n["scatter_add"] == n["scatter_add_device"] > 0,
              f"{what} {label}: peak_stats {n['peak_stats']} counted, {n['peak_stats_device']} ran on the device; "
              f"scatter_add {n['scatter_add']} counted, {n['scatter_add_device']} ran")
        check(n["cg_step"] == n["cg_step_device"]
              and (n["cg_step"] > 0) == (label != "host-loop trigger" and any(tally)),
              f"{what} {label}: cg_step {n['cg_step']} counted, {n['cg_step_device']} ran on the device")
        ar_want = n["all_reduce"] if engine.group.size > 1 else 0
        check(n["all_reduce_launches"] == n["all_reduce_device"] == ar_want and n["all_reduce"] > 0
              and n["all_reduce"] == (collectives or n["all_reduce"]),
              f"{what} {label}: all_reduce {n['all_reduce_launches']} launches counted, {n['all_reduce_device']} ran "
              f"on the device ({ar_want} expected), {n['all_reduce']} collectives counted by the group "
              f"({collectives or 'any'} expected)")
        if label != "track graph":
            kinds = {"stored": stored, "dropped": inserting - stored}
            check(n["host_exits"] == 0 and n["early_exits"] == 0 and n["chunk_launches"] == launches_per_run
                  and all(n[f"{k}_runs"] == v for k, v in kinds.items()),
                  f"{what}: {n['chunk_launches']} chunk launches ({launches_per_run} chunks), {n['host_exits']} host "
                  f"exits, {n['early_exits']} early, for {inserting} inserting frames ({stored} stored); branch "
                  f"runs stored {n['stored_runs']}, dropped {n['dropped_runs']}")
        else:
            check(n["chunk_launches"] == 0 and n["stored_runs"] == n["dropped_runs"] == 0,
                  f"{what}: the track-graph path launched the chunk graph or its branch")
        images = 0
        if image_bytes:
            images = coll.pop(("all_reduce", image_bytes), 0)
            want = int(state.bank.overflow) if label == "track graph" else stored
            check(images == want, f"{what} {label}: {images} image all-reduces, {want} expected (the graph route "
                                  f"one per stored keyframe, the eager branch one per eviction)")
        runs.append({"path": label, "seconds": dt, "inserting": inserting, "stored": stored, "images": images,
                     "collectives": coll, **n})
        if not first:
            first.update(state=state, outs=outs, tally=tally, coll=coll)
        else:
            why = None
            if not same_bits(pack_outputs(outs), pack_outputs(first["outs"])):
                why = "outputs"
            elif tally != first["tally"]:
                why = f"solve tallies {tally} and {first['tally']}"
            elif not device_bits_equal(state_leaves(state), state_leaves(first["state"])):
                why = "state leaves"
            elif coll != first["coll"]:
                why = f"collectives by payload {dict(coll)} and {dict(first['coll'])}"
            check(why is None, f"{what}: {label} differs from the chunk graph's first run in its {why}")
    syncs = {label: dist_chunk_syncs(engine, paths[label], frames_d, chunk) for label in ("chunk graph", "track graph")}
    cs = syncs["chunk graph"]
    check(cs["host_exits"] == 0 and cs["launches"] == 1 and cs["syncs"] == 1,
          f"{what}: one chunk through the chunk graph made {cs['syncs']} host syncs over {cs['launches']} launches "
          f"and {cs['host_exits']} host exits, with {cs['inserting']} inserting and {cs['stored']} stored frames")
    return {"fps": fps, "runs": runs, "result": (first["state"], first["outs"], first["tally"]), "syncs": syncs,
            "chunk": chunk}


def dist_paths_line(res: dict) -> str:
    """:func:`dist_paths`' figures as one line."""
    cs, ts = res["syncs"]["chunk graph"], res["syncs"]["track graph"]
    run = res["runs"][0]
    return (f"frames/s in turns " + ", ".join(f"{label} " + "/".join(f"{v:.1f}" for v in res["fps"][label])
                                             for label in DIST_PATHS)
            + f" | bit for bit (outputs, solve tallies, every state leaf, collectives by payload; the trigger "
            + f"program against the host-loop trigger too), no capture "
            + f"after the warm-up | per run: chunk-graph launches {run['chunk_launches']}, host exits "
            + f"{run['host_exits']}, early exits {run['early_exits']}; branch runs in the SWITCH: stored "
            + f"{run['stored_runs']}, dropped {run['dropped_runs']}; peak_stats {run['peak_stats']}, scatter_add "
            + f"{run['scatter_add']}, cg_step {run['cg_step']}, all_reduce {run['all_reduce_launches']} (each its "
            + f"device count; the trigger program's graph launches {run['trigger_launches']}), stitch_raster "
            + f"{run['stitch_raster']} launches; {run['all_reduce']} all-reduces, "
            + f"{dict(sorted(run['collectives'].items()))} by (op, bytes)"
            + f" | one {res['chunk']}-frame chunk: host syncs chunk graph {cs['syncs']} ({cs['launches']} launch, "
            + f"{cs['inserting']} inserting frames); the track-graph path {ts['syncs']} ({ts['inserting']} "
            + f"inserting, {ts['stored']} stored frames)")


CG_SOLVERS = ("eager", "graph", "one launch")


def cg_turns(prob, group, dev, reps: int = 1) -> dict:
    """The eager GN-CG solve (``solve_pose_graph_cg``), the graph program
    (``CGGraph``: captured steps, the host making the all-reduces and
    reading ‖r‖² per CG iteration) and, on a group whose all-reduce a
    graph holds, the one-launch solve (``CGTrigger.for_problem``: the
    trigger program's graph, the all-reduces and the stop test inside) on
    ``prob`` in turns (eager, graph, one launch, one launch, graph, eager;
    ``reps`` rounds), after one warm-up solve of each (the steps captured,
    the graph built): every solve bit for bit with the first (poses,
    cost, all-reduces), scatter_add's launches equal to its device count,
    the CG iterations equal → ms per solve and per CG iteration of each
    (host clock around synchronized solves), host syncs per solve (sync
    debug mode), CG iterations per solve, all-reduces."""
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.parallel.solver import CGGraph, CGTrigger, solve_pose_graph_cg

    graph = CGGraph(group)
    solvers = {"eager": lambda: solve_pose_graph_cg(prob, group, graph.cfg), "graph": lambda: graph(prob)}
    program = None
    if group.capturable:
        program, solvers["one launch"] = CGTrigger.for_problem(prob, group, graph.cfg)
    for solve in solvers.values():
        solve()
    check(program is None or program.built, "12d: the one-launch solve's graph was not built")
    ms = {label: [] for label in solvers}
    first, iters = None, None
    for label in tuple(x for x in ("eager", "graph", "one launch") if x in solvers) * reps + tuple(
            x for x in ("one launch", "graph", "eager") if x in solvers) * reps:
        sync(dev)
        calls, sa_calls, sa_ran = group.collective_calls(), sa.index_add_ordered.launches, sa.device_launches(dev)
        t0 = time.perf_counter()
        poses, cost = solvers[label]()
        sync(dev)
        ms[label].append(1e3 * (time.perf_counter() - t0))
        calls, sa_calls = group.collective_calls() - calls, sa.index_add_ordered.launches - sa_calls
        sa_ran = sa.device_launches(dev) - sa_ran
        check(sa_calls == sa_ran, f"12d {label}: scatter_add {sa_calls} counted, {sa_ran} ran on the device")
        if first is None:
            first = (poses, cost, calls, sa_calls)
        check(same_bits([poses, cost], list(first[:2])) and (calls, sa_calls) == first[2:],
              f"12d: the {label} GN-CG solve differs from the first (all-reduces {calls} against {first[2]}, "
              f"scatter_add {sa_calls} against {first[3]})")
    calls = first[2]
    cg_iters = calls - graph.cfg.outer_iterations - 1  # one per GN step, one per CG iteration, the cost
    check(graph.cg_iterations == cg_iters and (program is None or program.cg_iterations == cg_iters),
          f"12d: {graph.cg_iterations} CG iterations through CGGraph, "
          f"{None if program is None else program.cg_iterations} in one launch, {cg_iters} by all-reduces")
    syncs = {label: host_syncs(solve) for label, solve in solvers.items()}
    check(program is None or syncs["one launch"] == 1, f"12d: host syncs per one-launch solve {syncs}")
    med = {label: float(np.median(v)) for label, v in ms.items()}
    return {"ms": ms, "median_ms": med, "per_iteration_ms": {k: v / cg_iters for k, v in med.items()},
            "cg_iterations": cg_iters, "all_reduce": calls, "scatter_add": first[3], "poses": first[0],
            "cost": first[1], "syncs": syncs,
            "node_types": None if program is None else program.node_types,
            "structure": None if program is None else program.structure}


def cg_turns_line(res: dict) -> str:
    labels = [x for x in CG_SOLVERS if x in res["ms"]]
    return (f"GN-CG {' / '.join(labels)} in turns, ms per solve " + ", ".join(
        f"{label} " + "/".join(f"{v:.2f}" for v in res["ms"][label]) for label in labels)
        + "; per CG iteration (median) " + ", ".join(f"{x} {res['per_iteration_ms'][x]:.4f}" for x in labels)
        + f" ms; host syncs per solve " + ", ".join(f"{x} {res['syncs'][x]}" for x in labels)
        + f"; {res['cg_iterations']} CG iterations, {res['all_reduce']} "
        + f"all-reduces, {res['scatter_add']} scatter_add launches per solve (each its device count); every solve "
        + "bit for bit (poses, cost, all-reduces, CG iterations)"
        + (f"; the one launch's node types {res['node_types']}, nodes {res['structure']}" if res["node_types"] else ""))


def run_solve_costs(dev, config, engine, state, outs, group, backend: str) -> dict:
    """Phase 12d: dense LM against GN-CG, ms per solve, on the flagship's
    final graph (its keyframes at the poses reported when they were
    inserted) and on a chain the size of config_HD; GN-CG as the eager
    solve and as the graph program in turns (:func:`cg_turns`)."""
    import dataclasses

    from nislam_torch.core.pose_graph import _one_lane, solve_pose_graph
    from nislam_torch.core.slam import _map_problem, _optimize_map, _solver_config
    from nislam_torch.scripts.stagebench import solve_graph_ms
    from nislam_torch.utils.scaling import chain_problem

    bank = state.bank
    k = int(bank.count)
    inserted = torch.from_numpy(outs.pose[bank.frame_ids[:k].cpu().numpy()]).to(dev)
    start = dataclasses.replace(bank, poses=torch.cat([inserted, bank.poses[k:]]))
    (dense, dense_cost), dense_ms = _solve_ms(lambda: _optimize_map(start, state.edges, config, engine.camera))
    prob = _map_problem(start, state.edges, engine.camera)
    graph_ms = solve_graph_ms(_one_lane(prob), _solver_config(config), dev)
    with recorded_runs() as runs:
        cg = cg_turns(prob, group, dev)
    cg_poses = cg["poses"]
    print(f"12d, flagship final graph: {cg_turns_line(cg)} | {runs_line(runs)}")
    diff = lambda a, b: float(np.abs(_wrapped((a - b).cpu().numpy())).max())
    err = diff(cg_poses[:k], dense[:k])
    moved = diff(dense[:k], inserted)
    check(err <= POSE_ATOL, f"solve: GN-CG differs from dense LM by {err} on the flagship's graph")
    edges = int(state.edges.alive.sum())
    cg_ms = cg["median_ms"]
    print(f"solve, flagship final graph (K = {bank.capacity}, {k} live poses, {edges} live edges of "
          f"{state.edges.capacity}): dense LM {dense_ms:.2f} ms through the host loop, {graph_ms:.2f} ms as one "
          f"solve-graph launch (the LM loop a WHILE node), GN-CG ({backend}, 1 rank) {cg_ms['eager']:.2f} ms per "
          f"eager solve, {cg_ms['graph']:.2f} as the graph program, {cg_ms.get('one launch', float('nan')):.2f} as "
          f"one launch ({cg['all_reduce']} all-reduces each); cost "
          f"{float(dense_cost):.6g} vs {float(cg['cost']):.6g}; max |GN-CG - LM| {err:.2e} (the solve moves poses "
          f"by up to {moved:.3f})")

    prob = chain_problem(1024, 4096, device=dev)
    (hd_dense, _, hd_dense_cost), hd_dense_ms = _solve_ms(lambda: solve_pose_graph(prob), reps=2)
    hd_graph_ms = solve_graph_ms(_one_lane(prob), _solver_config(config), dev)
    hd = cg_turns(prob, group, dev)
    print(f"12d, chain K = 1024: {cg_turns_line(hd)}")
    hd_err = diff(hd["poses"], hd_dense)
    print(f"solve, chain K = {prob.poses.shape[0]} / E = {prob.from_slot.shape[0]} "
          f"({int(prob.edge_mask.sum())} live edges): dense LM "
          f"{hd_dense_ms:.2f} ms through the host loop, {hd_graph_ms:.2f} ms as one solve-graph launch, GN-CG "
          f"{hd['median_ms']['eager']:.2f} ms per eager solve, {hd['median_ms']['graph']:.2f} as the graph program, "
          f"{hd['median_ms'].get('one launch', float('nan')):.2f} as one launch "
          f"({hd['all_reduce']} all-reduces each); cost {float(hd_dense_cost):.6g} vs {float(hd['cost']):.6g}; max "
          f"|GN-CG - LM| {hd_err:.2e} (a long chain's soft directions: 64 CG iterations per step do not reach LM's "
          f"optimum there)")
    return {"flagship_dense_ms": dense_ms, "flagship_graph_ms": graph_ms, "flagship_cg_ms": cg_ms["eager"],
            "flagship_cg_graph_ms": cg_ms["graph"], "flagship_cg_launch_ms": cg_ms.get("one launch"),
            "hd_cg_launch_ms": hd["median_ms"].get("one launch"), "flagship_err": err, "cg_calls": cg["all_reduce"],
            "cg_iterations": cg["cg_iterations"], "cg_12d": cg, "hd_cg_12d": hd, "hd_dense_ms": hd_dense_ms,
            "hd_graph_ms": hd_graph_ms, "hd_cg_ms": hd["median_ms"]["eager"], "hd_cg_graph_ms": hd["median_ms"]["graph"],
            "hd_err": hd_err, "runs_12d": runs}


def peer_cases(group, config) -> dict:
    """``{label: (shape, dtype, one_shot_bytes)}``: the distributed engine's
    payloads (``peer_payloads``) and the protocol edges (``edge_payloads``)
    over ``group``."""
    from nislam_torch.scripts.captureprobe import edge_payloads, peer_payloads

    payloads = peer_payloads(config.map.keyframe_capacity, canvas_ring_config().map_stitcher.canvas_size, group.size,
                             (config.cf.height, config.cf.width))
    cases = {label: (shape, dtype, None) for label, (shape, dtype) in payloads.items()}
    cases.update(edge_payloads(group.size))
    return cases


def peer_probe(group, dev, config, what: str, shared: bool, library: bool = True) -> dict:
    """The peer all-reduce kernel over ``group`` at each payload of the
    distributed engine (``scripts/captureprobe.py --peer``: the GN-CG
    trigger's (K, 3) vector, (2, K, 3) block and (1,) cost, the (n, 11)
    search record, 12e's (2, S, S) canvas delta and an evicted image's
    int32 bits) and at each of its protocol edges (``edge_payloads``: the
    one shot and the two shot at 1, 3 and n·4 + 1 elements, each side of
    the crossover, three rounds): the kernel against its plain version bit
    for bit on this rank, every rank's result the same, a capture that a
    conditional body holds (one kernel node at n ranks, none at one) and
    whose replay gives the eager bits; µs per call in steady state eager
    and captured, the first call's apart, the plain version's, the
    library's (NCCL's, or gloo's on a gloo group; ``library`` False: left to
    :func:`library_probe`), the bound → {label: row}.  Ranks sharing the card
    time-slice (~2.2 ms a call), so they time fewer calls."""
    from nislam_torch.scripts.captureprobe import peer_ok, probe_peer

    res = {}
    for label, (shape, dtype, one_shot) in peer_cases(group, config).items():
        res[label] = r = probe_peer(group, shape, dtype, dev, shared, reps=4 if shared else 20,
                                    one_shot_bytes=one_shot, library=library)
        check(peer_ok(r), f"{what} all_reduce {label}: {r}")
    print(f"{what} all_reduce (the peer kernel, {group.size} rank{'s' if group.size > 1 else ''}, backend "
          f"{group.backend}): " + "; ".join(
              f"{label} {r['protocol']} ({r['blocks']} blocks, {r['rounds']} rounds) equal to its plain version and "
              f"on every rank, node types {r.get('nodes')}, replay bits {r.get('bits', 'n/a')}, {r['eager_us']:.2f} us "
              f"eager / {r['captured_us']:.2f} captured (first call {r['eager_first_us']:.2f} / "
              f"{r['captured_first_us']:.2f}; differences not positive {r['eager_nonpositive']} / "
              f"{r['captured_nonpositive']} of 3) / plain {r['plain_us']:.1f} / "
              + (f"{group.backend} {r['library_us']:.2f} / " if library else "") + f"bound {r['bound_us']:.3f}"
              for label, r in res.items()))
    return res


def library_probe(group, dev, config, probe: dict, what: str) -> None:
    """The process group's own all-reduce (gloo's on a gloo group) at each
    payload of :func:`peer_probe`'s rows ``probe`` (the same values), timed
    as the kernel was, into each row's ``library_us``.  12b's ranks call it
    after their path runs: gloo's all-reduce of card tensors goes through
    the host on threads and streams of its own, none of which the path
    then meets."""
    from nislam_torch.scripts.captureprobe import library_times, order_payload

    for label, (shape, dtype, _) in peer_cases(group, config).items():
        probe[label].update(library_times(group, order_payload(shape, dtype, group.rank, dev), dev, reps=4))
    print(f"{what}: {group.backend}'s all_reduce of the same card tensors: " + "; ".join(
        f"{label} {r['library_us']:.2f} us (differences not positive {r['library_nonpositive']} of 3)"
        for label, r in probe.items()), flush=True)


def trigger_turns(deng, frames_d, what: str = "12a", rounds: int = 2) -> dict:
    """The distributed engine's triggers: the flagship through the chunk
    graph with the trigger program and with the host-loop trigger,
    ``rounds`` times in turns (:func:`trigger_syncs`: host syncs and ms of
    each trigger that solved) → {label: {"syncs": [...], "ms": [...]}}
    over the rounds; every trigger of the program one host sync."""
    paths = {"chunk graph": deng, "host-loop trigger": HostLoopTriggerEngine(deng)}
    res = {label: {"syncs": [], "ms": [], "idle": []} for label in paths}
    for _ in range(rounds):
        for label, v in trigger_syncs(paths, frames_d, what).items():
            for k in v:
                res[label][k] += v[k]
    prog = res["chunk graph"]
    check(prog["syncs"] and set(prog["syncs"] + prog["idle"]) == {1},
          f"{what}: host syncs per trigger through the trigger program {prog}, 1 each expected")
    return res


def nccl_canvas(group, dev, frames: np.ndarray) -> dict:
    """12e's sequence (lane 0 of phase 11, :func:`canvas_ring_config`) on the
    one NCCL rank: after a warm-up run (captures; the trigger program's
    graph built at its first solve), one run through the chunk graph with
    the trigger program (its solving triggers one launch each, the canvas
    delta's all-reduce captured in it) and one with the host-loop trigger
    (the count-read recompute): outputs, tallies, every leaf (the canvas
    among them) bit for bit, collectives by payload equal, the delta's
    all-reduce in at least one solving trigger."""
    from nislam_torch.core.slam import pack_outputs, state_leaves
    from nislam_torch.parallel import make_distributed_engine
    from nislam_torch.parallel.solver import CGTrigger

    t0 = time.perf_counter()
    config = canvas_ring_config()
    seq = torch.from_numpy(frames).to(dev)
    engine = make_distributed_engine(config, group)
    dist_run(engine, seq, BATCH_CHUNK)
    check(engine.trigger_program.built, "12e on NCCL: the trigger program's graph was not built")
    delta_bytes = 2 * config.map_stitcher.canvas_size ** 2 * 4
    got = {}
    for label, eng in (("trigger program", engine), ("host-loop trigger", HostLoopTriggerEngine(engine))):
        c0, l0 = group.counts.copy(), CGTrigger.launches
        state, outs, tally = dist_run(eng, seq, BATCH_CHUNK)
        sync(dev)
        got[label] = ([x.clone() for x in state_leaves(state)], pack_outputs(outs), tally, group.counts - c0,
                      CGTrigger.launches - l0)
    (leaves, o, tally, coll, launches), (rleaves, ro, rtally, rcoll, rlaunches) = got.values()
    check(same_bits(o, ro) and tally == rtally and device_bits_equal(leaves, rleaves) and coll == rcoll,
          f"12e on NCCL: the trigger program differs from the host-loop trigger (tallies {tally}, {rtally}; "
          f"collectives {dict(coll)}, {dict(rcoll)})")
    solves = sum(tally)
    check(solves >= 1 and coll[("all_reduce", delta_bytes)] == solves and launches == len(tally) and rlaunches == 0,
          f"12e on NCCL: {solves} solves, {coll[('all_reduce', delta_bytes)]} delta all-reduces, {launches} "
          f"trigger-graph launches for {len(tally)} triggers")
    print(f"12e on 1 NCCL rank ({config.map.keyframe_capacity}-slot ring, {len(frames)} frames): the trigger "
          f"program (one launch per trigger: {launches}) bit for bit with the host-loop trigger (outputs, tallies "
          f"{tally}, every leaf with the canvas, collectives by payload); {solves} solving triggers, each with its "
          f"canvas delta's all-reduce ({delta_bytes} B) captured in the launch | {time.perf_counter() - t0:.1f} s")
    return {"solves": solves, "launches": launches}


def run_one_rank(ps, dev, config, engine, frames_d, gt, state, outs, canvas_frames):
    """Phases 12a and 12d: one rank over NCCL on the card."""
    import torch.distributed as dist

    from nislam_torch.core.loop_closure import find_loop_closure
    from nislam_torch.io.trajectory import ate_rmse
    from nislam_torch.parallel import init_distributed, make_distributed_engine

    t0 = time.perf_counter()
    group = init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, ONE_RANK_BACKEND, dev)
    backend = dist.get_backend()
    check(backend == ONE_RANK_BACKEND, f"12a: backend {backend}")
    try:
        check(group.capturable, "12a: the NCCL group's all-reduce is not capturable")
        probe = peer_probe(group, dev, config, "12a", False)
        deng = make_distributed_engine(config, group)
        with recorded_runs() as runs:
            res = dist_paths(deng, frames_d, dev, "12a", collectives=DIST_COLLECTIVES)
        st, o, tally = res["result"]
        _decisions_equal(o, outs, ("tracked", "inserted", "loop_found", "keyframe_slot", "loop_slot"),
                         "12a, one rank vs phase 3")
        err = float(np.abs(_wrapped(o.pose - outs.pose)).max())
        check(err <= DIST_POSE_ATOL, f"12a: poses differ from phase 3 by {err}")
        times = np.arange(N_FRAMES) / 30.0
        ate = ate_rmse(times, o.pose[:, :2], times, gt)
        tracked, loops = int(o.tracked.sum()), int(o.loop_found.sum())
        check(tracked == N_FRAMES and ate < 0.02 and loops >= 1 and any(tally),
              f"12a: tracked {tracked} of {N_FRAMES}, ATE {ate} m, {loops} loops, solves {tally}")

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
        print(f"12a: 1 rank, backend {backend}, {dev}: {N_FRAMES} flagship frames through the distributed "
              f"engine, {tracked}/{N_FRAMES} tracked, {loops} loops, solves {tally}, ATE {ate:.5f} m, decisions "
              f"equal to phase 3, max pose diff {err:.2e} | sharded search at loop frame {i} = find_loop_closure "
              f"(slot {int(sharded.loop_slot)}, {int(sharded.eligible_count)} eligible; max diff {serr:.1e}) | "
              f"{time.perf_counter() - t0:.1f} s")
        print(f"12a, the chunk graph against the track-graph path and the host-loop trigger: {dist_paths_line(res)}")
        print(f"12a: {runs_line(runs)}")
        trig = trigger_turns(deng, frames_d)
        prog = deng.trigger_program
        print(f"12a, the trigger program: built {prog.built}, node types in its captured steps {prog.node_types}, "
              f"nodes {prog.structure}")
        canvas = nccl_canvas(group, dev, canvas_frames)
        res["profiles"] = {label: profile_flagship(eng, frames_d, ps, f"12a {label}")
                           for label, eng in (("chunk graph", deng), ("track graph", TrackGraphEngine(deng)))}
        t0 = time.perf_counter()
        costs = run_solve_costs(dev, config, engine, state, outs, group, backend)
        costs.update(runs_12a=runs, paths_12a=res, trigger_12a=trig, probe_12a=probe, canvas_nccl=canvas,
                     trigger_structure=prog.structure, trigger_node_types=prog.node_types)
        print(f"12d: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    launches = sum(r["peak_stats"] for r in res["runs"])
    sa_launches = (sum(r["scatter_add"] for r in res["runs"])
                   + sum(sum(len(v) for v in c["ms"].values()) * c["scatter_add"]
                         for c in (costs["cg_12d"], costs["hd_cg_12d"])))
    return launches, sa_launches, costs


def rank_canvas(group, workdir: str, dev: torch.device) -> dict:
    """12e on one rank: the distributed engine with the online canvas
    (:func:`canvas_ring_config`) over lane 0 of phase 11 in chunks of
    BATCH_CHUNK, through its chunk graph (the keyframe branch in its
    SWITCH, the image's all-reduce at every stored keyframe inside it) and
    the track-graph path in turns (:func:`dist_paths`: bits, collectives
    by payload, branch runs, syncs) → the first run's outputs, poses,
    canvas, a fresh distributed recompute of its final bank, the canvas
    hook's all-reduces (an image per stored keyframe, the (2, S, S) canvas
    per recompute) by payload bytes, and the paths' figures."""
    from nislam_torch.core.slam import pack_outputs
    from nislam_torch.core.stitcher import make_canvas
    from nislam_torch.parallel import make_distributed_engine

    config = canvas_ring_config()
    seq = torch.from_numpy(np.load(os.path.join(workdir, "lanes.npy"), mmap_mode="r")[0].copy()).to(dev)
    engine = make_distributed_engine(config, group)
    with recorded_runs() as runs:
        paths = dist_paths(engine, seq, dev, f"12e rank {group.rank}", chunk=BATCH_CHUNK,
                           image_bytes=config.cf.height * config.cf.width * 4)
    state, outs, tally = paths["result"]
    first = paths["runs"][0]
    delta = first["collectives"]
    fresh = engine.recompute_canvas(make_canvas(config.map_stitcher, dev), state.bank)
    image_bytes = config.cf.height * config.cf.width * 4
    canvas_bytes = 2 * config.map_stitcher.canvas_size ** 2 * 4
    cs = paths["syncs"]["chunk graph"]
    return {
        "canvas_outs": pack_outputs(outs), "canvas_poses": state.bank.poses.cpu().numpy(),
        "canvas_count": state.bank.count.cpu().numpy(), "canvas_overflow": state.bank.overflow.cpu().numpy(),
        "canvas_solves": np.int32(sum(tally)), "canvas_seconds": np.float64(first["seconds"]),
        "canvas_data": state.canvas.data.cpu().numpy(), "canvas_weight": state.canvas.weight.cpu().numpy(),
        "canvas_fresh_data": fresh.data.cpu().numpy(), "canvas_fresh_weight": fresh.weight.cpu().numpy(),
        "canvas_retires": np.int64(first["images"]), "canvas_stored": np.int64(first["stored"]),
        "canvas_recomputes": np.int64(delta[("all_reduce", canvas_bytes)]),
        "canvas_image_bytes": np.int64(image_bytes), "canvas_bytes": np.int64(canvas_bytes),
        "canvas_coll_bytes": np.int64(first["all_reduce_bytes"]),
        "canvas_ar_launches": np.int64(sum(r["all_reduce_launches"] for r in paths["runs"])),
        "canvas_sa_launches": np.int64(sum(r["scatter_add"] for r in paths["runs"])),
        "canvas_sr_launches": np.int64(sum(r["stitch_raster"] for r in paths["runs"])),
        "canvas_runs": np.array(runs, dtype=np.int64),
        "canvas_fps_chunk": np.array(paths["fps"]["chunk graph"]),
        "canvas_fps_track": np.array(paths["fps"]["track graph"]),
        "canvas_fps_host": np.array(paths["fps"]["host-loop trigger"]),
        "canvas_run_counts": run_counts(paths["runs"]),
        "canvas_syncs": np.array([cs[k] for k in SYNC_KEYS], np.int64),
        "canvas_track_syncs": np.int64(paths["syncs"]["track graph"]["syncs"]),
    }


# The per-run counts that a rank of 12b and 12e saves, in this order.
RUN_KEYS = ("chunk_launches", "host_exits", "early_exits", "stored_runs", "dropped_runs", "peak_stats",
            "scatter_add", "stitch_raster", "cg_step", "all_reduce", "all_reduce_launches", "trigger_launches")
SYNC_KEYS = ("syncs", "launches", "host_exits", "inserting", "stored", "last_inserts")


def run_counts(runs: list) -> np.ndarray:
    return np.array([[r[k] for k in RUN_KEYS] for r in runs], np.int64)


def rank_paths_line(x: dict, prefix: str = "") -> str:
    """A rank's :func:`dist_paths` figures (saved by :func:`rank_main`
    under ``prefix``) as one line."""
    sc = x[f"{prefix}syncs"] if prefix else x["syncs_chunk"]
    track = int(x[f"{prefix}track_syncs"]) if prefix else int(x["syncs_track"][0])
    counts = x[f"{prefix}run_counts"] if prefix else x["run_counts"]
    return (f"per run ({', '.join(DIST_TURNS)}) " + ", ".join(RUN_KEYS) + " "
            + f"{counts.tolist()} | one chunk: host syncs chunk graph {int(sc[0])} ({int(sc[1])} launch, "
            + f"{int(sc[2])} host exits, {int(sc[3])} inserting, {int(sc[4])} stored frames), the track-graph path "
            + f"{track}")


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
    check(retires == int(r0["canvas_stored"]) and recomputes == solves,
          f"12e: {retires} image all-reduces for {int(r0['canvas_stored'])} stored keyframes, {recomputes} canvas "
          f"all-reduces for {solves} solves")
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
          f"{int(r0['canvas_image_bytes'])} per stored keyframe ({retires} all-reduces of the evicted image's "
          f"bits inside the chunk graph, all zeros but at the {evictions} evictions), "
          f"{int(r0['canvas_bytes'])} per recompute (one all-reduce of the (2, S, S) delta), "
          f"{int(r0['canvas_coll_bytes']) / n:.1f} per frame in all | scatter_add launches per rank {launches}, "
          f"stitch_raster {sr_launches} (four timed runs)")
    for r, x in enumerate(res):
        print(f"12e, rank {r}: the chunk graph (the branch in its SWITCH) against the track-graph path, bit for "
              f"bit (outputs, tallies, every state leaf, collectives by payload): frames/s in turns chunk graph "
              + "/".join(f"{v:.1f}" for v in x["canvas_fps_chunk"]) + ", the track-graph path "
              + "/".join(f"{v:.1f}" for v in x["canvas_fps_track"]) + ", the host-loop trigger "
              + "/".join(f"{v:.1f}" for v in x["canvas_fps_host"]) + f" | {rank_paths_line(x, 'canvas_')} | "
              + runs_line(x["canvas_runs"]))
    return sum(launches), sum(sr_launches)


def rank_main(argv) -> int:
    """One rank of phases 12b and 12c (``chip_smoke.py --rank R PORT DIR
    DEVICE``): writes its results to DIR/rankR.npz.  If it raises, it
    first says whether the card still answers (a synchronize: an earlier
    kernel's fault would show there) and how much of it is free."""
    try:
        return _rank_main(argv)
    except BaseException:
        dev = torch.device(argv[3])
        try:
            torch.cuda.synchronize(dev)
            health = "the card answers a synchronize"
        except Exception as e:  # the report goes on: the original error is raised below
            health = f"a synchronize raised {e!r}"
        try:
            free = f"{torch.cuda.mem_get_info(dev)[0] / 2 ** 30:.1f} GiB of the card free, this process reserves " \
                   f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.2f}"
        except Exception as e:
            free = f"the card's free memory not read ({e!r})"
        print(f"rank {argv[0]} failed: {health}; {free}", file=sys.stderr, flush=True)
        raise


def _rank_main(argv) -> int:
    import torch.distributed as dist

    from nislam_torch.core.slam import pack_outputs
    from nislam_torch.ops import peak_stats as ps
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
    probe = peer_probe(group, dev, config, f"12b rank {rank}", True, library=False)
    print(f"12b rank {rank}: after the probe the card has {torch.cuda.mem_get_info(dev)[0] / 2 ** 30:.1f} GiB "
          f"free, this process reserves {torch.cuda.memory_reserved(dev) / 2 ** 30:.2f}", flush=True)
    engine = make_distributed_engine(config, group)
    ps.peak_stats.shapes.clear()
    with recorded_runs() as runs:
        paths = dist_paths(engine, frames_d, dev, f"12b rank {rank}", collectives=DIST_COLLECTIVES)
    trig = trigger_turns(engine, frames_d, f"12b rank {rank}", rounds=1)
    state, outs, tally = paths["result"]
    first = paths["runs"][0]
    cs, ts = paths["syncs"]["chunk graph"], paths["syncs"]["track graph"]
    res.update(runs=np.array(runs, dtype=np.int64),
        outs=pack_outputs(outs), poses=state.bank.poses.cpu().numpy(),
        count=state.bank.count.cpu().numpy(), solves=np.int32(sum(tally)),
        fps_chunk=np.array(paths["fps"]["chunk graph"]), fps_track=np.array(paths["fps"]["track graph"]),
        fps_host=np.array(paths["fps"]["host-loop trigger"]),
        launches=np.int64(sum(r["peak_stats"] for r in paths["runs"])),
        sa_launches=np.int64(sum(r["scatter_add"] for r in paths["runs"])),
        chunk_launches=np.int64(sum(r["chunk_launches"] for r in paths["runs"])),
        run_counts=run_counts(paths["runs"]),
        syncs_chunk=np.array([cs[k] for k in SYNC_KEYS], np.int64),
        syncs_track=np.array([ts["syncs"], ts["inserting"], ts["stored"]], np.int64),
        search_shape=np.int64(ps.peak_stats.shapes[search_shape]),
        search_polar_shape=np.int64(ps.peak_stats.shapes[(c,) + tuple(cf.polar_shape)]),
        bank_rows=np.int64(state.bank.fft.shape[0]),
        coll_bytes=np.int64(first["all_reduce_bytes"]), coll_calls=np.int64(first["all_reduce"]),
        all_reduce_launches=np.int64(sum(r["all_reduce_launches"] for r in paths["runs"])),
        trigger=np.array(json.dumps(trig)),
    )
    del frames_d, engine, state, paths

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
    library_probe(group, dev, config, probe, f"12b rank {rank}")
    res["probe"] = np.array(json.dumps(probe))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    return 0


def rank_loop_main(argv) -> int:
    """``chip_smoke.py --rank-loop SECONDS VARIANTS``: 12b's start alone,
    again and again for SECONDS: two ranks sharing ``cuda:0`` over gloo
    run the peer probe, then the flagship's first distributed run
    (:func:`dist_run`, where 12b's rank 0 once failed to make a cuFFT
    plan), one variant after another of VARIANTS (comma-separated):
    ``gloo`` times gloo's all-reduce in the probe, before the run (as 12b
    did before its ranks timed it last), ``nogloo`` leaves it out.  Each
    launch's exit codes, and at the end the runs and failures by
    variant."""
    from nislam_torch.kernels.build import build

    seconds, variants = float(argv[0]), argv[1].split(",")
    t_start = time.perf_counter()
    kernels = ("peak_stats", "sum_only", "scatter_add", "stitch_raster", "cond_graph", "all_reduce")
    with ThreadPoolExecutor(len(kernels)) as ex:
        list(ex.map(build, kernels))
    tally = {v: [0, 0] for v in variants}
    with tempfile.TemporaryDirectory(prefix="nislam_rank_loop_") as workdir:
        np.save(os.path.join(workdir, "flagship.npy"), flagship_frames()[0])
        i, last = 0, 0.0
        while time.perf_counter() - t_start + 1.2 * last < seconds:
            v = variants[i % len(variants)]
            t0 = time.perf_counter()
            port = free_port()
            logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(RANKS)]
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--loop-rank", str(r), str(port),
                                       workdir, v], stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
                     for r in range(RANKS)]
            deadline = time.monotonic() + 240
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
            codes = [p.returncode for p in procs]
            last = time.perf_counter() - t0
            tally[v][0] += 1
            tally[v][1] += any(codes)
            print(f"launch {i} {v}: exit codes {codes}, {last:.1f} s", flush=True)
            for r, code in enumerate(codes):
                if code:
                    with open(os.path.join(workdir, f"rank{r}.log")) as f:
                        print(f"rank {r}'s output:\n{f.read()[-3000:]}", flush=True)
            i += 1
    print("runs and failures by variant: " + json.dumps(tally) + f"; {time.perf_counter() - t_start:.1f} s")
    return 0


def loop_rank_main(argv) -> int:
    """One rank of :func:`rank_loop_main` (``chip_smoke.py --loop-rank R
    PORT DIR VARIANT``)."""
    import torch.distributed as dist

    from nislam_torch.parallel import init_distributed, make_distributed_engine

    rank, port, workdir, variant = int(argv[0]), argv[1], argv[2], argv[3]
    dev = torch.device("cuda", 0)
    group = init_distributed(f"tcp://127.0.0.1:{port}", RANKS, rank, SHARED_CARD_BACKEND, dev, timeout_s=200)
    config = flagship_config()
    frames_d = torch.from_numpy(np.load(os.path.join(workdir, "flagship.npy"))).to(dev)
    peer_probe(group, dev, config, f"rank {rank}", True, library=variant == "gloo")
    dist_run(make_distributed_engine(config, group), frames_d)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def nccl_rank_main(argv) -> int:
    """One rank of ``--nccl-ranks N`` (``chip_smoke.py --nccl-rank R N PORT
    DIR``): NCCL on ``cuda:R``, the flagship through the distributed engine
    by :func:`dist_paths` (the chunk graph with its branch and trigger
    inside, the track-graph path, the host-loop trigger, in turns, bit for
    bit on this rank) and its triggers (:func:`trigger_turns`); writes
    DIR/rankR.npz."""
    import torch.distributed as dist

    from nislam_torch.core.slam import pack_outputs
    from nislam_torch.parallel import init_distributed, make_distributed_engine
    from nislam_torch.scripts.common import card_line

    rank, n, port, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    dev = torch.device("cuda", rank)
    group = init_distributed(f"tcp://127.0.0.1:{port}", n, rank, ONE_RANK_BACKEND, dev, timeout_s=RANK_TIMEOUT_S)
    frames_d = torch.from_numpy(np.load(os.path.join(workdir, "flagship.npy"))).to(dev)
    engine = make_distributed_engine(flagship_config(), group)
    what = f"{n} NCCL ranks, rank {rank}"
    paths = dist_paths(engine, frames_d, dev, what, collectives=DIST_COLLECTIVES)
    trig = trigger_turns(engine, frames_d, what, rounds=1)
    state, outs, tally = paths["result"]
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), outs=pack_outputs(outs),
             poses=state.bank.poses.cpu().numpy(), count=state.bank.count.cpu().numpy(), solves=np.int32(sum(tally)),
             fps=np.array([paths["fps"][label] for label in DIST_PATHS]), run_counts=run_counts(paths["runs"]),
             syncs=np.int64(paths["syncs"]["chunk graph"]["syncs"]), trigger=np.array(json.dumps(trig)),
             card=np.array(card_line(dev)))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def nccl_ranks_main(argv) -> int:
    """``chip_smoke.py --nccl-ranks N``, on a machine with N cards: the
    flagship through the distributed engine at N NCCL ranks, a card each
    (:func:`nccl_rank_main`), beside the single engine on ``cuda:0``
    (phase 3's run): every rank the same outputs, poses, count and solves,
    every frame tracked, ATE < 0.02 m, loops and solves, on each rank its
    routes bit for bit and the 386 collectives per run each one kernel
    launch; the frames whose decisions differ from the single engine's
    (above two ranks the sharded search's share of candidates may pick
    another loop), frames/s per rank by path and the trigger program's
    host syncs and ms per solving trigger."""
    from nislam_torch.core.slam import make_engine, unpack_step_output
    from nislam_torch.io.trajectory import ate_rmse

    n = int(argv[0])
    check(torch.cuda.device_count() >= n, f"--nccl-ranks {n}: {torch.cuda.device_count()} cards")
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    config = flagship_config()
    frames, gt = flagship_frames()
    _, outs, _ = run_slice(make_engine(config, dev), torch.from_numpy(frames).to(dev))
    with tempfile.TemporaryDirectory(prefix="nislam_nccl_ranks_") as workdir:
        np.save(os.path.join(workdir, "flagship.npy"), frames)
        port = free_port()
        logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--nccl-rank", str(r), str(n), str(port),
                                   workdir], stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT) for r in range(n)]
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
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                log = f.read()
            if p.returncode != 0:
                print(f"rank {r}'s output:\n{log[-6000:]}", file=sys.stderr)
            check(p.returncode == 0, f"--nccl-ranks {n}: rank {r} exited {p.returncode}")
        res = []
        for r in range(n):
            with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
                res.append(dict(f))
    for key in ("outs", "poses", "count", "solves"):
        check(all(np.array_equal(x[key], res[0][key]) for x in res), f"{n} NCCL ranks: the ranks' {key} differ")
    o = unpack_step_output(res[0]["outs"])
    tracked, loops, solves = int(o.tracked.sum()), int(o.loop_found.sum()), int(res[0]["solves"])
    # Each rank searches its share of the candidates, ceil(8 / n), as JAX's
    # sharded search does (nislam_tpu/parallel/loop_search.py): above two
    # ranks a loop decision may differ from the single engine's, so the
    # differing frames are counted, not held.
    differ = {name: int((getattr(o, name) != getattr(outs, name)).sum()) for name in ("inserted", "loop_found")}
    err = float(np.abs(_wrapped(o.pose - outs.pose)).max())
    times = np.arange(N_FRAMES) / 30.0
    ate = ate_rmse(times, o.pose[:, :2], times, gt)
    check(tracked == N_FRAMES and ate < 0.02 and loops >= 1 and solves >= 1,
          f"{n} NCCL ranks: tracked {tracked}, ATE {ate} m, {loops} loops, {solves} solves")
    print(f"{n} NCCL ranks, a card each ({', '.join(str(x['card']) for x in res)}): the flagship's {N_FRAMES} "
          f"frames through the distributed engine, every rank the same bits, {tracked} tracked, {loops} loops "
          f"(the single engine {int(outs.loop_found.sum())}), {solves} solves, ATE {ate:.5f} m; frames whose "
          f"decision differs from the single engine's {differ}, max pose diff {err:.2e}; "
          f"{time.perf_counter() - t0:.1f} s")
    for r, x in enumerate(res):
        trig = json.loads(str(x["trigger"]))
        print(f"rank {r}: frames/s in turns " + ", ".join(
            f"{label} " + "/".join(f"{v:.1f}" for v in fps) for label, fps in zip(DIST_PATHS, x["fps"]))
            + f" | per run ({', '.join(DIST_TURNS)}) " + ", ".join(RUN_KEYS) + f" {x['run_counts'].tolist()}"
            + f" | host syncs per chunk {int(x['syncs'])} | per solving trigger, host syncs / ms: "
            + "; ".join(f"{label} {v['syncs']} / {[round(m, 2) for m in v['ms']]}" for label, v in trig.items()))
    return 0


def run_two_ranks(dev, config, frames, gt, outs, lane_refs) -> tuple:
    """Phases 12b, 12c and 12e: two spawned ranks sharing the card over
    gloo → (peak_stats, scatter_add, stitch_raster launches) of their path
    runs, the longest runs of equal keys, 12b's frames/s per rank by path
    (the median of each path's two runs), 12b's chunk-graph launches per
    rank)."""
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
    torch.cuda.empty_cache()  # the ranks share this card: its cached blocks are freed for them
    free_gib = torch.cuda.mem_get_info(dev)[0] / 2 ** 30
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
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    # The ranks that were killed first, those that raised last: the end of
    # the output holds the error.
    for r, code in sorted(failed, key=lambda f: f[1] > 0):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            print(f"rank {r}'s output:\n{f.read()[-6000 if code > 0 else -1500:]}", file=sys.stderr)
    check(not failed, f"12b/c/e: ranks (rank, exit code) {failed} failed (killed after {RANK_TIMEOUT_S} s if "
                      f"negative); the card's free memory at their start {free_gib:.1f} GiB")
    res = []
    for r in range(RANKS):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
            res.append(dict(f))
    print(f"12b/c/e: {RANKS} ranks on {dev}, backend {res[0]['backend']}, ran in "
          f"{time.perf_counter() - t0:.1f} s (spawn, frames from .npy, warm-up included); the card's free memory "
          f"at their start {free_gib:.1f} GiB")

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
    fps = {label: [float(np.median(x[key])) for x in res]
           for label, key in zip(DIST_PATHS, ("fps_chunk", "fps_track", "fps_host"))}
    print(f"12b: flagship over {RANKS} ranks sharing the card ({config.map.keyframe_capacity} slots as "
          f"{int(res[0]['bank_rows'])} per rank, 4 candidates per rank): {N_FRAMES}/{N_FRAMES} tracked, "
          f"{int(res[0]['count'])} keyframes, {loops} loops, {solves} GN-CG solves, ATE {ate:.5f} m; "
          f"decisions equal to phase 3, max pose diff {err:.2e}; both ranks equal, and on each rank the track-graph path "
          f"equal to the chunk graph bit for bit | frames/s per rank in turns (two processes time-sharing one "
          f"card: the sharded path's overhead, not scaling) " + "; ".join(
              f"rank {r}: chunk graph " + "/".join(f"{v:.1f}" for v in x["fps_chunk"]) + ", the track-graph path "
              + "/".join(f"{v:.1f}" for v in x["fps_track"]) + ", the host-loop trigger "
              + "/".join(f"{v:.1f}" for v in x["fps_host"]) for r, x in enumerate(res))
          + f" | collective bytes per frame {int(res[0]['coll_bytes']) / N_FRAMES:.1f} "
          f"({int(res[0]['coll_calls'])} all-reduces) | peak_stats per rank per run: "
          f"{[int(x['run_counts'][0][RUN_KEYS.index('peak_stats')]) for x in res]} launches (each its device "
          f"count), at (4, 2, 480, 640): "
          f"{[int(x['search_shape']) for x in res]} in all its runs")
    for r, x in enumerate(res):
        print(f"12b, rank {r}: {rank_paths_line(x)} | {runs_line(x['runs'])}")
    probes = [json.loads(str(x["probe"])) for x in res]
    trig = [json.loads(str(x["trigger"])) for x in res]
    check(probes[0].keys() == probes[1].keys(), "12b: the ranks probed different payloads")
    print("12b: the trigger program per solving trigger, host syncs / ms (the host-loop trigger's beside it): "
          + "; ".join(f"rank {r}: " + ", ".join(f"{label} {v['syncs']} / {[round(m, 2) for m in v['ms']]}"
                                                for label, v in t.items()) for r, t in enumerate(trig)))

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
    chunk_launches = {"12b": [int(x["chunk_launches"]) for x in res],
                      "12e": [int(x["canvas_run_counts"][:, RUN_KEYS.index("chunk_launches")].sum()) for x in res]}
    syncs = [int(x["syncs_chunk"][0]) for x in res]
    peer = {"probe": probes, "trigger": trig,
            "launches": [int(x["all_reduce_launches"]) + int(x["canvas_ar_launches"]) for x in res]}
    return (sum(int(x["launches"]) + int(x["fleet_launches"]) for x in res), sa_launches, sr_launches, runs, fps,
            chunk_launches, syncs, peer)


def run_multi_rank(ps, dev, config, engine, frames, gt, state, outs, lane_refs) -> dict:
    """Phase 12; returns the kernel launches of its path runs, the ranks' included."""
    frames_d = torch.from_numpy(frames).to(dev)
    launches, sa_launches, costs = run_one_rank(ps, dev, config, engine, frames_d, gt, state, outs, lane_refs[0][0])
    del frames_d
    more, sa_more, sr_launches, runs, fps, chunk_launches, syncs, peer = run_two_ranks(dev, config, frames, gt, outs,
                                                                                        lane_refs)
    costs.update({f"runs_{k}": v for k, v in runs.items()}, fps_12b=fps, chunk_launches_12b=chunk_launches["12b"],
                 chunk_launches_12e=chunk_launches["12e"], syncs_12b=syncs, peer_12b=peer)
    return {"launches": launches + more, "sa_launches": sa_launches + sa_more, "sr_launches": sr_launches, **costs}


# Phase 13: the measuring entry points.  bench.py's JSON keys, the port's
# bench's contract.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ate_rmse_m", "tracked_frac", "device", "image",
              "polar", "semantics", "loop_truncated_frames"}
BATCH_KEYS = {"batch_size", "batch_frames_per_sec_per_chip"}
N_BENCH_BATCH_FRAMES = 128  # bench --batch 8: 32 frames per lane
BENCH_LIBRARIES = ["cond_graph", "peak_stats", "scatter_add"]  # the libraries of the bench's path
N_HDPROFILE_FRAMES = 24  # hdprofile's default is 48


def captured(main, argv, label: str) -> str:
    """``main(argv)`` of a measuring script in this process: prints its
    output, each line under ``label``, and returns it (exit 0 required)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"{label}: {line}")
    check(rc == 0, f"{label} exited {rc}")
    return out


def run_bench(ps, sa, dev: torch.device, argv) -> tuple:
    """``nislam_torch.scripts.bench`` in this process, the kernel counts set
    to 0 just before it → (its run, its stderr, peak_stats launches,
    scatter_add launches).  Prints its stderr lines and its JSON line."""
    from nislam_torch.scripts import bench

    err = io.StringIO()
    sync(dev)
    ps.peak_stats.launches = 0
    sa.index_add_ordered.launches = 0
    with contextlib.redirect_stderr(err):
        res = bench.run(bench.parse([*argv, "--device", str(dev)]))
    launches, sa_launches = ps.peak_stats.launches, sa.index_add_ordered.launches
    label = " ".join(["bench", *argv])
    for line in err.getvalue().splitlines():
        print(f"{label}: {line}")
    print(f"{label}: {json.dumps(res['result'])}")
    return res, err.getvalue(), launches, sa_launches


def fresh_bench(dev: torch.device) -> str:
    """``python -m nislam_torch.scripts.bench --quick`` in a process of its
    own, where no kernel is loaded and no cuFFT plan made before it runs →
    its stderr.  Prints its stderr and JSON lines; fails unless its warm-up
    loaded the bench path's kernels, made its plans and captured the
    engine's two graphs, and its timed window loaded, made and captured
    none."""
    proc = subprocess.run([sys.executable, "-m", "nislam_torch.scripts.bench", "--quick", "--device", str(dev)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    for line in (proc.stderr + proc.stdout).splitlines():
        print(f"fresh bench --quick: {line}")
    check(proc.returncode == 0, f"fresh bench --quick exited {proc.returncode}")
    check(set(json.loads(proc.stdout.splitlines()[-1])) == BENCH_KEYS, "fresh bench --quick: JSON keys")
    line = next((ln for ln in proc.stderr.splitlines() if ln.startswith("in the timed window: ")), "")
    m = re.fullmatch(r"in the timed window: kernel libraries loaded before it \[(.*)\], (\d+) inside it \[.*\] \| "
                     r"cuFFT plans (\d+) before it, (\d+) made inside it \| "
                     r"CUDA graphs captured (\d+) before it, (\d+) inside it", line)
    check(m is not None, f"fresh bench --quick: no window line ({line!r})")
    before = [name.strip("' ") for name in m.group(1).split(",") if name.strip()]
    check(sorted(before) == BENCH_LIBRARIES and int(m.group(3)) > 0,
          f"fresh bench --quick: the warm-up loaded {before} and made {m.group(3)} cuFFT plans")
    # the frame graph's track graph, its branch graph for a stored keyframe
    # and the chunk graph's builds over them
    check(int(m.group(5)) >= 3, f"fresh bench --quick: the warm-up captured {m.group(5)} CUDA graphs, not the "
                                f"track and branch graphs and a chunk graph build")
    check(m.group(2) == "0" and m.group(4) == "0" and m.group(6) == "0",
          f"fresh bench --quick: its timed window loaded {m.group(2)} kernel libraries, made {m.group(4)} cuFFT "
          f"plans, captured {m.group(6)} CUDA graphs")
    return proc.stderr


def run_measuring(ps, sa, dev, outs, ate) -> dict:
    """Phase 13: the port's measuring entry points on the card, against
    phase 3's outputs ``outs`` and ATE → the kernel launches of its bench
    runs."""
    from nislam_torch.scripts import hdbench, hdprofile, opbench, polarbench, psrcal, rotstudy, stagebench

    t_phase = time.perf_counter()
    # 13a: the bench at the flagship: phase 3's workload, chunking and config.
    t0 = time.perf_counter()
    res, _, launches, sa_launches = run_bench(ps, sa, dev, [])
    bench_fps = res["result"]["value"]
    got = res["outs"]
    check(set(res["result"]) == BENCH_KEYS, f"bench: JSON keys {sorted(res['result'])}")
    for name in ("tracked", "inserted", "loop_found", "keyframe_slot", "loop_slot"):
        check(np.array_equal(getattr(got, name), getattr(outs, name)), f"bench and phase 3 disagree on {name}")
    check(same_bits(got.pose, outs.pose), "bench: poses differ from phase 3's")
    check(res["result"]["tracked_frac"] == 1.0 and abs(res["ate"] - ate) <= 1e-9,
          f"bench: tracked_frac {res['result']['tracked_frac']}, ATE {res['ate']} against phase 3's {ate}")
    check(res["window_launches"] >= 2 * N_FRAMES - 2,
          f"bench: {res['window_launches']} peak_stats launches in the timed window")
    check(res["window"]["loaded"] == [] and res["window"]["fft_plans"] == 0 and res["window"]["graphs"] == 0,
          f"bench: its timed window loaded, planned or captured: {res['window']}")
    print(f"13a bench at the flagship: decisions, poses and ATE {res['ate']:.5f} m equal to phase 3's | "
          f"peak_stats launches {launches}, {res['window_launches']} in the timed window | "
          f"{time.perf_counter() - t0:.1f} s")
    # 13a': the warm-up in a fresh process: every kernel load and cuFFT
    # plan before the timed window.
    t0 = time.perf_counter()
    fresh_bench(dev)
    print(f"13a' bench --quick in a fresh process: the warm-up loaded {BENCH_LIBRARIES}, made the cuFFT plans, "
          f"captured the track and branch graphs and built the chunk graph; its timed window loaded, made and "
          f"captured none | "
          f"{time.perf_counter() - t0:.1f} s")
    # 13b: the batch engine's measure.
    t0 = time.perf_counter()
    res, err, more, sa_more = run_bench(ps, sa, dev, ["--batch", str(N_BATCH), "--frames", str(N_BENCH_BATCH_FRAMES)])
    per_lane = N_BENCH_BATCH_FRAMES // 4
    check(set(res["result"]) == BENCH_KEYS | BATCH_KEYS, f"bench --batch: JSON keys {sorted(res['result'])}")
    check(f"tracked per lane {[per_lane] * N_BATCH}" in err, "bench --batch: a lane lost frames")
    m = re.search(r"batch timed chunk: CUDA graphs captured (\d+) before it, (\d+) inside it", err)
    check(m is not None and m.group(2) == "0", f"bench --batch: its timed chunk captured graphs ({m and m.group(0)})")
    launches, sa_launches = launches + more, sa_launches + sa_more
    batch_fps = res["result"]["batch_frames_per_sec_per_chip"]
    print(f"13b bench --batch {N_BATCH}: {time.perf_counter() - t0:.1f} s")
    # 13c: stagebench at 480x640 and 1200x1600.
    for size in (640, 1200):
        t0 = time.perf_counter()
        out = captured(stagebench.main, ["--size", str(size), "--device", str(dev)], f"stagebench {size}")
        rows = json.loads(out.splitlines()[-1])["stagebench"]
        # The body rows (body k, k lane branches, body k in the chunk graph) up to the flagship's size.
        bodies = [f"batch x{N_BATCH}, body {k}: {k} of {N_BATCH} lanes store + search, one replay"
                  for k in stagebench.BODY_KS] if size == 640 else []
        bodies += [f"batch x{N_BATCH} chunk graph, body {k} on every frame (per frame of {stagebench.CHUNK_FRAMES})"
                   for k in stagebench.BODY_KS] if size == 640 else []
        # and the distributed branch per stored keyframe, eager and as captured steps
        bodies += [label for label in rows if label.startswith("distributed branch")]
        want = 18 + (3 * len(stagebench.BODY_KS) + 2 if size == 640 else 0)
        check(len(rows) == want and all(r["equal"] for r in rows.values()),
              f"stagebench {size}: {len(rows)} rows of {want}, or a stage's output differs from one plain call's")
        check(rows["peak_stats"]["launches"] > 0, f"stagebench {size}: the peak_stats stage launched no kernel")
        for label in ("tracked frame, graph replay", "frame graph, no keyframe",
                      "frame graph, keyframe stored + loop search", "batch x8 frame graph, no keyframe",
                      f"chunk graph, no keyframe (per frame of {stagebench.CHUNK_FRAMES})",
                      f"chunk graph, keyframe stored + loop search (per frame of {stagebench.CHUNK_FRAMES})",
                      *bodies):
            check(rows[label]["launches"] > 0, f"stagebench {size}: {label}: its replays counted no peak_stats launch")
        print(f"13c stagebench --size {size}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = captured(stagebench.main, ["--solve", "--r", "5", "--device", str(dev)], "stagebench --solve")
    rows = json.loads(out.splitlines()[-1])["stagebench_solve"]
    check(len(rows) == len(stagebench.SOLVE_CASES) and all(r["equal"] and r["graph_ms"] > 0 for r in rows.values()),
          f"stagebench --solve: {rows}")
    cg_rows = json.loads(out.splitlines()[-1])["stagebench_solve_cg"]
    check(len(cg_rows) == len(stagebench.CG_CASES) and all(r["equal"] for r in cg_rows.values()),
          f"stagebench --solve: the GN-CG graph program differs from the eager solve: {cg_rows}")
    print(f"13c stagebench --solve: {time.perf_counter() - t0:.1f} s")
    # 13d: one HD chunk under the profiler.
    t0 = time.perf_counter()
    prof = hdprofile.profile(1200, 1600, N_HDPROFILE_FRAMES, 4, dev)
    for line in hdprofile.report(prof, time.perf_counter() - t0).splitlines():
        print(f"hdprofile: {line}")
    total = sum(r["ms"] for r in prof["top"]["kernels"])
    check(prof["tracked"] == prof["frames"] and prof["activity"]["busy_ms"] > 0,
          f"hdprofile: {prof['tracked']} of {prof['frames']} frames tracked, busy {prof['activity']['busy_ms']} ms")
    check(total <= prof["activity"]["busy_ms"] * (1 + 1e-9),
          f"hdprofile: top kernels {total} ms > device busy {prof['activity']['busy_ms']} ms")
    print(f"13d hdprofile: {time.perf_counter() - t0:.1f} s")
    # 13e: the microbenches, short.
    for label, main, argv in (
        ("hdbench", hdbench.main, ["--r", "10"]),
        ("opbench", opbench.main, ["--k", "2", "6"]),
        ("polarbench", polarbench.main, ["--size", "640", "--batch", "8", "--r", "10"]),
        ("psrcal", psrcal.main, ["--sizes", "128", "256", "512", "--frames", "24"]),
        ("rotstudy", rotstudy.main, ["--channels", "64", "480", "--angles", "8", "--seeds", "42"]),
    ):
        t0 = time.perf_counter()
        out = captured(main, [*argv, "--device", str(dev)], label)
        check(out.startswith("device: ") and len(out.splitlines()) > 2, f"{label}: {out}")
        print(f"13e {label}: {time.perf_counter() - t0:.1f} s")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "sa_launches": sa_launches, "fps": bench_fps, "batch_fps": batch_fps}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nislam_torch.core.chunk_graph import ChunkGraph
    from nislam_torch.core.pose_graph import lm_step
    from nislam_torch.core.slam import make_engine
    from nislam_torch.core.solve_graph import SolveGraph, trigger
    from nislam_torch.io.trajectory import ate_rmse
    from nislam_torch.kernels.launch import solve_device_launches
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
    kernels = ("peak_stats", "sum_only", "scatter_add", "stitch_raster", "cond_graph", "all_reduce")
    with ThreadPoolExecutor(len(kernels)) as ex:  # one nvcc per source, together
        list(ex.map(build, kernels))
    print(f"kernel builds ({', '.join(kernels)}): {time.perf_counter() - t0:.2f} s")

    # --- 2. kernel against the plain version ---------------------------
    t0 = time.perf_counter()
    kres = check_kernel(dev)
    print(f"kernel checks and timings: {time.perf_counter() - t0:.1f} s")
    scatter_rows = check_scatter_add(dev, kres["floor_ms"])
    stitch_rows = check_stitch_raster(dev, kres["floor_ms"])
    solve_rows = check_solve_kernels(dev, kres["floor_ms"])
    cg_step_row = check_cg_step_kernel(dev, kres["floor_ms"])

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
    warm_exits = engine.chunk_graph.early_exits
    print(f"warm-up run: {time.perf_counter() - t0:.2f} s | the chunk graph's early exits in it {warm_exits} (a "
          f"branch kind's first use)")
    ran = ps.device_launches(dev)
    solve_ran = solve_device_launches(dev)
    ps.peak_stats.launches = 0
    sa.index_add_ordered.launches = 0
    ChunkGraph.launches = 0
    SolveGraph.launches = trigger.launches = lm_step.launches = 0
    t0 = time.perf_counter()
    with recorded_solves() as costs:
        state, outs, solves = run_slice(engine, frames_d)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ps.peak_stats.launches
    ran = ps.device_launches(dev) - ran
    check(ran == launches, f"slice: {launches} peak_stats calls counted, {ran} launches ran on the device")
    solve_launches = {"trigger": trigger.launches, "lm_step": lm_step.launches}
    solve_ran = [b - a for a, b in zip(solve_ran, solve_device_launches(dev))]
    sg_launches = SolveGraph.launches
    check(sg_launches == N_FRAMES // CHUNK + 1 and list(solve_launches.values()) == solve_ran
          and solve_launches["lm_step"] > 0,
          f"slice: {sg_launches} solve-graph launches (want {N_FRAMES // CHUNK + 1}), trigger and lm_step launches "
          f"counted {solve_launches}, run on the device {solve_ran}")
    sa_launches = sa.index_add_ordered.launches
    cg_launches = ChunkGraph.launches
    exits = engine.chunk_graph.early_exits - warm_exits
    check(cg_launches == N_FRAMES // CHUNK and exits == 0,
          f"slice: {cg_launches} chunk-graph launches, {exits} early exits (want {N_FRAMES // CHUNK} and 0)")
    tracked = int(outs.tracked.sum())
    loops = int(outs.loop_found.sum())
    times = np.arange(N_FRAMES) / 30.0
    ate = ate_rmse(times, outs.pose[:, :2], times, gt)
    print(f"slice: {N_FRAMES} frames in {dt:.3f} s = {N_FRAMES / dt:.1f} frames/s "
          f"(incl. deferred solves and finalize) | tracked {tracked} | keyframes "
          f"{int(state.bank.count)} | loops {loops} | solves {solves} | ATE {ate:.5f} m "
          f"| peak_stats launches {launches} (as many ran on the device) | chunk-graph launches {cg_launches}, "
          f"early exits {exits} | solve-graph launches {sg_launches}: trigger {solve_launches['trigger']}, lm_step "
          f"{solve_launches['lm_step']} launches (as many ran on the device)")
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

    # --- 3g. the chunk graph against the frame graph, the track-graph path and the eager loop ----------
    graph_res = check_graph(ps, dev, card, engine, frames_d, state, outs, costs, launches)
    cres = check_cond_graph(dev, engine, frames_d)

    # --- 3i. the inline solve inside the chunk graph ---------------------------
    inline_res = check_inline(ps, dev, card, frames_d)

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
    option_launches, option_sa_launches, option_sr_launches, runs8, option_graph = run_options(ps, dev)

    # --- step-mode latency (nislam_torch.scripts.stepbench) -------------------
    steps = run_stepbench()

    # --- 10a. the registration model -----------------------------------------
    check_registration_model(dev)

    # --- 11. the batch engine ----------------------------------------------------
    batch_launches, lane_refs, batch_res = run_batch(ps, dev)

    # --- 12. multi-rank on the one card -------------------------------------
    t0 = time.perf_counter()
    multi = run_multi_rank(ps, dev, config, engine, frames, gt, state, outs, lane_refs)
    print(f"multi-rank phases: {time.perf_counter() - t0:.1f} s")

    # --- 13. the measuring entry points ------------------------------------
    measuring = run_measuring(ps, sa, dev, outs, ate)

    dist_launches_12a = sum(r["chunk_launches"] for r in multi["paths_12a"]["runs"])
    ar_12a = sum(r["all_reduce_launches"] for r in multi["paths_12a"]["runs"])
    # At one rank the sum is the payload: 12a launches no all_reduce; each
    # 12b/12e rank launches one per collective.
    check(ar_12a == 0 and min(multi["peer_12b"]["launches"]) > 0,
          f"phase 12: all_reduce launches {ar_12a} at one rank (0 expected), "
          f"{multi['peer_12b']['launches']} per rank at two (some expected)")
    ar_label = next(iter(multi["probe_12a"]))  # the (K, 3) CG vector, the most frequent payload
    ar_main = multi["peer_12b"]["probe"][0][ar_label]
    cg_step_12a = sum(r["cg_step"] for r in multi["paths_12a"]["runs"])
    check(cg_step_12a > 0, "12a: the main path launched no cg_step kernel")
    flag = kres["times"]["(480, 640)"]
    sa_main = scatter_rows["dense LM H (K*K, 9), K=272 E=1024"]
    sr_main = stitch_rows["insert 480x640 on 4096^2"]
    # One CUDA kernel replaces both Pallas kernels (pallas_kernels.py:49
    # and :88, the row-blocked variant for responses over 4 MB), one launch
    # per call.  Its
    # launches are those of every path run above, each counted from 0; its
    # times are at the flagship's tracking response (480, 640).  No one
    # PyTorch call gives the peak, the column-major-first argmax, Σ and Σ².
    for where, res in (("flagship", graph_res), ("HD via the CLI's drive", hd["graph_3g"])):
        print(f"per frame in a profiled trace, {where}: " + "; ".join(
            f"{label} {per_frame(res[label], res[label]['frames'])}, busy share {res[label]['busy_share']:.4f}"
            for label in PROFILED))
    print(f"per frame in a profiled trace, HD via the CLI's --profile: {per_frame(hd['profile'], N_PROFILE_FRAMES)}")
    longest_runs = {"3": runs3, "8": runs8, **{k[5:]: multi[k] for k in ("runs_12a", "runs_12d", "runs_12b", "runs_12e")}}
    print(f"scatter_add on the main path (phases 3, 8, 12a, 12d's GN-CG, 12b, 12e): "
          f"{runs_line(r for v in longest_runs.values() for r in v)}")
    print(f"summary: phase 3 flagship {N_FRAMES / dt:.1f} frames/s, bits repeat | 3g frames/s in turns "
          + ", ".join(f"{label} " + "/".join(f"{v:.1f}" for v in graph_res["fps"][label]) for label in graph_res["fps"])
          + " | 3g host syncs per 128-frame chunk " + ", ".join(f"{k} {v}" for k, v in graph_res["syncs"].items())
          + " | 3g per frame " + "; ".join(
              f"{label} {graph_res[label]['host_launches'] / graph_res[label]['frames']:.2f} host launch calls, busy "
              f"{graph_res[label]['busy_share']:.4f}" + (f" (graph span {graph_res[label]['span_share']:.4f})"
                                                         if graph_res[label]["span_share"] else "")
              for label in PROFILED)
          + " | 3i inline frames/s in turns " + ", ".join(
              f"{label} " + "/".join(f"{v:.1f}" for v in inline_res["fps"][label]) for label in inline_res["fps"])
          + f" ({inline_res['solves']} inline solves), host syncs per 128-frame chunk "
          + ", ".join(f"{k} {v}" for k, v in inline_res["syncs"].items())
          + " | 3i phase 8's loop frames/s in turns " + ", ".join(
              f"{label} " + "/".join(f"{v:.1f}" for v in inline_res["loop8_fps"][label])
              for label in inline_res["loop8_fps"])
          + f", its solving frame {inline_res['solve_launch']['frame']} as a chunk of one "
          + "/".join(f"{v:.3f}" for v in inline_res["solve_launch"]["ms"]) + " ms (CUDA events)"
          + " | 3g HD frames/s in turns " + ", ".join(
              f"{label} " + "/".join(f"{v:.1f}" for v in hd["graph_3g"]["fps"][label]) for label in hd["graph_3g"]["fps"])
          + f" | HD via the CLI {hd['fps']} frames/s | 12b frames/s per rank: chunk graph "
          + "/".join(f"{v:.1f}" for v in multi["fps_12b"]["chunk graph"]) + ", the track-graph path "
          + "/".join(f"{v:.1f}" for v in multi["fps_12b"]["track graph"]) + ", the host-loop trigger "
          + "/".join(f"{v:.1f}" for v in multi["fps_12b"]["host-loop trigger"])
          + f", host syncs per {CHUNK}-frame chunk through the chunk graph per rank {multi['syncs_12b']}"
          + " | 12a frames/s in turns: " + ", ".join(
              f"{label} " + "/".join(f"{v:.1f}" for v in multi["paths_12a"]["fps"][label]) for label in DIST_PATHS)
          + ", per frame " + "; ".join(
              f"{label} {p['host_launches'] / p['frames']:.2f} host launch calls "
              f"({p['branch_launches'] or 0:.1f} per inserting frame's branch), busy {p['busy_share']:.4f}"
              + (f" (span of the launches and staged branches {p['span_share']:.4f})" if p["span_share"] else "")
              for label, p in multi["paths_12a"]["profiles"].items())
          + f", host syncs per {CHUNK}-frame chunk " + ", ".join(
              f"{label} {v['syncs']}" for label, v in multi["paths_12a"]["syncs"].items())
          + ", branch runs in the chunk graph per run " + ", ".join(
              f"{name} {multi['paths_12a']['runs'][0][f'{name}_runs']}" for _, name in BRANCH_KINDS)
          + f", chunk launches {multi['paths_12a']['runs'][0]['chunk_launches']}, host exits "
          + f"{multi['paths_12a']['runs'][0]['host_exits']}, all_reduce launches "
          + f"{multi['paths_12a']['runs'][0]['all_reduce_launches']}"
          + f" | 12a triggers that solved, trigger program / host-loop trigger: host syncs "
          + f"{multi['trigger_12a']['chunk graph']['syncs']} / {multi['trigger_12a']['host-loop trigger']['syncs']}, ms "
          + ", ".join(f"{x:.2f}" for x in multi["trigger_12a"]["chunk graph"]["ms"]) + " / "
          + ", ".join(f"{x:.2f}" for x in multi["trigger_12a"]["host-loop trigger"]["ms"])
          + f"; 12e on 1 NCCL rank {multi['canvas_nccl']['solves']} solves with the captured canvas delta"
          + f" | 12b triggers that solved, rank 0, trigger program / host-loop trigger: host syncs "
          + f"{multi['peer_12b']['trigger'][0]['chunk graph']['syncs']} / "
          + f"{multi['peer_12b']['trigger'][0]['host-loop trigger']['syncs']}"
          + f" | all_reduce us per call at the (K, 3) vector, eager / captured: 1 NCCL rank "
          + f"{multi['probe_12a'][ar_label]['eager_us']:.2f} / {multi['probe_12a'][ar_label]['captured_us']:.2f} "
          + f"(NCCL {multi['probe_12a'][ar_label]['library_us']:.2f}), 2 ranks sharing the card "
          + f"{ar_main['eager_us']:.2f} / {ar_main['captured_us']:.2f} (gloo {ar_main['library_us']:.2f})"
          + f" | 12d GN-CG ms per solve, eager / graph / one launch: K=272 {multi['flagship_cg_ms']:.2f} / "
          + f"{multi['flagship_cg_graph_ms']:.2f} / {multi['flagship_cg_launch_ms']:.2f}, K=1024 "
          + f"{multi['hd_cg_ms']:.2f} / {multi['hd_cg_graph_ms']:.2f} / {multi['hd_cg_launch_ms']:.2f}; "
          + "per CG iteration " + " / ".join(f"{multi['cg_12d']['per_iteration_ms'][x]:.4f}" for x in CG_SOLVERS)
          + " ms; host syncs per solve " + " / ".join(str(multi["cg_12d"]["syncs"][x]) for x in CG_SOLVERS)
          + f" | 13a bench {measuring['fps']} frames/s, 13b bench --batch {measuring['batch_fps']} lane-frames/s"
          + f" | cond_graph outer body {1e3 * cres['ms'] / CHUNK:.2f} us per frame ({cres['nodes']} nodes per "
          + f"iteration), empty WHILE iteration {cres['empty_us'][False]:.2f} us, with the stored branch taken "
          + f"{cres['empty_us'][True]:.2f} us, at {N_BATCH} lanes {cres['empty8_us']:.2f} us"
          + " | host syncs per flagship trigger that solved: solve graph "
          + f"{graph_res['trigger']['chunk graph']['syncs']}, host loop {graph_res['trigger']['host-loop trigger']['syncs']}"
          + f" | ms per dense solve, K=272 (the flagship's final graph): solve graph {multi['flagship_graph_ms']:.2f}, "
          + f"host loop {multi['flagship_dense_ms']:.2f}; K=1024 chain: solve graph "
          + f"{multi['hd_graph_ms']:.2f}, host loop {multi['hd_dense_ms']:.2f}"
          + f" | stepbench p50 / p99 deferred {steps['deferred_p50_ms']:.1f} / {steps['deferred_p99_ms']:.1f} ms, with "
          + f"the host-loop trigger {steps['host_loop_p50_ms']:.1f} / {steps['host_loop_p99_ms']:.1f} ms, inline "
          + f"through the chunk graph {steps['inline_p50_ms']:.1f} / {steps['inline_p99_ms']:.1f} ms, through the track-graph "
          + f"path {steps['inline_track_p50_ms']:.1f} / {steps['inline_track_p99_ms']:.1f} ms"
          + f" | {batch_summary(batch_res)}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(f"kernels on {card}:")
    print(json.dumps({"kernels": [
        {
            "name": "peak_stats",
            "route": "cuda",
            "source": "nislam_torch/csrc/peak_stats.cu",
            "replaces": "nislam_tpu/ops/pallas_kernels.py:49 and nislam_tpu/ops/pallas_kernels.py:88",
            "launches": (launches + inline_res["counts"]["peak_stats"] + hd["launches"] + option_launches
                         + batch_launches + multi["launches"] + measuring["launches"]),
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
            # Its launches are those of phases 3, 8, 12a, 12b, 12e and 13; its
            # times at the flagship's dense LM H blocks, every shape's under
            # "shapes".
            "name": "scatter_add",
            "route": "cuda",
            "source": "nislam_torch/csrc/scatter_add.cu",
            "replaces": "no Pallas kernel: the XLA scatter-adds at nislam_tpu/core/pose_graph.py:157 and "
                        "nislam_tpu/parallel/solver.py:52",
            "launches": (sa_launches + inline_res["counts"]["scatter_add"] + option_sa_launches + multi["sa_launches"]
                         + measuring["sa_launches"]),
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
        {
            # The port's own kernels: the chunk graph's outer body (the
            # copy ahead of the WHILE, the flags setting the SWITCH handle
            # and the run counts (in the batch's mode, k of the lanes that
            # insert by a ballot), each branch body's spectrum copy, the
            # advance writing the output row and the WHILE handle and
            # copying the next frame in), the counterpart of the lax.scan
            # and lax.cond of JAX's run_chunk.  Its launches are the
            # chunk-graph launches of phases 3, 3i, 8, 11, 12a, 12b and 12e; its times one
            # 128-frame flagship launch of the outer body alone (the nested
            # graphs empty, no branch taken), against the same work as a
            # host loop on the card; its bound the bytes that work needs.
            "name": "cond_graph",
            "route": "cuda",
            "source": "nislam_torch/csrc/cond_graph.cu",
            "replaces": "no Pallas kernel: the lax.scan and lax.cond of SlamEngine.run_chunk at "
                        "nislam_tpu/core/slam.py:235",
            "launches": (cg_launches + inline_res["counts"]["chunk_graph"] + option_graph["cond_graph"]
                         + batch_res["chunk_launches"] + dist_launches_12a + sum(multi["chunk_launches_12b"])
                         + sum(multi["chunk_launches_12e"])),
            "launches_by_path": {"3 flagship, deferred": cg_launches,
                                 "3i flagship, inline": inline_res["counts"]["chunk_graph"],
                                 "8 inline + online": option_graph["cond_graph"],
                                 "11 batch, one SWITCH over bodies keyed by k": batch_res["chunk_launches"],
                                 "12a distributed, 1 rank, four timed runs": dist_launches_12a,
                                 "12b distributed, per rank, four timed runs": multi["chunk_launches_12b"],
                                 "12e distributed + online canvas, per rank, four timed runs":
                                     multi["chunk_launches_12e"]},
            "batch_frames_by_k": batch_res["hist"],
            "inline_structure": inline_res["structure"],
            "max_abs_err": cres["max_abs_err"],
            "ms": cres["ms"],
            "plain_ms": cres["plain_ms"],
            "bound_ms": cres["bound_ms"],
            "bound_by": cres["bound_by"],
            "library_ms": None,
            "nodes_per_iteration": cres["nodes"],
            "structure_floor_ms": cres["floor_ms"],
            "empty_node_us": cres["probe"]["node_us"],
            "empty_while_iteration_us": cres["empty_us"][False],
            "empty_while_iteration_branch_taken_us": cres["empty_us"][True],
            "empty_while_iteration_8_lanes_us": cres["empty8_us"],
            "outer_body": cres["cases"],
            "probe": cres["probe"],
            "copy_share_of_bound": cres["copy_share"],
            "structure": cres["structure"],
            "early_exits": exits,
            "node_types": engine.chunk_graph.node_types,
            "frames_per_launch": CHUNK,
        },
        *({
            # The port's own kernels: the solve graph's trigger (each lane's
            # live pending count against 2, the LM control, the IF handle)
            # and lm_step (the damping schedule, the lane mask, the count,
            # the WHILE handle), the counterpart of the lax.cond of
            # maybe_optimize and the lax.while_loop's cond and carry of the
            # dense LM solve.  Their launches are those of phase 3's timed
            # run (inside solve-graph launches, counted from each launch's
            # read and equal to the kernels' own device counts); their times
            # one launch outside a graph at 1 lane, the 8-lane batch's under
            # "shapes"; no PyTorch call computes them.
            "name": name,
            "route": "cuda",
            "source": "nislam_torch/csrc/cond_graph.cu",
            "replaces": {"trigger": "no Pallas kernel: the lax.cond of maybe_optimize at "
                                    "nislam_tpu/core/slam.py:786 and, gated, the scan step's lax.cond over "
                                    "_flush_pending_loops at nislam_tpu/core/slam.py:1096",
                         "lm_step": "no Pallas kernel: the lax.while_loop's cond and mu update at "
                                    "nislam_tpu/core/pose_graph.py:251"}[name],
            "launches": solve_launches[name] + inline_res["counts"][name] + option_graph[name],
            "launches_by_path": {"3 flagship, deferred": solve_launches[name],
                                 "3i flagship, inline chunk graph": inline_res["counts"][name],
                                 "8 inline + online": option_graph[name]},
            "max_abs_err": solve_rows[name]["max_abs_err"],
            "ms": solve_rows[name]["ms"],
            "plain_ms": solve_rows[name]["plain_ms"],
            "bound_ms": solve_rows[name]["bound_ms"],
            "bound_by": solve_rows[name]["bound_by"],
            "library_ms": None,
            "launch_floor_ms": kres["floor_ms"],
            "shapes": solve_rows[name]["shapes"],
            "solve_graph": {"node_types": engine.solve_graph.node_types, "structure": engine.solve_graph.structure,
                            "empty_steps": solve_rows["trigger"]["empty_solve_graph"]},
        } for name in ("trigger", "lm_step")),
        {
            # The port's own kernel: the GN-CG trigger's loop control (a
            # start or a step of the Gauss-Newton and CG loops, setting a
            # WHILE handle inside the trigger program's graph), the
            # counterpart of the CG lax.while_loop's cond and the
            # Gauss-Newton fori_loop's counter.  Its launches are those of
            # 12a's timed runs through the trigger program (inside its graph
            # launches on the NCCL rank, counted from each launch's read and
            # equal to the kernel's own device count); its times one CG step
            # outside a graph; no PyTorch call computes it.
            "name": "cg_step",
            "route": "cuda",
            "source": "nislam_torch/csrc/cond_graph.cu",
            "replaces": "no Pallas kernel: the CG lax.while_loop's cond at nislam_tpu/parallel/solver.py:146 "
                        "and the Gauss-Newton fori_loop's counter at nislam_tpu/parallel/solver.py:152",
            "launches": cg_step_12a,
            "max_abs_err": cg_step_row["max_abs_err"],
            "ms": cg_step_row["ms"],
            "plain_ms": cg_step_row["plain_ms"],
            "bound_ms": cg_step_row["bound_ms"],
            "bound_by": cg_step_row["bound_by"],
            "library_ms": None,
            "launch_floor_ms": kres["floor_ms"],
            "cases": cg_step_row["cases"],
            "trigger_graph": {"node_types": multi["trigger_node_types"], "structure": multi["trigger_structure"]},
        },
        {
            # The port's own kernel: the peer-memory all-reduce, the
            # counterpart of XLA's all-reduce behind psum and the gathered
            # reductions of JAX's shard_maps.  Its launches are those of
            # each 12b/12e rank's timed runs (2 ranks sharing the card over
            # gloo), each equal to the kernel's own device count and to the
            # group's collectives; 12a's one NCCL rank launches none (the
            # sum over one rank is the payload in place).  Its times and
            # bound at the (K, 3) CG vector on 12b's rank 0, eager and
            # captured: two ranks sharing the card time-slice, so a wait
            # there is a context switch; the library call beside them is
            # gloo's all-reduce of the same card tensor on the same group.
            # Every payload and protocol edge under "shapes".
            "name": "all_reduce",
            "route": "cuda",
            "source": "nislam_torch/csrc/all_reduce.cu",
            "replaces": "no Pallas kernel: XLA's all-reduce under psum and the gathered reductions at "
                        "nislam_tpu/parallel/solver.py:106-154 and nislam_tpu/parallel/loop_search.py:130",
            "launches": ar_12a + sum(multi["peer_12b"]["launches"]),
            "launches_by_path": {"12a distributed, 1 NCCL rank, six timed runs (none: one rank)": ar_12a,
                                 "12b + 12e, per rank, timed runs": multi["peer_12b"]["launches"]},
            "max_abs_err": max(r["max_abs_err"] for rows in (multi["probe_12a"], *multi["peer_12b"]["probe"])
                               for r in rows.values()),
            "ms": 1e-3 * ar_main["eager_us"],
            "captured_ms": 1e-3 * ar_main["captured_us"],
            "plain_ms": 1e-3 * ar_main["plain_us"],
            "bound_ms": 1e-3 * ar_main["bound_us"],
            "bound_by": "bytes",
            "library_ms": 1e-3 * ar_main["library_us"],
            "shape": [ar_label, 2],
            "shapes": {"12a, 1 NCCL rank": multi["probe_12a"],
                       "12b, 2 ranks sharing the card (time-sliced: a wait is a context switch), rank 0":
                       multi["peer_12b"]["probe"][0]},
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
    if sys.argv[1:2] == ["--rank-loop"]:
        sys.exit(rank_loop_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--loop-rank"]:
        sys.exit(loop_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--hd-profiles"]:
        sys.exit(hd_profiles_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--nccl-ranks"]:
        sys.exit(nccl_ranks_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--nccl-rank"]:
        sys.exit(nccl_rank_main(sys.argv[2:]))
    sys.exit(main())
