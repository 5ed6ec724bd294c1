"""Per-stage timing of the tracked-frame pipeline.

    python -m nislam_torch.scripts.stagebench [--size 256|640|1200] [--r 30] [--device cuda]
    python -m nislam_torch.scripts.stagebench --solve [--r 10] [--device cuda]

Counterpart of ``scripts/stagebench.py``.  Times each stage of a tracked
frame alone, at the bench config's size (256: 256×256 with a 360×240
polar grid; 640: 480×640, 720×480; 1200: 1200×1600, 720×480):

- the undistort gather (``bilinear_sample`` over the camera's remap grid;
  the engine skips it for a camera without distortion);
- ``compute_intermedium`` (rfft2, the inverse transform of the magnitude,
  DC suppression, the polar gather, rfft2 of the polar map);
- the polar registration with its cached filter, rfft2 included;
- ``rotate_wrap_fft`` (three Fourier shears);
- the image registration with its cached filter, rfft2 included;
- ``peak_stats`` (the kernel on the card);
- ``keyframe_filter`` (rfft2 and the filter's two transforms);
- a tracked frame through the engine's track graph
  (``SlamEngine.track_graph``, bench config, the frame tracked against
  itself as the keyframe): the copies of its two features and one replay,
  which stand for the eager stages from the polar registration to the
  image registration and the keyframe decision and output around them;
- the same frame through the engine's frame graph
  (``SlamEngine.frame_graph``): a frame that inserts nothing (three
  feature copies and the track graph's replay), and a frame that inserts
  and stores a keyframe (an engine whose ``max_distance`` is −1, so that
  every tracked frame is one; the replays of the track graph and of the
  keyframe branch's graph, with the bank insert, the edge and the loop
  search over the candidates).  Device µs over back-to-back calls that
  leave out the flag read (a host sync, which back-to-back calls cannot
  hold); µs with the host over whole ``FrameGraph.run`` calls, the flag
  read included;
- the batch engine's frame at 8 lanes (``BatchSlamEngine.frame_graph``,
  every lane the same frame, banks of 32 slots): the copies of the three
  (8, ...) features and the batched track graph's replay (with the host,
  the (8, 2) flag read too); then, for k of its lanes storing a keyframe
  and searching (``BODY_KS``: 1, 2, 4 and 8; 1 and 2 on the CPU), one
  replay of body k (the keyframe branch over the k lanes, gathered on the
  device: ``core/slam.py``'s ``_branch_body_lanes``) against the replays
  of the k lanes' own branch graphs one after another (``_branch_body``
  on each lane's slice, the batch's branch before body k, captured here
  and in no engine), the inserting lanes set by hand in the track graph's
  output; and, on a card, body k inside the batch's chunk graph: one
  launch over ``CHUNK_FRAMES`` frames in which lanes 0 .. k − 1 store a
  keyframe on every frame (they alternate between the frame and the
  frame shifted by ``SHIFT_PX`` pixels, each a keyframe) and the other
  lanes none (the same frame again), per frame;
- a frame inside the engine's chunk graph (``SlamEngine.chunk_graph``,
  the frame graph's graphs nested in one graph of conditional nodes):
  the device µs of one launch over a chunk of ``CHUNK_FRAMES`` copies of
  the frame, divided by its frames, without keyframes and with a stored
  keyframe (and its loop search) on every frame; with the host, the
  chunk's one read after it too; and, with ``optimizer.inline``, one
  frame per launch that stores a keyframe (no loop search) whose inline
  trigger solves two pending matches written into the buffer by hand
  (a made-up state of three stored copies of one image: the solve of a
  real sequence is timed by ``chip_smoke.py`` phase 3i), the state's
  small leaves written back before each launch (the poses, counts,
  edges and pending buffer, which the solve changes: a few small
  copies);
- on a card, the chunk graph with empty bodies (``chunk_graph.
  EmptyBodies``: the track graph and each body one empty kernel),
  ``EMPTY_FRAMES`` WHILE iterations per launch with no feature copy, with
  no branch taken, with the stored one taken and at ``BATCH_LANES`` lanes
  (one SWITCH over ``BATCH_LANES`` bodies), and ``HD_FRAMES`` iterations
  that copy HD-size
  features in: what the outer body costs the card per frame by itself.
  On the CPU the graphs' bodies run eagerly, the chunk graph's outer body
  as its plain program.

JAX chains R calls in one ``lax.scan`` to cancel a dispatch floor of
about 1 ms.  Here each stage gets two times on the card: **device µs per
call**, R back-to-back calls between one pair of CUDA events
(``device_ms_per_launch``, over input copies that exceed the L2 cache),
and **µs per call with the host**, one event pair around one call
(``call_ms``).  The host is the port's bottleneck, so both count.  On the
CPU, one host-clock time per stage.  JAX's float-pair spectra (``r2c`` /
``c2r``) work around a TPU limit and have no counterpart: the port's
``estimate_trans`` takes complex tensors.

``--solve`` times the dense LM solve instead (:data:`SOLVE_CASES`: chain
graphs of the flagship's capacities, K = 272 / E = 1024, of
``config_HD.yaml``'s, K = 1024 / E = 4096, and the batch engine's 8
lanes of the first, as one batched LM): its LM iterations; the whole
solve through the host loop (``solve_pose_graph_lanes``, one read of
the loop condition per iteration), in ms; one iteration's device µs
stage by stage (the normal equations, pin + damping, ``cholesky_ex``,
the two triangular solves, the step with its new cost, ``lm_step``) and whole
(``lm_iterate`` + ``lm_step``, back to back); the host's µs to issue
one iteration (its launches, no read); and the solve as one launch of a
solve graph (``core/solve_graph.py``'s LM loop as a WHILE node: an IF
body of the setup, the loop and an empty finish), in ms.  A solve
repeated must give the same bits.  Then the GN-CG solve at one rank
(:data:`CG_CASES`, the first two graphs; a process group of one rank:
NCCL on the card, gloo on the CPU): the eager ``solve_pose_graph_cg``
and the graph program ``CGGraph`` (its local work as captured steps
between the collectives), ms per solve each and whether their bits are
equal; per CG iteration, the eager operations (the local JᵀJ·p, the
all-reduce, the update, over the program's buffers) and the graph's (a
replay, the all-reduce, a replay), device µs back to back and µs with
the host, the read of ‖r‖² included.

Up to the flagship's size (``BODY_MAX_PIXELS``) the default run adds the
distributed engine's keyframe branch per stored keyframe at one rank (a
process group of this one rank: NCCL on the card, gloo on the CPU): the
eager branch with the plug points (the track-graph path's: ~450
launches and the sharded search's host read of the ranks' frame ids)
against the staged branch (its captured steps, the record's all-reduce
between them), the same stored keyframe inserted again and searched, in
device µs and µs with the host.  Their device µs are the device's busy
time in a profiler trace of the calls (:func:`busy_call`): a collective
and a read cannot be queued back to back behind a spin.

Each stage's output in the timing run must equal that of one call made
before it (the graph's: the frame's responses and poses); the
``peak_stats`` stage's must also equal its plain version (peak and
argmax exactly, the sums within 1e-5 of Σ|x|).
Prints the card's name and power limit, one line per stage, then one
JSON line: ``{"stagebench": {stage: times}, "size", "polar", "device"}``.

``--device cuda`` (the default) fails when no card is present; it never
falls back to the CPU.  ``--device cpu`` runs the same stages on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from nislam_torch.scripts import bench
from nislam_torch.scripts.common import SIZES, asked_device, card_line, format_times, time_call

SUM_RTOL = 1e-5  # peak_stats sums against the plain version, relative to Σ|x|
BATCH_LANES = 8  # the batch rows' lanes (chip_smoke.py's phase 11)
BATCH_SLOTS = 32  # their banks' slots: the search registers max_candidates of them whatever the size
CHUNK_FRAMES = 16  # frames per launch of the chunk-graph rows
EMPTY_FRAMES = 128  # WHILE iterations per launch of the empty-body rows: a flagship chunk
HD_FRAMES = 64  # the HD empty-body row's frames: the CLI's HD chunk
HD_IMAGE, HD_POLAR = (1200, 1600), (360, 241)  # its features: img_u (f32), polar (c64); the spectrum (H, W/2+1)
BODY_KS = (1, 2, 4, 8)  # the batch's body rows: lanes that store and search (1 and 2 on the CPU)
SHIFT_PX = 100  # the batch chunk rows' shifted frame: 100/640 of the width, past max_distance (80 px)
BODY_MAX_PIXELS = 480 * 640  # the body rows run up to the flagship's size


def same(a, b) -> bool:
    """Equal, leaf by leaf (complex tensors as their float pairs)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def stages(h: int, w: int, rd: int, rc: int, device: torch.device, seed: int = 0) -> Dict[str, tuple]:
    """``{label: (fn, input[, call_fn])}``: each stage as a function of
    one input (the image, or the polar map for the polar registration);
    ``call_fn``, where given, is the call timed with the host."""
    from nislam_torch.core.camera import make_camera_ops
    from nislam_torch.core.config import CameraConfig, CFConfig
    from nislam_torch.core.slam import frontend, make_engine, state_leaves
    from nislam_torch.ops.fft import r2c, rfft2
    from nislam_torch.ops.peak_stats import peak_stats
    from nislam_torch.ops.registration import compute_intermedium, estimate_trans, keyframe_filter, make_cf_ops
    from nislam_torch.ops.warp import bilinear_sample, rotate_wrap_fft
    from nislam_torch.parallel import make_batch_engine

    cfg = CFConfig(width=w, height=h, rotation_divisor=rd, rotation_channel=rc)
    cam = make_camera_ops(CameraConfig(image_width=w, image_height=h, height=1.0,
                                       intrinsics=(float(w), w / 2.0, float(w), h / 2.0))).to(device)
    ops = make_cf_ops(cfg).to(device)
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(device)
    pshape, ishape = cfg.polar_shape, (h, w)
    pol = torch.from_numpy(rng.random(pshape, dtype=np.float32)).to(device)
    target_p, target_i = r2c(ops.target_rot_fft), r2c(ops.target_fft)
    zf_p, zf_i = rfft2(pol), rfft2(img)
    filt_p = keyframe_filter(zf_p, target_p, pshape, cfg)
    filt_i = keyframe_filter(zf_i, target_i, ishape, cfg)
    seven = torch.tensor(7.0, device=device)
    config = bench.make_config(h, w, rd, rc, 0, 8.0, keyframe_capacity=256, edge_capacity=256)
    engine = make_engine(config, device)
    state, _ = engine.step(engine.init_state(), img)  # the keyframe
    graph = engine.track_graph
    graph.load(state)
    _, fft, polar = frontend(img, cf_ops=engine.cf_ops, camera=engine.camera)
    frame = engine.frame_graph
    frame.load(state)
    # Every tracked frame a keyframe: tracked against itself, the frame is
    # the target again after each insert.
    kcfg = dataclasses.replace(config, keyframe_selection=dataclasses.replace(
        config.keyframe_selection, max_distance=-1.0))
    keng = make_engine(kcfg, device)
    kframe = keng.frame_graph
    kframe.load(keng.step(keng.init_state(), img)[0])

    # The batch engine's lanes, each the same frame; every tracked frame a
    # keyframe for the branch row, which replays lane 0's branch alone.
    bconfig = dataclasses.replace(config, map=dataclasses.replace(config.map, keyframe_capacity=BATCH_SLOTS))
    batch_engines = []
    for cfg_b in (bconfig, dataclasses.replace(bconfig, keyframe_selection=kcfg.keyframe_selection)):
        beng = make_batch_engine(cfg_b, BATCH_LANES, device)
        states, _ = beng.run_chunk(beng.init_states(), img.expand(BATCH_LANES, 1, h, w))
        beng.frame_graph.load(states)
        del states
        batch_engines.append(beng)
    bframe, kbframe = (e.frame_graph for e in batch_engines)
    # The lanes' first keyframes come from the batch's front end (8 frames
    # at once), whose spectra differ in the last bits from the one frame's
    # that the timed calls copy in: one insert first, so that every timed
    # call tracks against a keyframe made from the copied features.
    kbframe.run(img, fft, polar)

    # The chunk graph's rows: a chunk of CHUNK_FRAMES copies of the frame;
    # one run first captures and builds (the stored kind too, for keng).
    feats_n = tuple(t.expand(CHUNK_FRAMES, *t.shape).contiguous() for t in (img, fft, polar))
    chunks = {}
    for eng in (engine, keng):
        out = torch.empty((CHUNK_FRAMES, 17), device=device)
        eng.chunk_graph.run(feats_n, out, 0)
        chunks[eng] = (eng.chunk_graph, out)

    def chunk_rows(eng, read: bool):
        """One chunk (``read``: and its read) → its frames' outputs."""
        chunk, out = chunks[eng]
        if read:
            chunk.run(feats_n, out, 0)
        else:
            chunk.launch(feats_n, out, 0, CHUNK_FRAMES)
        return out[:, 4:13]

    # The inline solve: every tracked frame a stored keyframe, no loop
    # search (its gate stays open), two live pending matches written in
    # by hand (a made-up state, not one that a sequence reaches).  A solve
    # moves the poses, so each call starts from the same state: the
    # state's leaves under 1 MB (poses, counts, edges, pending buffer,
    # chain) are written back first; the larger ones (spectra) the frame
    # rewrites with the same values.
    icfg = dataclasses.replace(kcfg, optimizer=dataclasses.replace(kcfg.optimizer, inline=True),
                               loop_closure=dataclasses.replace(kcfg.loop_closure, to_find_loop=False))
    ieng = make_engine(icfg, device)
    istate = ieng.init_state()
    for _ in range(3):
        istate, _ = ieng.step(istate, img)
    ifg = ieng.frame_graph
    pending = ifg.state.pending
    pending.loop_slot[:2] = torch.tensor([0, 1], dtype=torch.int32, device=device)
    pending.cur_slot[:2] = ifg.state.track.last_slot
    pending.rel_pose[:2] = torch.tensor([[0.5, 0.0, 0.0], [0.5, 0.0, 0.0]], device=device)
    pending.count.fill_(2)
    small = [(x, x.clone()) for x in state_leaves(ifg.state) if x.numel() * x.element_size() < 1 << 20]
    ifeats = tuple(t[None].contiguous() for t in (img, fft, polar))
    iout = torch.empty((1, 17), device=device)

    def inline_row(read: bool):
        """The state written back, then one frame through the chunk graph
        (``read``: and its read) → its output from ``optimized`` on."""
        for buf, value in small:
            buf.copy_(value)
        chunk = ieng.chunk_graph
        if read:
            chunk.run(ifeats, iout, 0)
        else:
            chunk.launch(ifeats, iout, 0, 1)
        return iout[:, 3:13]

    inline_row(True)  # captures and builds

    def frame_graph_replays(fg, x, branch: bool):
        fg.fft.copy_(fft)
        outs = fg.track.run(x, polar)
        if branch:
            fg.branch_step(True).run()
        return outs.packed[4:13]

    def batch_replays(fg, x, read: bool):
        """The batch frame graph's feature copies (each lane this frame),
        the track graph's replay, with ``read`` the flag read → lane 0's
        output."""
        fg.fft.copy_(fft)
        outs = fg.track.run(x, polar)
        if read:
            fg.decide(outs.flags)
        return outs.packed[0, 4:13]

    return {
        "undistort gather": (lambda x: bilinear_sample(x, cam.map_x, cam.map_y), img),
        "compute_intermedium (3 xforms+polar)": (lambda x: compute_intermedium(x, ops), img),
        "polar registration (incl rfft2)":
            (lambda x: estimate_trans(zf_p, rfft2(x), target_p, pshape, cfg, filt=filt_p), pol),
        "rotate_wrap_fft (3 shears)": (lambda x: rotate_wrap_fft(x, seven), img),
        "image registration (incl rfft2)":
            (lambda x: estimate_trans(zf_i, rfft2(x), target_i, ishape, cfg, filt=filt_i), img),
        "peak_stats": (peak_stats, img),
        "keyframe_filter (2 xforms, img size)": (lambda x: keyframe_filter(rfft2(x), target_i, ishape, cfg), img),
        # The packed output's responses, raw odometry and pose.
        "tracked frame, graph replay": (lambda x: graph.run(x, polar).packed[4:13], img),
        "frame graph, no keyframe": (lambda x: frame_graph_replays(frame, x, False), img,
                                     lambda x: frame.run(x, fft, polar)[4:13]),
        "frame graph, keyframe stored + loop search": (lambda x: frame_graph_replays(kframe, x, True), img,
                                                       lambda x: kframe.run(x, fft, polar)[4:13]),
        f"batch x{BATCH_LANES} frame graph, no keyframe": (lambda x: batch_replays(bframe, x, False), img,
                                                           lambda x: batch_replays(bframe, x, True)),
        **(body_rows(*batch_engines, img, device) if h * w <= BODY_MAX_PIXELS else {}),
        f"chunk graph, no keyframe (per frame of {CHUNK_FRAMES})":
            (lambda x: chunk_rows(engine, False), img, lambda x: chunk_rows(engine, True), CHUNK_FRAMES),
        f"chunk graph, keyframe stored + loop search (per frame of {CHUNK_FRAMES})":
            (lambda x: chunk_rows(keng, False), img, lambda x: chunk_rows(keng, True), CHUNK_FRAMES),
        "chunk graph, keyframe stored + inline solve of two written-in matches (one frame per launch, the state "
        "written back first)":
            (lambda x: inline_row(False), img, lambda x: inline_row(True)),
        **(empty_body_rows(device, img) if device.type == "cuda" else {}),
    }


def body_rows(tracking, beng, img: torch.Tensor, device: torch.device) -> Dict[str, tuple]:
    """The batch's keyframe branch over k lanes (``BODY_KS``) on ``beng``'s
    frame graph (every tracked frame a keyframe; its track graph has run),
    the chunk rows on an engine of ``tracking``'s config (the bench's
    keyframe selection):
    one replay of body k against the k lanes' own branch graphs replayed
    one after another, lanes 0 .. k − 1 marked as inserting and storing in
    the track graph's output; on a card, body k inside the batch's chunk
    graph (see the module's docstring).  Each returns the track graph's
    responses and poses of every lane, which the branches leave as they
    are (the chunk rows: the chunk's)."""
    import functools

    from nislam_torch.core.frame_graph import lane_view
    from nislam_torch.core.slam import _branch_body, frontend
    from nislam_torch.core.track_graph import CapturedStep
    from nislam_torch.parallel import make_batch_engine

    fg = beng.frame_graph
    kw = dict(config=beng.config, cf_ops=beng.cf_ops, camera=beng.camera)
    ins, outs = fg.track.inputs, fg.track.outputs
    lanes = torch.arange(BATCH_LANES, device=device)
    marks = {k: (lanes < k).to(torch.float32)[:, None].expand(BATCH_LANES, 2).contiguous() for k in BODY_KS}
    # The batch's branch before bodies keyed by k: one graph per lane, the
    # branch on the lane's slice of the buffers.
    lane_steps = [CapturedStep(device, functools.partial(
        _branch_body, lane_view(fg.state, b),
        SimpleNamespace(img_u=ins.img_u[b], polar=ins.polar[b], fft=fg.fft[b], tracked=outs.tracked[b],
                        packed=outs.packed[b]), True, **kw), fg._stream, fg._pool) for b in range(BATCH_LANES)]

    def body(k: int):
        outs.tracked[:, 1:3].copy_(marks[k])  # insert, will_store
        fg.body_step(k).run()
        return outs.packed[:, 4:13]

    def lane_branches(k: int):
        outs.tracked[:, 1:3].copy_(marks[k])
        for step in lane_steps[:k]:
            step.run()
        return outs.packed[:, 4:13]

    ks = BODY_KS if device.type == "cuda" else BODY_KS[:2]
    rows = {}
    for k in ks:
        rows[f"batch x{BATCH_LANES}, body {k}: {k} of {BATCH_LANES} lanes store + search, one replay"] = (
            lambda x, k=k: body(k), img)
        rows[f"batch x{BATCH_LANES}, {k} lane branch graphs (store + search) one after another"] = (
            lambda x, k=k: lane_branches(k), img)
    if device.type != "cuda":
        return rows
    # The chunk rows: lanes < k alternate the shifted frame (even frames)
    # and the frame (odd ones), a stored keyframe each, so that every
    # launch starts and ends with every lane's chain on the frame.
    ceng = make_batch_engine(tracking.config, BATCH_LANES, device)
    states, _ = ceng.run_chunk(ceng.init_states(), img.expand(BATCH_LANES, 1, *img.shape))
    ceng.frame_graph.load(states)
    del states
    a = frontend(img, cf_ops=ceng.cf_ops, camera=ceng.camera)
    b = frontend(torch.roll(img, SHIFT_PX, dims=-1), cf_ops=ceng.cf_ops, camera=ceng.camera)
    frame = torch.arange(CHUNK_FRAMES, device=device)[:, None]
    out = torch.empty((BATCH_LANES, CHUNK_FRAMES, 17), device=device)
    chunk = ceng.chunk_graph
    feats = {}
    for k in ks:
        shifted = (lanes[None, :] < k) & (frame % 2 == 0)  # (frames, lanes)
        feats[k] = tuple(torch.where(shifted.reshape(shifted.shape + (1,) * fa.dim()), fb, fa).contiguous()
                         for fa, fb in zip(a, b))
        chunk.run(feats[k], out, 0)  # captures body k and builds

    def chunk_row(k: int, read: bool):
        if read:
            chunk.run(feats[k], out, 0)
        else:
            chunk.launch(feats[k], out, 0, CHUNK_FRAMES)
        return out[:, :, 4:13]

    for k in ks:
        rows[f"batch x{BATCH_LANES} chunk graph, body {k} on every frame (per frame of {CHUNK_FRAMES})"] = (
            lambda x, k=k: chunk_row(k, False), img, lambda x, k=k: chunk_row(k, True), CHUNK_FRAMES)
    return rows


def empty_body_rows(device: torch.device, img: torch.Tensor) -> Dict[str, tuple]:
    """The chunk graph with empty bodies: no branch taken, the stored
    branch taken, no branch at ``BATCH_LANES`` lanes (the batch's one
    SWITCH over ``BATCH_LANES`` bodies), and no branch over
    ``HD_FRAMES`` frames of HD-size features (random; the advance copies
    each frame's ``img_u`` and ``polar`` in)."""
    from nislam_torch.core.chunk_graph import EmptyBodies

    gen = torch.Generator(device=device).manual_seed(0)
    hd = (torch.rand((HD_FRAMES, *HD_IMAGE), generator=gen, device=device),
          torch.view_as_complex(torch.rand((HD_FRAMES, HD_IMAGE[0], HD_IMAGE[1] // 2 + 1, 2), generator=gen,
                                           device=device)),
          torch.view_as_complex(torch.rand((HD_FRAMES, *HD_POLAR, 2), generator=gen, device=device)))
    cases = {"no branch taken": (EMPTY_FRAMES, {}), "stored branch taken": (EMPTY_FRAMES, {"taken": True}),
             f"one SWITCH over {BATCH_LANES} bodies ({BATCH_LANES} lanes), no branch taken":
                 (EMPTY_FRAMES, {"lanes": BATCH_LANES}),
             "HD segments copied, no branch taken": (HD_FRAMES, {"feats": hd})}
    rows = {}
    for label, (frames, kw) in cases.items():
        graph = EmptyBodies(device, frames, **kw)

        def launch(x, graph=graph):
            graph.launch()
            return graph.ctl[:4]

        rows[f"chunk graph, empty bodies, {label} (per frame of {frames})"] = (launch, img, None, frames)
    return rows


def copied(v):
    """``v``'s tensors copied: a stage may return a view of a buffer that
    its next call overwrites."""
    return tuple(copied(x) for x in v) if isinstance(v, (tuple, list)) else v.clone()


def check_peak_stats(got, x: torch.Tensor) -> bool:
    """The kernel's statistics against the plain version's on ``x``."""
    from nislam_torch.ops.peak_stats import peak_stats_reference

    want = peak_stats_reference(x)
    tol = SUM_RTOL * float(x.abs().sum())
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and all(abs(float(g - v)) <= tol for g, v in zip(got[2:], want[2:])))


# The distributed branch rows' calls per timing, at most: a profiler
# trace of the eager branch holds ~450 launches per call.
DIST_REPS = 10
# The packed output's loop fields (loop_found, loop_slot, loop_eligible):
# what the distributed branch rows compare from call to call.
LOOP_FIELDS = [2, 15, 16]


def dist_branch_stages(h: int, w: int, rd: int, rc: int, group, device: torch.device, seed: int = 0
                       ) -> Dict[str, tuple]:
    """The distributed engine's keyframe branch per stored keyframe, at one
    rank of ``group``: the bench config with every tracked frame a
    keyframe, the frame tracked against itself after one step that
    captures; the eager branch (``_eager_branch`` with the plug points, on
    a view of the frame graph's state: the track-graph path's) against the
    captured branch: on a card one captured step with the record's
    all-reduce inside (``CollectiveFrameGraph.branch_step(True)``, what the
    chunk graph's SWITCH nests), on the CPU the staged branch
    (``HostBranchFrameGraph.program(True)``: its steps with the record's
    all-reduce between them).  Each inserts the
    same keyframe again, the bank's ring reused, and searches it, and
    returns the packed output's loop fields.  Timed by :func:`busy_call`:
    both make a collective, and the eager one reads the host."""
    from nislam_torch.core.frame_graph import _parts
    from nislam_torch.core.slam import _eager_branch
    from nislam_torch.parallel import make_distributed_engine

    config = bench.make_config(h, w, rd, rc, 0, 8.0, keyframe_capacity=256, edge_capacity=256)
    config = dataclasses.replace(config, keyframe_selection=dataclasses.replace(
        config.keyframe_selection, max_distance=-1.0))
    engine = make_distributed_engine(config, group)
    img = torch.from_numpy(np.random.default_rng(seed).random((h, w), dtype=np.float32)).to(device)
    state, _ = engine.step(engine.init_state(), img)
    engine.step(state, img)  # a stored keyframe: its branch's steps made and captured
    fg = engine.frame_graph
    prog, outs = fg.program(True) if fg.host_branch else fg.branch_step(True), fg.track.outputs
    feats = (fg.track.inputs.img_u, fg.fft, fg.track.inputs.polar)
    kw = engine._steps()

    def eager(_):
        view = type(fg.state)(**_parts(fg.state))
        return _eager_branch(view, feats, outs.tracked, True, fg.state.track.next_frame_id - 1, **kw)[LOOP_FIELDS]

    def staged(_):
        prog.run()
        return outs.packed[LOOP_FIELDS]

    return {f"distributed branch, stored keyframe + sharded search ({group.size} rank), eager": (eager, img),
            f"distributed branch, stored keyframe + sharded search ({group.size} rank), captured steps":
                (staged, img)}


@contextlib.contextmanager
def one_rank(device: torch.device):
    """A process group of this one rank (NCCL on a card, gloo on the CPU)
    and its ``bank`` group; destroyed after the block."""
    import socket

    import torch.distributed as dist

    from nislam_torch.parallel.mesh import init_distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    group = init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, "nccl" if device.type == "cuda" else "gloo", device)
    try:
        yield group
    finally:
        dist.destroy_process_group()


def run(size: int, reps: int, device: torch.device) -> dict:
    """Every stage → ``{label: {times..., "equal": bool, "launches":
    peak_stats kernel launches inside its timing}}``; up to the flagship's
    size, the distributed branch rows at one rank too."""
    h, w, rd, rc = SIZES[size]
    if h * w > BODY_MAX_PIXELS:
        return time_stages(stages(h, w, rd, rc, device), reps, device)
    with one_rank(device) as group:
        rows = time_stages(stages(h, w, rd, rc, device), reps, device)
        return {**rows, **time_stages(dist_branch_stages(h, w, rd, rc, group, device), min(reps, DIST_REPS), device,
                                      busy_call)}


def busy_call(fn: Callable, inputs, reps: int, device: torch.device, call_fn: Optional[Callable] = None
              ) -> Dict[str, float]:
    """:func:`time_call`'s figures for a call that makes a collective or a
    host read, which back-to-back calls cannot queue behind a spin: on the
    card ``device_us``, the device's busy time (the union of its kernel,
    copy and memset intervals) in one profiler trace of ``reps`` calls of
    ``fn`` after three, per call, and ``call_us`` as :func:`time_call`'s;
    on the CPU :func:`time_call`'s."""
    if device.type != "cuda":
        return time_call(fn, inputs, reps, device, call_fn)
    import os
    import tempfile

    from nislam_torch.utils.profiling import call_ms, device_activity, trace

    for i in range(3):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="stagebench_") as d:
        with trace(d):
            for i in range(reps):
                fn(inputs[i % len(inputs)])
            torch.cuda.synchronize()
        busy_ms = device_activity(os.path.join(d, "trace.json"))["busy_ms"]
    call_fn = fn if call_fn is None else call_fn
    return {"device_us": 1e3 * busy_ms / reps, "call_us": 1e3 * call_ms(lambda: call_fn(inputs[0]), reps)}


def time_stages(table: Dict[str, tuple], reps: int, device: torch.device, timer: Callable = time_call) -> dict:
    """:func:`run`'s timings of ``table`` (:func:`stages`' form) by
    ``timer`` (:func:`time_call`'s signature)."""
    from nislam_torch.ops.peak_stats import peak_stats
    from nislam_torch.utils.profiling import cold_copies

    rows = {}
    for label, (fn, x, *rest) in table.items():
        call_fn = rest[0] if rest and rest[0] is not None else fn
        frames = rest[1] if len(rest) > 1 else 1  # a chunk row's times are per frame
        first = copied(fn(x))
        last = [None]

        def keep(v, fn=fn):
            last[0] = fn(v)

        def keep_call(v, fn=call_fn):
            last[0] = fn(v)

        inputs = cold_copies(x, reps) if device.type == "cuda" else [x]
        launches = peak_stats.launches
        times = {k: v / frames for k, v in timer(keep, inputs, reps, device, keep_call).items()}
        launches = peak_stats.launches - launches
        equal = same(first, last[0])
        if label == "peak_stats":
            equal = equal and check_peak_stats(first, x)
        rows[label] = {**times, "equal": equal, "launches": launches}
    return rows


# --solve: {label: (keyframes, edge capacity, lanes)}
SOLVE_CASES = {"dense LM, K=272 E=1024": (272, 1024, 1), "dense LM, K=1024 E=4096": (1024, 4096, 1),
               f"batched LM, {BATCH_LANES} lanes, K=272 E=1024": (272, 1024, BATCH_LANES)}


def solve_problem(k: int, e: int, lanes: int, device: torch.device):
    """``lanes`` chain graphs (``chain_problem``, seeds 0, 1, ...) stacked."""
    from nislam_torch.core.pose_graph import PoseGraphProblem
    from nislam_torch.utils.scaling import chain_problem

    probs = [chain_problem(k, e, seed=r, device=device) for r in range(lanes)]
    return PoseGraphProblem(*(torch.stack(leaf) for leaf in zip(*probs)))


def solve_row(prob, reps: int, device: torch.device) -> dict:
    """One :data:`SOLVE_CASES` row over the stacked ``prob`` (see the
    module's docstring)."""
    import time

    import nislam_torch.core.pose_graph as pg
    from nislam_torch.utils.profiling import device_fence

    cfg = pg.SolverConfig()
    lanes = prob.poses.shape[0]
    first = pg.solve_pose_graph_lanes(prob, cfg)
    device_fence(first[2])
    t0 = time.perf_counter()
    again = pg.solve_pose_graph_lanes(prob, cfg)
    device_fence(again[2])
    solve_ms = 1e3 * (time.perf_counter() - t0)
    trace = []
    pg.solve_pose_graph_lanes(prob, cfg, trace=trace)
    carry = pg.lm_setup(prob, cfg)
    control = pg.lm_control(lanes, device)
    pg.lm_begin(control, torch.ones_like(control.active), cfg)
    h, g, _ = pg._lm_assemble(carry)
    hd, gp = pg._lm_damp(carry, control, h, g)
    chol, status = pg._lm_factor(hd)
    delta = pg._lm_solve(chol, gp)
    x0, cost0 = carry.x.clone(), carry.cost.clone()
    scratch = pg.lm_control(lanes, device)

    def take(_):
        carry.x.copy_(x0)
        carry.cost.copy_(cost0)
        pg._lm_take(carry, control, delta, status)

    def iteration(_):
        pg.lm_iterate(carry, control)
        pg.lm_step(scratch, cfg)

    stages = {"assembly": lambda _: pg._lm_assemble(carry), "pin + damping": lambda _: pg._lm_damp(carry, control, h, g),
              "cholesky_ex": lambda _: pg._lm_factor(hd), "triangular solves": lambda _: pg._lm_solve(chol, gp),
              "step + new cost": take, "lm_step": lambda _: pg.lm_step(scratch, cfg), "iteration": iteration}
    row = {"iterations": len(trace), "solve_ms": solve_ms,
           "equal": all(bool(torch.equal(a, b)) for a, b in zip(first, again))}
    for name, fn in stages.items():
        row[name] = time_call(fn, [None], reps, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            iteration(None)
        row["host_us_per_iteration"] = 1e6 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        row["graph_ms"] = solve_graph_ms(prob, cfg, device)
    return row


def solve_graph_ms(prob, cfg, device: torch.device) -> float:
    """Ms per solve of ``prob`` as one solve-graph launch (the setup's and
    the loop's captured steps under the IF, the finish empty), over a
    fake frame graph whose one-slot pending buffers make every lane run;
    median of a few launches after the one that captures."""
    import statistics

    from nislam_torch.core.solve_graph import SolveGraph

    lanes = prob.poses.shape[0]
    fake = SimpleNamespace(
        bank=SimpleNamespace(count=torch.zeros(lanes, dtype=torch.int32, device=device)),
        pending=SimpleNamespace(count=torch.full((lanes,), 2, dtype=torch.int32, device=device),
                                loop_slot=torch.zeros((lanes, 2), dtype=torch.int32, device=device)))
    frame = SimpleNamespace(device=device, state=fake, _stream=torch.cuda.Stream(device))
    graph = SolveGraph(frame, cfg, lambda state, run: prob, lambda state, run, result: None, scale_free=False)
    times = []
    for _ in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    if not graph.built:
        raise RuntimeError("the solve graph was not built")
    return statistics.median(times[2:])


# --solve's GN-CG rows at one rank: {label: (keyframes, edge capacity)}
CG_CASES = {"GN-CG, K=272 E=1024": (272, 1024), "GN-CG, K=1024 E=4096": (1024, 4096)}


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cg_row(prob, group, reps: int, device: torch.device) -> dict:
    """One :data:`CG_CASES` row (see the module's docstring)."""
    import statistics
    import time

    from nislam_torch.parallel import solver as sv

    graph = sv.CGGraph(group)

    def solve_ms(fn):
        out = fn()
        times = []
        for _ in range(3):
            _fence(device)
            t0 = time.perf_counter()
            out = fn()
            _fence(device)
            times.append(1e3 * (time.perf_counter() - t0))
        return out, statistics.median(times)

    (eager, eager_cost), eager_ms = solve_ms(lambda: sv.solve_pose_graph_cg(prob, group, graph.cfg))
    (poses, cost), graph_ms = solve_ms(lambda: graph(prob))
    prog = graph.program(prob)
    b, steps, damping = prog.b, prog.steps, graph.cfg.damping

    def eager_iteration(_):
        sv._hvp(b)
        group.all_reduce(b.hp)
        sv._update(b, damping)

    def graph_iteration(_):
        steps["hvp"].run()
        group.all_reduce(b.hp)
        steps["update"].run()

    def with_read(iteration):
        return lambda x: (iteration(x), float(b.r2))

    bits = lambda x: x.view(torch.int32)
    return {"cg_iterations": graph.cg_iterations, "eager_ms": eager_ms, "graph_ms": graph_ms,
            "equal": bool(torch.equal(bits(poses), bits(eager)) and torch.equal(bits(cost), bits(eager_cost))),
            "eager_iteration": time_call(eager_iteration, [None], reps, device, with_read(eager_iteration)),
            "graph_iteration": time_call(graph_iteration, [None], reps, device, with_read(graph_iteration))}


def cg_rows(reps: int, device: torch.device) -> Dict[str, dict]:
    """The GN-CG rows, over a process group of this one rank."""
    from nislam_torch.utils.scaling import chain_problem

    with one_rank(device) as group:
        return {label: cg_row(chain_problem(k, e, device=group.device), group, reps, group.device)
                for label, (k, e) in CG_CASES.items()}


def cg_line(label: str, row: dict) -> str:
    unit = "device_us" if "device_us" in row["eager_iteration"] else "cpu_us"
    host = lambda t: f", {t['call_us']:.1f} us with the host and the read" if "call_us" in t else ""
    return (f"{label} (1 rank): {row['cg_iterations']} CG iterations per solve, ms per solve eager "
            f"{row['eager_ms']:.3f}, graph {row['graph_ms']:.3f} | per CG iteration eager "
            f"{row['eager_iteration'][unit]:.1f} us {unit}{host(row['eager_iteration'])}; graph "
            f"{row['graph_iteration'][unit]:.1f} us {unit}{host(row['graph_iteration'])} | "
            f"{'equal' if row['equal'] else 'DIFFERS'}")


# --solve's distributed trigger rows at one rank: {label: (keyframes, edge
# capacity, live keyframes, pending loop matches)}
TRIGGER_CASES = {"distributed trigger, K=272 E=1024": (272, 1024, 74, 17)}


def trigger_config(k: int, e: int):
    """A distributed engine's configuration at the map's capacities; the
    images small (the trigger's work does not depend on them)."""
    from nislam_torch.core import config as c

    h, w = 64, 96
    return c.SlamConfig(
        cf=c.CFConfig(width=w, height=h, rotation_divisor=90, rotation_channel=48),
        map=c.MapConfig(grid_scale=0.15, keyframe_capacity=k, edge_capacity=e),
        camera=c.CameraConfig(image_width=w, image_height=h, height=1.0, intrinsics=(100.0, w / 2.0, 100.0, h / 2.0)))


def trigger_state(engine, live: int, matches: int, seed: int = 0):
    """A made-up state of ``engine``: ``live`` keyframes on a ring at noisy
    poses, an odometry edge between neighbours, and ``matches`` pending
    loop matches across the ring (every one live, so a trigger solves)."""
    from nislam_torch.core.map_store import EDGE_KCC
    from nislam_torch.core.se2 import relative_pose

    state, cam = engine.init_state(), engine.camera
    dev = state.bank.poses.device
    rng = np.random.default_rng(seed)
    host = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    t = np.arange(live) * 2 * np.pi / live
    truth = host(np.stack([3 * np.cos(t), 3 * np.sin(t), np.mod(t + np.pi / 2 + np.pi, 2 * np.pi) - np.pi], 1))
    noise = rng.normal(0, 1, (live, 3)) * [0.05, 0.05, 0.02]
    noise[0] = 0
    bank, edges, pending, track = state.bank, state.edges, state.pending, state.track
    bank.poses[:live] = truth + host(noise)
    bank.count.fill_(live)
    f, to = torch.arange(live - 1, device=dev), torch.arange(1, live, device=dev)
    m = live - 1
    edges.from_slot[:m], edges.to_slot[:m] = f.int(), to.int()
    edges.T[:m] = cam.robot_to_camera(relative_pose(truth[f], truth[to])) + host(rng.normal(0, 0.002, (m, 3)))
    edges.info[:m] = torch.diag(host([400.0, 400.0, 2500.0]))
    edges.types[:m] = EDGE_KCC
    edges.alive[:m] = True
    edges.count.fill_(m)
    a = rng.choice(live - 12, matches, replace=False)
    b = a + rng.integers(8, 12, matches)
    for i, (x, y) in enumerate(zip(a, b)):
        rel = relative_pose(truth[x], truth[y]) + host(rng.normal(0, 0.003, 3))
        pending.loop_slot[i], pending.cur_slot[i] = int(x), int(y)
        pending.rel_pose[i] = cam.camera_to_image_plane(cam.robot_to_camera(rel))
    pending.count.fill_(matches)
    track.last_slot.fill_(live - 1)
    track.initialized.fill_(True)
    return state


def trigger_row(case: tuple, group, reps: int, device: torch.device, log=None) -> dict:
    """One :data:`TRIGGER_CASES` row: the same solving trigger through the
    host loop (``optimize_host_loop``: reads, the edges one by one,
    ``CGGraph``, the count-read recompute), through the trigger program
    with the host making the collectives (its steps captured between them,
    one read of the run flag and one of the CG condition per check: gloo's
    route on CPU tensors, here over this group with ``host_route`` set) and,
    on a group whose all-reduce a graph holds (a card, any rank count), as
    one launch: ms per solving
    trigger (host clock around a synchronized call, median of ``reps``
    after one warm-up; the state copied in before each, outside the time),
    host syncs per trigger (sync debug mode, on a card), CG iterations, and
    on a card the one launch's device ms (CUDA events) per CG iteration;
    every route's state leaves against the host loop's.  ``log(route,
    row)``, when given, is called as each route's row is done."""
    import statistics
    import time
    import warnings

    from nislam_torch.core.slam import map_state, optimize_host_loop, state_leaves
    from nislam_torch.parallel import make_distributed_engine

    k, e, live, matches = case
    config = trigger_config(k, e)
    groups = {"host loop": group, "host collectives": dataclasses.replace(group, host_route=True)}
    if group.capturable:
        groups["one launch"] = group
    engines = {label: make_distributed_engine(config, g) for label, g in groups.items()}
    pristine = trigger_state(engines["host loop"], live, matches)
    clone = lambda: map_state(pristine, lambda x: x.clone())

    def prepared(label):
        eng = engines[label]
        if label == "host loop":
            return lambda s=clone(): optimize_host_loop(eng, s)
        graph = eng.frame_graph
        graph.load(pristine)
        lent = graph.lend(pristine)
        return lambda: eng.optimize(lent)

    def syncs(fn) -> Optional[int]:
        if device.type != "cuda":
            return None
        torch.cuda.synchronize(device)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) and "prototype" not in str(w.message) for w in seen)

    bits = lambda x: x.reshape(-1).view(torch.uint8)
    rows, want = {}, None
    for label, eng in engines.items():
        prepared(label)()  # captures, the graph built
        times, spans, out = [], [], None
        for _ in range(max(3, reps)):
            fn = prepared(label)
            _fence(device)
            if device.type == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            out = fn()
            if device.type == "cuda":
                b.record()
            _fence(device)
            times.append(1e3 * (time.perf_counter() - t0))
            if device.type == "cuda":
                spans.append(a.elapsed_time(b))
        leaves = [bits(x).clone() for x in state_leaves(out[0])]
        want = leaves if want is None else want
        row = {"ms": statistics.median(times), "ran": bool(out[1]), "syncs": syncs(prepared(label)),
               "equal": all(torch.equal(x, y) for x, y in zip(leaves, want, strict=True))}
        program = None if label == "host loop" else eng.trigger_program
        row["cg_iterations"] = (eng.solver_fn if program is None else program).cg_iterations
        if spans:
            row["event_ms"] = statistics.median(spans)
        if label == "one launch" and spans:
            row["device_us_per_cg_iteration"] = 1e3 * row["event_ms"] / max(1, row["cg_iterations"])
        rows[label] = row
        if log is not None:
            log(label, row)
    return rows


def trigger_rows(reps: int, device: torch.device) -> Dict[str, dict]:
    """The distributed trigger's rows, over a process group of this one rank."""
    with one_rank(device) as group:
        return {label: trigger_row(case, group, reps, group.device) for label, case in TRIGGER_CASES.items()}


def trigger_line(label: str, rows: dict) -> str:
    def one(route, r):
        extra = f", {r['device_us_per_cg_iteration']:.1f} us of the launch per CG iteration (events)" \
            if "device_us_per_cg_iteration" in r else ""
        sync = "not measured" if r["syncs"] is None else r["syncs"]
        return (f"{route} {r['ms']:.3f} ms per solving trigger, {sync} host syncs, {r['cg_iterations']} CG "
                f"iterations{extra}, {'equal' if r['equal'] and r['ran'] else 'DIFFERS'}")
    return f"{label}: " + "; ".join(one(route, r) for route, r in rows.items())


def solve_rows(reps: int, device: torch.device) -> Dict[str, dict]:
    return {label: solve_row(solve_problem(k, e, lanes, device), reps, device)
            for label, (k, e, lanes) in SOLVE_CASES.items()}


def solve_line(label: str, row: dict) -> str:
    unit = "device_us" if "device_us" in row["iteration"] else "cpu_us"
    stages = ", ".join(f"{name} {row[name][unit]:.1f}" for name in
                       ("assembly", "pin + damping", "cholesky_ex", "triangular solves", "step + new cost", "lm_step"))
    host = f", host {row['host_us_per_iteration']:.1f} us to issue it" if "host_us_per_iteration" in row else ""
    graph = f" | as one solve-graph launch {row['graph_ms']:.3f} ms" if "graph_ms" in row else ""
    return (f"{label}: {row['iterations']} LM iterations, {row['solve_ms']:.3f} ms per solve through the host loop"
            f"{graph} | per iteration {row['iteration'][unit]:.1f} us {unit} ({stages}){host} | "
            f"{'equal' if row['equal'] else 'DIFFERS'}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256, choices=sorted(SIZES))
    ap.add_argument("--r", type=int, default=30, help="calls per timing")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    ap.add_argument("--solve", action="store_true", help="time the dense LM solve instead")
    args = ap.parse_args(argv)
    device = asked_device(args.device, "stagebench")
    if args.r < 1:
        ap.error("--r must be positive")
    if args.solve:
        card = card_line(device)
        print(f"device: {card}  dense LM solves", flush=True)
        rows = solve_rows(args.r, device)
        for label, row in rows.items():
            print(solve_line(label, row), flush=True)
        cg = cg_rows(args.r, device)
        for label, row in cg.items():
            print(cg_line(label, row), flush=True)
        trig = trigger_rows(args.r, device)
        for label, row in trig.items():
            print(trigger_line(f"{label} (1 rank)", row), flush=True)
        print(json.dumps({"stagebench_solve": rows, "stagebench_solve_cg": cg, "stagebench_solve_trigger": trig,
                          "device": card}))
        routes = [r for row in trig.values() for r in row.values()]
        return 0 if all(r["equal"] for r in [*rows.values(), *cg.values(), *routes]) and all(
            r["ran"] for r in routes) else 1
    h, w, rd, rc = SIZES[args.size]
    card = card_line(device)
    print(f"device: {card}  size {h}x{w} polar {rd}x{rc}", flush=True)
    rows = run(args.size, args.r, device)
    for label, row in rows.items():
        print(f"{label:44s} {format_times(row)}  {'equal' if row['equal'] else 'DIFFERS'}", flush=True)
    print(json.dumps({"stagebench": rows, "size": f"{h}x{w}", "polar": f"{rd}x{rc}", "device": card}))
    return 0 if all(r["equal"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
