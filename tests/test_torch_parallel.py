"""The multi-rank layer against ``nislam_tpu.parallel``, on the CPU.

Ranks are subprocesses that run this file as a worker (``__main__``
below): gloo over ``tcp://127.0.0.1:<free port>``, CPU tensors, one thread
each, no JAX.  Each world size is ONE launch that runs every check for
that size and writes each rank's results to an ``.npz``; each launch has
its own timeout, so a hang fails its tests without eating the suite's
clock.  JAX runs in the pytest process on the conftest's virtual devices
(``make_mesh({...: n}, devices=jax.devices()[:n])``), in threads, and the
ranks start only once JAX's references are done: the module runs on one
test worker, and at any time either JAX compiles or the ranks run, so
that the suite's other workers keep their cores.  Inputs are made once
from seeds with numpy and shared as files.

Held against JAX, world sizes 2 and 4 (the ``checks`` launches):

- ``solve_pose_graph_cg`` on a chain graph with dead slots: every rank the
  same; within 1e-4 of JAX's GN-CG and 2e-3 of dense LM; slot 0 and dead
  slots untouched; the same through ``CGGraph`` (the distributed engine's
  solver: the local work as captured steps between the collectives, their
  plain program here), bit for bit with the eager solve on every rank,
  poses, cost and all-reduces;
- ``find_loop_closure_sharded`` on a bank from a revisiting run: found,
  slot and eligible count equal, pose within 1e-4, response at rtol 5e-4
  (two f32 FFT chains, ROADMAP Queue 3), and equal to the single search;
  and the truncation case of ``tests/test_parallel.py`` (a per-rank cap of
  2 keeps the candidates nearest the prior pose);
- the collective bytes of one search (one (n, 11) f32 record, whatever
  the bank's K) and of one solve (the record sizes times the calls).

The engines, world size 2 (the ``engines`` launch), on the workloads of
``tests/test_parallel.py``, on worlds whose true matches win clearly
(seeds 1, 2 and 5, and the default world of the distributed engine's
run), so no registration peak is a near-tie that another f32 rounding
could resolve differently (ROADMAP Queue 3):

- the distributed engine (bank sharded over 2 ranks, GN-CG solves between
  chunks of 16) against JAX's on a 2-device ``bank`` mesh (decisions
  equal, poses within 2e-3) and against the torch single engine
  (decisions equal, poses within 5e-3, dense LM against GN-CG); both ranks
  the same; ``gather`` of the sharded bank equal to the single engine's;
- the same run (the chunk graph's plain program, the branch on the host)
  against the track-graph path (``run_chunk_track_graph``) on each rank
  bit for bit: outputs, solve tallies, every state leaf; one host exit
  per inserting frame, none early; the lent state's ``shard_base`` the
  rank's block; ``step`` against the track-graph path frame by frame;
- the same with the online stitcher over a 24-slot ring that evicts:
  decisions equal to JAX's distributed engine; both ranks' canvases equal
  bit for bit; the pixel count equal to JAX's and the intensity total
  within 1e-5 of it; the canvas equal to a fresh distributed recompute of
  the final bank; one all-reduce of an image per eviction and of the
  (2, S, S) canvas per recompute; on each rank the chunk graph with its
  keyframe branch as captured steps between the collectives against the
  track-graph path bit for bit (outputs, tallies, every leaf, all-reduces
  by payload), the stored kind's three steps made once;
- the deferred trigger's program (the pending edges, the GN-CG solve and
  the masked sharded recompute on the device, the host making the
  all-reduces) against the host loop on each rank, bit for bit, on
  hand-made maps with 0, 1 and ≥ 2 live pending matches, a voided match
  and stale entries, with and without the online canvas, through
  ``optimize`` and ``finalize``; the masked sharded recompute against the
  count-read one with the bank below capacity and with the ring wrapped;
- a single-engine checkpoint resumed into ``place()`` and into a fleet
  lane, against the uninterrupted run;
- the fleet, deferred and inline, lane for lane against JAX's fleet on a
  2-device ``data`` mesh, with no collective inside ``run_chunk``;
- the batch engine with a ``data`` group, 4 lanes over 2 ranks, against
  JAX's batch engine on a 2-device ``data`` mesh; its graphs against its
  kept eager loop bit for bit on each rank, with no collective inside
  ``run_chunk``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, wait
from types import SimpleNamespace

import numpy as np
import pytest
import torch

H, W = 64, 96
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
POSE_ATOL = 2e-3
DECISIONS = ("tracked", "inserted", "loop_found", "frame_id", "keyframe_slot", "loop_slot")
CHUNK = 16  # the distributed engine's chunks: 56 frames leave a tail of 8
STEP_FRAMES = 24  # the distributed engine's step against the track-graph path
LANE_CHUNK = 20  # the fleet's and the batch engine's: 48 frames leave a tail of 8
# Intensity totals of two canvases that hold the same pixels, summed in
# another order (the stitcher's tolerance, chip_smoke.py phase 8).
CANVAS_RTOL = 1e-5

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Shared by the pytest process and the ranks
# ---------------------------------------------------------------------------


def slam_config(cfgmod, **loop_closure):
    """The tests' 64×96 config, built from either package's config module
    (``nislam_tpu.core.config`` or ``nislam_torch.core.config``)."""
    lc = dict(to_find_loop=True, position_response_thr=8.0, angle_response_thr=8.0,
              frame_gap_thr=20, distance_thr=0.8, max_candidates=64)
    lc.update(loop_closure)
    return cfgmod.SlamConfig(
        cf=cfgmod.CFConfig(width=W, height=H, rotation_divisor=90, rotation_channel=48),
        keyframe_selection=cfgmod.KeyframeSelectionConfig(
            max_distance=0.08, max_angle=0.05, lower_response_thr=4.0, upper_response_thr=6.0,
        ),
        map=cfgmod.MapConfig(grid_scale=0.15, keyframe_capacity=64, edge_capacity=256),
        loop_closure=cfgmod.LoopClosureConfig(**lc),
        camera=cfgmod.CameraConfig(image_width=W, image_height=H, height=1.0,
                                   intrinsics=(100.0, W / 2.0, 100.0, H / 2.0)),
    )


def search_config(cfgmod):
    """The sharded search's config: ``tests/test_parallel.py``'s gates, and
    the flagship's 8 candidates (JAX's compile time grows with them)."""
    return slam_config(cfgmod, frame_gap_thr=5, distance_thr=0.2, max_candidates=8)


def trunc_config(cfgmod):
    """The truncation case: 16 slots, gates off, a per-rank cap of 2."""
    import dataclasses

    base = slam_config(cfgmod, frame_gap_thr=0, distance_thr=0.0, position_response_thr=6.0,
                       angle_response_thr=3.0, max_candidates=8, max_candidates_per_shard=2)
    return dataclasses.replace(base, map=cfgmod.MapConfig(grid_scale=1.0, keyframe_capacity=16,
                                                          edge_capacity=16))


def inline_config(cfgmod):
    base = slam_config(cfgmod, distance_thr=0.6)
    return dataclasses.replace(base, optimizer=dataclasses.replace(base.optimizer, inline=True))


def canvas_config(cfgmod):
    """The online stitcher on stored images over a ring of 24 slots, which
    the 56-frame run overflows (evictions), on a 512² canvas that holds
    every frame."""
    base = slam_config(cfgmod)
    return dataclasses.replace(
        base, map=dataclasses.replace(base.map, keyframe_capacity=24, edge_capacity=128),
        map_stitcher=dataclasses.replace(base.map_stitcher, stitch_map=True, online=True, canvas_size=512))


BANK_FIELDS = ("fft", "polar_fft", "filt", "filt_polar", "images", "poses", "grid_xy", "frame_ids",
               "distances", "count", "overflow", "evict_cursor")
RESULT_FIELDS = ("found", "loop_slot", "relative_pose", "response", "eligible_count")


def _bank_arrays(prefix: str, data) -> dict:
    return {name: data[f"{prefix}_{name}"] for name in BANK_FIELDS}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _rank_search(group, data, prefix: str, cfg) -> dict:
    """One sharded search on the bank ``prefix``_* of ``data``."""
    from nislam_torch.core.map_store import KeyframeBank
    from nislam_torch.core.slam import init_state
    from nislam_torch.ops.registration import compute_intermedium
    from nislam_torch.parallel.engine import make_distributed_engine

    engine = make_distributed_engine(cfg, group)
    full = init_state(cfg, torch.device("cpu"))
    full.bank = KeyframeBank(**{k: torch.from_numpy(np.array(v)) for k, v in _bank_arrays(prefix, data).items()})
    bank = engine.place(full).bank
    image = torch.from_numpy(data[f"{prefix}_image"])
    _, polar = compute_intermedium(image, engine.cf_ops)
    res = engine.loop_search_fn(
        bank, image, polar, torch.tensor(int(data[f"{prefix}_fid"]), dtype=torch.int32),
        torch.tensor(float(data[f"{prefix}_dist"])), torch.from_numpy(data[f"{prefix}_prior"]),
        engine.cf_ops, cfg.loop_closure, cfg.map.grid_scale,
    )
    return {f"{prefix}_{k}": v.numpy() for k, v in zip(RESULT_FIELDS, res)}


def _counts(group, before) -> np.ndarray:
    """The collective calls since ``before`` as rows (is all_reduce, bytes, calls)."""
    delta = group.counts - before
    return np.array([(op == "all_reduce", nbytes, n) for (op, nbytes), n in sorted(delta.items())],
                    np.int64).reshape(-1, 3)


def rank_checks(group, data) -> dict:
    """The solve, the two searches and the collective bytes."""
    import dataclasses

    from nislam_torch.core import config as tconfig
    from nislam_torch.core.pose_graph import PoseGraphProblem
    from nislam_torch.parallel.solver import CGGraph, CGSolverConfig, solve_pose_graph_cg
    from nislam_torch.utils.scaling import collective_bytes_loop_search, collective_bytes_solver

    out = {}
    e = data["solve_from"].shape[0]
    prob = PoseGraphProblem(
        poses=torch.from_numpy(data["solve_poses"]), pose_mask=torch.from_numpy(data["solve_mask"]),
        from_slot=torch.from_numpy(data["solve_from"]), to_slot=torch.from_numpy(data["solve_to"]),
        T=torch.from_numpy(data["solve_T"]), sqrt_info=torch.eye(3).expand(e, 3, 3).contiguous(),
        edge_mask=torch.from_numpy(data["solve_edge_mask"]),
    )
    cg = CGSolverConfig(outer_iterations=30, cg_iterations=100)
    for name, solve in (("solve", lambda p: solve_pose_graph_cg(p, group, cg)), ("solve_graph", CGGraph(group, cg))):
        before = group.counts.copy()
        poses, cost = solve(prob)
        out.update({f"{name}_poses": poses.numpy(), f"{name}_cost": cost.numpy(),
                    f"{name}_counts": _counts(group, before)})

    out.update(_rank_search(group, data, "search", search_config(tconfig)))
    out.update(_rank_search(group, data, "trunc", trunc_config(tconfig)))

    cfg = search_config(tconfig)
    big = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, keyframe_capacity=128))
    out["search_bytes"] = np.array([collective_bytes_loop_search(group, c) for c in (cfg, big)])
    before = group.counts.copy()
    out["chain_bytes"] = np.array(collective_bytes_solver(group, keyframe_capacity=64, edge_capacity=128))
    out["chain_counts"] = _counts(group, before)
    return out


def _rank_canvas(group, frames) -> dict:
    """The distributed engine with the online stitcher: its outputs, its
    canvas, a fresh recompute of its final bank, and the all-reduces of
    the canvas hook by payload bytes; its every leaf and collective, and
    its branch's steps by kind, beside the same run through the
    track-graph path (the eager branch)."""
    from nislam_torch.core import config as tconfig
    from nislam_torch.core.slam import pack_outputs
    from nislam_torch.core.stitcher import make_canvas
    from nislam_torch.parallel import make_distributed_engine

    from test_torch_dist_graph import TrackGraphEngine

    cfg = canvas_config(tconfig)
    engine = make_distributed_engine(cfg, group)
    before = group.counts.copy()
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), frames, chunk_frames=CHUNK, solve_tally=tally)
    state, ran = engine.finalize(state)
    delta = group.counts - before
    counts = _counts(group, before)
    fresh = engine.recompute_canvas(make_canvas(cfg.map_stitcher, torch.device("cpu")), state.bank)
    image_bytes, canvas_bytes = H * W * 4, 2 * cfg.map_stitcher.canvas_size ** 2 * 4
    progs = engine.frame_graph.programs
    out = dict(
        canvas_outs=pack_outputs(outs), canvas_poses=state.bank.poses.numpy(),
        canvas_count=state.bank.count.numpy(), canvas_overflow=state.bank.overflow.numpy(),
        canvas_solves=np.int32(sum(tally) + ran), canvas_data=state.canvas.data.numpy(),
        canvas_weight=state.canvas.weight.numpy(), canvas_fresh_data=fresh.data.numpy(),
        canvas_fresh_weight=fresh.weight.numpy(),
        canvas_retires=np.int64(delta[("all_reduce", image_bytes)]),
        canvas_recomputes=np.int64(delta[("all_reduce", canvas_bytes)]),
        canvas_leaves=_leaf_bytes(state), canvas_tally=np.array(tally + [ran]), canvas_counts=counts,
        canvas_programs=np.array([(int(k), len(p.steps), p.runs) for k, p in sorted(progs.items())], np.int64),
        canvas_exits=np.int64(engine.chunk_graph.host_exits),
    )
    ref = TrackGraphEngine(make_distributed_engine(cfg, group))
    before = group.counts.copy()
    tally = []
    state, outs = ref.run_sequence(ref.init_state(), frames, chunk_frames=CHUNK, solve_tally=tally)
    state, ran = ref.finalize(state)
    out.update(canvas_track_outs=pack_outputs(outs), canvas_track_leaves=_leaf_bytes(state),
               canvas_track_tally=np.array(tally + [ran]), canvas_track_counts=_counts(group, before))
    return out


def _leaf_bytes(state) -> np.ndarray:
    from nislam_torch.core.slam import state_leaves

    return np.frombuffer(b"".join(x.reshape(-1).view(torch.uint8).numpy().tobytes() for x in state_leaves(state)),
                         np.uint8)


def _rank_track_graph_path(group, cfg, frames) -> dict:
    """The distributed engine through the track-graph path (``run_chunk_track_graph``),
    the reference of its chunk graph, and ``step`` through the chunk
    graph against it frame by frame (the trigger after every frame)."""
    from nislam_torch.core.slam import pack_outputs, run_chunk_track_graph
    from nislam_torch.parallel import make_distributed_engine

    from test_torch_dist_graph import TrackGraphEngine

    ref = TrackGraphEngine(make_distributed_engine(cfg, group))
    tally = []
    state, outs = ref.run_sequence(ref.init_state(), frames, chunk_frames=CHUNK, solve_tally=tally)
    state, ran = ref.finalize(state)
    out = dict(track_outs=pack_outputs(outs), track_leaves=_leaf_bytes(state), track_tally=np.array(tally + [ran]))
    eng, ref = make_distributed_engine(cfg, group), make_distributed_engine(cfg, group)
    gs, rs = eng.init_state(), ref.init_state()
    got, want = [], []
    for frame in frames[:STEP_FRAMES]:
        gs, packed = eng.step_packed(gs, torch.from_numpy(frame))
        rs, o = run_chunk_track_graph(ref, rs, frame[None])
        got.append(packed)
        want.append(o.pack()[0])
        gs, _ = eng.optimize(gs)
        rs, _ = ref.optimize(rs)
    out.update(step_outs=torch.stack(got).numpy(), step_leaves=_leaf_bytes(gs),
               step_track_outs=torch.stack(want).numpy(), step_track_leaves=_leaf_bytes(rs),
               step_exits=np.int64(eng.chunk_graph.host_exits))
    return out


# The deferred trigger's hand-made maps (tests/test_torch_dist_graph.py's).
TRIGGER_CASES = ("none", "one", "voided", "run", "stale")


def _rank_trigger(group) -> dict:
    """The distributed engine's trigger program (its plain program: the
    host makes the all-reduces, as on gloo) and the host loop on each
    hand-made map, with and without the online canvas, through
    ``optimize`` and ``finalize`` → each's decision, every leaf's bytes and
    the all-reduces by payload; then ``ShardedCanvas``' staged recompute and
    the count-read one with the bank below capacity and with the ring
    wrapped, each canvas's bytes."""
    from nislam_torch.core.slam import finalize_host_loop, optimize_host_loop
    from nislam_torch.parallel import make_distributed_engine
    from nislam_torch.parallel.engine import ShardedCanvas

    from test_torch_solve_graph import N_KF, _config as solve_config, _fill

    out = {}
    for online in (False, True):
        config = solve_config(online=online)
        engine, ref = make_distributed_engine(config, group), make_distributed_engine(config, group)
        for case in TRIGGER_CASES:
            for entry, host in (("optimize", optimize_host_loop), ("finalize", finalize_host_loop)):
                key = f"trig_{case}_{int(online)}_{entry}"
                for label, eng in (("program", engine), ("host", ref)):
                    state = eng.init_state()
                    _fill(state, eng.camera, case, 0)
                    rows = state.bank.images.shape[0]
                    rng = np.random.default_rng(0)
                    images = rng.uniform(0, 1, (N_KF,) + tuple(state.bank.images.shape[1:]))
                    own = images[group.rank * rows:(group.rank + 1) * rows]
                    state.bank.images[:len(own)] = torch.from_numpy(own).to(state.bank.images.dtype)
                    before = group.counts.copy()
                    state, ran = (getattr(eng, entry)(state) if label == "program" else host(eng, state))
                    out.update({f"{key}_{label}_leaves": _leaf_bytes(state), f"{key}_{label}_ran": np.bool_(ran),
                                f"{key}_{label}_counts": _counts(group, before)})
        if online:
            state = engine.init_state()
            _fill(state, engine.camera, "run", 0)
            rng = np.random.default_rng(5)
            k = config.map.keyframe_capacity
            state.bank.images.copy_(torch.from_numpy(rng.uniform(0, 1, state.bank.images.shape)))
            state.bank.poses.copy_(torch.from_numpy(rng.normal(0, 0.3, (k, 3)).astype(np.float32)))
            canvas = ShardedCanvas(group)
            for name, count in (("below", 13), ("wrapped", k)):
                state.bank.count.fill_(count)
                want = canvas.recompute(dataclasses.replace(state.canvas, data=state.canvas.data.clone(),
                                                            weight=state.canvas.weight.clone()),
                                        state.bank, engine.camera)
                delta = ShardedCanvas.recompute_buffer(state.canvas)
                ShardedCanvas.recompute_stage(delta, state.canvas, state.bank, engine.camera)
                group.all_reduce(delta)
                ShardedCanvas.recompute_finish(state.canvas, delta)
                out.update({f"recompute_{name}_masked": torch.stack([state.canvas.data, state.canvas.weight]).numpy(),
                            f"recompute_{name}_count_read": torch.stack([want.data, want.weight]).numpy()})
    return out


def rank_engines(group, data, workdir) -> dict:
    from nislam_torch.core import config as tconfig
    from nislam_torch.core.slam import init_state, pack_outputs, state_leaves
    from nislam_torch.io.checkpoint import load_state
    from nislam_torch.parallel import make_batch_engine, make_distributed_engine, make_fleet_engine
    from nislam_torch.parallel.batch import eager_engine
    from nislam_torch.parallel.mesh import world_group

    out = {}
    cfg = slam_config(tconfig)
    cpu = torch.device("cpu")
    frames = data["engine_frames"]

    dist = make_distributed_engine(cfg, group)
    state = dist.init_state()
    assert state.bank.fft.shape[0] == cfg.map.keyframe_capacity // group.size
    tally = []
    state, outs = dist.run_sequence(state, frames, chunk_frames=CHUNK, solve_tally=tally)
    state, ran = dist.finalize(state)
    full = dist.gather(state)
    out.update(engine_outs=pack_outputs(outs), engine_poses=state.bank.poses.numpy(),
               engine_count=state.bank.count.numpy(), engine_solves=np.int32(sum(tally) + ran),
               engine_fft=full.bank.fft.numpy(), engine_filt_polar=full.bank.filt_polar.numpy(),
               engine_images=full.bank.images.numpy(), engine_leaves=_leaf_bytes(state),
               engine_tally=np.array(tally + [ran]), engine_shard_base=np.int64(state.bank.shard_base),
               engine_exits=np.array([dist.chunk_graph.host_exits, dist.chunk_graph.early_exits]))
    out.update(_rank_track_graph_path(group, cfg, frames))
    out.update(_rank_canvas(group, frames))
    out.update(_rank_trigger(group))

    ckpt = os.path.join(workdir, "mid.npz")
    s8 = dist.place(load_state(ckpt, init_state(cfg, cpu)))
    s8, o8 = dist.run_sequence(s8, frames[32:], chunk_frames=CHUNK)
    s8, _ = dist.finalize(s8)
    out.update(resume_outs=pack_outputs(o8), resume_poses=s8.bank.poses.numpy())

    lanes = world_group("data", cpu)
    fleet = make_fleet_engine(cfg, lanes)
    st = fleet.place_states([load_state(ckpt, init_state(cfg, cpu)) for _ in range(2)])
    st, of = fleet.run_sequences(st, np.stack([frames[32:]] * 2), chunk_frames=CHUNK)
    st, _ = fleet.finalize(st)
    out.update(resume_fleet_outs=pack_outputs(of), resume_fleet_poses=st.bank.poses.numpy())

    for name, c, seqs in (("fleet", cfg, data["lane_seqs"][:2]), ("inline", inline_config(tconfig),
                                                                    data["inline_seqs"])):
        fleet = make_fleet_engine(c, lanes)
        before = lanes.counts.copy()
        fleet.run_chunk(fleet.init_states(), seqs[:, :4])
        assert lanes.counts == before, "the fleet's lane body made a collective"
        chunk = LANE_CHUNK if name == "fleet" else seqs.shape[1]
        st, fo = fleet.run_sequences(fleet.init_states(), seqs, chunk_frames=chunk)
        st, _ = fleet.finalize(st)
        out.update({f"{name}_outs": pack_outputs(fo), f"{name}_poses": st.bank.poses.numpy()})

    batch = make_batch_engine(cfg, 4, device="cpu", group=lanes)
    assert list(batch.lanes) == [2 * group.rank, 2 * group.rank + 1]
    before = lanes.counts.copy()
    batch.run_chunk(batch.init_states(), data["lane_seqs"][batch.lanes.start:batch.lanes.stop, :4])
    assert lanes.counts == before, "the batch engine's frame made a collective"
    # The graph path, then the kept eager loop (run_chunk_eager).
    eager = eager_engine(make_batch_engine(cfg, 4, device="cpu", group=lanes))
    for name, eng in (("batch", batch), ("batch_eager", eager)):
        tally = []
        bs, bo = eng.run_sequences(eng.init_states(), data["lane_seqs"], chunk_frames=LANE_CHUNK, solve_tally=tally)
        bs, ran = eng.finalize(bs)
        leaves = b"".join(x.reshape(-1).view(torch.uint8).numpy().tobytes() for x in state_leaves(bs))
        out.update({f"{name}_outs": pack_outputs(bo), f"{name}_poses": bs.bank.poses.numpy(),
                    f"{name}_tally": np.array(tally + [ran]), f"{name}_leaves": np.frombuffer(leaves, np.uint8)})
    assert batch._frame_graph is not None and eager._frame_graph is None
    return out


def rank_engine4(group, data) -> dict:
    """The distributed engine at 4 ranks: the bank over the group, its
    chunk graph (the branch on the host: gloo with CPU tensors), the GN-CG
    solves between chunks."""
    from nislam_torch.core import config as tconfig
    from nislam_torch.core.slam import pack_outputs
    from nislam_torch.parallel import make_distributed_engine

    dist = make_distributed_engine(slam_config(tconfig), group)
    tally = []
    state, outs = dist.run_sequence(dist.init_state(), data["engine_frames"], chunk_frames=CHUNK, solve_tally=tally)
    state, ran = dist.finalize(state)
    return {"engine_outs": pack_outputs(outs), "engine_poses": state.bank.poses.numpy(),
            "engine_count": state.bank.count.numpy(), "engine_solves": np.int32(sum(tally) + int(ran))}


def main(argv) -> int:
    world, rank, port, workdir, what = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nislam_torch.parallel.mesh import init_distributed

    group = init_distributed(f"tcp://127.0.0.1:{port}", world, rank, "gloo", "cpu", timeout_s=LAUNCH_TIMEOUT_S)
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        data = dict(f)
    if what == "checks":
        out = rank_checks(group, data)
    elif what == "engine4":
        out = rank_engine4(group, data)
    else:
        out = rank_engines(group, data, workdir)
    np.savez(os.path.join(workdir, f"{what}_{world}_rank{rank}.npz"), **out)
    assert "jax" not in sys.modules and "nislam_tpu" not in sys.modules
    # A barrier, then the process group destroyed: a gloo rank that exits
    # with its process group alive may abort in C++ teardown ("terminate
    # called without an active exception").
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# Launching the ranks (pytest side)
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, workdir: str, what: str) -> list:
    """``world`` ranks of this worker on ``workdir``'s inputs, started
    together and waited for within the launch's own timeout (a hang is
    killed and fails) → each rank's arrays."""
    port = free_port()
    path = os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    start = time.monotonic()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(world), str(r), str(port), workdir, what],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, LAUNCH_TIMEOUT_S - (time.monotonic() - start)))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks ({what}) did not finish in {LAUNCH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} ({what}) failed:\n{log}"
    results = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"{what}_{world}_rank{r}.npz")) as f:
            results.append(dict(f))
    return results


def bank_inputs(prefix: str, bank, image, fid, dist, prior) -> dict:
    out = {f"{prefix}_{name}": getattr(bank, name).numpy() for name in BANK_FIELDS}
    out.update({f"{prefix}_image": np.asarray(image, np.float32), f"{prefix}_fid": np.int32(fid),
                f"{prefix}_dist": np.float32(dist), f"{prefix}_prior": np.asarray(prior, np.float32)})
    return out


def _search_inputs() -> dict:
    """A bank from an out-and-back run (revisits with a large frame gap)
    and its last frame as the query; the truncation case's bank of four
    keyframes, the true match at the last slot of its rank's block."""
    from nislam_torch.core import config as tconfig
    from nislam_torch.core.map_store import add_keyframe, make_keyframe_bank
    from nislam_torch.core.slam import make_engine
    from nislam_torch.ops.registration import compute_intermedium, compute_keyframe_filters, make_cf_ops
    from nislam_torch.utils.synthetic import make_world, render_frame, render_sequence, straight_path

    cfg = search_config(tconfig)
    engine = make_engine(cfg, torch.device("cpu"))
    world = make_world(512, 3.0)
    path = straight_path(20, step=5.0, start=(256.0, 256.0))
    frames = render_sequence(world, H, W, path + path[::-1])
    state, _ = engine.run_chunk(engine.init_state(), frames)
    tr = state.track
    out = bank_inputs("search", state.bank, frames[-1], int(tr.next_frame_id), float(tr.distance),
                      tr.last_pose.numpy())

    tcfg = trunc_config(tconfig)
    ops = make_cf_ops(tcfg.cf)
    bank = make_keyframe_bank(tcfg.cf, tcfg.map, torch.device("cpu"))
    # slots 0-2: decoys clustered at (250, 250); slot 3: the true revisit
    # target at (280, 262), last in its rank's block.
    for i, (px, py) in enumerate([(250.0, 250.0), (251.0, 251.0), (252.0, 252.0), (280.0, 262.0)]):
        img = torch.from_numpy(render_frame(world, H, W, px, py, 0.0))
        fft, polar = compute_intermedium(img, ops)
        fi, fp = compute_keyframe_filters(fft, polar, ops)
        add_keyframe(bank, fft=fft, polar_fft=polar, filt=fi, filt_polar=fp, image=img,
                     pose=torch.tensor([(px - 256.0) * 0.01, (py - 256.0) * 0.01, 0.0]),
                     frame_id=torch.tensor(i, dtype=torch.int32), distance=torch.tensor(0.01 * i),
                     grid_scale=tcfg.map.grid_scale, enabled=True)
    out.update(bank_inputs("trunc", bank, render_frame(world, H, W, 281.0, 262.0, 0.0), 100, 9.0,
                           [0.24, 0.06, 0.0]))
    return out


def _solve_inputs() -> dict:
    """A 24-pose chain with skip edges in 32 slots (8 dead, holding
    values that must come back untouched) and 64 edge slots."""
    from nislam_torch.utils.scaling import chain_problem

    p = chain_problem(24, 64, seed=3)
    poses = np.zeros((32, 3), np.float32)
    poses[:24] = p.poses.numpy()
    poses[24:] = np.linspace(1.0, 2.0, 24, dtype=np.float32).reshape(8, 3)
    return {"solve_poses": poses, "solve_mask": np.arange(32) < 24, "solve_from": p.from_slot.numpy(),
            "solve_to": p.to_slot.numpy(), "solve_T": p.T.numpy(), "solve_edge_mask": p.edge_mask.numpy()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs; JAX's references in threads (XLA compiles outside the
    interpreter lock), waited for; then the launches, one world size after
    the other.  Each test reads the futures it needs, so a failure fails
    only those tests."""
    from nislam_tpu.core import config as jconfig

    workdir = str(tmp_path_factory.mktemp("ranks"))
    data = {**_solve_inputs(), **_search_inputs()}
    np.savez(os.path.join(workdir, "inputs.npz"), **data)
    with ThreadPoolExecutor(3) as ex:
        jax_refs = {
            ("search", 2): ex.submit(_jax_search, data, "search", search_config(jconfig), 2),
            ("search", 4): ex.submit(_jax_search, data, "search", search_config(jconfig), 4),
            ("trunc", 4): ex.submit(_jax_search, data, "trunc", trunc_config(jconfig), 4),
            ("solve", 2): ex.submit(_jax_solve, data, 2),
            ("solve", 4): ex.submit(_jax_solve, data, 4),
        }
        wait(list(jax_refs.values()))
        runs = ex.submit(lambda: {n: launch(n, workdir, "checks") for n in (2, 4)})
        yield SimpleNamespace(data=data, results=lambda n: runs.result()[n], jax=jax_refs)


def _jax_solve(data, n):
    """JAX's GN-CG on an n-device mesh and its dense LM → numpy
    ``(cg poses, cg cost, dense poses)``."""
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core.pose_graph import PoseGraphProblem, solve_pose_graph
    from nislam_tpu.parallel.mesh import make_mesh
    from nislam_tpu.parallel.solver import CGSolverConfig, solve_pose_graph_cg

    e = data["solve_from"].shape[0]
    prob = PoseGraphProblem(
        poses=jnp.asarray(data["solve_poses"]), pose_mask=jnp.asarray(data["solve_mask"]),
        from_slot=jnp.asarray(data["solve_from"]), to_slot=jnp.asarray(data["solve_to"]),
        T=jnp.asarray(data["solve_T"]), sqrt_info=jnp.broadcast_to(jnp.eye(3), (e, 3, 3)),
        edge_mask=jnp.asarray(data["solve_edge_mask"]),
    )
    cg, cost = solve_pose_graph_cg(prob, make_mesh({"bank": n}, devices=jax.devices()[:n]),
                                   cfg=CGSolverConfig(outer_iterations=30, cg_iterations=100))
    dense, _, _ = solve_pose_graph(prob)
    return np.asarray(cg), float(cost), np.asarray(dense)


def _jax_bank(data, prefix):
    import jax.numpy as jnp

    from nislam_tpu.core.map_store import KeyframeBank

    return KeyframeBank(**{k: jnp.asarray(v) for k, v in _bank_arrays(prefix, data).items()})


def _jax_search(data, prefix, cfg, n):
    import jax
    import jax.numpy as jnp

    from nislam_tpu.ops.registration import compute_intermedium, make_cf_ops
    from nislam_tpu.parallel.loop_search import find_loop_closure_sharded
    from nislam_tpu.parallel.mesh import make_mesh

    ops = make_cf_ops(cfg.cf)
    img = jnp.asarray(data[f"{prefix}_image"])
    _, polar = compute_intermedium(img, ops)
    res = find_loop_closure_sharded(
        _jax_bank(data, prefix), img, polar, jnp.asarray(int(data[f"{prefix}_fid"]), jnp.int32),
        jnp.asarray(float(data[f"{prefix}_dist"]), jnp.float32), jnp.asarray(data[f"{prefix}_prior"]),
        ops, cfg.loop_closure, cfg.map.grid_scale, make_mesh({"bank": n}, devices=jax.devices()[:n]),
    )
    return {k: np.asarray(v) for k, v in zip(RESULT_FIELDS, res)}


def _same_on_every_rank(results, key):
    for r, res in enumerate(results[1:], 1):
        np.testing.assert_array_equal(res[key], results[0][key], err_msg=f"{key}: rank {r} vs rank 0")
    return results[0][key]


def _held(got: dict, want: dict, what: str):
    for k in ("found", "loop_slot", "eligible_count"):
        assert int(got[k]) == int(want[k]), f"{what}: {k} {got[k]} != {want[k]}"
    np.testing.assert_allclose(got["relative_pose"], want["relative_pose"], atol=1e-4, err_msg=what)
    np.testing.assert_allclose(got["response"], want["response"], rtol=5e-4, err_msg=what)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["eager", "graph"])
@pytest.mark.parametrize("n", [2, 4])
def test_cg_solve_matches_jax(ranks, n, solver):
    """The eager GN-CG solve, and ``CGGraph``'s (bit for bit with it on
    every rank: poses, cost, all-reduces), against JAX's GN-CG and dense LM."""
    data = ranks.data
    jcg, jcost, dense = ranks.jax[("solve", n)].result()
    results = ranks.results(n)
    key = "solve" if solver == "eager" else "solve_graph"
    got = _same_on_every_rank(results, f"{key}_poses")
    np.testing.assert_allclose(got, jcg, atol=1e-4)
    np.testing.assert_allclose(got[:24], dense[:24], atol=POSE_ATOL)
    np.testing.assert_allclose(_same_on_every_rank(results, f"{key}_cost"), jcost, rtol=1e-3)
    np.testing.assert_array_equal(got[0], data["solve_poses"][0])  # the pinned base
    np.testing.assert_array_equal(got[24:], data["solve_poses"][24:])  # dead slots
    if solver == "graph":
        for r, res in enumerate(results):
            for name in ("poses", "cost", "counts"):
                a, b = res[f"solve_graph_{name}"], res[f"solve_{name}"]
                assert a.tobytes() == b.tobytes() and a.shape == b.shape, f"rank {r}: {name}"


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_search_matches_jax(ranks, n):
    """Both searches find the revisit; torch's equals JAX's sharded search
    and the single search (``coarse_scale`` 1: the same candidates)."""
    from nislam_torch.core import config as tconfig
    from nislam_torch.core.loop_closure import find_loop_closure
    from nislam_torch.core.map_store import KeyframeBank
    from nislam_torch.ops.registration import compute_intermedium, make_cf_ops

    data = ranks.data
    want = ranks.jax[("search", n)].result()
    results = ranks.results(n)
    got = {k: _same_on_every_rank(results, f"search_{k}") for k in RESULT_FIELDS}
    assert bool(got["found"])
    _held(got, want, f"sharded search, {n} ranks vs JAX")

    cfg = search_config(tconfig)
    ops = make_cf_ops(cfg.cf)
    img = torch.from_numpy(data["search_image"])
    _, polar = compute_intermedium(img, ops)
    single = find_loop_closure(
        KeyframeBank(**{k: torch.from_numpy(np.array(v)) for k, v in _bank_arrays("search", data).items()}),
        img, polar, torch.tensor(int(data["search_fid"]), dtype=torch.int32),
        torch.tensor(float(data["search_dist"])), torch.from_numpy(data["search_prior"]), ops,
        cfg.loop_closure, cfg.map.grid_scale,
    )
    _held(got, {k: v.numpy() for k, v in zip(RESULT_FIELDS, single)}, f"sharded search, {n} ranks vs single")


@pytest.mark.parametrize("n", [4])
def test_sharded_truncation_keeps_nearest(ranks, n):
    """A per-rank cap of 2 with four eligible keyframes in rank 0's block:
    the true match at the block's last slot survives (nearest the prior),
    as in JAX."""
    want = ranks.jax[("trunc", n)].result()
    got = {k: _same_on_every_rank(ranks.results(n), f"trunc_{k}") for k in RESULT_FIELDS}
    assert int(got["eligible_count"]) == 4 and bool(got["found"]) and int(got["loop_slot"]) == 3
    _held(got, want, f"truncation, {n} ranks vs JAX")


@pytest.mark.parametrize("n", [2, 4])
def test_collective_bytes(ranks, n):
    """One search moves one (n, 11) f32 record whatever the bank's K; one
    solve moves (2, K, 3) per Gauss-Newton step, (K, 3) per CG iteration
    and the cost, all by all_reduce."""
    results = ranks.results(n)
    search = _same_on_every_rank(results, "search_bytes")
    assert search.tolist() == [n * 11 * 4] * 2
    for key, k, outer in (("solve_counts", 32, 30), ("chain_counts", 64, 20)):
        counts = _same_on_every_rank(results, key)
        assert counts[:, 0].all()  # all_reduce only
        calls = {int(b): int(c) for _, b, c in counts}
        assert set(calls) <= {2 * k * 3 * 4, k * 3 * 4, 4}, calls
        assert calls[2 * k * 3 * 4] == outer and calls[4] == 1
        assert 0 < calls[k * 3 * 4] <= outer * (100 if key == "solve_counts" else 64)
    chain = results[0]["chain_counts"]
    assert int(results[0]["chain_bytes"]) == int((chain[:, 1] * chain[:, 2]).sum())


@pytest.mark.parametrize("k, n, c", [(64, 8, 8), (272, 2, 4), (100, 8, 64)])
def test_shard_work_stats_equal(k, n, c):
    from nislam_torch.utils.scaling import shard_work_stats as tstats
    from nislam_tpu.utils.scaling import shard_work_stats as jstats

    kw = dict(keyframe_capacity=k, nshards=n, max_candidates=c)
    assert tstats(**kw) == jstats(**kw)


def test_engines_refuse_bad_groups():
    """Capacities that do not divide, the wrong axis; no process group is
    needed to refuse."""
    from nislam_torch.core import config as tconfig
    from nislam_torch.parallel import make_batch_engine, make_distributed_engine, make_fleet_engine
    from nislam_torch.parallel.mesh import RankGroup

    cfg = slam_config(tconfig)
    bank3 = RankGroup(rank=0, size=3, axis="bank", device=torch.device("cpu"))
    with pytest.raises(ValueError, match="keyframe_capacity"):
        make_distributed_engine(cfg, bank3)
    bank2 = dataclasses.replace(bank3, size=2)
    # the online stitcher is taken, through the engine's sharded canvas hook
    online = make_distributed_engine(canvas_config(tconfig), bank2)
    assert online.canvas_ops is not None and online.config.map_stitcher.online
    with pytest.raises(ValueError, match="'data'"):
        make_fleet_engine(cfg, bank2)
    with pytest.raises(ValueError, match="'bank'"):
        make_distributed_engine(cfg, dataclasses.replace(bank2, axis="data"))
    with pytest.raises(ValueError, match="divisible"):
        make_batch_engine(cfg, 3, device="cpu", group=dataclasses.replace(bank2, axis="data"))
    # the engine turns the inline solve off: the drive defers it
    inline = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, inline=True))
    assert not make_distributed_engine(inline, bank2).config.optimizer.inline


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


def _jax_distributed(frames, make_config, n: int = 2):
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core import config as jconfig
    from nislam_tpu.parallel.engine import make_distributed_engine
    from nislam_tpu.parallel.mesh import make_mesh

    je = make_distributed_engine(make_config(jconfig), make_mesh({"bank": n}, devices=jax.devices()[:n]))
    js, jo = je.run_sequence(je.init_state(), jnp.asarray(frames), chunk_frames=CHUNK)
    js, _ = je.finalize(js)
    return jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jo)


def _jax_fleet(seqs, mode):
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core import config as jconfig
    from nislam_tpu.parallel.fleet import make_fleet_engine
    from nislam_tpu.parallel.mesh import make_mesh

    cfg = slam_config(jconfig) if mode == "deferred" else inline_config(jconfig)
    fleet = make_fleet_engine(cfg, make_mesh({"data": 2}, devices=jax.devices()[:2]))
    if mode == "deferred":
        js, jo = fleet.run_sequences(fleet.init_states(), jnp.asarray(seqs), chunk_frames=LANE_CHUNK)
    else:
        js, jo = fleet.run_chunk(fleet.init_states(), jnp.asarray(seqs))
    js, _ = fleet.finalize(js)
    return jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jo)


def _jax_batch(seqs):
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core import config as jconfig
    from nislam_tpu.parallel.batch import make_batch_engine
    from nislam_tpu.parallel.mesh import make_mesh

    je = make_batch_engine(slam_config(jconfig), batch=4, mesh=make_mesh({"data": 2}, devices=jax.devices()[:2]))
    js, jo = je.run_sequences(je.init_states(), jnp.asarray(seqs), chunk_frames=LANE_CHUNK)
    js, _ = je.finalize(js)
    return jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jo)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Inputs; JAX's references in threads while the torch single engine's
    reference runs here, then the launch.  Each test reads the futures it
    needs."""
    from nislam_torch.core import config as tconfig
    from nislam_torch.core.slam import make_engine
    from nislam_torch.io.checkpoint import save_state
    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence, square_loop_path

    workdir = str(tmp_path_factory.mktemp("engine_ranks"))
    frames = _engine_frames()
    lane_path = heading_loop_path(48, step=3.5, start=(256.0, 256.0), tail=8)
    inline_path = square_loop_path(side_steps=18, step=4.5, start=(256.0, 256.0), tail=24)
    worlds = {s: make_world(512, 3.0, seed=s) for s in (1, 2, 5)}
    data = {
        "engine_frames": frames,
        "lane_seqs": np.stack([render_sequence(worlds[s], H, W, lane_path) for s in (1, 2, 5, 1)]),
        "inline_seqs": np.stack([render_sequence(worlds[s], H, W, inline_path) for s in (1, 2)]),
    }
    np.savez(os.path.join(workdir, "inputs.npz"), **data)

    single = make_engine(slam_config(tconfig), torch.device("cpu"))
    mid, _ = single.run_sequence(single.init_state(), frames[:32], chunk_frames=CHUNK)
    save_state(os.path.join(workdir, "mid.npz"), mid)
    with ThreadPoolExecutor(3) as ex:
        jax_refs = {
            "distributed": ex.submit(_jax_distributed, frames, slam_config),
            "canvas": ex.submit(_jax_distributed, frames, canvas_config),
            "deferred": ex.submit(_jax_fleet, data["lane_seqs"][:2], "deferred"),
            "inline": ex.submit(_jax_fleet, data["inline_seqs"], "inline"),
            "batch": ex.submit(_jax_batch, data["lane_seqs"]),
        }
        ref, ref_outs = single.run_sequence(single.init_state(), frames, chunk_frames=CHUNK)
        ref, _ = single.finalize(ref)
        wait(list(jax_refs.values()))
        runs = ex.submit(launch, 2, workdir, "engines")
        yield SimpleNamespace(data=data, results=runs.result, ref=ref, ref_outs=ref_outs, jax=jax_refs)


def _engine_frames() -> np.ndarray:
    """The distributed engine's frames: a heading loop that closes."""
    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

    return render_sequence(make_world(512, 3.0), H, W, heading_loop_path(56, step=3.5, start=(256.0, 256.0), tail=10))


@pytest.fixture(scope="module")
def engine4(tmp_path_factory):
    """The distributed engine at 4 gloo ranks and JAX's on a 4-device
    ``bank`` mesh (first, in a thread), on the engines' frames."""
    workdir = str(tmp_path_factory.mktemp("engine4_ranks"))
    frames = _engine_frames()
    np.savez(os.path.join(workdir, "inputs.npz"), engine_frames=frames)
    with ThreadPoolExecutor(1) as ex:
        jax_ref = ex.submit(_jax_distributed, frames, slam_config, 4)
        wait([jax_ref])
        yield SimpleNamespace(results=launch(4, workdir, "engine4"), jax=jax_ref)


def test_distributed_engine_at_4_ranks_matches_jax(engine4):
    """At 4 ranks (16 bank slots and 64 edge slots each) every rank the
    same, and against JAX's distributed engine on 4 devices: decisions
    exact, GN-CG poses within 5e-3."""
    from nislam_torch.core.slam import unpack_step_output

    results = engine4.results
    js, jo = engine4.jax.result()
    for r, res in enumerate(results[1:], 1):
        for key in ("engine_outs", "engine_poses", "engine_count", "engine_solves"):
            assert res[key].tobytes() == results[0][key].tobytes(), f"{key}: rank {r} vs rank 0"
    got = unpack_step_output(results[0]["engine_outs"])
    assert int(got.loop_found.sum()) >= 1 and int(results[0]["engine_solves"]) >= 1
    _decisions_equal(got, jo, "4 ranks vs JAX's distributed engine on 4 devices")
    assert _wrapped(got.pose - jo.pose) <= 5e-3
    k = int(results[0]["engine_count"])
    assert k == int(js.bank.count)
    assert _wrapped(results[0]["engine_poses"][:k] - np.asarray(js.bank.poses)[:k]) <= 5e-3


def _both(results, key):
    r0, r1 = results()
    np.testing.assert_array_equal(r0[key], r1[key], err_msg=f"{key}: the ranks differ")
    return r0[key]


def _both_bits(results, key):
    """``key`` on both ranks, equal bit for bit (float32)."""
    r0, r1 = results()
    np.testing.assert_array_equal(r0[key].view(np.int32), r1[key].view(np.int32),
                                  err_msg=f"{key}: the ranks' bits differ")
    return r0[key]


def _outs(results, key):
    from nislam_torch.core.slam import unpack_step_output

    return unpack_step_output(_both(results, key))


def _wrapped(d):
    d = np.array(d)
    d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return np.abs(d).max()


def _decisions_equal(got, want, what):
    for name in DECISIONS:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=f"{what}: {name}")


def test_distributed_engine_matches_jax_and_single(engines):
    results, ref, ref_outs = engines.results, engines.ref, engines.ref_outs
    js, jo = engines.jax["distributed"].result()

    got = _outs(results, "engine_outs")
    assert int(got.loop_found.sum()) >= 1 and int(_both(results, "engine_solves")) >= 1
    _decisions_equal(got, jo, "vs JAX's distributed engine")
    assert _wrapped(got.pose - jo.pose) <= POSE_ATOL
    np.testing.assert_allclose(got.response[1:], jo.response[1:], rtol=5e-4)
    k = int(_both(results, "engine_count"))
    assert k == int(js.bank.count) == int(ref.bank.count)
    assert _wrapped(_both(results, "engine_poses")[:k] - np.asarray(js.bank.poses)[:k]) <= POSE_ATOL

    _decisions_equal(got, ref_outs, "vs the torch single engine")
    assert _wrapped(got.pose - ref_outs.pose) <= 5e-3
    assert _wrapped(_both(results, "engine_poses")[:k] - ref.bank.poses.numpy()[:k]) <= 5e-3
    # gather(): the sharded blocks make the single engine's bank, bit for bit
    for name in ("fft", "filt_polar", "images"):
        np.testing.assert_array_equal(_both(results, f"engine_{name}"), getattr(ref.bank, name).numpy(),
                                      err_msg=name)


def test_distributed_chunk_graph_equals_track_graph_path(engines):
    """The distributed engine's chunk graph (its plain program: the track
    graph alone, the branch on the host at each frame that inserts)
    against the track-graph path on each rank: outputs, solve tallies and
    every state leaf bit for bit; one host exit per inserting frame, none
    early; the lent state keeps the rank's ``shard_base``; ``step``
    likewise, frame by frame."""
    from nislam_torch.core.slam import unpack_step_output

    for r, rank in enumerate(engines.results()):
        assert rank["engine_outs"].tobytes() == rank["track_outs"].tobytes(), f"rank {r}"
        np.testing.assert_array_equal(rank["engine_tally"], rank["track_tally"], err_msg=f"rank {r}")
        assert rank["engine_leaves"].tobytes() == rank["track_leaves"].tobytes(), f"rank {r}"
        assert rank["engine_tally"].any(), f"rank {r}: no solve"
        inserted = unpack_step_output(rank["engine_outs"]).inserted
        assert rank["engine_exits"].tolist() == [int(inserted[1:].sum()), 0], f"rank {r}"
        assert int(rank["engine_shard_base"]) == r * 32, f"rank {r}"
        assert rank["step_outs"].tobytes() == rank["step_track_outs"].tobytes(), f"rank {r}: step"
        assert rank["step_leaves"].tobytes() == rank["step_track_leaves"].tobytes(), f"rank {r}: step"
        assert int(rank["step_exits"]) == int(unpack_step_output(rank["step_outs"]).inserted[1:].sum()) > 0


@pytest.mark.parametrize("online", (0, 1), ids=("map", "online canvas"))
def test_distributed_trigger_program_equals_host_loop(engines, online):
    """At 2 gloo ranks, on each hand-made map (0, 1, 2 with one voided, 4
    with one voided, 2 live before stale entries), ``optimize`` and
    ``finalize`` through the trigger program (the pending edges, the GN-CG
    solve and the masked sharded recompute on the device, the host making
    the all-reduces) against the host loop on each rank, bit for bit: the
    decision, every state leaf, the all-reduces by payload (the same on
    both ranks)."""
    for r, rank in enumerate(engines.results()):
        for case in TRIGGER_CASES:
            for entry in ("optimize", "finalize"):
                key = f"trig_{case}_{online}_{entry}"
                ran = bool(rank[f"{key}_program_ran"])
                assert ran == bool(rank[f"{key}_host_ran"]) == (case in ("run", "stale")), (r, key)
                assert rank[f"{key}_program_leaves"].tobytes() == rank[f"{key}_host_leaves"].tobytes(), (r, key)
                np.testing.assert_array_equal(rank[f"{key}_program_counts"], rank[f"{key}_host_counts"],
                                              err_msg=f"rank {r}: {key}")
                if ran:
                    assert rank[f"{key}_program_counts"][:, 2].sum() > 20, (r, key)  # the GN-CG's all-reduces
    for case in TRIGGER_CASES:  # the collectives' count and payloads: the same on both ranks
        _both(engines.results, f"trig_{case}_{online}_optimize_program_counts")


@pytest.mark.parametrize("name", ("below", "wrapped"), ids=("below capacity", "ring wrapped"))
def test_distributed_masked_recompute_equals_count_read(engines, name):
    """At 2 gloo ranks, ``ShardedCanvas``' staged recompute (each rank's
    block masked by ``slot < count`` on the device, the delta's
    all-reduce, the copy) against the count-read ``recompute``, bit for
    bit on both ranks, with the bank below capacity (13 of 24 slots: rank
    1 holds one live slot) and with the ring wrapped (every slot live)."""
    masked = _both_bits(engines.results, f"recompute_{name}_masked")
    want = _both_bits(engines.results, f"recompute_{name}_count_read")
    assert masked.tobytes() == want.tobytes() and masked[1].sum() > 0


def test_distributed_online_canvas_matches_jax(engines):
    """The online stitcher on the sharded bank: JAX's decisions, a canvas
    bit-equal on both ranks that holds JAX's pixels and intensity, equal
    to a fresh recompute of the final bank, and one collective per
    eviction and per recompute."""
    results = engines.results
    js, jo = engines.jax["canvas"].result()

    got = _outs(results, "canvas_outs")
    _decisions_equal(got, jo, "online canvas, vs JAX's distributed engine")
    assert _wrapped(got.pose - jo.pose) <= POSE_ATOL
    k, evictions = int(_both(results, "canvas_count")), int(_both(results, "canvas_overflow"))
    solves = int(_both(results, "canvas_solves"))
    assert k == int(js.bank.count) and evictions == int(js.bank.overflow) > 0 and solves >= 1
    assert int(got.loop_found.sum()) >= 1
    data, weight = _both_bits(results, "canvas_data"), _both_bits(results, "canvas_weight")
    jdata, jweight = np.asarray(js.canvas.data), np.asarray(js.canvas.weight)
    # Every frame lands inside the canvas: each live keyframe's pixels once.
    assert weight.sum(dtype=np.float64) == jweight.sum(dtype=np.float64) == k * H * W
    total = jdata.sum(dtype=np.float64)
    assert abs(data.sum(dtype=np.float64) - total) <= CANVAS_RTOL * total
    np.testing.assert_array_equal(_both_bits(results, "canvas_fresh_weight"), weight)
    fresh = _both_bits(results, "canvas_fresh_data")
    assert np.abs(fresh - data).max() <= 1e-5 * np.abs(fresh).max() + 1e-3
    assert int(_both(results, "canvas_retires")) == evictions
    assert int(_both(results, "canvas_recomputes")) == solves


def test_distributed_staged_branch_with_canvas_equals_track_graph_path(engines):
    """The online canvas over a ring that evicts, on each of the 2 ranks:
    the chunk graph with its keyframe branch as captured steps (their
    plain program: filters and the staged eviction, the evicted slot's
    read and the image's all-reduce, the insert and the search's local
    part, the record's all-reduce, the merge) against the track-graph
    path (the eager branch): outputs, solve tallies, every state leaf and
    the all-reduces by payload bit for bit; the stored kind's three steps
    made once, run once per stored keyframe's host exit."""
    from nislam_torch.core.slam import unpack_step_output

    for r, rank in enumerate(engines.results()):
        assert rank["canvas_outs"].tobytes() == rank["canvas_track_outs"].tobytes(), f"rank {r}"
        np.testing.assert_array_equal(rank["canvas_tally"], rank["canvas_track_tally"], err_msg=f"rank {r}")
        assert rank["canvas_leaves"].tobytes() == rank["canvas_track_leaves"].tobytes(), f"rank {r}"
        np.testing.assert_array_equal(rank["canvas_counts"], rank["canvas_track_counts"], err_msg=f"rank {r}")
        o = unpack_step_output(rank["canvas_outs"])
        stored = int(((o.keyframe_slot >= 0) & o.inserted)[1:].sum())
        assert rank["canvas_programs"].tolist() == [[1, 3, stored]] and int(rank["canvas_exits"]) == stored > 0
        assert int(rank["canvas_overflow"]) > 0, f"rank {r}: the ring never evicted"


def test_checkpoint_resumes_into_place_and_fleet_lane(engines):
    """A single-engine checkpoint after 32 frames, resumed into the sharded
    engine's ``place()`` and into both fleet lanes, continues the
    uninterrupted run."""
    results, ref, ref_outs = engines.results, engines.ref, engines.ref_outs
    k = int(ref.bank.count)
    for key in ("resume", "resume_fleet"):
        got = _outs(results, f"{key}_outs")
        lanes = [got] if key == "resume" else [type(got)(*(f[b] for f in got)) for b in range(2)]
        poses = _both(results, f"{key}_poses")
        for lane in lanes:
            np.testing.assert_array_equal(lane.inserted, ref_outs.inserted[32:], err_msg=key)
            np.testing.assert_array_equal(lane.loop_found, ref_outs.loop_found[32:], err_msg=key)
            assert _wrapped(lane.pose - ref_outs.pose[32:]) <= 5e-3, key
        assert _wrapped(poses[:k] - ref.bank.poses.numpy()[:k]) <= 5e-3, key


@pytest.mark.parametrize("mode", ["deferred", "inline"])
def test_fleet_matches_jax_fleet(engines, mode):
    results = engines.results
    js, jo = engines.jax[mode].result()

    key = "fleet" if mode == "deferred" else "inline"
    got = _outs(results, f"{key}_outs")
    _decisions_equal(got, jo, f"{mode} fleet vs JAX")
    np.testing.assert_array_equal(got.optimized, jo.optimized)
    assert _wrapped(got.pose - jo.pose) <= POSE_ATOL
    if mode == "deferred":
        assert int(got.loop_found.sum()) > 0
    else:
        assert int(got.optimized.sum()) > 0  # inline solves fired mid-sequence
    for r, rank in enumerate(results()):  # each rank's own lane state
        k = int(np.asarray(js.bank.count)[r])
        assert _wrapped(rank[f"{key}_poses"][:k] - np.asarray(js.bank.poses)[r, :k]) <= POSE_ATOL


def test_batch_engine_group_matches_jax(engines):
    """4 lanes over 2 ranks (lanes 0–1 on rank 0, 2–3 on rank 1) against
    JAX's batch engine with its lanes on a 2-device ``data`` mesh."""
    results = engines.results
    js, jo = engines.jax["batch"].result()

    got = _outs(results, "batch_outs")
    assert got.pose.shape == (4, 48, 3) and int(got.loop_found.sum()) >= 4
    _decisions_equal(got, jo, "batch lanes over 2 ranks vs JAX")
    assert _wrapped(got.pose - jo.pose) <= POSE_ATOL
    jposes = np.asarray(js.bank.poses)
    for r, rank in enumerate(results()):
        assert _wrapped(rank["batch_poses"] - jposes[2 * r:2 * r + 2]) <= POSE_ATOL


def test_batch_engine_group_graph_equals_eager(engines):
    """The same 4 lanes over 2 ranks through the batch engine's graphs and
    through its kept eager loop: outputs, solve tallies and every state
    leaf equal bit for bit on each rank; a frame makes no collective."""
    results = engines.results
    np.testing.assert_array_equal(_both_bits(results, "batch_outs"), _both_bits(results, "batch_eager_outs"))
    for r, rank in enumerate(results()):
        np.testing.assert_array_equal(rank["batch_tally"], rank["batch_eager_tally"], err_msg=f"rank {r}")
        assert rank["batch_leaves"].tobytes() == rank["batch_eager_leaves"].tobytes(), f"rank {r}"
        assert rank["batch_tally"].any(), f"rank {r}: no solve"


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
