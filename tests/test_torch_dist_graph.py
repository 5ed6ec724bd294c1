"""The distributed engine's graphs (``nislam_torch.parallel``) at one rank, on the CPU.

One rank in this process, through a stub group whose ``all_reduce``
counts the call and returns its input (the sum over one rank): the
engine's own code with every collective where it is at n ranks.  On the
CPU the captured steps run eagerly on their buffers: the plain program.

- ``CGGraph`` (``parallel/solver.py``: the GN-CG solve's local work as
  steps between the collectives) against the eager
  ``solve_pose_graph_cg`` bit for bit: poses, cost and the all-reduces
  by payload (so the CG iterations), on a graph of the flagship's shape
  (272 slots, 74 live, 1024 edge slots, a chain and 17 loop edges) and
  on ``chain_problem(64, 256)``; a second solve of other values through
  the same program.  At 2 and 4 gloo ranks: ``tests/test_torch_parallel.py``;
- the distributed engine's ``run_chunk`` through the chunk graph's plain
  program (the track graph alone; each frame that inserts stops the
  launch and runs its keyframe branch as the steps of a ``StagedBranch``,
  the host making the search's and the canvas's collectives between
  them: their plain program here) against the track-graph path
  (``run_chunk_track_graph``, the eager branch with the plug points), bit
  for bit: outputs, solve tallies, every state leaf and the all-reduces
  by payload, on the golden workload and with the online canvas over a
  ring that evicts; one host exit per inserting frame, no early exit, no
  graph made for the other path, the deferred trigger through the host
  loop with GN-CG (no solve graph);
- each branch kind's steps made once (a stored keyframe's: the steps
  between the record's all-reduce and, with the canvas, the image's), its
  runs the host exits of its kind;
- a record whose frame id an all-reduce changed raises "ranks diverged"
  before any later collective, in ``run_chunk`` (at the next launch's
  read) and in ``step`` (at the read after the branch);
- ``step`` against the track-graph path frame by frame, the deferred
  trigger after every frame;
- the lent-state rule for the distributed engine's placed state: a
  sharded bank's ``shard_base`` kept in a lent state and checked by
  ``FrameGraph.load``;
- ``launch_counts`` within a named host range, on a hand-made trace;
- on a card (``gpu`` marker, skipped here): the same bits, the chunk
  graph's host syncs one per launch (one more when a chunk ends with a
  branch) and its launches one more than the host exits, the branch's
  steps replayed once per host exit of their kind, its host launch calls
  per inserting frame (a profiled chunk) at most 10, and ``CGGraph``
  against the eager solve.

The 2-rank engine cases run in ``tests/test_torch_parallel.py``.  This
file imports no JAX, so its ``gpu`` cases run on a card without it
(``--noconftest``).
"""

import dataclasses
import json
import types
import warnings

import numpy as np
import pytest
import torch

from nislam_torch.core import config as tconfig
from nislam_torch.core.pose_graph import PoseGraphProblem
from nislam_torch.core.slam import (
    _live_pending_count, pack_outputs, run_chunk_track_graph, state_leaves, unpack_step_output,
)
from nislam_torch.parallel.engine import make_distributed_engine
from nislam_torch.parallel.loop_search import RECORD
from nislam_torch.parallel.mesh import RankGroup
from nislam_torch.parallel.solver import CGGraph, CGSolverConfig, solve_pose_graph_cg
from nislam_torch.utils.profiling import launch_counts
from nislam_torch.utils.scaling import chain_problem
from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

torch.set_num_threads(1)  # see test_torch_engine.py

CPU = torch.device("cpu")
H, W = 96, 128


class OneRank(RankGroup):
    """A group of one rank with no process group: each ``all_reduce`` is
    counted and returns its input, the sum over one rank."""

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self._record("all_reduce", t)
        return t


def one_rank(device=CPU) -> OneRank:
    return OneRank(rank=0, size=1, axis="bank", device=torch.device(device))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


def _assert_states_equal(a, b) -> None:
    for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b), strict=True)):
        assert _same_bits(x, y), f"state leaf {i}"


# ---------------------------------------------------------------------------
# The GN-CG solve
# ---------------------------------------------------------------------------


def flagship_shaped_problem(seed: int = 0, device=CPU) -> PoseGraphProblem:
    """A graph of the flagship's final shape: 272 slots of which 74 live
    (the rest hold values that must come back untouched), 1024 edge slots
    holding the odometry chain and 17 loop edges, each with its own
    information."""
    k, live, e, loops = 272, 74, 1024, 17
    rng = np.random.default_rng(seed)
    chain = chain_problem(live, live - 1, seed=seed)
    poses = rng.uniform(-1.0, 1.0, (k, 3)).astype(np.float32)
    poses[:live] = chain.poses.numpy() + rng.normal(0.0, 0.05, (live, 3)).astype(np.float32)
    fr = np.zeros(e, np.int32)
    to = np.zeros(e, np.int32)
    fr[:live - 1], to[:live - 1] = chain.from_slot.numpy()[:live - 1], chain.to_slot.numpy()[:live - 1]
    a = rng.choice(live - 10, loops, replace=False)
    fr[live - 1:live - 1 + loops], to[live - 1:live - 1 + loops] = a, a + rng.integers(5, 10, loops)
    used = live - 1 + loops
    gt = chain.poses.numpy().astype(np.float64)
    T = rng.normal(0.0, 0.3, (e, 3)).astype(np.float32)
    T[:live - 1] = chain.T.numpy()[:live - 1]
    for i in range(live - 1, used):  # the loops' measurements from the chain's poses
        pa, pb = gt[fr[i]], gt[to[i]]
        c, s = np.cos(pa[2]), np.sin(pa[2])
        d = pb[:2] - pa[:2]
        T[i] = (c * d[0] + s * d[1], -s * d[0] + c * d[1], (pb[2] - pa[2] + np.pi) % (2 * np.pi) - np.pi)
    info = np.tile(np.eye(3, dtype=np.float32), (e, 1, 1)) * rng.uniform(0.5, 2.0, (e, 1, 1)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return PoseGraphProblem(poses=t(poses), pose_mask=t(np.arange(k) < live), from_slot=t(fr), to_slot=t(to),
                            T=t(T), sqrt_info=t(np.sqrt(info)), edge_mask=t(np.arange(e) < used))


PROBLEMS = {"flagship shape": flagship_shaped_problem, "chain": lambda seed=0, device=CPU: chain_problem(
    64, 256, seed=seed, device=device)}


def _solve_both(prob, group, graph):
    """The eager solve and ``graph``'s, each → (poses, cost, all-reduces by payload)."""
    out = []
    for solve in (lambda p: solve_pose_graph_cg(p, group, graph.cfg), graph):
        before = group.counts.copy()
        poses, cost = solve(prob)
        out.append((poses, cost, group.counts - before))
    return out


@pytest.mark.parametrize("name", PROBLEMS)
def test_cg_graph_equals_eager_solve(name):
    """The graph program's plain steps give the eager solve's bits: poses,
    cost and every all-reduce (one per Gauss-Newton step, one per CG
    iteration, the cost), twice through one program."""
    group = one_rank()
    graph = CGGraph(group, CGSolverConfig())
    for seed in (0, 1):
        prob = PROBLEMS[name](seed=seed)
        (ep, ec, en), (gp, gc, gn) = _solve_both(prob, group, graph)
        assert _same_bits(gp, ep) and _same_bits(gc, ec) and gn == en, (name, seed)
        k = prob.poses.shape[0]
        calls = {nbytes: n for (_, nbytes), n in en.items()}
        assert calls[2 * k * 3 * 4] == CGSolverConfig().outer_iterations and calls[4] == 1
        assert graph.cg_iterations == calls[k * 3 * 4] > 0
        dead = ~prob.pose_mask
        assert _same_bits(gp[dead], prob.poses[dead]) and _same_bits(gp[0], prob.poses[0])
    assert len(graph._programs) == 1  # one shape, one program


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _config(name: str):
    """The golden 96×128 config (``tests/test_torch_engine.py``'s), or
    with the online canvas over a ring of 40 slots that evicts."""
    c = tconfig
    config = c.SlamConfig(
        cf=c.CFConfig(width=W, height=H, rotation_divisor=360, rotation_channel=96),
        keyframe_selection=c.KeyframeSelectionConfig(
            max_distance=0.10, max_angle=0.05, lower_response_thr=4.0, upper_response_thr=6.0),
        map=c.MapConfig(grid_scale=0.15, keyframe_capacity=128, edge_capacity=512),
        loop_closure=c.LoopClosureConfig(to_find_loop=True, position_response_thr=8.0, angle_response_thr=8.0,
                                         frame_gap_thr=30, distance_thr=1.0, max_candidates=8),
        camera=c.CameraConfig(image_width=W, image_height=H, height=1.0, intrinsics=(100.0, W / 2.0, 100.0, H / 2.0)),
    )
    if name == "online":
        config = dataclasses.replace(
            config, map=dataclasses.replace(config.map, keyframe_capacity=40),
            map_stitcher=dataclasses.replace(config.map_stitcher, online=True, canvas_size=1024))
    return config


WORKLOADS = ("golden", "online")


def _frames(name: str) -> np.ndarray:
    """The golden frames (100), or 120 that come back over the start."""
    world = make_world(1024, 3.0, seed=1234)
    path = heading_loop_path(100, step=5.5, tail=10) if name == "golden" else heading_loop_path(120, step=5.5, tail=30)
    return render_sequence(world, H, W, path)


class TrackGraphEngine:
    """``engine`` with the track-graph path (``run_chunk_track_graph``) in
    place of its chunk graph."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def run_chunk(self, state, images):
        return run_chunk_track_graph(self.engine, state, images)

    def run_sequence(self, *args, **kwargs):
        return type(self.engine).run_sequence(self, *args, **kwargs)


def _run(engine, frames, chunk: int = 32):
    """``run_sequence`` + ``finalize`` → (state, packed outputs, solve tally)."""
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), frames, chunk_frames=chunk, solve_tally=tally)
    state, ran = engine.finalize(state)
    return state, pack_outputs(outs), tally + [ran]


@pytest.fixture(scope="module", params=WORKLOADS)
def runs(request):
    """One workload through the distributed engine's chunk graph and the
    track-graph path, each on an engine of its own at one rank."""
    config, frames = _config(request.param), _frames(request.param)
    res = {}
    for label, wrap in (("chunk graph", lambda e: e), ("track graph", TrackGraphEngine)):
        group = one_rank()
        engine = make_distributed_engine(config, group)
        res[label] = (engine, group, *_run(wrap(engine), frames))
    return types.SimpleNamespace(name=request.param, frames=frames, res=res)


def test_chunk_graph_equals_track_graph_path(runs):
    """Bit for bit: outputs, solve tallies, every state leaf; loops found
    and solved by GN-CG (its all-reduces counted), with no solve graph."""
    engine, group, state, outs, tally = runs.res["chunk graph"]
    ref_engine, ref_group, ref_state, ref_outs, ref_tally = runs.res["track graph"]
    assert outs.tobytes() == ref_outs.tobytes()
    assert tally == ref_tally and any(tally)
    _assert_states_equal(state, ref_state)
    assert engine.branch_on_host and not engine.uses_solve_graph and isinstance(engine.solver_fn, CGGraph)
    assert engine.chunk_graph.built and engine._track_graph is None and engine._solve_graph is None
    assert ref_engine._frame_graph is None and ref_engine._track_graph is not None
    k = engine.config.map.keyframe_capacity
    assert group.counts[("all_reduce", k * 3 * 4)] > 0 and group.counts == ref_group.counts
    if runs.name == "online":
        assert int(state.bank.overflow) > 0  # the ring evicted, and the canvas retired them


def test_host_exits_are_the_inserting_frames(runs):
    """One host exit per tracked frame that inserts (the first frame is
    the eager init), none early."""
    engine, _, _, outs, _ = runs.res["chunk graph"]
    inserted = unpack_step_output(outs).inserted
    chunk = engine.chunk_graph
    assert chunk.host_exits == int(inserted[1:].sum()) > 0 and chunk.early_exits == 0
    assert not engine.frame_graph.branch_slots()  # the branch is never captured whole


def test_branch_steps_are_made_once(runs):
    """Each branch kind's steps are made at its first use and kept: a
    stored keyframe's are the steps between its collectives (the record's
    all-reduce; with the canvas over a ring, the evicted image's before
    it); its runs are the host exits of its kind, and a further chunk
    makes no step."""
    engine, _, state, outs, _ = runs.res["chunk graph"]
    fg = engine.frame_graph
    progs = dict(fg.programs)
    o = unpack_step_output(outs)
    stored = int(((o.keyframe_slot >= 0) & o.inserted)[1:].sum())
    assert {k: p.runs for k, p in progs.items()} == {True: stored} and stored == engine.chunk_graph.host_exits
    assert len(progs[True].steps) == (3 if runs.name == "online" else 2)
    steps = [s for p in progs.values() for s in p.steps]
    engine.run_chunk(state, runs.frames[:24])
    assert fg.programs == progs and [s for p in fg.programs.values() for s in p.steps] == steps


class Corrupting(OneRank):
    """:class:`OneRank` whose ``corrupt``-th all-reduce of a winner record
    (RECORD floats) adds one to its frame id, as a rank that searched for
    another frame would leave it; counts every collective after it."""

    def __init__(self, corrupt: int, **kw):
        super().__init__(**kw)
        self.corrupt, self.records, self.after = corrupt, 0, 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.records >= self.corrupt:
            self.after += 1
        if t.numel() == RECORD:
            self.records += 1
            if self.records == self.corrupt:
                t[:, 10] += 1.0
        return super().all_reduce(t)


@pytest.mark.parametrize("mode", ("run_chunk", "step"))
def test_diverged_record_raises_before_any_later_collective(mode):
    """A record whose frame id the all-reduce changed (the ranks searched
    for different frames) raises "ranks diverged" before the host makes
    any later collective (the next search's all-reduce, the deferred
    trigger's GN-CG): in ``run_chunk`` at the read after the next launch,
    in ``step`` at the read after the branch (a step is a chunk of one,
    which ends with its branch)."""
    config, frames = _config("golden"), _frames("golden")
    # In step mode the 60th search is frame 92's, whose match makes the
    # first trigger solve: the GN-CG's all-reduces would come next.
    group = Corrupting(corrupt=3 if mode == "run_chunk" else 60, rank=0, size=1, axis="bank", device=CPU)
    engine = make_distributed_engine(config, group)
    state = engine.init_state()
    with pytest.raises(RuntimeError, match="ranks diverged"):
        if mode == "run_chunk":
            engine.run_sequence(state, frames, chunk_frames=32)
        else:
            for frame in frames:
                state, _ = engine.step(state, torch.from_numpy(frame))
                state, _ = engine.optimize(state)
    assert group.records == group.corrupt and group.after == 0
    if mode == "step":
        assert int(_live_pending_count(engine.frame_graph.state.pending)) >= 2


def test_step_equals_track_graph_path():
    """``step`` (a chunk of one through the chunk graph) against the
    track-graph path frame by frame, the deferred trigger after every
    frame: outputs and every state leaf bit for bit."""
    config, frames = _config("golden"), _frames("golden")
    engine, ref = make_distributed_engine(config, one_rank()), make_distributed_engine(config, one_rank())
    gs, rs = engine.init_state(), ref.init_state()
    ran_any = False
    for frame in frames:
        gs, g = engine.step_packed(gs, torch.from_numpy(frame))
        rs, r = run_chunk_track_graph(ref, rs, frame[None])
        assert _same_bits(g, r.pack()[0])
        gs, ran = engine.optimize(gs)
        rs, ran_ref = ref.optimize(rs)
        assert ran == ran_ref
        ran_any |= ran
    _assert_states_equal(gs, rs)
    assert ran_any and engine.chunk_graph.host_exits > 0 and engine._track_graph is None


def test_lent_state_rule():
    """A run lends the graph's buffers (the bank's ``shard_base`` kept),
    passing the state back consumes it, a kept state does not change
    under a later run, and a state of another block is refused."""
    config, frames = _config("golden"), _frames("golden")
    engine = make_distributed_engine(config, one_rank())
    first, _ = engine.run_chunk(engine.init_state(), frames[:32])
    buffers = state_leaves(engine.frame_graph.state)
    assert all(x is y for x, y in zip(state_leaves(first), buffers, strict=True))
    assert "shard_base" in vars(first.bank) and first.bank.shard_base == 0
    again, _ = engine.run_chunk(first, frames[32:48])
    assert again is first and "shard_base" in vars(again.bank)
    kept = [x.clone() for x in state_leaves(first)]
    other, _ = engine.run_chunk(engine.init_state(), frames[:40])
    assert other is not first
    assert all(_same_bits(x, y) for x, y in zip(state_leaves(first), kept, strict=True))
    moved = engine.init_state()
    moved.bank.shard_base = 64
    with pytest.raises(ValueError, match="shard_base"):
        engine.run_chunk(moved, frames[:2])


def test_launch_counts_within_a_range(tmp_path):
    """The launch calls inside the host ranges of one name, on their own
    thread; the ranges counted."""
    def x(cat, name, ts, dur=1.0, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}

    events = [
        x("user_annotation", "branch", 10.0, 10.0), x("user_annotation", "branch", 40.0, 5.0),
        x("cuda_runtime", "cudaLaunchKernel", 0.0), x("cuda_runtime", "cudaGraphLaunch", 12.0),
        x("cuda_driver", "cuLaunchKernel", 19.0), x("cuda_runtime", "cudaLaunchKernel", 15.0, tid=2),
        x("cuda_runtime", "cudaGraphLaunch", 30.0), x("cuda_runtime", "cudaLaunchKernel", 44.0),
        x("kernel", "k", 50.0),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert launch_counts(str(path), within="branch") == {"kernel_launches": 2, "graph_launches": 1,
                                                        "host_launches": 3, "kernels": 1, "ranges": 2}
    assert launch_counts(str(path))["host_launches"] == 6


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured only on a card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", PROBLEMS)
def test_cg_graph_on_the_card(cuda, name):
    """The captured steps against the eager solve on the card, bit for
    bit, twice through one program (the second all replays)."""
    group = one_rank(cuda)
    graph = CGGraph(group, CGSolverConfig())
    for seed in (0, 1):
        (ep, ec, en), (gp, gc, gn) = _solve_both(PROBLEMS[name](seed=seed, device=cuda), group, graph)
        assert _same_bits(gp, ep) and _same_bits(gc, ec) and gn == en, (name, seed)
    assert all(step.captured for step in graph._programs[next(iter(graph._programs))].steps.values())


@pytest.mark.gpu
def test_engine_paths_on_the_card(cuda, tmp_path):
    """The chunk graph with its staged branch against the track-graph path
    on the card, bit for bit (outputs, tallies, every leaf, all-reduces by
    payload); one host read per launch and one after a chunk that ends
    with a branch (sync debug mode), one launch more per chunk than its
    host exits unless its last frame inserts; each branch step replayed
    once per host exit of its kind after its capture; at most 10 host
    launch calls per inserting frame's branch in a profiled chunk."""
    from nislam_torch.core.chunk_graph import ChunkGraph
    from nislam_torch.core.frame_graph import HostBranchFrameGraph
    from nislam_torch.utils.profiling import trace

    config, frames = _config("golden"), torch.from_numpy(_frames("golden")).to(cuda)
    group, ref_group = one_rank(cuda), one_rank(cuda)
    engine, ref = make_distributed_engine(config, group), make_distributed_engine(config, ref_group)
    _run(engine, frames)  # captures
    _run(TrackGraphEngine(ref), frames)
    fg = engine.frame_graph
    runs, replays = fg.programs[True].runs, [s.replays for s in fg.programs[True].steps]
    before, ref_before = group.counts.copy(), ref_group.counts.copy()
    gs, go, gt = _run(engine, frames)
    rs, ro, rt = _run(TrackGraphEngine(ref), frames)
    assert go.tobytes() == ro.tobytes() and gt == rt
    _assert_states_equal(gs, rs)
    assert group.counts - before == ref_group.counts - ref_before
    runs = fg.programs[True].runs - runs
    assert runs > 0 and [s.replays - r for s, r in zip(fg.programs[True].steps, replays)] == [runs] * len(replays)
    state, _ = engine.run_chunk(engine.init_state(), frames[:32])
    exits, launches = engine.chunk_graph.host_exits, ChunkGraph.launches
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, outs = engine.run_chunk(state, frames[32:64])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) and "prototype" not in str(w.message) for w in seen)
    exits, launches = engine.chunk_graph.host_exits - exits, ChunkGraph.launches - launches
    last_inserts = bool(outs.inserted[-1])
    assert launches == exits + 1 - int(last_inserts) and exits == int(outs.inserted.sum())
    assert syncs == launches + int(last_inserts)  # the reads after the launches, the check after a last branch

    real = HostBranchFrameGraph.finish

    def marked(self, *args):
        with torch.profiler.record_function("nislam::host_branch"):
            real(self, *args)

    state, _ = engine.run_chunk(engine.init_state(), frames[:32])
    HostBranchFrameGraph.finish = marked
    try:
        with trace(str(tmp_path)):
            _, outs = engine.run_chunk(state, frames[32:64])
            torch.cuda.synchronize()
    finally:
        HostBranchFrameGraph.finish = real
    counts = launch_counts(str(tmp_path / "trace.json"), within="nislam::host_branch")
    assert counts["ranges"] == int(outs.inserted.sum()) > 0
    assert counts["host_launches"] <= 10 * counts["ranges"], counts

