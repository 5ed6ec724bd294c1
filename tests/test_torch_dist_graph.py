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
  graph made for the other path, the deferred trigger through the
  engine's trigger program (no solve graph);
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
- the deferred trigger's program (``CGTrigger``: the trigger, the masked
  pending-edge loop, the GN-CG steps, the finish and the masked sharded
  recompute; its plain program here, the host making the all-reduces)
  against the host loop (``optimize_host_loop``, ``finalize_host_loop``)
  bit for bit on ``tests/test_torch_solve_graph.py``'s hand-made maps (0,
  1 and ≥ 2 live pending matches, a voided match, stale entries), with
  and without the online canvas: every leaf, the decision, the
  all-reduces by payload, the CG iterations; no host read but the
  program's own (the run flag, ‖r‖² per CG check); the
  ``cg_step`` kernel's plain version against the host's stop test at the
  float32 values next to ``cg_tol ** 2``; the masked sharded recompute
  against the count-read one; ``stagebench --solve``'s trigger row;
- on a card (``gpu`` marker, skipped here): the same bits, the chunk
  graph's host syncs one per launch (one more when a chunk ends with a
  branch) and its launches one more than the host exits, the branch's
  steps replayed once per host exit of their kind, its host launch calls
  per inserting frame (a profiled chunk) at most 10, and ``CGGraph``
  against the eager solve; ``cg_step`` against its plain version; at one
  NCCL rank the trigger program as one launch and one host read per
  trigger, bit for bit with the host-loop trigger.

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
    _live_pending_count, finalize_host_loop, optimize_host_loop, pack_outputs, run_chunk_track_graph, state_leaves,
    unpack_step_output,
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
    and solved by GN-CG (its all-reduces counted), with no solve graph.
    The track-graph path makes no chunk graph; its triggers run the same
    trigger program, over the frame graph's buffers."""
    engine, group, state, outs, tally = runs.res["chunk graph"]
    ref_engine, ref_group, ref_state, ref_outs, ref_tally = runs.res["track graph"]
    assert outs.tobytes() == ref_outs.tobytes()
    assert tally == ref_tally and any(tally)
    _assert_states_equal(state, ref_state)
    assert engine.branch_on_host and not engine.uses_solve_graph and isinstance(engine.solver_fn, CGGraph)
    assert engine.chunk_graph.built and engine._track_graph is None and engine._solve_graph is None
    assert ref_engine._chunk_graph is None and ref_engine._track_graph is not None
    assert ref_engine._trigger_program is not None and ref_engine._frame_graph is not None
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


class CorruptingInGraph(Corrupting):
    """:class:`Corrupting` on a group whose all-reduces a graph holds (a
    card's peer kernel): the keyframe branch runs inside the chunk graph;
    the payload bytes of every collective after the corrupted one are
    kept."""

    capturable = True

    def __init__(self, corrupt: int, **kw):
        super().__init__(corrupt, **kw)
        self.later = []

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.records >= self.corrupt:
            self.later.append(t.numel() * t.element_size())
        return super().all_reduce(t)


def test_diverged_record_raises_at_the_graph_routes_read():
    """With the branch inside the chunk graph, a record whose frame id the
    all-reduce changed raises "ranks diverged" at the read after that
    launch (the frame-id word read with the control block), before the
    host launches anything more: the collectives after it are the same
    launch's later searches only, no trigger's."""
    config, frames = _config("golden"), _frames("golden")
    group = CorruptingInGraph(corrupt=3, rank=0, size=1, axis="bank", device=CPU)
    engine = make_distributed_engine(config, group)
    assert not engine.branch_on_host
    with pytest.raises(RuntimeError, match="ranks diverged"):
        engine.run_sequence(engine.init_state(), frames, chunk_frames=32)
    assert group.records >= group.corrupt and set(group.later) <= {RECORD * 4}
    assert engine.chunk_graph.host_exits == 0


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
# The deferred trigger
# ---------------------------------------------------------------------------

# test_torch_solve_graph.py's hand-made maps (24 slots, 64 edges, a ring of
# 20 keyframes): 0, 1, 2 with one voided (1 live), 4 with one voided (3
# live), 2 live before stale entries.
TRIGGER_CASES = ("none", "one", "voided", "run", "stale")
SOLVES = ("run", "stale")


def _trigger_pair(online: bool, case: str, seed: int = 0):
    """Two distributed engines at one stub rank (the program's, the host
    loop's) and one hand-made state for each, bit for bit the same."""
    from test_torch_solve_graph import N_KF, _config as solve_config, _fill

    config = solve_config(online=online)
    out = []
    for _ in range(2):
        group = one_rank()
        engine = make_distributed_engine(config, group)
        state = engine.init_state()
        _fill(state, engine.camera, case, seed)
        images = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, state.bank.images[:N_KF].shape))
        state.bank.images[:N_KF] = images.to(state.bank.images.dtype)
        out.append((engine, group, state))
    return out


@pytest.mark.parametrize("online", (False, True), ids=("map", "online canvas"))
@pytest.mark.parametrize("case", TRIGGER_CASES)
def test_trigger_program_equals_host_loop(case, online):
    """``optimize`` and ``finalize`` through the trigger program (its plain
    program here: the trigger, the masked pending-edge loop, the GN-CG
    steps between the all-reduces, the finish and the masked sharded
    recompute) against the host loop (``optimize_host_loop``,
    ``finalize_host_loop``) bit for bit: the decision, every state leaf
    (edge store, poses, canvas, chain, pending buffer), the all-reduces by
    payload and the CG iterations."""
    for entry, host in (("optimize", optimize_host_loop), ("finalize", finalize_host_loop)):
        (engine, group, state), (ref, ref_group, ref_state) = _trigger_pair(online, case)
        got, ran = getattr(engine, entry)(state)
        want, ran_ref = host(ref, ref_state)
        assert ran == ran_ref == (case in SOLVES), (entry, ran, ran_ref)
        _assert_states_equal(got, want)
        assert group.counts == ref_group.counts, (entry, dict(group.counts), dict(ref_group.counts))
        assert engine._solve_graph is None and not engine.trigger_program.built
        if ran:
            k = engine.config.map.keyframe_capacity
            assert engine.trigger_program.cg_iterations == ref.solver_fn.cg_iterations \
                == group.counts[("all_reduce", k * 3 * 4)] > 0
            assert (group.counts[("all_reduce", 2 * engine.config.map_stitcher.canvas_size ** 2 * 4)] == 1) == online
        if entry == "finalize":
            assert int(got.pending.count) == 0


@pytest.mark.parametrize("online", (False, True), ids=("map", "online canvas"))
@pytest.mark.parametrize("case", ("none", "run"))
def test_trigger_makes_no_host_read_but_its_own(monkeypatch, case, online):
    """The trigger program's ``optimize`` and ``finalize`` on the state the
    engine lent, with every host read refused but the program's own
    (``CGTrigger.read``): the run flag once, then on this route (the host
    makes the collectives, as on gloo) ‖r‖² once per CG check, as
    ``CGGraph`` reads it; no read of the pending count or slots and no
    ``int(bank.count)``.  Bits equal to the host loop's."""
    from nislam_torch.parallel import solver as sv

    (engine, group, state), (ref, _, ref_state) = _trigger_pair(online, case)
    graph = engine.frame_graph
    graph.load(state)
    state = graph.lend(state)
    real_tolist = torch.Tensor.tolist
    reads = []

    def read(words):
        program = engine.trigger_program
        reads.append("r2" if words.data_ptr() == program.b.r2.data_ptr()
                     else (words.data_ptr() - program.ctl.data_ptr()) // 4)
        return real_tolist(words)

    def refused(what):
        def raise_(*args, **kwargs):
            raise AssertionError(f"the trigger called Tensor.{what}")
        return raise_

    with monkeypatch.context() as m:
        for what in ("item", "tolist", "__bool__", "__int__", "__float__", "numpy", "cpu"):
            m.setattr(torch.Tensor, what, refused(what))
        m.setattr(sv.CGTrigger, "read", staticmethod(read))
        state, ran = engine.optimize(state)
        state, ran_final = engine.finalize(state)
    want, ran_ref = optimize_host_loop(ref, ref_state)
    want, _ = finalize_host_loop(ref, want)
    assert ran == ran_ref == (case == "run") and not ran_final
    _assert_states_equal(state, want)
    assert reads[0] == sv.ANY and reads.count(sv.ANY) == 2  # optimize's and finalize's run flags
    checks = [r for r in reads if r != sv.ANY]
    assert set(checks) <= {"r2"}
    cfg = engine.solver_fn.cfg
    iterations = engine.trigger_program.cg_iterations if ran else 0
    assert iterations <= len(checks) <= iterations + cfg.outer_iterations


def test_cg_step_reference_matches_the_host_test():
    """``cg_step_reference``'s CG condition equals the host's ``it <
    cg_iterations and float(r2) > cg_tol ** 2`` at r² the float32 values
    just below, at and just above the double tolerance, and at the
    iteration cap; its Gauss-Newton condition ``gn < outer_iterations``;
    a start zeroes its counter."""
    from nislam_torch.parallel import solver as sv

    cfg = CGSolverConfig(cg_iterations=5, outer_iterations=3)
    tol2 = cfg.cg_tol ** 2
    near = np.float32(tol2)
    values = (np.nextafter(near, np.float32(0)), near, np.nextafter(near, np.float32(1)), np.float32(1.0),
              np.float32(0.0))
    assert float(values[0]) < tol2 < float(values[2])
    for r2 in values:
        for mode, it in ((sv.CG_BEGIN, 7), (sv.CG_STEP, 0), (sv.CG_STEP, 3), (sv.CG_STEP, 4), (sv.CG_STEP, 5)):
            words = torch.zeros(sv.TRIGGER_WORDS, dtype=torch.int32)
            words[sv.CG_IT] = it
            sv.cg_step_reference(words, torch.tensor([r2]), mode, cfg)
            new = 0 if mode == sv.CG_BEGIN else it + 1
            assert int(words[sv.CG_IT]) == new
            assert bool(words[sv.CG_LOOP]) == (new < cfg.cg_iterations and float(r2) > tol2), (r2, mode, it)
    for mode, gn in ((sv.GN_BEGIN, 9), (sv.GN_STEP, 0), (sv.GN_STEP, 1), (sv.GN_STEP, 2)):
        words = torch.zeros(sv.TRIGGER_WORDS, dtype=torch.int32)
        words[sv.GN] = gn
        sv.cg_step_reference(words, torch.zeros(1), mode, cfg)
        new = 0 if mode == sv.GN_BEGIN else gn + 1
        assert int(words[sv.GN]) == new and bool(words[sv.GN_LOOP]) == (new < cfg.outer_iterations)
    with pytest.raises(ValueError, match="mode"):
        sv.cg_step_reference(torch.zeros(sv.TRIGGER_WORDS, dtype=torch.int32), torch.zeros(1), 4, cfg)


@pytest.mark.parametrize("wrapped", (False, True), ids=("below capacity", "ring wrapped"))
def test_masked_sharded_recompute_equals_count_read(wrapped):
    """``ShardedCanvas``' staged recompute (every slot of the block masked
    by ``slot < count`` on the device, the delta's all-reduce, the copy)
    against the count-read ``recompute``, bit for bit, at one rank; the
    2-rank case is in ``tests/test_torch_parallel.py``."""
    from nislam_torch.parallel.engine import ShardedCanvas

    (engine, group, state), _ = _trigger_pair(True, "run")
    rng = np.random.default_rng(3)
    k = engine.config.map.keyframe_capacity
    count = k if wrapped else 13
    state.bank.count.fill_(count)
    state.bank.images.copy_(torch.from_numpy(rng.uniform(0, 1, state.bank.images.shape)).to(state.bank.images.dtype))
    state.bank.poses.copy_(torch.from_numpy(rng.normal(0, 0.3, (k, 3)).astype(np.float32)))
    canvas = ShardedCanvas(group)
    want = canvas.recompute(dataclasses.replace(state.canvas, data=state.canvas.data.clone(),
                                                weight=state.canvas.weight.clone()), state.bank, engine.camera)
    delta = ShardedCanvas.recompute_buffer(state.canvas)
    ShardedCanvas.recompute_stage(delta, state.canvas, state.bank, engine.camera)
    group.all_reduce(delta)
    ShardedCanvas.recompute_finish(state.canvas, delta)
    assert _same_bits(state.canvas.data, want.data) and _same_bits(state.canvas.weight, want.weight)
    assert float(want.weight.sum()) > 0


def test_stagebench_trigger_row_on_the_cpu():
    """``stagebench --solve``'s distributed trigger row on a small map at
    one stub rank: the host loop and the program with the host making the
    collectives solve, give the same bits and the same CG iterations."""
    from nislam_torch.scripts import stagebench

    rows = stagebench.trigger_row((24, 64, 16, 4), one_rank(), 1, CPU)
    assert set(rows) == {"host loop", "host collectives"}
    assert all(r["ran"] and r["equal"] and r["syncs"] is None for r in rows.values())
    assert rows["host loop"]["cg_iterations"] == rows["host collectives"]["cg_iterations"] > 0


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



class HostLoopTrigger(TrackGraphEngine):
    """``engine`` with its chunk graph and the host-loop trigger
    (``optimize_host_loop``, ``finalize_host_loop``: the pending count and
    slots read, the loop edges added one by one, ``CGGraph``, the
    count-read sharded recompute), the reference of its trigger program."""

    def run_chunk(self, state, images):
        return self.engine.run_chunk(state, images)

    def optimize(self, state):
        return optimize_host_loop(self.engine, state)

    def finalize(self, state):
        return finalize_host_loop(self.engine, state)


def _host_reads(fn) -> int:
    """The host syncs that ``fn()`` makes on the card (sync debug mode)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) and "prototype" not in str(w.message) for w in seen)


@pytest.fixture(scope="module")
def nccl_group():
    """One NCCL rank on the card, in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the graphs exist only on a card")
    import socket

    import torch.distributed as dist

    from nislam_torch.parallel.mesh import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    group = init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, "nccl", "cuda:0")
    yield group
    dist.destroy_process_group()


@pytest.mark.gpu
def test_cg_step_kernel_on_the_card(cuda):
    """The ``cg_step`` kernel against its plain version on the same words:
    each mode, r² next to ``cg_tol ** 2`` on both sides and at it, and the
    iteration at its cap; its launches against its device count."""
    from nislam_torch.kernels.launch import cg_step_device_launches
    from nislam_torch.parallel import solver as sv

    cfg = CGSolverConfig(cg_iterations=5, outer_iterations=3)
    tol2 = np.float32(cfg.cg_tol ** 2)
    before, ran = sv.cg_step.launches, cg_step_device_launches(cuda)
    for r2 in (np.nextafter(tol2, np.float32(0)), tol2, np.nextafter(tol2, np.float32(1)), np.float32(1.0)):
        for mode, it in ((sv.CG_BEGIN, 0), (sv.CG_STEP, 0), (sv.CG_STEP, 3), (sv.CG_STEP, 4), (sv.GN_BEGIN, 0),
                         (sv.GN_STEP, 1), (sv.GN_STEP, 2)):
            words = torch.zeros(sv.TRIGGER_WORDS, dtype=torch.int32)
            words[sv.CG_IT], words[sv.GN] = it, it
            got, want = words.to(cuda), words.clone()
            r = torch.tensor([r2])
            sv.cg_step(got, r.to(cuda), mode, cfg, force="kernel")
            sv.cg_step(want, r, mode, cfg, force="reference")
            assert torch.equal(got.cpu(), want), (r2, mode, it)
    assert sv.cg_step.launches - before == cg_step_device_launches(cuda) - ran == 28


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_trigger_one_launch_on_the_card(nccl_group, name):
    """At one NCCL rank the trigger program is one graph launch (built at
    the first trigger that solves) and one host read per trigger, bit for
    bit with the host-loop trigger (outputs, tallies, every leaf,
    all-reduces by payload, the CG iterations); ``cg_step`` and the
    trigger kernel launched as often as their device counts say."""
    from nislam_torch.core.solve_graph import trigger
    from nislam_torch.kernels.launch import cg_step_device_launches, solve_device_launches
    from nislam_torch.parallel import solver as sv

    cuda = torch.device("cuda:0")
    group = nccl_group
    assert group.capturable
    config, frames = _config(name), torch.from_numpy(_frames(name)).to(cuda)
    engine = make_distributed_engine(config, group)
    host = HostLoopTrigger(make_distributed_engine(config, group))
    _run(engine, frames)  # captures; the graph built at the first trigger that solves
    _run(host, frames)
    program = engine.trigger_program
    assert program.built and set(program.node_types) <= {"kernel", "memcpy", "memset", "graph", "empty"}
    syncs = []
    real = engine.optimize
    engine.optimize = lambda state: syncs.append(0) or _count_syncs(syncs, real, state)
    c0, t0, s0 = group.counts.copy(), trigger.launches, sv.cg_step.launches
    d0, cg0 = solve_device_launches(cuda)[0], cg_step_device_launches(cuda)
    gs, go, gt = _run(engine, frames)
    c1 = group.counts.copy()
    d1, cg1 = solve_device_launches(cuda)[0], cg_step_device_launches(cuda)
    t1, s1 = trigger.launches, sv.cg_step.launches
    rs, ro, rt = _run(host, frames)
    del engine.optimize
    assert go.tobytes() == ro.tobytes() and gt == rt and any(gt)
    _assert_states_equal(gs, rs)
    assert c1 - c0 == group.counts - c1
    assert t1 - t0 == d1 - d0 and s1 - s0 == cg1 - cg0 > 0
    assert syncs and all(n == 1 for n in syncs), syncs  # optimize: one read; finalize adds none


def _count_syncs(syncs, optimize, state):
    out = []
    syncs[-1] = _host_reads(lambda: out.append(optimize(state)))
    return out[0]
