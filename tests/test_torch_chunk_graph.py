"""A chunk of tracked frames as one graph (``nislam_torch.core.chunk_graph``) at the golden size.

On the CPU the chunk graph's outer body (the copy of the first frame,
then per frame: track, flags, one branch step per lane whose taken kind
copies the lane's spectrum in, advance and the next frame's copy) runs
as a Python loop over the frame graph's buffers and the same control
block that the card's graph uses: the plain program.  The engine's
``run_chunk`` and ``step`` go through it.

- the workloads of ``tests/test_torch_frame_graph.py`` (flagship-like,
  HD-like, the online canvas on a ring that evicts, ``eviction: drop``
  with a bank that fills, ``to_find_loop: false``), chunk by chunk with
  no solve between: the chunk program equals the eager loop
  (``run_chunk_eager``) bit for bit in outputs and every state leaf, with
  as many ``peak_stats`` calls at each shape; against JAX's
  ``SlamEngine.run_chunk`` on the same chunks the decisions and integer
  outputs are equal, PSRs within rtol 5e-4, poses within 2e-3;
- a branch kind that the graph does not hold yet stops the chunk, which
  the host finishes (the stopped frame's spectrum copied in first) and
  resumes: counted, equal results, none once both kinds are held;
- a spectrum is copied only where a branch runs (in the batch, every
  lane's spectra in one copy, on the frames whose body runs);
- ``step_packed`` is a chunk of one: ``slam_step``'s bits, one host read
  per tracked step;
- the batch engine's chunk program equals its kept eager loop at seeds
  1, 2 and 5, its bodies keyed by the number of lanes that insert;
- the card's graph and the CPU's loop come from one description, the
  plain flags step counts each slot's runs, and the nested graphs'
  counted launches are added per replay;
- on a card (``gpu`` marker, skipped here): the chunk graph against the
  flag-read frame graph bit for bit at 64×96 (single and batch), no host
  sync inside a chunk launch under sync debug mode "error", the node
  types of the captured bodies, and the built graph's nodes: four per
  WHILE iteration, one conditional node (the batch's too: one SWITCH over
  its bodies, not one per lane), no count node in a branch body.
"""

import collections
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nislam_torch.core.chunk_graph as cg
import nislam_torch.ops.peak_stats as tps
from nislam_torch.core.chunk_graph import ChunkGraph, outer_body
from nislam_torch.core.frame_graph import FrameGraph
from nislam_torch.core.slam import (
    make_engine,
    optimize_host_loop,
    pack_outputs,
    run_chunk_eager,
    run_chunk_frame_graph,
    slam_step,
    state_leaves,
)
from nislam_torch.core.track_graph import COUNTED, CapturedStep
from nislam_tpu.core.slam import make_engine as make_jax_engine

from test_torch_frame_graph import DROP_CAPACITY, WORKLOADS, _workload
from test_torch_track_graph import _assert_states_equal, _same_bits

torch.set_num_threads(1)  # see test_torch_engine.py

CPU = torch.device("cpu")
PSR_RTOL = 5e-4
POSE_ATOL = 2e-3


def _chunks(engine, run_chunk, frames, chunk):
    """The frames chunk by chunk through ``run_chunk`` (no solve between)
    → (state, packed outputs (N, 17) numpy, peak_stats reference calls by
    shape)."""
    calls = collections.Counter()
    real = tps.peak_stats_reference

    def counted(g):
        calls[tuple(g.shape)] += 1
        return real(g)

    state, outs = engine.init_state(), []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tps, "peak_stats_reference", counted)
        for a in range(0, len(frames), chunk):
            state, o = run_chunk(state, frames[a:a + chunk])
            outs.append(o.pack())
    return state, torch.cat(outs).cpu().numpy(), calls


@pytest.fixture(scope="module", params=WORKLOADS)
def runs(request):
    """One workload chunk by chunk through the chunk program, the eager
    loop and JAX's ``run_chunk``."""
    config, frames, chunk = _workload(request.param)
    engine = make_engine(config, CPU)
    je = make_jax_engine(config)
    js, jo = je.init_state(), []
    for a in range(0, len(frames), chunk):
        js, o = je.run_chunk(js, jnp.asarray(frames[a:a + chunk]))
        jo.append(jax.tree.map(np.asarray, o))
    return types.SimpleNamespace(
        name=request.param, engine=engine, frames=frames, chunk=chunk,
        graph=_chunks(engine, engine.run_chunk, frames, chunk),
        eager=_chunks(engine, lambda s, f: run_chunk_eager(engine, s, f), frames, chunk),
        jax=(jax.tree.map(np.asarray, js), jax.tree.map(lambda *x: np.concatenate(x), *jo)),
    )


def test_chunk_program_equals_eager_loop(runs):
    """Bit for bit with the eager loop, with as many peak_stats calls at
    each shape; every tracked frame after the first went through the
    chunk program."""
    (gs, go, gc), (es, eo, ec) = runs.graph, runs.eager
    assert go.tobytes() == eo.tobytes()
    _assert_states_equal(gs, es)
    assert gc == ec and sum(gc.values()) > 0
    chunk = runs.engine.chunk_graph
    assert chunk.built and runs.engine._track_graph is None
    # A graph holds what the frame graph has made: the stored kind always,
    # the dropped kind where the bank drops.
    want = {0, 1} if runs.name == "drop" else {0}
    assert set(runs.engine.frame_graph.branch_slots()) == want
    assert chunk.early_exits == len(want)  # one per kind: its first use


def test_chunk_program_matches_jax(runs):
    """Against JAX's ``SlamEngine.run_chunk`` on the same chunks: decisions
    and integer outputs equal, PSRs within rtol 5e-4, poses within 2e-3."""
    from nislam_torch.core.slam import unpack_step_output

    (gs, go, _), (js, jo) = runs.graph, runs.jax
    t = unpack_step_output(go)
    for name in ("tracked", "inserted", "loop_found", "optimized", "frame_id", "keyframe_slot", "loop_slot",
                 "loop_eligible"):
        np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(jo, name)), err_msg=name)
    np.testing.assert_allclose(t.response, jo.response, rtol=PSR_RTOL)
    np.testing.assert_allclose(t.pose, jo.pose, atol=POSE_ATOL)
    np.testing.assert_allclose(t.cf_pose, jo.cf_pose, atol=POSE_ATOL)
    np.testing.assert_array_equal(gs.bank.count.numpy(), js.bank.count)
    np.testing.assert_allclose(gs.bank.poses.numpy(), js.bank.poses, atol=POSE_ATOL)
    if runs.name not in ("no_loop", "drop"):  # drop: the bank is full before the path comes back
        assert t.loop_found.any()


def test_drop_exits_early_and_resumes():
    """The drop workload: the chunk stops at the first keyframe its full
    bank drops (the graph holds the stored kind only), the host copies
    that frame's spectrum in (the graph copies one only inside a branch),
    finishes the frame, captures the kind and resumes; the results equal
    the eager loop's and the flag-read frame graph's, and a second pass,
    with both kinds held, takes no exit."""
    config, frames, chunk = _workload("drop")
    engine = make_engine(config, CPU)
    seen, stopped, spectra = [], [], []
    real, real_finish, real_features = ChunkGraph._read, FrameGraph.finish, engine._features

    def read(self):
        i, stop = real(self)
        frame_id = int(self.frame_graph.track.outputs.packed[13])  # the frame the chunk ended at
        seen.append((frame_id, stop, tuple(sorted(self.frame_graph.branch_slots()))))
        if stop:
            stopped.append(i)
        return i, stop

    def features(images):
        feats = real_features(images)
        spectra.append(feats[1])
        return feats

    exits = []

    def finish(self):
        if stopped:  # an early exit's frame: its spectrum is in the buffer before its branch
            exits.append(_same_bits(self.fft, spectra[-1][stopped.pop()]))
        real_finish(self)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(ChunkGraph, "_read", read)
        m.setattr(FrameGraph, "finish", finish)
        m.setattr(engine, "_features", features)
        gs, go, _ = _chunks(engine, engine.run_chunk, frames, chunk)
    stops = [(i, slots) for i, stop, slots in seen if stop]
    assert [slots for _, slots in stops] == [(), (0,)]  # the stored kind's first use, then the dropped kind's
    assert exits == [True, True]
    drop_frame = stops[1][0]
    outs = go.reshape(-1, 17)
    assert outs[drop_frame, 1] == 1.0 and outs[drop_frame, 14] == -1.0  # inserted, not stored
    assert int(gs.bank.count) == DROP_CAPACITY
    es, eo, _ = _chunks(engine, lambda s, f: run_chunk_eager(engine, s, f), frames, chunk)
    fs, fo, _ = _chunks(engine, lambda s, f: run_chunk_frame_graph(engine, s, f), frames, chunk)
    assert go.tobytes() == eo.tobytes() == fo.tobytes()
    _assert_states_equal(gs, es)
    _assert_states_equal(fs, es)
    exits = engine.chunk_graph.early_exits
    again, ao, _ = _chunks(engine, engine.run_chunk, frames, chunk)
    assert engine.chunk_graph.early_exits == exits == 2
    assert ao.tobytes() == eo.tobytes()


@pytest.mark.parametrize("name", ("drop", "online"))
def test_step_packed_is_a_chunk_of_one(name):
    """``step_packed`` equals ``slam_step`` bit for bit (the deferred
    trigger after every frame), each tracked step one launch of the chunk
    program with one host read, and the lent state's first-frame flag
    known without one."""
    config, frames, _ = _workload(name)
    engine = make_engine(config, CPU)
    kw = engine._steps()
    reads = []
    real = ChunkGraph._read

    def read(self):
        reads.append(1)
        return real(self)

    gs, es = engine.init_state(), engine.init_state()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ChunkGraph, "_read", read)
        for frame in frames:
            image = torch.from_numpy(frame)
            gs, g = engine.step_packed(gs, image)
            es, e = slam_step(es, engine._features(image), **kw)
            assert _same_bits(g, e.pack())
            gs, _ = engine.optimize(gs)
            es, _ = optimize_host_loop(engine, es)
    _assert_states_equal(gs, es)
    # The first frame is the init step, the second the track graph's first
    # use (through the frame graph): every later one is a chunk of one.
    assert len(reads) == len(frames) - 2
    assert gs is engine.frame_graph._lent_state()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.Tensor, "__bool__", lambda self: pytest.fail("read the initialized flag"))
        assert engine._initialized(gs)


def test_batch_chunk_program_equals_eager_loop():
    """The batch engine (three lanes, seeds 1, 2 and 5, lane b b frames
    behind, a bank that fills and drops) through its chunk program equals
    its kept eager loop bit for bit: outputs, solve tallies, every state
    leaf; the graph holds a body for each number of lanes that inserted in
    a frame (1, 2 and 3), each added at an early exit."""
    from nislam_torch.parallel import make_batch_engine
    from nislam_torch.parallel.batch import eager_engine, run_chunk_frame_graph as batch_frame_graph

    from test_torch_batch_graph import LANES, _config, _run

    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

    path = heading_loop_path(48 + LANES - 1, step=3.5, start=(256.0, 256.0), tail=8)
    seqs = np.stack([render_sequence(make_world(512, 3.0, seed=s), 64, 96, path)[b:b + 48]
                     for b, s in enumerate((1, 2, 5))])
    engine = make_batch_engine(_config("drop"), LANES, device="cpu")
    gs, go, gt, gr = _run(engine, seqs)
    es, eo, et, er = _run(eager_engine(engine), seqs)
    fs, fo, ft, fr = _run(eager_engine(engine, batch_frame_graph), seqs)
    assert pack_outputs(go).tobytes() == pack_outputs(eo).tobytes() == pack_outputs(fo).tobytes()
    assert gt == et == ft and gr == er == fr
    for x, y, z in zip(state_leaves(gs), state_leaves(es), state_leaves(fs), strict=True):
        assert _same_bits(x, y) and _same_bits(z, y)
    k = go.inserted[:, 1:].sum(axis=0)
    assert set(engine.frame_graph.branch_slots()) == {n - 1 for n in k[k > 0].tolist()} == {0, 1, 2}
    assert engine.chunk_graph.lanes == LANES and engine.chunk_graph.early_exits == LANES


def test_one_description_for_the_card_and_the_cpu():
    """``build_graph`` adds the card's nodes in :func:`outer_body`'s order,
    which the CPU's loop follows: the graph with its copy of the first
    frame's ``img_u`` and ``polar``, the track graph, the flags (the
    bodies held and how the kernel picks one: the single engine's kind or
    the batch's count of inserting lanes), ONE SWITCH over the bodies
    (each body's graph, none for a body not held, and the spectrum
    buffer), the advance; a refused step raises and destroys the
    half-built graph."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name.removeprefix("nislam_cg_"), args))
                return 5 if name == fail[0] else 0
            return call

    fail = [None]
    ctl = torch.zeros(cg.CTL_WORDS, dtype=torch.int32)
    copies, spectrum = ((100, 8), (300, 24)), (200, 48)
    for lanes, slots, by_count, bodies in ((1, (1,), False, [None, 13]), (3, (0, 2), True, [12, None, 13])):
        calls.clear()
        args = (Lib(), ctl, lanes, slots, copies, 7, 11, {s: 12 + (s > 0) for s in slots}, 14, spectrum, None,
                by_count)
        cg.build_graph(*args)
        names = [name for name, _ in calls]
        assert names == ["create", "add_child", "add_flags", "add_switch", "add_advance", "instantiate"]
        assert calls[0][1][2:] == (lanes, 100, 8, 300, 24)
        assert calls[1][1][1:] == (7,)
        assert calls[2][1][1:] == (11, sum(1 << s for s in slots), int(by_count))
        assert list(calls[3][1][1]) == bodies and calls[3][1][2:] == spectrum
        assert calls[4][1][1:] == (14, cg.WIDTH)
    assert [op for op, *_ in outer_body((0, 3))] == ["track", "flags", "switch", "advance_copy"]
    assert outer_body((1,)) == (("track",), ("flags",), ("switch",), ("advance_copy",))
    assert outer_body(()) == (("track",), ("flags",), ("advance_copy",))
    calls.clear()
    fail[0] = "nislam_cg_add_switch"
    with pytest.raises(RuntimeError, match="switch node failed: CUDA error 5"):
        cg.build_graph(*args)
    assert calls[-1][0] == "destroy"


def test_nested_replays_are_counted():
    """``CapturedStep.count_replays(k)`` adds k replays' counted calls, by
    wrapper and by peak_stats shape: what a chunk graph's read adds for
    the graphs it nests."""
    step = CapturedStep(CPU, lambda: None)
    step._launches = ((2, 0, 1), collections.Counter({(2, 480, 640): 1, (480, 640): 1}))
    before = [w.launches for w in COUNTED]
    shapes = collections.Counter(tps.peak_stats.shapes)
    try:
        step.count_replays(3)
        assert [w.launches - b for w, b in zip(COUNTED, before)] == [6, 0, 3]
        assert tps.peak_stats.shapes - shapes == collections.Counter({(2, 480, 640): 3, (480, 640): 3})
    finally:
        for w, b in zip(COUNTED, before):
            w.launches = b
        tps.peak_stats.shapes.clear()
        tps.peak_stats.shapes.update(shapes)


def test_plain_kernels():
    """The flags and advance kernels' plain versions: a missing body stops
    the frame and takes none; advance writes row NEXT − 1 of each lane and
    moves on, or leaves i on a stop."""
    ctl = torch.zeros(cg.CTL_WORDS, dtype=torch.int32)
    ctl[cg.I] = 2
    assert cg._flags(ctl, torch.tensor([[True, False]]), (0, 1)) == {1}
    assert int(ctl[cg.STOP]) == 0 and int(ctl[cg.NEXT]) == 3
    assert cg._flags(ctl, torch.tensor([[True, True]]), (1,)) == set()
    assert int(ctl[cg.STOP]) == 1 and int(ctl[cg.NEXT]) == 2
    out = torch.zeros(3, 4, cg.WIDTH)
    packed = torch.arange(3 * cg.WIDTH, dtype=torch.float32).reshape(3, cg.WIDTH)
    ctl[cg.N] = 4
    assert not cg._advance(ctl, packed, out) and int(ctl[cg.I]) == 2 and not out.any()
    ctl[cg.STOP], ctl[cg.NEXT] = 0, 3
    assert cg._advance(ctl, packed, out) and int(ctl[cg.I]) == 3 and int(ctl[cg.DONE]) == 1
    assert torch.equal(out[:, 2], packed)
    ctl[cg.NEXT] = 4
    assert not cg._advance(ctl, packed, out) and int(ctl[cg.I]) == 4


def test_plain_flags_sets_run_counts():
    """The flags step counts each body's runs in the control block (the
    card's flags kernel does, in place of a count node per body): one per
    frame that takes it, none on a frame that inserts nothing or stops."""
    ctl = torch.zeros(cg.CTL_WORDS, dtype=torch.int32)
    for flags in ([True, True], [False, True], [True, False], [True, True], [False, False]):
        cg._flags(ctl, torch.tensor([flags]), (0, 1))
    runs = ctl[cg.RUNS:cg.RUNS + 2].tolist()
    assert runs == [2, 1]
    cg._flags(ctl, torch.tensor([[True, False]]), (0,))  # dropped: slot 1 missing
    assert int(ctl[cg.STOP]) == 1 and ctl[cg.RUNS:cg.RUNS + 2].tolist() == runs


def _count_spectrum_copies(engine, run):
    """``run()`` with each spectrum copy and branch run inside the chunk
    program recorded by chunk-local frame → (copies, runs)."""
    fg, chunk = engine.frame_graph, engine.chunk_graph
    copies, runs, inside = collections.Counter(), collections.Counter(), []
    real_in, real_run, real_plain = cg._spectrum_in, CapturedStep.run, ChunkGraph._plain

    def spectrum_in(fft, spectra):
        assert fft is fg.fft and spectra.shape == fft.shape  # every lane's spectra at once
        copies[int(chunk.ctl[cg.I])] += 1
        return real_in(fft, spectra)

    def step_run(self):
        if inside and any(v is self for v in fg.branch_slots().values()):
            runs[int(chunk.ctl[cg.I])] += 1
        return real_run(self)

    def plain(self, *args):
        inside.append(1)
        try:
            real_plain(self, *args)
        finally:
            inside.pop()

    with pytest.MonkeyPatch.context() as m:
        m.setattr(cg, "_spectrum_in", spectrum_in)
        m.setattr(CapturedStep, "run", step_run)
        m.setattr(ChunkGraph, "_plain", plain)
        run()
    return copies, runs


def test_plain_program_copies_spectra_only_where_a_branch_runs():
    """The plain program moves the spectrum only on the frames where a
    branch runs: the single engine (the drop workload) and the batch (three
    lanes), where one copy moves every lane's spectra for the frame's body;
    frames that insert nothing copy only ``img_u`` and ``polar``."""
    from nislam_torch.parallel import make_batch_engine

    from test_torch_batch_graph import LANES, _config, _run

    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

    config, frames, chunk = _workload("drop")
    engine = make_engine(config, CPU)
    copies, runs = _count_spectrum_copies(engine, lambda: _chunks(engine, engine.run_chunk, frames, chunk))
    assert copies == runs and 0 < sum(copies.values()) < len(frames) - 2

    path = heading_loop_path(48, step=3.5, start=(256.0, 256.0), tail=8)
    seqs = np.stack([render_sequence(make_world(512, 3.0, seed=s), 64, 96, path) for s in (1, 2, 5)])
    batch = make_batch_engine(_config("ring"), LANES, device="cpu")
    copies, runs = _count_spectrum_copies(batch, lambda: _run(batch, seqs))
    assert copies == runs and 0 < sum(copies.values()) < len(path) - 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk graph is built only on a card")
    return torch.device("cuda")


def _small_single(config_name="drop"):
    """The batch tests' 64×96 config (one lane) and 48 frames of seed 1."""
    from test_torch_batch_graph import _config

    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

    path = heading_loop_path(48, step=3.5, start=(256.0, 256.0), tail=8)
    return _config(config_name), render_sequence(make_world(512, 3.0, seed=1), 64, 96, path)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("ring", "drop"))
def test_chunk_graph_equals_frame_graph_on_the_card(cuda, name):
    """At 64×96 on the card: the chunk graph against the flag-read frame
    graph and the eager loop, bit for bit in outputs and every state leaf,
    with as many counted launches; then the batch engine's (three lanes)
    against its frame graph and its eager loop (each lane's branch on its
    own), bit for bit."""
    from nislam_torch.parallel import make_batch_engine
    from nislam_torch.parallel.batch import eager_engine, run_chunk_frame_graph as batch_frame_graph

    from test_torch_batch_graph import LANES, _config, _run

    config, frames = _small_single(name)
    frames_d = torch.from_numpy(frames).to(cuda)
    engine = make_engine(config, cuda)
    paths = {"chunk": engine.run_chunk, "frame": lambda s, f: run_chunk_frame_graph(engine, s, f),
             "eager": lambda s, f: run_chunk_eager(engine, s, f)}
    for run in paths.values():
        _chunks(engine, run, frames_d, 20)  # captures
    res = {}
    for label, run in paths.items():
        torch.cuda.synchronize()
        before = [w.launches for w in COUNTED]
        state, outs, _ = _chunks(engine, run, frames_d, 20)
        res[label] = (state, outs, [w.launches - b for w, b in zip(COUNTED, before)])
    for label in ("frame", "eager"):
        assert res[label][1].tobytes() == res["chunk"][1].tobytes(), label
        assert res[label][2] == res["chunk"][2] and res["chunk"][2][0] > 0, label
        for x, y in zip(state_leaves(res["chunk"][0]), state_leaves(res[label][0]), strict=True):
            assert _same_bits(x.cpu(), y.cpu()), label
    assert ChunkGraph.launches > 0
    path = np.stack([_small_single(name)[1]] * LANES)
    batch = make_batch_engine(_config(name), LANES, device="cuda")
    _run(batch, path)
    outs = [_run(e, path) for e in (batch, eager_engine(batch, batch_frame_graph), eager_engine(batch))]
    assert pack_outputs(outs[0][1]).tobytes() == pack_outputs(outs[1][1]).tobytes() == \
        pack_outputs(outs[2][1]).tobytes()
    for x, y, z in zip(state_leaves(outs[0][0]), state_leaves(outs[1][0]), state_leaves(outs[2][0]), strict=True):
        assert _same_bits(x.cpu(), y.cpu()) and _same_bits(x.cpu(), z.cpu())


@pytest.mark.gpu
def test_no_host_sync_in_a_chunk_launch(cuda):
    """A chunk launch (the control block's kernel and the graph) under
    ``torch.cuda``'s sync debug mode "error", the chunk's frames keyframes
    among them; the read after it is the chunk's one host sync."""
    config, frames = _small_single("ring")
    engine = make_engine(config, cuda)
    frames_d = torch.from_numpy(frames).to(cuda)
    state, _ = engine.run_chunk(engine.init_state(), frames_d[:24])  # captures and builds
    real = cg._CardGraph.launch
    launched = []

    def checked(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched.append(1)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(cg._CardGraph, "launch", checked)
        _, outs = engine.run_chunk(state, frames_d[24:])
    assert launched == [1] and bool(outs.inserted.any())


@pytest.mark.gpu
def test_node_types_of_the_bodies(cuda):
    """The node types that PyTorch's captures hold, walked before a build:
    only types that a conditional body accepts (kernels and copies)."""
    config, frames = _small_single("drop")
    engine = make_engine(config, cuda)
    engine.run_chunk(engine.init_state(), torch.from_numpy(frames).to(cuda))
    types_found = engine.chunk_graph.node_types
    print("node types of the nested graphs:", types_found)
    assert types_found.get("kernel", 0) > 0 and set(types_found) <= cg.BODY_TYPES


@pytest.mark.gpu
def test_card_graph_structure(cuda):
    """The built graph on the card, walked (``nislam_cg_describe``): the
    copy and the WHILE node outside; per WHILE iteration the track graph,
    the flags kernel, one SWITCH node and the advance (four nodes); in each
    SWITCH body the spectrum copy and the branch graph, no other kernel (no
    count node); for the single engine (a stored and a dropped body) and
    the batch (three lanes: ONE SWITCH of three bodies keyed by k, not one
    per lane)."""
    from nislam_torch.parallel import make_batch_engine

    from test_torch_batch_graph import LANES, _config, _run

    config, frames = _small_single("drop")
    engine = make_engine(config, cuda)
    engine.run_chunk(engine.init_state(), torch.from_numpy(frames).to(cuda))
    batch = make_batch_engine(_config("drop"), LANES, device="cuda")
    _run(batch, np.stack([frames] * LANES))
    for eng, bodies in ((engine, 2), (batch, LANES)):
        slots = sorted(eng.frame_graph.branch_slots())
        st = eng.chunk_graph.structure
        print("chunk graph structure:", st)
        assert st["outer_nodes"] == 2
        assert (st["iteration_nodes"], st["iteration_conditionals"], st["iteration_children"]) == (4, 1, 1)
        assert st["iteration_kernels"] == 2 and st["iteration_copies"] == 1  # flags; the advance copies
        assert st["branch_bodies"] == bodies and st["empty_branch_bodies"] == bodies - len(slots)
        assert st["branch_kernels"] == st["branch_copies"] == st["branch_children"] == len(slots)
        assert st["branch_conditionals"] == 0
