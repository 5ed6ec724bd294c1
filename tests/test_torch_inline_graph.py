"""The inline pose-graph solve inside the chunk graph, at the golden 96×128 size.

With ``optimizer.inline`` the single engine's ``run_chunk`` and ``step``
go through the chunk graph (``nislam_torch.core.chunk_graph``): a stored
keyframe's branch is followed, in the same stored body, by the inline
trigger (``core/solve_graph.py``: the trigger gated by the frame's
``loop_found``; under an IF the setup, the LM loop and the inline finish,
which recomputes the online canvas on the device).  On the CPU that is
the chunk graph's plain program; the frame graph runs the same stored
branch and trigger frame by frame, the track-graph path keeps the host
loop (``_flush_pending_loops``).  The golden loop lengthened to 120 frames
(``tests/test_torch_engine.py::test_slice_options_match_jax``'s) fires the
inline trigger:

- the chunk program, with and without the online canvas (a ring of 40
  slots that evicts), against ``run_chunk_eager``, the frame graph and
  ``run_chunk_track_graph`` bit for bit: outputs, every state leaf, the
  canvas; against JAX's inline ``run_sequence`` decisions exactly, poses
  within 2e-3;
- ``step`` with the inline solve equals the eager step, one chunk-graph
  read per tracked step;
- the gated trigger's plain version: gate closed (a loop found), one live
  match (cleared, no solve), two (solve), a voided one;
- the masked ``recompute`` (no host read of the bank's count) against the
  loop that reads it, bit for bit, on a ring bank that evicted, a count
  off the batch size, and a false ``enabled`` that leaves the bits;
- ``solve_lanes`` with the online canvas makes no host read of the
  bank's count and equals the host loop;
- priming the inline steps (their capture on a card) leaves every leaf;
- ``outer_body`` and ``solve_body`` describe the inline stored body, and
  ``build_graph`` adds its nodes in that order;
- on a card (``gpu`` marker, skipped here): the inline chunk graph against
  the frame graph and the eager loop bit for bit, with as many counted
  launches, ``trigger`` and ``lm_step`` equal to their device counts, no
  host sync inside a chunk launch under sync debug mode "error", and the
  built graph four conditional levels deep.

JAX is imported only inside the test that compares with it, so the
``gpu`` case runs on a card without it (``--noconftest``).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import nislam_torch.core.chunk_graph as cg
import nislam_torch.core.solve_graph as tsg
from nislam_torch.core.chunk_graph import ChunkGraph, outer_body
from nislam_torch.core.slam import (
    make_engine,
    map_state,
    optimize_host_loop,
    run_chunk_eager,
    run_chunk_frame_graph,
    run_chunk_track_graph,
    slam_step,
    solve_lanes,
    state_leaves,
)
from nislam_torch.core.stitcher import make_canvas, recompute, recompute_reference
from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

torch.set_num_threads(1)  # see test_torch_engine.py

CPU = torch.device("cpu")
CHUNK = 40
POSE_ATOL = 2e-3
OPTIONS = ("inline", "inline_online")


def _config(option: str, config_module=None):
    """The golden config (``tests/test_torch_engine.py``'s) with the inline
    solve, and for ``inline_online`` the online canvas over a ring of 40
    slots that evicts, built from the port's config classes or
    ``config_module``'s (the JAX package's)."""
    if config_module is None:
        import nislam_torch.core.config as config_module
    c = config_module
    h, w = 96, 128
    config = c.SlamConfig(
        cf=c.CFConfig(width=w, height=h, rotation_divisor=360, rotation_channel=96),
        keyframe_selection=c.KeyframeSelectionConfig(
            max_distance=0.10, max_angle=0.05, lower_response_thr=4.0, upper_response_thr=6.0,
        ),
        map=c.MapConfig(grid_scale=0.15, keyframe_capacity=128, edge_capacity=512),
        loop_closure=c.LoopClosureConfig(
            to_find_loop=True, position_response_thr=8.0, angle_response_thr=8.0,
            frame_gap_thr=30, distance_thr=1.0, max_candidates=8,
        ),
        camera=c.CameraConfig(image_width=w, image_height=h, height=1.0,
                              intrinsics=(100.0, w / 2.0, 100.0, h / 2.0)),
    )
    config = dataclasses.replace(config, optimizer=dataclasses.replace(config.optimizer, inline=True))
    if option == "inline_online":
        config = dataclasses.replace(
            config, map=dataclasses.replace(config.map, keyframe_capacity=40),
            map_stitcher=dataclasses.replace(config.map_stitcher, online=True, canvas_size=1024))
    return config


def _frames(n: int = 120) -> np.ndarray:
    """The golden loop lengthened to 120 frames: a 30-frame tail back over
    the start, so loops are found on consecutive keyframes and the inline
    trigger fires."""
    world = make_world(1024, 3.0, seed=1234)
    return render_sequence(world, 96, 128, heading_loop_path(n, step=5.5, tail=30))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


def _assert_states_equal(a, b, what: str = "") -> None:
    for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b), strict=True)):
        assert _same_bits(x, y), f"{what}: state leaf {i}"


def _chunks(run_chunk, state, frames, chunk: int = CHUNK):
    """``frames`` chunk by chunk through ``run_chunk`` (no trigger between
    them: the inline solve runs in the step) → (state, packed (N, 17))."""
    outs = []
    for a in range(0, len(frames), chunk):
        state, o = run_chunk(state, frames[a:a + chunk])
        outs.append(o.pack())
    return state, torch.cat(outs)


PATHS = {
    "chunk graph": lambda e: e.run_chunk,
    "frame graph": lambda e: (lambda s, f: run_chunk_frame_graph(e, s, f)),
    "track graph": lambda e: (lambda s, f: run_chunk_track_graph(e, s, f)),
    "eager": lambda e: (lambda s, f: run_chunk_eager(e, s, f)),
}


@pytest.fixture(scope="module", params=OPTIONS)
def runs(request):
    """The 120 frames through each path, each on an engine of its own."""
    config, frames = _config(request.param), _frames()
    res = {}
    for label, path in PATHS.items():
        engine = make_engine(config, CPU)
        res[label] = (engine, *_chunks(path(engine), engine.init_state(), frames))
    return types.SimpleNamespace(option=request.param, config=config, frames=frames, res=res)


def test_inline_chunk_program_equals_the_other_paths(runs):
    """The chunk program (every tracked frame through it, the inline
    trigger in its stored body) equals the frame graph, the track-graph path and
    the eager loop bit for bit: outputs, every state leaf (the canvas
    among them); the inline trigger solved."""
    engine, state, outs = runs.res["chunk graph"]
    assert not engine.branch_on_host and engine.chunk_graph.built and engine._track_graph is None
    assert engine.frame_graph.inline is engine.solve_graph and engine.solve_graph.inline
    assert engine.solve_graph.carry is not None  # its steps ran
    assert int(outs[:, 3].sum()) >= 1 and int(outs[:, 2].sum()) >= 1  # inline solves, loops
    for label in ("frame graph", "track graph", "eager"):
        _, other, other_outs = runs.res[label]
        assert _same_bits(outs, other_outs), label
        _assert_states_equal(state, other, label)
    if runs.option == "inline_online":
        assert int(state.bank.overflow) > 0 and state.canvas.weight.sum() > 0  # evicted, canvas live


def test_inline_chunk_program_matches_jax(runs):
    """Against JAX's inline ``run_sequence`` on the same frames: decisions
    and integer outputs exactly, poses within 2e-3."""
    import jax
    import jax.numpy as jnp

    import nislam_tpu.core.config as jconfig
    from nislam_tpu.core.slam import make_engine as make_jax_engine

    from nislam_torch.core.slam import unpack_step_output

    je = make_jax_engine(_config(runs.option, jconfig))
    js, jo = je.run_sequence(je.init_state(), jnp.asarray(runs.frames))
    jo = jax.tree.map(np.asarray, jo)
    _, state, outs = runs.res["chunk graph"]
    t = unpack_step_output(outs.numpy())
    for name in ("tracked", "inserted", "loop_found", "optimized", "frame_id", "keyframe_slot", "loop_slot",
                 "loop_eligible"):
        np.testing.assert_array_equal(getattr(t, name), getattr(jo, name), err_msg=name)
    np.testing.assert_allclose(t.pose, jo.pose, atol=POSE_ATOL)
    np.testing.assert_allclose(t.cf_pose, jo.cf_pose, atol=POSE_ATOL)
    np.testing.assert_allclose(state.bank.poses.numpy(), np.asarray(js.bank.poses), atol=POSE_ATOL)
    assert t.optimized.any()


def test_inline_step_equals_eager_step():
    """``step`` with the inline solve is a chunk of one through the chunk
    graph (one read of its control block per tracked step): the eager
    step's bits, frame by frame, the inline solve among them."""
    config, frames = _config("inline"), _frames()
    engine = make_engine(config, CPU)
    # One solve graph, whichever of the two is made first.
    assert engine.solve_graph is engine.frame_graph.inline
    kw = engine._steps()
    reads, real = [], ChunkGraph._read

    def read(self):
        reads.append(1)
        return real(self)

    gs, es, solved = engine.init_state(), engine.init_state(), 0
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ChunkGraph, "_read", read)
        for frame in frames:
            image = torch.from_numpy(frame)
            gs, g = engine.step_packed(gs, image)
            es, e = slam_step(es, engine._features(image), **kw)
            assert _same_bits(g, e.pack())
            solved += int(g[3])
    _assert_states_equal(gs, es)
    assert solved >= 1
    assert len(reads) == len(frames) - 2  # the init step and the track graph's first use read none


def _control(lanes: int):
    ctl = torch.zeros(tsg.CTL_WORDS, dtype=torch.int32)
    return ctl, torch.zeros(lanes, dtype=torch.bool), tsg.lm_control(lanes, CPU, ctl)


@pytest.mark.parametrize("found,slots,count,run", [
    (1.0, [1, 2], 2, False),    # a loop found: no trigger, the pending matches kept
    (0.0, [1], 1, False),       # one live match: discarded unsolved
    (0.0, [1, -1], 2, False),   # one live match and a voided one: discarded
    (0.0, [1, 2], 2, True),     # two live matches: the solve runs
    (0.0, [1, 2, 3], 2, True),  # a stale entry past the count is not live
])
def test_gated_trigger_plain_version(found, slots, count, run):
    """The inline trigger's plain version (``trigger_reference`` with the
    frame's ``loop_found`` as its gate): JAX's ``stored & ~loop_found``
    and ≥ 2 live matches; a gated lane that does not solve has its pending
    count cleared, a lane whose gate is closed keeps it; the deferred
    trigger (no gate) on the same buffer keeps a single match."""
    cfg = tsg.SolverConfig()
    loop_slot = torch.full((1, 8), 0, dtype=torch.int32)
    loop_slot[0, :len(slots)] = torch.tensor(slots, dtype=torch.int32)
    for gate in (torch.tensor([found]), None):
        ctl, flags, control = _control(1)
        pending = torch.tensor([count], dtype=torch.int32)
        tsg.trigger(ctl, pending, loop_slot, flags, control, cfg, gate)
        live = sum(1 for i, s in enumerate(slots) if i < count and s >= 0)
        want = run if gate is not None else live >= 2
        assert flags.tolist() == [want] and ctl[tsg.ANY] == int(want) == ctl[tsg.RUN]
        assert control.active.tolist() == [want] and ctl[tpg_loop()] == int(want)
        cleared = gate is not None and found < 0.5 and not want
        assert int(pending) == (0 if cleared else count)
        assert ctl[tsg.TRIGGERS:].tolist() == [0] * tsg.COUNTS  # only a graph's kernels count


def tpg_loop() -> int:
    from nislam_torch.core.pose_graph import LOOP

    return LOOP


def _online_state():
    """The online-canvas run's state after the ring evicted (the fixture's
    frames through the eager loop on a fresh engine) and its engine."""
    config = _config("inline_online")
    engine = make_engine(config, CPU)
    state, _ = _chunks(lambda s, f: run_chunk_eager(engine, s, f), engine.init_state(), _frames(104))
    return engine, state


@pytest.fixture(scope="module")
def online():
    return _online_state()


def test_masked_recompute_equals_count_read_loop(online):
    """The masked recompute (every slot of the bank, ``slot < count`` on the
    device) equals the loop over the live slots that reads the count, bit
    for bit: on the ring bank that evicted (every slot live), on a bank
    whose count is not a multiple of the batch, and a false ``enabled``
    leaves the canvas's bits, a true one equals none."""
    engine, state = online
    ms = engine.config.map_stitcher
    assert int(state.bank.overflow) > 0 and int(state.bank.count) == state.bank.capacity
    bank = state.bank
    part = types.SimpleNamespace(images=bank.images, poses=bank.poses, count=torch.tensor(21, dtype=torch.int32))
    for b in (bank, part):
        got = recompute(make_canvas(ms, CPU), b, engine.camera)
        want = recompute_reference(make_canvas(ms, CPU), b, engine.camera)
        assert _same_bits(got.data, want.data) and _same_bits(got.weight, want.weight)
        assert got.weight.sum() > 0
    kept = [state.canvas.data.clone(), state.canvas.weight.clone()]
    recompute(state.canvas, part, engine.camera, enabled=torch.tensor(False))
    assert _same_bits(state.canvas.data, kept[0]) and _same_bits(state.canvas.weight, kept[1])
    on = recompute(make_canvas(ms, CPU), part, engine.camera, enabled=torch.tensor(True))
    want = recompute_reference(make_canvas(ms, CPU), part, engine.camera)
    assert _same_bits(on.data, want.data) and _same_bits(on.weight, want.weight)


def test_solve_lanes_online_reads_no_bank_count(online):
    """The deferred trigger through the solve graph with the online canvas
    recomputes it inside its program: no host read of the bank's count;
    the result equals the host loop bit for bit, its canvas
    ``recompute_reference`` of the solved bank."""
    engine, state = online
    state = map_state(state, torch.clone)
    # Two live matches, so the trigger solves.
    state.pending.loop_slot[:2] = torch.tensor([3, 5], dtype=torch.int32)
    state.pending.cur_slot[:2] = state.track.last_slot
    state.pending.rel_pose[:2] = 0.01
    state.pending.count.fill_(2)
    want, want_ran = optimize_host_loop(engine, map_state(state, torch.clone))
    assert want_ran
    engine.frame_graph.load(state)
    count = engine.frame_graph.state.bank.count
    reads = []
    real = {name: getattr(torch.Tensor, name) for name in ("__int__", "__index__", "__bool__", "item", "tolist")}

    def reader(name):
        def read(self, *args):
            if self.untyped_storage().data_ptr() == count.untyped_storage().data_ptr():
                reads.append(name)
            return real[name](self, *args)
        return read

    with pytest.MonkeyPatch.context() as m:
        for name in real:
            m.setattr(torch.Tensor, name, reader(name))
        got, ran = solve_lanes(engine, state)
    assert ran == [True] and reads == []
    _assert_states_equal(got, want, "solve graph against the host loop")
    fresh = recompute_reference(make_canvas(engine.config.map_stitcher, CPU), got.bank, engine.camera)
    assert _same_bits(got.canvas.data, fresh.data) and _same_bits(got.canvas.weight, fresh.weight)


def test_prime_keeps_every_leaf(online):
    """Priming the inline trigger's steps (on a card their capture: each
    step's first run, with no lane running) leaves every state leaf and
    the frame's packed output bit for bit; pending matches stay."""
    engine, state = online
    state = map_state(state, torch.clone)
    state.pending.loop_slot[:2] = torch.tensor([3, 5], dtype=torch.int32)
    state.pending.count.fill_(2)
    fg = engine.frame_graph
    fg.load(state)
    fg.track.run(torch.zeros_like(fg.track.inputs.img_u), torch.zeros_like(fg.track.inputs.polar))
    before = [x.clone() for x in state_leaves(fg.state)] + [fg.track.outputs.packed.clone()]
    engine.solve_graph.prime()
    after = state_leaves(fg.state) + [fg.track.outputs.packed]
    assert all(_same_bits(x, y) for x, y in zip(before, after, strict=True))
    assert engine.solve_graph.carry is not None


def test_descriptions_of_the_inline_stored_body():
    """``solve_body(loops, inline=True)`` ends its IF in the inline finish;
    ``outer_body`` gives the SWITCH that program after the stored body's
    branch (``("switch", program)``) when the graph holds the stored kind,
    none when it holds only the dropped kind; ``build_graph`` adds the
    inline trigger right after the SWITCH node, with the trigger's and
    lm_step's arguments and the three steps' graphs, and a refused step
    raises and destroys the half-built graph."""
    inline = tsg.solve_body(True, inline=True)
    loop = ("while", (("iteration",), ("lm_step",)))
    assert inline == (("trigger",), ("if", (("setup",), loop, ("inline_finish",))))
    assert tsg.solve_body(False, inline=True) == (("trigger",), ("if", (("setup",), ("inline_finish",))))
    assert tsg.solve_steps(True, inline=True) == ("setup", "iteration", "inline_finish")
    assert outer_body((0, 1), inline) == (("track",), ("flags",), ("switch", inline), ("advance_copy",))
    assert outer_body((1,), inline) == (("track",), ("flags",), ("switch",), ("advance_copy",))
    assert outer_body((0, 1)) == (("track",), ("flags",), ("switch",), ("advance_copy",))
    calls, fail = [], [None]

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name.removeprefix("nislam_cg_"), args))
                return 5 if name == fail[0] else 0
            return call

    parts = types.SimpleNamespace(body=inline, trigger=["t0", "t1"], lm_step=["l0"],
                                  graphs={"setup": 21, "iteration": 22, "inline_finish": 23})
    ctl = torch.zeros(cg.CTL_WORDS, dtype=torch.int32)
    args = (Lib(), ctl, 1, (0, 1), ((100, 8), (300, 24)), 7, 11, {0: 12, 1: 13}, 14, (200, 16), parts)
    cg.build_graph(*args)
    assert [name for name, _ in calls] == ["create", "add_child", "add_flags", "add_switch", "add_inline",
                                           "add_advance", "instantiate"]
    assert calls[4][1][1:] == ("t0", "t1", 21, 22, 23, "l0")
    calls.clear()
    fail[0] = "nislam_cg_add_inline"
    with pytest.raises(RuntimeError, match="inline trigger node failed: CUDA error 5"):
        cg.build_graph(*args)
    assert calls[-1][0] == "destroy"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk graph is built only on a card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("option", OPTIONS)
def test_inline_chunk_graph_on_the_card(cuda, option):
    """On the card: the inline engine's chunk graph, the frame graph and the
    eager loop over the 120 frames, after a pass that captures: bit for
    bit in outputs and every state leaf, as many counted launches, the
    ``trigger`` and ``lm_step`` launches equal to the kernels' own device
    counts, the trigger's one per stored keyframe on the graph paths, and
    ``lm_step``'s equal to the eager loop's host count; a chunk launch makes no host sync (sync debug mode "error");
    the built graph is WHILE → SWITCH → IF → WHILE deep."""
    from nislam_torch.core.pose_graph import lm_step
    from nislam_torch.core.track_graph import COUNTED
    from nislam_torch.kernels.launch import solve_device_launches

    config, frames = _config(option), torch.from_numpy(_frames()).to(cuda)
    engine = make_engine(config, cuda)
    paths = {label: PATHS[label](engine) for label in ("chunk graph", "frame graph", "eager")}
    for run in paths.values():
        _chunks(run, engine.init_state(), frames)  # captures
    res = {}
    for label, run in paths.items():
        torch.cuda.synchronize()
        before = [w.launches for w in COUNTED] + [tsg.trigger.launches, lm_step.launches]
        ran = solve_device_launches(cuda)
        state, outs = _chunks(run, engine.init_state(), frames)
        after = [w.launches for w in COUNTED] + [tsg.trigger.launches, lm_step.launches]
        ran = [b - a for a, b in zip(ran, solve_device_launches(cuda))]
        res[label] = (state, outs, [b - a for a, b in zip(before, after)])
        assert res[label][2][-2:] == ran, label
    state, outs, counts = res["chunk graph"]
    assert int(outs[:, 3].sum()) >= 1 and counts[-1] > 0
    # What the outputs show: on the graph paths one trigger after each
    # stored keyframe; the eager loop's host loop launches none, and it
    # launches and counts each LM iteration from the host.
    stored = int(((outs[:, 14] >= 0) & (outs[:, 13] > 0)).sum())
    assert [res[label][2][-2] for label in paths] == [stored, stored, 0]
    assert len({res[label][2][-1] for label in paths}) == 1
    for label in ("frame graph", "eager"):
        assert _same_bits(outs, res[label][1]), label
        assert res[label][2][:len(COUNTED)] == counts[:len(COUNTED)], label
        _assert_states_equal(state, res[label][0], label)
    real, launched = cg._CardGraph.launch, []

    def checked(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched.append(1)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(cg._CardGraph, "launch", checked)
        _chunks(engine.run_chunk, engine.init_state(), frames)
    assert len(launched) == -(-len(frames) // CHUNK)
    st = engine.chunk_graph.structure
    print("inline chunk graph structure:", st)
    assert st["depth"] == 4 and st["inline_ifs"] == 1 and st["inline_while_nodes"] == 2
    assert st["inline_if_children"] == 2 and st["inline_if_conditionals"] == 1
