"""The whole tracked frame's graphs (``nislam_torch.core.frame_graph``) at the golden size.

On the CPU the frame graph's two bodies (the track body and the keyframe
branch) run eagerly on its buffers, with the flag read between them: the
plain version.  ``run_chunk_frame_graph`` runs a chunk through it frame by frame (the
engine's own ``run_chunk`` and ``step`` go through the chunk graph over
its buffers, ``tests/test_torch_chunk_graph.py``), for every
configuration here:

- flagship-like (bf16 bank, cached filters, no stored images, the exact
  search); HD-like (bf16, no cached filters, ``coarse_scale: 4``); ring
  eviction with the online canvas over chunks long enough to evict;
  ``eviction: drop`` with a bank that fills, so that keyframes are
  inserted but not stored; ``to_find_loop: false``;
- (a) ``run_sequence`` (``finalize`` included) equals the eager loop
  (``run_chunk_eager``) bit for bit in outputs, solves and every state
  leaf, and ``step`` equals ``slam_step``;
- (b) decisions equal JAX's engine (``chunked_deferred_drive``) exactly,
  poses within 2e-3, responses rtol 1e-3 (the golden tie-free seeds);
- (c) the bodies make no host read (only ``FrameGraph.decide`` reads the
  flags) and build no tensor from host data, on a frame that stores a
  keyframe and searches (and, online, retires an evicted one);
- (d) the state rule: a run lends the graph's buffers, passing the state
  back consumes it, a kept state never changes under a later run;
- (e) the inline solve takes the chunk graph; so do the distributed
  engine's frames, the keyframe branch on the host at each frame that
  inserts, and its trigger the host loop with GN-CG, with no solve graph;
- on a card (``gpu`` marker, skipped here): the frame graph, the track-graph path
  and the eager loop bit for bit, with as many kernel launches.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nislam_torch.core.slam as tslam
from nislam_torch.core.frame_graph import FrameGraph
from nislam_torch.core.slam import (
    make_engine,
    optimize_host_loop,
    run_chunk_eager,
    run_chunk_frame_graph,
    run_chunk_track_graph,
    slam_step,
    state_leaves,
)
from nislam_tpu.core.slam import chunked_deferred_drive
from nislam_tpu.core.slam import make_engine as make_jax_engine
from nislam_tpu.utils.synthetic import heading_loop_path, make_world, render_sequence

from test_torch_engine import _assert_outputs_match, _golden_config, _option_config
from test_torch_track_graph import EagerEngine, _assert_outputs_equal, _assert_states_equal, _same_bits

torch.set_num_threads(1)  # see test_torch_engine.py

CPU = torch.device("cpu")
WORKLOADS = ("flagship", "hd", "online", "drop", "no_loop")
DROP_CAPACITY = 24  # the golden run inserts 64 keyframes


class TrackGraphEngine(EagerEngine):
    """``engine`` with the track-graph path (``run_chunk_track_graph``) in place of
    its frame graph."""

    def run_chunk(self, state, images):
        return run_chunk_track_graph(self.engine, state, images)


class FrameGraphEngine(EagerEngine):
    """``engine`` with the frame graph frame by frame, its flag read per
    frame (``run_chunk_frame_graph``), in place of its chunk graph."""

    def run_chunk(self, state, images):
        return run_chunk_frame_graph(self.engine, state, images)


def _config(name):
    config = _golden_config()
    if name == "online":
        return _option_config("online")
    if name == "flagship":
        return dataclasses.replace(config, map=dataclasses.replace(
            config.map, bank_dtype="bf16", cache_filters=True, store_images=False))
    if name == "hd":
        return dataclasses.replace(
            config,
            map=dataclasses.replace(config.map, bank_dtype="bf16", cache_filters=False, store_images=False),
            loop_closure=dataclasses.replace(config.loop_closure, coarse_scale=4),
        )
    if name == "drop":
        return dataclasses.replace(config, map=dataclasses.replace(
            config.map, eviction="drop", keyframe_capacity=DROP_CAPACITY))
    return dataclasses.replace(config, loop_closure=dataclasses.replace(config.loop_closure, to_find_loop=False))


def _workload(name):
    """(config, frames, chunk): the golden frames in chunks of 32, the
    online canvas over the 120-frame tail in chunks of 40
    (test_torch_engine.py's runs)."""
    world = make_world(1024, 3.0, seed=1234)
    if name == "online":
        return _config(name), render_sequence(world, 96, 128, heading_loop_path(120, step=5.5, tail=30)), 40
    return _config(name), render_sequence(world, 96, 128, heading_loop_path(100, step=5.5, tail=10)), 32


def _run(engine, frames, chunk):
    """``run_sequence`` + ``finalize`` → (state, outputs, solves between chunks)."""
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), frames, chunk_frames=chunk, solve_tally=tally)
    state, _ = engine.finalize(state)
    return state, outs, tally


@pytest.fixture(scope="module", params=WORKLOADS)
def runs(request):
    """One workload through the frame graph (frame by frame, with its flag
    read) and the eager loop, on one engine."""
    config, frames, chunk = _workload(request.param)
    engine = make_engine(config, CPU)
    return types.SimpleNamespace(
        name=request.param, config=config, frames=frames, chunk=chunk, engine=engine,
        graph=_run(FrameGraphEngine(engine), frames, chunk), eager=_run(EagerEngine(engine), frames, chunk),
    )


def test_frame_graph_equals_eager_loop(runs):
    """(a) Through the frame graph, bit for bit with the eager loop, and
    each workload's own branch exercised."""
    (gs, go, gt), (es, eo, et) = runs.graph, runs.eager
    assert not runs.engine.branch_on_host and runs.engine._track_graph is None
    assert len(go.tracked) == len(runs.frames) and go.tracked.all()
    _assert_outputs_equal(go, eo)
    _assert_states_equal(gs, es)
    assert gt == et
    stored = go.keyframe_slot >= 0
    if runs.name == "online":
        assert int(gs.bank.overflow) > 0 and go.loop_found.any()  # the ring evicted and retired
    elif runs.name == "drop":
        assert int(gs.bank.count) == DROP_CAPACITY and (go.inserted & ~stored).any()
    elif runs.name == "no_loop":
        assert not go.loop_found.any() and (go.loop_eligible == 0).all() and stored.any()
    else:
        assert go.loop_found.any() and any(gt)


@pytest.mark.parametrize("name", ("flagship", "hd", "drop", "no_loop"))
def test_step_packed_equals_slam_step(name):
    """(a) ``step_packed`` through the frame graph equals ``slam_step`` bit
    for bit over a whole workload, the deferred trigger after every frame."""
    config, frames, _ = _workload(name)
    engine = make_engine(config, CPU)
    kw = engine._steps()
    gs, es = engine.init_state(), engine.init_state()
    for frame in frames:
        image = torch.from_numpy(frame)
        gs, g = engine.step_packed(gs, image)
        es, e = slam_step(es, engine._features(image), **kw)
        assert _same_bits(g, e.pack())
        gs, _ = engine.optimize(gs)
        es, _ = optimize_host_loop(engine, es)
    _assert_states_equal(gs, es)
    assert engine.frame_graph is not None and engine._track_graph is None


def test_frame_graph_matches_jax(runs):
    """(b) Against JAX's engine on the same frames and chunks."""
    je = make_jax_engine(runs.config)
    js, jo = chunked_deferred_drive(je, je.init_state(), jnp.asarray(runs.frames), chunk_frames=runs.chunk)
    js, _ = je.finalize(js)
    js, jo = jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jo)
    state, outs, _ = runs.graph
    _assert_outputs_match(outs, jo)
    np.testing.assert_allclose(state.bank.poses.numpy(), js.bank.poses, atol=2e-3)


@pytest.mark.parametrize("name", ("flagship", "hd", "online"))
def test_bodies_make_no_host_read(monkeypatch, name):
    """(c) The last frame that stores a keyframe (online: after the ring
    has evicted) through the frame graph with every host read but
    ``FrameGraph.decide``'s, and every tensor built from host data,
    refused: its output equals the eager loop's bit for bit."""
    config, frames, _ = _workload(name)
    engine = make_engine(config, CPU)
    _, ref = run_chunk_eager(engine, engine.init_state(), frames)
    j = int(np.flatnonzero(ref.keyframe_slot.numpy() >= 0)[-1])
    # The front end batched as in the runs before and at frame j.
    feats = tuple(f[0] for f in engine._features(frames[j:j + 1]))
    want_state, _ = run_chunk_eager(engine, engine.init_state(), frames[:j])
    _, want = tslam._track_step(want_state, feats, **engine._steps())
    state, _ = engine.run_chunk(engine.init_state(), frames[:j])
    if name == "online":
        assert int(state.bank.overflow) > 0
    graph = engine.frame_graph
    graph.load(state)
    real_tolist = torch.Tensor.tolist

    def refused(what):
        def raise_(*args, **kwargs):
            raise AssertionError(f"the body called Tensor.{what}")
        return raise_

    def tensors_only(real):
        def build(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"the body built a tensor from host data {data!r}")
            return real(data, *args, **kwargs)
        return build

    decided = []

    def decide(flags):
        decided.append(tuple(real_tolist(flags)))
        return decided[-1]

    with monkeypatch.context() as m:
        for what in ("item", "tolist", "__bool__", "__int__", "__float__", "numpy", "cpu"):
            m.setattr(torch.Tensor, what, refused(what))
        m.setattr(torch, "tensor", tensors_only(torch.tensor))
        m.setattr(torch, "as_tensor", tensors_only(torch.as_tensor))
        m.setattr(FrameGraph, "decide", staticmethod(decide))
        with pytest.raises(AssertionError, match="Tensor.__bool__"):
            bool(torch.ones(()))  # the guard is on
        packed = graph.run(*feats).clone()
    assert decided == [(True, True)]
    assert _same_bits(packed, want.pack())


def test_lent_state_rule():
    """(d) A run returns the graph's own buffers; passing that state back
    consumes it (the same object comes back); a state that is kept while
    another runs keeps its values and gets buffers of its own; a state
    given from outside is only read, and one that does not fit the engine
    is refused."""
    config, frames, _ = _workload("flagship")
    engine = make_engine(config, CPU)
    first, _ = engine.run_chunk(engine.init_state(), frames[:32])
    buffers = state_leaves(engine.frame_graph.state)
    assert all(x is y for x, y in zip(state_leaves(first), buffers, strict=True))  # nothing copied out
    again, _ = engine.run_chunk(first, frames[32:48])
    assert again is first  # consumed
    kept = [x.clone() for x in state_leaves(first)]
    given = engine.init_state()
    given, _ = engine.run_chunk(given, frames[:1])  # the first frame, eagerly, on the given state
    given_bits = [x.clone() for x in state_leaves(given)]
    other, _ = engine.run_chunk(given, frames[1:40])
    assert other is not given and other is not first
    assert all(_same_bits(x, y) for x, y in zip(state_leaves(first), kept, strict=True))
    assert not any(x is y for x, y in zip(state_leaves(first), buffers))
    assert all(_same_bits(x, y) for x, y in zip(state_leaves(given), given_bits, strict=True))
    # The detached state runs on, equal to a new engine's run of it.
    fresh = make_engine(config, CPU)
    want, want_outs = fresh.run_chunk(fresh.init_state(), frames[:32])
    want, want_outs = fresh.run_chunk(want, frames[32:48])
    want, want_outs = fresh.run_chunk(want, frames[48:64])
    got, got_outs = engine.run_chunk(first, frames[48:64])
    assert _same_bits(got_outs.pack(), want_outs.pack())
    _assert_states_equal(got, want)
    # A state of another configuration is refused before anything is copied.
    small = make_engine(dataclasses.replace(config, map=dataclasses.replace(config.map, keyframe_capacity=64)), CPU)
    kept = [x.clone() for x in state_leaves(got)]
    with pytest.raises(ValueError, match="does not fit"):
        engine.run_chunk(small.run_chunk(small.init_state(), frames[:2])[0], frames[2:4])
    assert all(_same_bits(x, y) for x, y in zip(state_leaves(got), kept, strict=True))
    assert all(x is y for x, y in zip(state_leaves(got), buffers))  # still lent, not detached


@pytest.mark.parametrize("case", ("inline", "plug points"))
def test_inline_and_plug_points_take_the_track_graph_path(case, monkeypatch):
    """(e) The configuration decides the path: the inline solve takes the
    chunk graph over the frame graph (its trigger inside the stored body);
    the distributed engine's plug points take the chunk graph for its
    frames, with the keyframe branch on the host (no branch captured, one
    host exit per frame that inserts), and its trigger program for the
    trigger (``CGTrigger``: the pending edges, the GN-CG solve and the
    sharded recompute on the device; no solve graph, never the host
    loop); neither takes the track-graph path."""
    from nislam_torch.parallel.engine import DistributedSlamEngine
    from nislam_torch.parallel.solver import CGGraph, CGSolverConfig, CGTrigger

    from test_torch_dist_graph import one_rank

    config, frames, _ = _workload("flagship")
    if case == "inline":
        inline = make_engine(dataclasses.replace(config, optimizer=dataclasses.replace(config.optimizer, inline=True)),
                             CPU)
        assert not inline.branch_on_host and inline.uses_solve_graph
        called = []
        monkeypatch.setattr(tslam, "run_chunk_track_graph", lambda *a: called.append(a[0]) or a[1:])
        state, _ = inline.run_chunk(inline.init_state(), frames[:8])
        inline.step(state, torch.from_numpy(frames[8]))
        assert called == [] and inline._track_graph is None
        assert inline.chunk_graph.built and inline.frame_graph.inline is inline.solve_graph
        return
    single = make_engine(config, CPU)
    dist = DistributedSlamEngine(config, single.cf_ops, single.camera, one_rank(), CGSolverConfig())
    assert not single.branch_on_host and single.uses_solve_graph
    assert dist.branch_on_host and not dist.uses_solve_graph and isinstance(dist.solver_fn, CGGraph)
    assert single.frame_graph.inline is None
    called, host_loop, triggers = [], [], []
    monkeypatch.setattr(tslam, "run_chunk_track_graph", lambda *a: called.append(a[0]) or a[1:])
    monkeypatch.setattr(tslam, "optimize_host_loop", lambda e, s: host_loop.append(e) or (s, False))
    real_run = CGTrigger.run
    monkeypatch.setattr(CGTrigger, "run", lambda self: triggers.append(self) or real_run(self))
    state, outs = dist.run_chunk(dist.init_state(), frames[:24])
    state, _ = dist.step(state, torch.from_numpy(frames[24]))
    state, _ = dist.optimize(state)
    dist.finalize(state)
    assert called == [] and dist._track_graph is None and dist.chunk_graph.built
    assert dist.frame_graph.host_branch and not dist.frame_graph.branch_slots()
    assert dist.chunk_graph.host_exits == int(outs.inserted[1:].sum()) > 0 and dist.chunk_graph.early_exits == 0
    assert host_loop == [] and triggers == [dist.trigger_program] * 2 and dist._solve_graph is None
    with pytest.raises(RuntimeError, match="its solve graph"):
        single.trigger_program
    with pytest.raises(RuntimeError, match="no solve graph"):
        dist.solve_graph


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured only on a card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_three_paths_on_the_card(cuda, name):
    """The frame graph, the track-graph path and the eager loop on the card: bit for
    bit in outputs, solves and every state leaf, with as many launches of
    each counted kernel; nothing is captured after the first run."""
    from nislam_torch.core.track_graph import COUNTED, CapturedStep

    config, frames, chunk = _workload(name)
    engine = make_engine(config, cuda)
    frames_d = torch.from_numpy(frames).to(cuda)
    paths = {"frame graph": FrameGraphEngine(engine), "track graph": TrackGraphEngine(engine),
             "eager": EagerEngine(engine)}
    for eng in paths.values():
        _run(eng, frames_d, chunk)  # captures
    assert engine.frame_graph.captured and engine.track_graph.captured
    captures = CapturedStep.captures
    results = {}
    for label, eng in paths.items():
        torch.cuda.synchronize()
        before = [w.launches for w in COUNTED]
        state, outs, tally = _run(eng, frames_d, chunk)
        results[label] = (state, outs, tally, [w.launches - b for w, b in zip(COUNTED, before)])
    assert CapturedStep.captures == captures
    gs, go, gt, gl = results["frame graph"]
    assert gl[0] > 0
    for label in ("track graph", "eager"):
        s, o, t, n = results[label]
        _assert_outputs_equal(go, o)
        assert gt == t and gl == n, label
        for x, y in zip(state_leaves(gs), state_leaves(s), strict=True):
            assert _same_bits(x.cpu(), y.cpu()), label
