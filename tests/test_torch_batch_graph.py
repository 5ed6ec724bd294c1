"""The batch engine's graphs and batched solve (``nislam_torch.parallel.batch``) on the CPU.

On the CPU the batch frame graph's bodies (the batched track body and,
when k lanes insert, body k: the keyframe branch over those k lanes,
gathered on the device) run eagerly on its buffers, with the (B, 2) flag
read between them: the plain version.  The workload is
``tests/test_torch_batch.py``'s: three lanes, each its own tie-free world
(seeds 1, 2, 5), on a 48-frame loop that comes back over its start, in
chunks of 20 (a tail of 8).  ``drop`` fills a bank of 31 slots that
drops when full: every lane stores keyframes, finds loops, then inserts
keyframes that its bank drops.

- (a) ``run_sequences`` (``finalize`` included) through the graphs equals
  the kept eager per-frame loop (``run_chunk_eager``, each lane's branch
  on its own) bit for bit: outputs, solve tallies, every state leaf; the
  bodies made are those of the numbers of lanes that inserted, stored and
  dropped keyframes among them (``tests/test_torch_batch_branch.py``
  holds body k for k = 1, 2, 3 against k lane branches);
- (b) the lanes' solves as one batched LM (``solve_pose_graph_lanes``)
  equal one ``solve_pose_graph`` per lane bit for bit, with lanes that
  stop at different iterations and a lane whose normal matrix is not
  positive definite; and ``BatchSlamEngine.optimize`` equals
  ``solve_and_rederive`` lane by lane;
- (c) the bodies make no host read (only ``FrameGraph.decide`` reads the
  flags) and build no tensor from host data;
- (d) the lent-state rule for batch states;
- a keyframe's tracking chain is the same whether ``_init_step`` (from a
  step's own front end) or the branch graph inserts it, the features
  row-major (on a card also at 480×640, where cuFFT returns one frame's
  spectra column-major);
- on a card (``gpu`` marker, skipped here): both paths bit for bit with as
  many launches of each counted kernel, and the keyframe chain check.

The ``data`` group case runs in ``tests/test_torch_parallel.py``.  This
file imports no JAX, so the ``gpu`` cases run on a card without it
(``--noconftest``).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import nislam_torch.core.pose_graph as tpg
from nislam_torch.core.config import (
    CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig, MapConfig, SlamConfig,
)
from nislam_torch.core.frame_graph import FrameGraph
from nislam_torch.core.slam import _init_step, make_engine, map_state, pack_outputs, solve_and_rederive, state_leaves
from nislam_torch.parallel import make_batch_engine
from nislam_torch.parallel.batch import _lane, _store_lane, eager_engine, run_chunk_eager, run_chunk_frame_graph
from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

torch.set_num_threads(1)  # see test_torch_batch.py

H, W = 64, 96
CPU = torch.device("cpu")
CHUNK = 20
LANES = 3
DROP_CAPACITY = 31  # the lanes insert 35 keyframes in 48 frames, the loops come before the 31st
WORKLOADS = ("ring", "drop")
CHAIN = ("last_fft", "last_polar", "last_filt", "last_filt_polar")


def _config(name="ring"):
    """``tests/test_torch_batch.py``'s config (the port's dataclasses)."""
    config = SlamConfig(
        cf=CFConfig(width=W, height=H, rotation_divisor=90, rotation_channel=48),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=0.08, max_angle=0.05, lower_response_thr=4.0, upper_response_thr=6.0,
        ),
        map=MapConfig(grid_scale=0.15, keyframe_capacity=64, edge_capacity=256),
        loop_closure=LoopClosureConfig(
            to_find_loop=True, position_response_thr=8.0, angle_response_thr=8.0,
            frame_gap_thr=20, distance_thr=0.8, max_candidates=64,
        ),
        camera=CameraConfig(image_width=W, image_height=H, height=1.0,
                            intrinsics=(100.0, W / 2.0, 100.0, H / 2.0)),
    )
    if name == "drop":
        return dataclasses.replace(config, map=dataclasses.replace(
            config.map, eviction="drop", keyframe_capacity=DROP_CAPACITY))
    return config


@pytest.fixture(scope="module")
def seqs():
    path = heading_loop_path(48, step=3.5, start=(256.0, 256.0), tail=8)
    return np.stack([render_sequence(make_world(512, 3.0, seed=s), H, W, path) for s in (1, 2, 5)])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


def _assert_states_equal(a, b) -> None:
    for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b), strict=True)):
        assert _same_bits(x, y), f"state leaf {i}"


def _run(engine, images):
    """``run_sequences`` + ``finalize`` → (states, outputs, solves between
    chunks, finalize's solves)."""
    tally = []
    states, outs = engine.run_sequences(engine.init_states(), images, chunk_frames=CHUNK, solve_tally=tally)
    states, ran = engine.finalize(states)
    return states, outs, tally, ran


@pytest.fixture(scope="module", params=WORKLOADS)
def runs(request, seqs):
    """One workload through the frame graph (frame by frame, with its flag
    read) and the eager loop, on one engine."""
    engine = make_batch_engine(_config(request.param), LANES, device="cpu")
    return types.SimpleNamespace(name=request.param, engine=engine,
                                 graph=_run(eager_engine(engine, run_chunk_frame_graph), seqs),
                                 eager=_run(eager_engine(engine), seqs))


def test_graph_path_equals_eager_path(runs):
    """(a) Bit for bit, and a body made for each number of lanes that
    inserted in a frame, stored and dropped keyframes among them."""
    (gs, go, gt, gr), (es, eo, et, er) = runs.graph, runs.eager
    assert pack_outputs(go).tobytes() == pack_outputs(eo).tobytes()
    assert gt == et and gr == er
    _assert_states_equal(gs, es)
    assert go.tracked.all() and any(map(any, gt))
    stored = go.keyframe_slot >= 0
    assert stored[:, 1:].any(axis=1).all() and go.loop_found.any(axis=1).all()
    # One body per number k of lanes that insert in a frame (the lanes
    # follow one path, so they insert together here: k = 3).
    k = go.inserted[:, 1:].sum(axis=0)
    assert set(runs.engine.frame_graph._branches) == set(k[k > 0].tolist()) and LANES in k
    if runs.name == "drop":
        assert (go.inserted & ~stored).any(axis=1).all()
        assert (gs.bank.count == DROP_CAPACITY).all()


def _problem(rng, lane: int, k: int = 12, e: int = 20) -> tpg.PoseGraphProblem:
    """A noisy chain of ``k`` poses with loop edges, slot 9 dead, the last
    two edges dead; lane 3's slot 10 is live but no live edge touches it,
    so its normal matrix is singular at every step (every step rejected)."""
    truth = np.cumsum(rng.normal(0.0, [0.5, 0.5, 0.2], (k, 3)), axis=0).astype(np.float32)
    pose_mask = np.ones(k, bool)
    pose_mask[9] = False
    live = [s for s in range(k) if pose_mask[s] and not (lane == 3 and s == 10)]
    pairs = list(zip(live[:-1], live[1:]))
    while len(pairs) < e - 2:
        a, b = rng.choice(live, 2, replace=False)
        pairs.append((int(a), int(b)))
    pairs += [(0, 9), (9, 1)]
    f, t = np.array(pairs, np.int32).T

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], b[2] - a[2]], np.float32)

    noise = 0.02 * (lane + 1)
    meas = np.stack([rel(truth[a], truth[b]) for a, b in pairs]) + rng.normal(0, noise, (e, 3)).astype(np.float32)
    init = truth + rng.normal(0, 0.3, truth.shape).astype(np.float32)
    edge_mask = np.ones(e, bool)
    edge_mask[-2:] = False
    sqrt_info = np.broadcast_to(np.diag([10.0, 10.0, 20.0]).astype(np.float32), (e, 3, 3))
    return tpg.PoseGraphProblem(*(torch.from_numpy(np.ascontiguousarray(v)) for v in (
        init, pose_mask, f, t, meas, sqrt_info, edge_mask)))


def _lane_problems():
    """``_problem``'s four lanes, alone and stacked."""
    rng = np.random.default_rng(7)
    probs = [_problem(rng, lane) for lane in range(4)]
    return probs, tpg.PoseGraphProblem(*(torch.stack(leaf) for leaf in zip(*probs)))


def _lanes_against_single(monkeypatch, cfg, scale_free):
    """One batched LM over ``_problem``'s four lanes against four single
    solves, bit for bit in poses, scale and cost, after as many
    iterations (its trace) → iterations per lane."""
    probs, stacked = _lane_problems()
    trace = []
    poses, scale, cost = tpg.solve_pose_graph_lanes(stacked, cfg, init_scale=1.0, scale_free=scale_free,
                                                    trace=trace)
    real, iterations = tpg._assemble_lanes, []

    def counted(*args, **kwargs):
        iterations[-1] += 1
        return real(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(tpg, "_assemble_lanes", counted)
        for r, prob in enumerate(probs):
            iterations.append(0)
            want = tpg.solve_pose_graph(prob, cfg, init_scale=1.0, scale_free=scale_free)
            for got, w in zip((poses[r], scale[r], cost[r]), want):
                assert _same_bits(got, w.reshape(got.shape)), f"lane {r}"
    assert [sum(f[r] is not None for f in trace) for r in range(4)] == iterations  # the trace's counts
    assert not any(f[3][0] for f in trace if f[3] is not None)  # lane 3 accepts no step
    # lane 3: every step rejected, μ × 10 each time from 1e-4 to its 1e8 cap
    assert iterations[3] >= 12, iterations
    return iterations


@pytest.mark.parametrize("estimate_scale,scale_free", [(False, False), (True, True)])
def test_lane_solve_equals_single_solves(monkeypatch, estimate_scale, scale_free):
    """(b) One batched LM over four lanes equals four single solves bit for
    bit: poses, scale and cost, after as many iterations (its trace).  The
    lanes stop at different iterations, and lane 3's normal matrix is
    never positive definite."""
    cfg = tpg.SolverConfig(max_iterations=30, estimate_scale=estimate_scale)
    iterations = _lanes_against_single(monkeypatch, cfg, scale_free)
    assert len(set(iterations[:3])) > 1, iterations  # lanes stop at different iterations


def test_lane_solve_freezes_stopped_lanes(monkeypatch):
    """(b) With a loose stop (rtol 1e-2) lanes 0 and 1 stop while their next
    step would be accepted (the same solve with rtol 0 shows it), and
    lanes 2 and 3 run on: the batched LM must keep each stopped lane's x
    and cost as they were, and its μ, as the single solves do."""
    cfg = tpg.SolverConfig(max_iterations=30, estimate_scale=True)
    iterations = _lanes_against_single(monkeypatch, dataclasses.replace(cfg, rtol=1e-2), True)
    on = []
    tpg.solve_pose_graph_lanes(_lane_problems()[1], dataclasses.replace(cfg, rtol=0.0), init_scale=1.0,
                               scale_free=True, trace=on)
    assert iterations[0] < iterations[2] and iterations[1] < iterations[2], iterations
    assert on[iterations[0]][0][0] and on[iterations[1]][1][0]  # their next steps, accepted


def test_optimize_equals_lane_solves(seqs):
    """(b) ``optimize`` after a chunk that closes loops in every lane equals
    ``solve_and_rederive`` of each triggered lane on its own, bit for bit
    in every state leaf."""
    engine = make_batch_engine(_config(), LANES, device="cpu")
    states, _ = engine.run_chunk(engine.init_states(), seqs[:, :40])
    want = map_state(states, torch.clone)
    states, ran = engine.optimize(states)
    assert ran == [True] * LANES
    for b in range(LANES):
        lane, before = _lane(want, b)
        _store_lane(want, b, before, solve_and_rederive(lane, config=engine.config, camera=engine.camera))
    _assert_states_equal(states, want)
    assert (states.pending.count == 0).all()


def test_bodies_make_no_host_read(monkeypatch, seqs):
    """(c) The last frame in which every lane stores a keyframe and searches,
    through the batch frame graph with every host read but
    ``FrameGraph.decide``'s, and every tensor built from host data,
    refused: its outputs equal the eager step's bit for bit."""
    engine = make_batch_engine(_config(), LANES, device="cpu")
    _, ref = run_chunk_eager(engine, engine.init_states(), seqs)
    j = int(np.flatnonzero((ref.keyframe_slot.numpy() >= 0).all(axis=0))[-1])
    feats = tuple(f[0] for f in engine._features(seqs[:, j:j + 1]))
    want_states, _ = run_chunk_eager(engine, engine.init_states(), seqs[:, :j])
    want = engine._step(want_states, feats, [True] * LANES)
    states, _ = engine.run_chunk(engine.init_states(), seqs[:, :j])
    graph = engine.frame_graph
    graph.load(states)
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
        decided.append(real_tolist(flags))
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
    assert decided == [[[True, True]] * LANES]
    assert want.loop_eligible.gt(0).all()  # every lane searched
    assert _same_bits(packed, want.pack())
    _assert_states_equal(graph.state, want_states)


def test_lent_state_rule(seqs):
    """(d) A chunk returns the graph's own buffers; passing that state back
    consumes it; a state kept while another runs keeps its values and gets
    buffers of its own, and runs on as a new engine's would; a state given
    from outside is only read."""
    config = _config()
    engine = make_batch_engine(config, LANES, device="cpu")
    first, _ = engine.run_chunk(engine.init_states(), seqs[:, :20])
    buffers = state_leaves(engine.frame_graph.state)
    assert all(x is y for x, y in zip(state_leaves(first), buffers, strict=True))
    again, _ = engine.run_chunk(first, seqs[:, 20:30])
    assert again is first
    kept = [x.clone() for x in state_leaves(first)]
    given, _ = engine.run_chunk(engine.init_states(), seqs[:, :1])  # the first frame, eagerly
    given_bits = [x.clone() for x in state_leaves(given)]
    other, _ = engine.run_chunk(given, seqs[:, 1:20])
    assert other is not given and other is not first
    assert all(_same_bits(x, y) for x, y in zip(state_leaves(first), kept, strict=True))
    assert not any(x is y for x, y in zip(state_leaves(first), buffers))
    assert all(_same_bits(x, y) for x, y in zip(state_leaves(given), given_bits, strict=True))
    fresh = make_batch_engine(config, LANES, device="cpu")
    want, _ = fresh.run_chunk(fresh.init_states(), seqs[:, :20])
    want, _ = fresh.run_chunk(want, seqs[:, 20:30])
    want, want_outs = fresh.run_chunk(want, seqs[:, 30:40])
    got, got_outs = engine.run_chunk(first, seqs[:, 30:40])
    assert _same_bits(got_outs.pack(), want_outs.pack())
    _assert_states_equal(got, want)


def _chain_check(config, dev: torch.device, first: np.ndarray, frame: np.ndarray) -> dict:
    """``frame`` made a keyframe by ``_init_step`` from a step's own front
    end (one (H, W) frame, as step mode computes it), and by the single
    engine's branch graph after ``first`` (every tracked frame a keyframe)
    → ``{leaf: equal}`` for the tracking chain's spectra, ``"row-major"``
    (the step's features), and ``"replay"``: the frame run again through
    the captured graphs (on a card) from the same state gives the first
    run's outputs."""
    config = dataclasses.replace(config, keyframe_selection=dataclasses.replace(
        config.keyframe_selection, max_distance=-1.0))
    engine = make_engine(config, dev)
    kw = dict(config=config, cf_ops=engine.cf_ops, camera=engine.camera)
    f0, f1 = (engine._features(torch.from_numpy(x)) for x in (first, frame))
    by_init, _ = _init_step(engine.init_state(), f1, **kw)
    start, _ = _init_step(engine.init_state(), f0, **kw)
    start_bits = map_state(start, torch.clone)
    graph = engine.frame_graph
    graph.load(start)
    first_run = graph.run(*f1).clone()
    by_branch = graph.lend(start)
    result = {name: _same_bits(getattr(by_init.track, name), getattr(by_branch.track, name)) for name in CHAIN}
    result["row-major"] = all(x.is_contiguous() for x in f1)
    assert bool(first_run[1] > 0.5) and int(first_run[14]) >= 0, "the frame was not stored as a keyframe"
    graph.load(start_bits)
    result["replay"] = _same_bits(graph.run(*f1), first_run)
    return result


def _white_noise_case():
    """``stagebench``'s keyframe row: a 480×640 white-noise frame tracked
    against itself, the bench config."""
    from nislam_torch.scripts import bench

    frame = np.random.default_rng(0).random((480, 640), dtype=np.float32)
    return bench.make_config(480, 640, 720, 480, 0, 8.0, keyframe_capacity=16, edge_capacity=16), frame


def test_init_and_branch_set_the_same_chain(seqs):
    """A keyframe's chain does not depend on which path made it: the two
    read equal features, row-major, through the same operations."""
    assert all(_chain_check(_config(), CPU, seqs[0, 0], seqs[0, 1]).values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured only on a card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_chain_on_the_card(cuda, seqs):
    """The keyframe chain check on the card, where the branch and the track
    graph are captured at their first run and replayed after it.  At
    480×640 cuFFT returns a single frame's spectra column-major; the
    front end's features are row-major, or the step's keyframe gets other
    filters (other bits, up to 0.05) than the branch's copies of them."""
    config, frame = _white_noise_case()
    for result in (_chain_check(_config(), cuda, seqs[0, 0], seqs[0, 1]), _chain_check(config, cuda, frame, frame)):
        assert all(result.values()), result


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_both_paths_on_the_card(cuda, seqs, name):
    """The chunk graph, the flag-read frame graph and the eager loop (each
    lane's branch on its own) on the card: bit for bit in outputs, solves
    and every state leaf, the two graphs with as many launches of each
    counted kernel (both run body k; the eager loop searches once per lane
    that stores); nothing is captured after the first run."""
    from nislam_torch.core.track_graph import COUNTED, CapturedStep

    engine = make_batch_engine(_config(name), LANES, device=cuda)
    images = torch.from_numpy(seqs).to(cuda)
    paths = {"graph": engine, "frame": eager_engine(engine, run_chunk_frame_graph), "eager": eager_engine(engine)}
    for eng in paths.values():
        _run(eng, images)  # captures
    captures = CapturedStep.captures
    results = {}
    for label, eng in paths.items():
        torch.cuda.synchronize()
        before = [w.launches for w in COUNTED]
        results[label] = (*_run(eng, images), [w.launches - b for w, b in zip(COUNTED, before)])
    assert CapturedStep.captures == captures
    gs, go, gt, gr, gl = results["graph"]
    assert gl[0] > 0 and gl == results["frame"][4]
    for label in ("frame", "eager"):
        ws, wo, wt, wr, _ = results[label]
        assert pack_outputs(go).tobytes() == pack_outputs(wo).tobytes(), label
        assert gt == wt and gr == wr, label
        _assert_states_equal(gs, ws)
