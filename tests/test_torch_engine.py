"""The torch engine against the JAX engine and the golden trajectory, on the CPU.

- the pose-graph solve against ``solve_pose_graph`` on a fixed random graph
  (atol 1e-4);
- ``state_from_numpy`` / ``state_to_numpy`` round trip, bf16 bank included;
- steps from the same converted mid-sequence state in both engines;
- the slice: the golden workload of tests/test_golden.py through the torch
  engine reproduces tests/golden_trajectory.txt (flags exactly, poses atol
  2e-3) and the JAX engine's per-frame outputs (decisions exactly, poses
  atol 2e-3, responses rtol 1e-3 — PSRs of two f32 FFT chains, see
  test_torch_ops.py);
- the same with ``optimizer.inline`` and with ``map_stitcher.online``;
- ``step_packed`` and the streamed driver against ``step`` and
  ``run_sequence``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nislam_torch.core.pose_graph as tpg
import nislam_tpu.core.pose_graph as jpg
import nislam_tpu.core.se2 as jse2
from nislam_torch.core.slam import make_engine, state_from_numpy, state_to_numpy
from nislam_tpu.core.slam import chunked_deferred_drive
from nislam_tpu.core.slam import make_engine as make_jax_engine
from nislam_tpu.core.stitcher import occupancy_grid as jax_occupancy_grid
from nislam_tpu.utils.synthetic import heading_loop_path, make_world, render_sequence

from test_golden import _read_golden

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _golden_config():
    from nislam_tpu.core.config import (
        CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig, MapConfig, SlamConfig,
    )

    h, w = 96, 128
    return SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=360, rotation_channel=96),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=0.10, max_angle=0.05, lower_response_thr=4.0, upper_response_thr=6.0,
        ),
        map=MapConfig(grid_scale=0.15, keyframe_capacity=128, edge_capacity=512),
        loop_closure=LoopClosureConfig(
            to_find_loop=True, position_response_thr=8.0, angle_response_thr=8.0,
            frame_gap_thr=30, distance_thr=1.0, max_candidates=8,
        ),
        camera=CameraConfig(image_width=w, image_height=h, height=1.0,
                            intrinsics=(100.0, w / 2.0, 100.0, h / 2.0)),
    )


@pytest.fixture(scope="module")
def golden_run():
    """The golden workload through the JAX engine, with the state saved
    (as numpy) at the start of the second chunk."""
    config = _golden_config()
    world = make_world(1024, 3.0, seed=1234)
    frames = render_sequence(world, 96, 128, heading_loop_path(100, step=5.5, tail=10))
    engine = make_jax_engine(config)
    state = engine.init_state()
    state, outs1 = chunked_deferred_drive(engine, state, jnp.asarray(frames[:32]), chunk_frames=32)
    mid = jax.tree.map(np.asarray, state)
    state, outs2 = chunked_deferred_drive(engine, state, jnp.asarray(frames[32:]), chunk_frames=32)
    state, _ = engine.finalize(state)
    outs = jax.tree.map(lambda a, b: np.concatenate([a, b]), outs1, outs2)
    return types.SimpleNamespace(config=config, frames=frames, mid=mid, outs=outs,
                                 final=jax.tree.map(np.asarray, state))


def _random_problem(rng, k=12, e=30, dead_edges=4):
    poses = np.cumsum(rng.standard_normal((k, 3)) * [0.5, 0.5, 0.3], axis=0).astype(np.float32)
    poses[0] = 0.0
    f = rng.integers(0, k - 2, e).astype(np.int32)
    t = (f + rng.integers(1, 3, e)).astype(np.int32)
    true_rel = np.asarray(jse2.relative_pose(jnp.asarray(poses[f]), jnp.asarray(poses[t])))
    meas = (true_rel + rng.standard_normal((e, 3)) * [0.02, 0.02, 0.01]).astype(np.float32)
    init = (poses + rng.standard_normal((k, 3)) * [0.2, 0.2, 0.1]).astype(np.float32)
    init[0] = poses[0]
    info = np.tile(np.eye(3, dtype=np.float32), (e, 1, 1)) * rng.uniform(0.5, 2.0, (e, 1, 1)).astype(np.float32)
    mask = np.ones(e, bool)
    mask[:dead_edges] = False
    pose_mask = np.ones(k, bool)
    pose_mask[-1] = False  # a dead slot stays put
    return dict(poses=init, pose_mask=pose_mask, from_slot=f, to_slot=t, T=meas, info=info, edge_mask=mask)


def _problems(p):
    j = jpg.PoseGraphProblem(
        poses=jnp.asarray(p["poses"]), pose_mask=jnp.asarray(p["pose_mask"]),
        from_slot=jnp.asarray(p["from_slot"]), to_slot=jnp.asarray(p["to_slot"]),
        T=jnp.asarray(p["T"]), sqrt_info=jpg.sqrt_information(jnp.asarray(p["info"])),
        edge_mask=jnp.asarray(p["edge_mask"]),
    )
    t = tpg.PoseGraphProblem(
        poses=torch.from_numpy(p["poses"]), pose_mask=torch.from_numpy(p["pose_mask"]),
        from_slot=torch.from_numpy(p["from_slot"]), to_slot=torch.from_numpy(p["to_slot"]),
        T=torch.from_numpy(p["T"]), sqrt_info=tpg.sqrt_information(torch.from_numpy(p["info"])),
        edge_mask=torch.from_numpy(p["edge_mask"]),
    )
    return t, j


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_pose_graph_solve_matches(rng, estimate_scale):
    t, j = _problems(_random_problem(rng))
    np.testing.assert_allclose(t.sqrt_info.numpy(), np.asarray(j.sqrt_info), rtol=1e-6)
    scale = 1.1 if estimate_scale else 1.0
    th, tg, tc = tpg._assemble_normal_eqs(t.poses, t, torch.tensor(scale), estimate_scale)
    jh, jg, jc = jpg._assemble_normal_eqs(j.poses, j, jnp.float32(scale), estimate_scale)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    tcfg = tpg.SolverConfig(estimate_scale=estimate_scale)
    jcfg = jpg.SolverConfig(estimate_scale=estimate_scale)
    tp, ts, tcost = tpg.solve_pose_graph(t, tcfg, init_scale=1.0, scale_free=estimate_scale)
    jp, js, jcost = jpg.solve_pose_graph(j, jcfg, init_scale=1.0, scale_free=estimate_scale)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(float(ts), float(js), atol=1e-4)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(tp.numpy()[0], np.asarray(jp)[0])  # base pinned
    np.testing.assert_array_equal(tp.numpy()[-1], t.poses.numpy()[-1])  # dead slot kept


def test_non_positive_definite_does_not_raise():
    """``cholesky_ex``: a non-PD information matrix or normal matrix is
    rejected by the caller's masks, as JAX's NaN factor is, never raised."""
    tpg.sqrt_information(torch.zeros(2, 3, 3))
    prob = tpg.PoseGraphProblem(
        poses=torch.tensor([[0.0, 0, 0], [1.0, 0, 0]]), pose_mask=torch.tensor([True, True]),
        from_slot=torch.tensor([0], dtype=torch.int32), to_slot=torch.tensor([1], dtype=torch.int32),
        T=torch.tensor([[1.0, 0, 0]]), sqrt_info=torch.zeros(1, 3, 3), edge_mask=torch.tensor([True]),
    )
    poses, _, _ = tpg.solve_pose_graph(prob)  # singular H: every step rejected
    np.testing.assert_array_equal(poses.numpy(), prob.poses.numpy())


def test_state_round_trip(golden_run):
    mid = golden_run.mid
    bf16 = types.SimpleNamespace(**{f.name: getattr(mid.bank, f.name) for f in dataclasses.fields(mid.bank)})
    for name in ("fft", "polar_fft", "filt", "filt_polar"):
        setattr(bf16, name, np.asarray(getattr(mid.bank, name)).astype(jnp.bfloat16))
    for bank in (mid.bank, bf16):
        tree = types.SimpleNamespace(bank=bank, edges=mid.edges, track=mid.track, pending=mid.pending)
        state = state_from_numpy(tree, CPU)
        assert (state.bank.fft.dtype == torch.bfloat16) == (bank is bf16)
        back = state_to_numpy(state)
        for part in ("bank", "edges", "track", "pending"):
            for f in dataclasses.fields(getattr(back, part)):
                got = getattr(getattr(back, part), f.name)
                want = np.asarray(getattr(getattr(tree, part), f.name))
                np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f"{part}.{f.name}")


def _assert_outputs_match(t, j, sl=slice(None)):
    for name in ("tracked", "inserted", "loop_found", "optimized", "frame_id",
                 "keyframe_slot", "loop_slot", "loop_eligible"):
        np.testing.assert_array_equal(getattr(t, name)[sl], np.asarray(getattr(j, name))[sl], err_msg=name)
    np.testing.assert_allclose(t.pose[sl], np.asarray(j.pose)[sl], atol=2e-3)
    np.testing.assert_allclose(t.cf_pose[sl], np.asarray(j.cf_pose)[sl], atol=2e-3)
    np.testing.assert_allclose(t.response[sl], np.asarray(j.response)[sl], rtol=1e-3)


def test_steps_from_converted_mid_state(golden_run):
    """Both engines continue from the same state at frame 32: one
    ``step``, then a whole chunk."""
    engine = make_engine(golden_run.config, CPU)
    frames = golden_run.frames
    state, out = engine.step(state_from_numpy(golden_run.mid, CPU), torch.from_numpy(frames[32]))
    first = jax.tree.map(lambda x: np.asarray(x)[32], golden_run.outs)
    _assert_outputs_match(
        jax.tree.map(lambda x: x.numpy()[None], out), jax.tree.map(lambda x: x[None], first)
    )
    state = state_from_numpy(golden_run.mid, CPU)
    state, outs = engine.run_chunk(state, frames[32:64])
    _assert_outputs_match(
        jax.tree.map(lambda x: x.numpy(), outs), jax.tree.map(lambda x: x[32:64], golden_run.outs)
    )


def test_slice_reproduces_golden_and_jax(golden_run):
    engine = make_engine(golden_run.config, CPU)
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), golden_run.frames, chunk_frames=32,
                                      solve_tally=tally)
    state, _ = engine.finalize(state)
    assert any(tally)
    kf = outs.keyframe_slot[outs.keyframe_slot >= 0]
    poses = state.bank.poses.numpy()[kf]
    flags = np.stack([outs.inserted, outs.loop_found, outs.optimized], axis=-1).astype(int)
    g_poses, g_flags = _read_golden()
    np.testing.assert_array_equal(flags, g_flags)
    np.testing.assert_allclose(poses, g_poses, atol=2e-3)
    _assert_outputs_match(outs, golden_run.outs)
    np.testing.assert_allclose(state.bank.poses.numpy(), golden_run.final.bank.poses, atol=2e-3)
    np.testing.assert_array_equal(state.edges.alive.numpy(), golden_run.final.edges.alive)
    np.testing.assert_array_equal(state.edges.types.numpy(), golden_run.final.edges.types)


def _option_config(option):
    """The golden config with the inline solve, or with the online canvas
    and a bank small enough that ring eviction retires keyframes from it."""
    config = _golden_config()
    if option == "inline":
        return dataclasses.replace(config, optimizer=dataclasses.replace(config.optimizer, inline=True))
    return dataclasses.replace(
        config,
        map=dataclasses.replace(config.map, keyframe_capacity=40),
        map_stitcher=dataclasses.replace(config.map_stitcher, online=True, canvas_size=1024),
    )


@pytest.mark.parametrize("option", ["inline", "online"])
def test_slice_options_match_jax(option):
    """The golden workload lengthened to 120 frames (a 30-frame tail back
    over the start, so loops are found on consecutive keyframes and the
    inline trigger fires) with ``optimizer.inline`` or
    ``map_stitcher.online``: decisions exactly, poses atol 2e-3.

    The online canvas equals ``recompute(bank)`` of the torch engine
    (weights exactly: the negated scatter retired every evicted keyframe).
    Against JAX's canvas the weights agree on all but a few cells: a pixel
    whose coordinate lies within the ~1e-6 pose difference of a cell
    boundary truncates to the neighbouring cell."""
    from nislam_torch.core.stitcher import make_canvas, occupancy_grid, recompute

    config = _option_config(option)
    world = make_world(1024, 3.0, seed=1234)
    frames = render_sequence(world, 96, 128, heading_loop_path(120, step=5.5, tail=30))
    je = make_jax_engine(config)
    if option == "inline":
        js, jo = je.run_sequence(je.init_state(), jnp.asarray(frames))
    else:
        js, jo = chunked_deferred_drive(je, je.init_state(), jnp.asarray(frames), chunk_frames=40)
    js, _ = je.finalize(js)
    engine = make_engine(config, CPU)
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), frames, chunk_frames=40, solve_tally=tally)
    state, _ = engine.finalize(state)
    _assert_outputs_match(outs, jax.tree.map(np.asarray, jo))
    np.testing.assert_allclose(state.bank.poses.numpy(), np.asarray(js.bank.poses), atol=2e-3)
    if option == "inline":
        assert outs.optimized.any() and not tally  # solved in the step, never between chunks
        return
    assert any(tally) and int(np.asarray(js.bank.overflow)) > 0  # solves and evictions
    fresh = recompute(make_canvas(config.map_stitcher, CPU), state.bank, engine.camera)
    assert torch.equal(state.canvas.weight, fresh.weight)
    torch.testing.assert_close(state.canvas.data, fresh.data, rtol=1e-5, atol=1e-2)
    jw = np.asarray(js.canvas.weight)
    tw = state.canvas.weight.numpy()
    assert tw.sum() == jw.sum() > 0
    assert (tw != jw).sum() <= 1e-2 * (jw != 0).sum()
    tg, jg = occupancy_grid(state.canvas).numpy(), np.asarray(jax_occupancy_grid(js.canvas))
    assert (tg != jg).sum() <= 1e-2 * (jg >= 0).sum()


def test_online_canvas_needs_stored_images():
    config = _option_config("online")
    config = dataclasses.replace(config, map=dataclasses.replace(config.map, store_images=False))
    with pytest.raises(ValueError, match="store_images"):
        make_engine(config, CPU)


def test_step_packed_and_streamed_drive(golden_run):
    """``step_packed`` is ``step`` in one (17,) vector; the streamed driver
    over host chunks (a short tail, a ``max_frames`` cut) equals
    ``run_sequence`` with the same chunking; empty sources give empty
    outputs."""
    from nislam_torch.core.slam import (
        dead_step_output, empty_step_output, streamed_deferred_drive, unpack_step_output,
    )

    engine = make_engine(golden_run.config, CPU)
    frames = golden_run.frames
    s1, out = engine.step(engine.init_state(), torch.from_numpy(frames[0]))
    s1, out = engine.step(s1, torch.from_numpy(frames[1]))
    s2, packed = engine.step_packed(engine.init_state(), torch.from_numpy(frames[0]))
    s2, packed = engine.step_packed(s2, torch.from_numpy(frames[1]))
    assert packed.shape == (17,)
    for got, want in zip(unpack_step_output(packed.numpy()), out):
        np.testing.assert_array_equal(np.asarray(got), want.numpy().astype(np.asarray(got).dtype))

    n = 70
    times = np.arange(n) / 30.0
    chunks = ((frames[i:i + 32], times[i:i + 32]) for i in range(0, 100, 32))
    state, outs, ts, ran = streamed_deferred_drive(engine, engine.init_state(), chunks, max_frames=n)
    tally = []
    ref_state, ref = engine.run_sequence(engine.init_state(), torch.from_numpy(frames[:n]),
                                         chunk_frames=32, solve_tally=tally)
    assert len(ran) == 3 and ran == tally and len(outs.tracked) == n
    np.testing.assert_array_equal(ts, times)
    for got, want in zip(outs, ref):
        np.testing.assert_array_equal(got, want)
    assert torch.equal(state.bank.poses, ref_state.bank.poses)
    _, empty, ts, ran = streamed_deferred_drive(engine, engine.init_state(), iter(()))
    assert len(empty.tracked) == 0 and len(ts) == 0 and ran == []
    _, empty = engine.run_sequence(engine.init_state(), frames[:0])
    assert len(empty.tracked) == 0
    assert empty_step_output().pose.shape == (0, 3)
    dead = dead_step_output((2,))
    assert dead.keyframe_slot.tolist() == [-1, -1] and not dead.tracked.any()
