"""The torch batch engine against ``nislam_tpu.parallel.batch``, on the CPU.

Three lanes, each its own world (seeds 1, 2, 5) on the same 48-frame loop
that comes back over its start, so the deferred loop search finds loops
and the between-chunk trigger solves; chunks of 20 leave a tail of 8.
These worlds' true matches win clearly, so no registration peak is a
near-tie that another f32 rounding could resolve differently.  Seed 3's
world has one: a rotation peak between two 4° polar bins, which the batch
engine and the single engine (whose front end and tracking run at another
batch size) resolve to different bins.
Per lane: decisions, slots and loop slots equal, the pending buffers
equal, poses within 2e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nislam_torch.core.slam import make_engine
from nislam_torch.parallel import make_batch_engine
from nislam_tpu.core.config import (
    CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig, MapConfig, SlamConfig,
)
from nislam_tpu.parallel.batch import make_batch_engine as make_jax_batch_engine
from nislam_tpu.utils.synthetic import heading_loop_path, make_world, render_sequence

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

H, W = 64, 96
CPU = torch.device("cpu")
POSE_ATOL = 2e-3
DECISIONS = ("tracked", "inserted", "loop_found", "optimized", "frame_id", "keyframe_slot",
             "loop_slot", "loop_eligible")


def _config():
    return SlamConfig(
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


@pytest.fixture(scope="module")
def seqs():
    path = heading_loop_path(48, step=3.5, start=(256.0, 256.0), tail=8)
    return np.stack([render_sequence(make_world(512, 3.0, seed=s), H, W, path) for s in (1, 2, 5)])


def _angle_wrapped(d):
    d = np.array(d)
    d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return d


def test_batch_engine_matches_jax_batch_engine(seqs):
    cfg = _config()
    je = make_jax_batch_engine(cfg, batch=3)
    js, jo = je.run_sequences(je.init_states(), jnp.asarray(seqs), chunk_frames=20)
    js, jran = je.finalize(js)
    jo, js = jax.tree.map(np.asarray, jo), jax.tree.map(np.asarray, js)

    engine = make_batch_engine(cfg, 3, device="cpu")
    tally = []
    states, outs = engine.run_sequences(engine.init_states(), seqs, chunk_frames=20, solve_tally=tally)
    assert len(tally) == 3 and any(any(r) for r in tally)  # the tail chunk's trigger included
    assert int(outs.loop_found.sum()) >= 3
    pending = [states.pending.count.clone(), states.pending.loop_slot.clone(),
               states.pending.cur_slot.clone()]
    states, ran = engine.finalize(states)

    for name in DECISIONS:
        np.testing.assert_array_equal(getattr(outs, name), getattr(jo, name), err_msg=name)
    np.testing.assert_allclose(outs.pose, jo.pose, atol=POSE_ATOL)
    np.testing.assert_allclose(outs.response, jo.response, rtol=5e-4)
    assert ran == np.asarray(jran).tolist()
    bank, jbank = states.bank, js.bank
    for name in ("count", "frame_ids", "grid_xy", "overflow"):
        np.testing.assert_array_equal(getattr(bank, name).numpy(), getattr(jbank, name), err_msg=name)
    np.testing.assert_allclose(bank.poses.numpy(), jbank.poses, atol=POSE_ATOL)
    for name in ("from_slot", "to_slot", "types", "alive", "count"):
        np.testing.assert_array_equal(getattr(states.edges, name).numpy(), getattr(js.edges, name),
                                      err_msg=name)
    np.testing.assert_array_equal(states.pending.count.numpy(), js.pending.count)
    np.testing.assert_array_equal(states.track.last_slot.numpy(), js.track.last_slot)
    np.testing.assert_allclose(states.track.last_pose.numpy(), js.track.last_pose, atol=POSE_ATOL)

    # The pending buffers before finalize: the same matches, lane by lane,
    # as the JAX engine holds after the same three chunks.
    js3 = je.init_states()
    for start in range(0, 48, 20):
        sl = jnp.asarray(seqs[:, start:start + 20])
        if sl.shape[1] < 20:
            pad = 20 - sl.shape[1]
            sl = jnp.concatenate([sl, jnp.repeat(sl[:, -1:], pad, axis=1)], axis=1)
            js3, _ = je.run_chunk_masked(js3, sl, jnp.arange(20) < 20 - pad)
        else:
            js3, _ = je.run_chunk(js3, sl)
        js3, _ = je.optimize(js3)
    count = np.asarray(js3.pending.count)
    np.testing.assert_array_equal(pending[0].numpy(), count)
    for b in range(3):
        k = count[b]
        np.testing.assert_array_equal(pending[1][b, :k].numpy(), np.asarray(js3.pending.loop_slot)[b, :k])
        np.testing.assert_array_equal(pending[2][b, :k].numpy(), np.asarray(js3.pending.cur_slot)[b, :k])


def test_batch_lanes_match_single_engine(seqs):
    """Each lane equals the single engine's deferred sequence loop at the same
    chunking: decisions exactly, poses within 2e-3 (angles modulo 2π: a
    heading at ±π may round to either side)."""
    cfg = _config()
    engine = make_batch_engine(cfg, 3, device="cpu")
    states, outs = engine.run_sequences(engine.init_states(), seqs, chunk_frames=20)
    states, _ = engine.finalize(states)
    single = make_engine(cfg, CPU)
    for b in range(3):
        st, so = single.run_sequence(single.init_state(), seqs[b], chunk_frames=20)
        st, _ = single.finalize(st)
        for name in DECISIONS:
            np.testing.assert_array_equal(getattr(so, name), getattr(outs, name)[b], err_msg=name)
        assert np.abs(_angle_wrapped(so.pose - outs.pose[b])).max() <= POSE_ATOL
        assert np.abs(_angle_wrapped(st.bank.poses.numpy() - states.bank.poses[b].numpy())).max() <= POSE_ATOL


def test_batch_engine_edges(seqs):
    """An empty chunk, a lane count that does not match, and a resumed
    run: two half-sequences through ``run_chunk`` equal one chunk."""
    engine = make_batch_engine(_config(), 3, device="cpu")
    states, outs = engine.run_sequences(engine.init_states(), seqs[:, :0])
    assert outs.tracked.shape == (3, 0) and outs.pose.shape == (3, 0, 3)
    with pytest.raises(ValueError, match="lanes"):
        engine.run_chunk(engine.init_states(), seqs[:2, :4])
    with pytest.raises(ValueError):
        make_batch_engine(_config(), 0, device="cpu")
    a, one = engine.run_chunk(engine.init_states(), seqs[:, :12])
    a, two = engine.run_chunk(a, seqs[:, 12:24])
    b, whole = engine.run_chunk(engine.init_states(), seqs[:, :24])
    for x, y, z in zip(one, two, whole):
        np.testing.assert_array_equal(torch.cat([x, y], dim=1).numpy(), z.numpy())
    assert torch.equal(a.bank.poses, b.bank.poses) and torch.equal(a.pending.count, b.pending.count)
