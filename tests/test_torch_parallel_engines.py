"""The multi-rank engines against ``nislam_tpu.parallel``, on the CPU, 2 ranks.

One launch of two ranks (the worker of ``test_torch_parallel.py``: gloo,
CPU tensors, its own timeout) runs every check and writes each rank's
results; JAX runs in the pytest process on 2 virtual devices meanwhile,
in threads.
The workloads are ``tests/test_parallel.py``'s, on worlds whose true
matches win clearly (seeds 1, 2 and 5, and the default world of the
distributed engine's run), so no registration peak is a near-tie that
another f32 rounding could resolve differently (ROADMAP Queue 3).

- the distributed engine (bank sharded over 2 ranks, GN-CG solves between
  chunks of 16) against JAX's on a 2-device ``bank`` mesh (decisions
  equal, poses within 2e-3) and against the torch single engine
  (decisions equal, poses within 5e-3, dense LM against GN-CG); both ranks
  the same; ``gather`` of the sharded bank equal to the single engine's;
- a single-engine checkpoint resumed into ``place()`` and into a fleet
  lane, against the uninterrupted run;
- the fleet, deferred and inline, lane for lane against JAX's fleet on a
  2-device ``data`` mesh, with no collective inside ``run_chunk``;
- the batch engine with a ``data`` group, 4 lanes over 2 ranks, against
  JAX's batch engine on a 2-device ``data`` mesh.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_parallel import H, POSE_ATOL, W, launch, slam_config

# The suite runs in parallel worker processes: keep torch from taking every core.
torch.set_num_threads(2)

DECISIONS = ("tracked", "inserted", "loop_found", "frame_id", "keyframe_slot", "loop_slot")
CHUNK = 16  # the distributed engine's chunks: 56 frames leave a tail of 8
LANE_CHUNK = 20  # the fleet's and the batch engine's: 48 frames leave a tail of 8


def inline_config(cfgmod):
    base = slam_config(cfgmod, distance_thr=0.6)
    return dataclasses.replace(base, optimizer=dataclasses.replace(base.optimizer, inline=True))


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def rank_engines(group, data, workdir) -> dict:
    from nislam_torch.core import config as tconfig
    from nislam_torch.core.slam import init_state, pack_outputs
    from nislam_torch.io.checkpoint import load_state
    from nislam_torch.parallel import make_batch_engine, make_distributed_engine, make_fleet_engine
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
               engine_images=full.bank.images.numpy())

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
    bs, bo = batch.run_sequences(batch.init_states(), data["lane_seqs"], chunk_frames=LANE_CHUNK)
    bs, _ = batch.finalize(bs)
    out.update(batch_outs=pack_outputs(bo), batch_poses=bs.bank.poses.numpy())
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _jax_distributed(frames):
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core import config as jconfig
    from nislam_tpu.parallel.engine import make_distributed_engine
    from nislam_tpu.parallel.mesh import make_mesh

    je = make_distributed_engine(slam_config(jconfig), make_mesh({"bank": 2}, devices=jax.devices()[:2]))
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
    """Inputs, the launch, JAX's references in threads, and the torch
    single engine's reference run, all under way at once."""
    from nislam_torch.core import config as tconfig
    from nislam_torch.core.slam import make_engine
    from nislam_torch.io.checkpoint import save_state
    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence, square_loop_path

    workdir = str(tmp_path_factory.mktemp("engine_ranks"))
    frames = render_sequence(make_world(512, 3.0), H, W,
                             heading_loop_path(56, step=3.5, start=(256.0, 256.0), tail=10))
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
        runs = ex.submit(launch, 2, workdir, "engines")
        jax_refs = {
            "distributed": ex.submit(_jax_distributed, frames),
            "deferred": ex.submit(_jax_fleet, data["lane_seqs"][:2], "deferred"),
            "inline": ex.submit(_jax_fleet, data["inline_seqs"], "inline"),
            "batch": ex.submit(_jax_batch, data["lane_seqs"]),
        }
        ref, ref_outs = single.run_sequence(single.init_state(), frames, chunk_frames=CHUNK)
        ref, _ = single.finalize(ref)
        yield SimpleNamespace(data=data, results=runs.result, ref=ref, ref_outs=ref_outs, jax=jax_refs)


def _both(results, key):
    r0, r1 = results()
    np.testing.assert_array_equal(r0[key], r1[key], err_msg=f"{key}: the ranks differ")
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
