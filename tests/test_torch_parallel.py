"""The multi-rank layer against ``nislam_tpu.parallel``, on the CPU.

Ranks are subprocesses that run this file as a worker (``__main__``
below): gloo over ``tcp://127.0.0.1:<free port>``, CPU tensors, one thread
each, no JAX.  Each world size is ONE launch that runs every check for
that size and writes each rank's results to an ``.npz``; each launch has
its own timeout, so a hang fails its tests without eating the suite's
clock, and the launches run one after the other, so that few processes
compete with the suite's other workers.  JAX runs in the pytest process
on the conftest's virtual devices (``make_mesh({...: n},
devices=jax.devices()[:n])``) while the ranks run.  Inputs are made once
from seeds with numpy and shared as files.

Held against JAX, world sizes 2 and 4 (this file):

- ``solve_pose_graph_cg`` on a chain graph with dead slots: every rank the
  same; within 1e-4 of JAX's GN-CG and 2e-3 of dense LM; slot 0 and dead
  slots untouched;
- ``find_loop_closure_sharded`` on a bank from a revisiting run: found,
  slot and eligible count equal, pose within 1e-4, response at rtol 5e-4
  (two f32 FFT chains, ROADMAP Queue 3), and equal to the single search;
  and the truncation case of ``tests/test_parallel.py`` (a per-rank cap of
  2 keeps the candidates nearest the prior pose);
- the collective bytes of one search (one (n, 11) f32 record, whatever
  the bank's K) and of one solve (the record sizes times the calls).

The engines (world size 2) are held in ``test_torch_parallel_engines.py``,
which launches this worker too.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

H, W = 64, 96
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
POSE_ATOL = 2e-3

# The suite runs in parallel worker processes: keep torch from taking every core.
torch.set_num_threads(2)


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
    from nislam_torch.parallel.solver import CGSolverConfig, solve_pose_graph_cg
    from nislam_torch.utils.scaling import collective_bytes_loop_search, collective_bytes_solver

    out = {}
    e = data["solve_from"].shape[0]
    prob = PoseGraphProblem(
        poses=torch.from_numpy(data["solve_poses"]), pose_mask=torch.from_numpy(data["solve_mask"]),
        from_slot=torch.from_numpy(data["solve_from"]), to_slot=torch.from_numpy(data["solve_to"]),
        T=torch.from_numpy(data["solve_T"]), sqrt_info=torch.eye(3).expand(e, 3, 3).contiguous(),
        edge_mask=torch.from_numpy(data["solve_edge_mask"]),
    )
    before = group.counts.copy()
    poses, cost = solve_pose_graph_cg(prob, group, CGSolverConfig(outer_iterations=30, cg_iterations=100))
    out.update(solve_poses=poses.numpy(), solve_cost=cost.numpy(), solve_counts=_counts(group, before))

    out.update(_rank_search(group, data, "search", search_config(tconfig)))
    out.update(_rank_search(group, data, "trunc", trunc_config(tconfig)))

    cfg = search_config(tconfig)
    big = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, keyframe_capacity=128))
    out["search_bytes"] = np.array([collective_bytes_loop_search(group, c) for c in (cfg, big)])
    before = group.counts.copy()
    out["chain_bytes"] = np.array(collective_bytes_solver(group, keyframe_capacity=64, edge_capacity=128))
    out["chain_counts"] = _counts(group, before)
    return out


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
    else:
        import test_torch_parallel_engines as engines

        out = engines.rank_engines(group, data, workdir)
    np.savez(os.path.join(workdir, f"{what}_{world}_rank{rank}.npz"), **out)
    assert "jax" not in sys.modules and "nislam_tpu" not in sys.modules
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
    """The inputs, then in threads (XLA compiles and subprocesses run
    outside the interpreter lock) JAX's references and the launches, one
    world size after the other; each test waits for what it reads."""
    from nislam_tpu.core import config as jconfig

    workdir = str(tmp_path_factory.mktemp("ranks"))
    data = {**_solve_inputs(), **_search_inputs()}
    np.savez(os.path.join(workdir, "inputs.npz"), **data)
    with ThreadPoolExecutor(3) as ex:
        runs = ex.submit(lambda: {n: launch(n, workdir, "checks") for n in (2, 4)})
        jax_refs = {
            ("search", 2): ex.submit(_jax_search, data, "search", search_config(jconfig), 2),
            ("search", 4): ex.submit(_jax_search, data, "search", search_config(jconfig), 4),
            ("trunc", 4): ex.submit(_jax_search, data, "trunc", trunc_config(jconfig), 4),
            ("solve", 2): ex.submit(_jax_solve, data, 2),
            ("solve", 4): ex.submit(_jax_solve, data, 4),
        }
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


@pytest.mark.parametrize("n", [2, 4])
def test_cg_solve_matches_jax(ranks, n):
    data = ranks.data
    jcg, jcost, dense = ranks.jax[("solve", n)].result()
    results = ranks.results(n)
    got = _same_on_every_rank(results, "solve_poses")
    np.testing.assert_allclose(got, jcg, atol=1e-4)
    np.testing.assert_allclose(got[:24], dense[:24], atol=POSE_ATOL)
    np.testing.assert_allclose(_same_on_every_rank(results, "solve_cost"), jcost, rtol=1e-3)
    np.testing.assert_array_equal(got[0], data["solve_poses"][0])  # the pinned base
    np.testing.assert_array_equal(got[24:], data["solve_poses"][24:])  # dead slots


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
    """Capacities that do not divide, the wrong axis, the online stitcher;
    no process group is needed to refuse."""
    import dataclasses

    from nislam_torch.core import config as tconfig
    from nislam_torch.parallel import make_batch_engine, make_distributed_engine, make_fleet_engine
    from nislam_torch.parallel.mesh import RankGroup

    cfg = slam_config(tconfig)
    bank3 = RankGroup(rank=0, size=3, axis="bank", device=torch.device("cpu"))
    with pytest.raises(ValueError, match="keyframe_capacity"):
        make_distributed_engine(cfg, bank3)
    bank2 = dataclasses.replace(bank3, size=2)
    with pytest.raises(ValueError, match="online stitcher"):
        make_distributed_engine(dataclasses.replace(
            cfg, map_stitcher=dataclasses.replace(cfg.map_stitcher, stitch_map=True, online=True)), bank2)
    with pytest.raises(ValueError, match="'data'"):
        make_fleet_engine(cfg, bank2)
    with pytest.raises(ValueError, match="'bank'"):
        make_distributed_engine(cfg, dataclasses.replace(bank2, axis="data"))
    with pytest.raises(ValueError, match="divisible"):
        make_batch_engine(cfg, 3, device="cpu", group=dataclasses.replace(bank2, axis="data"))
    # the engine turns the inline solve off: the drive defers it
    inline = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, inline=True))
    assert not make_distributed_engine(inline, bank2).config.optimizer.inline


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
