"""Scaling figures of the multi-rank layer that do not depend on timing.

Counterpart of ``nislam_tpu.utils.scaling``:

- :func:`shard_work_stats` — the sharded loop search's work per rank,
  exact by shape (a copy of the JAX function);
- :func:`collective_bytes_loop_search` and :func:`collective_bytes_solver`
  — the payload bytes one sharded search and one GN-CG solve move, read
  from the :class:`~nislam_torch.parallel.mesh.RankGroup`'s counts over
  one call.  The search moves one (n, 11) f32 record whatever the bank's
  K; the solve moves a (2, K, 3) vector per Gauss-Newton step, a (K, 3)
  vector per CG iteration and the final cost.

JAX's ``collective_bytes_from_hlo`` (reads XLA's HLO) and
``partition_overhead_bound`` (times a virtual CPU mesh) have no
counterpart here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def shard_work_stats(
    *, keyframe_capacity: int, nshards: int, max_candidates: int
) -> Dict[str, float]:
    """Static per-shard work of the sharded loop search — exact by shape."""
    slots = keyframe_capacity // nshards
    regs = min(max_candidates, slots)
    return {
        "slots_per_shard": slots,
        "registrations_per_shard": regs,
        # Every shard executes the identical static program: balance is
        # exact (1.0) unless capacity does not divide the shard count.
        "balance": 1.0 if keyframe_capacity % nshards == 0 else round(
            slots / (slots + 1), 3
        ),
    }


def _counted_bytes(group, fn) -> int:
    before = group.collective_bytes()
    fn()
    return group.collective_bytes() - before


def collective_bytes_loop_search(group, config) -> int:
    """Payload bytes of one sharded loop search over ``group`` on an empty
    bank of ``config``'s size (every rank calls it)."""
    import torch

    from nislam_torch.parallel.engine import make_distributed_engine

    engine = make_distributed_engine(config, group)
    state = engine.init_state()
    cf, dev = config.cf, group.device
    polar = torch.zeros((cf.polar_shape[0], cf.polar_shape[1] // 2 + 1), dtype=torch.complex64, device=dev)
    return _counted_bytes(group, lambda: engine.loop_search_fn(
        state.bank, torch.zeros((cf.height, cf.width), device=dev), polar,
        torch.zeros((), dtype=torch.int32, device=dev), torch.zeros((), device=dev),
        torch.zeros(3, device=dev), engine.cf_ops, config.loop_closure, config.map.grid_scale,
    ))


def chain_problem(keyframes: int, edge_capacity: int, *, seed: int = 0, device="cpu"):
    """A pose graph the size of a map: ``keyframes`` poses along a wavy
    path, edges i → i+d for d = 1, 2, 4, 8, … while they fit
    ``edge_capacity`` (odometry and its skips), each measured with 2 cm of
    noise; the initial poses integrate the noisy odometry.  All slots
    live; the unused edge slots masked."""
    import torch

    from nislam_torch.core.pose_graph import PoseGraphProblem
    from nislam_torch.core.se2 import absolute_pose, relative_pose

    k, e = keyframes, edge_capacity
    rng = np.random.default_rng(seed)
    steps = torch.zeros((k, 3), dtype=torch.float64)
    steps[:, 0] = 0.5
    steps[:, 2] = torch.from_numpy(0.1 * rng.standard_normal(k))
    gt = [torch.zeros(3, dtype=torch.float64)]
    for i in range(1, k):
        gt.append(absolute_pose(gt[-1], steps[i]))
    gt = torch.stack(gt)
    fr, to = [], []
    d = 1
    while d < k and len(fr) + k - d <= e:
        fr.extend(range(k - d))
        to.extend(range(d, k))
        d *= 2
    live = len(fr)
    meas = torch.zeros((e, 3), dtype=torch.float64)
    meas[:live] = relative_pose(gt[fr], gt[to])
    meas[:live, :2] += torch.from_numpy(0.02 * rng.standard_normal((live, 2)))
    init = [torch.zeros(3, dtype=torch.float64)]
    for i in range(k - 1):  # the first k - 1 edges are the odometry
        init.append(absolute_pose(init[-1], meas[i]))
    slots = lambda a: torch.tensor(a + [0] * (e - live), dtype=torch.int32, device=device)
    return PoseGraphProblem(
        poses=torch.stack(init).to(device=device, dtype=torch.float32),
        pose_mask=torch.ones(k, dtype=torch.bool, device=device),
        from_slot=slots(fr), to_slot=slots(to), T=meas.to(device=device, dtype=torch.float32),
        sqrt_info=torch.eye(3, device=device).expand(e, 3, 3).contiguous(),
        edge_mask=torch.arange(e, device=device) < live,
    )


def collective_bytes_solver(group, *, keyframe_capacity: int, edge_capacity: int) -> int:
    """Payload bytes of one GN-CG solve over ``group`` of
    :func:`chain_problem` at these capacities (every rank calls it).  The
    CG iteration count, and so the bytes, depend on the data."""
    from nislam_torch.parallel.solver import solve_pose_graph_cg

    prob = chain_problem(keyframe_capacity, edge_capacity, device=group.device)
    return _counted_bytes(group, lambda: solve_pose_graph_cg(prob, group))
