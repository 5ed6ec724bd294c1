"""Distributed SLAM engine: a keyframe bank sharded over ranks, edge-sharded solve.

Counterpart of ``nislam_tpu.parallel.engine``: the single engine's step
(``nislam_torch.core.slam``) on every rank, on the same frames, with its
two plug points set —

- **loop search** → :func:`~nislam_torch.parallel.loop_search.find_loop_closure_sharded`:
  each rank holds its block of the bank's spectra and cached filters and
  registers the query against its own candidates; one all-reduce of the
  per-rank winners picks the loop;
- **pose-graph solve** → :func:`~nislam_torch.parallel.solver.solve_pose_graph_cg`:
  each rank takes its block of the edges; every CG iteration costs one
  all-reduce of a (K, 3) vector.

Everything else (tracking, keyframe decisions, the stores, the deferred
driver) is the single engine's code, replicated: each rank tracks every
frame.  Device memory for the map's O(K·H·W) leaves shrinks 1/n per rank;
the per-slot tables (poses, cells, ids) stay replicated.  The solve is
always deferred to the chunk boundaries, as JAX's engine has it: the
engine's config is the caller's with ``optimizer.inline`` off.

Every rank must take the same host branch at every frame, or one rank
enters a collective that the others never join.  They do as long as each
rank's kernels are deterministic (cuFFT and ``peak_stats`` are: no float
atomics, merges in a fixed order) and the replicated state stays equal
(an all-reduce leaves the same bits on every rank).  The loop search
raises if the ranks searched for different frames.

Not carried over: the online stitcher (its eviction and recompute read
every stored keyframe image, which the ranks hold in blocks) is refused.
A sharded state is saved by :meth:`DistributedSlamEngine.gather` into a
full one first.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from nislam_torch.core.slam import SlamEngine, SlamState, init_state, make_engine, map_state
from nislam_torch.parallel.loop_search import find_loop_closure_sharded
from nislam_torch.parallel.mesh import RankGroup
from nislam_torch.parallel.solver import CGSolverConfig, solve_pose_graph_cg

# The bank leaves sharded over ranks; the others are replicated.
SHARDED = ("fft", "polar_fft", "filt", "filt_polar", "images")


class DistributedSlamEngine(SlamEngine):
    """One SLAM instance whose keyframe bank spans the ranks of ``group``;
    this object is one rank's part of it."""

    def __init__(self, config, cf_ops, camera, group: RankGroup, cg: CGSolverConfig):
        super().__init__(config, cf_ops, camera, group.device)
        self.group = group
        self.loop_search_fn = partial(find_loop_closure_sharded, group=group)
        self.solver_fn = partial(solve_pose_graph_cg, group=group, cfg=cg)

    def _block(self) -> slice:
        k = self.config.map.keyframe_capacity // self.group.size
        return slice(self.group.rank * k, (self.group.rank + 1) * k)

    def init_state(self) -> SlamState:
        return self.place(init_state(self.config, self.device))

    def place(self, state: SlamState) -> SlamState:
        """This rank's copy of a full single-engine state (e.g. from
        ``io.checkpoint.load_state``, or :meth:`gather`): its block of the
        sharded bank leaves, every other leaf whole, on this rank's device.
        Every rank must be given the same state."""
        blk = self._block()
        bank = dataclasses.replace(state.bank, **{name: getattr(state.bank, name)[blk] for name in SHARDED})
        out = map_state(dataclasses.replace(state, bank=bank), lambda x: x.to(self.device, copy=True))
        out.bank.shard_base = blk.start
        return out

    def gather(self, state: SlamState) -> SlamState:
        """The full single-engine state from every rank's sharded one (one
        all-reduce of the bits of each sharded leaf: exact), e.g. to save a
        checkpoint; the same on every rank."""
        blk = self._block()
        k = self.config.map.keyframe_capacity
        full = {}
        for name in SHARDED:
            part = getattr(state.bank, name)
            whole = torch.zeros((k,) + tuple(part.shape[1:]), dtype=part.dtype, device=part.device)
            if part.numel():
                bits = part.view(torch.int32 if part.element_size() == 4 else torch.int16)
                acc = torch.zeros(whole.shape, dtype=torch.int32, device=part.device)
                acc[blk] = bits.to(torch.int32)
                whole = self.group.all_reduce(acc).to(bits.dtype).view(part.dtype)
            full[name] = whole
        return dataclasses.replace(state, bank=dataclasses.replace(state.bank, **full))


def make_distributed_engine(config, group: RankGroup, cg: CGSolverConfig = CGSolverConfig()) -> DistributedSlamEngine:
    """This rank's part of a distributed engine over ``group`` (its
    ``bank`` axis), on ``group.device``.  The keyframe and edge capacities
    must divide by the group size."""
    if group.axis != "bank":
        raise ValueError(f"the distributed engine shards its bank over a 'bank' group, not {group.axis!r}")
    n = group.size
    for name in ("keyframe_capacity", "edge_capacity"):
        if getattr(config.map, name) % n:
            raise ValueError(f"{name} {getattr(config.map, name)} not divisible by {n} 'bank' ranks")
    if config.map_stitcher.stitch_map and config.map_stitcher.online:
        raise ValueError("the distributed engine does not run the online stitcher (map_stitcher.online): "
                         "see ROADMAP.md Queue 1, the distributed online canvas")
    config = dataclasses.replace(config, optimizer=dataclasses.replace(config.optimizer, inline=False))
    single = make_engine(config, group.device)
    return DistributedSlamEngine(config, single.cf_ops, single.camera, group, cg)
