"""Loop-closure search over a keyframe bank sharded across ranks.

Counterpart of ``nislam_tpu.parallel.loop_search``.  Each rank holds its
block of the bank's spectra and filters (``bank.shard_base`` onward); the
per-slot tables and the query are the same on every rank.  Each rank
gates its slots, keeps up to its cap of candidates nearest the prior pose,
registers them in one batched ``compute_pose(large_rotation=True)`` (the
``peak_stats`` kernel on the card) and takes its local best; one
``all_reduce`` of an (n, 11) record carries every rank's winner, and the
winner over ranks is the first maximum, as ``jnp.argmax`` takes it.
Compute per rank scales 1/n; communication is O(n), not O(K).

Gating is the single-card search's (``nislam_torch.core.loop_closure``):
3×3 grid neighbourhood, frame gap, travel distance, winner by total
response, threshold acceptance.

:class:`ShardedSearch` is the distributed engine's plug point: the search
eagerly, and the same search split at its one collective (the local part,
the all-reduce, the merge), whose device parts a keyframe branch of
captured steps replays, as JAX runs the sharded search inside its one
compiled scan.
"""

from __future__ import annotations

import torch

from nislam_torch.core.loop_closure import LoopResult, _gating_mask, _take
from nislam_torch.core.map_store import KeyframeBank, grid_location
from nislam_torch.ops.fft import r2c
from nislam_torch.ops.registration import CFOps, compute_pose
from nislam_torch.parallel.mesh import RankGroup

# The winner record of one rank: total response, global slot, pose (3),
# response (3), any candidate, eligible count, frame id.
RECORD = 11


def _check_shard(bank: KeyframeBank, group: RankGroup) -> int:
    """This rank's block of ``bank``'s spectra → its slots per rank;
    raises if the bank is not sharded over ``group``."""
    n, k = group.size, bank.capacity
    if k % n:
        raise ValueError(f"bank capacity {k} not divisible by {n} ranks")
    local_k = k // n
    if bank.fft.shape[0] != local_k or bank.shard_base != group.rank * local_k:
        raise ValueError(f"rank {group.rank}'s bank holds {bank.fft.shape[0]} slots from "
                         f"{bank.shard_base}, not its block of {local_k}")
    return local_k


def _local_row(bank: KeyframeBank, image, cur_polar_fft, cur_frame_id, cur_distance, prior_pose, cf_ops: CFOps,
               cfg, grid_scale: float, n: int, local_k: int) -> torch.Tensor:
    """The search's local part on this rank's block of ``bank`` (``n``
    ranks of ``local_k`` slots): gating, the candidates nearest the prior
    pose, their batched registration, the local best → this rank's
    (RECORD,) row of the winner record.  No collective, no host read."""
    per_rank = cfg.max_candidates_per_shard or -(-cfg.max_candidates // n)
    c = min(per_rank, local_k)
    lo = bank.shard_base
    dev = bank.poses.device

    blk = slice(lo, lo + local_k)
    valid = (torch.arange(lo, lo + local_k, device=dev) < bank.count)
    cur_cell = grid_location(prior_pose[:2], grid_scale)
    near = torch.all(torch.abs(bank.grid_xy[blk] - cur_cell[None, :]) <= 1, dim=-1)
    eligible = _gating_mask(bank.frame_ids[blk], bank.distances[blk], cur_frame_id,
                            cur_distance, near & valid, cfg)
    d2 = torch.sum((bank.poses[blk, :2] - prior_pose[:2]) ** 2, dim=-1)
    # Stable descending sort, not torch.topk: ties go to the lowest slot.
    idx = torch.sort(torch.where(eligible, -d2, -torch.inf), descending=True, stable=True).indices[:c]
    picked = eligible[idx]
    filters = (
        (r2c(bank.filt[idx]), r2c(bank.filt_polar[idx])) if bank.filt.shape[1] else None
    )
    pose, info = compute_pose(
        r2c(bank.fft[idx]), image[None], r2c(bank.polar_fft[idx]), cur_polar_fft[None], cf_ops,
        large_rotation=True, filters=filters,
    )
    total = torch.where(picked, info.sum(dim=-1), -torch.inf)
    best = torch.argmax(total).reshape(1)
    f32 = lambda x: torch.as_tensor(x, device=dev).to(torch.float32).reshape(-1)
    return torch.cat([
        _take(total, best).reshape(1), f32(_take(idx, best) + lo), _take(pose, best),
        _take(info, best), f32(picked.any()), f32(eligible.sum()), f32(cur_frame_id),
    ])


def _merge(rec: torch.Tensor, cfg) -> LoopResult:
    """The winner over ranks of the all-reduced (n, RECORD) record: the
    first maximum of the totals among the ranks with a candidate, then the
    thresholds.  No host read."""
    anys = rec[:, 8] > 0.5
    w = torch.argmax(torch.where(anys, rec[:, 0], -torch.inf)).reshape(1)
    win = _take(rec, w)
    any_any = anys.any()
    best_info = win[5:8]
    found = any_any & (best_info[0] > cfg.position_response_thr) & (
        best_info[2] > cfg.angle_response_thr
    )
    return LoopResult(
        found=found,
        loop_slot=win[1].to(torch.int32),
        relative_pose=win[2:5],
        response=torch.where(any_any, best_info, -torch.inf),
        eligible_count=rec[:, 9].sum().to(torch.int32),
    )


def find_loop_closure_sharded(
    bank: KeyframeBank, image, cur_polar_fft, cur_frame_id, cur_distance, prior_pose,
    cf_ops: CFOps, cfg, grid_scale: float, group: RankGroup, cur_fft=None,
) -> LoopResult:
    """Sharded-bank search → the same :class:`LoopResult` on every rank.

    The per-rank candidate cap is ``cfg.max_candidates_per_shard`` or, by
    default (0), ``⌈max_candidates / n⌉``, so the total budget is the
    single search's ``max_candidates``.  A rank holding more eligible
    keyframes than its cap keeps those nearest the prior pose (ties to the
    lowest slot), the single search's rule applied per rank.

    Like JAX's, this search always ranks at full resolution: ``cur_fft``
    is accepted for the signature of ``find_loop_closure`` and unused.
    Raises if the ranks searched for different frames (their decisions
    diverged): one host read of the record's frame ids."""
    local_k = _check_shard(bank, group)
    row = _local_row(bank, image, cur_polar_fft, cur_frame_id, cur_distance, prior_pose, cf_ops, cfg, grid_scale,
                     group.size, local_k)
    rec = group.gather_rows(row)  # (n, RECORD), the same on every rank

    frame_ids = rec[:, 10].tolist()
    if any(f != frame_ids[group.rank] for f in frame_ids):
        raise RuntimeError(f"ranks diverged: loop searches for frames {frame_ids}")
    return _merge(rec, cfg)


class ShardedSearch:
    """The distributed engine's loop-search plug point over ``group``:
    called, it is :func:`find_loop_closure_sharded` (the eager search of
    the track-graph path); its staged form splits that search at its
    collective, for a keyframe branch that runs as captured steps
    (``core/slam.py``'s :func:`~nislam_torch.core.slam.staged_branch_parts`):

    - :meth:`local` (a step): the local part, its row written into a
      zero-filled (n, RECORD) record, a buffer of :meth:`record`;
    - :meth:`exchange` (the host): the record's all-reduce, the one
      collective, as :meth:`RankGroup.gather_rows` makes it;
    - :meth:`merge` (a step): the frame-id check folded into a word on the
      device, then the winner over ranks.

    The same bits as the eager search, and the same all-reduce by payload."""

    def __init__(self, group: RankGroup):
        self.group = group

    def __call__(self, bank, image, cur_polar_fft, cur_frame_id, cur_distance, prior_pose, cf_ops, cfg,
                 grid_scale, cur_fft=None) -> LoopResult:
        return find_loop_closure_sharded(bank, image, cur_polar_fft, cur_frame_id, cur_distance, prior_pose, cf_ops,
                                         cfg, grid_scale, self.group, cur_fft=cur_fft)

    def record(self, device) -> torch.Tensor:
        """A buffer for the (n, RECORD) winner record."""
        return torch.zeros((self.group.size, RECORD), dtype=torch.float32, device=device)

    def local(self, rec: torch.Tensor, bank: KeyframeBank, image, cur_polar_fft, cur_frame_id, cur_distance,
              prior_pose, cf_ops: CFOps, cfg, grid_scale: float) -> None:
        """The local part into ``rec``: zeros, this rank's row at its place."""
        row = _local_row(bank, image, cur_polar_fft, cur_frame_id, cur_distance, prior_pose, cf_ops, cfg, grid_scale,
                         self.group.size, _check_shard(bank, self.group))
        rec.zero_()
        rec[self.group.rank].copy_(row)

    def exchange(self, rec: torch.Tensor) -> None:
        """The record's all-reduce, in place (on the host)."""
        self.group.all_reduce(rec)

    @staticmethod
    def merge(rec: torch.Tensor, cur_frame_id: torch.Tensor, cfg, diverged: torch.Tensor) -> LoopResult:
        """The winner of the all-reduced ``rec``.  A record whose rows hold
        another frame id than ``cur_frame_id`` (this rank's) means the ranks
        searched for different frames: ``diverged`` ((1,) int32, 0 while
        none did) takes this frame id + 1, unless it holds one already, for
        the host to read before its next collective."""
        mismatch = (rec[:, 10] != cur_frame_id.to(torch.float32)).any()
        diverged.copy_(torch.where((diverged == 0) & mismatch, cur_frame_id + 1, diverged))
        return _merge(rec, cfg)
