"""Correlation-based loop closure: batched candidate re-registration.

Counterpart of ``nislam_tpu.core.loop_closure`` (exact path): gate the
whole bank (3×3 grid neighborhood, frame gap, travel distance), pick up to
``max_candidates`` eligible slots nearest the prior pose, register all of
them in one batched ``compute_pose(large_rotation=True)``, and accept the
best ``response.sum()`` if it clears both loop thresholds.  No host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nislam_torch.core.map_store import KeyframeBank, frames_in_neighborhood
from nislam_torch.ops.fft import r2c
from nislam_torch.ops.registration import CFOps, compute_pose


class LoopResult(NamedTuple):
    found: torch.Tensor  # () bool
    loop_slot: torch.Tensor  # () i32 winning bank slot
    relative_pose: torch.Tensor  # (3,) image plane, center-based
    response: torch.Tensor  # (3,) winner's (psr_t, psr_t, psr_r)
    eligible_count: torch.Tensor  # () i32 gating-eligible keyframes seen


def no_loop_result(device: torch.device) -> LoopResult:
    """The inert result of a skipped search."""
    return LoopResult(
        found=torch.zeros((), dtype=torch.bool, device=device),
        loop_slot=torch.zeros((), dtype=torch.int32, device=device),
        relative_pose=torch.zeros(3, dtype=torch.float32, device=device),
        response=torch.zeros(3, dtype=torch.float32, device=device),
        eligible_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _gating_mask(frame_ids, distances, cur_frame_id, cur_distance, candidate_mask, cfg):
    """Frame-gap and travel-distance gates; a threshold ≤ 0 disables its gate."""
    m = candidate_mask
    if cfg.frame_gap_thr > 0:
        m = m & (torch.abs(cur_frame_id - frame_ids) >= cfg.frame_gap_thr)
    if cfg.distance_thr > 0:
        m = m & (torch.abs(cur_distance - distances) >= cfg.distance_thr)
    return m


def _batched_search(
    bank: KeyframeBank, image, cur_polar_fft, eligible, cf_ops: CFOps,
    max_candidates: int, cfg, prior_pose=None,
) -> LoopResult:
    if cfg.coarse_scale > 1:
        raise NotImplementedError("coarse-to-fine loop search (coarse_scale > 1) is not ported yet")
    k = bank.capacity
    c = min(max_candidates, k)
    n_eligible = eligible.to(torch.int32).sum().to(torch.int32)
    if prior_pose is None:
        score = eligible.float()
    else:
        d2 = torch.sum((bank.poses[:, :2] - prior_pose[:2]) ** 2, dim=-1)
        score = torch.where(eligible, -d2, -torch.inf)
    # Stable descending sort, not torch.topk: ties must go to the lowest
    # slot, as jax.lax.top_k orders them (without a prior pose every
    # eligible score ties).
    slots = torch.sort(score, descending=True, stable=True).indices[:c]
    picked = eligible[slots]

    zf = r2c(bank.fft[slots])
    zp = r2c(bank.polar_fft[slots])
    filters = (
        (r2c(bank.filt[slots]), r2c(bank.filt_polar[slots])) if bank.filt.shape[1] else None
    )
    pose, info = compute_pose(
        zf, image[None], zp, cur_polar_fft[None], cf_ops,
        large_rotation=True, filters=filters,
    )
    total = torch.where(picked, info.sum(dim=-1), -torch.inf)
    # Index with a one-element tensor: indexing with a 0-dim tensor would
    # read it back to the host.
    best = torch.argmax(total).reshape(1)
    best_info = info.index_select(0, best)[0]
    any_eligible = picked.any()
    found = any_eligible & (best_info[0] > cfg.position_response_thr) & (
        best_info[2] > cfg.angle_response_thr
    )
    return LoopResult(
        found=found,
        loop_slot=slots.index_select(0, best)[0].to(torch.int32),
        relative_pose=pose.index_select(0, best)[0],
        response=torch.where(any_eligible, best_info, -torch.inf),
        eligible_count=n_eligible,
    )


def find_loop_closure(
    bank: KeyframeBank, image, cur_polar_fft, cur_frame_id, cur_distance,
    prior_pose, cf_ops: CFOps, cfg, grid_scale: float,
) -> LoopResult:
    """Spatially gated search around ``prior_pose``."""
    near = frames_in_neighborhood(bank, prior_pose, grid_scale)
    eligible = _gating_mask(
        bank.frame_ids, bank.distances, cur_frame_id, cur_distance, near, cfg
    )
    return _batched_search(
        bank, image, cur_polar_fft, eligible, cf_ops, cfg.max_candidates, cfg,
        prior_pose=prior_pose,
    )


def find_loop_closure_all(*args, **kwargs) -> LoopResult:
    """Exhaustive search over the whole bank: not ported yet."""
    raise NotImplementedError("find_loop_closure_all is not ported yet")
