"""Correlation-based loop closure: batched candidate re-registration.

Counterpart of ``nislam_tpu.core.loop_closure``: gate the whole bank (3×3
grid neighborhood, frame gap, travel distance), pick up to
``max_candidates`` eligible slots nearest the prior pose, register all of
them in one batched ``compute_pose(large_rotation=True)``, and accept the
best ``response.sum()`` if it clears both loop thresholds.  With
``coarse_scale > 1`` the candidates are ranked at 1/s resolution and only
the winner is registered at full resolution (:func:`_coarse_fine_search`).
No host sync on either path.

:func:`find_loop_closure_lanes` is the same search over gathered lanes of
a lanes-first bank (the batch engine's keyframe branch): the gates and the
candidate order per lane, one batched registration over every lane's
candidates, each lane's own argmax and acceptance.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from nislam_torch.core.map_store import KeyframeBank, frames_in_neighborhood, grid_location
from nislam_torch.ops.fft import by_lane, impulse_spectrum_pair, irfft2, r2c, rfft2, spectral_crop
from nislam_torch.ops.registration import CFOps, compute_pose, estimate_rotation, estimate_trans
from nislam_torch.ops.warp import rotate_wrap_fft_spectrum


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


@functools.lru_cache(maxsize=8)
def _impulse_target(h: int, w: int, device: torch.device) -> torch.Tensor:
    """Complex KCC target at ``(h, w)`` on ``device``, built once."""
    return r2c(torch.from_numpy(impulse_spectrum_pair(h, w)).to(device))


def _take(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """``x[best]`` for a one-element index tensor: indexing with a 0-dim
    tensor would read it back to the host."""
    return x.index_select(0, best)[0]


def _accept(best_pose, best_info, best_slot, picked, n_eligible, cfg) -> LoopResult:
    any_eligible = picked.any()
    found = any_eligible & (best_info[0] > cfg.position_response_thr) & (
        best_info[2] > cfg.angle_response_thr
    )
    return LoopResult(
        found=found,
        loop_slot=best_slot.to(torch.int32),
        relative_pose=best_pose,
        response=torch.where(any_eligible, best_info, -torch.inf),
        eligible_count=n_eligible,
    )


def _coarse_fine_search(
    bank: KeyframeBank, image, cur_fft, cur_polar_fft, picked, slots, cf_ops: CFOps,
    cfg, n_eligible,
) -> LoopResult:
    """Coarse-to-fine candidate evaluation (``coarse_scale`` = s > 1).

    1. Exact rotation of every candidate from the full polar spectra.
    2. Coarse translation registration of both 180° hypotheses at 1/s
       resolution: both sides go through :func:`spectral_crop`, and the
       coarse filter is solved from the cropped keyframe spectrum.  The
       score ``2·s·max(cpsr) + info_rot`` stands in for ``response.sum()``
       (translation PSR grows with √area); ties go to the first maximum.
    3. Exact full-resolution registration of the winner only, reusing its
       stage-1 rotation; the full-resolution image filter is gathered for
       that one slot.
    """
    cf = cf_ops.cfg
    s = cfg.coarse_scale
    ishape = (cf.height, cf.width)
    cshape = (cf.height // s, cf.width // s)
    cached = bool(bank.filt.shape[1])
    zf = r2c(bank.fft[slots])  # (C, H, W2)
    zp = r2c(bank.polar_fft[slots])
    filt_polar = r2c(bank.filt_polar[slots]) if cached else None

    degree, info_rot = estimate_rotation(zp, cur_polar_fft[None], cf_ops, filt_polar)  # (C,)

    cur_cimg = irfft2(spectral_crop(cur_fft, ishape, s), cshape)
    rfc = rotate_wrap_fft_spectrum(cur_cimg[None], -degree)  # (C, Hs, Ws2)
    rot2 = torch.stack([rfc, torch.conj(rfc)], dim=-3)  # (C, 2, Hs, Ws2)
    zc = spectral_crop(zf, ishape, s)
    ctgt = _impulse_target(*cshape, zc.device)
    _, cpsr = estimate_trans(zc[:, None], rot2, ctgt, cshape, cf, filt=None)  # (C, 2)
    score = 2.0 * s * torch.amax(cpsr, dim=-1) + info_rot
    best = torch.argmax(torch.where(picked, score, -torch.inf)).reshape(1)
    best_slot = _take(slots, best)

    filters = (
        (r2c(_take(bank.filt, best_slot.reshape(1))), _take(filt_polar, best))
        if cached else None
    )
    pose, info = compute_pose(
        _take(zf, best), image, _take(zp, best), cur_polar_fft, cf_ops,
        large_rotation=True, filters=filters,
        rotation=(_take(degree, best), _take(info_rot, best)),
    )
    return _accept(pose, info, best_slot, picked, n_eligible, cfg)


def _batched_search(
    bank: KeyframeBank, image, cur_polar_fft, eligible, cf_ops: CFOps,
    max_candidates: int, cfg, prior_pose=None, cur_fft=None,
) -> LoopResult:
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

    if cfg.coarse_scale > 1:
        if cur_fft is None:
            cur_fft = rfft2(image)
        return _coarse_fine_search(
            bank, image, cur_fft, cur_polar_fft, picked, slots, cf_ops, cfg, n_eligible
        )
    zf = r2c(bank.fft[slots])
    zp = r2c(bank.polar_fft[slots])
    filters = (
        (r2c(bank.filt[slots]), r2c(bank.filt_polar[slots])) if bank.filt.shape[1] else None
    )
    pose, info = compute_pose(
        zf, image[None], zp, cur_polar_fft[None], cf_ops,
        large_rotation=True, filters=filters,
    )
    best = torch.argmax(torch.where(picked, info.sum(dim=-1), -torch.inf)).reshape(1)
    return _accept(_take(pose, best), _take(info, best), _take(slots, best), picked, n_eligible, cfg)


def find_loop_closure(
    bank: KeyframeBank, image, cur_polar_fft, cur_frame_id, cur_distance,
    prior_pose, cf_ops: CFOps, cfg, grid_scale: float, cur_fft=None,
) -> LoopResult:
    """Spatially gated search around ``prior_pose``.  ``cur_fft`` (the
    frame's image spectrum) saves the coarse path a transform."""
    near = frames_in_neighborhood(bank, prior_pose, grid_scale)
    eligible = _gating_mask(
        bank.frame_ids, bank.distances, cur_frame_id, cur_distance, near, cfg
    )
    return _batched_search(
        bank, image, cur_polar_fft, eligible, cf_ops, cfg.max_candidates, cfg,
        prior_pose=prior_pose, cur_fft=cur_fft,
    )


def find_loop_closure_all(
    bank: KeyframeBank, image, cur_polar_fft, cur_frame_id, cur_distance,
    cf_ops: CFOps, cfg,
) -> LoopResult:
    """Exhaustive search: every live, gate-passing slot is a candidate."""
    eligible = _gating_mask(
        bank.frame_ids, bank.distances, cur_frame_id, cur_distance, bank.valid_mask(), cfg
    )
    return _batched_search(bank, image, cur_polar_fft, eligible, cf_ops, bank.capacity, cfg)


def _rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` (any shape, i64) of ``x``'s flattened (B·K, ...) view
    of a lanes-first (B, K, ...) leaf → rows.shape + x.shape[2:]."""
    flat = x.view((-1,) + tuple(x.shape[2:]))
    return flat[rows.reshape(-1)].reshape(tuple(rows.shape) + tuple(x.shape[2:]))


def _take_lanes(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """``x[j, best[j]]`` for each lane j of x (k, C, ...): :func:`_take` per
    lane, with no 0-dim index."""
    k, c = x.shape[0], x.shape[1]
    flat = x.reshape((k * c,) + tuple(x.shape[2:]))
    return flat[torch.arange(k, device=best.device) * c + best]


def _accept_lanes(best_pose, best_info, best_slot, picked, n_eligible, stored, cfg) -> LoopResult:
    """:func:`_accept` per lane, each result counted only where ``stored``
    (a lane whose bank dropped its keyframe searched for nothing)."""
    any_eligible = picked.any(dim=-1)
    found = any_eligible & (best_info[:, 0] > cfg.position_response_thr) & (
        best_info[:, 2] > cfg.angle_response_thr
    )
    return LoopResult(
        found=found & stored,
        loop_slot=best_slot.to(torch.int32),
        relative_pose=best_pose,
        response=torch.where(any_eligible[:, None], best_info, -torch.inf),
        eligible_count=torch.where(stored, n_eligible, 0),
    )


def find_loop_closure_lanes(
    bank: KeyframeBank, lanes: torch.Tensor, image, cur_polar_fft, cur_fft, cur_frame_id, cur_distance,
    prior_pose, stored, cf_ops: CFOps, cfg, grid_scale: float,
) -> LoopResult:
    """:func:`find_loop_closure` for k gathered lanes at once: lane j
    searches the bank of lane ``lanes[j]`` of a lanes-first bank (leaves
    (B, K, ...)) for its frame (``image`` (k, H, W), the spectra (k, ...),
    the ids, distances and prior poses (k, ...)).  Per lane the
    neighbourhood, the gates and a stable descending sort of its (K,)
    scores; the candidates' spectra and filters gathered at rows ``lane·K
    + slot``; ONE batched registration over the (k, C) candidates, each
    response reduced as the lane's own search reduces it (``lanes=k``);
    then each lane's argmax and acceptance.  A lane's result counts only
    where ``stored`` (k,) holds (``found`` and ``eligible_count`` masked).
    No host sync, no 0-dim index."""
    kcap = bank.poses.shape[1]
    nl = lanes.shape[0]
    count = bank.count[lanes]
    grid = bank.grid_xy[lanes]  # (k, K, 2)
    poses = bank.poses[lanes]
    cur = grid_location(prior_pose[:, :2], grid_scale)
    valid = torch.arange(kcap, device=count.device) < count[:, None]
    near = torch.all(torch.abs(grid - cur[:, None, :]) <= 1, dim=-1) & valid
    eligible = _gating_mask(bank.frame_ids[lanes], bank.distances[lanes],
                            cur_frame_id[:, None], cur_distance[:, None], near, cfg)
    c = min(cfg.max_candidates, kcap)
    n_eligible = eligible.to(torch.int32).sum(dim=-1).to(torch.int32)
    d2 = torch.sum((poses[:, :, :2] - prior_pose[:, None, :2]) ** 2, dim=-1)
    score = torch.where(eligible, -d2, -torch.inf)
    # Stable descending sort per lane, not torch.topk (see _batched_search).
    slots = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :c]  # (k, C)
    picked = eligible.gather(1, slots)
    rows = lanes[:, None] * kcap + slots
    zf = r2c(_rows(bank.fft, rows))  # (k, C, H, W2)
    zp = r2c(_rows(bank.polar_fft, rows))
    cached = bool(bank.filt.shape[2])
    if cfg.coarse_scale > 1:
        cf = cf_ops.cfg
        s = cfg.coarse_scale
        ishape = (cf.height, cf.width)
        cshape = (cf.height // s, cf.width // s)
        filt_polar = r2c(_rows(bank.filt_polar, rows)) if cached else None
        degree, info_rot = estimate_rotation(zp, cur_polar_fft[:, None], cf_ops, filt_polar, lanes=nl)  # (k, C)
        cur_cimg = by_lane(lambda f: irfft2(spectral_crop(f, ishape, s), cshape), nl, cur_fft)
        rfc = by_lane(rotate_wrap_fft_spectrum, nl, cur_cimg[:, None], -degree)  # (k, C, Hs, Ws2)
        rot2 = torch.stack([rfc, torch.conj(rfc)], dim=-3)  # (k, C, 2, Hs, Ws2)
        zc = spectral_crop(zf, ishape, s)
        ctgt = _impulse_target(*cshape, zc.device)
        _, cpsr = estimate_trans(zc[:, :, None], rot2, ctgt, cshape, cf, filt=None, lanes=nl)  # (k, C, 2)
        score = 2.0 * s * torch.amax(cpsr, dim=-1) + info_rot
        best = torch.argmax(torch.where(picked, score, -torch.inf), dim=-1)
        best_slot = _take_lanes(slots, best)
        filters = (
            (r2c(_rows(bank.filt, lanes * kcap + best_slot)), _take_lanes(filt_polar, best))
            if cached else None
        )
        pose, info = compute_pose(
            _take_lanes(zf, best), image, _take_lanes(zp, best), cur_polar_fft, cf_ops,
            large_rotation=True, filters=filters,
            rotation=(_take_lanes(degree, best), _take_lanes(info_rot, best)), lanes=nl,
        )
        return _accept_lanes(pose, info, best_slot, picked, n_eligible, stored, cfg)
    filters = (r2c(_rows(bank.filt, rows)), r2c(_rows(bank.filt_polar, rows))) if cached else None
    pose, info = compute_pose(
        zf, image[:, None], zp, cur_polar_fft[:, None], cf_ops,
        large_rotation=True, filters=filters, lanes=nl,
    )
    best = torch.argmax(torch.where(picked, info.sum(dim=-1), -torch.inf), dim=-1)
    return _accept_lanes(_take_lanes(pose, best), _take_lanes(info, best), _take_lanes(slots, best), picked,
                         n_eligible, stored, cfg)
