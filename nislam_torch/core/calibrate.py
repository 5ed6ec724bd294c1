"""Per-deployment threshold calibration from a dataset's own frames.

Counterpart of ``nislam_tpu.core.calibrate`` on the port's registration
ops.  ``derive_response_thresholds`` scales the reference's 640×480
anchors by the √area law, which holds across sizes; the anchor itself
depends on the texture.  This measures the matched and no-match PSR
anchors on the first K frames of the dataset and on the synthetic gaussian
anchor texture at the same config, and rescales the derived thresholds by
the ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from nislam_torch.core.camera import make_camera_ops
from nislam_torch.core.config import derive_response_thresholds
from nislam_torch.ops.registration import compute_intermedium, compute_pose, make_cf_ops


def measure_psr_anchors(config, images: np.ndarray, device: torch.device) -> Dict[str, float]:
    """Matched (consecutive frames) and no-match (frames half the window
    apart) PSR anchors of ``images`` under ``config``: medians and deciles
    of the translation and rotation PSR.  The no-match pairs only mean
    something if the camera moves a frame width over the window;
    ``nomatch_suspect`` flags when it did not."""
    n = images.shape[0]
    if n < 4:
        raise ValueError(f"calibration needs ≥4 frames, got {n}")
    cf_ops = make_cf_ops(config.cf).to(device)
    camera = make_camera_ops(config.camera).to(device)
    imgs = torch.as_tensor(np.asarray(images)).to(device)
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) / 255.0

    def pair_info(a: int, b: int) -> np.ndarray:
        ua = camera.undistort(imgs[a])
        ub = camera.undistort(imgs[b])
        fa, pa = compute_intermedium(ua, cf_ops)
        _, pb = compute_intermedium(ub, cf_ops)
        _, info = compute_pose(fa, ub, pa, pb, cf_ops, large_rotation=False)
        return info.cpu().numpy()

    matched = np.stack([pair_info(i, i + 1) for i in range(n - 1)])
    half = n // 2
    garbage = np.stack([pair_info(i, i + half) for i in range(min(half, 8))])
    mt, mr = matched[:, 0].astype(np.float64), matched[:, 2].astype(np.float64)
    gt, gr = garbage[:, 0].astype(np.float64), garbage[:, 2].astype(np.float64)
    return {
        "matched_t_median": float(np.median(mt)),
        "matched_t_q10": float(np.quantile(mt, 0.1)),
        "matched_r_median": float(np.median(mr)),
        "matched_r_q10": float(np.quantile(mr, 0.1)),
        "nomatch_t_q90": float(np.quantile(gt, 0.9)),
        "nomatch_r_q90": float(np.quantile(gr, 0.9)),
        "nomatch_suspect": bool(np.quantile(gt, 0.5) > 0.5 * np.median(mt)),
        "pairs": int(n - 1),
    }


def _synthetic_anchor(config, device: torch.device, n_frames: int = 12) -> Dict[str, float]:
    """The same probe on the gaussian synthetic texture the derived
    thresholds were anchored on."""
    from nislam_torch.utils.synthetic import make_world, render_sequence, straight_path

    h, w = config.cf.height, config.cf.width
    world_n = 1 << int(np.ceil(np.log2(4 * max(h, w))))
    world = make_world(world_n, 3.0, seed=7)
    step = max(2.0, w / 32.0)
    frames = render_sequence(
        world, h, w, straight_path(n_frames, step=step, start=(world_n / 2.0,) * 2)
    ).astype(np.float32)
    return measure_psr_anchors(config, frames, device)


def calibrate_thresholds(
    config, images: np.ndarray, device: torch.device
) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Texture-rescaled thresholds and diagnostics.  The derived thresholds
    are multiplied by the dataset's matched-PSR median over the synthetic
    anchor's, clamped to [0.25, 4]."""
    data = measure_psr_anchors(config, images, device)
    synth = _synthetic_anchor(config, device)
    rt = float(np.clip(data["matched_t_median"] / max(synth["matched_t_median"], 1e-6), 0.25, 4.0))
    rr = float(np.clip(data["matched_r_median"] / max(synth["matched_r_median"], 1e-6), 0.25, 4.0))
    base = derive_response_thresholds(
        config.cf.width, config.cf.height, config.cf.rotation_divisor, config.cf.rotation_channel
    )
    thr = {
        "lower_response_thr": round(base["lower_response_thr"] * rt, 2),
        "upper_response_thr": round(base["upper_response_thr"] * rt, 2),
        "lower_rotation_response_thr": round(base["lower_rotation_response_thr"] * rr, 2),
        "upper_rotation_response_thr": round(base["upper_rotation_response_thr"] * rr, 2),
        "position_response_thr": round(base["position_response_thr"] * rt, 2),
        "angle_response_thr": round(base["angle_response_thr"] * rr, 2),
    }
    diag = {
        **{f"data_{k}": v for k, v in data.items()},
        **{f"synth_{k}": v for k, v in synth.items()},
        "texture_ratio_translation": round(rt, 3),
        "texture_ratio_rotation": round(rr, 3),
        # q10 of the matched PSR over the lower gate (> 1: the gate admits
        # ≥ 90 % of matched frames)
        "margin_tracking": round(data["matched_t_q10"] / max(thr["lower_response_thr"], 1e-6), 2),
        "margin_rotation": round(
            data["matched_r_q10"] / max(thr["lower_rotation_response_thr"], 1e-6), 2
        ),
        # the no-match q90 must sit below the loop gates
        "separation_position": round(
            thr["position_response_thr"] / max(data["nomatch_t_q90"], 1e-6), 2
        ),
        "separation_angle": round(thr["angle_response_thr"] / max(data["nomatch_r_q90"], 1e-6), 2),
    }
    return thr, diag


def apply_thresholds(config, thr: Dict[str, float]):
    """A copy of ``config`` with the calibrated thresholds installed."""
    return dataclasses.replace(
        config,
        keyframe_selection=dataclasses.replace(
            config.keyframe_selection,
            lower_response_thr=thr["lower_response_thr"],
            upper_response_thr=thr["upper_response_thr"],
            lower_rotation_response_thr=thr["lower_rotation_response_thr"],
            upper_rotation_response_thr=thr["upper_rotation_response_thr"],
        ),
        loop_closure=dataclasses.replace(
            config.loop_closure,
            position_response_thr=thr["position_response_thr"],
            angle_response_thr=thr["angle_response_thr"],
        ),
    )
