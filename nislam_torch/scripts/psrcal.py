"""PSR threshold calibration: how the peak-to-sidelobe ratio scales with size.

    python -m nislam_torch.scripts.psrcal [--sizes 96 128 192 256 384] [--frames 64]
        [--families gaussian ...] [--device cuda]

Counterpart of ``scripts/psrcal.py``.  Runs the tracker at several square
image sizes over the same world and trajectory (in units of the view: a
step of W/64 px per frame) and reports the tracked frames' PSR quantiles
for translation and rotation, then the fitted power-law exponents of the
median PSR against W·H.  ``derive_response_thresholds``
(``nislam_torch/core/config.py``) scales the reference's 640×480 anchors
by the square root of the area, an exponent of 0.5; the fit is printed
beside it.  The JAX script measured the law with XLA's FFT on the CPU;
this measures it with the port's FFT chain on ``--device`` (cuFFT on the
card).

``--device cuda`` (the default) fails when no card is present; it never
falls back to the CPU.  ``--device cpu`` runs the same sweep on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from nislam_torch.scripts.common import asked_device, card_line

ASSUMED_EXPONENT = 0.5  # derive_response_thresholds' square-root-of-area law


def run_size(h: int, w: int, n_frames: int, family: str = "gaussian", device="cpu") -> dict:
    """Track ``n_frames`` of the heading loop at (h, w) in one chunk, with
    thresholds low enough that every frame tracks → the tracked frames'
    PSR quantiles (q10, median, q90) for translation and rotation."""
    from nislam_torch.core.config import (
        CameraConfig, CFConfig, KeyframeSelectionConfig, LoopClosureConfig, MapConfig, SlamConfig,
    )
    from nislam_torch.core.slam import make_engine
    from nislam_torch.utils.synthetic import add_sensor_noise, heading_loop_path, make_world, render_sequence

    rd, rc = 360, max(96, h // 2)
    fx = float(w)
    px = 1.0 / fx
    step_px = w / 64.0  # a constant fraction of the view per frame across sizes
    world_n = 1 << int(np.ceil(np.log2(4 * max(h, w))))
    config = SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=rd, rotation_channel=rc),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=10.0 * step_px * px, max_angle=0.05236,
            # Low thresholds: every frame tracks and its PSRs are recorded.
            lower_response_thr=0.5, upper_response_thr=1.0,
        ),
        map=MapConfig(grid_scale=0.3 * h * px, keyframe_capacity=max(64, n_frames // 2),
                      edge_capacity=4 * n_frames, store_images=False),
        loop_closure=LoopClosureConfig(to_find_loop=False),
        camera=CameraConfig(image_width=w, image_height=h, height=1.0, intrinsics=(fx, w / 2.0, fx, h / 2.0)),
    )
    sigma = 1.5 if family == "powerlaw" else 3.0
    world = make_world(world_n, sigma, family=family)
    poses = heading_loop_path(n_frames, step=step_px, start=(world_n / 2.0, world_n / 2.0))
    frames = add_sensor_noise(render_sequence(world, h, w, poses))
    engine = make_engine(config, torch.device(device))
    _, outs = engine.run_chunk(engine.init_state(), torch.from_numpy(frames).to(device))
    resp = outs.response.cpu().numpy()
    tracked = outs.tracked.cpu().numpy().astype(bool)
    r = resp[tracked]
    return {
        "h": h, "w": w, "rd": rd, "rc": rc, "n": int(tracked.sum()),
        "trans_q10": float(np.quantile(r[:, 0], 0.1)),
        "trans_med": float(np.median(r[:, 0])),
        "trans_q90": float(np.quantile(r[:, 0], 0.9)),
        "rot_q10": float(np.quantile(r[:, 2], 0.1)),
        "rot_med": float(np.median(r[:, 2])),
        "rot_q90": float(np.quantile(r[:, 2], 0.9)),
    }


def fit_exponents(rows) -> tuple:
    """Slopes of log(median PSR) against log(W·H) → (translation, rotation)."""
    logn = np.log([r["h"] * r["w"] for r in rows])
    trans = np.polyfit(logn, np.log([r["trans_med"] for r in rows]), 1)[0]
    rot = np.polyfit(logn, np.log([r["rot_med"] for r in rows]), 1)[0]
    return float(trans), float(rot)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[96, 128, 192, 256, 384])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--families", nargs="+", default=["gaussian"],
                    help="texture families (gaussian powerlaw blobs fibrous)")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    device = asked_device(args.device, "psrcal")
    print(f"device: {card_line(device)}", flush=True)
    for family in args.families:
        if len(args.families) > 1:
            print(f"--- family: {family} ---", flush=True)
        rows = []
        for s in args.sizes:
            row = run_size(s, s, args.frames, family=family, device=device)
            rows.append(row)
            print(f"{row['h']}x{row['w']} (n={row['n']}): trans PSR q10/med/q90 = {row['trans_q10']:.2f}/"
                  f"{row['trans_med']:.2f}/{row['trans_q90']:.2f} | rot PSR q10/med/q90 = "
                  f"{row['rot_q10']:.2f}/{row['rot_med']:.2f}/{row['rot_q90']:.2f}", flush=True)
        if len(rows) >= 2:
            trans, rot = fit_exponents(rows)
            print(f"fitted [{family}]: median translation PSR ~ (W*H)^{trans:.3f} "
                  f"(derive_response_thresholds assumes {ASSUMED_EXPONENT})")
            print(f"        [{family}]: median rotation PSR ~ (W*H)^{rot:.3f} "
                  f"(rotation grid fixed at 360x(H/2) except tiny sizes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
