"""Rotation-recovery accuracy against ``rotation_channel``.

    python -m nislam_torch.scripts.rotstudy [--size 480 640] [--divisor 720]
        [--channels 64 128 480] [--angles 49] [--seeds 42 7] [--out MD] [--device cuda]

Counterpart of ``scripts/rotstudy.py``.  The polar channel count is the
radial resolution of the polar map; the angle resolution is set by the
divisor (360/divisor degrees per bin).  For each channel count this
measures the loop-mode registration (``compute_pose`` with
``large_rotation=True``: both 180° hypotheses) of views of one world point
turned across an off-grid ±180° sweep against the unturned view, over
``--seeds`` textures: the mean, p95 and max angle error, the share within
1 and 2 bins, the median rotation PSR, the derived ``angle_response_thr``
and the share of views whose PSR clears it (every view is a true revisit,
so that share is the loop recall on perfectly placed candidates).  The
JAX script ran on the CPU only; this runs on ``--device``.

Prints one line per channel count and the markdown table; ``--out``
(default: none) also writes the table to a file.

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


def sweep_angles(n: int) -> np.ndarray:
    """``n`` angles over ±180°, off the bin centres (the honest case)."""
    return np.linspace(-180.0, 180.0, n, endpoint=False) + 0.217


def sweep(h: int, w: int, divisor: int, channel: int, seeds: Sequence[int], angles: np.ndarray,
          device) -> dict:
    """Per view of the sweep (seed-major): ``{"err": |angle error| in
    degrees, "psr": rotation PSR, "accept": PSR > angle_response_thr}``
    and the threshold."""
    from nislam_torch.core.config import CFConfig, derive_response_thresholds
    from nislam_torch.ops.registration import compute_intermedium, compute_pose, make_cf_ops
    from nislam_torch.utils.synthetic import make_world, render_frame

    cfg = CFConfig(width=w, height=h, rotation_divisor=divisor, rotation_channel=channel)
    ops = make_cf_ops(cfg).to(device)
    thr = derive_response_thresholds(w, h, divisor, channel)["angle_response_thr"]
    errs, psrs = [], []
    for seed in seeds:
        world = make_world(2048, 3.0, seed=seed)
        base = torch.from_numpy(render_frame(world, h, w, 1024.0, 1024.0, 0.0)).to(device)
        kf_fft, kf_polar = compute_intermedium(base, ops)
        for a in angles:
            cur = torch.from_numpy(render_frame(world, h, w, 1024.0, 1024.0, np.deg2rad(a))).to(device)
            _, cur_polar = compute_intermedium(cur, ops)
            pose, info = compute_pose(kf_fft, cur, kf_polar, cur_polar, ops, large_rotation=True)
            e = abs(np.degrees(float(pose[2])) - a) % 360.0
            errs.append(min(e, 360.0 - e))
            psrs.append(float(info[2]))
    psrs = np.asarray(psrs)
    return {"err": np.asarray(errs), "psr": psrs, "accept": psrs > thr, "thr": thr}


def channel_row(channel: int, divisor: int, res: dict) -> dict:
    """One channel count's row of the table."""
    errs, bin_deg = res["err"], 360.0 / divisor
    return dict(
        channel=channel, mean_err=float(errs.mean()), p95_err=float(np.percentile(errs, 95)),
        max_err=float(errs.max()), within_1bin=float((errs <= bin_deg + 1e-6).mean()),
        within_2bin=float((errs <= 2 * bin_deg + 1e-6).mean()), median_psr=float(np.median(res["psr"])),
        thr=res["thr"], accept=float(res["accept"].mean()),
    )


def table(rows, h: int, w: int, d: int, n_seeds: int, n_angles: int, card: str) -> str:
    lines = [
        "# Rotation-channel study",
        "",
        f"Loop-mode (large-rotation) angle recovery at {h}×{w}, divisor {d} (bin = {360.0 / d:.3g}°), "
        f"±180° off-grid sweep × {n_seeds} textures ({n_angles} angles each), half-polar engine, on "
        f"{card}.  `accept` = share of the sweep's views whose rotation PSR clears the derived "
        "`angle_response_thr` (every view is a true revisit).",
        "",
        "| channel | mean err ° | p95 ° | max ° | ≤1 bin | ≤2 bins | median rot-PSR | thr | accept |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['channel']} | {r['mean_err']:.3f} | {r['p95_err']:.3f} | {r['max_err']:.3f} | "
            f"{r['within_1bin']:.2%} | {r['within_2bin']:.2%} | {r['median_psr']:.1f} | "
            f"{r['thr']:.1f} | {r['accept']:.2%} |"
        )
    lines += ["", "Command: `python -m nislam_torch.scripts.rotstudy`."]
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    ap.add_argument("--divisor", type=int, default=720)
    ap.add_argument("--channels", type=int, nargs="+", default=[64, 128, 480])
    ap.add_argument("--angles", type=int, default=49, help="sweep points over ±180°")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 7])
    ap.add_argument("--out", default=None, help="also write the markdown table here")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    device = asked_device(args.device, "rotstudy")
    card = card_line(device)
    print(f"device: {card}", flush=True)
    h, w = args.size
    angles = sweep_angles(args.angles)
    rows = []
    for c in args.channels:
        r = channel_row(c, args.divisor, sweep(h, w, args.divisor, c, args.seeds, angles, device))
        rows.append(r)
        print(f"C={c}: mean {r['mean_err']:.3f}° p95 {r['p95_err']:.3f}° max {r['max_err']:.3f}° "
              f"within1bin {r['within_1bin']:.2%} psr~{r['median_psr']:.1f} (thr {r['thr']:.1f}) "
              f"accept {r['accept']:.2%}", flush=True)
    text = table(rows, h, w, args.divisor, len(args.seeds), args.angles, card)
    print(text, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
