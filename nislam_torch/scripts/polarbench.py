"""Power → polar pipeline variants, single frame and batched.

    python -m nislam_torch.scripts.polarbench [--size 256|640|1200] [--batch 16] [--r 20] [--device cuda]

Counterpart of ``scripts/polarbench.py``, with the variants the port has:

- ``4-tap half_polar (production)``: DC suppression, then
  ``polar_resample`` over the first D/2 rows of the 4-tap
  ``polar_tap_constants`` table, as ``compute_intermedium`` runs it;
- ``literal chain``: ``remove_zero_component`` → ``fftshift2`` → the
  ``polar_grid`` gather (``warp_polar``);
- ``half gather -> rfft2 (engine ctx)``: the production gather feeding the
  polar map's rfft2, as the engine does;
- ``crop -> rfft2 (no gather bound)``: the same consumer with the gather
  replaced by a crop, so the difference is the gather's cost in context.

Left out, TPU-only: the fused 8-tap gather, the quad-packed gathers (one
descriptor per output) and the batch-minor layouts.

Each variant at batch 1 and at ``--batch`` B is timed as ``stagebench``
times a stage (device µs per call and µs per call with the host on the
card, one host-clock time on the CPU), and printed per call and per
frame, after the card's name and power limit.

``--device cuda`` (the default) fails when no card is present; it never
falls back to the CPU.  ``--device cpu`` runs the same variants on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from nislam_torch.scripts.common import SIZES, asked_device, card_line, format_times, time_call


def variants(h: int, w: int, rd: int, rc: int, device: torch.device) -> Dict[str, Callable]:
    """``{label: fn(power)}`` over (…, h, w) power arrays."""
    from nislam_torch.ops.fft import fftshift2, rfft2
    from nislam_torch.ops.registration import remove_zero_component
    from nislam_torch.ops.warp import polar_grid, polar_resample, polar_tap_constants, warp_polar

    idx, wgt = polar_tap_constants(h, w, rd, rc, fold_dc=False)
    idx_h = torch.from_numpy(np.ascontiguousarray(idx[: rd // 2])).to(device)
    w_h = torch.from_numpy(np.ascontiguousarray(wgt[: rd // 2])).to(device)
    gx, gy = (torch.from_numpy(g).to(device) for g in polar_grid(h, w, rd, rc))

    def half(x):
        return polar_resample(remove_zero_component(x), idx_h, w_h)

    return {
        "4-tap half_polar (production)": half,
        "literal chain": lambda x: warp_polar(fftshift2(remove_zero_component(x)), gx, gy),
        "half gather -> rfft2 (engine ctx)": lambda x: torch.abs(rfft2(half(x))),
        "crop -> rfft2 (no gather bound)": lambda x: torch.abs(rfft2(remove_zero_component(x)[..., : rd // 2, :rc])),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256, choices=sorted(SIZES))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--r", type=int, default=20, help="calls per timing")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    device = asked_device(args.device, "polarbench")
    if args.r < 1 or args.batch < 1:
        ap.error("--r and --batch must be positive")
    from nislam_torch.utils.profiling import cold_copies

    h, w, rd, rc = SIZES[args.size]
    print(f"device: {card_line(device)}  {h}x{w} -> {rd}x{rc}", flush=True)
    rng = np.random.default_rng(0)
    fns = variants(h, w, rd, rc, device)
    for b in (1, args.batch) if args.batch > 1 else (1,):
        shape = (h, w) if b == 1 else (b, h, w)
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)
        inputs = cold_copies(x, args.r) if device.type == "cuda" else [x]
        print(f"--- batch {b}", flush=True)
        for label, fn in fns.items():
            t = time_call(fn, inputs, args.r, device)
            per_frame = {k: v / b for k, v in t.items()}
            print(f"{label:36s} {format_times(t)}  | per frame {format_times(per_frame)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
