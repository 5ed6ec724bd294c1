"""HD-size (1200×1600) stage decomposition of the tracking path's pieces.

    python -m nislam_torch.scripts.hdbench [--r 20] [--only A,B,...] [--device cuda]

Counterpart of ``scripts/hdbench.py``, with the variants the port has:

- the ``peak_stats`` kernel against ``peak_stats_reference``, its plain
  version;
- the rfft2 + irfft2 round trip and the irfft2 of the magnitude (cuFFT
  through ``torch.fft``);
- ``rotate_wrap_fft`` (three shears), ``_shear_x`` alone, and the shear
  phase alone (the ``_cis`` term of one shear);
- the polar gather from HD power (``polar_resample`` with the 4-tap
  ``polar_tap_constants`` table, 720×480 out);
- the undistort gather (``bilinear_sample``, 4 taps) over the JAX script's
  mild barrel grid (k = 0.02).

Left out, TPU-only: the factored (Cooley-Tukey) against the dense
matmul-DFT, the blocked Pallas ``peak_stats`` against multi-pass jnp (the
port has one kernel and its plain version, both above), and the
quad-packed undistort (one gather descriptor per output).

Each variant is timed as ``stagebench`` times a stage: device µs per call
(R back-to-back calls between one pair of CUDA events) and µs per call
with the host, or one host-clock time on the CPU.  Prints the card's name
and power limit, then one line per variant.

``--device cuda`` (the default) fails when no card is present; it never
falls back to the CPU.  ``--device cpu`` runs the same variants on the CPU.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from nislam_torch.scripts.common import asked_device, card_line, format_times, time_call

SIZE = (1200, 1600)  # the HD config (configs/config_HD.yaml)


def variants(h: int, w: int, device: torch.device, rd: int = 720, rc: int = 480) -> Dict[str, Callable]:
    """``{label: fn(x)}`` over an (h, w) image."""
    from nislam_torch.ops.fft import irfft2, rfft2
    from nislam_torch.ops.peak_stats import peak_stats, peak_stats_reference
    from nislam_torch.ops.warp import _cis, _shear_x, bilinear_sample, polar_resample, polar_tap_constants, \
        rotate_wrap_fft

    pidx, pw = polar_tap_constants(h, w, rd, rc, fold_dc=False)
    pidx, pw = torch.from_numpy(pidx).to(device), torch.from_numpy(pw).to(device)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = w / 2.0, h / 2.0
    r2 = ((xs - cx) / cx) ** 2 + ((ys - cy) / cy) ** 2
    gx = torch.from_numpy(cx + (xs - cx) * (1 + 0.02 * r2)).to(device)
    gy = torch.from_numpy(cy + (ys - cy) * (1 + 0.02 * r2)).to(device)
    kx = torch.arange(w // 2 + 1, dtype=torch.float32, device=device)
    yc = torch.arange(h, dtype=torch.float32, device=device) - h / 2.0
    seven = torch.tensor(7.0, device=device)
    shear = torch.tensor(0.12, device=device)
    return {
        "peak_stats kernel": peak_stats,
        "peak_stats plain (peak_stats_reference)": peak_stats_reference,
        "rfft2+irfft2 roundtrip (cuFFT)": lambda x: irfft2(rfft2(x), (h, w)),
        "irfft2 of magnitude (cuFFT)": lambda x: irfft2(torch.abs(rfft2(x)), (h, w)),
        "rotate_wrap_fft 3 shears": lambda x: rotate_wrap_fft(x, seven),
        "shear_x only": lambda x: _shear_x(x, shear),
        "shear phase sincos only": lambda x: _cis((2.0 * math.pi / w) * (shear * yc)[:, None] * kx),
        f"polar_resample 4-tap ({rd}x{rc} out)": lambda x: polar_resample(x, pidx, pw),
        "undistort bilinear_sample (4 taps)": lambda x: bilinear_sample(x, gx, gy),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--r", type=int, default=20, help="calls per timing")
    ap.add_argument("--only", default="", help="comma-separated label prefixes")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    device = asked_device(args.device, "hdbench")
    if args.r < 1:
        ap.error("--r must be positive")
    only = [o for o in args.only.split(",") if o]
    h, w = SIZE
    from nislam_torch.utils.profiling import cold_copies

    print(f"device: {card_line(device)}  size {h}x{w}", flush=True)
    img = torch.from_numpy(np.random.default_rng(0).random((h, w), dtype=np.float32)).to(device)
    inputs = cold_copies(img, args.r) if device.type == "cuda" else [img]
    for label, fn in variants(h, w, device).items():
        if only and not any(label.startswith(o) for o in only):
            continue
        print(f"{label:44s} {format_times(time_call(fn, inputs, args.r, device))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
