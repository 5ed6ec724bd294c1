"""Slope-based op microbench: K₁ and K₂ chained ops, per-op cost = Δt / ΔK.

    python -m nislam_torch.scripts.opbench [--h 1200 --w 1600] [--k 8 32] [--batch B]
        [--only fft,...] [--device cuda]

Counterpart of ``scripts/opbench.py``.  Each variant applies one op K
times in a chain (each op's output is the next one's input) at two chain
lengths; the difference of the two times over the difference of the
lengths is the cost of one op, with whatever a chain pays once (the first
launch, the fence) cancelled.  Variants:

- ``fft rt cuFFT``: rfft2 then irfft2 (JAX's "xla-FFT" row);
- ``rotate 3-shear``: ``rotate_wrap_fft``;
- ``rotate gather``: ``rotate_wrap`` (bilinear, periodic);
- ``peak_stats kernel`` and ``peak_stats plain``: the kernel (on the
  card) and ``peak_stats_reference``, the statistics folded back into the
  chain;
- ``roll+add (bandwidth ref)``.

JAX's matmul-DFT rows (``mm-CT``, ``mm-dense``) are TPU-only and left out.

On the card each chain is timed twice: its device time, the device's
busy time over 3 chains in one ``torch.profiler`` trace
(``device_activity``: the union of its kernel intervals, idle gaps left
out), and its time with the host (``call_ms``), so each variant prints µs
per op on the device and with the host.  A spin kernel cannot hold a
chain for a CUDA-event timing: 32 rotations are ~2000 launches, more than
a stream's launch queue takes.  On the CPU: the best of 3 host-clock runs.
Prints the card's name and power limit first.

``--device cuda`` (the default) fails when no card is present; it never
falls back to the CPU.  ``--device cpu`` runs the same chains on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from nislam_torch.scripts.common import asked_device, card_line

CHAIN_REPS = 3


def ops(device: torch.device, k: int) -> Dict[str, Callable]:
    """``{label: op(x, i)}``: one op of chains up to ``k`` long, ``i`` its
    place in the chain."""
    from nislam_torch.ops.fft import irfft2, rfft2
    from nislam_torch.ops.peak_stats import peak_stats, peak_stats_reference
    from nislam_torch.ops.warp import rotate_wrap, rotate_wrap_fft

    # On the card already: a host scalar copied in per op would wait for the stream.
    degs = 7.0 + 1e-6 * torch.arange(k, dtype=torch.float32, device=device)

    def folded(stats_fn):
        def op(x, i):
            peak, idx, s, _ = stats_fn(x)
            return x * (1.0 + 1e-12 * (peak + s)) + 1e-12 * idx.float().sum()
        return op

    return {
        "fft rt cuFFT": lambda x, i: irfft2(rfft2(x), tuple(x.shape[-2:])) + 1e-7 * i,
        "rotate 3-shear": lambda x, i: rotate_wrap_fft(x, degs[i]),
        "rotate gather": lambda x, i: rotate_wrap(x, degs[i]),
        "peak_stats kernel": folded(peak_stats),
        "peak_stats plain": folded(peak_stats_reference),
        "roll+add (bandwidth ref)": lambda x, i: torch.roll(x, 1, dims=-1) + 1e-7,
    }


def chain(op: Callable, k: int) -> Callable:
    def fn(x):
        for i in range(k):
            x = op(x, i)
        return x
    return fn


def chain_ms(fn: Callable, x: torch.Tensor, device: torch.device) -> Dict[str, float]:
    """ms of one chain.  On the card: ``device``, the device's busy time
    over ``CHAIN_REPS`` chains in one ``torch.profiler`` trace
    (``device_activity``), per chain; and ``host``, ``call_ms``.  On the
    CPU: the best of ``CHAIN_REPS`` host-clock runs."""
    if device.type == "cuda":
        from nislam_torch.utils.profiling import call_ms, device_activity, trace

        fn(x)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="nislam_opbench_") as d:
            with trace(d):
                for _ in range(CHAIN_REPS):
                    fn(x)
                torch.cuda.synchronize()
            busy = device_activity(os.path.join(d, "trace.json"))["busy_ms"]
        return {"device": busy / CHAIN_REPS, "host": call_ms(lambda: fn(x), CHAIN_REPS)}
    fn(x)
    best = float("inf")
    for _ in range(CHAIN_REPS):
        t0 = time.perf_counter()
        fn(x)
        best = min(best, time.perf_counter() - t0)
    return {"cpu": 1e3 * best}


def slope(op: Callable, x: torch.Tensor, k_lo: int, k_hi: int, device: torch.device) -> dict:
    """``{clock: {"per_op_us", "lo_ms", "hi_ms"}}`` for each clock of
    :func:`chain_ms`."""
    lo, hi = chain_ms(chain(op, k_lo), x, device), chain_ms(chain(op, k_hi), x, device)
    return {c: {"per_op_us": 1e3 * (hi[c] - lo[c]) / (k_hi - k_lo), "lo_ms": lo[c], "hi_ms": hi[c]} for c in lo}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=1200)
    ap.add_argument("--w", type=int, default=1600)
    ap.add_argument("--k", type=int, nargs=2, default=(8, 32))
    ap.add_argument("--only", default="", help="comma-separated label prefixes")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    device = asked_device(args.device, "opbench")
    k_lo, k_hi = args.k
    if not 0 < k_lo < k_hi:
        ap.error("--k needs 0 < K1 < K2")
    only = [o for o in args.only.split(",") if o]
    print(f"device: {card_line(device)}  {args.h}x{args.w} batch={args.batch}", flush=True)
    shape = (args.batch, args.h, args.w) if args.batch else (args.h, args.w)
    x = torch.from_numpy(np.random.default_rng(0).random(shape, dtype=np.float32)).to(device)
    for label, op in ops(device, k_hi).items():
        if only and not any(label.startswith(o) for o in only):
            continue
        res = slope(op, x, k_lo, k_hi, device)
        cols = "  ".join(f"{r['per_op_us']:9.1f} us/op {c} (K{k_lo}:{r['lo_ms']:8.2f}ms K{k_hi}:{r['hi_ms']:8.2f}ms)"
                         for c, r in res.items())
        print(f"{label:28s} {cols}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
