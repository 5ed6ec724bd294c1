"""Interleaved A/B of the ``peak_stats`` variants at HD size, on one CUDA card.

    python -m nislam_torch.scripts.pkbench [--reps 100] [--rounds 5]

Counterpart of ``scripts/pkbench.py``.  At (1200, 1600) float32 it runs,
in turn, ``rounds`` rounds of ``reps`` back-to-back launches of each
variant, cycling through copies of the input that together exceed the L2
cache:

- ``jnp4pass``: :func:`peak_stats_reference`, the plain PyTorch version;
- ``blocked``: the ``peak_stats`` kernel with its own block ranges;
- ``blocked_bh600``: the kernel with ranges of 600 rows (two blocks);
- ``sumonly``: the ``sum_only`` kernel, the streaming-only control;
- ``torch.sum``: the library call computing what ``sumonly`` computes.

Prints the card's name and power limit, then the minimum and median µs per
launch of each variant beside the HBM bound of reading the input once
(7.68 MB, 2.29 µs at 3.35 TB/s) and the share of the bound each reaches,
then one JSON line of the same numbers.  Exits non-zero without a CUDA
device: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

SHAPE = (1200, 1600)


def interleave(variants: Dict[str, Callable], inputs: Sequence, *, rounds: int, reps: int,
               timer: Callable) -> Dict[str, List[float]]:
    """``rounds`` rounds; in each, every variant in turn is timed by
    ``timer(fn, inputs, reps)`` (ms per launch).  Returns µs per launch,
    one entry per round, for each variant."""
    times: Dict[str, List[float]] = {name: [] for name in variants}
    for _ in range(rounds):
        for name, fn in variants.items():
            times[name].append(1e3 * timer(fn, inputs, reps))
    return times


def variants() -> Dict[str, Callable]:
    """The four variants of the A/B and the library call, on one input."""
    from nislam_torch.ops.peak_stats import peak_stats, peak_stats_reference
    from nislam_torch.ops.sum_only import sum_only

    return {
        "jnp4pass": peak_stats_reference,
        "blocked": lambda x: peak_stats(x, force="kernel"),
        "blocked_bh600": lambda x: peak_stats(x, force="kernel", rows=600),
        "sumonly": lambda x: sum_only(x, force="kernel"),
        "torch.sum": lambda x: torch.sum(x, dim=(-2, -1)),
    }


def summarize(times: Dict[str, List[float]], bound_us: float) -> Dict[str, dict]:
    """min and median µs per launch, and the bound's share of the median."""
    out = {}
    for name, ts in times.items():
        med = statistics.median(ts)
        out[name] = {"min_us": min(ts), "med_us": med, "bound_share": bound_us / med}
    return out


def check(x: torch.Tensor) -> None:
    """Each kernel variant against its plain version on ``x``: peak and
    argmax equal, sums within 1e-5 of Σ|x|."""
    from nislam_torch.ops.peak_stats import peak_stats, peak_stats_reference
    from nislam_torch.ops.sum_only import sum_only

    tol = 1e-5 * float(x.abs().sum())
    want = peak_stats_reference(x)
    for rows in (None, 600):
        got = peak_stats(x, force="kernel", rows=rows)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and abs(float(got[2] - want[2])) <= tol):
            raise SystemExit(f"pkbench: peak_stats (rows={rows}) differs from the plain version")
    if abs(float(sum_only(x, force="kernel") - x.sum())) > tol:
        raise SystemExit("pkbench: sum_only differs from torch.sum")


def make_input(dev: torch.device, seed: int = 0) -> torch.Tensor:
    """The (1200, 1600) f32 input, uniform in [0, 1) from ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(SHAPE, dtype=np.float32)).to(dev)


def run(dev: torch.device, *, reps: int = 100, rounds: int = 5, seed: int = 0) -> dict:
    """The A/B on ``dev``, with no comparison launches (see :func:`check`)
    → ``{"bound_us", "bytes", "variants": {name: {"min_us", "med_us",
    "bound_share"}}}``."""
    from nislam_torch.utils.profiling import bound_ms, cold_copies, device_ms_per_launch

    x = make_input(dev, seed)
    nbytes = x.numel() * x.element_size()
    bound_us = 1e3 * bound_ms(nbytes)[0]
    times = interleave(variants(), cold_copies(x, reps), rounds=rounds, reps=reps,
                       timer=device_ms_per_launch)
    return {"bytes": nbytes, "bound_us": bound_us, "variants": summarize(times, bound_us)}


def report(res: dict) -> None:
    for name, v in res["variants"].items():
        print(f"{name:16s} min {v['min_us']:9.3f} us  med {v['med_us']:9.3f} us  "
              f"bound {res['bound_us']:.3f} us ({res['bytes'] / 1e6:.2f} MB read)  "
              f"share {v['bound_share']:.3f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m nislam_torch.scripts.pkbench")
    p.add_argument("--reps", type=int, default=100, help="launches per variant per round")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("pkbench: needs a CUDA device (no CPU fallback)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(dev))
    check(make_input(dev, args.seed))
    res = run(dev, reps=args.reps, rounds=args.rounds, seed=args.seed)
    report(res)
    print(json.dumps({"shape": list(SHAPE), "reps": args.reps, "rounds": args.rounds, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
