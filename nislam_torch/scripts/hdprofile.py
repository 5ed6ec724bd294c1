"""Profile one chunk of the HD engine and print the kernels that take the card.

    python -m nislam_torch.scripts.hdprofile [--size 1200 1600] [--frames 48] [--coarse 4] [--device cuda]

Counterpart of ``scripts/hdprofile.py``: the same engine config (the
1200×1600 image, 720×480 polar grid, 256 keyframe slots and 256 edges,
bf16 bank with cached filters, 8 candidates, ``coarse_scale`` 4), the
same world (4096², seed 42) and heading loop of ``--frames`` frames.  One
chunk over all frames warms the engine; a second, on a fresh state, runs
under ``nislam_torch.utils.profiling.trace`` into a temporary directory
(removed after).  Prints the card's name and power limit, the top kernels
of that trace (``top_kernels``) with the total they account for, the
device's busy share (``device_activity``) and, per frame, the host's
launch calls (kernel launches and graph launches: the engine replays one
captured graph per tracked frame) apart from the device's kernels
(``launch_counts``).  ``--size 480 640`` profiles the flagship's image
size.  The config is :func:`nislam_torch.scripts.bench.make_config`'s, so the bench's
``NISLAM_BENCH_NO_LOOP`` and ``NISLAM_BENCH_MAX_CAND`` apply here too.

``--device cuda`` (the default) fails when no card is present; it never
falls back to the CPU.  ``--device cpu`` traces the CPU alone: the trace
then holds no device kernels.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

from nislam_torch.scripts import bench
from nislam_torch.scripts.common import asked_device, card_line
from nislam_torch.scripts.traceparse import kernel_table

TOP = 40  # kernels listed, as the JAX script lists its ops


def make_config(h: int, w: int, coarse: int, rd: int = 720, rc: int = 480):
    """``scripts/hdprofile.py``'s config at (h, w): the bench's at a step of
    8 px with 256 keyframe slots and 256 edges."""
    return bench.make_config(h, w, rd, rc, 0, 8.0, keyframe_capacity=256, edge_capacity=256, coarse_scale=coarse)


def profile(h: int, w: int, n: int, coarse: int, device: torch.device) -> dict:
    """Warm-up chunk, then one profiled chunk → ``{"top": top_kernels,
    "activity": device_activity, "frames", "tracked", "launches_per_frame"
    (the host's kernel launch calls), "counts": launch_counts}``."""
    from nislam_torch.core.slam import make_engine
    from nislam_torch.utils.profiling import device_activity, launch_counts, top_kernels, trace
    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

    config = make_config(h, w, coarse)
    imgs = render_sequence(make_world(4096, 3.0, seed=42), h, w, heading_loop_path(n, 8.0, start=(2048.0, 2048.0)))
    x = torch.from_numpy(imgs).to(device)
    eng = make_engine(config, device)
    _, outs = eng.run_chunk(eng.init_state(), x)  # warm: kernel build, cuFFT plans
    outs.frame_id.cpu()
    with tempfile.TemporaryDirectory(prefix="nislam_hdprofile_") as d:
        with trace(d):
            _, outs = eng.run_chunk(eng.init_state(), x)
            outs.frame_id.cpu()
        path = os.path.join(d, "trace.json")
        act = device_activity(path)
        counts = launch_counts(path)
        kernels = top_kernels(path, TOP)
    return {"top": kernels, "activity": act, "frames": n, "tracked": int(outs.tracked.sum()),
            "launches_per_frame": act["launches"] / n, "counts": counts}


def report(res: dict, seconds: float) -> str:
    """:func:`profile`'s result as printable lines."""
    act = res["activity"]
    return "\n".join([
        f"one chunk of {res['frames']} frames ({res['tracked']} tracked) profiled in {seconds:.1f} s "
        "(warm-up included)",
        f"device busy {act['busy_ms']:.3f} ms of the trace's {act['window_ms']:.3f} ms = busy share "
        f"{act['busy_share']:.4f} | from the host {res['launches_per_frame']:.1f} kernel launches per frame "
        f"and {res['counts']['graph_launches'] / res['frames']:.1f} graph launches | "
        f"{res['counts']['kernels'] / res['frames']:.1f} device kernels per frame",
        kernel_table(res["top"]),
    ])


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, nargs=2, default=(1200, 1600), metavar=("H", "W"))
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--coarse", type=int, default=4, help="the loop search's coarse_scale")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    args = ap.parse_args(argv)
    device = asked_device(args.device, "hdprofile")
    h, w = args.size
    print(f"device: {card_line(device)}  {h}x{w} polar 720x480 coarse_scale {args.coarse}", flush=True)
    t0 = time.perf_counter()
    res = profile(h, w, args.frames, args.coarse, device)
    print(report(res, time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
