"""A/B of the one-launch reduction kernels against an earlier two-pass
build of them, on one CUDA card.

    git show <commit>:nislam_torch/csrc/peak_stats.cu > <dir>/peak_stats.cu
    git show <commit>:nislam_torch/csrc/sum_only.cu   > <dir>/sum_only.cu
    python -m nislam_torch.scripts.kernel_ab --parent-dir <dir> [--targets 132,264,528]

``<dir>`` holds the sources of the two-pass kernels (pass 1 over row bands
writes partials, pass 2 merges them: two launches per call).  The script
builds them with nvcc beside the tree's own kernels and times, at every
response shape of the main path, ``rounds`` rounds of parent, tree, tree,
parent, each ``reps`` back-to-back launches over input copies that exceed
the L2 cache (:func:`nislam_torch.utils.profiling.device_ms_per_launch`).
It first checks that both builds agree on peak and argmax.  ``--targets``
also times the tree's kernel with other block-count targets than its own
(``nislam_torch.kernels.launch.TARGET_BLOCKS``).

Then the host's side of one registration at (480, 640): one call of
``registration_stats`` (the kernel with its fused epilogue) against the
kernel followed by the epilogue as PyTorch operations on the device
(``registration_epilogue``, what a registration ran after the two-pass
kernel), and against one empty launch: µs per call with one event pair
around each call (:func:`nislam_torch.utils.profiling.call_ms`), and the
host's time alone over many queued calls.

Prints the card's name and power limit, the launch floor, a line per shape
(median µs per launch of each side, the bound), the host's lines, and one
JSON line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict

import torch

PEAK_SHAPES = [(360, 480), (480, 640), (8, 360, 480), (8, 2, 480, 640), (8, 2, 300, 400),
               (1200, 1600), (2, 1200, 1600), (8, 2, 1200, 1600)]
SUM_SHAPES = [(1200, 1600)]
# Blocks the two-pass kernels' pass 1 aimed for.
PARENT_TARGET_BLOCKS = 4 * 132


def build_parent(src_dir: str, out_dir: str) -> Dict[str, ctypes.CDLL]:
    """nvcc over the two-pass sources, both at once, with the tree's flags."""
    from nislam_torch.kernels.build import NVCC_FLAGS, nvcc_path

    procs = {}
    for name in ("peak_stats", "sum_only"):
        out = os.path.join(out_dir, f"parent_{name}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(src_dir, f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc failed for the parent's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["peak_stats"].nislam_peak_stats_f32.argtypes = [p, i, i, i, i, i, p, p, p, p, p, p, p]
    libs["peak_stats"].nislam_peak_stats_f32.restype = i
    libs["sum_only"].nislam_sum_only_f32.argtypes = [p, i, i, i, i, i, p, p, p]
    libs["sum_only"].nislam_sum_only_f32.restype = i
    return libs


def _parent_bands(b: int, h: int):
    s = max(1, min(h, -(-PARENT_TARGET_BLOCKS // b)))
    rows = -(-h // s)
    return -(-h // rows), rows


def parent_peak_stats(lib: ctypes.CDLL) -> Callable:
    """The two-pass kernel's wrapper as it was: four outputs and two
    scratch arrays allocated per call."""
    def fn(g: torch.Tensor):
        h, w = g.shape[-2:]
        b = g.numel() // (h * w)
        s, rows = _parent_bands(b, h)
        f = dict(dtype=torch.float32, device=g.device)
        peak, sm, ss = (torch.empty(b, **f) for _ in range(3))
        idx = torch.empty(b, dtype=torch.int32, device=g.device)
        part_f = torch.empty((3, b * s), **f)
        part_i = torch.empty(b * s, dtype=torch.int32, device=g.device)
        err = lib.nislam_peak_stats_f32(
            g.data_ptr(), b, h, w, s, rows, part_f.data_ptr(), part_i.data_ptr(), peak.data_ptr(),
            idx.data_ptr(), sm.data_ptr(), ss.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent peak_stats: CUDA error {err}")
        return peak, idx, sm, ss
    return fn


def parent_sum_only(lib: ctypes.CDLL) -> Callable:
    def fn(x: torch.Tensor):
        h, w = x.shape[-2:]
        b = x.numel() // (h * w)
        s, rows = _parent_bands(b, h)
        out = torch.empty(b, dtype=torch.float32, device=x.device)
        part = torch.empty(b * s, dtype=torch.float32, device=x.device)
        err = lib.nislam_sum_only_f32(x.data_ptr(), b, h, w, s, rows, part.data_ptr(), out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent sum_only: CUDA error {err}")
        return out
    return fn


def with_target(fn: Callable, target: int) -> Callable:
    """``fn`` run with the launch geometry's block target set to ``target``."""
    from nislam_torch.kernels import launch

    def run(x):
        keep = launch.TARGET_BLOCKS
        launch.TARGET_BLOCKS = target
        try:
            return fn(x)
        finally:
            launch.TARGET_BLOCKS = keep
    return run


def time_shape(sides: Dict[str, Callable], x: torch.Tensor, *, rounds: int, reps: int) -> Dict[str, float]:
    """Median µs per launch of each side: per round the first two sides run
    A, B, B, A and the others once each."""
    from nislam_torch.utils.profiling import cold_copies, device_ms_per_launch

    inputs = cold_copies(x, reps)
    names = list(sides)
    order = names[:2] + names[1::-1] + names[2:]
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in order:
            times[name].append(1e3 * device_ms_per_launch(sides[name], inputs, reps))
    return {name: statistics.median(ts) for name, ts in times.items()}


def host_us(fn: Callable, n: int = 2000) -> float:
    """Host µs per call of ``fn`` over ``n`` queued calls (the device's
    work is waited for only after the clock stops)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def epilogue_ab(dev: torch.device) -> Dict[str, dict]:
    """One registration's statistics at (480, 640), fused against unfused
    → ``{side: {"call_us", "host_us"}}``."""
    from nislam_torch.ops.peak_stats import peak_stats, registration_epilogue, registration_stats
    from nislam_torch.ops.sum_only import empty_launch
    from nislam_torch.utils.profiling import call_ms

    shape = (480, 640)
    g = torch.randn(shape, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    sides = {
        "fused": lambda: registration_stats(g, shape, force="kernel"),
        "kernel + PyTorch epilogue": lambda: registration_epilogue(*peak_stats(g, force="kernel"), shape),
        "empty launch": lambda: empty_launch(stream),
    }
    return {name: {"call_us": 1e3 * call_ms(fn, reps=200), "host_us": host_us(fn)}
            for name, fn in sides.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m nislam_torch.scripts.kernel_ab")
    p.add_argument("--parent-dir", required=True, help="directory with the two-pass peak_stats.cu and sum_only.cu")
    p.add_argument("--reps", type=int, default=100)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--targets", default="", help="comma-separated block targets to time as well")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device (no CPU fallback)", file=sys.stderr)
        return 2
    from nislam_torch.ops.peak_stats import peak_stats, peak_stats_reference
    from nislam_torch.ops.sum_only import sum_only
    from nislam_torch.utils.profiling import bound_ms, launch_floor_ms

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(dev)
    print(card)
    targets = [int(t) for t in args.targets.split(",") if t]
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        libs = build_parent(args.parent_dir, tmp)
        floor_us = 1e3 * launch_floor_ms(args.reps)
        print(f"launch floor (empty kernel): {floor_us:.3f} us per launch")
        cases = [("peak_stats", s, parent_peak_stats(libs["peak_stats"]),
                  lambda x: peak_stats(x, force="kernel")) for s in PEAK_SHAPES]
        cases += [("sum_only", s, parent_sum_only(libs["sum_only"]),
                   lambda x: sum_only(x, force="kernel")) for s in SUM_SHAPES]
        for kernel, shape, parent, tree in cases:
            x = torch.randn(shape, generator=gen, device=dev)
            if kernel == "peak_stats":
                want = peak_stats_reference(x)
                for name, fn in (("parent", parent), ("tree", tree)):
                    got = fn(x)
                    if not (torch.equal(got[0].reshape(-1), want[0].reshape(-1))
                            and torch.equal(got[1].reshape(-1), want[1].reshape(-1))):
                        raise SystemExit(f"kernel_ab: the {name}'s peak_stats differs from the plain version at {shape}")
            sides = {"parent": parent, "tree": tree}
            sides.update({f"tree@{t}": with_target(tree, t) for t in targets})
            med = time_shape(sides, x, rounds=args.rounds, reps=args.reps)
            n_arrays = x.numel() // (shape[-2] * shape[-1])
            bound_us = 1e3 * bound_ms(4 * x.numel() + (32 if kernel == "peak_stats" else 4) * n_arrays)[0]
            extra = "".join(f"  {k} {v:.3f}" for k, v in med.items() if k not in ("parent", "tree"))
            print(f"{kernel} {shape}: parent {med['parent']:.3f} us  tree {med['tree']:.3f} us  "
                  f"ratio {med['tree'] / med['parent']:.3f}  bound {bound_us:.3f} us{extra}")
            results.append({"kernel": kernel, "shape": list(shape), "bound_us": bound_us, **med})
    host = epilogue_ab(dev)
    for name, v in host.items():
        print(f"one registration's statistics at (480, 640), {name}: {v['call_us']:.1f} us per call "
              f"(one event pair), {v['host_us']:.1f} us of host time")
    print(json.dumps({"card": card, "reps": args.reps, "rounds": args.rounds,
                      "launch_floor_us": floor_us, "results": results, "host": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
