"""A/B of the tree's kernels against earlier builds of them, on one CUDA
card.

    git show e99b40e:nislam_torch/csrc/peak_stats.cu  > <dir>/peak_stats.cu
    git show e99b40e:nislam_torch/csrc/sum_only.cu    > <dir>/sum_only.cu
    git show 6d79892:nislam_torch/csrc/scatter_add.cu > <dir>/scatter_add.cu
    python -m nislam_torch.scripts.kernel_ab --parent-dir <dir> [--targets 132,264,528]

``<dir>`` holds the parent sources, any of four: the two-pass
reduction kernels (pass 1 over row bands writes partials, pass 2 merges
them: two launches per call), the scatter-add whose head thread walks
its run of sorted keys, and a ``stitch_raster.cu`` of the tree's C
interface (timed at a 480×640 and a 1200×1600 insert).  The script builds them with nvcc beside the
tree's own kernels and times, at every response shape of the main path
(and, for the scatter-add, at the solvers' shapes, a ragged case and
runs of 1000 keys), ``rounds`` rounds of parent, tree, tree, parent, each
``reps`` back-to-back launches over input copies that exceed the L2 cache
(:func:`nislam_torch.utils.profiling.device_ms_per_launch`).  It first
checks that both builds agree: on peak and argmax, and on the scatter's
bits.  ``--targets`` also times the tree's reduction kernels with other
block-count targets than their own
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
    """nvcc over the parent sources that ``src_dir`` holds, all at once,
    with the tree's flags."""
    from nislam_torch.kernels.build import NVCC_FLAGS, nvcc_path

    procs = {}
    for name in ("peak_stats", "sum_only", "scatter_add", "stitch_raster"):
        if not os.path.exists(os.path.join(src_dir, f"{name}.cu")):
            continue
        out = os.path.join(out_dir, f"parent_{name}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(src_dir, f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc failed for the parent's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if "peak_stats" in libs:
        libs["peak_stats"].nislam_peak_stats_f32.argtypes = [p, i, i, i, i, i, p, p, p, p, p, p, p]
        libs["peak_stats"].nislam_peak_stats_f32.restype = i
    if "sum_only" in libs:
        libs["sum_only"].nislam_sum_only_f32.argtypes = [p, i, i, i, i, i, p, p, p]
        libs["sum_only"].nislam_sum_only_f32.restype = i
    if "scatter_add" in libs:
        libs["scatter_add"].nislam_scatter_add_f32.argtypes = [p, p, p, p, ll, i, ll, p]
        libs["scatter_add"].nislam_scatter_add_f32.restype = i
        libs["scatter_add"].nislam_scatter_add_error_word.argtypes = [ctypes.POINTER(p)]
        libs["scatter_add"].nislam_scatter_add_error_word.restype = i
    if "stitch_raster" in libs:
        from nislam_torch.ops.stitch_raster import _bind

        _bind(libs["stitch_raster"])  # the tree's signature
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


def parent_scatter_add(lib: ctypes.CDLL) -> Callable:
    """The scatter-add as it was: one thread per sorted position, the head
    of each run walks it; takes (out, plan, src) and the plan's sorted
    keys and order."""
    word = ctypes.c_void_p()
    if lib.nislam_scatter_add_error_word(ctypes.byref(word)) != 0:
        raise RuntimeError("parent scatter_add: allocating the error word failed")

    def fn(x):
        out, plan, src = x
        c = out.shape[1] if out.dim() == 2 else 1
        err = lib.nislam_scatter_add_f32(plan.sorted_keys.data_ptr(), plan.order.data_ptr(), src.data_ptr(),
                                         out.data_ptr(), plan.keys.shape[0], c, out.shape[0],
                                         torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent scatter_add: CUDA error {err}")
        return out
    return fn


def parent_stitch_raster(lib: ctypes.CDLL, center) -> Callable:
    """An earlier build of the stitcher's kernel with the tree's C
    interface: one enabled frame, a host flag; takes (data, weight, image,
    constants)."""
    def fn(x):
        data, weight, img, k = x
        h, w = img.shape
        s = data.shape[0]
        err = lib.nislam_stitch_raster_f32(img.data_ptr(), h, w, k.data_ptr(), None, 1, w / 2.0, h / 2.0, s,
                                           s // 2 - center[0], s // 2 - center[1], 100.0, 1.0, data.data_ptr(),
                                           weight.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent stitch_raster: CUDA error {err}")
        return data, weight
    return fn


def stitch_cases(dev: torch.device):
    """(label, center, inputs): a 480×640 insert on a 4096² canvas and a
    1200×1600 one on 8192² (configs/config_geekplus.yaml, config_HD.yaml),
    each as 16 frames of random pixels at poses shifted over a grid of
    0.15 m steps onto one canvas that already holds values, as
    ``chip_smoke.py`` phase 2b times them."""
    from nislam_torch.core.camera import make_camera_ops
    from nislam_torch.core.config import CameraConfig
    from nislam_torch.core.stitcher import _frame_constants

    gen = torch.Generator(device=dev).manual_seed(5)
    for (h, w), s in (((480, 640), 4096), ((1200, 1600), 8192)):
        cam = make_camera_ops(CameraConfig(image_width=w, image_height=h, height=1.0,
                                           intrinsics=(float(w), w / 2.0, float(w), h / 2.0))).to(dev)
        data = torch.rand((s, s), generator=gen, device=dev) * 100.0
        weight = torch.randint(0, 4, (s, s), generator=gen, device=dev).float()
        inputs = []
        for v in range(16):
            pose = torch.tensor([0.31 + 0.15 * (v % 6 - 2.5), -0.17 + 0.15 * (v // 6 - 2.5), 0.6], device=dev)
            inputs.append((data, weight, torch.rand((h, w), generator=gen, device=dev), _frame_constants(pose, cam)))
        yield f"insert {h}x{w} on {s}^2", (0, 0), inputs


def scatter_cases(dev: torch.device, run_lengths=(1000,)):
    """(label, out, keys, src) at the shapes the solvers give the scatter:
    the dense LM's H blocks and gradient and a GN-CG rank's (K, 3) sums on
    chain graphs of the flagship's and config_HD's capacities (K = 272 /
    E = 1024 and K = 1024 / E = 4096); a ragged case with empty rows,
    single keys and one long run (a fifth of the keys); and (K, 3) sums
    whose runs all have one length, each of ``run_lengths`` (shuffled
    keys, about 4096 of them, or one run)."""
    from nislam_torch.core.pose_graph import normal_eq_plan
    from nislam_torch.ops.scatter_add import spread_masked
    from nislam_torch.utils.scaling import chain_problem

    gen = torch.Generator(device=dev).manual_seed(3)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    for k, e in ((272, 1024), (1024, 4096)):
        plan = normal_eq_plan(chain_problem(k, e, device=dev))
        yield f"dense LM H (K*K, 9), K={k} E={e}", rand(k * k, 9), plan.h.keys, rand(4 * e, 9)
        yield f"dense LM g (K, 3), K={k} E={e}", rand(k, 3), plan.g.keys, rand(2 * e, 3)
    prob = chain_problem(272, 1024, device=dev)
    f, t = prob.from_slot[:512].long(), prob.to_slot[:512].long()  # a rank's edge block over two ranks
    keys = spread_masked(torch.cat([f, t]), prob.edge_mask[:512].repeat(2), 272)  # as the solver's
    yield "GN-CG (K, 3), K=272, 512 edges per rank", rand(272, 3), keys, rand(1024, 3)
    keys = torch.randint(0, 500, (5000,), generator=gen, device=dev)
    keys[torch.rand(5000, generator=gen, device=dev) < 0.2] = 3
    keys[0] = 999  # rows 500..998 stay empty
    yield "ragged (1000, 3)", rand(1000, 3), keys, rand(5000, 3)
    for length in run_lengths:
        rows = max(1, 4096 // length)
        keys = torch.randperm(2 * rows, generator=gen, device=dev)[:rows].repeat_interleave(length)
        keys = keys[torch.randperm(keys.numel(), generator=gen, device=dev)]
        yield f"runs of {length} (K, 3), K={2 * rows} N={keys.numel()}", rand(2 * rows, 3), keys, rand(keys.numel(), 3)


def scatter_bound_bytes(out: torch.Tensor, keys: torch.Tensor) -> int:
    """Bytes that ``out[keys[i]] += src[i]`` must move, whatever its
    design: the source rows (4·N·C) and the keys (8·N) read once, each
    touched row of ``out`` read and written once (8·C per distinct key)."""
    n, c = keys.numel(), (out.shape[1] if out.dim() == 2 else 1)
    return 4 * n * c + 8 * n + 8 * c * int(torch.unique(keys).numel())


def scatter_inputs(out, plan, src, reps: int) -> list:
    """Copies of (out, plan, src) whose bytes exceed the L2 cache."""
    from nislam_torch.ops.scatter_add import ScatterPlan
    from nislam_torch.utils.profiling import COLD_BYTES

    nbytes = sum(x.numel() * x.element_size() for x in (out, src, *plan))
    n = max(1, min(reps, -(-COLD_BYTES // nbytes)))
    return [(out, plan, src)] + [(out.clone(), ScatterPlan(*(x.clone() for x in plan)), src.clone())
                                 for _ in range(n - 1)]


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


def time_shape(sides: Dict[str, Callable], inputs: list, *, rounds: int, reps: int) -> Dict[str, float]:
    """Median µs per launch of each side over ``inputs``: per round the
    first two sides run A, B, B, A and the others once each."""
    from nislam_torch.utils.profiling import device_ms_per_launch

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
    p.add_argument("--parent-dir", required=True,
                   help="directory with any of the parent's peak_stats.cu, sum_only.cu, scatter_add.cu and "
                        "stitch_raster.cu")
    p.add_argument("--reps", type=int, default=100)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--targets", default="", help="comma-separated block targets to time as well")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device (no CPU fallback)", file=sys.stderr)
        return 2
    from nislam_torch.ops import scatter_add as sa
    from nislam_torch.ops.peak_stats import peak_stats, peak_stats_reference
    from nislam_torch.ops.sum_only import sum_only
    from nislam_torch.utils.profiling import bound_ms, cold_copies, launch_floor_ms

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
        cases = []
        if "peak_stats" in libs:
            cases += [("peak_stats", s, parent_peak_stats(libs["peak_stats"]),
                       lambda x: peak_stats(x, force="kernel")) for s in PEAK_SHAPES]
        if "sum_only" in libs:
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
            med = time_shape(sides, cold_copies(x, args.reps), rounds=args.rounds, reps=args.reps)
            n_arrays = x.numel() // (shape[-2] * shape[-1])
            bound_us = 1e3 * bound_ms(4 * x.numel() + (32 if kernel == "peak_stats" else 4) * n_arrays)[0]
            extra = "".join(f"  {k} {v:.3f}" for k, v in med.items() if k not in ("parent", "tree"))
            print(f"{kernel} {shape}: parent {med['parent']:.3f} us  tree {med['tree']:.3f} us  "
                  f"ratio {med['tree'] / med['parent']:.3f}  bound {bound_us:.3f} us{extra}")
            results.append({"kernel": kernel, "shape": list(shape), "bound_us": bound_us, **med})
        if "scatter_add" in libs:
            parent = parent_scatter_add(libs["scatter_add"])
            tree = lambda x: sa.index_add_ordered(x[0], x[1], x[2], force="kernel")
            for label, out, keys, src in scatter_cases(dev):
                plan = sa.ScatterPlan.of(keys)
                got = {name: fn((out.clone(), plan, src)) for name, fn in (("parent", parent), ("tree", tree))}
                sa.raise_on_bad_keys(dev)
                if not torch.equal(got["parent"].view(torch.int32), got["tree"].view(torch.int32)):
                    raise SystemExit(f"kernel_ab: the parent's and the tree's scatter_add differ at {label}")
                med = time_shape({"parent": parent, "tree": tree}, scatter_inputs(out, plan, src, args.reps),
                                 rounds=args.rounds, reps=args.reps)
                bound_us = 1e3 * bound_ms(scatter_bound_bytes(out, keys))[0]
                print(f"scatter_add {label}: parent {med['parent']:.3f} us  tree {med['tree']:.3f} us  "
                      f"ratio {med['tree'] / med['parent']:.3f}  bound {bound_us:.3f} us")
                results.append({"kernel": "scatter_add", "shape": label, "bound_us": bound_us, **med})
        if "stitch_raster" in libs:
            from nislam_torch.ops import stitch_raster as sr

            for label, center, inputs in stitch_cases(dev):
                parent = parent_stitch_raster(libs["stitch_raster"], center)
                tree = lambda x, c=center: sr.stitch_raster(*x, True, 100.0, 1.0, c, force="kernel")
                got = []
                for fn in (parent, tree):
                    data, weight = inputs[0][0].clone(), inputs[0][1].clone()
                    fn((data, weight, *inputs[0][2:]))
                    got.append((data, weight))
                if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*got)):
                    raise SystemExit(f"kernel_ab: the parent's and the tree's stitch_raster differ at {label}")
                del got
                med = time_shape({"parent": parent, "tree": tree}, inputs, rounds=args.rounds, reps=args.reps)
                print(f"stitch_raster {label}: parent {med['parent']:.3f} us  tree {med['tree']:.3f} us  "
                      f"ratio {med['tree'] / med['parent']:.3f}")
                results.append({"kernel": "stitch_raster", "shape": label, **med})
    host = epilogue_ab(dev)
    for name, v in host.items():
        print(f"one registration's statistics at (480, 640), {name}: {v['call_us']:.1f} us per call "
              f"(one event pair), {v['host_us']:.1f} us of host time")
    print(json.dumps({"card": card, "reps": args.reps, "rounds": args.rounds,
                      "launch_floor_us": floor_us, "results": results, "host": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
