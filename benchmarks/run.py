"""The benchmark of ``nislam_torch``, one cell per run.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for (``BENCHMARK.json``'s ``chips``).  Set-up renders the cell's traffic on
the card (``benchmarks/traffic/<mix>.json``: its content is the mix's,
``--seed`` draws the order in which the sequences cycle), makes the
engine of its configuration (``benchmarks/configs/<config>.json``) through
``nislam_torch.models`` and runs every distinct sequence once, so that
every kernel library is loaded, every cuFFT plan made and every CUDA graph
captured before the window.  The window
(:mod:`benchmarks.harness.window`) then runs the sequences back to back
for ``--seconds``; a line on standard error says what it loaded, planned,
captured and left early (all 0 in a sound run).  Once it has closed, the
program's outputs are held against the plain reference
(:mod:`benchmarks.harness.check`), and each number compared is printed
beside its limit, last on standard error and last in the result.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (chunk requests), ``failed`` (requests with a frame that did
not track), ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, each read by
``benchmarks/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and ``checks``.  Without a card (or with fewer than the cell
asks for) it prints no result and exits 2; if a module of JAX or of the
JAX package is loaded it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# One process with few threads: the card does the work, and idle CPU
# thread pools only add jitter to the host's launches.
os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

from benchmarks.harness import catalog, check, devtrace, guard, probes  # noqa: E402
from benchmarks.harness.record import Record  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, beside every number."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip()) or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def no_jax(where: str) -> None:
    found = guard.loaded_forbidden()
    if found:
        log(f"{where}: modules of JAX or the JAX package are loaded: {found}")
        raise SystemExit(3)


def run(args: argparse.Namespace, device: torch.device, root: str = ROOT) -> dict:
    """One run of the cell on ``device`` → the result's object."""
    cell = catalog.load_cell(args.workload, root)
    slam, mix, drive = cell.config["slam"], cell.traffic, cell.driver
    cf = slam["cf"]
    no_jax("at the start")

    engine = drive.make_engine(slam, mix, device)
    t = time.perf_counter()
    seqs = drive.make_sequences(mix, cf["height"], cf["width"], args.seed, device)
    log(f"traffic {mix['name']}: {seqs.distinct} sequences of {seqs.length} frames "
        f"{cf['height']}x{cf['width']} rendered in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    for j in range(seqs.distinct):
        drive.run_sequence(engine, seqs.frames[j], seqs.chunk)
    log(f"warm-up: every distinct sequence once in {time.perf_counter() - t:.2f} s")
    no_jax("after set-up")
    before = drive.compile_counts(engine, device)
    count0 = drive.counters(engine) if args.trace else None
    setup_s = time.perf_counter() - T0

    win = drive.run_window(engine, seqs, args.seconds, keep=check.sampled(seqs),
                            trace=bool(args.trace))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    no_jax("after the window")
    after = drive.compile_counts(engine, device)
    made = {"libraries": sorted(after["libraries"] - before["libraries"]),
            "plans": None if before["plans"] is None else after["plans"] - before["plans"],
            "graphs": after["graphs"] - before["graphs"], "early_exits": after["early_exits"] - before["early_exits"]}
    log(f"in the window: kernel libraries loaded {len(made['libraries'])} {made['libraries']} | cuFFT plans made "
        f"{made['plans']} | CUDA graphs captured {made['graphs']} | early exits {made['early_exits']}")
    if made["libraries"] or made["plans"] or made["graphs"] or made["early_exits"]:
        raise SystemExit("the window loaded, planned, captured or left early: set-up did not warm up what it runs")
    log(f"window: {len(win.requests)} chunk requests, {win.frames} frames in {win.seconds:.3f} s, "
        f"{sum(r.solved for r in win.requests)} triggers solved")

    if not args.trace and not drive.module and device.type == "cuda":
        # Which of its throughput modes this process settled into, beside
        # the window's rate: the track_us probe, outside the window.
        us = probes.chunk_us_per_frame(engine, probes.still_frames(seqs.frames[0, 0], seqs.chunk))
        log(f"process probe after the window: {us:.3f} device us per tracked-only frame")

    record = Record(cell=cell, device=device, setup_s=setup_s, window=win, trace=bool(args.trace),
                    engine=engine, sequences=seqs)
    breakdown = None
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        count1 = drive.counters(engine)
        record.counters = {k: count1[k] - count0[k] for k in count1}
        record.spans = devtrace.call_spans(win.calls)
        record.profile = devtrace.profiled(lambda: drive.run_sequence(engine, seqs.frames[0], seqs.chunk))
        dev_info.update(busy_s=record.profile["busy_s"], window_s=record.profile["window_s"])
        gaps = sorted(record.spans["gaps"].items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": record.profile["device_ops"],
                     "idle_gaps": [[k, v / 1e3] for k, v in gaps]}
        for kind, (n, ms) in sorted(record.spans["by_kind"].items()):
            log(f"window calls: {kind}: {n} calls, {ms:.3f} device ms")
        log(f"profiled sequence: busy {record.profile['busy_s']:.4f} s of {record.profile['window_s']:.4f} s "
            f"({record.profile['kernels']} device events)")
        metrics = catalog.read_metrics(cell.per_layer, record, root)
    else:
        metrics = catalog.read_metrics(cell.end_to_end, record, root)

    # The program's state freed before the reference runs.
    record.engine = engine = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, lines = check.check_window(win, seqs, cell, device)
    for line in lines:
        log(line)
    log(f"output check: {time.perf_counter() - t:.2f} s")
    limits = cell.limits["limits"]
    correct = check.verdict(numbers, limits)
    no_jax("before the result")
    for k in check.NUMBERS:
        log(f"check {k}: {numbers[k]:.6g} (limit {limits[k]})")
    result = {"correct": correct, "attempted": len(win.requests),
              "failed": sum(r.tracked < r.frames for r in win.requests), "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = catalog.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"device: {card_line()} | torch {torch.__version__} CUDA {torch.version.cuda}")
    torch.set_num_threads(1)
    result = run(args, torch.device("cuda", 0))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
