"""The readings that the output check's limits are set from, for one cell.

    python3 benchmarks/calibrate.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3]

Set-up once, as a run makes it; then for each seed the cell's mix is
rendered with worlds of that seed's own (``traffic.sequence_seed(seed,
j)`` in place of the mix's ``world_seeds``: content that no run uses), and
every distinct sequence runs through the engine as the window runs it
(fresh state, chunks, the trigger after each, finalize) and is held
against the plain reference: the program's readings, whose largest is
the lower reading of each number.  For each control seed the reference
computed in bfloat16 is put in the program's place: its readings, whose
smallest is the upper one.  Prints one line per seed and
sequence, and a JSON summary last.  Needs the card the cell asks for.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmarks.harness import catalog, check, traffic  # noqa: E402


def worlds(mix: dict, seed: int) -> list:
    """World seeds of calibration seed ``seed``, as many as the mix has."""
    return [traffic.sequence_seed(seed, j) for j in range(len(mix["world_seeds"]))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = catalog.load_cell(args.workload)
    slam, mix, cf, drive = cell.config["slam"], cell.traffic, cell.config["slam"]["cf"], cell.driver
    px = check.px_per_metre(slam)
    engine = drive.make_engine(slam, mix, dev)
    ref_slam = drive.reference(cell, dev)
    lower, upper, most = [], [], 0
    for seed in args.seeds:
        seqs = drive.make_sequences(mix, cf["height"], cf["width"], seed, dev, worlds(mix, seed))
        for j in range(seqs.distinct):
            t = time.perf_counter()
            packed, keyframes = (x.cpu().numpy() for x in drive.run_sequence(engine, seqs.frames[j], seqs.chunk))
            t_prog = time.perf_counter() - t
            t = time.perf_counter()
            ref = ref_slam.run(seqs.frames[j], seqs.chunk)
            t_ref = time.perf_counter() - t
            row = check.compare(check.unpack(packed), ref, 0, px, keyframes)
            most = max(most, len(keyframes), int(ref["inserted"].sum()))
            lower.append(row)
            print(f"program seed {seed} sequence {j}: " + ", ".join(f"{k} {row[k]:.6g}" for k in check.NUMBERS)
                  + f" | keyframes {int(ref['inserted'].sum())} loops {int(ref['loop_found'].sum())} "
                  f"solves {int(ref['solves'])} tracked {int(ref['tracked'].sum())}/{len(ref['tracked'])} "
                  f"| program {t_prog:.2f} s, reference {t_ref:.2f} s", flush=True)
    for seed in args.control_seeds:
        seqs = drive.make_sequences(mix, cf["height"], cf["width"], seed, dev, worlds(mix, seed))
        t = time.perf_counter()
        row = check.check_control(seqs, cell, dev, range(seqs.distinct))
        upper.append(row)
        print(f"control seed {seed}: " + ", ".join(f"{k} {row[k]:.6g}" for k in check.NUMBERS)
              + f" | {time.perf_counter() - t:.2f} s", flush=True)
    summary = {"workload": args.workload, "seeds": args.seeds, "control_seeds": args.control_seeds,
               "lower": {k: max(r[k] for r in lower) for k in check.NUMBERS} if lower else None,
               "upper": {k: min(r[k] for r in upper) for k in check.NUMBERS} if upper else None,
               "most_keyframes": most}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
