"""The kernels that take the device's time in one ``torch.profiler`` trace.

    python -m nislam_torch.scripts.traceparse DIR [N]

Counterpart of ``scripts/traceparse.py``, which reads the leaf-op self
times of an XLA trace.  ``DIR`` holds the Chrome trace ``trace.json``
that ``nislam_torch.utils.profiling.trace`` writes (``python -m
nislam_torch run --profile DIR`` leaves one there).  Prints the
device's busy time (kernels, copies and memsets, overlaps once) and the
top ``N`` kernels (default 45) by total time, each with its launch count
and its share of the busy time (:func:`~nislam_torch.utils.profiling.top_kernels`).
It only reads the file, so it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def kernel_table(top: dict) -> str:
    """A :func:`~nislam_torch.utils.profiling.top_kernels` result as
    printable lines: the busy time, the listed kernels' total, one line
    per kernel."""
    rows = top["kernels"]
    lines = [f"device busy: {top['busy_ms']:.3f} ms | top {len(rows)} kernels: "
             f"{sum(r['ms'] for r in rows):.3f} ms, {sum(r['share'] for r in rows):.1%} of it"]
    lines += [f"{r['ms']:10.3f} ms x{r['launches']:5d} {r['share']:7.2%}  {r['name'][:120]}" for r in rows]
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir", help="the directory that holds trace.json")
    ap.add_argument("n", type=int, nargs="?", default=45, help="kernels to list (default 45)")
    args = ap.parse_args(argv)
    from nislam_torch.utils.profiling import top_kernels

    print(kernel_table(top_kernels(os.path.join(args.dir, "trace.json"), args.n)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
