"""Late wakes of a 2 ms sleep beside a command: the load that a
sleep-based timing test sees while the command runs.

    python -m nislam_torch.scripts.sleep_probe [--window 20] -- <command> [args...]

``tests/test_profiling.py::test_stage_timer_accumulates_and_summarizes``
fails when three 2 ms sleeps take longer than one 10 ms sleep, that is
when they average more than 3.33 ms.  This starts ``<command>`` (say, the
test suite, or some of its files), and while it runs sleeps 2 ms at a time
in this process, at this process's priority, counting the sleeps that
take more than 3.33 ms.  Prints the share of late sleeps in each window
of ``--window`` seconds, then over the whole run, beside the command's
exit code and its seconds.  A change meant to spare that test is held
against the share with and without it, beside the same command.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

SLEEP_S = 0.002
LATE_S = 0.010 / 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--window", type=float, default=20.0, help="seconds per reported window")
    ap.add_argument("command", nargs=argparse.REMAINDER, help="-- <command> [args...]")
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command given")
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    windows = []  # (sleeps, late) per window
    n = late = 0
    t_window = t_start
    while proc.poll() is None:
        t0 = time.perf_counter()
        time.sleep(SLEEP_S)
        t1 = time.perf_counter()
        n += 1
        late += (t1 - t0) > LATE_S
        if t1 - t_window >= args.window:
            windows.append((n, late))
            print(f"window {len(windows)}: {late}/{n} sleeps late = {late / n:.4f}", flush=True)
            n = late = 0
            t_window = t1
    if n:
        windows.append((n, late))
    total, total_late = sum(w[0] for w in windows), sum(w[1] for w in windows)
    shares = [w[1] / w[0] for w in windows]
    print(f"command exit {proc.returncode} after {time.perf_counter() - t_start:.1f} s | "
          f"{total_late}/{total} sleeps late = {total_late / max(total, 1):.4f} | per window "
          f"min {min(shares):.4f} max {max(shares):.4f} over {len(windows)} windows of {args.window:g} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
