"""Registered frames per second: every frame the engine registered in the
window over the window's whole elapsed time (fresh-state starts, deferred
triggers and each sequence's finalize inside it)."""

from benchmarks.harness.stats import rate

UNIT = "frames/s"
LAYER = "end to end"


def read(record):
    return rate(record.window.frames, record.window.seconds)
