"""The 95th percentile of every chunk request in the window, each timed on
the host's clock from its run_chunk call to the host's read of its poses,
its deferred trigger (and at a sequence's end its finalize) included."""

from benchmarks.harness.stats import percentile

UNIT = "ms"
LAYER = "end to end"


def read(record):
    return percentile([1e3 * (r.t1 - r.t0) for r in record.window.requests], 95.0)
