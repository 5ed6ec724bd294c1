"""Levenberg-Marquardt iterations per solve in the window, from the solve
graph's own counts (SolveGraph.counts: IF bodies taken by a deferred
trigger, LM iterations)."""

UNIT = "count"
LAYER = "pose-graph solve"
MOVES = "chunk_ms_p95"


def read(record):
    c = record.counters or {}
    if not c.get("solves"):
        return None
    return c["lm_iterations"] / c["solves"]
