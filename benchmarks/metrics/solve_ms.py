"""Device ms of a deferred trigger that solved: the CUDA-event span of each
optimize or finalize call in the window whose trigger ran the pose-graph
solve, their mean."""

UNIT = "ms"
LAYER = "pose-graph solve"
MOVES = "chunk_ms_p95"


def read(record):
    if record.spans is None or not record.spans["solve_ms"]:
        return None
    return sum(record.spans["solve_ms"]) / len(record.spans["solve_ms"])
