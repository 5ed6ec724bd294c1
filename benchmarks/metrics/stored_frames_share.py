"""The share of the window's frames whose stored-keyframe body ran inside
the chunk graph, from the program's own count of its runs
(ChunkGraph.runs, slot 0), in %."""

UNIT = "%"
LAYER = "chunk graph"
MOVES = "frames_per_s"


def read(record):
    if not record.counters or record.counters.get("stored_runs") is None:
        return None
    return 100.0 * record.counters["stored_runs"] / record.window.frames
