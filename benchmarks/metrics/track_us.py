"""Device µs per tracked frame that inserts nothing: run_chunk over a chunk
of copies of one frame on a state whose keyframe it is (the batched front
end, the track graph and the chunk graph's outer body), CUDA events over
several calls."""

from benchmarks.harness.probes import chunk_us_per_frame, still_frames

UNIT = "us"
LAYER = "tracking front end"
MOVES = "frames_per_s"


def read(record):
    if record.engine is None or not record.trace:
        return None
    seqs = record.sequences
    return chunk_us_per_frame(record.engine, still_frames(seqs.frames[0, 0], seqs.chunk))
