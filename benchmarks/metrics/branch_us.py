"""Device µs that a stored keyframe adds to its frame: run_chunk over a chunk
in which every frame stores a keyframe and searches for a loop (a frame
and its copy shifted by 1.5 travel gates, in turn), per frame, less
track_us's chunk of frames that insert nothing."""

from benchmarks.harness.probes import chunk_us_per_frame, hopping_frames, still_frames

UNIT = "us"
LAYER = "keyframe branch"
MOVES = "frames_per_s"


def read(record):
    if record.engine is None or not record.trace:
        return None
    seqs = record.sequences
    frame = seqs.frames[0, 0]
    hop = chunk_us_per_frame(record.engine, hopping_frames(frame, seqs.chunk, record.slam))
    return hop - chunk_us_per_frame(record.engine, still_frames(frame, seqs.chunk))
