"""The share of the window in which no engine call held the device: 1 − the
summed CUDA-event spans around each run_chunk, optimize and finalize over
the window, in %."""

UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"


def read(record):
    if record.spans is None:
        return None
    return 100.0 * (1.0 - record.spans["busy_ms"] / 1e3 / record.window.seconds)
