"""The peak_stats kernel's share of its roofline at the cell's registration
shape: the least time to read the (H, W) float32 response once and write
its 8-word record at 3.35 TB/s, over the kernel's device µs per launch
(CUDA events over many launches on cold inputs), in %."""

from benchmarks.harness.probes import registration_stats_bytes, registration_stats_us
from benchmarks.harness.stats import bytes_bound_s, roofline_share

UNIT = "%"
LAYER = "kernels"
MOVES = "frames_per_s"


def read(record):
    if not record.trace or record.device.type != "cuda":
        return None
    cf = record.slam["cf"]
    h, w = cf["height"], cf["width"]
    return roofline_share(bytes_bound_s(registration_stats_bytes(h, w)),
                          1e-6 * registration_stats_us(h, w, record.device))
