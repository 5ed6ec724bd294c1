"""The streamed driver's feed and the profiler's busy share, without JAX.

- ``device_activity`` on a hand-made trace: the union of device intervals
  (overlapping streams count once) over the window of host and device
  events, and the host's kernel launches; on a real CPU trace from
  ``trace``, no device time.
- The NISF reader with ``pin=True`` (a reader feeding the card) gives
  pinned tensors byte-equal to its numpy chunks.  Pinned host memory is a
  CUDA allocation, so these cases are marked ``gpu`` and skip without a
  card; they need no JAX.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from nislam_torch.io.native_loader import NativeChunkReader
from nislam_torch.utils.profiling import device_activity, trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_device_activity_reads_one_trace(tmp_path):
    events = [
        _x("cpu_op", "aten::mul", 100.0, 50.0),  # window starts at 100
        _x("cuda_runtime", "cudaLaunchKernel", 110.0, 5.0),
        _x("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0),
        _x("cuda_runtime", "cudaMemcpyAsync", 130.0, 5.0),
        _x("kernel", "k1", 200.0, 100.0),
        _x("kernel", "k2", 250.0, 100.0),  # overlaps k1 on another stream: 200..350
        _x("gpu_memcpy", "Memcpy HtoD", 400.0, 20.0),
        _x("gpu_memset", "Memset", 410.0, 30.0),  # 400..440
        _x("gpu_user_annotation", "range", 100.0, 1000.0),  # not device work
        {"ph": "s", "cat": "ac2g", "ts": 110.0},  # flow arrows carry no time
        _x("cpu_op", "aten::sync", 1000.0, 100.0),  # window ends at 1100
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    act = device_activity(str(path))
    assert act == {
        "busy_ms": 0.19, "window_ms": 1.0, "busy_share": pytest.approx(0.19),
        "launches": 2, "device_events": 4,
    }


def test_device_activity_on_a_cpu_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.fft.rfft2(torch.ones(64, 64)).abs().sum()
    assert os.path.getsize(tmp_path / "key_averages.txt") > 0
    act = device_activity(str(tmp_path / "trace.json"))
    assert act["window_ms"] > 0 and act["device_events"] == 0 and act["busy_share"] == 0.0


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned host memory is a CUDA allocation")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("version", [1, 2])
def test_pinned_nisf_reader_matches(cuda, tmp_path, version):
    n, h, w = 11, 6, 7
    rng = np.random.default_rng(version)
    frames = rng.random((n, h, w)).astype(np.float32)
    if version == 2:
        frames = (frames * 255).astype(np.uint8)
    path = str(tmp_path / "f.nisf")
    with open(path, "wb") as f:
        f.write(struct.pack("<4sIIII", b"NISF", version, n, h, w))
        f.write((np.arange(n) / 30.0).astype("<f8").tobytes())
        f.write(frames.tobytes())
    for threads in (0, 2):
        plain = NativeChunkReader(path, 4, threads=threads, ring=2)
        pinned = NativeChunkReader(path, 4, threads=threads, ring=2, pin=True)
        want, got = list(plain), list(pinned)
        plain.close()
        pinned.close()
        assert [len(x[0]) for x in got] == [4, 4, 3]
        for (pa, pt), (na, nt) in zip(got, want):
            assert isinstance(pa, torch.Tensor) and pa.is_pinned()
            assert pa.numpy().dtype == na.dtype and pa.numpy().tobytes() == na.tobytes()
            assert pt.tobytes() == nt.tobytes()
