"""Chunked reader of packed NISF frame files (written by ``Dataset.pack``).

Same interface as ``nislam_tpu.io.native_loader.NativeChunkReader`` — a
test holds its chunks and timestamps byte-equal to that reader's — built on
``np.memmap`` instead of a C++ library: the file is mapped once, chunks are
copied out of the page cache by a small thread pool that reads up to
``ring`` chunks ahead (numpy releases the interpreter lock while it
copies).  With ``pin=True`` (a reader feeding a CUDA card) those threads
copy each chunk straight into page-locked host memory, so the engine's
streamed driver only issues its asynchronous upload.

File layout (little endian): ``'NISF' | u32 version | u32 n | u32 h |
u32 w``, then n float64 timestamps, then n (h, w) frames — uint8 for
version 2, float32 for version 1.
"""

from __future__ import annotations

import collections
import itertools
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

_HEADER = struct.Struct("<4sIIII")
_DTYPES = {1: np.dtype("<f4"), 2: np.dtype(np.uint8)}
_TORCH_DTYPES = {np.uint8: torch.uint8, np.float32: torch.float32}


class NativeChunkReader:
    """Iterate ``(frames (N ≤ chunk, H, W), times (N,) f64)`` chunks in the
    file's stored dtype (:attr:`dtype`); the frames are numpy arrays, or
    pinned CPU tensors with ``pin=True`` (needs CUDA).  A pinned chunk is
    allocated by PyTorch's caching host allocator, which keeps freed blocks
    for reuse and hands one out again only after the uploads recorded on it
    have finished, so at most ``ring`` + 2 chunk buffers are live."""

    def __init__(self, path: str, chunk: int, *, threads: int = 2, ring: int = 4,
                 pin: bool = False):
        if not os.path.exists(path):
            raise FileNotFoundError(f"cannot open NISF file {path}")
        with open(path, "rb") as f:
            head = f.read(_HEADER.size)
        if len(head) != _HEADER.size:
            raise ValueError(f"{path}: truncated NISF header")
        magic, version, n, h, w = _HEADER.unpack(head)
        if magic != b"NISF" or version not in _DTYPES:
            raise ValueError(f"{path}: not a NISF v1/v2 file")
        dtype = _DTYPES[version]
        frames_at = _HEADER.size + 8 * n
        need = frames_at + n * h * w * dtype.itemsize
        if os.path.getsize(path) < need:
            raise ValueError(f"{path}: {os.path.getsize(path)} bytes, header says {need}")
        self.n, self.height, self.width = n, h, w
        self.dtype = np.uint8 if version == 2 else np.float32
        self.chunk = chunk
        self._pin = pin
        self._ring = max(1, ring)
        self._times = np.memmap(path, dtype="<f8", mode="r", offset=_HEADER.size, shape=(n,))
        self._frames = (
            np.memmap(path, dtype=dtype, mode="r", offset=frames_at, shape=(n, h, w))
            if n else np.zeros((0, h, w), dtype)
        )
        self._pool = ThreadPoolExecutor(max_workers=threads) if threads > 0 else None

    @staticmethod
    def available() -> bool:
        """Always true: the reader needs nothing beyond numpy."""
        return True

    def __len__(self) -> int:
        return self.n

    def _read(self, start: int) -> Tuple[np.ndarray, np.ndarray]:
        stop = min(start + self.chunk, self.n)
        times = np.array(self._times[start:stop], dtype=np.float64)
        if not self._pin:
            return np.array(self._frames[start:stop], dtype=self.dtype), times
        frames = torch.empty((stop - start, self.height, self.width),
                             dtype=_TORCH_DTYPES[self.dtype], pin_memory=True)
        np.copyto(frames.numpy(), self._frames[start:stop])
        return frames, times

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        starts = iter(range(0, self.n, self.chunk))
        if self._pool is None:
            for s in starts:
                yield self._read(s)
            return
        ahead = collections.deque(
            self._pool.submit(self._read, s) for s in itertools.islice(starts, self._ring)
        )
        while ahead:
            done = ahead.popleft()
            nxt = next(starts, None)
            if nxt is not None:
                ahead.append(self._pool.submit(self._read, nxt))
            yield done.result()

    def frame(self, idx: int) -> np.ndarray:
        """Read-only view of one frame in the mapped file (stored dtype)."""
        if not 0 <= idx < self.n:
            raise IndexError(idx)
        return self._frames[idx]

    def timestamps(self) -> np.ndarray:
        return np.array(self._times, dtype=np.float64)

    def close(self) -> None:
        pool = getattr(self, "_pool", None)  # absent if __init__ raised
        if pool is not None:
            pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):
        self.close()
