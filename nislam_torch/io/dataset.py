"""Dataset readers: the reference layout, the TUM RGB-D layout, in-memory frames.

Copy of ``nislam_tpu.io.dataset`` (numpy only; a test holds the two
equal).  The reference layout is ``dataroot/image_names.txt`` (one file
name per line) + ``dataroot/<image_dir>/`` + an optional
``dataroot/times.txt``; missing timestamps are −1.0.  The TUM layout is
``rgb.txt`` with ``timestamp path`` lines.  Images are read with cv2 or
PIL, whichever is installed, imported at first read.

:meth:`_Base.pack` writes the packed NISF file that
:mod:`nislam_torch.io.native_loader` streams.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Tuple

import numpy as np


def _imread_gray_u8(path: str) -> np.ndarray:
    """Grayscale uint8 image via cv2 or PIL."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    except ImportError:
        pass
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("L"), np.uint8)
    except ImportError as exc:
        raise RuntimeError(f"no image backend (cv2/PIL) available to read {path}") from exc


def _imread_gray(path: str) -> np.ndarray:
    """Grayscale float32 [0, 1] image."""
    return _imread_gray_u8(path).astype(np.float32) / 255.0


class _Base:
    def __len__(self) -> int:
        raise NotImplementedError

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        """(image f32 [0, 1] of shape (H, W), timestamp or −1.0)."""
        raise NotImplementedError

    def get_raw(self, idx: int) -> Tuple[np.ndarray, float]:
        """Like :meth:`get` in the source's own dtype: uint8 for 8-bit image
        files (the engine normalizes /255 on the device), f32 otherwise."""
        return self.get(idx)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, float]]:
        for i in range(len(self)):
            yield self.get(i)

    def chunks(self, size: int, raw: bool = False) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Stacked ``(images (N ≤ size, H, W), times (N,) f64)`` chunks;
        ``raw=True`` serves the source dtype (:meth:`get_raw`)."""
        getter = self.get_raw if raw else self.get
        n = len(self)
        for start in range(0, n, size):
            pairs = [getter(i) for i in range(start, min(start + size, n))]
            yield (
                np.stack([p[0] for p in pairs]),
                np.asarray([p[1] for p in pairs], np.float64),
            )

    def pack(self, out_path: str) -> str:
        """Write the NISF file: little-endian header ``'NISF' | u32 version
        | u32 n | u32 h | u32 w``, n float64 timestamps, then n raw (H, W)
        frames — version 2 / uint8 for an 8-bit source, version 1 / f32
        otherwise."""
        img0, _ = self.get_raw(0)
        u8 = img0.dtype == np.uint8
        h, w = img0.shape
        n = len(self)
        with open(out_path, "wb") as f:
            f.write(struct.pack("<4sIIII", b"NISF", 2 if u8 else 1, n, h, w))
            times = np.asarray([self.get_raw(i)[1] for i in range(n)], "<f8")
            f.write(times.tobytes())
            for i in range(n):
                img, _ = self.get_raw(i)
                if img.shape != (h, w):
                    raise ValueError(f"frame {i} shape {img.shape} != {(h, w)}")
                f.write(img.tobytes() if u8 else img.astype("<f4").tobytes())
        return out_path


class ImageFolderDataset(_Base):
    """The reference layout; only ``image_names.txt`` is read up front."""

    def __init__(self, dataroot: str, image_dir_name: str = "rgb"):
        if not os.path.isdir(dataroot):
            raise FileNotFoundError(f"dataroot {dataroot} doesn't exist")
        self.image_dir = os.path.join(dataroot, image_dir_name)
        with open(os.path.join(dataroot, "image_names.txt")) as f:
            self.names: List[str] = [ln.split(",")[0].strip() for ln in f if ln.strip()]
        self.times: List[float] = []
        times_file = os.path.join(dataroot, "times.txt")
        if os.path.exists(times_file):
            with open(times_file) as f:
                self.times = [float(ln.split(",")[0]) for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.names)

    def _time(self, idx: int) -> float:
        return self.times[idx] if idx < len(self.times) else -1.0

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        return _imread_gray(os.path.join(self.image_dir, self.names[idx])), self._time(idx)

    def get_raw(self, idx: int) -> Tuple[np.ndarray, float]:
        return _imread_gray_u8(os.path.join(self.image_dir, self.names[idx])), self._time(idx)


class TumRgbdDataset(_Base):
    """TUM RGB-D layout: ``rgb.txt`` lines ``timestamp path``."""

    def __init__(self, dataroot: str, index_file: str = "rgb.txt"):
        self.root = dataroot
        self.entries: List[Tuple[float, str]] = []
        with open(os.path.join(dataroot, index_file)) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                t, rel = ln.split()[:2]
                self.entries.append((float(t), rel))

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        t, rel = self.entries[idx]
        return _imread_gray(os.path.join(self.root, rel)), t

    def get_raw(self, idx: int) -> Tuple[np.ndarray, float]:
        t, rel = self.entries[idx]
        return _imread_gray_u8(os.path.join(self.root, rel)), t


class SyntheticDataset(_Base):
    """In-memory frames; timestamps at a fixed rate."""

    def __init__(self, frames: np.ndarray, rate_hz: float = 30.0, t0: float = 0.0):
        self.frames = np.asarray(frames, np.float32)
        self.rate = rate_hz
        self.t0 = t0

    def __len__(self) -> int:
        return len(self.frames)

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        return self.frames[idx], self.t0 + idx / self.rate


def open_dataset(dataroot: str, image_dir_name: str = "rgb") -> _Base:
    """The reference layout (image_names.txt) or the TUM layout (rgb.txt)."""
    if os.path.exists(os.path.join(dataroot, "image_names.txt")):
        return ImageFolderDataset(dataroot, image_dir_name)
    if os.path.exists(os.path.join(dataroot, "rgb.txt")):
        return TumRgbdDataset(dataroot)
    raise FileNotFoundError(
        f"{dataroot}: neither image_names.txt (reference layout) nor "
        "rgb.txt (TUM layout) found"
    )
