"""The stitcher's rasterisation: frames added into the occupancy canvas.

``stitch_raster(data, weight, images, consts, enabled, scale, wsign,
center)`` maps every pixel (j, i) of each (H, W) frame through the frame's
constants ``(r00, r01, r10, r11, px, py)`` (its image-plane rotation and
translation) to the canvas cell of ``trunc(R·(i − W/2, j − H/2) + p)``
and adds ``image × scale`` into ``data`` and ``wsign`` into ``weight``, in
place, in the flat order of the pixels (frame-major): what two CPU
``index_add_`` calls over the flat targets compute, bit for bit.  Pixels
off the canvas, and every pixel of a frame that ``enabled`` masks, add
nothing.

On the card each frame is one launch of the hand-written CUDA kernel
``nislam_torch/csrc/stitch_raster.cu``, which computes the targets itself
with eager PyTorch's rounding and sums each cell's pixels in flat order
with no sort (the first pixel of a cell in its 5×5 window owns it); the
frames of a batch are launched in order, which keeps the flat order.  On
the CPU the wrapper takes :func:`stitch_raster_reference`, the plain
version the kernel is tested against: :func:`frame_cells` and two
``index_add_``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nislam_torch.ops.scatter_add import index_add_reference

# (r00, r01, r10, r11, px, py) per frame.
CONSTS = 6
# The kernel's window argument needs the map's float32 rounding far below
# the 0.12-pixel margin: canvas coordinates and frame sides below 2^16.
COORD_LIMIT = 1 << 16


def image_targets(consts: torch.Tensor, hw) -> tuple:
    """Integer image-plane coordinates (x, y), each (..., H, W) int32, of
    every pixel of frames with constants ``consts`` (..., 6), truncated
    toward zero: ``x = (r00·iw + r01·ih) + px`` with ``iw = i − W/2`` and
    ``ih = j − H/2``, one float32 rounding per operation."""
    h, w = hw
    dev = consts.device
    k = consts[..., None, None, :]  # (..., 1, 1, 6)
    iw = torch.arange(w, dtype=torch.float32, device=dev) - w / 2.0
    ih = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - h / 2.0
    x = k[..., 0] * iw + k[..., 1] * ih + k[..., 4]
    y = k[..., 2] * iw + k[..., 3] * ih + k[..., 5]
    return torch.trunc(x).to(torch.int32), torch.trunc(y).to(torch.int32)


def frame_cells(consts: torch.Tensor, hw, size: int, center, enabled) -> tuple:
    """Flat cells (..., H, W) i64 of a ``size``² canvas centred on image-
    plane pixel ``center`` = (cx, cy) for every pixel of frames with
    constants ``consts`` (..., 6), and the mask (..., H, W) of those that
    land on the canvas in an enabled frame (``enabled`` broadcast to the
    leading axes).  A masked pixel points at cell 0: it adds exact zeros
    (+0 to data, ±0 to weight) to a cell that is never −0, which leaves
    its bits."""
    xi, yi = image_targets(consts, hw)
    col = xi - center[0] + size // 2
    row = yi - center[1] + size // 2
    inb = (col >= 0) & (col < size) & (row >= 0) & (row < size)
    if isinstance(enabled, torch.Tensor):
        en = enabled.to(device=consts.device, dtype=torch.bool)
    else:  # filled on the device: no copy from the host
        en = torch.full((), bool(enabled), dtype=torch.bool, device=consts.device)
    ok = inb & en.reshape(en.shape + (1, 1))
    return torch.where(ok, row.long() * size + col, 0), ok


def stitch_raster_reference(data: torch.Tensor, weight: torch.Tensor, images: torch.Tensor,
                            consts: torch.Tensor, enabled, scale: float, wsign: float, center) -> None:
    """Plain PyTorch version: :func:`frame_cells`, then ``index_add_`` of
    the values and of the weights over the flat pixels, in place."""
    idx, ok = frame_cells(consts, images.shape[-2:], data.shape[0], center, enabled)
    idx = idx.reshape(-1)
    index_add_reference(data.view(-1), idx, torch.where(ok, images * scale, 0.0).reshape(-1))
    index_add_reference(weight.view(-1), idx, wsign * ok.to(torch.float32).reshape(-1))


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound at the first call."""
    from nislam_torch.kernels.build import load_library

    return load_library("stitch_raster", _bind)


def _check(data, weight, images, consts, center) -> None:
    tensors = (data, weight, images, consts)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the stitch_raster kernel takes CUDA tensors")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"stitch_raster kernel takes float32, got {[t.dtype for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("stitch_raster: canvas, images and constants lie on different devices")
    s = data.shape[0]
    if data.dim() != 2 or data.shape != (s, s) or weight.shape != (s, s) or s == 0:
        raise ValueError(f"stitch_raster: data and weight must be one (S, S), got {tuple(data.shape)} "
                         f"and {tuple(weight.shape)}")
    if not (data.is_contiguous() and weight.is_contiguous()):
        raise ValueError("stitch_raster kernel takes contiguous canvases")
    if images.dim() < 2 or consts.shape != images.shape[:-2] + (CONSTS,):
        raise ValueError(f"stitch_raster: constants {tuple(consts.shape)} do not match images "
                         f"{tuple(images.shape)}")
    h, w = images.shape[-2:]
    if max(h, w) >= COORD_LIMIT or max(abs(int(center[0])), abs(int(center[1]))) + s >= COORD_LIMIT:
        raise ValueError(f"stitch_raster: frame {h}x{w} or canvas {s} at {tuple(center)} reaches "
                         f"coordinates of 2^16, where the kernel's window argument does not hold")


def _stitch_raster_cuda(data, weight, images, consts, enabled, scale, wsign, center) -> None:
    _check(data, weight, images, consts, center)
    h, w = images.shape[-2:]
    lead = tuple(images.shape[:-2])
    f = math.prod(lead)
    if f == 0 or h == 0 or w == 0:
        return
    imgs = images.contiguous()
    k = consts.contiguous()
    if isinstance(enabled, torch.Tensor):
        en = torch.broadcast_to(enabled.to(device=data.device, dtype=torch.bool), lead).reshape(f)
        en_ptr, en_step, on = en.data_ptr(), en.stride(0), 1
    else:  # a host flag: no copy to the card
        en_ptr, en_step, on = None, 0, int(bool(enabled))
    s = data.shape[0]
    lib = _library()
    index = data.device.index
    with torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        for n in range(f):  # frame-major: in order, as one flat scatter of the batch
            err = lib.nislam_stitch_raster_f32(
                imgs.data_ptr() + 4 * n * h * w, h, w, k.data_ptr() + 4 * CONSTS * n,
                None if en_ptr is None else en_ptr + n * en_step, on, w / 2.0, h / 2.0, s,
                s // 2 - int(center[0]), s // 2 - int(center[1]), scale, wsign,
                data.data_ptr(), weight.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"stitch_raster kernel launch failed: CUDA error {err}")
            stitch_raster.launches += 1


def stitch_raster(data: torch.Tensor, weight: torch.Tensor, images: torch.Tensor, consts: torch.Tensor,
                  enabled, scale: float, wsign: float, center, force: str | None = None) -> None:
    """Add frames ``images`` (..., H, W) f32 with constants ``consts``
    (..., 6) into the (S, S) canvases ``data`` (``image × scale``) and
    ``weight`` (``wsign``) centred on image-plane pixel ``center``, in
    place.  ``enabled`` (a bool or a bool tensor, broadcast to the leading
    axes) masks whole frames.

    A CUDA canvas goes to the kernel, one launch per frame (which raises
    if it cannot run), a CPU canvas to :func:`stitch_raster_reference`.
    ``force`` ∈ {"kernel", "reference"} pins the choice.
    ``stitch_raster.launches`` counts kernel launches."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and data.is_cuda):
        _stitch_raster_cuda(data, weight, images, consts, enabled, scale, wsign, center)
    else:
        stitch_raster_reference(data, weight, images, consts, enabled, scale, wsign, center)


stitch_raster.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of the library's entry point."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nislam_stitch_raster_f32.argtypes = [p, i, i, p, p, i, f, f, i, i, i, f, f, p, p, p]
    lib.nislam_stitch_raster_f32.restype = i
