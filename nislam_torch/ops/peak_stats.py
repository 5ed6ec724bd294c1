"""Fused correlation-response reduction: peak, argmax, Σg, Σg².

Counterpart of ``nislam_tpu.ops.pallas_kernels``.  Every KCC registration
ends with one pass over its (H, W) response.  On the card that pass is the
hand-written CUDA kernel ``nislam_torch/csrc/peak_stats.cu``; on the CPU it
is :func:`peak_stats_reference`, the plain version the kernel is tested
against.

The argmax is the **first maximum in column-major order** (the reference's
Eigen ``maxCoeff`` traverses column-major storage), reported as a row-major
flat index.  NaN responses are not supported by either path.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# Blocks pass 1 aims for: a few waves over the card's 132 SMs.
_TARGET_BLOCKS = 4 * 132


def peak_stats_reference(g: torch.Tensor) -> Stats:
    """Plain PyTorch version: ``(peak f32, idx i32, sum f32, sumsq f32)``
    over the last two axes."""
    h, w = g.shape[-2], g.shape[-1]
    lead = g.shape[:-2]
    flat = g.reshape(*lead, h * w)
    # argmax over the transposed view = first maximum in column-major order.
    idx_cm = torch.argmax(g.transpose(-2, -1).reshape(*lead, h * w), dim=-1)
    idx = (idx_cm % h) * w + idx_cm // h
    peak = torch.take_along_dim(flat, idx[..., None], dim=-1)[..., 0]
    return peak, idx.to(torch.int32), flat.sum(-1), (flat * flat).sum(-1)


def _bands(b: int, h: int) -> Tuple[int, int]:
    """(bands per response, rows per band) for pass 1."""
    s = max(1, min(h, -(-_TARGET_BLOCKS // b)))
    rows = -(-h // s)
    return -(-h // rows), rows


def _peak_stats_cuda(g: torch.Tensor) -> Stats:
    from nislam_torch.kernels.build import load_library

    if not g.is_cuda:
        raise ValueError("the peak_stats kernel takes a CUDA tensor")
    if g.dtype != torch.float32:
        raise TypeError(f"peak_stats kernel takes float32, got {g.dtype}")
    if g.dim() < 2 or g.shape[-2] * g.shape[-1] == 0:
        raise ValueError(f"peak_stats needs a non-empty (..., H, W), got {tuple(g.shape)}")
    h, w = g.shape[-2], g.shape[-1]
    if h * w >= 2**31:
        raise ValueError("peak_stats kernel indexes one response with int32")
    lead = g.shape[:-2]
    g = g.contiguous()
    b = g.numel() // (h * w)
    s, rows = _bands(b, h)
    dev = g.device
    peak = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    sm = torch.empty(b, dtype=torch.float32, device=dev)
    ss = torch.empty(b, dtype=torch.float32, device=dev)
    part_f = torch.empty((3, b * s), dtype=torch.float32, device=dev)
    part_i = torch.empty(b * s, dtype=torch.int32, device=dev)
    lib = load_library("peak_stats", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nislam_peak_stats_f32(
            g.data_ptr(), b, h, w, s, rows,
            part_f.data_ptr(), part_i.data_ptr(),
            peak.data_ptr(), idx.data_ptr(), sm.data_ptr(), ss.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"peak_stats kernel launch failed: CUDA error {err}")
    peak_stats.launches += 1
    return peak.reshape(lead), idx.reshape(lead), sm.reshape(lead), ss.reshape(lead)


def peak_stats(g: torch.Tensor, force: str | None = None) -> Stats:
    """``(peak, flat_argmax, sum, sum_of_squares)`` over the last two axes.

    A CUDA tensor goes to the kernel (which raises if it cannot run), a CPU
    tensor to :func:`peak_stats_reference`.  ``force`` ∈ {"kernel",
    "reference"} pins the choice.  ``peak_stats.launches`` counts kernel
    launches."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and g.is_cuda):
        return _peak_stats_cuda(g)
    return peak_stats_reference(g)


peak_stats.launches = 0


def psr_from_stats(
    peak: torch.Tensor, s: torch.Tensor, ss: torch.Tensor, n: int
) -> torch.Tensor:
    """PSR from the fused moments: ``side_mean = (Σg − peak)/(n−1)``,
    ``std = sqrt(ss/n − 2·side_mean·s/n + side_mean²)``."""
    side_mean = (s - peak) / (n - 1)
    var = ss / n - 2.0 * side_mean * s / n + side_mean * side_mean
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return (peak - side_mean) / (std + 1e-7)


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of the kernel's entry point."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nislam_peak_stats_f32.argtypes = [p, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.nislam_peak_stats_f32.restype = ctypes.c_int
