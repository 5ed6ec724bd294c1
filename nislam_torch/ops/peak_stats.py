"""Fused correlation-response reduction: peak, argmax, Σg, Σg².

Counterpart of ``nislam_tpu.ops.pallas_kernels``.  Every KCC registration
ends with one pass over its (H, W) response.  On the card that pass is the
hand-written CUDA kernel ``nislam_torch/csrc/peak_stats.cu``, one launch
that also derives the registration's ``(trans, psr)`` from the four
statistics (:func:`registration_stats`); on the CPU it is
:func:`peak_stats_reference` and :func:`registration_epilogue`, the plain
versions the kernel is tested against.

The argmax is the **first maximum in column-major order** (the reference's
Eigen ``maxCoeff`` traverses column-major storage), reported as a row-major
flat index.  NaN responses are not supported by either path.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

from nislam_torch.kernels.launch import block_ranges, check_input, launch_reduction

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (trans, psr) and then the four statistics
RegStats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


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


def psr_from_stats(
    peak: torch.Tensor, s: torch.Tensor, ss: torch.Tensor, n: int
) -> torch.Tensor:
    """PSR from the fused moments: ``side_mean = (Σg − peak)/(n−1)``,
    ``std = sqrt(ss/n − 2·side_mean·s/n + side_mean²)``."""
    side_mean = (s - peak) / (n - 1)
    var = ss / n - 2.0 * side_mean * s / n + side_mean * side_mean
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return (peak - side_mean) / (std + 1e-7)


def registration_epilogue(
    peak: torch.Tensor, idx: torch.Tensor, s: torch.Tensor, ss: torch.Tensor,
    shape: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a registration wants of its response's four statistics →
    ``(trans, psr)``: ``trans = (−(row − H//2), −(col − W//2))`` at ``idx``
    and :func:`psr_from_stats`.  The kernel computes the same in its last
    step; on CPU tensors this is IEEE f32 arithmetic, which the kernel
    reproduces bit for bit (PyTorch's CUDA division by a Python number
    multiplies by its reciprocal and may differ in the last bit)."""
    h, w = shape
    row = torch.div(idx, w, rounding_mode="floor").float()
    col = torch.remainder(idx, w).float()
    trans = torch.stack([-(row - h // 2), -(col - w // 2)], dim=-1)
    return trans, psr_from_stats(peak, s, ss, h * w)


def registration_stats_reference(g: torch.Tensor, shape: Tuple[int, int]) -> RegStats:
    """Plain PyTorch version of :func:`registration_stats`."""
    _check_shape(g, shape)
    stats = peak_stats_reference(g)
    return (*registration_epilogue(*stats, shape), *stats)


def _check_shape(g: torch.Tensor, shape: Tuple[int, int]) -> None:
    if tuple(g.shape[-2:]) != tuple(shape):
        raise ValueError(f"response of shape {tuple(g.shape)} is not (..., {shape[0]}, {shape[1]})")


@functools.cache
def _entry():
    """The kernel's C entry point, built and bound at the first call."""
    from nislam_torch.kernels.build import load_library

    return load_library("peak_stats", _bind).nislam_peak_stats_f32


def _peak_stats_cuda(g: torch.Tensor, rows: int | None = None, blocks: int | None = None) -> RegStats:
    """One launch of the kernel → ``(trans, psr, peak, idx, sum, sumsq)``,
    all views of one packed output allocation (a record of 8 words per
    response)."""
    g = check_input(g, "peak_stats")
    out = torch.empty((*g.shape[:-2], 8), dtype=torch.float32, device=g.device)
    launch_reduction(_entry(), "peak_stats", g, rows, 4, out, blocks)
    peak_stats.launches += 1
    peak_stats.shapes[g.shape] += 1
    _, _, psr, peak, idx, sm, ss, _ = out.unbind(-1)
    return out[..., :2], psr, peak, idx.view(torch.int32), sm, ss


def _pick_kernel(g: torch.Tensor, force: str | None) -> bool:
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    return force == "kernel" or (force is None and g.is_cuda)


def peak_stats(g: torch.Tensor, force: str | None = None, rows: int | None = None) -> Stats:
    """``(peak, flat_argmax, sum, sum_of_squares)`` over the last two axes.

    A CUDA tensor goes to the kernel (which raises if it cannot run), a CPU
    tensor to :func:`peak_stats_reference`.  ``force`` ∈ {"kernel",
    "reference"} pins the choice.  ``rows`` pins the rows one block of the
    kernel reads (the ``block_rows`` of the JAX row-blocked kernel; the
    plain version ignores it).  ``peak_stats.launches`` counts kernel
    launches, those of :func:`registration_stats` included, and
    ``peak_stats.shapes`` the same launches by response shape."""
    if _pick_kernel(g, force):
        return _peak_stats_cuda(g, rows)[2:]
    return peak_stats_reference(g)


peak_stats.launches = 0
peak_stats.shapes = collections.Counter()


def registration_stats(
    g: torch.Tensor, shape: Tuple[int, int], force: str | None = None, blocks: int | None = None
) -> RegStats:
    """``(trans, psr, peak, flat_argmax, sum, sum_of_squares)`` of responses
    ``g`` of ``shape`` = (H, W): the four statistics of :func:`peak_stats`
    and what a registration derives from them
    (:func:`registration_epilogue`), in the same single launch on the card;
    a CPU tensor takes :func:`registration_stats_reference`.  ``blocks``
    pins the kernel's blocks per response (:func:`lane_blocks`), which fix
    how Σg and Σg² of a response are split and so their last bits; the
    plain version sums in one order and ignores it."""
    _check_shape(g, shape)
    if _pick_kernel(g, force):
        return _peak_stats_cuda(g, blocks=blocks)
    return registration_stats_reference(g, shape)


def lane_blocks(g: torch.Tensor, lanes: int) -> int | None:
    """The pin (:func:`registration_stats`' ``blocks``) that splits each
    response of ``g`` (..., H, W), whose leading axis holds ``lanes`` equal
    groups of responses, over as many blocks as a launch over one group
    would: a batched loop search over gathered lanes gets each lane's
    statistics bit for bit as that lane's own search gets them.  None for
    one group: the launch's own geometry."""
    if lanes == 1:
        return None
    h, w = g.shape[-2], g.shape[-1]
    responses = g.numel() // (h * w)
    if responses % lanes:
        raise ValueError(f"{responses} responses do not split into {lanes} lanes")
    return block_ranges(responses // lanes, h, w)[0]


def device_launches(device: torch.device) -> int:
    """The kernel's launches that have run on ``device``, as the kernel
    itself counts them (one atomic per launch): those inside CUDA graphs
    and their conditional bodies included.  Waits for the device."""
    from nislam_torch.kernels.build import load_library
    from nislam_torch.kernels.launch import cuda_check

    n = ctypes.c_ulonglong()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        cuda_check(load_library("peak_stats", _bind).nislam_peak_stats_device_launches(ctypes.byref(n)),
                   "reading peak_stats' device launch count")
    return n.value


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of the kernel's entry point and its
    device launch count."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nislam_peak_stats_f32.argtypes = [p, i, i, i, i, i, i, p, ctypes.c_longlong, p, p]
    lib.nislam_peak_stats_f32.restype = ctypes.c_int
    lib.nislam_peak_stats_device_launches.argtypes = [p]
    lib.nislam_peak_stats_device_launches.restype = ctypes.c_int
