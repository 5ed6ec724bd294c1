"""Σ over the last two axes of a float32 (..., H, W) tensor.

Counterpart of ``sum_only_pallas`` in ``scripts/pkbench.py``: the
"streaming only" control of the ``peak_stats`` A/B benchmark, a pass over
the same bytes with none of the max/argmax work.  On the card it is the
hand-written CUDA kernel ``nislam_torch/csrc/sum_only.cu``; on the CPU it
is :func:`sum_only_reference`, the plain version the kernel is tested
against.
"""

from __future__ import annotations

import ctypes

import torch

from nislam_torch.ops.peak_stats import _bands


def sum_only_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sum`` over the last two axes."""
    return torch.sum(x, dim=(-2, -1))


def _sum_only_cuda(x: torch.Tensor) -> torch.Tensor:
    from nislam_torch.kernels.build import load_library

    if not x.is_cuda:
        raise ValueError("the sum_only kernel takes a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"sum_only kernel takes float32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] * x.shape[-1] == 0:
        raise ValueError(f"sum_only needs a non-empty (..., H, W), got {tuple(x.shape)}")
    h, w = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    x = x.contiguous()
    b = x.numel() // (h * w)
    s, rows = _bands(b, h)
    dev = x.device
    out = torch.empty(b, dtype=torch.float32, device=dev)
    part = torch.empty(b * s, dtype=torch.float32, device=dev)
    lib = load_library("sum_only", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nislam_sum_only_f32(x.data_ptr(), b, h, w, s, rows, part.data_ptr(),
                                      out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sum_only kernel launch failed: CUDA error {err}")
    sum_only.launches += 1
    return out.reshape(lead)


def sum_only(x: torch.Tensor, force: str | None = None) -> torch.Tensor:
    """Σ over the last two axes.

    A CUDA tensor goes to the kernel (which raises if it cannot run), a CPU
    tensor to :func:`sum_only_reference`.  ``force`` ∈ {"kernel",
    "reference"} pins the choice.  ``sum_only.launches`` counts kernel
    launches."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and x.is_cuda):
        return _sum_only_cuda(x)
    return sum_only_reference(x)


sum_only.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of the kernel's entry point."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nislam_sum_only_f32.argtypes = [p, i, i, i, i, i, p, p, p]
    lib.nislam_sum_only_f32.restype = ctypes.c_int
