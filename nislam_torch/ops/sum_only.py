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
import functools

import torch

from nislam_torch.kernels.launch import check_input, launch_reduction


def sum_only_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sum`` over the last two axes."""
    return torch.sum(x, dim=(-2, -1))


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound at the first call."""
    from nislam_torch.kernels.build import load_library

    return load_library("sum_only", _bind)


def _sum_only_cuda(x: torch.Tensor) -> torch.Tensor:
    x = check_input(x, "sum_only")
    out = torch.empty(x.shape[:-2], dtype=torch.float32, device=x.device)
    launch_reduction(_library().nislam_sum_only_f32, "sum_only", x, None, 1, out)
    sum_only.launches += 1
    return out


def empty_launch(stream: int) -> None:
    """One launch of the library's empty kernel on ``stream`` (a handle):
    what :func:`nislam_torch.utils.profiling.launch_floor_ms` times."""
    err = _library().nislam_empty_launch(stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


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
    """Declare the C signatures of the library's entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nislam_sum_only_f32.argtypes = [p, i, i, i, i, i, i, p, ctypes.c_longlong, p, p]
    lib.nislam_sum_only_f32.restype = ctypes.c_int
    lib.nislam_empty_launch.argtypes = [p]
    lib.nislam_empty_launch.restype = ctypes.c_int
