"""Fixed-order ``index_add``: rows of ``src`` added into ``out`` at ``keys``.

``index_add_ordered(out, keys, src)`` computes ``out[keys[i]] += src[i]``
for i in index order, each row starting from its existing value: what the
CPU's ``index_add_`` and ``index_put_(accumulate=True)`` compute, bit for
bit.  On the card ``index_add_`` sums repeated rows with float atomics in
no fixed order; the hand-written CUDA kernel ``nislam_torch/csrc/
scatter_add.cu`` sums each run of equal keys of a stable sort of the keys
in sorted order instead, so a solve gives the same bits on every run, as
XLA's scatter does for the JAX package.  On the CPU the wrapper takes
:func:`index_add_reference`, the plain version the kernel is tested
against.

The sort and the run table (:func:`run_table`) depend only on the keys.
A caller that scatters with the same keys many times (every iteration of
a solve) makes one :class:`ScatterPlan` and passes it in place of the
keys.

A key outside ``[0, S)`` is never written.  The kernel reports it in an
error word of pinned host memory; the wrapper reads that word, with no
synchronisation, before each launch and raises on a report of an earlier
launch, and :func:`raise_on_bad_keys` reads it after a synchronisation.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch


def run_table(sorted_keys: torch.Tensor) -> torch.Tensor:
    """The run table of ``sorted_keys`` (N,): (N,) i64, at the first
    position of each run of equal keys (its head) the end of the run, 0
    at every other position.  A run's row is its head's key, its start the
    head's position, its length the end minus the start.  Plain tensor
    operations, with no host read."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = sorted_keys[1:] != sorted_keys[:-1]
    tail = torch.ones(n, dtype=torch.bool, device=dev)
    tail[:-1] = head[1:]
    run = torch.cumsum(head, 0) - 1
    # Each run's last position writes the run's end at the run's index;
    # the other positions write to slot N, which is never read.
    ends = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ends[torch.where(tail, run, n)] = torch.arange(1, n + 1, device=dev)
    return torch.where(head, ends[run], 0)


class ScatterPlan(NamedTuple):
    """The keys of a scatter and, for a CUDA tensor, their stable sort and
    its run table (:func:`run_table`)."""

    keys: torch.Tensor  # (N,) i64, in call order
    sorted_keys: Optional[torch.Tensor] = None  # (N,) i64, stable-sorted; None on the CPU
    order: Optional[torch.Tensor] = None  # (N,) i64: sorted_keys = keys[order]
    run_end: Optional[torch.Tensor] = None  # (N,) i64

    @classmethod
    def of(cls, keys: torch.Tensor) -> "ScatterPlan":
        """The plan of ``keys`` (int64, or any integer type); sorts only on
        the card, where the kernel needs it."""
        keys = keys.reshape(-1).long()
        if not keys.is_cuda:
            return cls(keys)
        sorted_keys, order = torch.sort(keys, stable=True)
        return cls(keys, sorted_keys, order, run_table(sorted_keys))


def spread_masked(keys: torch.Tensor, live: torch.Tensor, rows: int) -> torch.Tensor:
    """``keys`` with each masked entry (``live`` False) sent to row
    ``position mod rows`` instead.

    For callers whose masked entries add exact zeros into an output that
    starts at +0 (the solvers' dead edges):
    a row that starts at +0 never becomes −0, and adding ±0 to a row that
    is not −0 leaves its bits, so those entries may go to any row and the
    result is the same, bit for bit.  Spread out, they never form a long
    run of one key, whose adds are one chain on the card."""
    spread = torch.arange(keys.numel(), device=keys.device).reshape(keys.shape) % rows
    return torch.where(live, keys.long(), spread)


def index_add_reference(out: torch.Tensor, keys: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``out.index_add_(0, keys, src)``, in place."""
    return out.index_add_(0, keys, src)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound at the first call."""
    from nislam_torch.kernels.build import load_library

    return load_library("scatter_add", _bind)


@functools.cache
def _error_word() -> ctypes.c_int:
    """The kernel's error word (mapped pinned host memory), as a ctypes int."""
    addr = ctypes.c_void_p()
    err = _library().nislam_scatter_add_error_word(ctypes.byref(addr))
    if err != 0:
        raise RuntimeError(f"scatter_add: allocating the error word failed: CUDA error {err}")
    return ctypes.c_int.from_address(addr.value)


def _take_report() -> bool:
    """Whether a launch reported a key out of range since the last read;
    clears the report."""
    word = _error_word()
    bad = word.value != 0
    word.value = 0
    return bad


def raise_on_bad_keys(device: torch.device) -> None:
    """Waits for ``device`` and raises if a kernel launch met a key outside
    ``[0, S)`` since the last report."""
    torch.cuda.synchronize(device)
    if _take_report():
        raise IndexError("scatter_add: a key outside [0, S) was skipped")


def _check(out: torch.Tensor, plan: ScatterPlan, src: torch.Tensor) -> None:
    if not (out.is_cuda and src.is_cuda and plan.keys.is_cuda):
        raise ValueError("the scatter_add kernel takes CUDA tensors")
    if out.dtype != torch.float32 or src.dtype != torch.float32:
        raise TypeError(f"scatter_add kernel takes float32, got {out.dtype} and {src.dtype}")
    if plan.keys.dtype != torch.int64 or plan.keys.dim() != 1:
        raise TypeError(f"scatter_add kernel takes (N,) int64 keys, got {plan.keys.dtype} {tuple(plan.keys.shape)}")
    if not (out.device == src.device == plan.keys.device):
        raise ValueError("scatter_add: out, keys and src lie on different devices")
    if out.dim() not in (1, 2) or out.shape[0] == 0:
        raise ValueError(f"scatter_add: out must be (S,) or (S, C), got {tuple(out.shape)}")
    if src.shape != (plan.keys.shape[0],) + tuple(out.shape[1:]):
        raise ValueError(f"scatter_add: src {tuple(src.shape)} does not match keys "
                         f"{tuple(plan.keys.shape)} and out {tuple(out.shape)}")
    if not (out.is_contiguous() and src.is_contiguous()):
        raise ValueError("scatter_add kernel takes contiguous out and src")


def _index_add_cuda(out: torch.Tensor, plan: ScatterPlan, src: torch.Tensor) -> torch.Tensor:
    _check(out, plan, src)
    if plan.run_end is None:
        plan = ScatterPlan.of(plan.keys)
    n = plan.keys.shape[0]
    if n == 0:
        return out
    c = out.shape[1] if out.dim() == 2 else 1
    if _take_report():
        raise IndexError("scatter_add: an earlier launch skipped a key outside [0, S)")
    index = out.device.index
    with contextlib.nullcontext() if index == torch.cuda.current_device() else torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = _library().nislam_scatter_add_f32(plan.sorted_keys.data_ptr(), plan.run_end.data_ptr(),
                                                plan.order.data_ptr(), src.data_ptr(), out.data_ptr(), n, c,
                                                out.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {err}")
    index_add_ordered.launches += 1
    return out


def index_add_ordered(out: torch.Tensor, keys: Union[torch.Tensor, ScatterPlan], src: torch.Tensor,
                      force: str | None = None) -> torch.Tensor:
    """``out[keys[i]] += src[i]`` in index order, in place → ``out``.

    ``out`` is (S,) or (S, C) float32, ``src`` (N,) or (N, C) to match, and
    ``keys`` an (N,) integer tensor or its :class:`ScatterPlan`.  A CUDA
    tensor goes to the kernel (which raises if it cannot run), a CPU tensor
    to :func:`index_add_reference`.  ``force`` ∈ {"kernel", "reference"}
    pins the choice.  ``index_add_ordered.launches`` counts kernel
    launches."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    plan = keys if isinstance(keys, ScatterPlan) else ScatterPlan(keys.reshape(-1).long())
    if force == "kernel" or (force is None and out.is_cuda):
        return _index_add_cuda(out, plan, src)
    return index_add_reference(out, plan.keys, src)


index_add_ordered.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of the library's entry points."""
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.nislam_scatter_add_f32.argtypes = [p, p, p, p, p, ll, ctypes.c_int, ll, p]
    lib.nislam_scatter_add_f32.restype = ctypes.c_int
    lib.nislam_scatter_add_error_word.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.nislam_scatter_add_error_word.restype = ctypes.c_int
