"""Spectral primitives with the reference FFT conventions, on ``torch.fft``.

Counterpart of ``nislam_tpu.ops.fft``.  Transforms use the ``rfft2``
convention over row-major ``(..., H, W)`` tensors (half spectrum along the
last axis); every inverse normalizes by ``1/N`` like numpy's default and
the reference's ``IFFT``.  On the card ``torch.fft`` runs cuFFT, so the
matmul-DFT backends of the JAX package (a TPU workaround) have no
counterpart here: the port is held against the JAX ``xla`` backend.

Persistent state stores spectra as float pairs ``(..., N, 2)``
(:func:`c2r`), as the JAX package does: torch has no bf16 complex type, and
the bf16 keyframe bank needs pairs.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def c2r(x: torch.Tensor) -> torch.Tensor:
    """Complex (..., N) → float32 (..., N, 2) pair view (no copy)."""
    return torch.view_as_real(x)


def r2c(y: torch.Tensor) -> torch.Tensor:
    """Float (..., N, 2) → complex64 (..., N); upcasts bf16 storage so every
    consumer computes in f32."""
    if y.dtype != torch.float32:
        y = y.float()
    return torch.view_as_complex(y.contiguous())


def _project_edges(xf: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Zero the imaginary part of the DC (and, for even ``n``, Nyquist)
    bins along ``dim``.  numpy's c2r transform ignores those imaginary
    parts; cuFFT's result is undefined for them, so the port drops them
    explicitly and both backends compute the same inverse."""
    im = xf.imag.clone()
    im.select(dim, 0).zero_()
    if n % 2 == 0:
        im.select(dim, n // 2).zero_()
    return torch.complex(xf.real, im)


def rfft2(x: torch.Tensor) -> torch.Tensor:
    """Real 2D FFT over the last two axes → (..., H, W//2+1) complex64."""
    return torch.fft.rfft2(x.float())


def irfft2(xf: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`rfft2` with explicit spatial ``shape``; a real
    input is read as a spectrum with zero imaginary part."""
    return torch.fft.irfft2(xf, s=tuple(shape))


def rfft2_from_last_spectrum(g: torch.Tensor) -> torch.Tensor:
    """Finish an rfft2 from the row-wise half spectrum ``g``: only the H-axis
    DFT, so ``rfft2(irfft_last(g)) == rfft2_from_last_spectrum(g)``."""
    return torch.fft.fft(g, dim=-2)


def rfft_last(x: torch.Tensor) -> torch.Tensor:
    """1D real FFT along the last axis."""
    return torch.fft.rfft(x.float(), dim=-1)


def irfft_last(xf: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.irfft(_project_edges(xf, n, -1), n=n, dim=-1)


def rfft_ax2(x: torch.Tensor) -> torch.Tensor:
    """1D real FFT along axis -2."""
    return torch.fft.rfft(x.float(), dim=-2)


def irfft_ax2(xf: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.irfft(_project_edges(xf, n, -2), n=n, dim=-2)


def impulse_spectrum_pair(h: int, w: int) -> np.ndarray:
    """Float-pair half spectrum ``(h, w//2+1, 2)`` of a unit impulse at
    ``(h//2, w//2)`` — the KCC target, in closed form (numpy copy of
    ``nislam_tpu.ops.fft.impulse_spectrum_pair``, tested bit-equal)."""
    ky = np.arange(h)
    kx = np.arange(w // 2 + 1)
    phase = -2.0 * math.pi * (
        ky[:, None] * ((h // 2) / h) + kx[None, :] * ((w // 2) / w)
    )
    return np.stack([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)
