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


def by_lane(fn, lanes: int, *args):
    """``fn(*args)`` where the leading axis of every tensor in ``args``
    holds ``lanes`` lanes (other arguments pass as they are).  On the CPU,
    with more than one lane, each lane's call on its own, the results
    stacked: MKL vectorizes a transform over a strided axis across the
    transforms that share its call, so a lane's bits would depend on the
    lanes beside it; lane by lane they are the bits of that lane's own
    program, which the plain version of a batched program (the batch
    engine's keyframe branch over gathered lanes) is held against.  On the
    card one call: cuFFT takes the batch whole."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    if lanes == 1 or device.type != "cpu":
        return fn(*args)
    outs = [fn(*(a[j] if isinstance(a, torch.Tensor) else a for a in args)) for j in range(lanes)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


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


def spectral_crop(xf: torch.Tensor, shape: tuple[int, int], scale: int) -> torch.Tensor:
    """Low-pass crop of an rfft2 half spectrum: the spectrum of the
    sinc-downsampled image at ``(H/scale, W/scale)``, scaled by ``1/scale²``
    so spatial values keep their magnitude.

    Keeps the ``Hs//2+1`` lowest and ``Hs//2-1`` highest row frequencies and
    the first ``Ws//2+1`` columns; the coarse Nyquist row and column are
    zeroed (their mirrors are cropped away), so the crop is Hermitian along
    column 0 and cuFFT's c2r transform of it is defined.  ``scale`` must
    divide both axes into even sizes."""
    h, w = shape
    hs, ws = h // scale, w // scale
    if hs * scale != h or ws * scale != w or hs % 2 or ws % 2:
        raise ValueError(f"spectral_crop: {h}x{w} not divisible into even {hs}x{ws}")
    ws2 = ws // 2 + 1
    top = xf[..., : hs // 2 + 1, :ws2].clone()
    bot = xf[..., h - (hs // 2 - 1):, :ws2].clone()
    top[..., hs // 2, :] = 0
    top[..., :, ws2 - 1] = 0
    bot[..., :, ws2 - 1] = 0
    return torch.cat([top, bot], dim=-2) * (1.0 / (scale * scale))


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """fftshift over the last two axes."""
    return torch.fft.fftshift(x, dim=(-2, -1))


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
