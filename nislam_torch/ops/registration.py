"""Kernel Cross-Correlator (KCC) registration — the front-end core.

Counterpart of ``nislam_tpu.ops.registration``: per-frame features
(:func:`compute_intermedium`), one closed-form registration
(:func:`estimate_trans`, ending in the ``peak_stats`` kernel) and the full
(x, y, θ) estimate with the 180° ambiguity resolution
(:func:`compute_pose`).  Everything is batched over leading axes and free
of host branches.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Tuple

import numpy as np
import torch
from torch import nn

from nislam_torch.ops.fft import by_lane, impulse_spectrum_pair, irfft2, r2c, rfft2
from nislam_torch.ops.peak_stats import lane_blocks, registration_stats
from nislam_torch.ops.warp import (
    polar_resample,
    polar_tap_constants,
    rotate_wrap,
    rotate_wrap_fft_spectrum,
)

# Legacy global rotation-PSR scale of the half-size polar correlation, the
# fallback of :func:`half_polar_psr_affine` when its probes fail.
HALF_POLAR_PSR_SCALE = 0.84


class CFOps(nn.Module):
    """Precomputed KCC tables: target spectra (float pairs) and the 4-tap
    polar table, as buffers; the config and the half-polar PSR map as
    attributes."""

    def __init__(self, cfg, half_psr_a: float, half_psr_b: float, target_fft,
                 target_rot_fft, polar_idx, polar_w):
        super().__init__()
        self.cfg = cfg
        self.half_psr_a = float(half_psr_a)
        self.half_psr_b = float(half_psr_b)
        self.register_buffer("target_fft", torch.as_tensor(target_fft))  # (H, W//2+1, 2)
        self.register_buffer("target_rot_fft", torch.as_tensor(target_rot_fft))  # (D, C//2+1, 2)
        self.register_buffer("polar_idx", torch.as_tensor(polar_idx))  # (D, C, 4) i32
        self.register_buffer("polar_w", torch.as_tensor(polar_w))  # (D, C, 4) f32


def _np_psr(g: np.ndarray) -> float:
    """Numpy PSR, same formula as :func:`psr`."""
    n = g.size
    peak = float(g.max())
    side = (float(g.sum()) - peak) / (n - 1)
    std = float(np.sqrt(((g - side) ** 2).mean()))
    return (peak - side) / (std + 1e-7)


def _np_kcc_psr(z, x, kernel, offset, power, sigma, lambda_) -> float:
    """Numpy KCC registration PSR of x against keyframe z."""
    h, w = z.shape
    zf = np.fft.rfft2(z)
    xf = np.fft.rfft2(x)
    tgt = np.fft.rfft2(
        np.eye(1, h * w, (h // 2) * w + w // 2, dtype=np.float64).reshape(h, w)
    )

    def kern(af, bf):
        ab = np.fft.irfft2(af * np.conj(bf), s=(h, w))
        if kernel == 0:
            k = (ab + offset) ** power
            k = k / np.abs(k).max()
        else:
            e = (2.0 / (sigma * sigma * h * w)) * ab
            k = np.exp(e - e.max())
        return np.fft.rfft2(k)

    filt = tgt / (kern(zf, zf) + lambda_)
    g = np.fft.irfft2(filt * kern(xf, zf), s=(h, w))
    return _np_psr(g)


@functools.lru_cache(maxsize=None)
def half_polar_psr_affine(
    height: int, width: int, full_d: int, c: int, kernel: int,
    offset: float, power: float, sigma: float, lambda_: float,
) -> Tuple[float, float]:
    """Per-config map ``psr_full ≈ a·psr_half + b`` of the half-polar
    rotation confidence, measured host-side in numpy on synthetic probes
    through the real polar tap table.  Multiplicative (b = 0).  numpy copy
    of ``nislam_tpu.ops.registration.half_polar_psr_affine`` (same seeded
    probes, tested equal)."""
    rng = np.random.default_rng(1234)
    d2 = full_d // 2
    idx, wgt = polar_tap_constants(height, width, full_d, c, fold_dc=True)

    def polar_map(img):
        power_t = np.fft.ifft2(np.abs(np.fft.fft2(img))).real
        taps = power_t.reshape(-1)[idx]
        return np.sum(taps * wgt, axis=-1)

    def smooth_tex():
        t = rng.standard_normal((height, width))
        ft = np.fft.rfft2(t)
        ky = np.fft.fftfreq(height)[:, None]
        kx = np.fft.rfftfreq(width)[None, :]
        ft *= np.exp(-300.0 * (ky * ky + kx * kx))
        t = np.fft.irfft2(ft, s=(height, width))
        t -= t.min()
        return t / max(t.max(), 1e-9)

    def psr_np(z, x):
        return _np_kcc_psr(z, x, kernel, offset, power, sigma, lambda_)

    hs, fs = [], []
    for _ in range(4):
        t1 = smooth_tex()
        pf1 = polar_map(t1)
        for noise in (0.02, 0.05, 0.1):
            tn = np.clip(t1 + noise * rng.standard_normal(t1.shape), 0, 1)
            pfn = polar_map(tn)
            fs.append(psr_np(pf1, pfn))
            hs.append(psr_np(pf1[:d2], pfn[:d2]))
    h = float(np.mean(hs))
    f = float(np.mean(fs))
    if h < 3.0 or f < 3.0:
        warnings.warn(
            f"half_polar_psr_affine: matched probes failed to register at "
            f"polar {full_d}x{c} (PSR {h:.1f}/{f:.1f}); falling back to "
            f"the global 1/{HALF_POLAR_PSR_SCALE} scale",
            stacklevel=2,
        )
        return 1.0 / HALF_POLAR_PSR_SCALE, 0.0
    return f / h, 0.0


def make_cf_ops(cfg) -> CFOps:
    """KCC tables for ``cfg`` (a ``CFConfig``) on the CPU; move the module
    with ``.to(device)``."""
    pidx, pw = polar_tap_constants(
        cfg.height, cfg.width, cfg.rotation_divisor, cfg.rotation_channel, fold_dc=False
    )
    pd, pc = cfg.polar_shape
    if cfg.half_polar_active:
        a, b = half_polar_psr_affine(
            cfg.height, cfg.width, cfg.rotation_divisor, cfg.rotation_channel,
            cfg.kernel, cfg.offset, cfg.power, cfg.sigma, cfg.lambda_,
        )
    else:
        a, b = 1.0, 0.0
    return CFOps(
        cfg, a, b,
        target_fft=impulse_spectrum_pair(cfg.height, cfg.width),
        target_rot_fft=impulse_spectrum_pair(pd, pc),
        polar_idx=np.ascontiguousarray(pidx[:pd]),
        polar_w=np.ascontiguousarray(pw[:pd]),
    )


def remove_zero_component(x: torch.Tensor) -> torch.Tensor:
    """DC suppression of the power transform: row 0 ← mean of rows 1 and −1,
    then column 0 ← mean of columns 1 and −1, both from the original array
    (the column rule wins at the corner)."""
    row0 = (x[..., 1, :] + x[..., -1, :]) / 2.0
    col0 = (x[..., :, 1] + x[..., :, -1]) / 2.0
    y = x.clone()
    y[..., 0, :] = row0
    y[..., :, 0] = col0
    return y


def _kernel_spectrum(xf, zf, shape: Tuple[int, int], cfg) -> torch.Tensor:
    """FFT of ``kernel(x, z)``: polynomial ``((xz + offset)^power) / max|·|``
    or gaussian ``exp(e − max e)`` with ``e = 2·xz/(σ²·N)``."""
    xz = irfft2(xf * torch.conj(zf), shape)
    if cfg.kernel == 0:
        k = (xz + cfg.offset) ** cfg.power
        k = k / torch.amax(torch.abs(k), dim=(-2, -1), keepdim=True)
    elif cfg.kernel == 1:
        n = shape[0] * shape[1]
        e = (2.0 / (cfg.sigma * cfg.sigma * n)) * xz
        k = torch.exp(e - torch.amax(e, dim=(-2, -1), keepdim=True))
    else:
        raise ValueError(f"invalid kernel type {cfg.kernel}")
    return rfft2(k)


def psr(g: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """Peak-to-sidelobe ratio: ``(peak − side_mean)/(std + 1e-7)`` with
    ``side_mean = (Σg − peak)/(N−1)`` and ``std = sqrt(mean((g − side_mean)²))``."""
    n = g.shape[-2] * g.shape[-1]
    side_mean = (torch.sum(g, dim=(-2, -1)) - peak) / (n - 1)
    sm = side_mean[..., None, None]
    std = torch.sqrt(torch.mean((g - sm) ** 2, dim=(-2, -1)))
    return (peak - side_mean) / (std + 1e-7)


def keyframe_filter(zf, target_fft, shape: Tuple[int, int], cfg) -> torch.Tensor:
    """Correlation filter ``H = target / (Kzz + λ)`` of a keyframe."""
    kzz = _kernel_spectrum(zf, zf, shape, cfg)
    return target_fft / (kzz + cfg.lambda_)


def estimate_trans(
    zf, xf, target_fft, shape: Tuple[int, int], cfg, filt=None, lanes: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One KCC registration of ``xf`` against keyframe ``zf`` → ``(trans,
    psr)``, ``trans = (−(row − H//2), −(col − W//2))`` at the response's
    column-major-first argmax.  ``filt`` skips the ``Kzz`` solve.
    ``lanes``: the leading axis holds that many independent searches, and
    each response's statistics are reduced as one search's launch would
    reduce them (:func:`~nislam_torch.ops.peak_stats.lane_blocks`); on the
    CPU each lane runs on its own (:func:`~nislam_torch.ops.fft.by_lane`)."""
    if lanes > 1 and xf.device.type == "cpu":
        return by_lane(lambda z, x, f: estimate_trans(z, x, target_fft, shape, cfg, f), lanes, zf, xf, filt)
    if filt is None:
        filt = keyframe_filter(zf, target_fft, shape, cfg)
    kxz = _kernel_spectrum(xf, zf, shape, cfg)
    g = irfft2(filt * kxz, shape)
    return registration_stats(g, shape, blocks=lane_blocks(g, lanes))[:2]


def compute_intermedium(image: torch.Tensor, ops: CFOps) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame features ``(fft, polar_fft)``: the image spectrum and the
    spectrum of the polar map of its (DC-suppressed) power transform, both
    row-major.  On a card, cuFFT returns a single (H, W) frame's spectra
    column-major (strides (1, H)); a product with them keeps that layout,
    and cuFFT transforms it back with another plan, to other bits.  Row-
    major features give a keyframe the same filters and chain whether it
    comes from a step's own front end, a chunk's, or a captured graph's
    feature buffers."""
    cfg = ops.cfg
    f = rfft2(image)
    power = irfft2(torch.abs(f), (cfg.height, cfg.width))
    pol = polar_resample(remove_zero_component(power), ops.polar_idx, ops.polar_w)
    return f.contiguous(), rfft2(pol).contiguous()


def normalize_degree(deg: torch.Tensor) -> torch.Tensor:
    """Map degrees into [-180, 180)."""
    return deg - 360.0 * torch.floor((deg + 180.0) / 360.0)


def compute_keyframe_filters(fft, polar_fft, ops: CFOps) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image filter, polar filter) of a new keyframe."""
    cfg = ops.cfg
    fi = keyframe_filter(fft, r2c(ops.target_fft), (cfg.height, cfg.width), cfg)
    fp = keyframe_filter(polar_fft, r2c(ops.target_rot_fft), cfg.polar_shape, cfg)
    return fi, fp


def estimate_rotation(last_polar_fft, cur_polar_fft, ops: CFOps, filt_polar=None, lanes: int = 1):
    """Polar-spectrum registration → (degree, rotation PSR in full-grid
    units); ``lanes`` as :func:`estimate_trans` takes it."""
    cfg = ops.cfg
    rots, info_rot = estimate_trans(
        last_polar_fft, cur_polar_fft, r2c(ops.target_rot_fft),
        cfg.polar_shape, cfg, filt=filt_polar, lanes=lanes,
    )
    degree = normalize_degree(rots[..., 0] * (2.0 / cfg.rotation_divisor) * 180.0)
    if cfg.half_polar_active:
        info_rot = ops.half_psr_a * info_rot + ops.half_psr_b
    return degree, info_rot


def _rotate_spectrum_fn(cfg):
    """``(img, deg) -> rfft2(rotate(img, deg))``: the fused shear-spectrum
    path for the fft method on even sizes, else bilinear rotate + rfft2."""
    if _fused_rotation(cfg):
        return rotate_wrap_fft_spectrum
    return lambda img, deg: rfft2(rotate_wrap(img, deg))


def _fused_rotation(cfg) -> bool:
    return cfg.rotate_method == "fft" and cfg.height % 2 == 0 and cfg.width % 2 == 0


def _pick_hypothesis(trans2, info2, degree):
    """Keep the 180° hypothesis with the higher translation PSR."""
    take_veri = info2[..., 1] > info2[..., 0]
    info_trans = torch.where(take_veri, info2[..., 1], info2[..., 0])
    trans = torch.where(take_veri[..., None], trans2[..., 1, :], trans2[..., 0, :])
    return trans, info_trans, torch.where(take_veri, degree + 180.0, degree)


def compute_pose(
    last_fft, image, last_polar_fft, cur_polar_fft, ops: CFOps, *,
    large_rotation: bool, filters=None, rotation=None, lanes: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full (x, y, θ) registration of ``image`` against a keyframe →
    ``pose = (trans_col, trans_row, θ)`` and ``info = (psr_t, psr_t, psr_r)``.

    Tracking (``large_rotation=False``) folds ``|deg| > 90`` by −180 and runs
    one translation registration.  Loop mode registers both 180°
    hypotheses and keeps the higher PSR: with the fused fft rotation the
    second is the conjugate spectrum (rot180 of a real image), otherwise
    both de-rotations run batched.  ``rotation=(degree, info_rot)`` skips
    the polar registration and reuses an :func:`estimate_rotation` result
    (the coarse-to-fine loop search's winner).  ``lanes``: the leading
    axis holds that many lanes' searches, batched (see
    :func:`estimate_trans`).
    """
    cfg = ops.cfg
    ishape = (cfg.height, cfg.width)
    filt_img, filt_polar = filters if filters is not None else (None, None)
    if rotation is not None:
        degree, info_rot = rotation
    else:
        degree, info_rot = estimate_rotation(last_polar_fft, cur_polar_fft, ops, filt_polar, lanes)
    rotate_spec = _rotate_spectrum_fn(cfg)
    target = r2c(ops.target_fft)
    if not large_rotation:
        degree = torch.where(torch.abs(degree) > 90.0, degree - 180.0, degree)
        rot_fft = by_lane(rotate_spec, lanes, image, -degree)
        trans, info_trans = estimate_trans(
            last_fft, rot_fft, target, ishape, cfg, filt=filt_img, lanes=lanes
        )
    else:
        if _fused_rotation(cfg):
            rf = by_lane(rotate_spec, lanes, image, -degree)
            rot2_fft = torch.stack([rf, torch.conj(rf)], dim=-3)
        else:
            degs = torch.stack([-degree, -degree + 180.0], dim=-1)
            rot2_fft = by_lane(rotate_spec, lanes, image[..., None, :, :], degs)
        trans2, info2 = estimate_trans(
            last_fft[..., None, :, :], rot2_fft, target, ishape, cfg,
            filt=None if filt_img is None else filt_img[..., None, :, :], lanes=lanes,
        )
        trans, info_trans, degree = _pick_hypothesis(trans2, info2, degree)
    degree = torch.where(degree > 180.0, degree - 360.0, degree)
    theta = degree * (math.pi / 180.0)
    pose = torch.stack([trans[..., 1], trans[..., 0], theta], dim=-1)
    info = torch.stack([info_trans, info_trans, info_rot], dim=-1)
    return pose, info
