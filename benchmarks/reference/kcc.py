"""Plain Kernel Cross-Correlator registration: the reference's front end.

A frozen, single-lane copy of the arithmetic that NI-SLAM's tracker
performs on a frame: the image spectrum and the spectrum of the polar map
of its (DC-suppressed) power transform; a keyframe's correlation filter;
one closed-form registration (the response's first maximum in
column-major order and its peak-to-sidelobe ratio); the rotation from the
polar spectra, the de-rotation as three Fourier shears and the
translation, with the 180-degree hypothesis test of loop mode.

Plain ``torch`` operations in float32 (``torch.fft`` for every
transform); nothing of the program under test.  ``Precision.q`` rounds
each stage's output: the identity for the reference, bfloat16 for the
control that the comparison must fail.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch


class Precision:
    """Where a stage's result is rounded.  ``f32``: nowhere (the reference);
    ``bf16``: every image, spectrum, filter and response rounded to
    bfloat16 as it is made (the control one step below float32)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16"):
            raise ValueError(f"precision {name!r} is not f32 or bf16")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        if torch.is_complex(x):
            r = torch.view_as_real(x).to(torch.bfloat16).float()
            return torch.view_as_complex(r.contiguous())
        return x.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# Transforms (numpy's conventions: 1/N on the inverse, half spectrum last)


def rfft2(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfft2(x.float())


def irfft2(xf: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    return torch.fft.irfft2(xf, s=tuple(shape))


def _project_edges(xf: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Zero the imaginary part of the DC (and even-n Nyquist) bins along
    ``dim``, which a c2r transform ignores."""
    im = xf.imag.clone()
    im.select(dim, 0).zero_()
    if n % 2 == 0:
        im.select(dim, n // 2).zero_()
    return torch.complex(xf.real, im)


def impulse_spectrum(h: int, w: int, device) -> torch.Tensor:
    """Half spectrum of a unit impulse at (h//2, w//2): the KCC target."""
    ky = np.arange(h)
    kx = np.arange(w // 2 + 1)
    phase = -2.0 * math.pi * (ky[:, None] * ((h // 2) / h) + kx[None, :] * ((w // 2) / w))
    pair = np.stack([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)
    return torch.view_as_complex(torch.from_numpy(pair).to(device))


def spectral_crop(xf: torch.Tensor, shape: Tuple[int, int], scale: int) -> torch.Tensor:
    """Spectrum of the sinc-downsampled image at (H/s, W/s), scaled by
    1/s² (the coarse Nyquist row and column zeroed)."""
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


# ---------------------------------------------------------------------------
# The polar map of the power transform


def polar_taps(h: int, w: int, divisor: int, channel: int) -> Tuple[np.ndarray, np.ndarray]:
    """``cv::warpPolar``'s bilinear sampling of the fftshifted power
    (zero outside the frame) as a table of 4 taps per output cell: flat
    indices into the UNSHIFTED power and their weights."""
    cx, cy = w / 2.0, h / 2.0
    max_radius = float(min(h // 2, w // 2))
    phi = np.arange(divisor, dtype=np.float32)[:, None]
    rho = np.arange(channel, dtype=np.float32)[None, :]
    angle = phi * (2.0 * math.pi / divisor)
    mag = rho * (max_radius / channel)
    gx = (cx + mag * np.cos(angle)).astype(np.float32)
    gy = (cy + mag * np.sin(angle)).astype(np.float32)
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    wx = (gx - x0).astype(np.float64)
    wy = (gy - y0).astype(np.float64)
    idx = np.zeros((divisor, channel, 4), np.int64)
    wgt = np.zeros((divisor, channel, 4), np.float64)
    slot = np.zeros((divisor, channel), np.int64)
    for yi, xi, weight in ((y0, x0, (1.0 - wx) * (1.0 - wy)), (y0, x0 + 1, wx * (1.0 - wy)),
                           (y0 + 1, x0, (1.0 - wx) * wy), (y0 + 1, x0 + 1, wx * wy)):
        use = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & (weight > 0)
        oy = np.mod(yi - h // 2, h)
        ox = np.mod(xi - w // 2, w)
        ii, jj = np.nonzero(use)
        s = slot[ii, jj]
        idx[ii, jj, s] = oy[ii, jj] * w + ox[ii, jj]
        wgt[ii, jj, s] = weight[ii, jj]
        slot[ii, jj] = s + 1
    return idx.astype(np.int32), wgt.astype(np.float32)


def remove_zero_component(x: torch.Tensor) -> torch.Tensor:
    """Row 0 ← mean of rows 1 and −1, then column 0 ← mean of columns 1
    and −1, both from the original array."""
    row0 = (x[..., 1, :] + x[..., -1, :]) / 2.0
    col0 = (x[..., :, 1] + x[..., :, -1]) / 2.0
    y = x.clone()
    y[..., 0, :] = row0
    y[..., :, 0] = col0
    return y


# ---------------------------------------------------------------------------
# One registration


def kernel_spectrum(xf, zf, shape, cf: dict, p: Precision) -> torch.Tensor:
    """FFT of the polynomial (or Gaussian) kernel of x and z."""
    xz = p.q(irfft2(xf * torch.conj(zf), shape))
    if cf["kernel"] == 0:
        k = (xz + cf["offset"]) ** cf["power"]
        k = k / torch.amax(torch.abs(k), dim=(-2, -1), keepdim=True)
    elif cf["kernel"] == 1:
        e = (2.0 / (cf["sigma"] * cf["sigma"] * shape[0] * shape[1])) * xz
        k = torch.exp(e - torch.amax(e, dim=(-2, -1), keepdim=True))
    else:
        raise ValueError(f"invalid kernel type {cf['kernel']}")
    return p.q(rfft2(p.q(k)))


def keyframe_filter(zf, target, shape, cf: dict, p: Precision) -> torch.Tensor:
    """H = target / (Kzz + λ)."""
    return p.q(target / (kernel_spectrum(zf, zf, shape, cf, p) + cf["lambda_"]))


def response_stats(g: torch.Tensor, shape: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(trans, psr)`` of responses ``g`` (..., H, W): the first maximum
    in column-major order, ``trans = (−(row − H//2), −(col − W//2))``,
    and the PSR from the moments Σg and Σg²."""
    h, w = shape
    lead = g.shape[:-2]
    flat = g.reshape(*lead, h * w)
    idx_cm = torch.argmax(g.transpose(-2, -1).reshape(*lead, h * w), dim=-1)
    idx = (idx_cm % h) * w + idx_cm // h
    peak = torch.take_along_dim(flat, idx[..., None], dim=-1)[..., 0]
    s = flat.sum(-1)
    ss = (flat * flat).sum(-1)
    n = h * w
    side = (s - peak) / (n - 1)
    var = ss / n - 2.0 * side * s / n + side * side
    psr = (peak - side) / (torch.sqrt(torch.clamp(var, min=0.0)) + 1e-7)
    row = torch.div(idx, w, rounding_mode="floor").float()
    col = torch.remainder(idx, w).float()
    return torch.stack([-(row - h // 2), -(col - w // 2)], dim=-1), psr


def register(zf, xf, target, shape, cf: dict, p: Precision, filt=None):
    """One KCC registration of ``xf`` against keyframe ``zf`` → (trans, psr)."""
    if filt is None:
        filt = keyframe_filter(zf, target, shape, cf, p)
    g = p.q(irfft2(filt * kernel_spectrum(xf, zf, shape, cf, p), shape))
    return response_stats(g, shape)


# ---------------------------------------------------------------------------
# The half-polar rotation confidence's calibration (host numpy)


def _np_psr(g: np.ndarray) -> float:
    n = g.size
    peak = float(g.max())
    side = (float(g.sum()) - peak) / (n - 1)
    std = float(np.sqrt(((g - side) ** 2).mean()))
    return (peak - side) / (std + 1e-7)


def _np_kcc_psr(z, x, cf: dict) -> float:
    h, w = z.shape
    zf, xf = np.fft.rfft2(z), np.fft.rfft2(x)
    tgt = np.fft.rfft2(np.eye(1, h * w, (h // 2) * w + w // 2, dtype=np.float64).reshape(h, w))

    def kern(af, bf):
        ab = np.fft.irfft2(af * np.conj(bf), s=(h, w))
        if cf["kernel"] == 0:
            k = (ab + cf["offset"]) ** cf["power"]
            k = k / np.abs(k).max()
        else:
            e = (2.0 / (cf["sigma"] * cf["sigma"] * h * w)) * ab
            k = np.exp(e - e.max())
        return np.fft.rfft2(k)

    filt = tgt / (kern(zf, zf) + cf["lambda_"])
    return _np_psr(np.fft.irfft2(filt * kern(xf, zf), s=(h, w)))


def half_polar_scale(cf: dict) -> float:
    """The factor that maps the PSR of a half-polar rotation registration
    to the full grid's, measured on seeded synthetic probes through the
    polar table (1/0.84 where the probes fail to register)."""
    height, width, full_d, c = cf["height"], cf["width"], cf["rotation_divisor"], cf["rotation_channel"]
    rng = np.random.default_rng(1234)
    d2 = full_d // 2
    # The table with the DC suppression folded in: the same map as
    # remove_zero_component followed by the 4 taps.
    idx, wgt = polar_taps(height, width, full_d, c)

    def polar_map(img):
        power = np.fft.ifft2(np.abs(np.fft.fft2(img))).real
        power = power.copy()
        row0 = (power[1, :] + power[-1, :]) / 2.0
        col0 = (power[:, 1] + power[:, -1]) / 2.0
        power[0, :] = row0
        power[:, 0] = col0
        return np.sum(power.reshape(-1)[idx] * wgt, axis=-1)

    def smooth_tex():
        t = rng.standard_normal((height, width))
        ft = np.fft.rfft2(t)
        ky = np.fft.fftfreq(height)[:, None]
        kx = np.fft.rfftfreq(width)[None, :]
        ft *= np.exp(-300.0 * (ky * ky + kx * kx))
        t = np.fft.irfft2(ft, s=(height, width))
        t -= t.min()
        return t / max(t.max(), 1e-9)

    hs, fs = [], []
    for _ in range(4):
        t1 = smooth_tex()
        pf1 = polar_map(t1)
        for noise in (0.02, 0.05, 0.1):
            pfn = polar_map(np.clip(t1 + noise * rng.standard_normal(t1.shape), 0, 1))
            fs.append(_np_kcc_psr(pf1, pfn, cf))
            hs.append(_np_kcc_psr(pf1[:d2], pfn[:d2], cf))
    h, f = float(np.mean(hs)), float(np.mean(fs))
    if h < 3.0 or f < 3.0:
        warnings.warn("half-polar probes failed to register; using the 1/0.84 scale", stacklevel=2)
        return 1.0 / 0.84
    return f / h


# ---------------------------------------------------------------------------
# Rotation by Fourier shears


def _cis(theta: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(theta), torch.sin(theta))


def _shear_x_spectrum(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    f = torch.fft.rfft(img.float(), dim=-1)
    kx = torch.arange(w // 2 + 1, dtype=torch.float32, device=img.device)
    y = torch.arange(h, dtype=torch.float32, device=img.device) - h / 2.0
    d = s[..., None] * y
    return f * _cis((2.0 * math.pi / w) * d[..., :, None] * kx)


def _shear_x(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.fft.irfft(_project_edges(_shear_x_spectrum(img, s), img.shape[-1], -1), n=img.shape[-1], dim=-1)


def _shear_y(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    f = torch.fft.rfft(img.float(), dim=-2)
    ky = torch.arange(h // 2 + 1, dtype=torch.float32, device=img.device)
    x = torch.arange(w, dtype=torch.float32, device=img.device) - w / 2.0
    d = s[..., None] * x
    g = f * _cis((2.0 * math.pi / h) * ky[:, None] * d[..., None, :])
    return torch.fft.irfft(_project_edges(g, h, -2), n=h, dim=-2)


def _rot180(img: torch.Tensor) -> torch.Tensor:
    return torch.roll(torch.flip(img, dims=(-2, -1)), shifts=(1, 1), dims=(-2, -1))


def rotated_spectrum(img: torch.Tensor, degree: torch.Tensor, p: Precision) -> torch.Tensor:
    """``rfft2`` of ``img`` rotated by ``degree`` about its centre with
    periodic wrap: fold into (−90, 90] with an exact 180° flip, then
    R(θ) = Sx(−tan θ/2)·Sy(sin θ)·Sx(−tan θ/2) as Fourier shears."""
    h, w = img.shape[-2], img.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"the Fourier rotation takes even sizes, got {h}x{w}")
    deg = torch.as_tensor(degree, dtype=torch.float32, device=img.device)
    d = deg - 360.0 * torch.floor((deg + 180.0) / 360.0)
    flip = torch.abs(d) > 90.0
    d = torch.where(flip, d - torch.sign(d) * 180.0, d)
    img = torch.where(flip[..., None, None], _rot180(img), img)
    rad = d * (math.pi / 180.0)
    a, b = -torch.tan(rad / 2.0), torch.sin(rad)
    g = _shear_x_spectrum(p.q(_shear_y(p.q(_shear_x(img, a)), b)), a)
    im = g.imag.clone()
    im[..., 0] = 0.0
    im[..., -1] = 0.0
    return p.q(torch.fft.fft(torch.complex(g.real, im), dim=-2))


# ---------------------------------------------------------------------------
# The tracker's registration of a frame against a keyframe


class KCC:
    """The KCC tables of one configuration's ``cf`` block on a device."""

    def __init__(self, cf: dict, device, precision: Precision):
        self.cf = cf
        self.p = precision
        h, w, d, c = cf["height"], cf["width"], cf["rotation_divisor"], cf["rotation_channel"]
        self.half = cf.get("half_polar", True) and d % 2 == 0
        self.ishape = (h, w)
        self.pshape = (d // 2 if self.half else d, c)
        idx, wgt = polar_taps(h, w, d, c)
        self.polar_idx = torch.from_numpy(np.ascontiguousarray(idx[: self.pshape[0]])).to(device)
        self.polar_w = torch.from_numpy(np.ascontiguousarray(wgt[: self.pshape[0]])).to(device)
        self.target = impulse_spectrum(h, w, device)
        self.target_rot = impulse_spectrum(*self.pshape, device)
        self.rot_scale = half_polar_scale(cf) if self.half else 1.0

    def features(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image spectrum, polar spectrum) of (..., H, W) frames."""
        q = self.p.q
        f = q(rfft2(q(image)))
        power = q(irfft2(torch.abs(f), self.ishape))
        flat = remove_zero_component(power).reshape(*power.shape[:-2], -1)
        taps = flat.index_select(-1, self.polar_idx.reshape(-1).long()).reshape(
            flat.shape[:-1] + self.polar_idx.shape)
        pol = q(torch.sum(taps * self.polar_w, dim=-1))
        return f, q(rfft2(pol))

    def filters(self, fft, polar) -> Tuple[torch.Tensor, torch.Tensor]:
        return (keyframe_filter(fft, self.target, self.ishape, self.cf, self.p),
                keyframe_filter(polar, self.target_rot, self.pshape, self.cf, self.p))

    def rotation(self, kf_polar, cur_polar, filt_polar=None):
        """(degree, rotation PSR in full-grid units)."""
        rots, info = register(kf_polar, cur_polar, self.target_rot, self.pshape, self.cf, self.p, filt_polar)
        deg = rots[..., 0] * (2.0 / self.cf["rotation_divisor"]) * 180.0
        deg = deg - 360.0 * torch.floor((deg + 180.0) / 360.0)
        return deg, (self.rot_scale * info if self.half else info)

    def pose(self, kf_fft, image, kf_polar, cur_polar, *, large_rotation: bool,
             filters: Optional[tuple] = None, rotation: Optional[tuple] = None):
        """(x, y, θ) of ``image`` against a keyframe → (pose, (psr_t, psr_t, psr_r))."""
        filt_img, filt_pol = filters if filters is not None else (None, None)
        degree, info_rot = rotation if rotation is not None else self.rotation(kf_polar, cur_polar, filt_pol)
        if not large_rotation:
            degree = torch.where(torch.abs(degree) > 90.0, degree - 180.0, degree)
            trans, info_t = register(kf_fft, rotated_spectrum(image, -degree, self.p), self.target,
                                     self.ishape, self.cf, self.p, filt_img)
        else:
            rf = rotated_spectrum(image, -degree, self.p)
            both = torch.stack([rf, torch.conj(rf)], dim=-3)
            trans2, info2 = register(kf_fft[..., None, :, :], both, self.target, self.ishape, self.cf, self.p,
                                     None if filt_img is None else filt_img[..., None, :, :])
            veri = info2[..., 1] > info2[..., 0]
            info_t = torch.where(veri, info2[..., 1], info2[..., 0])
            trans = torch.where(veri[..., None], trans2[..., 1, :], trans2[..., 0, :])
            degree = torch.where(veri, degree + 180.0, degree)
        degree = torch.where(degree > 180.0, degree - 360.0, degree)
        pose = torch.stack([trans[..., 1], trans[..., 0], degree * (math.pi / 180.0)], dim=-1)
        return pose, torch.stack([info_t, info_t, info_rot], dim=-1)
