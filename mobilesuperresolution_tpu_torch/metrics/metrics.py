"""Evaluation metrics on NHWC tensors, numerically matching the JAX package's
mobilesuperresolution_tpu/metrics/metrics.py (which follows the reference's
recipes):

- ``psnr``: SR quantized to the 255 grid (round, clamp), border shaved, MSE
  per image over (H, W, C), ``-10·log10``; returns the **batch sum**.
- ``psnr_y``: the reference's exact path: the UN-quantized SR clamped to
  [0, 1], the difference projected to Y with [0.257, 0.504, 0.098].
- ``ssim``: SR quantized; both projected to Y with
  [65.738, 129.057, 25.064]/256; border shaved; gaussian-weighted SSIM (win
  11, sigma 1.5, K1 0.01, K2 0.03, data range 1), in the float32-stable
  centered form; per-image sum over leading axes.

The separable gaussian filter is 11 shifted multiply-adds per axis in the
input's dtype, so no convolution library (and no TF32 path) is involved.
"""

import numpy as np
import torch

_Y_WEIGHTS = (0.257, 0.504, 0.098)
_SSIM_GRAY = (65.738 / 256.0, 129.057 / 256.0, 25.064 / 256.0)


def _quantize(sr):
    return torch.clamp(torch.round(sr * 255.0), 0.0, 255.0) / 255.0


def _shave(t, shave, hw_axes=(-3, -2)):
    if not shave:
        return t
    sl = [slice(None)] * t.dim()
    for a in hw_axes:
        sl[a] = slice(shave, -shave)
    return t[tuple(sl)]


def psnr(sr, hr, shave=4):
    """Batch-summed PSNR. sr/hr: (..., H, W, C) in [0, 1]."""
    sr = torch.clamp(_quantize(sr.to(hr.dtype)), 0.0, 1.0)
    diff = _shave(sr - hr, shave)
    mse = torch.mean(diff**2, dim=(-3, -2, -1))
    return torch.sum(-10.0 * torch.log10(mse))


def psnr_y(sr, hr, shave=4):
    """Batch-summed PSNR on the Y channel of the clamped, un-quantized SR."""
    diff = torch.clamp(sr.to(hr.dtype), 0.0, 1.0) - hr
    if diff.shape[-1] == 3:
        w = torch.tensor(_Y_WEIGHTS, dtype=diff.dtype, device=diff.device)
        diff = torch.sum(diff * w, dim=-1, keepdim=True)
    diff = _shave(diff, shave)
    mse = torch.mean(diff**2, dim=(-3, -2, -1))
    return torch.sum(-10.0 * torch.log10(mse))


def _gaussian_kernel1d(sigma=1.5, radius=5):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _to_y_pair(sr, hr, shave):
    """Quantize sr, project both to the SSIM gray channel, shave borders."""
    sr = _quantize(sr.to(hr.dtype))
    w = torch.tensor(_SSIM_GRAY, dtype=hr.dtype, device=hr.device)
    x = torch.sum(sr * w, dim=-1)
    y = torch.sum(hr * w, dim=-1)
    return _shave(x, shave, (-2, -1)), _shave(y, shave, (-2, -1))


def _filter2_valid(img, kernel1d):
    """Separable 'valid' correlation over the last two axes of (..., H, W)."""
    k = [float(v) for v in kernel1d]
    n = len(k)
    h, w = img.shape[-2], img.shape[-1]
    rows = sum(k[i] * img[..., i : h - n + 1 + i, :] for i in range(n))
    return sum(k[i] * rows[..., i : w - n + 1 + i] for i in range(n))


def _ssim_map(x, y, kernel1d, k1=0.01, k2=0.03, data_range=1.0, win_size=11):
    """Float32-stable SSIM map of (..., H, W) images, algebraically the
    textbook form: images centered by one scalar per image before the second
    moments, and the luminance / structure gaps carried by the difference
    image d = x - y, so SSIM <= 1 by construction (see the JAX module's
    ``_ssim_map`` for the derivation)."""
    NP = win_size * win_size
    cov_norm = NP / (NP - 1)

    def f(t):
        return _filter2_valid(t, kernel1d)

    ux, uy = f(x), f(y)
    c = 0.5 * (x.mean(dim=(-2, -1), keepdim=True) + y.mean(dim=(-2, -1), keepdim=True))
    xc, yc = x - c, y - c
    vx = cov_norm * (f(xc * xc) - f(xc) * f(xc))
    vy = cov_norm * (f(yc * yc) - f(yc) * f(yc))
    d = x - y
    ud = f(d)
    vd = cov_norm * (f(d * d) - ud * ud)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    a1 = b1 - ud * ud
    a2 = b2 - vd
    return (a1 * a2) / (b1 * b2)


def ssim(sr, hr, shave=4):
    """Gaussian-weighted SSIM on the Y channel. sr/hr: (..., H, W, C) in
    [0, 1]; a single (H, W, C) image returns its mean SSIM, leading axes
    return the per-image SUM (the accounting of ``psnr``)."""
    x, y = _to_y_pair(sr, hr, shave)
    maps = _ssim_map(x, y, _gaussian_kernel1d())
    if sr.dim() == 3:
        return torch.mean(maps)
    return torch.sum(torch.mean(maps, dim=(-2, -1)))


def ssim_np(sr, hr, shave=4):
    """float64 numpy SSIM (host-side golden path). Batched input returns the
    per-image SUM like ``ssim``."""
    sr = np.asarray(sr, dtype=np.float64)
    hr = np.asarray(hr, dtype=np.float64)
    if sr.ndim == 4:
        return float(sum(ssim_np(s, h, shave) for s, h in zip(sr, hr)))
    sr = np.clip(np.around(sr * 255.0), 0, 255) / 255.0
    w = np.asarray(_SSIM_GRAY, dtype=np.float64)
    x = (sr * w).sum(-1)
    y = (hr * w).sum(-1)
    if shave:
        x = x[shave:-shave, shave:-shave]
        y = y[shave:-shave, shave:-shave]
    k = _gaussian_kernel1d()

    def f(img):
        img = np.apply_along_axis(lambda c: np.convolve(c, k, mode="valid"), 0, img)
        return np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, img)

    NP = 11 * 11
    cov_norm = NP / (NP - 1)
    ux, uy = f(x), f(y)
    vx = cov_norm * (f(x * x) - ux * ux)
    vy = cov_norm * (f(y * y) - uy * uy)
    vxy = cov_norm * (f(x * y) - ux * uy)
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return float(s.mean())
