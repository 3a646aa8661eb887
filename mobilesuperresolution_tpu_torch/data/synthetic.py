"""Procedural synthetic images and the synthetic SISR dataset, made from a
seed with numpy (own copy of the SISR half of
mobilesuperresolution_tpu/data/synthetic.py; the video clips and
SyntheticVSRDataset come with the VSR eval slice)."""

import numpy as np

from mobilesuperresolution_tpu_torch.data.isr import ImageSRBicubicDataset


def synthetic_image(seed, hw=(128, 128), textured=True):
    """Structured uint8 HWC image: gradients + sinusoid texture + noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f1, f2 = rng.uniform(3, 11, 2)
    img = np.stack(
        [
            127 + 90 * np.sin(yy / f1) * np.cos(xx / f2),
            127 + 110 * np.sin((xx + yy) / (f1 + f2) * 2),
            255 * xx / w,
        ],
        axis=-1,
    )
    if textured:
        img = img + rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_natural_image(seed, hw=(128, 128)):
    """Noise-FREE 'natural-structure' uint8 image: random anti-aliased shapes
    (sharp edges), thin lines, an oriented grating, smooth gradients. All
    high-frequency content is STRUCTURED — recoverable from LR context by a
    trained SR model — unlike ``synthetic_image``'s per-pixel Gaussian noise,
    whose irreducible L1 floor (~0.8·sigma ≈ 0.037 at sigma=12/255) caps any
    trained model AT bicubic quality (measured: +0.05 dB after full
    convergence). The convergence artifacts train/eval on these."""
    rng = np.random.default_rng(seed)
    h, w = hw
    hh2, ww2 = 2 * h, 2 * w  # render at 2x, box-filter down: anti-aliased edges
    yy, xx = np.mgrid[0:hh2, 0:ww2].astype(np.float64)
    gx, gy = rng.uniform(-1, 1, 2)
    img = np.empty((hh2, ww2, 3))
    img[:] = (110 + 60 * (gx * xx / ww2 + gy * yy / hh2))[..., None]
    f = rng.uniform(6, 18)
    th = rng.uniform(0, np.pi)
    grating = 35 * np.sin((np.cos(th) * xx + np.sin(th) * yy) * (2 * np.pi / f))
    img += grating[..., None] * rng.uniform(0.2, 0.9, 3)
    for _ in range(int(rng.integers(14, 26))):
        kind = int(rng.integers(3))
        color = rng.uniform(10, 245, 3)
        cy, cx = rng.uniform(0, hh2), rng.uniform(0, ww2)
        ang = rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        if kind == 0:  # rotated rectangle
            v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
            m = (np.abs(u) < rng.uniform(8, ww2 / 5)) & (
                np.abs(v) < rng.uniform(8, hh2 / 5)
            )
        elif kind == 1:  # circle
            r = rng.uniform(6, min(hh2, ww2) / 6)
            m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        else:  # thin bar (2x-res width 3-8 → 1.5-4 px sharp line)
            m = np.abs(u) < rng.uniform(3, 8)
        alpha = rng.uniform(0.65, 1.0)
        img = np.where(m[..., None], (1 - alpha) * img + alpha * color, img)
    img = img.reshape(h, 2, w, 2, 3).mean(axis=(1, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


class SyntheticISRDataset(ImageSRBicubicDataset):
    """``num_images`` textured ``synthetic_image`` HR images, seeds 0, 1, ..."""

    def __init__(self, mode, params, num_images=8, hw=(128, 128)):
        self._images = [synthetic_image(i, hw) for i in range(num_images)]
        super().__init__(mode, params, [(f"synth_{i}", None) for i in range(num_images)])

    def _load(self, files, index):
        return self._images[index]
