"""Procedural synthetic images, clips and the synthetic SISR and VSR
datasets (TRAIN and EVAL), made from a seed with numpy (own copy of
mobilesuperresolution_tpu/data/synthetic.py)."""

import numpy as np

from mobilesuperresolution_tpu_torch.data.imresize import imresize_np
from mobilesuperresolution_tpu_torch.data.isr import ImageSRBicubicDataset
from mobilesuperresolution_tpu_torch.data.vsr import VideoSRDataset


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


def synthetic_video(seed, t=4, hw=(96, 96), step=2, natural=False):
    """Structured uint8 (T, H, W, C) clip: a crop window translating
    diagonally by ``step`` px per frame over one synthetic image
    (``synthetic_natural_image`` when ``natural``)."""
    gen = synthetic_natural_image if natural else synthetic_image
    big = gen(seed, (hw[0] + step * t, hw[1] + step * t))
    return np.stack([big[step * i : step * i + hw[0], step * i : step * i + hw[1]] for i in range(t)])


class SyntheticISRDataset(ImageSRBicubicDataset):
    """``num_images`` ``synthetic_image`` HR images, seeds 0, 1, ...,
    textured unless ``params.synthetic_textured`` is False."""

    def __init__(self, mode, params, num_images=8, hw=(128, 128)):
        textured = bool(getattr(params, "synthetic_textured", True))
        self._images = [synthetic_image(i, hw, textured=textured) for i in range(num_images)]
        super().__init__(mode, params, [(f"synth_{i}", None) for i in range(num_images)])

    def _load(self, files, index):
        return self._images[index]


class SyntheticVSRDataset(VideoSRDataset):
    """``num_clips`` clips of ``frames`` HR frames (``hw``), a crop moving 2
    px per frame over ``synthetic_image(100 + clip)``, LR by the
    MATLAB-exact bicubic; one window per clip."""

    def __init__(self, mode, params, num_clips=2, frames=6, hw=(96, 96)):
        t = frames
        self._lr_clips, self._hr_clips = [], []
        for c in range(num_clips):
            big = synthetic_image(100 + c, (hw[0] + 4 * t, hw[1] + 4 * t))
            hrs = [big[2 * i : 2 * i + hw[0], 2 * i : 2 * i + hw[1]] for i in range(t)]
            self._hr_clips.append(hrs)
            self._lr_clips.append([imresize_np(f, scalar_scale=1.0 / params.scale) for f in hrs])
        windows = [[(f"clip{c}/frame{i}", None) for i in range(t)] for c in range(num_clips)]
        super().__init__(mode, params, windows, windows)

    def _load_item(self, index):
        return self._lr_clips[index], self._hr_clips[index]
