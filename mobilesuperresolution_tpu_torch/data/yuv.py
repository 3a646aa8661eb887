"""YUV420 planar → RGB for the NEMO raw-frame pipeline (own copy of
mobilesuperresolution_tpu/data/yuv.py, numpy only).

The reference's recipe (datasets/yuv420_to_bgr.py): cv2.resize the chroma
planes 2x (INTER_LINEAR), merge (y, v, u) as YCrCb, cv2.COLOR_YCrCb2BGR.
Reproduced bit-exactly in integer numpy:
- the chroma upsample replicates cv2's fixed-point bilinear (coefficient
  scale 2048, its SIMD rounding: per term (b·(S>>4))>>16, then (+2)>>2);
- the colour conversion replicates cvtColor's 14-bit fixed point
  (Cr·22987, Cr·-11698 + Cb·-5636, Cb·29049, rounded (x + 2^13) >> 14).
Frames are stored in RGB order (the reference's BGR rawfiles are flipped on
read, data/nemo.py ``--raw_order bgr``).
"""

import os

import numpy as np


def _up2_cv2_linear(src, out_h, out_w):
    """cv2.resize(src, (out_w, out_h), INTER_LINEAR) for the exact-2x uint8
    case, in cv2's own fixed-point arithmetic."""
    s = src.astype(np.int64)
    sh, sw = src.shape
    kidx = np.arange(out_w)
    k = kidx // 2
    left = np.where(kidx % 2 == 0, np.clip(k - 1, 0, sw - 1), k)
    right = np.where(kidx % 2 == 0, k, np.clip(k + 1, 0, sw - 1))
    wl = np.where(kidx % 2 == 0, 512, 1536)
    rowpass = s[:, left] * wl + s[:, right] * (2048 - wl)  # scale 2048
    ridx = np.arange(out_h)
    r = ridx // 2
    top = np.where(ridx % 2 == 0, np.clip(r - 1, 0, sh - 1), r)
    bot = np.where(ridx % 2 == 0, r, np.clip(r + 1, 0, sh - 1))
    wt = np.where(ridx % 2 == 0, 512, 1536)[:, None]
    t = ((wt * (rowpass[top, :] >> 4)) >> 16) + (((2048 - wt) * (rowpass[bot, :] >> 4)) >> 16)
    return np.clip((t + 2) >> 2, 0, 255)


def yuv420_to_rgb(y, u, v):
    """y: (H, W) uint8; u, v: (H/2, W/2) uint8 → (H, W, 3) uint8 RGB, equal
    to the reference's cv2 pipeline (u = Cb, v = Cr)."""
    h, w = y.shape
    cb = _up2_cv2_linear(u, h, w) - 128
    cr = _up2_cv2_linear(v, h, w) - 128
    yf = y.astype(np.int64)

    def _fx(x):
        return (x + (1 << 13)) >> 14

    r = yf + _fx(22987 * cr)
    g = yf + _fx(-11698 * cr - 5636 * cb)
    b = yf + _fx(29049 * cb)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def convert_yuv_dir(src_dir, dst_dir, hw):
    """Convert per-frame ``.y`` / ``.u`` / ``.v`` planar files of (H, W) =
    ``hw`` frames into interleaved RGB ``.raw`` files (the reference's
    converter). Returns the number of frames."""
    h, w = hw
    os.makedirs(dst_dir, exist_ok=True)
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(src_dir) if f.endswith(".y"))
    for name in names:
        y = np.fromfile(os.path.join(src_dir, name + ".y"), np.uint8).reshape(h, w)
        u = np.fromfile(os.path.join(src_dir, name + ".u"), np.uint8).reshape(h // 2, w // 2)
        v = np.fromfile(os.path.join(src_dir, name + ".v"), np.uint8).reshape(h // 2, w // 2)
        yuv420_to_rgb(y, u, v).tofile(os.path.join(dst_dir, name + ".raw"))
    return len(names)
