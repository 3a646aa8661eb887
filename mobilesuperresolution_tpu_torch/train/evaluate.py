"""Shared eval harness, image and video branches, with the reference's
accounting (counterpart of mobilesuperresolution_tpu/train/evaluate.py):

- video (5-D output): shave 4 for psnr/psnr_y, SSIM and the bilinear
  baseline (align_corners=False); the count advances by T per clip; per-frame
  SR / bilinear / HR PNG dumps.
- image (4-D output): psnr shave scale+6, psnr_y and ssim shave scale; the
  bilinear baseline uses align_corners=True with shave scale+6; the count
  advances by batch.
- every metric returns a batch sum; the harness divides by the total at the
  end.

Metrics run on the device of the model's output.
"""

import os
from dataclasses import dataclass

import torch

from mobilesuperresolution_tpu_torch.data.io_cache import save_png
from mobilesuperresolution_tpu_torch.metrics import psnr, psnr_y, ssim, ssim_np
from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear
from mobilesuperresolution_tpu_torch.train.losses import charbonnier_loss


@dataclass
class EvalResult:
    psnr: float = 0.0
    psnr_y: float = 0.0
    ssim: float = 0.0
    bilinear_psnr: float = 0.0
    bilinear_ssim: float = 0.0
    loss: float = 0.0
    total: int = 0

    def as_dict(self):
        t = max(self.total, 1)
        return {
            "PSNR": self.psnr / t,
            "PSNR_Y": self.psnr_y / t,
            "SSIM": self.ssim / t,
            "bilinear_PSNR": self.bilinear_psnr / t,
            "bilinear_SSIM": self.bilinear_ssim / t,
            "loss": self.loss / t,
        }


def _np(t):
    return t.detach().float().cpu().numpy()


def evaluate(forward_fn, eval_batches, scale, job_dir=None, eval_data_name="eval", save=False,
             ssim_on_host=False, device=None):
    """forward_fn(lr, out_h, out_w) -> sr (NHWC or NTHWC float in [0, 1]).

    eval_batches yields (name, lr, hr), numpy arrays or tensors, with lr
    (B, H, W, C) or (B, T, H, W, C); both move to ``device`` (default: where
    they are; numpy lands on the CPU). SSIM runs on that device in float32;
    ``ssim_on_host=True`` takes the float64 numpy golden path instead."""
    res = EvalResult()

    def _ssim_sum(a, b, shave):
        if ssim_on_host:
            a, b = _np(a), _np(b)
            a, b = a.reshape((-1,) + a.shape[-3:]), b.reshape((-1,) + b.shape[-3:])
            return float(sum(ssim_np(ai, bi, shave=shave) for ai, bi in zip(a, b)))
        return float(ssim(a, b, shave=shave))

    for name, lr_in, hr in eval_batches:
        lr_in = torch.as_tensor(lr_in, device=device)
        hr = torch.as_tensor(hr, device=device)
        is_video = hr.dim() == 5
        out_h, out_w = hr.shape[-3], hr.shape[-2]
        sr = forward_fn(lr_in, out_h, out_w)
        if isinstance(sr, tuple):  # NAS models return (sr, speed)
            sr = sr[0]
        sr = sr.float()

        if is_video:
            b, t = hr.shape[:2]
            res.total += int(t) * int(b)
            baseline = resize_bilinear(lr_in, (out_h, out_w), align_corners=False)[..., :3]
            res.bilinear_psnr += float(psnr(baseline, hr, shave=4))
            res.psnr_y += float(psnr_y(sr, hr, shave=4))
            res.psnr += float(psnr(sr, hr, shave=4))
            res.loss += float(charbonnier_loss(sr, hr)) * t * b
            res.ssim += _ssim_sum(sr, hr, shave=4)
            res.bilinear_ssim += _ssim_sum(baseline, hr, shave=4)
            if save and job_dir is not None:
                for i in range(t):
                    base = f"{name}{i:03d}.png"
                    save_png(os.path.join(job_dir, "eval", eval_data_name, base), _np(sr[0, i]))
                    save_png(os.path.join(job_dir, "eval", "bilinear", base), _np(baseline[0, i]))
                    save_png(os.path.join(job_dir, "eval", "hr", base), _np(hr[0, i]))
        else:
            b = hr.shape[0]
            res.total += int(b)
            res.loss += float(charbonnier_loss(sr, hr)) * b
            baseline = resize_bilinear(lr_in, (out_h, out_w), align_corners=True)[..., :3]
            res.psnr += float(psnr(sr, hr, shave=scale + 6))
            res.psnr_y += float(psnr_y(sr, hr, shave=scale))
            res.bilinear_psnr += float(psnr(baseline, hr, shave=scale + 6))
            res.ssim += _ssim_sum(sr, hr, shave=scale)
            res.bilinear_ssim += _ssim_sum(baseline, hr, shave=scale)
            if save and job_dir is not None:
                save_png(os.path.join(job_dir, "eval", eval_data_name, f"{name}.png"), _np(sr[0]))
    return res

