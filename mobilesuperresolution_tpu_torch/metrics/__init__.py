"""Evaluation metrics (counterpart of mobilesuperresolution_tpu/metrics)."""

from mobilesuperresolution_tpu_torch.metrics.metrics import psnr, psnr_y, ssim, ssim_np

__all__ = ["psnr", "psnr_y", "ssim", "ssim_np"]
