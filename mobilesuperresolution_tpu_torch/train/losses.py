"""Training losses (counterpart of mobilesuperresolution_tpu/train/losses.py)."""

import torch


def l1_loss(sr, hr):
    return torch.mean(torch.abs(sr - hr))


def charbonnier_loss(sr, hr, eps=1e-12):
    """mean(sqrt(diff² + eps)): the reference puts eps inside the sqrt,
    un-squared."""
    diff = sr - hr
    return torch.mean(torch.sqrt(diff * diff + eps))
