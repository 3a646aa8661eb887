"""Latency loss (counterpart of mobilesuperresolution_tpu/nas/speed_loss.py)."""

import torch


class SpeedLoss:
    """loss = reduce((speed - target)/scale) * gamma with 'clamp' (penalize
    only being slower than target), 'mse', or 'abs' reduction."""

    def __init__(self, scale=1.0):
        self.scale = float(scale)

    def __call__(self, speed, target, gamma=0.01, method="clamp"):
        if method not in ("mse", "clamp", "abs"):
            raise ValueError(f"unknown SpeedLoss method {method!r}")
        diff = (speed - target) / self.scale
        if method == "clamp":
            loss = torch.clamp_min(diff, 0.0)
        elif method == "mse":
            loss = diff**2
        else:
            loss = torch.abs(diff)
        return torch.mean(loss) * gamma
