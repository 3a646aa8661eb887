"""Straight-through-estimator primitives for the NAS search (counterpart of
mobilesuperresolution_tpu/ops/ste.py):

- ``rounding``: binarize channel gates at >= 0.5 with a top-k floor of
  ``least_channel`` always-on channels (ties kept: ``w >= kth``); not
  differentiable.
- ``binary_mask``: forward ``rounding(w)``, gradient identity, by the
  residual trick ``w + (round(w) - w).detach()``.
- ``condition``: hard skip-vs-keep select with identity gradients to both
  alphas.

Every decision is a tensor value, not Python control flow on the data, so a
forward never synchronises with the device.
"""

import torch


def rounding(w, least_channel=8):
    """Hard-binarize gate vector ``w`` at >= 0.5; if fewer than
    ``least_channel`` gates survive, keep the top-``least_channel`` instead
    (ties included)."""
    w = w.detach()
    hard = (w >= 0.5).to(w.dtype)
    if least_channel <= 0:
        return hard
    if w.numel() < least_channel:
        raise ValueError(
            f"gate vector has {w.numel()} channels but the channel floor "
            f"(least_channel) is {least_channel}: the supernet needs "
            f"num_residual_units >= {least_channel}"
        )
    kth = torch.topk(w.reshape(-1), least_channel).values[-1]
    floor = (w >= kth).to(w.dtype)
    return torch.where(hard.sum() >= least_channel, hard, floor)


def binary_mask(w, least_channel=8):
    """STE-binarized gates: forward = rounding(w), gradient = identity."""
    return w + (rounding(w, least_channel) - w).detach()


def mask_active_count(w, least_channel=8):
    """Number of active channels of a gate vector (a scalar tensor, no
    gradient)."""
    return rounding(w, least_channel).sum()


class _Condition(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha1, alpha2):
        keep_skip = alpha1 >= alpha2
        one, zero = torch.ones_like(alpha1), torch.zeros_like(alpha1)
        return torch.where(keep_skip, one, zero), torch.where(keep_skip, zero, one)

    @staticmethod
    def backward(ctx, g1, g2):
        return g1, g2


def condition(alpha1, alpha2):
    """(beta1, beta2) = (1, 0) if alpha1 >= alpha2 else (0, 1), with
    straight-through gradients d beta1/d alpha1 = d beta2/d alpha2 = 1."""
    return _Condition.apply(alpha1, alpha2)
