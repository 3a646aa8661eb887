"""Latency estimation for the NAS search (counterpart of
mobilesuperresolution_tpu/nas/speed_estimator.py).

The default is the reference's analytic model

    speed(block) = sum_k (ch_split + 0.2 * ch_mask) * k^2 * alpha_k / 40   [ms]

computed without gradient, so gradients reach the alphas only through the
block-skip beta2; ``differentiable=True`` uses STE channel counts and live
alphas instead. Channel counts round with least_channel=8, the split gate's
too (its forward uses 0): the reference's asymmetry, kept for parity.

A measured table, ``(N, 4)`` rows ``[ch_in, ch_split, kernel, ms]``
(a ``.npy``), replaces the analytic model after ``densify_speed_table``.
"""

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.ops.ste import binary_mask, rounding

KERNEL_CHOICES = (3, 5, 7)


def analytic_block_speed(ch_mask, ch_split, kernel):
    """(ch_split + 0.2*ch_mask) * k^2 / 40."""
    return (ch_split + 0.2 * ch_mask) * (kernel * kernel) / 40.0


def block_speed_from_gates(mask_w, split_w, alpha, differentiable=False, speed_table=None):
    """Per-block latency estimate from the gate parameters (scalar tensor, ms).

    speed_table: optional dense (3, C+1, C+1) tensor of measured latencies
    indexed [kernel_idx, ch_split, ch_mask] (``densify_speed_table``); the
    channel counts index it without gradient, and with
    ``differentiable=True`` the alphas stay live either way."""
    if differentiable:
        ch0 = binary_mask(mask_w, least_channel=8).sum()
        ch1 = binary_mask(split_w, least_channel=8).sum()
        a = alpha
    else:
        ch0 = rounding(mask_w, 8).sum()
        ch1 = rounding(split_w, 8).sum()
        a = alpha.detach()
    if speed_table is not None:
        speeds = speed_table[:, ch1.detach().long(), ch0.detach().long()]  # (3,)
    else:
        ks = torch.tensor(KERNEL_CHOICES, dtype=torch.float32, device=alpha.device)
        speeds = analytic_block_speed(ch0, ch1, ks)  # (3,)
    out = torch.sum(speeds * a)
    return out if differentiable else out.detach()


def densify_speed_table(rows, max_ch, method="linear"):
    """(N, 4) measured rows [ch_in, ch_split, kernel, ms] → dense
    (3, max_ch+1, max_ch+1) float32 table [kernel_idx, ch_split, ch_mask].

    method="linear": separable linear interpolation over the measured
    (ch_mask, ch_split) grid, clamped to its edges, so the traced latency
    varies continuously with the channel counts. method="nearest": the
    nearest measured config."""
    if method == "nearest":
        est = TableSpeedEstimator(rows)
        table = np.zeros((len(KERNEL_CHOICES), max_ch + 1, max_ch + 1), np.float32)
        for ki, k in enumerate(KERNEL_CHOICES):
            for ch1 in range(max_ch + 1):
                for ch0 in range(max_ch + 1):
                    table[ki, ch1, ch0] = est(ch0, ch1, k)
        return table
    if method != "linear":
        raise ValueError(f"unknown densify method {method!r}")

    rows = np.asarray(rows, dtype=np.float32)
    if rows.ndim != 2 or rows.shape[1] != 4:
        raise ValueError("expected (N, 4) latency table")
    table = np.zeros((len(KERNEL_CHOICES), max_ch + 1, max_ch + 1), np.float32)
    splits_axis = np.arange(max_ch + 1, dtype=np.float32)
    for ki, k in enumerate(KERNEL_CHOICES):
        rk = rows[rows[:, 2] == k]
        if len(rk) == 0:
            raise ValueError(f"no measured rows for kernel {k}")
        # per measured ch_in: a dense latency line over ch_split (1-D interp,
        # edge-clamped; repeated splits averaged)
        lines = {}
        for c in np.unique(rk[:, 0]):
            rc = rk[rk[:, 0] == c]
            order = np.argsort(rc[:, 1], kind="stable")
            s, v = rc[order, 1], rc[order, 3]
            su, inv = np.unique(s, return_inverse=True)
            vu = np.zeros_like(su)
            np.add.at(vu, inv, v)
            vu /= np.bincount(inv).astype(vu.dtype)
            lines[float(c)] = np.interp(splits_axis, su, vu)
        # linear blend between the two measured ch_in lines bracketing ch0
        cs = np.asarray(sorted(lines))
        for ch0 in range(max_ch + 1):
            j = int(np.searchsorted(cs, ch0))
            if j == 0:
                table[ki, :, ch0] = lines[float(cs[0])]
            elif j >= len(cs):
                table[ki, :, ch0] = lines[float(cs[-1])]
            else:
                lo, hi = float(cs[j - 1]), float(cs[j])
                w = (ch0 - lo) / (hi - lo)
                table[ki, :, ch0] = (1.0 - w) * lines[lo] + w * lines[hi]
    return table


def get_ori_speed(num_blocks=4, num_residual_units=12):
    """Supernet baseline speed: num_blocks x the analytic block speed at k=7
    with every channel active."""
    return float(num_blocks * analytic_block_speed(num_residual_units, num_residual_units, 7))


class TableSpeedEstimator:
    """Nearest-config lookup over measured (ch_in, ch_split, kernel,
    latency_ms) rows."""

    def __init__(self, rows):
        rows = np.asarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != 4:
            raise ValueError("expected (N, 4) latency table")
        self.configs = rows[:, :3]
        self.latencies = rows[:, 3]

    def __call__(self, ch_mask, ch_split, kernel):
        q = np.asarray([ch_mask, ch_split, kernel], dtype=np.float32)
        d = np.sum((self.configs - q) ** 2, axis=1)
        return float(self.latencies[np.argmin(d)])
