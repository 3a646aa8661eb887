"""NAS supernet: searchable WDSR-B, depth / width / kernel-size search
(counterpart of mobilesuperresolution_tpu/models/wdsr_nas.py).

Per block (the reference's Split_Block.forward_body):
  x1 = split_gate * x ; x2 = x - x1
  x3 = x2 + sum_k softmax(alpha)_k * ReLU(ConvSep_k(x1)) + x1   (k in {3, 5, 7})
  out = beta1 * x + beta2 * (x2 + split_gate * x3)
with ConvSep = depthwise kxk WN-conv → ReLU → 1x1 WN-conv, one launch of
kernel B5 (kernels/fused_convsep.py) through its autograd Function, and the
trailing ReLU applied before the softmax weight. Every block is computed
even when beta2 = 0 (masked arithmetic, as in JAX): alpha2's gradient needs
it. The latency estimate accumulates through the forward as a float32
scalar tensor.

Parameters keep the flax names and layouts (``mask_w``, ``head``,
``block_{i}/{split_w,alpha,alpha1,alpha2}``,
``block_{i}/branch_{k}/WNConv_{0,1}``, ``tail``, ``skip``), so a JAX
checkpoint loads by key (train/checkpoint.py). Weights are used live
(``WNConv.forward_live``): the module trains.
"""

import torch
import torch.nn as nn

from mobilesuperresolution_tpu_torch.kernels.fused_convsep import FusedConvSepFn
from mobilesuperresolution_tpu_torch.nas.speed_estimator import KERNEL_CHOICES, block_speed_from_gates
from mobilesuperresolution_tpu_torch.ops.layers import WNConv, depth_to_space
from mobilesuperresolution_tpu_torch.ops.ste import binary_mask, condition, rounding

# the JAX initializers of the gates, Uniform(lo, hi) (wdsr_nas.py:45-53, 86-90)
GATE_INIT = {"mask_w": (0.5, 1.0), "split_w": (0.5, 1.0), "alpha": (0.5, 1.5),
             "alpha1": (0.0, 0.2), "alpha2": (0.8, 1.0)}


class ConvSep(nn.Module):
    """Separable conv branch, weight-normed with g_init=None:
    WNConv_0 depthwise kxk (v (k, k, 1, C)), ReLU, WNConv_1 1x1 C → features.
    One B5 launch forward."""

    def __init__(self, channels, features, kernel_size):
        super().__init__()
        self.WNConv_0 = WNConv(channels, channels, kernel_size, g_init=None, groups=channels)
        self.WNConv_1 = WNConv(channels, features, 1, g_init=None)

    def forward(self, x):
        dt = x.dtype
        wd = self.WNConv_0.effective_kernel()[:, :, 0, :].to(dt)
        wp = self.WNConv_1.effective_kernel()[0, 0].to(dt)
        return FusedConvSepFn.apply(x.contiguous(), wd, self.WNConv_0.b.to(dt), wp, self.WNConv_1.b.to(dt))


class SplitBlock(nn.Module):
    """Searchable block: channel split, 3 parallel kernel branches and the
    skip gate; owns its gates and adds its latency estimate."""

    uniform_init = GATE_INIT

    def __init__(self, num_residual_units, differentiable_speed=False):
        super().__init__()
        r = num_residual_units
        self.differentiable_speed = differentiable_speed
        self.split_w = nn.Parameter(torch.zeros(r))
        self.alpha = nn.Parameter(torch.zeros(len(KERNEL_CHOICES)))
        self.alpha1 = nn.Parameter(torch.zeros(()))
        self.alpha2 = nn.Parameter(torch.zeros(()))
        for k in KERNEL_CHOICES:
            setattr(self, f"branch_{k}", ConvSep(r, r, k))

    def forward(self, x, mask_w, speed_accu, speed_table=None):
        speed_curr = block_speed_from_gates(
            mask_w, self.split_w, self.alpha, differentiable=self.differentiable_speed, speed_table=speed_table
        )
        dt = x.dtype
        # the split gate uses least_channel=0 (reference wdsr_b.py:424)
        m_split = binary_mask(self.split_w, least_channel=0).to(dt)
        x1 = x * m_split
        x2 = x - x1
        pro = torch.softmax(self.alpha, dim=0).to(dt)
        x3 = x2
        for i, k in enumerate(KERNEL_CHOICES):
            x3 = x3 + torch.relu(getattr(self, f"branch_{k}")(x1)) * pro[i]
        x3 = x3 + x1
        sr2 = x2 + x3 * m_split
        beta1, beta2 = condition(self.alpha1, self.alpha2)
        out = beta1.to(dt) * x + beta2.to(dt) * sr2
        return out, beta2 * speed_curr + speed_accu


class NASModel(nn.Module):
    """The searchable WDSR-B supernet; ``forward`` returns (sr, speed_accu).
    With width_search=False the model-wide mask gate is not applied."""

    uniform_init = GATE_INIT

    def __init__(self, num_blocks=16, num_residual_units=32, scale=2, num_channels=3, image_mean=0.5,
                 width_search=True, differentiable_speed=False, compute_dtype=torch.float32):
        super().__init__()
        r = num_residual_units
        self.num_blocks = num_blocks
        self.num_residual_units = r
        self.scale = scale
        self.image_mean = image_mean
        self.width_search = width_search
        self.compute_dtype = compute_dtype
        num_outputs = scale * scale * num_channels
        self.mask_w = nn.Parameter(torch.zeros(r))
        self.head = WNConv(num_channels, r, 3, g_init=1.0)
        for i in range(num_blocks):
            setattr(self, f"block_{i}", SplitBlock(r, differentiable_speed))
        self.tail = WNConv(r, num_outputs, 3, g_init=1.0)
        self.skip = WNConv(num_channels, num_outputs, 5, g_init=1.0)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_blocks)]

    def prepare(self):
        """Nothing to derive: the supernet uses its weights live (the
        checkpoint bridge calls this after loading)."""

    def forward(self, x, speed_table=None):
        """x: (B, H, W, C) in [0, 1] → ((B, scale·H, scale·W, C) in x.dtype,
        float32 latency estimate). speed_table: optional dense
        (3, C+1, C+1) measured-latency tensor (nas.speed_estimator.
        densify_speed_table) in place of the analytic model."""
        r = self.num_residual_units
        if speed_table is not None and speed_table.shape[-1] < r + 1:
            raise ValueError(
                f"speed_table covers channels 0..{speed_table.shape[-1] - 1} but "
                f"num_residual_units={r}; re-densify with max_ch >= {r}"
            )
        in_dtype = x.dtype
        x = x.to(self.compute_dtype) - self.image_mean
        y = self.head.forward_live(x)
        m = binary_mask(self.mask_w, least_channel=8).to(y.dtype)
        speed_accu = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks():
            if self.width_search:
                y = y * m
            y, speed_accu = blk(y, self.mask_w, speed_accu, speed_table)
        if self.width_search:
            y = y * m
        y = self.tail.forward_live(y) + self.skip.forward_live(x)
        if self.scale > 1:
            y = depth_to_space(y, self.scale)
        return (y + self.image_mean).to(in_dtype), speed_accu


def get_block_status(model):
    """Indices of the surviving (not skipped) blocks: alpha1 < alpha2."""
    return [i for i, b in enumerate(model.blocks()) if float(b.alpha1.detach()) < float(b.alpha2.detach())]


def get_current_blocks(model):
    return len(get_block_status(model))


def get_width_from_block_idx(model, remain_block_idx):
    """Per surviving block [active mask channels, active split-and-mask
    channels, best kernel]."""
    mask_bin = rounding(model.mask_w)
    out = []
    for i, b in enumerate(model.blocks()):
        if i not in remain_block_idx:
            continue
        split_bin = rounding(b.split_w)
        out.append([
            int(mask_bin.sum()),
            int((mask_bin * split_bin).sum()),
            KERNEL_CHOICES[int(torch.argmax(b.alpha))],
        ])
    return out
