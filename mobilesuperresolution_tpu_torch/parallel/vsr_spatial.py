"""Exact height-sharded recurrent VSR for ``BasicVSR`` and ``BasicVSROrigin``
(counterpart of mobilesuperresolution_tpu/parallel/vsr_spatial.py).

The work splits by its structure:

1. SpyNet flows: frame-parallel, one call on the whole pair batch (kernel B1,
   30 launches per forward), on the process's device.
2. Bidirectional propagation: sequential in T, conv-local per step, so the
   frame height is sharded (parallel/mesh.py) with a halo exchange at every
   step: each step takes ``R = rt + max_disp`` carry rows from each
   neighbor shard (zeros at the image's edges), warps, and runs the trunk on
   the window. ``rt`` covers the trunk's receptive radius, ``max_disp`` the
   flow's row displacement. The shards on one device run their trunks as one
   batch.
3. Reconstruction: frame-parallel over B·T, the model's own (kernel B2), on
   the process's device. It is not sharded: its resize to the output size
   does not split at shard rows. So the process's card holds the full
   frames, flows, stacked features and reconstruction, as the unsharded
   forward does; what sharding takes off it is the trunk's per-step
   activations of the shards placed on other cards. Each shard's frames
   and flows are sliced straight onto its device, and each step's carry is
   written into one preallocated feature stack.

Exact (the plain forward's values, up to float summation order) whenever
every flow's row displacement is within ``max_disp``: the sharded path clips
flow dy to ±max_disp (dx is not limited: the width is not sharded), so
larger motion degrades toward zero padding instead of reading past the halo.
The image's edges reproduce the full frame's SAME zero padding: the halos
there are zeros and the trunk's ``row_mask`` re-zeroes out-of-image rows
after every conv.
"""

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR, BasicVSROrigin, stack_directions
from mobilesuperresolution_tpu_torch.ops.warp import flow_warp
from mobilesuperresolution_tpu_torch.parallel.halo import spatial_shards
from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh, on_device
from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step


def trunk_radius(num_block):
    """Receptive radius of one propagation step's trunk: conv0 3x3 (r=1) +
    num_block residual blocks of two 3x3 convs (r=2 each)."""
    return 1 + 2 * num_block


def _halo_exchange(shards, m):
    """shards: n (N, Hloc, W, C) tensors, each on its device → n (N, Hloc+2m,
    W, C): m rows of each neighbor copied in, zeros beyond the image."""
    out = []
    for i, a in enumerate(shards):
        zeros = a.new_zeros((a.shape[0], m) + tuple(a.shape[2:]))
        top = shards[i - 1][:, -m:].to(a.device) if i > 0 else zeros
        bot = shards[i + 1][:, :m].to(a.device) if i + 1 < len(shards) else zeros
        out.append(torch.cat([top, a, bot], dim=1))
    return out


def _rows(a, lo, hi, device):
    """Rows [lo, hi) (dim 2) of ``a`` on ``device``, zeros beyond the image."""
    h = a.shape[2]
    part = a[:, :, max(lo, 0) : min(hi, h)].to(device)
    return F.pad(part, (0, 0, 0, 0, max(-lo, 0), max(hi - h, 0)))


def _row_mask(i, hloc, margin, h_total, device):
    """(1, Hloc+2·margin, 1, 1) 0/1 mask of shard ``i``'s window: 1 where the
    row is an image row."""
    rows = i * hloc - margin + torch.arange(hloc + 2 * margin, device=device)
    return ((rows >= 0) & (rows < h_total)).float().view(1, -1, 1, 1)


def _propagate(model, x, ff, fb, mesh, n, rt, R):
    """The height-sharded recurrence: (out_b, out_f), each (B, T, H, W, nf)
    on x's device, as ``BasicVSRBase._propagate`` returns them. A function
    of its own so that the shards' windows and the last step's activations
    are freed before the reconstruction runs."""
    b, t, h, w, _ = x.shape
    nf = model.num_feat
    hloc = h // n
    devices = mesh.devices if isinstance(mesh, Mesh) else [x.device] * n
    trunk = model.propagation.trunks
    run = mesh.replicas(trunk) if isinstance(mesh, Mesh) else {x.device: trunk}
    groups = {}
    for i, d in enumerate(devices):
        groups.setdefault(d, []).append(i)
    # each shard's frames and flows (T, 2B, Hloc+2rt, W, ·) on its device,
    # with rt halo rows (zeros beyond the image)
    wins = [stack_directions(*(_rows(a, i * hloc - rt, (i + 1) * hloc + rt, d) for a in (x, ff, fb)))
            for i, d in enumerate(devices)]
    masks = [_row_mask(i, hloc, rt, h, d) for i, d in enumerate(devices)]
    group_masks = {d: torch.cat([masks[i].expand(b, -1, -1, -1) for i in idx]) for d, idx in groups.items()}
    carry = [x.new_zeros((2 * b, hloc, w, nf), device=d) for d in devices]
    out = x.new_empty((t, 2 * b, h, w, nf))
    for j in range(t):
        halo = _halo_exchange(carry, R)
        inps = []
        for i in range(n):
            frames_w, flows_w = wins[i]
            # warp the R-window; only the central rt-margin rows are used (the
            # flow is zero-padded over the discarded margin)
            warped = flow_warp(halo[i], F.pad(flows_w[j], (0, 0, 0, 0, R - rt, R - rt)), padding_mode="zeros")
            inp = torch.cat([frames_w[j], warped[:, R - rt : R + hloc + rt]], dim=-1) * masks[i].to(x.dtype)
            inps.append(torch.cat([inp[:b], inp[b:]], dim=-1))  # [backward | forward] channels
        for d, idx in groups.items():
            with on_device(d):
                y = run[d](torch.cat([inps[i] for i in idx]), row_mask=group_masks[d])
            for k, i in enumerate(idx):
                yi = y[k * b : (k + 1) * b, rt : rt + hloc]
                carry[i] = torch.cat([yi[..., :nf], yi[..., nf:]], dim=0)
                out[j, :, i * hloc : (i + 1) * hloc] = carry[i].to(out.device)
    return out[:, :b].flip(0).movedim(0, 1), out[:, b:].movedim(0, 1)


def spatial_basicvsr_forward(model, x, height, width, mesh, max_disp=8, flows=None):
    """Height-sharded forward of a ``BasicVSR`` or ``BasicVSROrigin``: x (B,
    T, H, W, C) with H divisible by the shard count of ``mesh`` (a ``Mesh``
    or an int: that many shards on x's device) → (B, T, height, width, C) in
    x.dtype, the model's own forward whenever every flow row displacement is
    within ``max_disp``; differentiable. ``flows``: precomputed time-major
    (flows_forward, flows_backward), as ``BasicVSR.forward``'s (the
    flow-cached serving path); the dy clip applies to them too. The deep
    ``basic_origin`` trunk (30 blocks: rt 61) needs H/n >= 61 + max_disp."""
    if not isinstance(model, (BasicVSR, BasicVSROrigin)) or not model.has_spynet:
        raise TypeError("spatial_basicvsr_forward supports the BasicVSR / BasicVSROrigin recurrent models; got "
                        f"{type(model).__name__}")
    n = spatial_shards(mesh)
    h = x.shape[2]
    rt = trunk_radius(model.num_block)
    R = rt + max_disp
    if h % n != 0:
        raise ValueError(f"H={h} not divisible by {n} spatial shards")
    if n > 1 and h // n < R:
        raise ValueError(f"shard height {h // n} must be >= trunk radius + max_disp = {R}")
    in_dtype = x.dtype
    x = x.to(model.compute_dtype)

    # 1. flows: SpyNet on the whole pair batch; dy clipped to the halo budget
    ff, fb = (torch.cat([f[..., :1], f[..., 1:].clamp(-max_disp, max_disp)], dim=-1)
              for f in model._flows(x, flows))

    # 2. propagation: the direction-stacked recurrence, height-sharded
    out_b, out_f = _propagate(model, x, ff, fb, mesh, n, rt, R)

    # 3. reconstruction: the model's own, batched over B·T
    return model._reconstruct(x, out_b, out_f, height, width).to(in_dtype)


def make_spatial_vsr_step(model, optimizer, mesh, out_hw, max_disp=8):
    """step(batch) -> metrics: the VSR step (train/steps.py::make_vsr_step,
    Charbonnier, the same optimizer) with the forward height-sharded by
    ``spatial_basicvsr_forward``. The halo exchanges, the dy clip and the
    row masks are differentiable, so the loss and the gradients are the
    plain step's whenever the flows' row displacements stay within
    ``max_disp`` (beyond it the clip's gradient is zero, the subgradient of
    the clipped forward)."""
    return make_vsr_step(model, optimizer, out_hw,
                         forward=lambda lr, oh, ow: spatial_basicvsr_forward(model, lr, oh, ow, mesh, max_disp))
