"""Height-sharded convolutional inference, exact, with overlap windows
(counterpart of mobilesuperresolution_tpu/parallel/halo.py).

- Each shard computes a window of ``H/n + 2·radius`` rows. Interior windows
  are centered on their output rows, so every conv sees real neighbor rows.
- At the image's top and bottom the window is shifted inward so that it
  ends exactly at the image edge: the model's own per-layer SAME zero
  padding then reproduces the full frame's boundary math. (A zero halo is
  not equivalent: after one conv the full frame's pad rows are zero again,
  while halo rows hold bias and activation values.)
- Windows have one shape; only the output crop differs per shard.

The windows run one after another, each on its shard's device
(parallel/mesh.py), so a window's activations are freed before the next
runs. Requires H/n >= 2·radius and a pure-conv model whose receptive radius
is at most ``radius``.
"""

import torch

from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh, on_device


def receptive_radius_wdsr(num_blocks, block_kernel=3):
    """Total receptive radius of the WDSR family: head 3x3 + per-block kxk +
    tail 3x3 (the 5x5 skip path is shallower)."""
    return 1 + num_blocks * (block_kernel // 2) + 1


def shard_offsets(h, n, radius):
    """Per-shard window start rows: interior windows centered on their output
    rows, edge windows shifted inward to end exactly at the image edge."""
    hs = h // n
    win = hs + 2 * radius
    return [min(max(i * hs - radius, 0), h - win) for i in range(n)]


def build_windows(x, n, radius):
    """x: (B, H, W, C) → n overlap windows (B, H/n + 2·radius, W, C), the
    JAX function's stack unstacked. They are views: each keeps x's memory
    layout, so its convs run the algorithms, and round as, the full frame's
    (a contiguous copy of a column-major image changes cuDNN's choice)."""
    win = x.shape[1] // n + 2 * radius
    return [x[:, o : o + win] for o in shard_offsets(x.shape[1], n, radius)]


def _crop(y, i, h, n, radius, scale):
    """Window ``i``'s central H/n output rows (times ``scale``)."""
    hs = h // n
    start = i * hs - shard_offsets(h, n, radius)[i]
    return y[:, start * scale : (start + hs) * scale]


def crop_concat(y, h, n, radius, scale=1, device=None):
    """y: (n, B, win·scale, W·scale, C') per-window outputs (or a sequence of
    n of them, each on its shard's device) → (B, H·scale, W·scale, C') on
    ``device`` (default: the windows'): each window's central H/n output
    rows, which cover the image exactly once."""
    return torch.cat([_crop(y[i], i, h, n, radius, scale).to(device or y[i].device) for i in range(n)], dim=1)


def _check_shardable(h, n, radius):
    # ValueError, not assert: under `python -O` a stripped assert would
    # silently drop output rows instead of failing
    if h % n != 0:
        raise ValueError(f"H={h} not divisible by {n} shards")
    hs = h // n
    if hs < 2 * radius and n != 1:
        raise ValueError(f"shard height {hs} must be >= 2*radius={2 * radius}")


def spatial_shards(mesh):
    """The number of height shards of ``mesh``: a ``Mesh`` or an int."""
    return mesh.spatial if isinstance(mesh, Mesh) else int(mesh)


def spatially_sharded_apply(apply_fn, x, mesh, radius, scale=1):
    """Run ``apply_fn`` (a module, or any callable when every shard is on
    x's device) on x: (B, H, W, C) with H split into ``mesh``'s shards (a
    ``Mesh`` or an int: that many shards on x's device). Returns the full
    (B, H·scale, W·scale, C') output on x's device, equal to ``apply_fn(x)``
    up to float summation order; differentiable."""
    n = spatial_shards(mesh)
    h = x.shape[1]
    _check_shardable(h, n, radius)
    if n == 1:
        return apply_fn(x)
    devices = mesh.devices if isinstance(mesh, Mesh) else [x.device] * n
    fns = [apply_fn] * n
    if isinstance(apply_fn, torch.nn.Module) and isinstance(mesh, Mesh):
        reps = mesh.replicas(apply_fn)
        fns = [reps[d] for d in devices]
    ys = []
    for fn, window, d in zip(fns, build_windows(x, n, radius), devices):
        with on_device(d):
            ys.append(fn(window.to(d)))
    return crop_concat(ys, h, n, radius, scale, device=x.device)
