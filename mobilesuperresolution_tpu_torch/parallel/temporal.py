"""Bounded-memory long-video inference: temporal chunking with overlap
(counterpart of mobilesuperresolution_tpu/parallel/temporal.py).

Each window of ``chunk + 2·overlap`` frames runs independently and keeps its
central ``chunk`` outputs; clip edges are replicated so every window has one
shape. Clips that fit in one window run un-windowed at native length (exact
for recurrent models, where a padded window would not be). For recurrent
models the result approximates the whole-clip forward, with error
decreasing in ``overlap``.

With a ``mesh`` (parallel/mesh.py) the windows go in groups of the mesh's
data slots: window ``i`` of a group runs on slot ``i`` (card ``(own + i)
mod n`` of a one-process job), and the outputs come back in order. A short
last group runs its own windows only: the JAX package pads it with copies
of its last window to keep one program shape, which eager torch does not
need, and the kept frames are the same.
"""

import numpy as np
import torch


def chunked_vsr_apply(apply_fn, lr, height, width, chunk, overlap=4, mesh=None):
    """apply_fn: ``(lr_window, out_h, out_w) -> sr_window`` over
    (B, T_win, H, W, C) tensors, run on whichever device the window lies on;
    lr: (B, T, H, W, C). Returns (B, T, height, width, C') on lr's device
    (``mesh``: groups of windows over its data slots)."""
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    if overlap < 0:
        raise ValueError("overlap must be >= 0")
    t = lr.shape[1]
    if t <= chunk + 2 * overlap:
        return apply_fn(lr, height, width)

    def window(s):
        idx = np.clip(np.arange(s - overlap, s + chunk + overlap), 0, t - 1)
        return lr[:, torch.from_numpy(idx).to(lr.device)]

    starts = list(range(0, t, chunk))
    nd = 1 if mesh is None else len(mesh.data_devices)
    outs = []
    for i in range(0, len(starts), nd):
        group = starts[i : i + nd]
        if mesh is None:
            srs = [apply_fn(window(group[0]), height, width)]
        else:
            srs = mesh.map_data(lambda x: apply_fn(x, height, width), [window(s) for s in group])
        for s, sr in zip(group, srs):
            outs.append(sr[:, overlap : overlap + min(chunk, t - s)])
    return torch.cat(outs, dim=1)
