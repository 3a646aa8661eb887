"""Bounded-memory long-video inference: temporal chunking with overlap
(counterpart of mobilesuperresolution_tpu/parallel/temporal.py, single-device
path).

Each window of ``chunk + 2·overlap`` frames runs independently and keeps its
central ``chunk`` outputs; clip edges are replicated so every window has one
shape. Clips that fit in one window run un-windowed at native length (exact
for recurrent models, where a padded window would not be). For recurrent
models the result approximates the whole-clip forward, with error
decreasing in ``overlap``.
"""

import numpy as np
import torch


def chunked_vsr_apply(apply_fn, lr, height, width, chunk, overlap=4, mesh=None):
    """apply_fn: ``(lr_window, out_h, out_w) -> sr_window`` over
    (B, T_win, H, W, C) tensors; lr: (B, T, H, W, C). Returns
    (B, T, height, width, C'). ``mesh`` (groups of windows over the
    process's cards) is not ported yet and raises."""
    if mesh is not None:
        raise NotImplementedError("chunked_vsr_apply(mesh=) (windows over several devices) is not ported yet "
                                  "(ROADMAP.md, queue A8)")
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    if overlap < 0:
        raise ValueError("overlap must be >= 0")
    t = lr.shape[1]
    if t <= chunk + 2 * overlap:
        return apply_fn(lr, height, width)
    outs = []
    for s in range(0, t, chunk):
        idx = np.clip(np.arange(s - overlap, s + chunk + overlap), 0, t - 1)
        sr = apply_fn(lr[:, torch.from_numpy(idx).to(lr.device)], height, width)
        outs.append(sr[:, overlap : overlap + min(chunk, t - s)])
    return torch.cat(outs, dim=1)
