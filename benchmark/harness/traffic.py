"""Seeded inputs of every traffic mix: moving textured clips.

A clip is a smooth random texture (two octaves, bilinearly upsampled noise)
seen through a window that moves by a whole number of pixels each frame, as
``chip_smoke.py::synthetic_stream`` made its stream. Each seed gives the same
frame sizes, clip lengths and set of motions (the traffic file's list, dealt
to the clips in a seeded order), so a seed changes the pixels and the order,
never the amount of work.
"""

import numpy as np


def _texture(rng, h, w):
    """(h, w, 3) float32 in [0, 1]: noise at 1/16 and 1/4 of the size,
    bilinearly upsampled and mixed 3:1."""
    import torch
    import torch.nn.functional as F

    out = 0
    for div, weight in ((16, 0.75), (4, 0.25)):
        noise = torch.from_numpy(rng.random((1, 3, h // div + 2, w // div + 2), dtype=np.float32))
        out = out + weight * F.interpolate(noise, size=(h, w), mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


def moving_clip(rng, frames, h, w, motion):
    """(frames, h, w, 3) float32: a texture translated by ``motion`` = (dx,
    dy) pixels a frame."""
    dx, dy = motion
    tex = _texture(rng, h + abs(dy) * frames, w + abs(dx) * frames)
    y0 = abs(dy) * frames if dy < 0 else 0
    x0 = abs(dx) * frames if dx < 0 else 0
    return np.stack([tex[y0 + dy * i: y0 + dy * i + h, x0 + dx * i: x0 + dx * i + w] for i in range(frames)])


def clip_pool(seed, clips, frames, h, w, motions):
    """(clips, frames, h, w, 3) float32: ``clips`` moving clips, clip c
    moving by the c-th of ``motions`` in a seeded order (cycled when there
    are more clips than motions)."""
    rng = np.random.default_rng([int(seed), 1])
    order = rng.permutation(len(motions))
    return np.stack([moving_clip(rng, frames, h, w, motions[order[c % len(motions)]]) for c in range(clips)])


def stream_orders(seed, streams, clips):
    """Each stream's seeded order of the pool's clips: stream s plays clip
    ``orders[s][j % clips]`` as its j-th scene."""
    rng = np.random.default_rng([int(seed), 2])
    return [rng.permutation(clips) for _ in range(streams)]


def stream_frame(pool, orders, k):
    """(S, h, w, 3): frame ``k`` of every stream; each stream cycles through
    the pool's clips, and a clip's end is a scene cut."""
    frames = pool.shape[1]
    return np.stack([pool[order[(k // frames) % len(order)], k % frames] for order in orders])


def train_batches(seed, batches, batch, frames, lr_hw, scale, motions):
    """``batches`` distinct (lr (B, T, h, w, 3), hr (B, T, s·h, s·w, 3))
    float32 pairs: moving HR clips and their s x s area-averaged LR."""
    rng = np.random.default_rng([int(seed), 3])
    h, w = lr_hw
    out = []
    for i in range(batches):
        hr = np.stack([moving_clip(rng, frames, scale * h, scale * w, motions[rng.integers(len(motions))])
                       for _ in range(batch)])
        lr = hr.reshape(batch, frames, h, scale, w, scale, 3).mean(axis=(3, 5), dtype=np.float32)
        out.append((np.ascontiguousarray(lr), hr))
    return out
