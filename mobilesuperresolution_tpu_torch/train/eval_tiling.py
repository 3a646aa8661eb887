"""Exact tiled eval (counterpart of mobilesuperresolution_tpu/train/eval_tiling.py).

Covers an image with fixed-shape tiles whose overlap is at least the model's
receptive radius, keeps only each tile's uncontaminated interior, and
anchors edge tiles to the true image border, so the model's own SAME zero
padding reproduces the whole-image boundary math. Each dimension tiles on
its own: a dimension smaller than the tile runs at its native size. In the
JAX package tiling bounds XLA's recompiles per eval shape; here it bounds
the activation memory of a large eval image, and the tile shapes a forward
sees (``shapes_used``).

Exact when ``radius`` is at least the model's true receptive radius
(``parallel.halo.receptive_radius_wdsr`` for the WDSR family) and the
forward computes each output pixel the same way whatever the input's size.
On the CPU the tiled forward equals the whole-image forward bit for bit. On
the card kernels B3 and B4 compute each pixel alike at any shape, but
cuDNN's head conv may pick another algorithm per input shape (another
summation order), so the tiled output agrees within float32 rounding there.
``--quantize int8`` is not tile-invariant: each tile is quantized by its own
maximum, as the reference's per-patch int8 deployment is.
"""


def tile_starts(n, tile, stride):
    """Start offsets covering [0, n) with a final tile anchored at the end."""
    starts = list(range(0, n - tile + 1, stride))
    if starts[-1] != n - tile:
        starts.append(n - tile)
    return starts


def make_tiled_forward(fwd, scale, radius, tile=128):
    """Wrap ``fwd(lr) -> sr`` ((B, H, W, C) → (B, sH, sW, C) tensors) into an
    exact tiled forward. The returned callable's ``shapes_used`` set records
    every spatial shape handed to ``fwd``."""
    stride = tile - 2 * radius
    if stride <= 0:
        raise ValueError(f"tile {tile} too small for radius {radius}")
    shapes_used = set()

    def tiled(lr):
        b, h, w = lr.shape[:3]
        th, tw = min(h, tile), min(w, tile)
        ys = tile_starts(h, th, stride) if h > th else [0]
        xs = tile_starts(w, tw, stride) if w > tw else [0]
        shapes_used.add((th, tw))
        out = None
        for y in ys:
            for x in xs:
                sr_tile = fwd(lr[:, y : y + th, x : x + tw])
                if isinstance(sr_tile, tuple):  # NAS models: (sr, speed)
                    sr_tile = sr_tile[0]
                if out is None:
                    out = sr_tile.new_zeros((b, h * scale, w * scale, sr_tile.shape[-1]))
                # the uncontaminated interior, extended to the image edge
                # where the tile is anchored on the true border
                vy0 = y if y == 0 else y + radius
                vy1 = y + th if y + th == h else y + th - radius
                vx0 = x if x == 0 else x + radius
                vx1 = x + tw if x + tw == w else x + tw - radius
                out[:, vy0 * scale : vy1 * scale, vx0 * scale : vx1 * scale] = sr_tile[
                    :, (vy0 - y) * scale : (vy1 - y) * scale, (vx0 - x) * scale : (vx1 - x) * scale]
        return out

    tiled.shapes_used = shapes_used
    return tiled
