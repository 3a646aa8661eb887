"""Receptive radius of the WDSR family (counterpart of
mobilesuperresolution_tpu/parallel/halo.py::receptive_radius_wdsr, the part
of that module tiled eval needs; the height-sharded halo inference is not
ported)."""


def receptive_radius_wdsr(num_blocks, block_kernel=3):
    """Total receptive radius of the WDSR family: head 3x3 + per-block kxk +
    tail 3x3 (the 5x5 skip path is shallower)."""
    return 1 + num_blocks * (block_kernel // 2) + 1
