"""Space-to-depth weight transform for SpyNet's 7x7 stacks.

Counterpart of mobilesuperresolution_tpu/ops/s2d_conv.py. The exact identity

    conv7x7(x, W) == d2s( conv5x5( s2d(x), T(W) ) )

runs the conv on (H/2, W/2, 4C); T(W) places original tap
W[2α+r−p, 2β+s−q] at transformed tap (α, β) from input phase (r, s) to
output phase (p, q), zero elsewhere. Channel ordering matches
``ops.layers.space_to_depth`` ('(c i j)': ch = c·4 + i·2 + j). The 5x5 convs
run on kernel B1 (kernels/conv5x5.py).
"""

import functools

import numpy as np
import torch


def transformed_kernel_size(k, f):
    """Tap count per dim after factor-f s2d: u = f·α + r − p + (k//2) must
    cover [0, k) for r, p ∈ [0, f)."""
    half = (k // 2 + f - 1) // f
    return 2 * half + 1


@functools.lru_cache(maxsize=8)
def _scatter_tensor(k=7, f=2):
    """Constant M[a,b,r,s,p,q,u,v] = 1 iff transformed tap (a,b) of
    input-phase (r,s) → output-phase (p,q) reads original tap (u,v)."""
    kn = transformed_kernel_size(k, f)
    half = kn // 2
    m = np.zeros((kn, kn, f, f, f, f, k, k), np.float32)
    for a in range(kn):
        for b in range(kn):
            for r in range(f):
                for s in range(f):
                    for p in range(f):
                        for q in range(f):
                            u = f * (a - half) + r - p + k // 2
                            v = f * (b - half) + s - q + k // 2
                            if 0 <= u < k and 0 <= v < k:
                                m[a, b, r, s, p, q, u, v] = 1.0
    return m


@functools.lru_cache(maxsize=8)
def _tap_index(k=7, f=2):
    """I[a,b,r,s,p,q] = u·k + v of the one original tap that ``_scatter_tensor``
    maps to (a,b,r,s,p,q), or k·k where it maps none (a zero tap)."""
    m = _scatter_tensor(k, f)
    idx = np.full(m.shape[:6], k * k, np.int64)
    *at, u, v = np.nonzero(m)
    idx[tuple(at)] = u * k + v
    return idx


def s2d_transform_weights(wk, factor=2):
    """wk: (k, k, Cin, Cout) HWIO → (k', k', f²·Cin, f²·Cout) HWIO: each
    transformed tap copies its original tap (``_scatter_tensor`` holds one
    1 per transformed tap at most), gathered rather than contracted."""
    k = wk.shape[0]
    cin, cout = wk.shape[2], wk.shape[3]
    f = factor
    taps = torch.cat([wk.reshape(k * k, cin, cout), wk.new_zeros((1, cin, cout))])
    w2 = taps[torch.as_tensor(_tap_index(k, f), device=wk.device)]  # a b r s p q c d
    kn = transformed_kernel_size(k, f)
    return w2.permute(0, 1, 6, 2, 3, 7, 4, 5).reshape(kn, kn, f * f * cin, f * f * cout)
