"""Math helpers (counterpart of mobilesuperresolution_tpu/core/maths.py: a
two-way softmax, part of the public surface, unused by training)."""

import torch


def softmax2(a, b):
    """Numerically stable softmax over two scalars (or tensors) → (pa, pb)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    m = torch.maximum(a, b)
    ea, eb = torch.exp(a - m), torch.exp(b - m)
    s = ea + eb
    return ea / s, eb / s
