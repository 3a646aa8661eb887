"""The backward that the kernels' autograd Functions share: no kernel has a
backward kernel, so each differentiates its plain version, recomputed."""

import torch


def plain_backward(plain, ctx, grad_y):
    """The gradients of ``plain(*ctx.saved_tensors)`` against ``grad_y`` for
    the saved inputs that need one (None for the others), by autograd
    through a recomputation."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        y = plain(*inputs)
    grads = iter(torch.autograd.grad(y, wanted, grad_y))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)
