"""Height-sharded SISR training with exact gradients (counterpart of
mobilesuperresolution_tpu/parallel/spatial_train.py).

The windows of parallel/halo.py are differentiable (``spatially_sharded_apply``
is the JAX package's ``spatial_sharded_forward`` too): every output pixel's
window forward equals its full-frame forward and each output row is kept by
exactly one window, so the L1 loss and the gradients are those of the
unsharded step up to float summation order. Composes with data parallelism:
each process of a group (parallel/distributed.py) shards its own batch, and
the step averages over the group as the plain step does.

Restricted to pure-conv models (the WDSR family: head, body, tail and skip
convs and depth-to-space, all spatially local).
"""

from mobilesuperresolution_tpu_torch.parallel.halo import spatially_sharded_apply
from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step


def make_spatial_sisr_step(model, optimizer, mesh, radius, scale):
    """step(batch) -> metrics: the SISR step (train/steps.py::make_sisr_step)
    with the forward sharded over ``mesh``'s height shards."""
    return make_sisr_step(model, optimizer,
                          forward=lambda m, lr: spatially_sharded_apply(m, lr, mesh, radius, scale))
