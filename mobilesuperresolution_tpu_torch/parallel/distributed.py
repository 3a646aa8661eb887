"""Multi-process runtime (counterpart of
mobilesuperresolution_tpu/parallel/distributed.py).

The JAX package's ``data`` mesh axis is carried here by processes, one per
device, as the reference does it (``init_process_group('nccl', 'env://')`` +
``LOCAL_RANK``): NCCL when the process computes on CUDA, gloo on the CPU.
Two ways in, as in the JAX package:

- ``--distributed``: ``env://``, torchrun's ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``;
- ``--coordinator_address host:port --num_processes N --process_id I``: a
  ``tcp://`` rendezvous at process 0's address.

Each process computes on ``cuda:LOCAL_RANK`` (``--process_id`` modulo the
visible cards without torchrun). ``process_index`` / ``process_count`` read
the group, and are 0 / 1 without one. The collectives' timeout is
``MSR_DISTRIBUTED_TIMEOUT`` seconds (default 1800: the chief's eval and
checkpoint writes run while the others wait at a barrier).
"""

import datetime
import os

import torch
import torch.distributed as dist


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def process_index():
    return dist.get_rank() if is_initialized() else 0


def process_count():
    return dist.get_world_size() if is_initialized() else 1


def is_primary():
    """The chief gate (the reference's ``params.local_rank == 0``)."""
    return process_index() == 0


def local_rank():
    """This process's device index on its host: torchrun's ``LOCAL_RANK``,
    else its process index."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def initialize(coordinator_address=None, num_processes=None, process_id=None, device="cuda"):
    """Join the process group once (later calls return at once): ``tcp://``
    at ``coordinator_address`` with the given size and rank, else
    ``env://``. ``device`` ('cuda' or 'cpu') picks NCCL or gloo; on CUDA the
    process's current card becomes ``cuda:local_rank()``."""
    if is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=int(os.environ.get("MSR_DISTRIBUTED_TIMEOUT", "1800")))
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())


def initialize_from_params(params):
    """CLI hook: join the process group when ``--distributed`` or
    ``--coordinator_address`` asks for it; returns True if it did."""
    explicit = getattr(params, "coordinator_address", None)
    if not explicit and not getattr(params, "distributed", False):
        return False
    device = getattr(params, "device", None) or "cuda"
    if explicit:
        n = getattr(params, "num_processes", None)
        i = getattr(params, "process_id", None)
        if n is None or i is None:
            raise ValueError("--coordinator_address requires --num_processes and --process_id (torchrun-style "
                             "explicit rendezvous)")
        initialize(explicit, n, i, device=device)
    else:
        initialize(device=device)
    return True


def shutdown():
    """Leave the process group, if in one."""
    if is_initialized():
        dist.destroy_process_group()


def barrier():
    if process_count() > 1:
        dist.barrier()


def all_reduce_mean_(tensors):
    """Average ``tensors`` (same device, any shapes) over the group in place
    with ONE all-reduce of their flat concatenation; a no-op in one
    process."""
    n = process_count()
    if n == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= n
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


def any_process(flag, device):
    """True on every process if ``flag`` is True on any (an all-reduce MAX)."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_parameters(model):
    """Make every process's parameters rank 0's (one flat broadcast), then
    re-derive the model's prepared weights; a no-op in one process."""
    if process_count() == 1:
        return
    params = list(model.parameters())
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        dist.broadcast(flat, 0)
        offset = 0
        for p in params:
            p.copy_(flat[offset : offset + p.numel()].view_as(p))
            offset += p.numel()
    model.prepare()
