"""The port's (data, spatial) mesh (counterpart of
mobilesuperresolution_tpu/parallel/mesh.py).

Torch has no virtual devices, so the JAX mesh's two axes split:

- ``data`` is carried by processes, one per device (parallel/distributed.py):
  each process loads its slice of the global batch (data/isr.py
  ``shard_by_process``) and the train steps average loss and gradients over
  the group;
- ``spatial`` is carried by the height shards of one process. In a
  one-process job shard ``i`` goes to the visible card ``(own + i) mod n``,
  own being the process's card (card ``i mod n`` when own is card 0), and
  halo rows between shards on different cards move by device-to-device
  copies. In a process group each process owns one card (``cuda:LOCAL_RANK``)
  and every one of its shards stays there: spreading them would put a
  process's shards, and in training a copy of its parameters, on another
  rank's card. A one-card process runs every shard on its card, a CPU
  process on the CPU.

A module runs on a shard's device through ``Mesh.replicas``: the module
itself where it lives; elsewhere, in training, a functional call on its
parameters copied there differentiably (the gradients flow back to the
module's own); in eval, a copy refreshed from the module's parameters.
"""

import contextlib
import copy

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.parallel.distributed import process_count


class Mesh:
    """``data``: the processes of the group; ``spatial``: this process's
    height shards, on ``devices`` (one per shard); ``device``: the process's
    own device, where the unsharded stages and the outputs live."""

    def __init__(self, spatial=1, device=None):
        if spatial < 1:
            raise ValueError(f"spatial={spatial} must be >= 1")
        device = torch.device(device or "cuda")
        self.data = process_count()
        if device.type == "cuda":
            own = torch.cuda.current_device() if device.index is None else device.index
            device = torch.device("cuda", own)
            n = torch.cuda.device_count()
            self.devices = [torch.device("cuda", (own + i) % n) for i in range(spatial)]
        if device.type != "cuda" or self.data > 1:
            self.devices = [device] * spatial
        self.device = device
        self.spatial = spatial
        self._copies = {}

    @property
    def shape(self):
        return {"data": self.data, "spatial": self.spatial}

    def replicas(self, module):
        """{shard device: callable running ``module`` there}; call it once
        per sharded forward (an eval copy is refreshed on each call)."""
        home = next(module.parameters()).device
        out = {}
        for dev in dict.fromkeys(self.devices):
            if dev == home:
                out[dev] = module
            elif module.training and torch.is_grad_enabled():
                moved = {k: p.to(dev) for k, p in module.named_parameters()}
                out[dev] = lambda *a, _p=moved, **kw: torch.func.functional_call(module, _p, a, kw)
            else:
                rep = self._copies.get((id(module), dev))
                if rep is None:
                    rep = self._copies[(id(module), dev)] = copy.deepcopy(module).to(dev)
                with torch.no_grad():
                    for rp, p in zip(rep.parameters(), module.parameters()):
                        rp.copy_(p)
                rep.eval()
                if hasattr(rep, "prepare"):
                    with on_device(dev):
                        rep.prepare()
                out[dev] = rep
        return out


def on_device(device):
    """Make ``device`` the current CUDA device while a shard runs there: the
    hand kernels launch on the current device's stream."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def make_mesh(data=None, spatial=1, device=None):
    """The process's mesh: ``data`` (None = the group's size) must equal the
    number of processes, which carry that axis."""
    n = process_count()
    if data is not None and data != n:
        raise ValueError(f"data={data} != {n} processes: the data axis is one process per device")
    return Mesh(spatial, device)


def shard_batch(mesh, batch):
    """This process's batch (numpy arrays or tensors: its slice of the global
    batch) onto its device; ``mesh`` a ``Mesh`` or a device."""
    device = mesh.device if isinstance(mesh, Mesh) else torch.device(mesh)
    return tuple((torch.from_numpy(a) if isinstance(a, np.ndarray) else a).to(device) for a in batch)
