"""The port's (data, spatial) mesh (counterpart of
mobilesuperresolution_tpu/parallel/mesh.py).

Torch has no virtual devices, so the JAX mesh's two axes split:

- ``data`` is carried by processes, one per device (parallel/distributed.py):
  each process loads its slice of the global batch (data/isr.py
  ``shard_by_process``) and the train steps average loss and gradients over
  the group;
- in one process the ``data`` axis also has slots (``Mesh.data_devices``):
  the visible cards, card ``(own + i) mod n`` for slot ``i``, in a
  one-process job; the process's own device alone in a process group and
  on the CPU. Groups of windows (``parallel/temporal.py``) and patch
  batches (``cli/test_vsr_by_patch.py``) put member ``i`` on slot ``i``
  (``Mesh.map_data``), and their outputs come back to the process's device
  in order;
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
    """``data``: the processes of the group; ``data_devices``: this
    process's data slots; ``spatial``: its height shards, on ``devices``
    (one per shard); ``device``: the process's own device, where the
    unsharded stages and the outputs live. ``slots`` (tests) gives the data
    axis that many slots of ``device``, so grouping runs on the CPU."""

    def __init__(self, spatial=1, device=None, slots=None):
        if spatial < 1:
            raise ValueError(f"spatial={spatial} must be >= 1")
        device = torch.device(device or "cuda")
        self.data = process_count()
        if device.type == "cuda":
            own = torch.cuda.current_device() if device.index is None else device.index
            device = torch.device("cuda", own)
        if device.type == "cuda" and self.data == 1:
            n = torch.cuda.device_count()
            cards = [torch.device("cuda", (own + i) % n) for i in range(max(n, spatial))]
            self.devices, self.data_devices = cards[:spatial], cards[:n]
        else:
            self.devices, self.data_devices = [device] * spatial, [device]
        if slots is not None:
            self.data_devices = [device] * slots
        self.device = device
        self.spatial = spatial
        self._copies = {}

    @property
    def shape(self):
        return {"data": self.data, "spatial": self.spatial}

    def replicas(self, module, devices=None):
        """{device: callable running ``module`` there} for the shards'
        devices (or ``devices``, e.g. ``data_devices``); call it once per
        sharded forward (an eval copy is refreshed on each call)."""
        home = next(module.parameters()).device
        out = {}
        for dev in dict.fromkeys(devices or self.devices):
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

    def map_data(self, fn, xs):
        """``fn(x)`` for member ``i`` of the group ``xs`` (at most one per
        data slot) on slot ``i``'s device, made current; the outputs on the
        process's device, in order. Members on other cards are launched
        before any output is copied back, so the cards work side by side."""
        if len(xs) > len(self.data_devices):
            raise ValueError(f"a group of {len(xs)} members on {len(self.data_devices)} data slots")
        outs = []
        for x, dev in zip(xs, self.data_devices):
            with on_device(dev):
                outs.append(fn(x.to(dev)))
        return [o.to(self.device) for o in outs]


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
