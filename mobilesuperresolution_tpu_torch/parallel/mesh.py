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
  process on the CPU;
- a one-process job with n cards and S shards has D = max(n // S, 1) data
  groups (``Mesh.groups``, JAX's ``make_mesh(data=n // S, spatial=S)``):
  group g's shard i on card ``(own + g·S + i) mod n``, group 0 being the
  mesh itself. ``Mesh.map_groups`` splits a batch of streams over them when
  D divides it (else one group computes it all, JAX's replicated fallback),
  each group running the whole forward on its own cards. In a process
  group, on one card and on the CPU, D = 1.

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
    unsharded stages and the outputs live; ``groups``: the data groups, each
    a mesh of ``spatial`` shards (the first is this mesh). ``slots`` (tests)
    puts every shard and that many data slots on ``device``, so windows and
    data groups (slots // spatial of them) run on the CPU or one card."""

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
            self.devices, self.data_devices = [device] * spatial, [device] * slots
        self.device = device
        self.spatial = spatial
        self._copies = {}
        n = len(self.data_devices)
        self.groups = [self] + [self._group([self.data_devices[(g * spatial + i) % n] for i in range(spatial)])
                                for g in range(1, max(n // spatial, 1))]

    def _group(self, devices):
        """Data group mesh: its shards on ``devices``, its unsharded stages
        and its one data slot on the first."""
        group = copy.copy(self)
        group.devices, group.device, group.data_devices = devices, devices[0], devices[:1]
        group._copies = {}
        group.groups = [group]
        return group

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

    def map_groups(self, fn, module, *batch):
        """``fn(group, module_there, *parts)``: ``batch`` is (tensor, dim)
        pairs whose dims hold the same B members; with D groups and D
        dividing B, group g gets members g·B/D .. (g+1)·B/D - 1 of each
        tensor on its device (made current) and ``module`` there (eval
        replicas, ``replicas``), else the mesh itself gets them all. Returns
        the outputs concatenated on dim 0 on the process's device, in member
        order. Groups on other cards are launched before any output is
        copied back."""
        b = batch[0][0].shape[batch[0][1]]
        d = len(self.groups)
        if d == 1 or b % d:
            return fn(self, module, *(t for t, _ in batch))
        there = self.replicas(module, [g.device for g in self.groups])
        outs = []
        for k, group in enumerate(self.groups):
            parts = [t.narrow(dim, k * b // d, b // d).to(group.device) for t, dim in batch]
            with on_device(group.device):
                outs.append(fn(group, there[group.device], *parts))
        return torch.cat([o.to(self.device) for o in outs])


def map_groups(mesh, fn, module, *batch):
    """``mesh.map_groups(fn, module, *batch)`` for a ``Mesh``; for a shard
    count (an int: one group on the input's device), ``fn(mesh, module,
    *tensors)``."""
    if isinstance(mesh, Mesh):
        return mesh.map_groups(fn, module, *batch)
    return fn(mesh, module, *(t for t, _ in batch))


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
