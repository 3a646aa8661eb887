"""Weight bridge: JAX flat-npz checkpoints ↔ the port's modules.

Counterpart of mobilesuperresolution_tpu/train/checkpoint.py::
load_params_npz / save_params_npz. The JAX package writes its params tree
as a flat npz keyed by the flax path joined with '/', e.g.
``spynet/level_0/conv0_kernel``,
``propagation/trunks/backward_block0_conv1_kernel``,
``fusion/Conv_0/kernel``, ``conv_last/kernel``, and for the SISR models
``BasicBlock_3/WNConv_1/v`` (flax names modules by position: ``WNConv_0``
head, ``BasicBlock_{i}/WNConv_{0,1,2}``, ``WNConv_1`` tail, ``WNConv_2``
skip; ResultNet's ``head``, ``block_{i}/WNConv_0``, ``tail``, ``skip``; the
NAS supernet's bare gates ``mask_w`` and
``block_{i}/split_w|alpha|alpha1|alpha2`` beside
``block_{i}/branch_{k}/WNConv_{0,1}/{v,g,b}``; the VSR 'single' model's
``encoder``, ``block_{i}/WNConv_{0,1}``, ``body_tail``, ``shuf`` and
'multi''s ``flownet/level_{i}/...``, ``encode``,
``block_{i}/PlainConv_{0,1}/Conv_0/{kernel,bias}``, ``decode``). The port keeps the same
parameter names and layouts (HWIO kernels, the raw ConvTranspose kernel,
weight norm's ``v``/``g``/``b``), so a key maps to a parameter by its module
path; the only rename is flax's inner ``Conv_0`` scope of a ``PlainConv``.

``CheckpointManager`` keeps the full training state for ``--resume``, in
the port's own format (one ``torch.save`` file per epoch under
``<job>/ckpt/``); it neither reads nor writes the JAX package's orbax
checkpoints. ``<job>/weights/models.npz`` (``save_params_npz``) stays the
artifact both packages read.
"""

import json
import os
import re

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.ops.layers import PlainConv, SubpixelConvTranspose, WNConv


def _entries(model):
    """(jax_key, parameter, owning module) for every parameter of ``model``."""
    out = []
    for mname, mod in model.named_modules():
        scope = mname.split(".") if mname else []
        if isinstance(mod, PlainConv):
            scope = scope + ["Conv_0"]
        for pname, p in mod.named_parameters(recurse=False):
            out.append(("/".join(scope + [pname]), p, mod))
    return out


def jax_named_parameters(model):
    """{jax_key: parameter} of ``model``, in module order."""
    return {k: p for k, p, _ in _entries(model)}


def jax_param_shapes(model):
    """{jax_key: shape} of the checkpoint ``model`` loads."""
    return {k: tuple(p.shape) for k, p, _ in _entries(model)}


def load_params_npz(model, src):
    """Copy a JAX checkpoint into ``model`` and re-derive its compute
    weights. src: an ``.npz`` path or a dict of numpy arrays keyed like the
    JAX flat npz. Every parameter must be present with its exact shape, and
    no key may be left over."""
    data = np.load(src) if isinstance(src, str) else src
    entries = _entries(model)
    missing = [k for k, _, _ in entries if k not in data]
    extra = sorted(set(data.keys()) - {k for k, _, _ in entries})
    if missing or extra:
        raise KeyError(f"checkpoint mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for key, p, _ in entries:
            arr = np.asarray(data[key])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr.astype(np.float32)))
    model.prepare()
    return model


def save_params_npz(job_dir, model, name="models"):
    """Write ``model``'s parameters in the JAX flat-npz layout to
    ``<job_dir>/weights/<name>.npz``, as the JAX package's save_params_npz
    does (atomically: a temporary file, then a rename), so the weights load
    in either package. Returns the path."""
    out_dir = os.path.join(job_dir, "weights")
    os.makedirs(out_dir, exist_ok=True)
    flat = {k: p.detach().float().cpu().numpy() for k, p, _ in _entries(model)}
    final = os.path.join(out_dir, f"{name}.npz")
    tmp = final + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, final)
    return final


def random_jax_params(model, seed=0):
    """Seeded random weights in the JAX checkpoint layout, drawn with numpy
    from the JAX package's initializer families: conv kernels and biases
    Uniform(±1/sqrt(fan_in)) (torch's default), the ConvTranspose kernel
    truncated-normal with variance 1/fan_in (flax lecun_normal) and its bias
    zero; a WNConv's ``v`` Uniform(±1/sqrt(fan_in)), its ``g`` the constant
    ``g_init`` (or ||v|| per output channel when None) and its ``b`` zero;
    a bare parameter that its module lists in ``uniform_init`` (the NAS
    gates) Uniform(lo, hi)."""
    rng = np.random.default_rng(seed)
    entries = _entries(model)
    shapes = {k: tuple(p.shape) for k, p, _ in entries}
    out = {}
    for key, p, owner in entries:
        shape = tuple(p.shape)
        leaf = key.rpartition("/")[2]
        if leaf in getattr(owner, "uniform_init", {}):
            lo, hi = owner.uniform_init[leaf]
            out[key] = rng.uniform(lo, hi, shape).astype(np.float32)
            continue
        if isinstance(owner, WNConv):
            # entries list v before g (declaration order), so g can read it
            stem, _, name = key.rpartition("/")
            if name == "v":
                bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
                arr = rng.uniform(-bound, bound, shape)
            elif name == "g" and owner.g_init is None:
                v = out[stem + "/v" if stem else "v"].astype(np.float64)
                arr = np.sqrt(np.sum(v * v, axis=(0, 1, 2)))
            else:
                arr = np.full(shape, owner.g_init if name == "g" else 0.0)
            out[key] = arr.astype(np.float32)
            continue
        stem = key[: -len("bias")] if key.endswith("bias") else key[: -len("kernel")]
        fan_in = int(np.prod(shapes[stem + "kernel"][:-1]))
        if isinstance(owner, SubpixelConvTranspose):
            if key.endswith("bias"):
                arr = np.zeros(shape)
            else:
                arr = rng.standard_normal(shape)
                while (bad := np.abs(arr) > 2.0).any():
                    arr[bad] = rng.standard_normal(int(bad.sum()))
                arr *= np.sqrt(1.0 / fan_in) / 0.87962566103423978
        else:
            bound = 1.0 / np.sqrt(fan_in)
            arr = rng.uniform(-bound, bound, shape)
        out[key] = arr.astype(np.float32)
    return out


def _replace_atomically(write, final):
    """Write ``final`` through ``write(tmp)`` and a rename, so a kill
    mid-write leaves the previous file whole."""
    tmp = f"{final}.tmp.{os.getpid()}"
    write(tmp)
    os.replace(tmp, final)


class CheckpointManager:
    """Full training state per epoch in ``<job_dir>/ckpt/<epoch>.pt``: the
    model's parameters, the optimizer's Adam moments and counts
    (``MultiStepAdam.state_dict``), ``step`` (training steps taken),
    ``epoch`` and an optional ``extra`` dict (``batches_done`` of a
    mid-epoch save). Keeps the ``max_to_keep`` latest epochs; saves are
    atomic. ``run_meta.json`` pins the process count (always 1 here), and
    ``restore`` refuses a checkpoint written by another count, as the JAX
    package's manager does."""

    process_count = 1

    def __init__(self, job_dir, max_to_keep=3):
        self.job_dir = job_dir
        self.path = os.path.abspath(os.path.join(job_dir, "ckpt"))
        os.makedirs(self.path, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._meta_path = os.path.join(self.path, "run_meta.json")
        self._meta_written = False
        self.last_extra = None

    def _file(self, epoch):
        return os.path.join(self.path, f"{int(epoch)}.pt")

    def all_epochs(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.path) if (m := re.fullmatch(r"(\d+)\.pt", f)))

    def latest_epoch(self):
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def _write_run_meta(self):
        """The first save of a manager overwrites the sidecar, so a fresh run
        in an old job dir does not inherit a stale count."""
        if self._meta_written:
            return

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump({"process_count": self.process_count}, f)

        _replace_atomically(write, self._meta_path)
        self._meta_written = True

    def _check_run_meta(self):
        try:
            with open(self._meta_path) as f:
                saved = json.load(f).get("process_count")
        except (OSError, ValueError):
            return
        if saved is not None and saved != self.process_count:
            raise ValueError(
                f"checkpoint was written by a {saved}-process job but this run has {self.process_count} "
                "processes: the batch partition and the learning rate depend on the process count, so "
                f"resuming would change the training trajectory. Relaunch with the original count, or delete "
                f"{self._meta_path} to accept the change."
            )

    def save(self, epoch, model, optimizer, extra=None, force=False):
        """Save the state at ``epoch``. ``force=True`` overwrites a save of
        the same epoch (the end-of-epoch save after a mid-epoch one); without
        it an existing save raises."""
        final = self._file(epoch)
        if os.path.exists(final) and not force:
            raise FileExistsError(f"a checkpoint of epoch {epoch} exists: {final}")
        payload = {
            "params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "optimizer": optimizer.state_dict(),
            "step": int(optimizer.steps),
            "epoch": int(epoch),
        }
        if extra:
            payload["extra"] = dict(extra)
        self._write_run_meta()
        _replace_atomically(lambda tmp: torch.save(payload, tmp), final)
        for old in self.all_epochs()[: -self.max_to_keep]:
            os.remove(self._file(old))

    def _load(self, epoch):
        return torch.load(self._file(epoch), map_location="cpu", weights_only=True)

    def peek_extra(self, epoch):
        """The ``extra`` dict of a saved epoch, or None, without a model or
        an optimizer (the search's resume reads its batch position before
        the phase's optimizer exists)."""
        if epoch is None or epoch not in self.all_epochs():
            return None
        return self._load(epoch).get("extra")

    def restore(self, model, optimizer, epoch=None):
        """Load the save of ``epoch`` (default the latest) into ``model`` (its
        parameters, then ``prepare()``) and ``optimizer``; returns the saved
        epoch, or 0 when there is nothing to restore. ``last_extra`` holds
        the save's ``extra`` dict (None without one)."""
        target = self.latest_epoch() if epoch is None else epoch
        self.last_extra = None
        if target is None:
            return 0
        self._check_run_meta()
        payload = self._load(target)
        model.load_state_dict(payload["params"])
        model.prepare()
        optimizer.load_state_dict(payload["optimizer"])
        optimizer.steps = payload["step"]
        self.last_extra = payload.get("extra")
        return payload["epoch"]
