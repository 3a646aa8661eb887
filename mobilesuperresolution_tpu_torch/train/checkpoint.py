"""Weight bridge: JAX flat-npz checkpoints → the port's modules.

Counterpart of mobilesuperresolution_tpu/train/checkpoint.py::
load_params_npz. The JAX package writes its params tree as a flat npz keyed
by the flax path joined with '/', e.g. ``spynet/level_0/conv0_kernel``,
``propagation/trunks/backward_block0_conv1_kernel``,
``fusion/Conv_0/kernel``, ``conv_last/kernel``, and for the SISR models
``BasicBlock_3/WNConv_1/v`` (flax names modules by position: ``WNConv_0``
head, ``BasicBlock_{i}/WNConv_{0,1,2}``, ``WNConv_1`` tail, ``WNConv_2``
skip; ResultNet's ``head``, ``block_{i}/WNConv_0``, ``tail``, ``skip``). The
port keeps the same parameter names and layouts (HWIO kernels, the raw
ConvTranspose kernel, weight norm's ``v``/``g``/``b``), so a key maps to a
parameter by its module path; the only rename is flax's inner ``Conv_0``
scope of a ``PlainConv``.
"""

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


def random_jax_params(model, seed=0):
    """Seeded random weights in the JAX checkpoint layout, drawn with numpy
    from the JAX package's initializer families: conv kernels and biases
    Uniform(±1/sqrt(fan_in)) (torch's default), the ConvTranspose kernel
    truncated-normal with variance 1/fan_in (flax lecun_normal) and its bias
    zero; a WNConv's ``v`` Uniform(±1/sqrt(fan_in)), its ``g`` the constant
    ``g_init`` (or ||v|| per output channel when None) and its ``b`` zero."""
    rng = np.random.default_rng(seed)
    entries = _entries(model)
    shapes = {k: tuple(p.shape) for k, p, _ in entries}
    out = {}
    for key, p, owner in entries:
        shape = tuple(p.shape)
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
