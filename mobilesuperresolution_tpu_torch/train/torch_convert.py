"""Reference and mmedit torch checkpoints → the JAX package's flat-npz
layout (counterpart of mobilesuperresolution_tpu/train/torch_convert.py).

Each converter maps a reference state dict (OIHW conv weights, weight
norm's ``weight_v`` / ``weight_g`` (O, 1, 1, 1) / ``bias``) to the flat dict
``train.checkpoint.load_params_npz`` takes: keys are the flax paths joined
with '/', kernels HWIO, ``g`` (O,). So a reference checkpoint loads into
the port's models through the same bridge as a JAX checkpoint, and the
models do not change. Dead reference modules (layers its forward never
calls) are dropped, as the JAX package drops them.
"""

import numpy as np
import torch


def load_torch_checkpoint(path):
    """``torch.load`` on the CPU: with ``weights_only=True`` first, then, for
    the mmedit checkpoints that pickle non-tensor entries (meta, config),
    a full unpickle. Load only files you trust."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return torch.load(path, map_location="cpu", weights_only=False)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _k(w):
    """OIHW torch conv weight → HWIO kernel."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _conv(entry_v, entry_g, entry_b):
    return {"v": _k(entry_v), "g": np.asarray(entry_g).reshape(-1), "b": np.asarray(entry_b)}


def _wn(sd, prefix):
    """A weight-normed conv triple → WNConv {v, g, b}."""
    return _conv(sd[f"{prefix}.weight_v"], sd[f"{prefix}.weight_g"], sd[f"{prefix}.bias"])


def _plain(sd, prefix):
    """A plain torch conv → {kernel, bias}."""
    return {"kernel": _k(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])}


def _convtranspose(sd, prefix):
    """torch ConvTranspose2d weight (Cin, Cout, kh, kw) → the
    SubpixelConvTranspose {kernel (kh, kw, Cin, Cout), bias}, spatially
    flipped: torch's transpose conv indexes W[o - s·i] where the VALID form
    indexes W[K-1-(o-s·i)] (ops/layers.py::subpixel_transpose_kernel)."""
    w = np.asarray(sd[f"{prefix}.weight"])
    return {"kernel": np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _arrays(state_dict):
    return {k: _np(v) for k, v in state_dict.items()}


def convert_wdsr_basic_state_dict(state_dict):
    """Reference WDSR-B (``head``, ``body.<i>.body.{0,2,3}``, ``tail``,
    ``skip.0``) → (flat params of ``models.wdsr_basic.BasicModel``, number
    of blocks)."""
    sd = _arrays(state_dict)
    params = {"WNConv_0": _wn(sd, "head")}
    i = 0
    while f"body.{i}.body.0.weight_v" in sd:
        params[f"BasicBlock_{i}"] = {f"WNConv_{j}": _wn(sd, f"body.{i}.body.{layer}")
                                     for j, layer in enumerate((0, 2, 3))}
        i += 1
    params["WNConv_1"] = _wn(sd, "tail")
    if "skip.0.weight_v" in sd:
        params["WNConv_2"] = _wn(sd, "skip.0")
    return _flatten(params), i


def load_reference_wdsr(path):
    """A reference WDSR-B ``.pt`` → (flat params, num_blocks,
    num_residual_units)."""
    sd = load_torch_checkpoint(path)
    params, num_blocks = convert_wdsr_basic_state_dict(sd)
    return params, num_blocks, int(sd["head.weight_v"].shape[0])


def _spynet(sd, prefix):
    out = {}
    level = 0
    while f"{prefix}basic_module.{level}.basic_module.0.weight" in sd:
        lp = {}
        for j in range(5):
            lp[f"conv{j}_kernel"] = _k(sd[f"{prefix}basic_module.{level}.basic_module.{2 * j}.weight"])
            lp[f"conv{j}_bias"] = np.asarray(sd[f"{prefix}basic_module.{level}.basic_module.{2 * j}.bias"])
        out[f"level_{level}"] = lp
        level += 1
    if level == 0:
        # an empty tree would surface later as a missing-key error far from
        # the cause ('module.'-prefixed DataParallel or whole-mmedit files)
        raise ValueError(f"no SpyNet keys matched prefix {prefix!r} — checkpoint keys look like {sorted(sd)[:3]}; "
                         f"expected '{prefix}basic_module.<level>.basic_module.<2j>.weight'")
    return out


def convert_spynet_state_dict(sd, prefix="spynet."):
    """Reference SpyNet names (``<prefix>basic_module.<level>.basic_module.
    <2j>.{weight,bias}``, level 0 the coarsest) → flat params of
    ``models.spynet.SpyNet`` (``level_<i>/conv<j>_{kernel,bias}``)."""
    return _flatten(_spynet(_arrays(sd), prefix))


def _trunks(sd):
    trunks = {}
    num_block = 0
    for d in ("backward", "forward"):
        trunks[f"{d}_conv0_kernel"] = _k(sd[f"{d}_trunk.main.0.weight"])
        trunks[f"{d}_conv0_bias"] = np.asarray(sd[f"{d}_trunk.main.0.bias"])
        i = 0
        while f"{d}_trunk.main.2.{i}.conv1.weight" in sd:
            for c in ("conv1", "conv2"):
                trunks[f"{d}_block{i}_{c}_kernel"] = _k(sd[f"{d}_trunk.main.2.{i}.{c}.weight"])
                trunks[f"{d}_block{i}_{c}_bias"] = np.asarray(sd[f"{d}_trunk.main.2.{i}.{c}.bias"])
            i += 1
        num_block = i
    return {"trunks": trunks}, num_block


def convert_basicvsr_origin_state_dict(state_dict):
    """Reference BasicVSR_origin (also mmedit's, under ``['params']``) →
    (flat params of ``models.basicvsr.BasicVSROrigin``, num_block):
    ``spynet.*`` → ``spynet/level_i``, ``{backward,forward}_trunk`` →
    ``propagation/trunks/<dir>_...`` and ``fusion``, ``upconv1``,
    ``upconv2``, ``conv_hr``, ``conv_last`` → the same-named plain convs."""
    sd = _arrays(state_dict)
    params = {"spynet": _spynet(sd, "spynet.")}
    params["propagation"], num_block = _trunks(sd)
    for name in ("fusion", "upconv1", "upconv2", "conv_hr", "conv_last"):
        params[name] = {"Conv_0": _plain(sd, name)}
    return _flatten(params), num_block


def convert_single_image_state_dict(state_dict):
    """Reference 'single' Result_Model → (flat params of
    ``models.single_image.SingleImageModel``, blocks, channel). Its
    ``skip`` conv and ``img_upsample`` are dead in its forward and
    dropped."""
    sd = _arrays(state_dict)
    params = {"encoder": _wn(sd, "encoder")}
    i = 0
    while f"body.{i}.body.0.body.0.weight_v" in sd:
        params[f"block_{i}"] = {"WNConv_0": _wn(sd, f"body.{i}.body.0.body.0"),
                                "WNConv_1": _wn(sd, f"body.{i}.body.0.body.2")}
        i += 1
    if i == 0:
        raise ValueError(f"no 'single' block keys matched; keys look like {sorted(sd)[:3]}")
    params["body_tail"] = _wn(sd, f"body.{i}")
    params["shuf"] = _convtranspose(sd, "shuf.0")
    return _flatten(params), i, int(sd["encoder.weight_v"].shape[0])


def convert_naive_multi_state_dict(state_dict):
    """Reference 'multi' Naive_model → (flat params of
    ``models.naive_multi.NaiveMultiModel``, num_blocks). Its per-block
    ``skip`` 1x1 and top-level ``skip`` 5x5 are dead and dropped."""
    sd = _arrays(state_dict)
    params = {"flownet": _spynet(sd, "flownet."), "encode": _wn(sd, "encode"), "decode": _wn(sd, "decode")}
    i = 0
    while f"body.{i}.body.0.weight" in sd:
        params[f"block_{i}"] = {"PlainConv_0": {"Conv_0": _plain(sd, f"body.{i}.body.0")},
                                "PlainConv_1": {"Conv_0": _plain(sd, f"body.{i}.body.2")}}
        i += 1
    if i == 0:
        raise ValueError(f"no 'multi' block keys matched; keys look like {sorted(sd)[:3]}")
    return _flatten(params), i


def convert_mvvsr_state_dict(state_dict):
    """Reference MotionVectorVSR → (flat params of
    ``models.mvvsr.MotionVectorVSR``, num_block). Its ``spynet`` (flows come
    from the bitstream) and ``upconv1``, ``upconv2``, ``conv_hr`` (out of
    its forward) are dropped."""
    sd = _arrays(state_dict)
    propagation, num_block = _trunks(sd)
    params = {"propagation": propagation, "fusion": {"Conv_0": _plain(sd, "fusion")},
              "conv_last": _convtranspose(sd, "conv_last")}
    return _flatten(params), num_block


def load_pretrained_supernet(nas_params, state_dict):
    """Shape-greedy pretrained transfer into the NAS supernet, by name: the
    reference copies a WDSR-B checkpoint's tensors wherever the shapes
    match, which with its checkpoints lands exactly the head, tail and skip
    weight-normed convs (the split-branch blocks never match). nas_params:
    the supernet's flat params. Returns (new flat params, tensors
    copied)."""
    sd = _arrays(state_dict)
    mapping = {"head": "head", "tail": "tail", "skip": "skip.0"}
    if "skip.weight_v" in sd:  # NAS-style checkpoints name it bare 'skip'
        mapping["skip"] = "skip"
    new = dict(nas_params)
    copied = 0
    for ours, theirs in mapping.items():
        if f"{theirs}.weight_v" not in sd or f"{ours}/v" not in new:
            continue
        cand = _wn(sd, theirs)
        if all(cand[t].shape == np.asarray(nas_params[f"{ours}/{t}"]).shape for t in ("v", "g", "b")):
            new.update({f"{ours}/{t}": cand[t] for t in ("v", "g", "b")})
            copied += 3
    return new, copied
