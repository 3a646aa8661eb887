"""Model registry (counterpart of mobilesuperresolution_tpu/models/__init__.py).

Ported so far: mobile BasicVSR ('basic') for VSR, and for SISR the WDSR-B
``BASIC_MODEL`` and the searched ``ResultNet``; the NAS supernet and the
rest of the VSR zoo are queued in ROADMAP.md.
"""

import torch

from mobilesuperresolution_tpu_torch.core.device import resolve_device
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
from mobilesuperresolution_tpu_torch.models.result_net import ResultNet
from mobilesuperresolution_tpu_torch.models.spynet import SpyNet
from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel

__all__ = ["BasicModel", "BasicVSR", "ResultNet", "SpyNet", "get_model", "get_vsr_model", "update_argparser"]


def update_argparser(parser):
    """SISR model flags, as the JAX package's models.update_argparser."""
    parser.add_argument("--model_type", default="BASIC_MODEL", type=str)
    parser.add_argument("--num_blocks", default=16, type=int)
    parser.add_argument("--num_residual_units", default=24, type=int)
    parser.add_argument("--quantize", choices=["none", "int8"], default="none",
                        help="int8 dynamic-range inference convs (not ported yet: raises).")


def get_model(params, device=None):
    """Build the SISR model named by params.model_type on ``device`` (default
    CUDA; raises without it unless ``device="cpu"``), in bf16 when
    ``params.bf16``. Parameters start at zero: load weights with
    ``train.checkpoint.load_params_npz``."""
    if getattr(params, "quantize", "none") == "int8":
        raise NotImplementedError("int8 quantized convs are not ported yet (ROADMAP.md, queue A12)")
    if params.model_type == "NAS_MODEL":
        raise NotImplementedError("NAS_MODEL is not ported yet (ROADMAP.md, queue A11: the NAS slice)")
    if params.model_type != "BASIC_MODEL":
        raise KeyError(f"unknown SISR model_type {params.model_type!r}")
    dev = resolve_device(device)
    model = BasicModel(
        num_blocks=params.num_blocks,
        num_residual_units=params.num_residual_units,
        scale=params.scale,
        compute_dtype=torch.bfloat16 if getattr(params, "bf16", False) else torch.float32,
    )
    model.to(dev).prepare()
    return model.eval()


def get_vsr_model(model_type="basic", scale=4, compute_dtype=torch.float32, device=None):
    """Build a VSR model at the reference's canonical size on ``device``
    (default CUDA; raises without it unless ``device="cpu"``). Parameters
    start at zero: load weights with ``train.checkpoint.load_params_npz``
    (a JAX checkpoint, or ``random_jax_params`` for seeded random ones)."""
    if model_type != "basic":
        raise NotImplementedError(
            f"VSR model {model_type!r} is not ported yet (ROADMAP.md, queue A); "
            "only 'basic' is"
        )
    dev = resolve_device(device)
    model = BasicVSR(num_feat=24, num_block=8, scale=scale, compute_dtype=compute_dtype)
    model.to(dev).prepare()
    return model.eval()
