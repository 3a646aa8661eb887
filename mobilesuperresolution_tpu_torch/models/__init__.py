"""Model registry (counterpart of mobilesuperresolution_tpu/models/__init__.py).

The whole VSR zoo: mobile BasicVSR ('basic'), the faithful BasicVSR
('basic_origin'), motion-vector BasicVSR ('basic_mv'), the per-frame
'single' and the searched 'multi' and 'multi_v1'; and for SISR the WDSR-B
``BASIC_MODEL``, the NAS supernet ``NAS_MODEL`` and the searched
``ResultNet``.
"""

import torch

from mobilesuperresolution_tpu_torch.core.device import resolve_device
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR, BasicVSROrigin
from mobilesuperresolution_tpu_torch.models.mvvsr import MotionVectorVSR
from mobilesuperresolution_tpu_torch.models.naive_multi import NaiveMultiModel
from mobilesuperresolution_tpu_torch.models.naive_multi_v1 import NaiveMultiModelV1
from mobilesuperresolution_tpu_torch.models.result_net import ResultNet
from mobilesuperresolution_tpu_torch.models.single_image import SingleImageModel
from mobilesuperresolution_tpu_torch.models.spynet import SpyNet
from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel
from mobilesuperresolution_tpu_torch.models.wdsr_nas import NASModel
from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

__all__ = ["BasicModel", "BasicVSR", "BasicVSROrigin", "MotionVectorVSR", "NASModel", "NaiveMultiModel",
           "NaiveMultiModelV1", "ResultNet", "SingleImageModel", "SpyNet", "get_model", "get_vsr_model",
           "update_argparser"]


def update_argparser(parser):
    """SISR model flags, as the JAX package's models.update_argparser."""
    parser.add_argument("--model_type", default="BASIC_MODEL", type=str)
    parser.add_argument("--num_blocks", default=16, type=int)
    parser.add_argument("--num_residual_units", default=24, type=int)
    parser.add_argument("--width_search", action="store_true",
                        help="NAS_MODEL: apply the model-wide channel mask gate.")
    parser.add_argument("--differentiable_speed", action="store_true",
                        help="NAS_MODEL: STE-differentiable latency estimate "
                        "(the reference leaves it without gradient).")
    parser.add_argument("--pretrained", action="store_true",
                        help="cli.search: shape-greedy transfer from a reference WDSR-B checkpoint into the "
                        "supernet (head, tail, skip); needs --pretrained_path.")
    parser.add_argument("--pretrained_path", type=str, default=None,
                        help="Reference wdsr_b_x<scale>_<blocks>_<units>.pt checkpoint for --pretrained.")
    parser.add_argument("--quantize", choices=["none", "int8"], default="none",
                        help="int8 dynamic-range inference convs (the numerics class of the reference's int8 "
                        "TFLite deployment; kernel Q1 on the card). BASIC_MODEL, --eval_only runs only.")


def get_model(params, device=None):
    """Build the SISR model named by params.model_type on ``device`` (default
    CUDA; raises without it unless ``device="cpu"``), in bf16 when
    ``params.bf16``. ``BASIC_MODEL`` starts at zero, in eval mode: load
    weights with ``train.checkpoint.load_params_npz``. ``NAS_MODEL`` (the
    supernet, ``--width_search`` / ``--differentiable_speed``) is ready to
    train: seeded random weights from the JAX initializers
    (``random_jax_params``, seed ``params.seed``), train mode.
    ``params.quantize == "int8"`` builds the int8 dynamic-range WDSR-B
    (inference only); the supernet refuses it, as in the JAX package."""
    quantized = getattr(params, "quantize", "none") == "int8"
    if quantized and params.model_type != "BASIC_MODEL":
        raise ValueError("--quantize int8 applies to BASIC_MODEL (and ResultNet via retrain_searched); the NAS "
                         "supernet trains and must stay float")
    if params.model_type not in ("BASIC_MODEL", "NAS_MODEL"):
        raise KeyError(f"unknown SISR model_type {params.model_type!r}")
    dev = resolve_device(device)
    common = dict(
        num_blocks=params.num_blocks,
        num_residual_units=params.num_residual_units,
        scale=params.scale,
        compute_dtype=torch.bfloat16 if getattr(params, "bf16", False) else torch.float32,
    )
    if params.model_type == "NAS_MODEL":
        model = NASModel(
            width_search=getattr(params, "width_search", True),
            differentiable_speed=getattr(params, "differentiable_speed", False),
            **common,
        ).to(dev)
        load_params_npz(model, random_jax_params(model, getattr(params, "seed", 0)))
        return model.train()
    model = BasicModel(quantized=quantized, **common)
    model.to(dev).prepare()
    return model.eval()


def get_vsr_model(model_type="basic", scale=4, compute_dtype=torch.float32, device=None, flow_downscale=1,
                  remat=False, block_index_path=None, quantized=False):
    """Build a VSR model at the reference's canonical size on ``device``
    (default CUDA; raises without it unless ``device="cpu"``), in eval mode:
    'basic' (mobile BasicVSR, nf 24, 8 blocks), 'basic_origin' (the faithful
    BasicVSR, nf 64, 30 blocks, x4 only), 'basic_mv' (BasicVSR on codec
    motion vectors, nf 20, 8 blocks; input (B, T, H, W, 5)), 'single' (32
    channels, 8 blocks, k 3), or 'multi' / 'multi_v1' (the searched models of
    ``block_index_path``, a search's ``block_index.txt``). Parameters start
    at zero: load weights with ``train.checkpoint.load_params_npz`` (a JAX
    checkpoint, or ``random_jax_params`` for seeded random ones).
    ``flow_downscale`` d runs SpyNet on 1/d-res frames and upsamples the flow
    (1 = the reference's flows; 'basic', 'basic_origin' and 'multi');
    ``remat`` recomputes each propagation step in the backward (the
    recurrent 'basic', 'basic_origin' and 'basic_mv'). ``quantized``: int8
    dynamic-range inference convs (ops/quant.py, kernel Q1 on the card) in
    SpyNet and the trunks of the BasicVSR family, SpyNet, the encoder, the
    blocks and the decode of 'multi', the body of 'single'; the
    reconstructions stay float. The refusals are the JAX package's."""
    dev = resolve_device(device)  # before building: a missing card fails fast
    if flow_downscale < 1:
        raise ValueError(f"flow_downscale must be >= 1, got {flow_downscale}")
    if flow_downscale != 1 and model_type not in ("basic", "basic_origin", "multi"):
        raise ValueError(f"flow_downscale is only implemented for 'basic'/'basic_origin'/'multi', not "
                         f"{model_type!r}: 'single' and 'basic_mv' run no SpyNet at inference, and 'multi_v1' "
                         "does not implement it")
    if remat and model_type not in ("basic", "basic_mv", "basic_origin"):
        raise ValueError(f"remat applies to the recurrent BasicVSR family ('basic'/'basic_mv'/'basic_origin'), "
                         f"not {model_type!r}: 'single'/'multi' are frame-parallel (no temporal scan to "
                         "recompute) and 'multi_v1' does not implement it")
    if quantized and model_type == "multi_v1":
        raise ValueError("quantized int8 inference is not implemented for 'multi_v1' (historical per-block-carry "
                         "variant) — use 'multi'")
    q = dict(quantized=quantized)
    if model_type == "basic":
        model = BasicVSR(num_feat=24, num_block=8, scale=scale, compute_dtype=compute_dtype,
                         flow_downscale=flow_downscale, remat=remat, **q)
    elif model_type == "basic_origin":
        if scale != 4:
            raise ValueError(f"basic_origin is the faithful x4 BasicVSR: its reconstruction is two fixed "
                             f"depth_to_space(2) stages, so scale={scale} would compute at x4 and resample; use "
                             "'basic' for other scales")
        model = BasicVSROrigin(num_feat=64, num_block=30, scale=scale, compute_dtype=compute_dtype,
                               flow_downscale=flow_downscale, remat=remat, **q)
    elif model_type == "basic_mv":
        model = MotionVectorVSR(num_feat=20, num_block=8, scale=scale, compute_dtype=compute_dtype, remat=remat, **q)
    elif model_type == "single":
        model = SingleImageModel(scale=scale, channel=32, blocks=8, kernel=3, compute_dtype=compute_dtype, **q)
    elif model_type == "multi":
        if block_index_path is None:
            raise ValueError("'multi' needs block_index_path (search artifact)")
        model = NaiveMultiModel.from_artifact(block_index_path, scale=scale, compute_dtype=compute_dtype,
                                              flow_downscale=flow_downscale, **q)
    elif model_type == "multi_v1":
        if block_index_path is None:
            raise ValueError("'multi_v1' needs block_index_path (search artifact)")
        model = NaiveMultiModelV1.from_artifact(block_index_path, scale=scale, compute_dtype=compute_dtype)
    else:
        raise KeyError(f"unknown VSR model_type {model_type!r}")
    model.to(dev).prepare()
    return model.eval()
