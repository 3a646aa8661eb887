"""VSR training entry (counterpart of mobilesuperresolution_tpu/cli/train_vsr.py,
the reference's train_video_superresolution.py), one device.

    python -m mobilesuperresolution_tpu_torch.cli.train_vsr --job_dir runs/vsr \\
        --dataset reds --model_type basic --scale 4 --image_batch 10 --epochs 30 \\
        --train_batch_size 2 --lr_patch_size 64 --learning_rate 1e-4

Trains a VSR model (``get_vsr_model``: ``--model_type`` basic,
basic_origin, basic_mv, single, or multi / multi_v1 with ``--model_path``
its search's block_index.txt; basic_mv reads RGB + motion vectors, 5
channels, from ``--dataset reds_with_mv``) from seeded random weights
(``--seed``), a SpyNet npz or reference ``.pth`` (``--spynet_weights``,
for the SpyNet models) and optionally a whole-model npz (``--eval_model``):
Charbonnier loss, Adam betas (0.9, 0.99) with milestones [E/2, 8E/10] over every
parameter but SpyNet's, which stays frozen (its flows carry no gradient),
the non-finite guard of ``train.steps``, checkpoints and ``--resume`` as in
cli/pretrain.py. After every epoch it scores ``--eval_datasets`` (whole
clips, or windows of ``--chunk_frames`` through ``parallel/temporal.py``,
or with ``--flow_cache`` through ``serve/flow_cache.py``) and writes
``<job_dir>/weights/models.npz`` in the JAX package's layout.
``--eval_only`` evaluates instead. Runs on CUDA unless ``--device cpu`` is
given; float32 in full float32 (TF32 off), ``--bf16`` in bfloat16.
``--xla_profile_steps N`` traces the first N steps (core/profiling.py); the
log goes to stdout and ``<job_dir>/result.log``.

Not ported yet, and refused with the queue item of ROADMAP.md that brings
them: ``--spatial_shards`` > 1 and ``--chunk_data_parallel`` (A8).
``--quantize int8`` is inference-only (cli.test_vsr, cli.test_vsr_by_patch,
cli.serve) and refused here, as by the JAX trainer.
"""

import logging

import numpy as np
import torch

import mobilesuperresolution_tpu_torch.data as data_pkg
from mobilesuperresolution_tpu_torch.cli.common_cli import (
    add_eval_args,
    add_train_args,
    base_parser,
    eval_modules,
    fit,
    load_vsr_eval_params,
    parse_with_plugins,
    train_steps_per_epoch,
)
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.core.utils import attr_extractor
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
from mobilesuperresolution_tpu_torch.models import get_vsr_model
from mobilesuperresolution_tpu_torch.parallel.temporal import chunked_vsr_apply
from mobilesuperresolution_tpu_torch.serve.flow_cache import FlowCachedStreamingVSR, make_flow_sr_fns
from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, load_params_npz, random_jax_params
from mobilesuperresolution_tpu_torch.train.evaluate import evaluate
from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step
from mobilesuperresolution_tpu_torch.train.torch_convert import convert_spynet_state_dict, load_torch_checkpoint

log = logging.getLogger("msr_torch.train_vsr")


def add_vsr_args(parser):
    parser.add_argument("--model_type", default="basic",
                        choices=["single", "multi", "multi_v1", "basic", "basic_mv", "basic_origin"],
                        help="'basic_mv' takes 5-channel input (RGB + motion vectors: --dataset reds_with_mv).")
    parser.add_argument("--model_path", type=str, default=None,
                        help="block_index.txt for the 'multi' and 'multi_v1' models.")
    parser.add_argument("--spynet_weights", type=str, default=None,
                        help="Pretrained SpyNet params: an .npz keyed like the JAX package's spynet scope, or an "
                        "mmedit/reference .pth checkpoint (converted).")
    parser.add_argument("--chunk_frames", type=int, default=0,
                        help="Evaluate long clips in temporal windows of this many output frames (0 = whole "
                        "clip); propagation is truncated at window edges, so PSNR can differ slightly.")
    parser.add_argument("--chunk_overlap", type=int, default=4, help="Context frames on each side of a chunk window.")
    parser.add_argument("--chunk_data_parallel", action="store_true",
                        help="Windows over several devices (not ported yet: raises).")
    parser.add_argument("--flow_cache", action="store_true",
                        help="With --chunk_frames: compute each SpyNet pair flow once and reuse it across "
                        "overlapping windows (serve/flow_cache.py; 'basic' and 'basic_origin').")
    parser.add_argument("--spatial_shards", type=int, default=1,
                        help="Shard frame height over devices (not ported yet: > 1 raises).")
    parser.add_argument("--spatial_max_disp", type=int, default=8)
    parser.add_argument("--flow_downscale", type=int, default=1,
                        help="Run SpyNet on 1/d-res frames and upsample the flow (1 = the reference's flows).")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute each propagation step in the backward: O(1) activation memory in clip "
                        "length, the same gradients.")
    parser.add_argument("--quantize", choices=["none", "int8"], default="none",
                        help="int8 dynamic-range inference convs (kernel Q1 on the card): cli.test_vsr, "
                        "cli.test_vsr_by_patch and cli.serve; the trainer refuses it.")


def check_vsr_args(params):
    """Raise for the flags whose code is not ported yet, naming its queue."""
    if params.spatial_shards > 1:
        raise NotImplementedError("--spatial_shards (height-sharded VSR) is not ported yet (ROADMAP.md, queue A8)")
    if params.chunk_data_parallel:
        raise NotImplementedError("--chunk_data_parallel (windows over devices) is not ported yet "
                                  "(ROADMAP.md, queue A8)")


def _spynet_params(path):
    """SpyNet weights of ``path``: an npz of the flow network's scope, or a
    reference / mmedit ``.pth`` (its ``['params']`` if it has them, the
    ``spynet.`` prefix if its keys carry it) converted."""
    if not path.endswith((".pt", ".pth")):
        return path
    sd = load_torch_checkpoint(path)
    if "params" in sd:
        sd = sd["params"]
    prefix = "spynet." if any(k.startswith("spynet.") for k in sd) else ""
    return convert_spynet_state_dict(sd, prefix=prefix)


def build_vsr_model(params, device, spynet_weights=None):
    """The VSR model of ``params`` on ``device``, in eval mode, with seeded
    random weights (``params.seed``), then ``spynet_weights`` (the flow
    network's, ``spynet`` or ``flownet``: an npz or a ``.pth``) and
    ``params.eval_model`` if given (``common_cli.load_vsr_eval_params``: an
    npz, or a reference / mmedit ``.pt`` / ``.pth``)."""
    model = get_vsr_model(params.model_type, scale=params.scale,
                          compute_dtype=torch.bfloat16 if params.bf16 else torch.float32, device=device,
                          flow_downscale=params.flow_downscale, remat=getattr(params, "remat", False),
                          block_index_path=params.model_path,
                          quantized=getattr(params, "quantize", "none") == "int8")
    load_params_npz(model, random_jax_params(model, params.seed))
    if spynet_weights:
        flow_net = model.spynet if hasattr(model, "spynet") else getattr(model, "flownet", None)
        if flow_net is None:
            raise ValueError(f"--spynet_weights given but model_type {params.model_type!r} has no flow network "
                             "('single' is frame-parallel; 'basic_mv' takes flows from the bitstream)")
        load_params_npz(flow_net, _spynet_params(spynet_weights))
    if params.eval_model:
        load_vsr_eval_params(params.eval_model, params.model_type, model)
    return model


def run_vsr_evaluation(params, model, eval_mods, epoch, device):
    """Score ``model`` (eval mode, prepared weights) on every eval set:
    whole clips, or with ``--chunk_frames`` windows of it
    (``chunked_vsr_apply``), or with ``--flow_cache`` too the flow-cached
    stream; clips that fit one window run un-windowed. Returns {set name:
    metrics}."""

    def base_fwd(lr_clip, oh, ow):
        with torch.inference_mode():
            return model(lr_clip, oh, ow)

    fwd = base_fwd
    if params.chunk_frames and params.flow_cache:
        window = params.chunk_frames + 2 * params.chunk_overlap
        fns = {}

        def fwd(lr_clip, oh, ow):
            b, t = lr_clip.shape[:2]
            if t <= window:  # as chunked_vsr_apply: a clip that fits one window runs whole
                return base_fwd(lr_clip, oh, ow)
            if (oh, ow) not in fns:
                fns[(oh, ow)] = make_flow_sr_fns(model, oh, ow)
            stream = FlowCachedStreamingVSR(*fns[(oh, ow)], oh, ow, chunk=params.chunk_frames,
                                            overlap=params.chunk_overlap, num_streams=b, device=lr_clip.device)
            clip = lr_clip.cpu().numpy()
            out = []
            for i in range(t):
                out.extend(stream.push(clip[:, i]))
            out.extend(stream.flush())
            sr = np.stack(out)  # (T, OH, OW, C), or (T, B, OH, OW, C)
            return torch.from_numpy(sr[None] if b == 1 else np.moveaxis(sr, 0, 1)).to(lr_clip.device)

    elif params.chunk_frames:

        def fwd(lr_clip, oh, ow):
            return chunked_vsr_apply(base_fwd, lr_clip, oh, ow, chunk=params.chunk_frames,
                                     overlap=params.chunk_overlap)

    results = {}
    for name, mod in eval_mods:
        ds = mod.get_dataset(modes.EVAL, params)
        res = evaluate(fwd, batch_iterator(ds), scale=params.scale, job_dir=params.job_dir, eval_data_name=name,
                       save=params.save_eval_images, device=device)
        results[name] = res.as_dict()
        log.info(f"[epoch {epoch}] {name}: " + "  ".join(f"{k}={v:.4f}" for k, v in results[name].items()))
    return results


def train_vsr(params, model, device):
    """Train ``model`` with ``make_vsr_step`` through ``common_cli.fit``, on
    LR patches of ``--lr_patch_size`` (output ``lr_patch_size * scale``
    square); ``eval_clips`` counts the eval clips. Returns ``fit``'s
    summary."""
    train_ds = data_pkg.get_dataset_module(params.dataset).get_dataset(modes.TRAIN, params)
    steps_per_epoch = train_steps_per_epoch(len(train_ds), params.train_batch_size)
    named = jax_named_parameters(model)
    opt = vsr_multistep_adam(named, params.learning_rate, steps_per_epoch, params.epochs,
                             trainable_mask=spynet_frozen_mask(named))
    out = params.lr_patch_size * params.scale
    eval_mods = eval_modules(params)
    n_clips = sum(len(mod.get_dataset(modes.EVAL, params)) for _, mod in eval_mods)
    return fit(params, model, opt, make_vsr_step(model, opt, (out, out)), train_ds, device,
               lambda epoch: (run_vsr_evaluation(params, model, eval_mods, epoch, device), n_clips),
               eval_key="eval_clips")


def main(argv=None):
    """Train (or with ``--eval_only`` evaluate) the VSR model; returns the
    training summary of ``train_vsr``, or {set name: metrics}."""
    parser = base_parser("VSR training (PyTorch/CUDA)")
    parser.set_defaults(dataset="reds", eval_datasets=[])
    add_train_args(parser)
    add_eval_args(parser, tile=False)
    add_vsr_args(parser)
    params = parse_with_plugins(parser, argv, with_models=False)
    LoggingTool(params.job_dir)
    log.info(attr_extractor(params))
    if params.quantize != "none":
        raise SystemExit("--quantize is inference-only (use test_vsr / serve); training runs the exact float "
                         "path like the reference")
    check_vsr_args(params)
    if params.eval_model and params.eval_model.endswith((".pt", ".pth")):
        # the JAX trainer initializes from an npz only; cli.test_vsr
        # evaluates torch checkpoints
        raise ValueError("cli.train_vsr's --eval_model is a params npz; evaluate a torch checkpoint with "
                         "cli.test_vsr, or convert it to an npz first")
    device = resolve_device(params.device)
    model = build_vsr_model(params, device, params.spynet_weights)
    with no_tf32(), torch.autograd.set_detect_anomaly(params.debug):
        if params.eval_only:
            return run_vsr_evaluation(params, model.eval(), eval_modules(params), 0, device)
        return train_vsr(params, model, device)


if __name__ == "__main__":
    main()
