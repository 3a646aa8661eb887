"""SISR pretraining entry (counterpart of mobilesuperresolution_tpu/cli/pretrain.py).

    python -m mobilesuperresolution_tpu_torch.cli.pretrain --job_dir runs/x2 \\
        --dataset div2k --eval_datasets set5 --scale 2 --num_blocks 16 \\
        --num_residual_units 24 --train_batch_size 16 --lr_patch_size 48 --epochs 30

Trains the WDSR-B ``BASIC_MODEL`` (``models.get_model``) from seeded random
weights (``--seed``) or a JAX flat-npz checkpoint (``--eval_model``): L1 loss,
Adam with the reference's MultiStepLR ([E/2, 9E/10] epochs, gamma 0.3) over
every parameter, shuffled drop-last batches made ahead in a thread, the
non-finite guard of ``train.steps``. After every epoch it scores the eval
sets and writes ``<job_dir>/weights/models.npz`` (the JAX package's layout),
and it appends the epoch's loss and eval metrics to
``<job_dir>/metrics.jsonl``; it checkpoints the full state after every
epoch (``train.checkpoint.CheckpointManager``), mid-epoch on a SIGTERM or
``--max_steps_per_run`` stop and every ``--checkpoint_every_steps`` steps,
and ``--resume`` continues from the latest save exactly. ``--eval_only``
evaluates the loaded weights instead. Runs on CUDA unless ``--device cpu``
is given; float32 convs run in full float32 (TF32 off, the caller's flags
restored after); ``--bf16`` computes in bfloat16. ``--eval_tile T`` scores
the eval sets in exact overlapping T x T tiles (train/eval_tiling.py);
``--quantize int8`` evaluates the int8 dynamic-range model (kernel Q1 on
the card) and needs ``--eval_only``.

Not ported (argparse refuses it): ``--spatial_shards`` (ROADMAP.md, queue
A8).
"""

import logging

import torch

import mobilesuperresolution_tpu_torch.data as data_pkg
from mobilesuperresolution_tpu_torch.cli.common_cli import (
    add_eval_args,
    add_train_args,
    base_parser,
    eval_modules,
    fit,
    parse_with_plugins,
    train_steps_per_epoch,
)
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.core.utils import attr_extractor
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
from mobilesuperresolution_tpu_torch.models import get_model
from mobilesuperresolution_tpu_torch.parallel.halo import receptive_radius_wdsr
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    jax_named_parameters,
    load_params_npz,
    random_jax_params,
)
from mobilesuperresolution_tpu_torch.train.eval_tiling import make_tiled_forward
from mobilesuperresolution_tpu_torch.train.evaluate import evaluate
from mobilesuperresolution_tpu_torch.train.state import multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

log = logging.getLogger("msr_torch.pretrain")


def _eval_radius(model):
    """The model's receptive radius (+ 2 to spare), from the model itself:
    a searched ResultNet from its blocks' kernels, WDSR-B from its depth.
    Too large costs time, never exactness."""
    if hasattr(model, "idx"):
        nb, k = len(model.idx), max(b[2] for b in model.idx)
    else:
        nb = model.num_blocks
        k = 3 if type(model).__name__ == "BasicModel" else 7
    return receptive_radius_wdsr(nb, block_kernel=k) + 2


def run_evaluation(params, model, eval_mods, device):
    """Evaluate ``model`` on every eval set, in ``params.eval_tile`` tiles
    when set; returns {set name: metrics}."""

    def whole(lr):
        with torch.inference_mode():
            return model(lr)

    fwd = whole
    if getattr(params, "eval_tile", 0):
        fwd = make_tiled_forward(whole, params.scale, _eval_radius(model), tile=params.eval_tile)

    def forward(lr, out_h, out_w):
        return fwd(lr)

    results = {}
    for name, mod in eval_mods:
        ds = mod.get_dataset(modes.EVAL, params)
        res = evaluate(
            forward, batch_iterator(ds), scale=params.scale, job_dir=params.job_dir,
            eval_data_name=name, save=params.save_eval_images, device=device,
        )
        results[name] = res.as_dict()
        log.info(f"{name}: " + "  ".join(f"{k}={v:.4f}" for k, v in results[name].items()))
    return results


def check_quantize(params):
    """int8 quantization is inference-only, as in the JAX package: round()
    has zero gradient almost everywhere, so a quantized forward would stop
    training silently."""
    if getattr(params, "quantize", "none") != "none" and not params.eval_only:
        raise SystemExit("--quantize is inference-only: add --eval_only")


def train_sisr(params, model, device):
    """Train ``model`` with ``make_sisr_step`` through ``common_cli.fit``:
    Adam with the reference's schedule over every parameter, the eval sets
    scored after every epoch. Returns ``fit``'s summary (``eval_images``
    counts the eval images)."""
    train_ds = data_pkg.get_dataset_module(params.dataset).get_dataset(modes.TRAIN, params)
    steps_per_epoch = train_steps_per_epoch(len(train_ds), params.train_batch_size)
    opt = multistep_adam(jax_named_parameters(model), params.learning_rate, steps_per_epoch, params.epochs)
    eval_mods = eval_modules(params)
    n_eval_images = sum(len(mod.get_dataset(modes.EVAL, params)) for _, mod in eval_mods)
    return fit(params, model, opt, make_sisr_step(model, opt), train_ds, device,
               lambda epoch: (run_evaluation(params, model, eval_mods, device), n_eval_images))


def main(argv=None):
    """Train (or with ``--eval_only`` evaluate) the SISR model; returns the
    training summary of ``train_sisr``, or {set name: metrics}."""
    parser = base_parser("SISR pretraining (PyTorch/CUDA)")
    add_train_args(parser)
    add_eval_args(parser)
    params = parse_with_plugins(parser, argv)
    LoggingTool(params.job_dir)
    log.info(attr_extractor(params))
    check_quantize(params)
    if not params.eval_only and params.model_type != "BASIC_MODEL":
        # the reference's pretrain crashes on the supernet (its model returns
        # (sr, speed)); the supernet trains in cli.search
        raise ValueError("pretrain trains BASIC_MODEL only: use cli.search for the NAS supernet and "
                         "cli.retrain_searched for the searched net")
    device = resolve_device(params.device)
    model = get_model(params, device=device)
    load_params_npz(model, params.eval_model or random_jax_params(model, params.seed))
    with no_tf32(), torch.autograd.set_detect_anomaly(params.debug):
        if params.eval_only:
            return run_evaluation(params, model.eval(), eval_modules(params), device)
        return train_sisr(params, model, device)


if __name__ == "__main__":
    main()
