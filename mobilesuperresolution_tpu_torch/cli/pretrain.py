"""SISR evaluation entry (counterpart of the ``--eval_only`` path of
mobilesuperresolution_tpu/cli/pretrain.py).

    python -m mobilesuperresolution_tpu_torch.cli.pretrain --job_dir runs/eval \\
        --eval_only --eval_model artifacts/convergence/wdsr_b_x2/weights/models.npz \\
        --num_blocks 8 --dataset div2k --eval_datasets set5 set14 --scale 2

Builds the WDSR-B ``BASIC_MODEL`` (``models.get_model``), loads a JAX
flat-npz checkpoint through the weight bridge (seeded random weights without
``--eval_model``), runs every eval set through ``train.evaluate`` and logs
PSNR, PSNR_Y, SSIM, the bilinear baseline and the Charbonnier loss per set.
Runs on CUDA unless ``--device cpu`` is given. A float32 evaluation runs its
convs in full float32: TF32 is off for cuDNN and matmuls while it runs, and
the caller's settings are restored after. Training (the rest of the JAX
entry) is not ported yet and raises.
"""

import logging

import torch

from mobilesuperresolution_tpu_torch.cli.common_cli import base_parser, eval_modules, parse_with_plugins
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
from mobilesuperresolution_tpu_torch.models import get_model
from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params
from mobilesuperresolution_tpu_torch.train.evaluate import evaluate

log = logging.getLogger("msr_torch.pretrain")


def run_evaluation(params, model, eval_mods, device):
    """Evaluate ``model`` on every eval set; returns {set name: metrics}."""

    def forward(lr, out_h, out_w):
        with torch.inference_mode():
            return model(lr)

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


def main(argv=None):
    parser = base_parser("SISR pretraining (PyTorch/CUDA; evaluation only so far)")
    parser.add_argument("--eval_model", type=str, default=None,
                        help="Path to a params .npz (the JAX package's flat layout) to evaluate.")
    parser.add_argument("--eval_only", action="store_true")
    parser.add_argument("--eval_tile", type=int, default=0,
                        help="Overlap-tiled evaluation. Only 0 (whole images) is "
                        "supported: tiling bounds XLA recompiles, and eager "
                        "PyTorch compiles nothing per shape.")
    params = parse_with_plugins(parser, argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
    if not params.eval_only:
        raise NotImplementedError("SISR training is not ported yet (ROADMAP.md, queue A10); pass --eval_only")
    if params.eval_tile:
        raise NotImplementedError(
            "--eval_tile bounds XLA recompiles for mixed-shape eval sets; eager PyTorch "
            "compiles nothing per shape, so the port evaluates whole images only"
        )
    device = resolve_device(params.device)
    model = get_model(params, device=device)
    load_params_npz(model, params.eval_model or random_jax_params(model, params.seed))
    with no_tf32():
        return run_evaluation(params, model, eval_modules(params), device)


if __name__ == "__main__":
    main()
