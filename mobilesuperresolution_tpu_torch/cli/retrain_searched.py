"""Retrain the searched architecture from scratch (counterpart of
mobilesuperresolution_tpu/cli/retrain_searched.py).

    python -m mobilesuperresolution_tpu_torch.cli.retrain_searched --job_dir runs/retrain \\
        --block_index artifacts/search_depth_tpu/block_index.txt --dataset div2k \\
        --eval_datasets set5 --scale 2 --train_batch_size 16 --lr_patch_size 48 --epochs 30

Rebuilds ``ResultNet`` from the last line of a search's ``block_index.txt``
(or its job dir) and trains it as cli/pretrain.py trains WDSR-B: the same
step, schedule, data, per-epoch evaluation, weights npz and metrics.jsonl;
seeded random weights (``--seed``) or a JAX flat-npz checkpoint
(``--eval_model``), which ``--eval_only`` evaluates instead. Runs on CUDA
unless ``--device cpu`` is given; checkpoints, ``--resume`` and the
preemption flags as in cli/pretrain.py, and ``--eval_tile`` as there.
``--quantize int8`` evaluates the int8 dynamic-range net (kernel Q1 on the
card) and needs ``--eval_only``. ``--distributed`` trains one process per
card on its slice of every epoch (parallel/distributed.py), at the
unscaled learning rate as in the JAX package; the chief evaluates and
writes.
"""

import logging

import torch

from mobilesuperresolution_tpu_torch.cli.common_cli import (
    add_eval_args,
    add_train_args,
    base_parser,
    eval_modules,
    parse_with_plugins,
)
from mobilesuperresolution_tpu_torch.cli.pretrain import check_quantize, run_evaluation, train_sisr
from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.core.utils import attr_extractor
from mobilesuperresolution_tpu_torch.models import ResultNet
from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

log = logging.getLogger("msr_torch.retrain")


def main(argv=None):
    """Train (or with ``--eval_only`` evaluate) the searched net; returns the
    training summary of ``pretrain.train_sisr``, or {set name: metrics}."""
    parser = base_parser("Retrain the searched architecture (PyTorch/CUDA)")
    add_train_args(parser)
    add_eval_args(parser)
    parser.add_argument("--block_index", type=str, required=True,
                        help="Path to block_index.txt (or its job dir).")
    parser.add_argument("--quantize", choices=["none", "int8"], default="none",
                        help="int8 dynamic-range inference convs (kernel Q1 on the card); --eval_only runs "
                        "only.")
    params = parse_with_plugins(parser, argv, with_models=False)
    LoggingTool(params.job_dir)
    log.info(attr_extractor(params))
    check_quantize(params)
    device = resolve_device(params.device)
    dtype = torch.bfloat16 if params.bf16 else torch.float32
    model = ResultNet.from_artifact(params.block_index, scale=params.scale, compute_dtype=dtype,
                                    quantized=params.quantize == "int8").to(device)
    log.info(f"searched architecture: {model.idx}")
    load_params_npz(model, params.eval_model or random_jax_params(model, params.seed))
    with no_tf32(), torch.autograd.set_detect_anomaly(params.debug):
        if params.eval_only:
            return run_evaluation(params, model.eval(), eval_modules(params), device)
        return train_sisr(params, model, device)


if __name__ == "__main__":
    main()
