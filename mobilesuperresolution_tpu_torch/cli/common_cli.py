"""Shared CLI plumbing (counterpart of mobilesuperresolution_tpu/cli/common_cli.py).

Only flags that ported code reads are parsed; each entry point adds its own.
Flags that only concern XLA or multi-host JAX (``--compile_cache``,
``--xla_profile_steps``, ``--distributed``, ``--coordinator_address``,
``--num_processes``, ``--process_id``) have no counterpart here;
``--resume``, ``--max_steps_per_run``, ``--checkpoint_every_steps`` and
``--debug`` come with checkpointing and preemption (ROADMAP.md, queue A3),
so argparse refuses them. ``--device`` picks CUDA (the default) or the CPU.
"""

import argparse
import os

import mobilesuperresolution_tpu_torch.data as data_pkg
import mobilesuperresolution_tpu_torch.models as models_pkg
from mobilesuperresolution_tpu_torch.data import isr


def train_steps_per_epoch(n_items, batch_size):
    """Optimizer steps per epoch: one process, batches with drop_last (the
    LR schedule's milestones count these)."""
    return max(n_items // batch_size, 1)


def base_parser(description):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--job_dir", type=str, required=True)
    parser.add_argument("--dataset", type=str, default="div2k")
    parser.add_argument("--eval_datasets", type=str, nargs="*", default=["set5"])
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the random weights and of the training data order.")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute.")
    parser.add_argument("--save_eval_images", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="'cuda' (default) or 'cpu'.")
    return parser


def add_train_args(parser):
    """Training flags, and the TRAIN data flags (``data/isr.py``); call
    before ``parse_with_plugins`` so the dataset's defaults apply."""
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    isr.add_train_args(parser)


def add_eval_args(parser):
    """The flags of the SISR entry points that evaluate or train one model
    (cli/pretrain.py, cli/retrain_searched.py)."""
    parser.add_argument("--eval_model", type=str, default=None,
                        help="Path to a params .npz (the JAX package's flat layout) to evaluate or "
                        "initialize from.")
    parser.add_argument("--eval_only", action="store_true")
    parser.add_argument("--eval_tile", type=int, default=0,
                        help="Overlap-tiled evaluation. Only 0 (whole images) is supported: tiling "
                        "bounds XLA recompiles, and eager PyTorch compiles nothing per shape.")


def parse_with_plugins(parser, argv=None, with_models=True):
    """Parse known args, let the dataset and (``with_models``) model modules
    inject their flags, then re-parse (the reference's plugin idiom)."""
    known, _ = parser.parse_known_args(argv)
    data_pkg.get_dataset_module(known.dataset).update_argparser(parser)
    if with_models:
        models_pkg.update_argparser(parser)
    params = parser.parse_args(argv)
    os.makedirs(params.job_dir, exist_ok=True)
    return params


def eval_modules(params):
    return [(name, data_pkg.get_dataset_module(name)) for name in params.eval_datasets]
