"""Shared CLI plumbing (counterpart of mobilesuperresolution_tpu/cli/common_cli.py).

Only the flags that evaluation reads are parsed. Flags that only concern
XLA or multi-host JAX (``--compile_cache``, ``--xla_profile_steps``,
``--distributed``, ``--coordinator_address``, ``--num_processes``,
``--process_id``) have no counterpart here; the training flags
(``--epochs``, ``--learning_rate``, batch sizes, ``--resume``, ...) come with
SISR training (ROADMAP.md, queue A10). ``--device`` picks CUDA (the
default) or the CPU.
"""

import argparse
import os

import mobilesuperresolution_tpu_torch.data as data_pkg
import mobilesuperresolution_tpu_torch.models as models_pkg


def base_parser(description):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--job_dir", type=str, required=True)
    parser.add_argument("--dataset", type=str, default="div2k")
    parser.add_argument("--eval_datasets", type=str, nargs="*", default=["set5"])
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the random weights used without --eval_model.")
    parser.add_argument("--eval_model", type=str, default=None,
                        help="Path to a params .npz (the JAX package's flat layout) "
                        "to evaluate.")
    parser.add_argument("--eval_only", action="store_true")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute.")
    parser.add_argument("--save_eval_images", action="store_true")
    parser.add_argument("--eval_tile", type=int, default=0,
                        help="Overlap-tiled evaluation. Only 0 (whole images) is "
                        "supported: tiling bounds XLA recompiles, and eager "
                        "PyTorch compiles nothing per shape.")
    parser.add_argument("--device", type=str, default=None,
                        help="'cuda' (default) or 'cpu'.")
    return parser


def parse_with_plugins(parser, argv=None):
    """Parse known args, let the dataset and model modules inject their
    flags, then re-parse (the reference's plugin idiom)."""
    known, _ = parser.parse_known_args(argv)
    data_pkg.get_dataset_module(known.dataset).update_argparser(parser)
    models_pkg.update_argparser(parser)
    params = parser.parse_args(argv)
    os.makedirs(params.job_dir, exist_ok=True)
    return params


def eval_modules(params):
    return [(name, data_pkg.get_dataset_module(name)) for name in params.eval_datasets]
