"""VSR evaluation entry (counterpart of mobilesuperresolution_tpu/cli/test_vsr.py,
the reference's test_video_superresolution.py).

    python -m mobilesuperresolution_tpu_torch.cli.test_vsr --job_dir runs/eval \\
        --dataset reds --eval_datasets reds --eval_model runs/vsr/weights/models.npz

Scores a VSR model of any ``--model_type`` (basic_mv on 5-channel data,
``--dataset reds_with_mv``) on ``--eval_datasets`` as ``cli/train_vsr.py``
does after each epoch (whole clips, height-sharded ones with
``--spatial_shards``, ``--chunk_frames`` windows, ``--flow_cache``), with
the weights of ``--eval_model`` (an npz in the JAX package's flat layout, as
either package writes it, or a reference / mmedit ``.pt`` / ``.pth``
converted per model type by ``common_cli.load_vsr_eval_params``) or,
without one, seeded random ones. Returns {set name: metrics}. Runs on CUDA
unless ``--device cpu`` is given; the log goes to stdout and
``<job_dir>/result.log``. ``--quantize int8`` scores the int8 dynamic-range
model (kernel Q1 on the card). The flags of ``train_vsr.check_vsr_args``
are refused as there.
"""

import logging

from mobilesuperresolution_tpu_torch.cli.common_cli import base_parser, eval_modules, parse_with_plugins
from mobilesuperresolution_tpu_torch.cli.train_vsr import (
    add_vsr_args,
    build_vsr_model,
    check_vsr_args,
    run_vsr_evaluation,
)
from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.core.utils import attr_extractor

log = logging.getLogger("msr_torch.test_vsr")


def main(argv=None):
    parser = base_parser("VSR evaluation (PyTorch/CUDA)")
    parser.set_defaults(dataset="reds", eval_datasets=["reds"])
    parser.add_argument("--eval_model", type=str, default=None,
                        help="Weights to evaluate: a params .npz (the JAX package's flat layout) or a "
                        "reference/mmedit .pt/.pth checkpoint (converted).")
    add_vsr_args(parser)
    params = parse_with_plugins(parser, argv, with_models=False)
    LoggingTool(params.job_dir)
    log.info(attr_extractor(params))
    check_vsr_args(params)
    device = resolve_device(params.device)
    model = build_vsr_model(params, device)
    with no_tf32():
        return run_vsr_evaluation(params, model.eval(), eval_modules(params), 0, device)


if __name__ == "__main__":
    main()
