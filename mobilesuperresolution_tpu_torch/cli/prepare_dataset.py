"""Dataset-cache preparation entry (counterpart of
mobilesuperresolution_tpu/cli/prepare_dataset.py, the reference's
prepare_dataset.py): build a dataset's TRAIN and EVAL sets once so their
decoded-image caches exist before training.

    python -m mobilesuperresolution_tpu_torch.cli.prepare_dataset --job_dir runs/prep \\
        --dataset reds --data_dir data

Logs each split's item count ("not available" for a split the dataset does
not have) to stdout and ``<job_dir>/result.log``.
"""

import logging

from mobilesuperresolution_tpu_torch.cli.common_cli import add_train_args, base_parser, parse_with_plugins
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.data import get_dataset_module

log = logging.getLogger("msr_torch.prepare_dataset")


def main(argv=None):
    """Returns {split: item count, or None where the dataset lacks it}."""
    parser = base_parser("Build dataset caches")
    add_train_args(parser)
    params = parse_with_plugins(parser, argv, with_models=False)
    LoggingTool(params.job_dir)
    dataset_module = get_dataset_module(params.dataset)
    counts = {}
    for mode in (modes.TRAIN, modes.EVAL):
        try:
            ds = dataset_module.get_dataset(mode, params)
        except NotImplementedError:
            counts[mode] = None
            log.info(f"{params.dataset} [{mode}]: not available")
            continue
        if hasattr(ds, "prepare_cache"):
            ds.prepare_cache()
        counts[mode] = len(ds)
        log.info(f"{params.dataset} [{mode}]: {len(ds)} items cached")
    return counts


if __name__ == "__main__":
    main()
