"""Registry adapter for the synthetic SISR dataset (tests, smoke runs), as
mobilesuperresolution_tpu/data/synthetic_module.py binds ``synthetic_isr``."""

from types import SimpleNamespace

from mobilesuperresolution_tpu_torch.data import isr as _isr
from mobilesuperresolution_tpu_torch.data.synthetic import SyntheticISRDataset


def _update_argparser(parser):
    _isr.update_argparser(parser)
    parser.add_argument("--synthetic_textured", type=lambda v: v.lower() != "false", default=True,
                        help="False = noise-free synthetic images (fully learnable).")
    parser.set_defaults(num_patches=4, train_batch_size=8)


def bind(name):
    if name != "synthetic_isr":
        raise KeyError(f"the port has no synthetic dataset {name!r} yet (ROADMAP.md)")
    return SimpleNamespace(name=name, update_argparser=_update_argparser, get_dataset=SyntheticISRDataset)
