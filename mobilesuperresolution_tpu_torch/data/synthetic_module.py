"""Registry adapter for the synthetic SISR dataset (tests, smoke runs), as
mobilesuperresolution_tpu/data/synthetic_module.py binds ``synthetic_isr``."""

from types import SimpleNamespace

from mobilesuperresolution_tpu_torch.data import isr as _isr
from mobilesuperresolution_tpu_torch.data.synthetic import SyntheticISRDataset


def bind(name):
    if name != "synthetic_isr":
        raise KeyError(f"the port has no synthetic dataset {name!r} yet (ROADMAP.md)")
    return SimpleNamespace(name=name, update_argparser=_isr.update_argparser, get_dataset=SyntheticISRDataset)
