"""Registry adapters for the synthetic datasets (tests, smoke runs), as
mobilesuperresolution_tpu/data/synthetic_module.py binds ``synthetic_isr``
and ``synthetic_vsr``. The size flags are the port's own; their defaults
make the JAX package's datasets (8 images of 128x128; 2 clips of 6 frames of
96x96), and ``--synthetic_size`` also takes HxW."""

from types import SimpleNamespace

from mobilesuperresolution_tpu_torch.data import isr as _isr
from mobilesuperresolution_tpu_torch.data import vsr as _vsr
from mobilesuperresolution_tpu_torch.data.synthetic import SyntheticISRDataset, SyntheticVSRDataset


def _update_isr_argparser(parser):
    _isr.update_argparser(parser)
    parser.add_argument("--synthetic_textured", type=lambda v: v.lower() != "false", default=True,
                        help="False = noise-free synthetic images (fully learnable).")
    parser.add_argument("--synthetic_size", type=str, default="128",
                        help="HR image size: one number (square) or HxW.")
    parser.set_defaults(num_patches=4, train_batch_size=8)


def _update_vsr_argparser(parser):
    _vsr.update_argparser(parser)
    parser.add_argument("--synthetic_clips", type=int, default=2)
    parser.add_argument("--synthetic_frames", type=int, default=6)
    parser.add_argument("--synthetic_size", type=str, default="96",
                        help="HR frame size: one number (square) or HxW, e.g. 720x1280 (REDS's).")
    # the patch must fit inside the 24x24 LR frames with the sampler's 2-px margin
    parser.set_defaults(num_patches=2, train_batch_size=2, lr_patch_size=16)


def _frame_size(text):
    """'96' → (96, 96); '720x1280' → (720, 1280)."""
    h, _, w = str(text).partition("x")
    return int(h), int(w or h)


def _isr_dataset(mode, params):
    return SyntheticISRDataset(mode, params, hw=_frame_size(getattr(params, "synthetic_size", "128")))


def _vsr_dataset(mode, params):
    hw = _frame_size(getattr(params, "synthetic_size", "96"))
    return SyntheticVSRDataset(mode, params, num_clips=getattr(params, "synthetic_clips", 2),
                               frames=getattr(params, "synthetic_frames", 6), hw=hw)


def bind(name):
    if name == "synthetic_isr":
        return SimpleNamespace(name=name, update_argparser=_update_isr_argparser, get_dataset=_isr_dataset)
    if name == "synthetic_vsr":
        return SimpleNamespace(name=name, update_argparser=_update_vsr_argparser, get_dataset=_vsr_dataset)
    raise KeyError(f"the port has no synthetic dataset {name!r}")
