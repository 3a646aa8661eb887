"""VSR patch-tiled evaluation with per-patch variation statistics
(counterpart of mobilesuperresolution_tpu/cli/test_vsr_by_patch.py, the
reference's test_video_superresolution_by_patch.py).

    python -m mobilesuperresolution_tpu_torch.cli.test_vsr_by_patch --job_dir runs/patch \\
        --dataset reds --eval_datasets reds --model_type basic --scale 4 --image_batch 10 \\
        --patch_h 64 --patch_w 64 --overlap_h 4 --overlap_w 0 --eval_model runs/vsr/weights/models.npz

Tiles each LR clip into ``--patch_h`` x ``--patch_w`` patches (rows step
``patch_h - overlap_h``, columns ``patch_w - overlap_w``, in raster order),
runs ``--patch_batch`` patches per forward (the last chunk padded by
repeating its last patch), records per patch-frame [spatial total
variation, temporal variation, PSNR (shave 4), bilinear-base PSNR] (the
variations over every input channel, motion vectors too for basic_mv; the
bilinear base from the RGB channels) and saves
the 4xN array to ``<job_dir>/run/<model_type>_<patch_h>_<patch_w>_2.npy``
(``analysis/patch_stats.py`` reads it). Runs on CUDA unless ``--device cpu``
is given. ``--data_parallel`` splits each patch batch over the data slots
of the process (parallel/mesh.py: the visible cards of a one-process job,
slot ``i`` on card ``(own + i) mod n``; one slot in a process group or on
the CPU), ``--patch_batch`` rounded up to a multiple of them and by default
equal to their number; ``--chunk_frames`` and ``--spatial_shards`` are
refused, as the patch already bounds the memory. ``--quantize int8`` evaluates the int8 dynamic-range
model (kernel Q1 on the card), each patch batch quantized per sample.
"""

import logging
import os

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.cli.common_cli import base_parser, eval_modules, parse_with_plugins
from mobilesuperresolution_tpu_torch.cli.train_vsr import add_vsr_args, build_vsr_model, check_vsr_args, replica_forward
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.core.utils import attr_extractor
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
from mobilesuperresolution_tpu_torch.metrics import psnr
from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear
from mobilesuperresolution_tpu_torch.parallel.mesh import make_mesh

log = logging.getLogger("msr_torch.test_vsr_by_patch")


def total_variation(clip):
    """clip: (B, T, H, W, C) → (B·T,) anisotropic total variation, the last
    row and column replicated."""
    b, t, h, w, c = clip.shape
    img = clip.reshape(b * t, h, w, c)
    pad = torch.cat([img, img[:, -1:]], dim=1)
    pad = torch.cat([pad, pad[:, :, -1:]], dim=2)
    return torch.sum((pad[:, 1:, :-1] - img).abs() + (pad[:, :-1, 1:] - img).abs(), dim=(1, 2, 3))


def time_variation(clip):
    """clip: (B, T, H, W, C) → (B·T,): each frame difference's magnitude
    added to both of its frames, doubled at the clip's first and last."""
    b, t = clip.shape[:2]
    d = torch.sum((clip[:, 1:] - clip[:, :-1]).abs(), dim=(2, 3, 4)).float()  # (B, T-1)
    tv = d.new_zeros((b, t))
    tv[:, :-1] += d
    tv[:, 1:] += d
    tv[:, 0] *= 2.0
    tv[:, -1] *= 2.0
    return tv.reshape(b * t)


def patch_positions(h, w, patch, overlap):
    """Top-left corners of the patches of an h x w frame, in raster order."""
    (ph, pw), (oh, ow) = patch, overlap
    return [(sh, sw) for sh in range(0, h - ph + 1, ph - oh) for sw in range(0, w - pw + 1, pw - ow)]


def evaluate_by_patch(forward_fn, batches, scale, patch=(64, 64), overlap=(4, 0), patch_batch=None, device=None,
                      mesh=None):
    """forward_fn(x (P·B, T, ph, pw, C), out_h, out_w) → (P·B, T, out_h,
    out_w, C), run on whichever device x lies on. ``batches`` yields (name,
    lr (B, T, h, w, C), hr (B, T, s·h, s·w, C)), numpy or tensors, moved to
    ``device`` (default: where they are). ``patch_batch`` patches go through
    one forward (default 1, the reference's order); with a ``mesh`` each
    patch batch is split in equal parts over its data slots
    (``Mesh.map_data``), ``patch_batch`` rounded up to a multiple of their
    number and by default equal to it. Returns the (4, N) float64 array of
    [spatial TV, temporal TV, PSNR, bilinear PSNR], one column per
    patch-frame."""
    ph, pw = patch
    nd = 1 if mesh is None else len(mesh.data_devices)
    pb = -(-(patch_batch or nd) // nd) * nd
    rows = {"space": [], "time": [], "psnr": [], "bilinear": []}
    for _, lr_clip, hr_clip in batches:
        lr_clip = torch.as_tensor(lr_clip, device=device)
        hr_clip = torch.as_tensor(hr_clip, device=device)
        b, t = lr_clip.shape[:2]
        positions = patch_positions(lr_clip.shape[2], lr_clip.shape[3], patch, overlap)
        lps = [lr_clip[:, :, sh : sh + ph, sw : sw + pw] for sh, sw in positions]
        # chunk by chunk: only one chunk of SR outputs is live at a time
        for i in range(0, len(lps), pb):
            chunk = lps[i : i + pb]
            xs = torch.cat(chunk + [chunk[-1]] * (pb - len(chunk)), dim=0).contiguous()
            if mesh is None:
                srs = forward_fn(xs, ph * scale, pw * scale)
            else:
                srs = torch.cat(mesh.map_data(lambda x: forward_fn(x, ph * scale, pw * scale), xs.chunk(nd)))
            srs = srs.reshape(pb, b, *srs.shape[1:])[: len(chunk)]
            for (sh, sw), lp, sr in zip(positions[i : i + pb], chunk, srs):
                hp = hr_clip[:, :, sh * scale : (sh + ph) * scale, sw * scale : (sw + pw) * scale]
                rows["space"].extend(total_variation(lp).tolist())
                rows["time"].extend(time_variation(lp).tolist())
                for fi in range(t):
                    base = resize_bilinear(lp[:, fi], (ph * scale, pw * scale), align_corners=False)[..., :3]
                    rows["psnr"].append(float(psnr(sr[:, fi], hp[:, fi], shave=4)))
                    rows["bilinear"].append(float(psnr(base, hp[:, fi], shave=4)))
    return np.stack([np.asarray(rows[k], np.float64) for k in ("space", "time", "psnr", "bilinear")], axis=0)


def main(argv=None):
    """Patch-tiled eval of every ``--eval_datasets`` set; returns {set name:
    the (4, N) array}, each also saved under ``<job_dir>/run/``."""
    parser = base_parser("VSR patch-tiled evaluation (PyTorch/CUDA)")
    parser.set_defaults(dataset="reds", eval_datasets=["reds"])
    parser.add_argument("--eval_model", type=str, default=None,
                        help="Weights to evaluate: a params .npz (the JAX package's flat layout) or a "
                        "reference/mmedit .pt/.pth checkpoint (converted).")
    add_vsr_args(parser)
    parser.add_argument("--patch_h", type=int, default=64)
    parser.add_argument("--patch_w", type=int, default=64)
    parser.add_argument("--overlap_h", type=int, default=4)
    parser.add_argument("--overlap_w", type=int, default=0)
    parser.add_argument("--data_parallel", action="store_true",
                        help="Split each patch batch over the process's data slots (the visible cards of a "
                        "one-process job).")
    parser.add_argument("--patch_batch", type=int, default=None,
                        help="Patches per forward (default: the data slots with --data_parallel, else 1).")
    params = parse_with_plugins(parser, argv, with_models=False)
    LoggingTool(params.job_dir)
    log.info(attr_extractor(params))
    if params.chunk_frames or params.spatial_shards > 1:
        flag = "--chunk_frames" if params.chunk_frames else "--spatial_shards"
        raise ValueError(f"{flag} applies to full-frame eval (cli.test_vsr); patch-tiled eval bounds memory by "
                         "the patch instead")
    check_vsr_args(params)
    device = resolve_device(params.device)
    model = build_vsr_model(params, device)
    mesh = None
    if params.data_parallel:
        mesh = make_mesh(spatial=1, device=device)
        log.info(f"patch eval over the data slots {[str(d) for d in mesh.data_devices]}")
    fwd = replica_forward(model, mesh)

    results = {}
    out_dir = os.path.join(params.job_dir, "run")
    os.makedirs(out_dir, exist_ok=True)
    with no_tf32():
        for name, mod in eval_modules(params):
            ds = mod.get_dataset(modes.EVAL, params)
            result = evaluate_by_patch(fwd, batch_iterator(ds), params.scale, patch=(params.patch_h, params.patch_w),
                                       overlap=(params.overlap_h, params.overlap_w), patch_batch=params.patch_batch,
                                       device=device, mesh=mesh)
            out = os.path.join(out_dir, f"{params.model_type}_{params.patch_h}_{params.patch_w}_2.npy")
            np.save(out, result)
            log.info(f"{name}: patches={result.shape[1]} psnr={result[2].mean():.3f} "
                     f"bilinear={result[3].mean():.3f} → {out}")
            results[name] = result
    return results


if __name__ == "__main__":
    main()
