"""The approximation ladder: what ``--flow_downscale``, ``--chunk_overlap``
and ``--quantize int8`` cost in quality (counterpart of
mobilesuperresolution_tpu/analysis/approx_ladder.py).

On a deterministic translating-texture video (rigid global motion, the case
optical flow exists for) a small recurrent VSR model is trained briefly
(no pretrained BasicVSR ships), then each approximation is scored two ways:

- ``agreement``: PSNR between the approximate output and the exact
  whole-clip, full-resolution-flow output (inf = exact);
- ``delta``: the change in PSNR against the ground truth, relative to the
  exact path.

    python -m mobilesuperresolution_tpu_torch.analysis.approx_ladder --config tiny

runs on the card (``--device cpu`` on the CPU) and prints the table.
``--config deployment`` runs mobile BasicVSR at nf 24 / 8 blocks, the
configuration the three flags are offered for, on noisy LR frames;
both configurations train with a photometrically pretrained, frozen SpyNet
(``ladder_config``).
"""

import argparse

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.data.native_imresize import imresize_u8
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR, BasicVSROrigin
from mobilesuperresolution_tpu_torch.models.spynet import upsample_flow
from mobilesuperresolution_tpu_torch.ops.warp import flow_warp
from mobilesuperresolution_tpu_torch.parallel.temporal import chunked_vsr_apply
from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, load_params_npz, random_jax_params
from mobilesuperresolution_tpu_torch.train.state import multistep_adam, spynet_frozen_mask
from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

# SpyNet's learning rate, relative to the rest, when it trains with the model
# (the reference BasicVSR recipe's multiplier; see train_tiny_origin)
FLOW_LR_MULT = 0.125


def make_translating_video(seed, t, h, w, scale=4, dy=2, dx=3, lr_noise=0.0):
    """Deterministic video with rigid global translation: (lr, hr), hr (1,
    T, H·scale, W·scale, 3) float32 in [0, 1], crops of one textured canvas
    sliding by (dy, dx) HR pixels a frame; lr the MATLAB-exact bicubic
    downscale of each frame. ``lr_noise`` > 0 adds independent Gaussian noise
    (std in [0, 1] units) to the LR frames only, which makes temporal fusion
    necessary: averaging aligned frames is then the only way to denoise."""
    rng = np.random.default_rng(seed)
    hh, ww = h * scale, w * scale
    ch, cw = hh + t * abs(dy), ww + t * abs(dx)
    yy, xx = np.mgrid[0:ch, 0:cw].astype(np.float64)
    canvas = (0.5 + 0.2 * np.sin(2 * np.pi * xx / 23.0) + 0.15 * np.cos(2 * np.pi * yy / 17.0)
              + 0.1 * np.sin(2 * np.pi * (xx + yy) / 41.0))
    noise = rng.standard_normal((ch, cw))
    # smoothed, so the noise translates like texture, not like sensor noise
    k = np.ones(5) / 5.0
    noise = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, noise)
    noise = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, noise)
    canvas = np.clip(canvas + 0.15 * noise, 0, 1)
    rgb = np.stack([canvas, 0.9 * canvas, np.clip(canvas * 1.1, 0, 1)], -1)
    rgb_u8 = (rgb * 255).astype(np.uint8)
    hrs, lrs = [], []
    for i in range(t):
        y0, x0 = i * abs(dy), i * abs(dx)
        frame = rgb_u8[y0 : y0 + hh, x0 : x0 + ww]
        hrs.append(frame)
        lrs.append(imresize_u8(frame, scalar_scale=1.0 / scale))
    hr = np.stack(hrs)[None].astype(np.float32) / 255.0
    lr = np.stack(lrs)[None].astype(np.float32) / 255.0
    if lr_noise > 0:
        noise_rng = np.random.default_rng(seed + 1)
        lr = np.clip(lr + lr_noise * noise_rng.standard_normal(lr.shape).astype(np.float32), 0.0, 1.0)
    return lr, hr


def pretrain_spynet_photometric(spynet, lr, steps=400, lr_rate=1e-4):
    """Train ``spynet`` in place on the clip's own consecutive LR pairs, both
    directions in one batch: minimise ||flow_warp(supp, spynet(ref, supp)) −
    ref||² with Adam. It stands in for the reference's pretrained SpyNet,
    which the reference freezes for VSR training; a one-clip photometric
    SpyNet does not map identical frames to a zero flow (on near-periodic
    texture any self-mapping flow is photometrically optimal), which the
    chunked path's replicate-padded clip edges show."""
    dev = spynet.level_0.conv0_kernel.device
    frames = torch.as_tensor(lr[0], device=dev)
    h, w = frames.shape[1:3]
    ref = torch.cat([frames[:-1], frames[1:]])
    supp = torch.cat([frames[1:], frames[:-1]])
    opt = torch.optim.Adam(spynet.parameters(), lr=lr_rate)
    for _ in range(steps):
        opt.zero_grad()
        fl = upsample_flow(spynet.forward_live(ref, supp), h, w)
        torch.mean((flow_warp(supp, fl) - ref) ** 2).backward()
        opt.step()
    spynet.prepare()
    return spynet


class _Adams:
    """Several optimizers stepped as one (``train.steps``' guard calls
    ``step()`` and counts ``steps``)."""

    def __init__(self, *opts):
        self.opts = opts
        self.steps = 0

    def step(self):
        for opt in self.opts:
            opt.step()


def train_tiny_origin(lr, hr, steps=150, num_feat=8, num_block=1, scale=4, t_train=4, seed=0, model_cls=None,
                      pretrain_flow_steps=0, device="cpu"):
    """Train a small recurrent VSR model (default ``BasicVSROrigin``;
    ``BasicVSR`` for the mobile deployment configuration) from seeded random
    weights on random ``t_train``-frame windows of the clip, Adam at a
    constant 1e-3. SpyNet trains with the rest at ``FLOW_LR_MULT`` times
    that rate, the reference BasicVSR recipe's SpyNet multiplier (the JAX
    package's ladder trains it at the full rate; here, from the port's seeded
    weights, that diverged for 3 of 8 seeds: flows of 1e7 pixels after 20
    steps, so every warp read zeros and each flow or chunk rung measured the
    exact output). With ``pretrain_flow_steps`` > 0 SpyNet is first trained
    photometrically on the clip, then frozen (the reference's convention).
    Returns the model, in eval mode."""
    model_cls = model_cls or BasicVSROrigin
    t = lr.shape[1]
    oh, ow = hr.shape[2], hr.shape[3]
    freeze_flow = pretrain_flow_steps > 0
    model = model_cls(num_feat=num_feat, num_block=num_block, scale=scale, stop_flow_grad=freeze_flow).to(device)
    load_params_npz(model, random_jax_params(model, seed))
    named = jax_named_parameters(model)
    trunk = spynet_frozen_mask(named)
    if freeze_flow:
        pretrain_spynet_photometric(model.spynet, lr, steps=pretrain_flow_steps)
        opt = multistep_adam(named, 1e-3, max(steps, 1), 1, trainable_mask=trunk, milestones=[])
    else:
        flow = {k: not v for k, v in trunk.items()}
        opt = _Adams(multistep_adam(named, 1e-3, max(steps, 1), 1, trainable_mask=trunk, milestones=[]),
                     multistep_adam(named, 1e-3 * FLOW_LR_MULT, max(steps, 1), 1, trainable_mask=flow, milestones=[]))
    step = make_vsr_step(model.train(), opt, (oh, ow))
    lr_t, hr_t = torch.as_tensor(lr, device=device), torch.as_tensor(hr, device=device)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        s = int(rng.integers(0, t - t_train + 1))
        step((lr_t[:, s : s + t_train], hr_t[:, s : s + t_train]))
    model.eval().prepare()
    return model


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _rung(approx, exact, hr, exact_psnr):
    return {"agreement": _psnr(approx, exact), "psnr": _psnr(approx, hr), "delta": _psnr(approx, hr) - exact_psnr}


def run_ladder(train_steps=150, num_feat=8, num_block=1, scale=4, t_eval=16, h=32, w=32, chunk=4, downscales=(2, 4),
               overlaps=(0, 2, 4, 8), seed=0, model_cls=None, t_train=4, lr_noise=0.0, pretrain_flow_steps=0,
               device="cpu"):
    """Returns {"exact_psnr": float, "flow_downscale": {d: {"agreement",
    "psnr", "delta"}}, "chunk_overlap": {ov: {... and "interior_agreement"
    where some frames' windows are replicate-padded}}, "quantize_int8":
    {...}}, as the JAX package's ``run_ladder``. Each approximate model
    carries the trained model's weights."""
    model_cls = model_cls or BasicVSROrigin
    lr, hr = make_translating_video(seed, t_eval, h, w, scale, lr_noise=lr_noise)
    with no_tf32():
        model = train_tiny_origin(lr, hr, steps=train_steps, num_feat=num_feat, num_block=num_block, scale=scale,
                                  seed=seed, model_cls=model_cls, t_train=t_train,
                                  pretrain_flow_steps=pretrain_flow_steps, device=device)
        weights = {k: p.detach().cpu().numpy() for k, p in jax_named_parameters(model).items()}
        oh, ow = hr.shape[2], hr.shape[3]
        x = torch.as_tensor(lr, device=device)

        def fwd_with(m):
            def fwd(xx, a, b):
                with torch.inference_mode():
                    return m(xx, a, b)

            return fwd

        def variant(**kw):
            m = model_cls(num_feat=num_feat, num_block=num_block, scale=scale, **kw).to(device)
            return fwd_with(load_params_npz(m, weights).eval())

        def run(fwd):
            return fwd(x, oh, ow).float().cpu().numpy()

        exact_fwd = fwd_with(model)
        exact = run(exact_fwd)
        out = {"exact_psnr": _psnr(exact, hr), "flow_downscale": {}, "chunk_overlap": {}}
        for d in downscales:
            out["flow_downscale"][d] = _rung(run(variant(flow_downscale=d)), exact, hr, out["exact_psnr"])
        for ov in overlaps:
            approx = chunked_vsr_apply(exact_fwd, x, oh, ow, chunk=chunk, overlap=ov).float().cpu().numpy()
            entry = _rung(approx, exact, hr, out["exact_psnr"])
            # interior frames: their window holds no replicate-padded context
            t_frames = approx.shape[1]
            interior = [f for f in range(t_frames)
                        if (f // chunk) * chunk - ov >= 0 and (f // chunk) * chunk + chunk + ov <= t_frames]
            if interior and len(interior) < t_frames:
                entry["interior_agreement"] = _psnr(approx[:, interior], exact[:, interior])
            out["chunk_overlap"][ov] = entry
        out["quantize_int8"] = _rung(run(variant(quantized=True)), exact, hr, out["exact_psnr"])
    return out


def format_table(res):
    lines = [
        f"exact whole-clip PSNR vs ground truth: {res['exact_psnr']:.2f} dB",
        "",
        "| approximation | agreement w/ exact (dB) | PSNR delta vs exact (dB) |",
        "|---|---|---|",
    ]
    for d, r in sorted(res["flow_downscale"].items()):
        lines.append(f"| flow_downscale={d} | {r['agreement']:.1f} | {r['delta']:+.3f} |")
    for ov, r in sorted(res["chunk_overlap"].items()):
        inner = f" (interior {r['interior_agreement']:.1f})" if "interior_agreement" in r else ""
        lines.append(f"| chunk_overlap={ov} | {r['agreement']:.1f}{inner} | {r['delta']:+.3f} |")
    if "quantize_int8" in res:
        r = res["quantize_int8"]
        lines.append(f"| quantize=int8 | {r['agreement']:.1f} | {r['delta']:+.3f} |")
    return "\n".join(lines)


def ladder_config(config):
    """``run_ladder``'s arguments of a named configuration: 'tiny'
    (1-block BasicVSR_origin, nf 8, 300 steps on a 24-frame 40x40 clip) and
    'deployment' (mobile BasicVSR, nf 24, 8 blocks, trained on 10-frame
    windows of a noisy clip), both with a photometrically pretrained, frozen
    SpyNet. The JAX package's 'tiny' trains SpyNet with the rest instead;
    from the port's seeded weights that left the flow and chunk rungs within
    0.3 dB of ties (or, at the full learning rate, diverged), so their order
    measured the flow net's noise, not the approximations."""
    if config == "tiny":
        return dict(train_steps=300, t_eval=24, h=40, w=40, pretrain_flow_steps=200)
    return dict(train_steps=3000, num_feat=24, num_block=8, t_eval=24, h=40, w=40, model_cls=BasicVSR, t_train=10,
                lr_noise=0.05, pretrain_flow_steps=600)


def main(argv=None):
    ap = argparse.ArgumentParser("The approximation ladder (PyTorch/CUDA)")
    ap.add_argument("--config", choices=("tiny", "deployment"), default="tiny",
                    help="tiny = 1-block BasicVSR_origin; deployment = mobile BasicVSR at nf 24 / 8 blocks, the "
                    "configuration --quantize / --flow_downscale / --chunk_frames are offered for.")
    ap.add_argument("--device", type=str, default=None, help="'cuda' (default) or 'cpu'.")
    args = ap.parse_args(argv)
    res = run_ladder(**ladder_config(args.config), device=resolve_device(args.device))
    print(format_table(res))
    return res


if __name__ == "__main__":
    main()
