"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
1. device name, and the card's name and power limit from nvidia-smi;
2. build the hand kernels from mobilesuperresolution_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card at the shapes
   the main path gives it, with kernel / plain / library-call times and the
   kernel's roofline bound;
4. a tiny float32 BasicVSR on the card against the same model on the CPU;
5. full-width serving: BasicVSR x4 (nf 24, 8 blocks, bf16) with seeded random
   weights through the JAX-checkpoint bridge, streamed by StreamingVSR
   (chunk 4, overlap 3: 10-frame windows) over 16 frames of 426x240 to 16
   finite 1080x1920 frames, with the kernels' launch counts checked, then the
   steady-state frames/s of the 10-frame window forward;
6. a tiny float32 WDSR-B BasicModel (2 blocks, 24 units, x2) on the card
   against the same model on the CPU;
7. the shipped wdsr_b_x2 and result_net_x2 weights through the port's
   evaluate on their held-out set, PSNR within 0.05 dB of report.json, with
   the B3 / B4 launch counts checked; then the SISR entry point
   (cli/pretrain.py --eval_only) once, with finite metrics;
8. full-width SISR: WDSR-B x2 (16 blocks, 24 units) with seeded random
   weights through the bridge on 2 DIV2K-validation-sized images (1356x2040
   HR from synthetic_image, degraded to 678x1020 by imresize_np) in float32
   and bf16, with 16 B3 + 1 B4 launches per image checked, then the
   steady-state ms per image and the peak device memory.

Prints the kernel table as one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
Needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
T_WIN, H_LR, W_LR, OH, OW = 10, 240, 426, 1080, 1920
N_STREAM_FRAMES = 16
CHUNK, OVERLAP = 4, 3
B1_PER_WINDOW = 30  # 6 pyramid levels x 5 s2d convs, every level even
B2_PER_WINDOW = 1
# SISR: WDSR-B x2 at the pretraining launcher's width, DIV2K validation size
SR_BLOCKS, SR_UNITS, SR_SCALE = 16, 24, 2
SR_HR = (1356, 2040)
SR_IMAGES = 2
B3_PER_IMAGE, B4_PER_IMAGE = SR_BLOCKS, 1
SHIPPED_PSNR = {"wdsr_b_x2": 30.2841, "result_net_x2": 30.1743}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms per call from CUDA events around ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check(name, got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e})")
    if not (err <= tol) or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")
    return err


def bf16_tol(want):
    # both sides round the f32 sum to bf16 once (<= 2^-8 relative each) and
    # sum in different orders: two bf16 ulps at the largest magnitude
    return 2.0 ** -6 * float(want.float().abs().max())


def f32_tol(want):
    # full-f32 FMA on both sides (TF32 off), thousands of terms per sum
    return 1e-5 + 1e-4 * float(want.float().abs().max())


def phase_kernels(gen, dev):
    from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same, conv5x5_same_plain
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
        fused_conv_pixel_shuffle,
        fused_conv_pixel_shuffle_plain,
        fused_conv_pixel_shuffle_skip,
        fused_conv_pixel_shuffle_skip_plain,
    )
    from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import fused_wdsr_block, fused_wdsr_block_plain

    rows = {"B1": [], "B2": [], "B3": [], "B4": []}

    def rand(shape, dtype, scale=1.0):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(dev, dtype).contiguous()

    # B1: the five s2d convs of SpyNet's finest level (18 images, 128x224), bf16
    n, h, w = 2 * (T_WIN - 1), 128, 224
    shapes = [(32, 128, True), (128, 256, True), (256, 128, True), (128, 64, True), (64, 8, False)]
    cases = [(cin, cout, relu, torch.bfloat16, n) for cin, cout, relu in shapes]
    cases.append((128, 64, True, torch.float32, 2))  # one f32 shape (fewer images)
    for cin, cout, relu, dtype, nimg in cases:
        x = rand((nimg, h, w, cin), dtype)
        wt = rand((5, 5, cin, cout), dtype, 1.0 / np.sqrt(25 * cin))
        b = rand((cout,), torch.float32, 0.1)
        got = conv5x5_same(x, wt, b, relu)
        want = conv5x5_same_plain(x, wt, b, relu)
        torch.cuda.synchronize()
        tag = f"B1 {nimg}x{h}x{w} {cin}->{cout} {str(dtype)[6:]}"
        err = check(tag, got, want, bf16_tol(want) if dtype == torch.bfloat16 else f32_tol(want))
        xn, wn, bb = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(), b.to(dtype)
        ms = cuda_ms(lambda: conv5x5_same(x, wt, b, relu))
        plain_ms = cuda_ms(lambda: conv5x5_same_plain(x, wt, b, relu))
        lib_ms = cuda_ms(lambda: F.conv2d(xn, wn, bb, padding=2))
        flops = 2.0 * nimg * h * w * cin * cout * 25
        bms, by = bound(flops, nbytes(x, wt, b, got), dtype)
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by})")
        rows["B1"].append(dict(case=tag, main_path=dtype == torch.bfloat16, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                               gflop=flops / 1e9))

    # B2: the main-path tail (2x2, pad ((1,2),(1,2)), 48 -> 48, s=4, crop to
    # (4h+1, 4w+1)) in bf16, and the Pallas kernel's 3x3/pad-1 form at s=2 in f32
    tail_cases = [
        (T_WIN, H_LR, W_LR, 48, 2, 4, ((1, 2), (1, 2)), (4 * H_LR + 1, 4 * W_LR + 1), torch.bfloat16),
        (4, 120, 214, 16, 3, 2, ((1, 1), (1, 1)), None, torch.float32),
    ]
    for nb, hh, ww, cin, k, s, pad, crop, dtype in tail_cases:
        cc = 3 * s * s
        x = rand((nb, hh, ww, cin), dtype)
        kern = rand((k, k, cin, cc), dtype, 1.0 / np.sqrt(k * k * cin))
        b = rand((cc,), dtype, 0.1)
        got = fused_conv_pixel_shuffle(x, kern, b, s, pad, crop)
        want = fused_conv_pixel_shuffle_plain(x, kern, b, s, pad, crop)
        torch.cuda.synchronize()
        tag = f"B2 {nb}x{hh}x{ww}x{cin} {k}x{k} s{s} -> {tuple(got.shape)} {str(dtype)[6:]}"
        err = check(tag, got, want, bf16_tol(want) if dtype == torch.bfloat16 else f32_tol(want))
        (pt, pb), (pl, pr) = pad
        xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous(memory_format=torch.channels_last)
        kn = kern.permute(3, 2, 0, 1).contiguous()
        oh, ow = got.shape[1:3]
        ms = cuda_ms(lambda: fused_conv_pixel_shuffle(x, kern, b, s, pad, crop))
        plain_ms = cuda_ms(lambda: fused_conv_pixel_shuffle_plain(x, kern, b, s, pad, crop))
        lib_ms = cuda_ms(lambda: F.pixel_shuffle(F.conv2d(xp, kn, b), s)[:, :, :oh, :ow])
        # conv positions that reach the crop, as the kernel computes them
        hc, wc = -(-oh // s), -(-ow // s)
        flops = 2.0 * nb * hc * wc * k * k * cin * cc
        bms, by = bound(flops, nbytes(x, kern, b, got), dtype)
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by})")
        rows["B2"].append(dict(case=tag, main_path=dtype == torch.bfloat16, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                               gflop=flops / 1e9))

    # B3: one WDSR-B block at the full-width x2 LR map (678x1020, 24 units:
    # E 144, M 20, k 3) in f32 (the eval CLI's default, the main path) and
    # bf16, and a ragged 37x53 map (neither side a multiple of the 16 tile)
    hl, wl = SR_HR[0] // SR_SCALE, SR_HR[1] // SR_SCALE
    c, e, m = SR_UNITS, int(SR_UNITS * 6), int(SR_UNITS * 0.84)
    for hh, ww, dtype in ((hl, wl, torch.float32), (hl, wl, torch.bfloat16), (37, 53, torch.float32),
                          (37, 53, torch.bfloat16)):
        x = rand((1, hh, ww, c), dtype)
        ws = [rand((c, e), torch.float32, c ** -0.5), rand((e,), torch.float32, 0.2),
              rand((e, m), torch.float32, e ** -0.5), rand((m,), torch.float32, 0.2),
              rand((3, 3, m, c), torch.float32, (9 * m) ** -0.5), rand((c,), torch.float32, 0.2)]
        ws = [w.to(dtype).float() for w in ws]  # as a bf16 model's prepare() holds them
        got = fused_wdsr_block(x, *ws)
        want = fused_wdsr_block_plain(x, *ws)
        torch.cuda.synchronize()
        tag = f"B3 1x{hh}x{ww}x{c} E{e} M{m} k3 {str(dtype)[6:]}"
        err = check(tag, got, want, bf16_tol(want) if dtype == torch.bfloat16 else f32_tol(want))
        ms = cuda_ms(lambda: fused_wdsr_block(x, *ws))
        plain_ms = cuda_ms(lambda: fused_wdsr_block_plain(x, *ws))
        # one library chain for the same function: cuDNN 1x1, ReLU, 1x1, 3x3 + residual
        xn = x.permute(0, 3, 1, 2)
        lw = [ws[0].t()[:, :, None, None].to(dtype), ws[1].to(dtype), ws[2].t()[:, :, None, None].to(dtype),
              ws[3].to(dtype), ws[4].permute(3, 2, 0, 1).contiguous().to(dtype), ws[5].to(dtype)]
        lib_ms = cuda_ms(lambda: xn + F.conv2d(F.conv2d(F.relu(F.conv2d(xn, lw[0], lw[1])), lw[2], lw[3]),
                                               lw[4], lw[5], padding=1))
        px = hh * ww
        flops = 2.0 * px * (c * e + e * m + 9 * m * c)
        bms, by = bound(flops, nbytes(x, got, *ws), dtype)
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by})")
        rows["B3"].append(dict(case=tag, main_path=(hh, dtype) == (hl, torch.float32), max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                               gflop=flops / 1e9))

    # B4: the WDSR tail at full width, body 24 -> 12 (3x3) + skip 3 -> 12 (5x5), s 2
    cc = 3 * SR_SCALE ** 2
    for dtype in (torch.float32, torch.bfloat16):
        x = rand((1, hl, wl, c), dtype)
        xs = rand((1, hl, wl, 3), dtype, 0.5)
        kern = rand((3, 3, c, cc), dtype, (9 * c) ** -0.5)
        ks = rand((5, 5, 3, cc), dtype, 75 ** -0.5)
        b = rand((cc,), torch.float32, 0.5)
        got = fused_conv_pixel_shuffle_skip(x, kern, b, SR_SCALE, xs, ks)
        want = fused_conv_pixel_shuffle_skip_plain(x, kern, b, SR_SCALE, xs, ks)
        torch.cuda.synchronize()
        tag = f"B4 1x{hl}x{wl}x{c} 3x3 + skip 3ch 5x5 s{SR_SCALE} -> {tuple(got.shape)} {str(dtype)[6:]}"
        err = check(tag, got, want, bf16_tol(want) if dtype == torch.bfloat16 else f32_tol(want))
        ms = cuda_ms(lambda: fused_conv_pixel_shuffle_skip(x, kern, b, SR_SCALE, xs, ks))
        plain_ms = cuda_ms(lambda: fused_conv_pixel_shuffle_skip_plain(x, kern, b, SR_SCALE, xs, ks))
        xn, xsn = x.permute(0, 3, 1, 2), xs.permute(0, 3, 1, 2)
        kn, ksn, bb = kern.permute(3, 2, 0, 1).contiguous(), ks.permute(3, 2, 0, 1).contiguous(), b.to(dtype)
        lib_ms = cuda_ms(lambda: F.pixel_shuffle(F.conv2d(xn, kn, bb, padding=1) + F.conv2d(xsn, ksn, padding=2),
                                                 SR_SCALE))
        flops = 2.0 * hl * wl * (9 * c + 25 * 3) * cc
        bms, by = bound(flops, nbytes(x, xs, kern, ks, b, got), dtype)
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by})")
        rows["B4"].append(dict(case=tag, main_path=dtype == torch.float32, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                               gflop=flops / 1e9))
    return rows


def phase_small_parity(dev):
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    rng = np.random.default_rng(1)
    x = rng.random((1, 3, 64, 96, 3), dtype=np.float32)
    outs = []
    for d in ("cpu", dev):
        m = BasicVSR(num_feat=8, num_block=1, scale=4).to(d)
        load_params_npz(m, random_jax_params(m, seed=1))
        with torch.inference_mode():
            outs.append(m(torch.from_numpy(x).to(d), 256, 384).cpu())
    # f32 everywhere (TF32 off): only summation order differs
    return check("tiny BasicVSR f32 card vs CPU", outs[1], outs[0], 1e-4)


def synthetic_stream(t, h, w, seed):
    """Smooth random texture translating by (1, 2) px per frame."""
    g = torch.Generator().manual_seed(seed)
    tex = torch.rand((1, 3, h // 8 + 4, w // 8 + 4), generator=g)
    tex = F.interpolate(tex, size=(h + 4 * t, w + 4 * t), mode="bilinear", align_corners=False)[0]
    tex = tex.permute(1, 2, 0).numpy()
    return [np.ascontiguousarray(tex[i : i + h, 2 * i : 2 * i + w]) for i in range(t)]


def phase_serving(dev):
    from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.models.basicvsr import compute_flows
    from mobilesuperresolution_tpu_torch.serve import StreamingVSR
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    model = get_vsr_model("basic", scale=4, compute_dtype=torch.bfloat16, device=dev)
    load_params_npz(model, random_jax_params(model, seed=0))

    def apply_fn(x, oh, ow):
        with torch.inference_mode():
            return model(x, oh, ow)

    frames = synthetic_stream(N_STREAM_FRAMES, H_LR, W_LR, seed=0)
    stream = StreamingVSR(apply_fn, OH, OW, chunk=CHUNK, overlap=OVERLAP, device=dev)
    assert stream.window == T_WIN
    stream.warmup((H_LR, W_LR, 3))
    torch.cuda.synchronize()

    conv5x5_same.launches = 0
    fused_conv_pixel_shuffle.launches = 0
    t0 = time.perf_counter()
    out = []
    for fr in frames:
        out.extend(stream.push(fr))
    out.extend(stream.flush())
    wall = time.perf_counter() - t0
    launches = {"B1": conv5x5_same.launches, "B2": fused_conv_pixel_shuffle.launches}
    windows = len(range(0, N_STREAM_FRAMES, CHUNK))
    log(f"  streamed {len(out)} frames in {windows} windows, {wall:.3f} s "
        f"({len(out) / wall:.2f} frames/s end to end incl. host copies); launches {launches}")
    if len(out) != N_STREAM_FRAMES:
        raise AssertionError(f"{len(out)} output frames, expected {N_STREAM_FRAMES}")
    for i, fr in enumerate(out):
        if fr.shape != (OH, OW, 3) or not np.isfinite(fr).all():
            raise AssertionError(f"frame {i}: shape {fr.shape}, finite {np.isfinite(fr).all()}")
    if launches != {"B1": B1_PER_WINDOW * windows, "B2": B2_PER_WINDOW * windows}:
        raise AssertionError(f"launch counts {launches} for {windows} windows")

    # steady-state forward of one 10-frame window, and the flow stage alone
    x = torch.from_numpy(np.stack(frames[:T_WIN])[None]).to(dev)
    with torch.inference_mode():
        win_ms = cuda_ms(lambda: model(x, OH, OW), iters=5, warmup=2)
        xb = x.to(torch.bfloat16)
        flow_ms = cuda_ms(lambda: compute_flows(model.spynet, xb), iters=5, warmup=1)
        sr = model(x, OH, OW)
    torch.cuda.synchronize()
    stats = dict(
        window_ms=win_ms, fps=T_WIN / win_ms * 1e3, spynet_flows_ms=flow_ms,
        stream_frames=len(out), stream_windows=windows, stream_wall_s=wall,
        stream_fps_end_to_end=len(out) / wall, launches=launches,
        out_min=float(sr.min()), out_max=float(sr.max()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(f"  window forward {win_ms:.3f} ms = {stats['fps']:.2f} frames/s; "
        f"SpyNet flows {flow_ms:.3f} ms; output range [{stats['out_min']:.3f}, {stats['out_max']:.3f}]")
    return stats, launches, windows


def sisr_launches():
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle_skip
    from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import fused_wdsr_block

    return {"B3": fused_wdsr_block.launches, "B4": fused_conv_pixel_shuffle_skip.launches}


def reset_sisr_launches():
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle_skip
    from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import fused_wdsr_block

    fused_wdsr_block.launches = 0
    fused_conv_pixel_shuffle_skip.launches = 0


def phase_sisr_parity(dev):
    from mobilesuperresolution_tpu_torch.models import BasicModel
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    x = np.random.default_rng(2).random((1, 45, 61, 3), dtype=np.float32)
    outs = []
    for d in ("cpu", dev):
        m = BasicModel(num_blocks=2, num_residual_units=SR_UNITS, scale=SR_SCALE).to(d)
        load_params_npz(m, random_jax_params(m, seed=2))
        with torch.inference_mode():
            outs.append(m(torch.from_numpy(x).to(d)).cpu())
    # f32 everywhere (TF32 off): only summation order differs
    return check("tiny BasicModel f32 card vs CPU", outs[1], outs[0], 1e-4)


def held_out_batches():
    """The convergence artifacts' held-out set: synthetic_natural_image seeds
    50-53 at 96x96, degraded x2 by the MATLAB-exact imresize."""
    from mobilesuperresolution_tpu_torch.data.imresize import imresize_np
    from mobilesuperresolution_tpu_torch.data.synthetic import synthetic_natural_image

    for s in range(50, 54):
        u8 = synthetic_natural_image(s, (96, 96))
        lr = imresize_np(u8, scalar_scale=0.5).astype(np.float32) / 255.0
        yield f"eval{s}", lr[None], (u8.astype(np.float32) / 255.0)[None]


def phase_shipped(dev):
    from mobilesuperresolution_tpu_torch.cli import pretrain
    from mobilesuperresolution_tpu_torch.models import BasicModel, ResultNet
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz
    from mobilesuperresolution_tpu_torch.train.evaluate import evaluate

    out = {}
    reset_sisr_launches()
    for run, want in SHIPPED_PSNR.items():
        d = os.path.join(ROOT, "artifacts", "convergence", run)
        with open(os.path.join(d, "report.json")) as f:
            cfg = json.load(f)["config"]
        if run == "wdsr_b_x2":
            n_wdsr_blocks = cfg["num_blocks"]
            model = BasicModel(cfg["num_blocks"], cfg["num_residual_units"], cfg["scale"])
        else:
            model = ResultNet(cfg["scale"], cfg["idx"])
        model.to(dev)
        load_params_npz(model, os.path.join(d, "weights", "models.npz"))

        def fwd(lr, oh, ow):
            with torch.inference_mode():
                return model(lr)

        res = evaluate(fwd, held_out_batches(), scale=cfg["scale"], device=dev).as_dict()
        log(f"  {run}: PSNR {res['PSNR']:.4f} (report {want}), SSIM {res['SSIM']:.4f}")
        if not abs(res["PSNR"] - want) <= 0.05:
            raise AssertionError(f"{run}: PSNR {res['PSNR']} not within 0.05 dB of {want}")
        out[run] = res
    launches = sisr_launches()
    if launches != {"B3": n_wdsr_blocks * 4, "B4": 4 + 4}:
        raise AssertionError(f"shipped-weights launches {launches}, expected B3 {n_wdsr_blocks} x 4, B4 4 + 4")
    out["launches"] = launches

    with tempfile.TemporaryDirectory() as job_dir:
        res = pretrain.main([
            "--job_dir", job_dir, "--eval_only", "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr",
            "--num_blocks", str(n_wdsr_blocks),
            "--eval_model", os.path.join(ROOT, "artifacts", "convergence", "wdsr_b_x2", "weights", "models.npz"),
        ])["synthetic_isr"]
    log(f"  cli.pretrain --eval_only on synthetic_isr: "
        + " ".join(f"{k}={v:.4f}" for k, v in res.items()))
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"cli.pretrain gave non-finite metrics {res}")
    out["cli"] = res
    return out


def phase_sisr_full(dev):
    """Full-width WDSR-B x2 on DIV2K-validation-sized images; the f32 pass is
    the SISR main path whose launches go in the kernel line."""
    from mobilesuperresolution_tpu_torch.data.imresize import imresize_np
    from mobilesuperresolution_tpu_torch.data.synthetic import synthetic_image
    from mobilesuperresolution_tpu_torch.models import get_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    t0 = time.perf_counter()
    hrs = [synthetic_image(10 + i, SR_HR) for i in range(SR_IMAGES)]
    lrs = [torch.from_numpy(imresize_np(h, scalar_scale=1.0 / SR_SCALE).astype(np.float32) / 255.0)[None].to(dev)
           for h in hrs]
    log(f"  made {SR_IMAGES} images {SR_HR[0]}x{SR_HR[1]} -> LR {tuple(lrs[0].shape[1:3])} "
        f"in {time.perf_counter() - t0:.1f} s")
    stats, main_launches = {}, None
    for name, bf16 in (("f32", False), ("bf16", True)):
        params = argparse.Namespace(model_type="BASIC_MODEL", num_blocks=SR_BLOCKS,
                                    num_residual_units=SR_UNITS, scale=SR_SCALE, bf16=bf16)
        model = get_model(params, device=dev)
        load_params_npz(model, random_jax_params(model, seed=0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_sisr_launches()
        with torch.inference_mode():
            outs = [model(x) for x in lrs]
        torch.cuda.synchronize()
        launches = sisr_launches()
        want_shape = (1, SR_HR[0], SR_HR[1], 3)
        for o in outs:
            if tuple(o.shape) != want_shape or not torch.isfinite(o).all():
                raise AssertionError(f"SISR {name}: output {tuple(o.shape)}, finite {bool(torch.isfinite(o).all())}")
        if launches != {"B3": B3_PER_IMAGE * SR_IMAGES, "B4": B4_PER_IMAGE * SR_IMAGES}:
            raise AssertionError(f"SISR {name}: launches {launches} for {SR_IMAGES} images")
        if main_launches is None:
            main_launches = launches
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(lrs[0]), iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats[name] = dict(ms_per_image=ms, launches=launches, peak_mem_gib=peak,
                           out_min=float(outs[0].min()), out_max=float(outs[0].max()))
        log(f"  {name}: {ms:.3f} ms per {SR_HR[0]}x{SR_HR[1]} image, launches {launches}, peak {peak:.3f} GiB, "
            f"output range [{stats[name]['out_min']:.3f}, {stats[name]['out_max']:.3f}]")
        del model, outs
    return stats, main_launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}; card: {smi}")
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        from mobilesuperresolution_tpu_torch.kernels import _build

        secs = _build.build()
        log(f"built kernels {_build.SOURCES} in {secs:.1f} s")
        for name in _build.SOURCES:
            info = [ln for ln in open(os.path.join(_build.BUILD_DIR, f"{name}.log")) if "registers" in ln or "spill" in ln]
            log("".join(f"  {name}: {ln.strip()}\n" for ln in info[-6:]).rstrip())
        report["build_s"] = secs

        log("kernels vs plain:")
        rows = phase_kernels(torch.Generator().manual_seed(0), dev)
        report["kernel_cases"] = rows
        log("small-model parity:")
        report["tiny_parity_err"] = phase_small_parity(dev)
        log("full-width serving:")
        stats, launches, windows = phase_serving(dev)
        report["serving"] = stats
        log("small SISR parity:")
        report["tiny_sisr_parity_err"] = phase_sisr_parity(dev)
        log("shipped SISR weights and the eval entry point:")
        report["shipped"] = phase_shipped(dev)
        log("full-width SISR:")
        report["sisr"], sisr_main = phase_sisr_full(dev)
        launches = {**launches, **sisr_main}
    except Exception:
        traceback.print_exc()
        return 1

    def entry(name, source, replaces, key):
        on_path = [r for r in rows[key] if r["main_path"]]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in rows[key]),
            "ms": sum(r["ms"] for r in on_path),
            "plain_ms": sum(r["plain_ms"] for r in on_path),
            "bound_ms": sum(r["bound_ms"] for r in on_path),
            "bound_by": max(on_path, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(r["library_ms"] for r in on_path),
        }

    kernels = {"kernels": [
        entry("conv5x5_same", "mobilesuperresolution_tpu_torch/csrc/conv5x5.cu",
              "mobilesuperresolution_tpu/kernels/conv5x5.py:107", "B1"),
        entry("fused_conv_pixel_shuffle", "mobilesuperresolution_tpu_torch/csrc/fused_tail.cu",
              "mobilesuperresolution_tpu/kernels/fused_tail.py:85", "B2"),
        entry("fused_wdsr_block", "mobilesuperresolution_tpu_torch/csrc/fused_wdsr_block.cu",
              "mobilesuperresolution_tpu/kernels/fused_wdsr_block.py:110", "B3"),
        entry("fused_conv_pixel_shuffle_skip", "mobilesuperresolution_tpu_torch/csrc/fused_tail.cu",
              "mobilesuperresolution_tpu/kernels/fused_tail.py:85", "B4"),
    ]}
    report["kernels"] = kernels["kernels"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
