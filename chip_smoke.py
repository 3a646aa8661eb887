"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
1. device name, and the card's name and power limit from nvidia-smi;
2. build the hand kernels from mobilesuperresolution_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card at the shapes
   the main path gives it, with kernel / plain / library-call times and the
   kernel's roofline bound (B3, B4 and B5 at the rate of the unit each product
   runs on: CUDA-core f32, 3xTF32 or bf16 tensor cores, named in the row);
   B1 over all six pyramid levels of one window (30 launches), per level and
   summed, against cuDNN; B3 and B5 also at other widths (B3 16, 32, 64
   units; B5 16, 48, 24 -> 40 channels) and B5 at the eval shape for k 3, 5,
   7; B4 (3xTF32 / bf16 tensor cores) at x2, x3, x4 and at 18, 21, 24, 32
   body channels, with its issued against useful K; B5's search-shape cases
   with their device time per launch (torch.profiler) and the wrapper's
   host time per call; B1 at the flow cache's group (8 pair samples) and B3
   and B4 at the training step's batch (16 x 48x48) too;
4. a tiny float32 BasicVSR on the card against the same model on the CPU;
5. full-width serving: BasicVSR x4 (nf 24, 8 blocks, bf16) with seeded random
   weights through the JAX-checkpoint bridge, streamed by StreamingVSR
   (chunk 4, overlap 3: 10-frame windows) over 16 frames of 426x240 to 16
   finite 1080x1920 frames, with the kernels' launch counts checked, then the
   steady-state frames/s of the 10-frame window forward;
5b. the same model, weights and frames through the flow-cached stream
   (serve/flow_cache.py): its output within bf16_tol of the plain stream's,
   each pair flow computed once, B1 launched 30 times per flow group and B2
   once per window; sr_fn's ms per window and flow_fn's per group of 4
   pairs, both streams' frames/s end to end (plain, cached, cached, plain);
   then one window with flow_downscale 2, finite, with its SpyNet ms;
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
   steady-state ms per image and the peak device memory;
8b. SISR pretraining through its entry point (cli/pretrain.py) at the
   pretraining launcher's width (x2, 16 blocks, 24 units, batch 16, 48x48
   LR patches, lr 1e-3, float32) on synthetic_isr for one epoch (8 steps, 8
   eval images): finite losses, 16 B3 + 1 B4 launches per training forward
   and per eval image, a weights npz with every JAX key; then the
   steady-state training step (mean of 10, CUDA events) in f32 and bf16;
8c. retraining of the searched net through its entry point
   (cli/retrain_searched.py) on artifacts/search_depth_tpu/block_index.txt,
   the same checks and data, B4 once per forward, and its steady-state step;
8d. three training steps of a tiny float32 WDSR-B on the card against the
   CPU: per-step losses and the first step's gradients within 1e-4;
9. a tiny float32 NAS supernet (2 blocks, 8 units, x2) on the card against
   the same model on the CPU: sr, the latency estimate and every
   parameter's gradient of one search step;
10. the NAS search through its entry point (cli/search.py) at the search
   launcher's width (x2, 16 blocks, 32 units, batch 16, patch 48, float32)
   on synthetic_isr, one epoch per phase: finite metrics at every step, a
   parseable block_index.txt, a weights npz with every JAX key, B5 launched
   48 times per training forward and per eval image; then the steady-state
   ms per search step and per 678x1020 supernet eval forward, and the peak
   device memory.

Prints the kernel table as one JSON line (launches from this slice's paths:
B1 and B2 from the flow-cached stream, B3 and B4 from the pretraining run,
B5 from the search), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
Needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import os
import re
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

# published H100 SXM peaks (NVIDIA data sheet, dense), by the unit and type
# a route computes on; "tf32x3" is the TF32 tensor-core rate over 3, the
# rate of a 3xTF32 split (hi·hi + hi·lo + lo·hi)
PEAK_RATES = {"f32": 67e12, "bf16": 989e12, "tf32x3": 495e12 / 3}
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
# NAS search: the supernet at launchers/search.sh's width
NAS_BLOCKS, NAS_UNITS, NAS_BATCH, NAS_PATCH = 16, 32, 16, 48
NAS_NUM_PATCHES = 6  # synthetic_isr: 8 images x 6 patches / batch 16 = 3 steps per epoch
# SISR training at launchers/pretraining.sh's width (batch 16, 48x48 LR patches, lr 1e-3, f32)
TRAIN_BATCH, TRAIN_PATCH = 16, 48
TRAIN_NUM_PATCHES = 16  # synthetic_isr: 8 images x 16 patches / batch 16 = 8 steps per epoch
TRAIN_STEPS = 8 * TRAIN_NUM_PATCHES // TRAIN_BATCH
B5_PER_FORWARD = 3 * NAS_BLOCKS


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
    """Bound of B1 and B2: bf16 at the tensor-core rate, f32 on the CUDA
    cores. Returns (ms, "operations" or "bytes")."""
    return bound_by_route([(flops, "bf16" if dtype == torch.bfloat16 else "f32")], nbytes)[:2]


def bound_by_route(work, nbytes):
    """Bound of a kernel whose operations run on several units: ``work`` is
    [(flops, basis)], basis a key of PEAK_RATES; the units work side by side,
    so the operations take at least the slowest unit's time. Returns (ms,
    "operations" or "bytes", the basis as text)."""
    t_ops = max(f / PEAK_RATES[b] for f, b in work) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    basis = " + ".join(f"{f / 1e9:.3f} GFLOP at {b}" for f, b in work)
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), basis


def route(dtype):
    """The tensor-core basis of B3's, B4's and B5's products for an I/O dtype."""
    return "bf16" if dtype == torch.bfloat16 else "tf32x3"


def host_us(fn, iters=200):
    """Host microseconds per call: the host clock around ``iters`` calls the
    card keeps up with (the launch queue never fills), synchronised after."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def device_ms_per_launch(fn, name, iters=30):
    """Device time per launch of the kernels whose name holds ``name``, from
    torch.profiler's CUDA events; with the launch count seen."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [ev.device_time_total if hasattr(ev, "device_time_total") else ev.cuda_time_total
             for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.name]
    return sum(times) / max(len(times), 1) / 1e3, len(times)


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


def ptxas_summary(path):
    """One line per entry function of an nvcc ``-Xptxas -v`` log: its name,
    demangled by the toolkit's cu++filt, then ptxas's own registers and
    spill lines."""
    from mobilesuperresolution_tpu_torch.kernels import _build

    entries = []  # [mangled name, registers line, spill line]
    for ln in open(path):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entries.append([m.group(1), "", ""])
        elif entries and "registers" in ln:
            entries[-1][1] = ln.split(":", 1)[1].strip()
        elif entries and "spill" in ln:
            entries[-1][2] = ln.strip()
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    names = subprocess.run([filt, *(e[0] for e in entries)], capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    out = []
    for name, (_, regs, spill) in zip(names, entries):
        depth, cut = 0, len(name)  # drop the parameter list, the last (...) group
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                cut = i
                break
        name = name[:cut].removeprefix("void ").replace("<unnamed>::", "").replace("(int)", "")
        out.append(f"{name}: {regs}; {spill}")
    return out


def phase_kernels(gen, dev):
    from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same, conv5x5_same_plain, pack_weights
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
        fused_conv_pixel_shuffle,
        fused_conv_pixel_shuffle_plain,
        fused_conv_pixel_shuffle_skip,
        fused_conv_pixel_shuffle_skip_plain,
    )
    from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import fused_wdsr_block, fused_wdsr_block_plain

    from mobilesuperresolution_tpu_torch.kernels.fused_convsep import fused_convsep, fused_convsep_plain

    rows = {"B1": [], "B2": [], "B3": [], "B4": [], "B5": []}  # + "B1_pyramid" below

    def rand(shape, dtype, scale=1.0):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(dev, dtype).contiguous()

    # B1: the five s2d convs of SpyNet's finest level (18 images, 128x224), bf16
    n, h, w = 2 * (T_WIN - 1), 128, 224
    shapes = [(32, 128, True), (128, 256, True), (256, 128, True), (128, 64, True), (64, 8, False)]
    cases = [(cin, cout, relu, torch.bfloat16, n) for cin, cout, relu in shapes]
    cases.append((128, 64, True, torch.float32, 2))  # one f32 shape (fewer images)
    # the flow cache's group: CHUNK pairs x 2 directions
    cases += [(cin, cout, relu, torch.bfloat16, 2 * CHUNK) for cin, cout, relu in shapes]
    for cin, cout, relu, dtype, nimg in cases:
        x = rand((nimg, h, w, cin), dtype)
        wt = rand((5, 5, cin, cout), dtype, 1.0 / np.sqrt(25 * cin))
        b = rand((cout,), torch.float32, 0.1)
        wp = pack_weights(wt) if cout % 64 == 0 else None  # as SpyNet's prepare packs them, once
        got = conv5x5_same(x, wt, b, relu, wp)
        want = conv5x5_same_plain(x, wt, b, relu)
        torch.cuda.synchronize()
        tag = f"B1 {nimg}x{h}x{w} {cin}->{cout} {str(dtype)[6:]}"
        err = check(tag, got, want, bf16_tol(want) if dtype == torch.bfloat16 else f32_tol(want))
        xn, wn, bb = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(), b.to(dtype)
        ms = cuda_ms(lambda: conv5x5_same(x, wt, b, relu, wp))
        plain_ms = cuda_ms(lambda: conv5x5_same_plain(x, wt, b, relu))
        lib_ms = cuda_ms(lambda: F.conv2d(xn, wn, bb, padding=2))
        flops = 2.0 * nimg * h * w * cin * cout * 25
        bms, by = bound(flops, nbytes(x, wt, b, got), dtype)
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by})")
        rows["B1"].append(dict(case=tag, main_path=dtype == torch.bfloat16 and nimg == n, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                               gflop=flops / 1e9))

    # B1 over one window's whole pyramid: SpyNet's six levels (426x240 is
    # resized to 448x256, then halved five times; the s2d convs run at half
    # each level's size), five convs each, 30 launches, bf16
    pyramid = []
    for lvl in range(6):
        lh, lw = h >> lvl, w >> lvl
        lv = dict(level=f"{n}x{lh}x{lw}", ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
        for cin, cout, relu in shapes:
            x = rand((n, lh, lw, cin), torch.bfloat16)
            wt = rand((5, 5, cin, cout), torch.bfloat16, 1.0 / np.sqrt(25 * cin))
            b = rand((cout,), torch.float32, 0.1)
            wp = pack_weights(wt) if cout % 64 == 0 else None
            got = conv5x5_same(x, wt, b, relu, wp)
            want = conv5x5_same_plain(x, wt, b, relu)
            torch.cuda.synchronize()
            tag = f"B1 pyramid {n}x{lh}x{lw} {cin}->{cout}"
            lv["max_abs_err"] = max(lv["max_abs_err"], check(tag, got, want, bf16_tol(want)))
            xn, wn, bb = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(), b.to(torch.bfloat16)
            lv["ms"] += cuda_ms(lambda: conv5x5_same(x, wt, b, relu, wp))
            lv["library_ms"] += cuda_ms(lambda: F.conv2d(xn, wn, bb, padding=2))
            lv["bound_ms"] += bound(2.0 * n * lh * lw * cin * cout * 25, nbytes(x, wt, b, got), torch.bfloat16)[0]
        pyramid.append(lv)
        log(f"    level {lv['level']}: B1 {lv['ms']:.4f} ms, library {lv['library_ms']:.4f}, "
            f"bound {lv['bound_ms']:.4f} (five convs)")
    rows["B1_pyramid"] = dict(levels=pyramid, launches=B1_PER_WINDOW, ms=sum(lv["ms"] for lv in pyramid),
                              library_ms=sum(lv["library_ms"] for lv in pyramid),
                              bound_ms=sum(lv["bound_ms"] for lv in pyramid))
    log(f"  B1 over one window's six levels ({B1_PER_WINDOW} launches): {rows['B1_pyramid']['ms']:.4f} ms, "
        f"library {rows['B1_pyramid']['library_ms']:.4f}, bound {rows['B1_pyramid']['bound_ms']:.4f}")

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
    # bf16, with the weights packed once as BasicBlock.prepare packs them; a
    # ragged 37x53 map (neither side a multiple of the 14 tile); and the
    # blocks of 16 (E 96, M 13), 32 (E 192, M 26) and 64 units at full width
    # (f32) and ragged (bf16)
    from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import block_shape
    from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import pack_weights as pack_b3

    hl, wl = SR_HR[0] // SR_SCALE, SR_HR[1] // SR_SCALE
    b3_cases = [(1, SR_UNITS, hh, ww, dt) for hh, ww in ((hl, wl), (37, 53)) for dt in (torch.float32, torch.bfloat16)]
    b3_cases += [(1, u, hh, ww, dt) for u in (16, 32, 64) for hh, ww, dt in ((hl, wl, torch.float32),
                                                                            (37, 53, torch.bfloat16))]
    # the training step's batch of LR patches (cli/pretrain.py)
    b3_cases += [(TRAIN_BATCH, SR_UNITS, TRAIN_PATCH, TRAIN_PATCH, dt) for dt in (torch.float32, torch.bfloat16)]
    for nb, c, hh, ww, dtype in b3_cases:
        _, e, m, _ = block_shape(c)
        x = rand((nb, hh, ww, c), dtype)
        ws = [rand((c, e), torch.float32, c ** -0.5), rand((e,), torch.float32, 0.2),
              rand((e, m), torch.float32, e ** -0.5), rand((m,), torch.float32, 0.2),
              rand((3, 3, m, c), torch.float32, (9 * m) ** -0.5), rand((c,), torch.float32, 0.2)]
        ws = [w.to(dtype).float() for w in ws]  # as a bf16 model's prepare() holds them
        packed = pack_b3(*ws, dtype)
        got = fused_wdsr_block(x, *ws, packed=packed)
        want = fused_wdsr_block_plain(x, *ws)
        torch.cuda.synchronize()
        tag = f"B3 {nb}x{hh}x{ww}x{c} E{e} M{m} k3 {str(dtype)[6:]}"
        err = check(tag, got, want, bf16_tol(want) if dtype == torch.bfloat16 else f32_tol(want))
        ms = cuda_ms(lambda: fused_wdsr_block(x, *ws, packed=packed))
        plain_ms = cuda_ms(lambda: fused_wdsr_block_plain(x, *ws))
        # one library chain for the same function: cuDNN 1x1, ReLU, 1x1, 3x3 + residual
        xn = x.permute(0, 3, 1, 2)
        lw = [ws[0].t()[:, :, None, None].to(dtype), ws[1].to(dtype), ws[2].t()[:, :, None, None].to(dtype),
              ws[3].to(dtype), ws[4].permute(3, 2, 0, 1).contiguous().to(dtype), ws[5].to(dtype)]
        lib_ms = cuda_ms(lambda: xn + F.conv2d(F.conv2d(F.relu(F.conv2d(xn, lw[0], lw[1])), lw[2], lw[3]),
                                               lw[4], lw[5], padding=1))
        px = nb * hh * ww
        flops = 2.0 * px * (c * e + e * m + 9 * m * c)
        bms, by, basis = bound_by_route([(flops, route(dtype))], nbytes(x, got, *ws))
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by}; {basis})")
        rows["B3"].append(dict(case=tag, main_path=(nb, c, hh, dtype) == (1, SR_UNITS, hl, torch.float32),
                               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                               bound_by=by, bound_basis=basis, gflop=flops / 1e9))

    # B4: the WDSR tail at full width, body 24 -> 12 (3x3) + skip 3 -> 12
    # (5x5), s 2, f32 (the main path) and bf16, with the weights packed once
    # as BasicModel.prepare packs them; then s 3 and 4 (27, 48 conv channels)
    # and ResultNet's body widths 18, 21, 32, f32 and bf16
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import _skip_plan
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import pack_weights as pack_b4

    b4_cases = [(1, hl, wl, c, s, dt) for c, s in ((SR_UNITS, SR_SCALE), (SR_UNITS, 3), (SR_UNITS, 4), (18, 2),
                                                   (21, 2), (32, 2)) for dt in (torch.float32, torch.bfloat16)]
    # the training step's batch of LR patches (cli/pretrain.py)
    b4_cases += [(TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, SR_UNITS, SR_SCALE, dt) for dt in (torch.float32,
                                                                                          torch.bfloat16)]
    for nb, hh, ww, c, s, dtype in b4_cases:
        cc = 3 * s * s
        x = rand((nb, hh, ww, c), dtype)
        xs = rand((nb, hh, ww, 3), dtype, 0.5)
        kern = rand((3, 3, c, cc), dtype, (9 * c) ** -0.5)
        ks = rand((5, 5, 3, cc), dtype, 75 ** -0.5)
        b = rand((cc,), torch.float32, 0.5)
        packed = pack_b4(kern, ks, b, dtype)
        got = fused_conv_pixel_shuffle_skip(x, kern, b, s, xs, ks, packed=packed)
        want = fused_conv_pixel_shuffle_skip_plain(x, kern, b, s, xs, ks)
        torch.cuda.synchronize()
        tag = f"B4 {nb}x{hh}x{ww}x{c} 3x3 + skip 3ch 5x5 s{s} -> {tuple(got.shape)} {str(dtype)[6:]}"
        err = check(tag, got, want, bf16_tol(want) if dtype == torch.bfloat16 else f32_tol(want))
        ms = cuda_ms(lambda: fused_conv_pixel_shuffle_skip(x, kern, b, s, xs, ks, packed=packed))
        plain_ms = cuda_ms(lambda: fused_conv_pixel_shuffle_skip_plain(x, kern, b, s, xs, ks))
        xn, xsn = x.permute(0, 3, 1, 2), xs.permute(0, 3, 1, 2)
        kn, ksn, bb = kern.permute(3, 2, 0, 1).contiguous(), ks.permute(3, 2, 0, 1).contiguous(), b.to(dtype)
        lib_ms = cuda_ms(lambda: F.pixel_shuffle(F.conv2d(xn, kn, bb, padding=1) + F.conv2d(xsn, ksn, padding=2), s))
        flops = 2.0 * nb * hh * ww * (9 * c + 25 * 3) * cc  # the useful work, whatever the kernel issues
        bms, by, basis = bound_by_route([(flops, route(dtype))], nbytes(x, xs, kern, ks, b, got))
        _, run, _, run2, npad = _skip_plan(c, cc, dtype)
        k_issued, k_useful = (3 * run, 5 * run2, npad), (9 * c, 75, cc)
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by}; {basis}); "
            f"K issued body {k_issued[0]} / skip {k_issued[1]} / N {k_issued[2]}, useful {k_useful}")
        rows["B4"].append(dict(case=tag, main_path=(nb, c, s, dtype) == (1, SR_UNITS, SR_SCALE, torch.float32),
                               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                               bound_by=by, bound_basis=basis, gflop=flops / 1e9, k_issued=k_issued,
                               k_useful=k_useful))

    # B5: one ConvSep branch at the search's shape, (16, 48, 48, 32) -> 32 for
    # k = 3, 5, 7 in f32 (the main path: the three branches of one block),
    # each also with the device time per launch (torch.profiler) and the
    # wrapper's host time per call; the supernet eval shape (1, 678, 1020, 32)
    # at k = 3, 5, 7 in f32 and k 7 in bf16; ragged 37x53 maps at 32 channels
    # and at 16, 48 and 24 -> 40 (C != C_out)
    b5_cases = [(NAS_BATCH, NAS_PATCH, NAS_PATCH, NAS_UNITS, NAS_UNITS, k, torch.float32, True) for k in (3, 5, 7)]
    b5_cases += [(1, hl, wl, NAS_UNITS, NAS_UNITS, k, torch.float32, False) for k in (3, 5, 7)]
    b5_cases += [(1, hl, wl, NAS_UNITS, NAS_UNITS, 7, torch.bfloat16, False)]
    b5_cases += [(2, 37, 53, NAS_UNITS, NAS_UNITS, 7, dt, False) for dt in (torch.float32, torch.bfloat16)]
    b5_cases += [(2, 37, 53, ci, co, k, dt, False) for ci, co in ((16, 16), (48, 48), (24, 40))
                 for k, dt in ((3, torch.float32), (7, torch.bfloat16))]
    for nb, hh, ww, c, co, k, dtype, on_path in b5_cases:
        x = rand((nb, hh, ww, c), dtype)
        ws = [rand((k, k, c), torch.float32, 1.0 / k), rand((c,), torch.float32, 0.2),
              rand((c, co), torch.float32, c ** -0.5), rand((co,), torch.float32, 0.2)]
        ws = [w.to(dtype).float() for w in ws]  # as the supernet in bf16 rounds them
        got = fused_convsep(x, *ws)
        want = fused_convsep_plain(x, *ws)
        torch.cuda.synchronize()
        tag = f"B5 {nb}x{hh}x{ww}x{c} k{k} -> {co} {str(dtype)[6:]}"
        err = check(tag, got, want, bf16_tol(want) if dtype == torch.bfloat16 else f32_tol(want))
        ms = cuda_ms(lambda: fused_convsep(x, *ws))
        plain_ms = cuda_ms(lambda: fused_convsep_plain(x, *ws))
        # one library chain for the same function: cuDNN depthwise + bias, ReLU, 1x1 + bias
        xn = x.permute(0, 3, 1, 2)
        lw = [ws[0].permute(2, 0, 1)[:, None].contiguous().to(dtype), ws[1].to(dtype),
              ws[2].t()[:, :, None, None].contiguous().to(dtype), ws[3].to(dtype)]
        lib_ms = cuda_ms(lambda: F.conv2d(F.relu(F.conv2d(xn, lw[0], lw[1], padding=k // 2, groups=c)), lw[2], lw[3]))
        px = nb * hh * ww
        work = [(2.0 * px * k * k * c, "f32"), (2.0 * px * c * co, route(dtype))]  # depthwise, 1x1
        bms, by, basis = bound_by_route(work, nbytes(x, got, *ws))
        row = dict(case=tag, main_path=on_path, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bms, bound_by=by, bound_basis=basis, gflop=sum(f for f, _ in work) / 1e9)
        extra = ""
        if on_path:
            row["device_ms"], seen = device_ms_per_launch(lambda: fused_convsep(x, *ws), "convsep")
            row["host_us"] = host_us(lambda: fused_convsep(x, *ws))
            extra = f"; device {row['device_ms']:.4f} ms per launch ({seen} seen), host {row['host_us']:.1f} us per call"
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by}; {basis}){extra}")
        rows["B5"].append(row)
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

    # steady-state forward of one 10-frame window, the mean of 15 timed
    # forwards (three repeats of five, each repeat's mean kept to show host
    # stalls: the window issues ~1,000 launches), and the flow stage alone
    x = torch.from_numpy(np.stack(frames[:T_WIN])[None]).to(dev)
    with torch.inference_mode():
        win_repeats = [cuda_ms(lambda: model(x, OH, OW), iters=5, warmup=2) for _ in range(3)]
        win_ms = sum(win_repeats) / len(win_repeats)
        xb = x.to(torch.bfloat16)
        flow_ms = cuda_ms(lambda: compute_flows(model.spynet, xb), iters=5, warmup=1)
        sr = model(x, OH, OW)
    torch.cuda.synchronize()
    stats = dict(
        window_ms=win_ms, window_ms_repeats=win_repeats, fps=T_WIN / win_ms * 1e3, spynet_flows_ms=flow_ms,
        stream_frames=len(out), stream_windows=windows, stream_wall_s=wall,
        stream_fps_end_to_end=len(out) / wall, launches=launches,
        out_min=float(sr.min()), out_max=float(sr.max()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(f"  window forward {win_ms:.3f} ms = {stats['fps']:.2f} frames/s "
        f"(repeats {', '.join(f'{r:.3f}' for r in win_repeats)} ms); "
        f"SpyNet flows {flow_ms:.3f} ms; output range [{stats['out_min']:.3f}, {stats['out_max']:.3f}]")
    return stats, launches, windows, (model, frames, out)


def run_stream(stream, frames):
    """Push ``frames`` through a fresh stream and flush it: (outputs, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    for fr in frames:
        out.extend(stream.push(fr))
    out.extend(stream.flush())
    return out, time.perf_counter() - t0


def phase_flow_cache(dev, model, frames, plain_out):
    """The flow-cached stream (serve/flow_cache.py) on phase_serving's model,
    weights and frames: its output against the plain stream's, each pair
    flow computed once, B1's launches 30 per flow group and B2's one per
    window; then sr_fn's ms per window and flow_fn's per group, both streams'
    frames/s end to end (plain, cached, cached, plain), and one
    flow_downscale 2 window."""
    from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.models.basicvsr import compute_flows
    from mobilesuperresolution_tpu_torch.serve import FlowCachedStreamingVSR, StreamingVSR, make_flow_sr_fns
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    flow_fn, sr_fn = make_flow_sr_fns(model, OH, OW)
    groups = []

    def counted_flow(ref, supp):
        groups.append(ref.shape[0])
        return flow_fn(ref, supp)

    def cached_stream(flow=flow_fn):
        return FlowCachedStreamingVSR(flow, sr_fn, OH, OW, chunk=CHUNK, overlap=OVERLAP, device=dev)

    stream = cached_stream(counted_flow)
    stream.warmup((H_LR, W_LR, 3))
    torch.cuda.synchronize()
    groups.clear()
    computed = []
    ensure = stream._ensure_flows

    def spying(pairs):
        computed.extend(k for k in dict.fromkeys(pairs) if k not in stream._pair_flows)
        return ensure(pairs)

    stream._ensure_flows = spying
    conv5x5_same.launches = 0
    fused_conv_pixel_shuffle.launches = 0
    out, wall = run_stream(stream, frames)
    launches = {"B1": conv5x5_same.launches, "B2": fused_conv_pixel_shuffle.launches}
    windows = len(range(0, N_STREAM_FRAMES, CHUNK))
    n = N_STREAM_FRAMES
    log(f"  cached stream: {len(out)} frames, {windows} windows, {len(groups)} flow groups of {groups[0]} pair "
        f"samples, {len(computed)} pairs computed; launches {launches}")
    if len(out) != n:
        raise AssertionError(f"{len(out)} cached output frames, expected {n}")
    want = torch.from_numpy(np.stack(plain_out))
    err = check("cached stream vs plain stream (bf16)", torch.from_numpy(np.stack(out)), want, bf16_tol(want))
    if len(computed) != len(set(computed)) or set(computed) != {(i, i + 1) for i in range(n - 1)} | {(0, 0),
                                                                                                  (n - 1, n - 1)}:
        raise AssertionError(f"pairs computed {computed}")
    if launches != {"B1": B1_PER_WINDOW * len(groups), "B2": B2_PER_WINDOW * windows}:
        raise AssertionError(f"cached stream launches {launches} for {len(groups)} groups, {windows} windows")

    x = torch.from_numpy(np.stack(frames[:T_WIN])[None]).to(dev)
    with torch.inference_mode():
        ff, fb = compute_flows(model.spynet, x.to(torch.bfloat16))
        sr_ms = cuda_ms(lambda: sr_fn(x, ff, fb), iters=5, warmup=2)
        ab = x[0, : 2 * CHUNK]
        ba = torch.cat([ab[CHUNK:], ab[:CHUNK]])
        flow_ms = cuda_ms(lambda: flow_fn(ab, ba), iters=5, warmup=2)

    def plain_stream():
        def apply_fn(xx, oh, ow):
            with torch.inference_mode():
                return model(xx, oh, ow)

        return StreamingVSR(apply_fn, OH, OW, chunk=CHUNK, overlap=OVERLAP, device=dev)

    walls = {"plain": [], "cached": []}
    for kind in ("plain", "cached", "cached", "plain"):
        walls[kind].append(run_stream(plain_stream() if kind == "plain" else cached_stream(), frames)[1])
    fps = {k: [n / w for w in v] for k, v in walls.items()}
    log(f"  sr_fn {sr_ms:.3f} ms per window + flow_fn {flow_ms:.3f} ms per group of {CHUNK} pairs = "
        f"{sr_ms + flow_ms:.3f} ms per steady window ({CHUNK / (sr_ms + flow_ms) * 1e3:.2f} output frames/s); "
        f"end to end (plain, cached, cached, plain): plain {fps['plain']} frames/s, cached {fps['cached']}")

    # one flow_downscale 2 window: SpyNet on 213x120 frames
    m2 = get_vsr_model("basic", scale=4, compute_dtype=torch.bfloat16, device=dev, flow_downscale=2)
    load_params_npz(m2, random_jax_params(m2, seed=0))
    conv5x5_same.launches = 0
    with torch.inference_mode():
        y = m2(x, OH, OW)
        torch.cuda.synchronize()
        ds_launches = conv5x5_same.launches
        ds_flow_ms = cuda_ms(lambda: compute_flows(m2.spynet, x.to(torch.bfloat16), 2), iters=5, warmup=2)
    if tuple(y.shape) != (1, T_WIN, OH, OW, 3) or not torch.isfinite(y).all():
        raise AssertionError(f"flow_downscale 2 window: {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
    log(f"  flow_downscale 2 window: finite {tuple(y.shape)}, SpyNet {ds_flow_ms:.3f} ms, B1 launches {ds_launches}")
    return dict(launches=launches, groups=len(groups), group_samples=groups[0], pairs_computed=len(computed),
                max_abs_err=err, wall_s=wall, sr_fn_ms=sr_ms, flow_fn_ms_per_group=flow_ms,
                steady_window_ms=sr_ms + flow_ms, steady_fps=CHUNK / (sr_ms + flow_ms) * 1e3,
                stream_fps_end_to_end=fps, downscale2=dict(spynet_ms=ds_flow_ms, b1_launches=ds_launches)), launches


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


def sisr_train_argv(job_dir):
    return ["--job_dir", job_dir, "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--scale",
            str(SR_SCALE), "--epochs", "1", "--num_patches", str(TRAIN_NUM_PATCHES), "--train_batch_size",
            str(TRAIN_BATCH), "--lr_patch_size", str(TRAIN_PATCH), "--learning_rate", "1e-3"]


def steady_step_ms(model, dev):
    """Mean ms of a SISR training step (make_sisr_step, Adam) over 10 steps on
    one fixed batch, CUDA events, after 3 warm-up steps; with the B3 and B4
    launches per step."""
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    g = torch.Generator().manual_seed(6)
    lr = torch.rand((TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3), generator=g).to(dev)
    hr = torch.rand((TRAIN_BATCH, SR_SCALE * TRAIN_PATCH, SR_SCALE * TRAIN_PATCH, 3), generator=g).to(dev)
    model.train()
    step = make_sisr_step(model, multistep_adam(jax_named_parameters(model), 1e-3, 100, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_sisr_launches()
    ms = cuda_ms(lambda: step((lr, hr)), iters=10, warmup=3)
    per_step = {k: v / 13 for k, v in sisr_launches().items()}
    return ms, per_step, torch.cuda.max_memory_allocated() / 2**30


def check_training_run(name, out, launches, per_forward, npz_keys, want_keys):
    steps = out["steps"]
    log(f"  {name}: {len(steps)} steps, losses {[round(s['loss'], 5) for s in steps]}, "
        f"{out['eval_images']} eval images, eval PSNR {out['eval'][-1]['synthetic_isr']['PSNR']:.4f}; "
        f"launches {launches}")
    if len(steps) != TRAIN_STEPS or not all(np.isfinite(s["loss"]) and s["skipped"] == 0 for s in steps):
        raise AssertionError(f"{name}: steps {[(s['loss'], s['skipped']) for s in steps]}")
    forwards = out["train_forwards"] + out["eval_images"]
    want = {k: v * forwards for k, v in per_forward.items()}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want} for {forwards} forwards")
    if npz_keys != want_keys:
        raise AssertionError(f"{name}: npz keys differ from the JAX layout: {sorted(npz_keys ^ want_keys)[:5]}")


def phase_pretrain(dev):
    """SISR pretraining through its entry point (cli/pretrain.py) at the
    pretraining launcher's width on synthetic_isr for one epoch; then the
    steady-state training step in f32 and bf16."""
    from mobilesuperresolution_tpu_torch.cli import pretrain
    from mobilesuperresolution_tpu_torch.models import get_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_param_shapes, load_params_npz, random_jax_params

    with tempfile.TemporaryDirectory() as job_dir:
        argv = sisr_train_argv(job_dir) + ["--num_blocks", str(SR_BLOCKS), "--num_residual_units", str(SR_UNITS)]
        reset_sisr_launches()
        t0 = time.perf_counter()
        out = pretrain.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sisr_launches()
        npz_keys = set(np.load(os.path.join(job_dir, "weights", "models.npz")).keys())
    stats = dict(steps=out["steps"], eval=out["eval"], train_forwards=out["train_forwards"],
                 eval_images=out["eval_images"], wall_s=wall, launches=launches)
    for name, bf16 in (("f32", False), ("bf16", True)):
        params = argparse.Namespace(model_type="BASIC_MODEL", num_blocks=SR_BLOCKS, num_residual_units=SR_UNITS,
                                    scale=SR_SCALE, bf16=bf16)
        model = get_model(params, device=dev)
        if name == "f32":
            check_training_run("cli.pretrain", out, launches, {"B3": B3_PER_IMAGE, "B4": B4_PER_IMAGE}, npz_keys,
                               set(jax_param_shapes(model)))
        load_params_npz(model, random_jax_params(model, seed=0))
        ms, per_step, peak = steady_step_ms(model, dev)
        stats[f"step_ms_{name}"], stats[f"step_launches_{name}"], stats[f"step_peak_gib_{name}"] = ms, per_step, peak
        log(f"  pretrain step {name}: {ms:.3f} ms (batch {TRAIN_BATCH}, {TRAIN_PATCH}x{TRAIN_PATCH}), launches per "
            f"step {per_step}, peak {peak:.3f} GiB")
        del model
    return stats, launches


def phase_retrain(dev):
    """Retraining of the searched net through its entry point
    (cli/retrain_searched.py) on artifacts/search_depth_tpu/block_index.txt
    for one epoch; then the steady-state step (f32)."""
    from mobilesuperresolution_tpu_torch.cli import retrain_searched
    from mobilesuperresolution_tpu_torch.models import ResultNet
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_param_shapes, load_params_npz, random_jax_params

    block_index = os.path.join(ROOT, "artifacts", "search_depth_tpu", "block_index.txt")
    with tempfile.TemporaryDirectory() as job_dir:
        reset_sisr_launches()
        t0 = time.perf_counter()
        out = retrain_searched.main(sisr_train_argv(job_dir) + ["--block_index", block_index])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sisr_launches()
        npz_keys = set(np.load(os.path.join(job_dir, "weights", "models.npz")).keys())
    model = ResultNet.from_artifact(block_index, scale=SR_SCALE).to(dev)
    check_training_run("cli.retrain_searched", out, launches, {"B3": 0, "B4": 1}, npz_keys,
                       set(jax_param_shapes(model)))
    load_params_npz(model, random_jax_params(model, seed=0))
    ms, per_step, peak = steady_step_ms(model, dev)
    log(f"  retrain step f32 ({model.idx}): {ms:.3f} ms, launches per step {per_step}, peak {peak:.3f} GiB")
    return dict(steps=out["steps"], eval=out["eval"], train_forwards=out["train_forwards"],
                eval_images=out["eval_images"], wall_s=wall, launches=launches, idx=model.idx, step_ms_f32=ms,
                step_launches_f32=per_step, step_peak_gib_f32=peak)


def phase_train_parity(dev):
    """Three SISR training steps of a tiny float32 WDSR-B (2 blocks, 24 units,
    x2) on the card against the CPU: per-step losses, and every parameter's
    gradient of the first step (the same weights on both sides)."""
    from mobilesuperresolution_tpu_torch.models import BasicModel
    from mobilesuperresolution_tpu_torch.train.checkpoint import (
        jax_named_parameters,
        load_params_npz,
        random_jax_params,
    )
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    g = torch.Generator().manual_seed(9)
    batches = [(torch.rand((2, 20, 22, 3), generator=g), torch.rand((2, 40, 44, 3), generator=g)) for _ in range(3)]
    runs = []
    for d in ("cpu", dev):
        m = BasicModel(num_blocks=2, num_residual_units=SR_UNITS, scale=SR_SCALE).to(d)
        load_params_npz(m, random_jax_params(m, seed=5))
        m.train()
        named = jax_named_parameters(m)
        step = make_sisr_step(m, multistep_adam(named, 1e-3, 3, 1))
        losses = []
        for i, (lr, hr) in enumerate(batches):
            losses.append(float(step((lr.to(d), hr.to(d)))["loss"]))
            if i == 0:
                grads = {k: p.grad.cpu() for k, p in named.items()}
        runs.append((losses, grads))
    (l0, g0), (l1, g1) = runs
    lerr = max(abs(a - b) for a, b in zip(l0, l1))
    gerr = max(float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-3) for k in g0)
    log(f"  losses card {l1}, CPU {l0}: max difference {lerr:.3e}; first-step gradients of {len(g0)} parameters: "
        f"max difference {gerr:.3e} of each one's largest (tol 1e-4)")
    if not (lerr <= 1e-4 and gerr <= 1e-4):
        raise AssertionError(f"tiny training steps: losses differ by {lerr}, gradients by {gerr}")
    return {"loss_err": lerr, "grad_err_rel": gerr}


def phase_nas_parity(dev):
    """Tiny supernet, card vs CPU: the forward and one search step's
    gradients of every parameter (the step at LR 0 leaves the weights)."""
    from mobilesuperresolution_tpu_torch.models import NASModel
    from mobilesuperresolution_tpu_torch.nas.speed_estimator import get_ori_speed
    from mobilesuperresolution_tpu_torch.nas.speed_loss import SpeedLoss
    from mobilesuperresolution_tpu_torch.train.checkpoint import (
        jax_named_parameters,
        load_params_npz,
        random_jax_params,
    )
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_search_step

    rng = np.random.default_rng(3)
    lr = torch.from_numpy(rng.random((2, 24, 20, 3), dtype=np.float32))
    hr = torch.from_numpy(rng.random((2, 48, 40, 3), dtype=np.float32))
    ori = get_ori_speed(2, 8)
    outs = []
    for d in ("cpu", dev):
        m = NASModel(num_blocks=2, num_residual_units=8, scale=2).to(d)
        load_params_npz(m, random_jax_params(m, seed=3))
        with torch.no_grad():
            sr, speed = m(lr.to(d))
        named = jax_named_parameters(m)
        step = make_search_step(m, multistep_adam(named, 0.0, 1, 1), SpeedLoss(scale=0.5 * ori))
        metrics = step((lr.to(d), hr.to(d)), 0.5 * ori)
        outs.append((sr.cpu(), float(speed), float(metrics["loss"]), {k: p.grad.cpu() for k, p in named.items()}))
    (sr0, sp0, l0, g0), (sr1, sp1, l1, g1) = outs
    err = check("tiny supernet sr f32 card vs CPU", sr1, sr0, 1e-4)
    if not (abs(sp1 - sp0) <= 1e-4 and abs(l1 - l0) <= 1e-4):
        raise AssertionError(f"tiny supernet: speed {sp1} vs {sp0}, loss {l1} vs {l0}")
    gerr = max(float((g1[k] - g0[k]).abs().max()) for k in g0)
    log(f"  speed {sp1:.4f} (CPU {sp0:.4f}), loss {l1:.6f} (CPU {l0:.6f}); "
        f"max gradient difference over {len(g0)} parameters {gerr:.3e} (tol 1e-4)")
    if not gerr <= 1e-4:
        raise AssertionError(f"tiny supernet gradients differ by {gerr}")
    return {"sr_err": err, "grad_err": gerr}


def phase_search(dev):
    """The NAS search through its entry point at the launcher's width, then
    the steady-state search step and supernet eval forward."""
    from mobilesuperresolution_tpu_torch.cli import search
    from mobilesuperresolution_tpu_torch.kernels.fused_convsep import fused_convsep
    from mobilesuperresolution_tpu_torch.models import get_model
    from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
    from mobilesuperresolution_tpu_torch.nas.speed_estimator import get_ori_speed
    from mobilesuperresolution_tpu_torch.nas.speed_loss import SpeedLoss
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, jax_param_shapes
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_search_step

    with tempfile.TemporaryDirectory() as job_dir:
        argv = ["--job_dir", job_dir, "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr",
                "--scale", "2", "--num_blocks", str(NAS_BLOCKS), "--num_residual_units", str(NAS_UNITS),
                "--width_search", "--speed_target", "500", "--width_epochs", "1", "--epochs", "1",
                "--kernel_epochs", "1", "--num_patches", str(NAS_NUM_PATCHES), "--train_batch_size",
                str(NAS_BATCH), "--lr_patch_size", str(NAS_PATCH), "--learning_rate", "1e-3", "--log_steps", "1"]
        fused_convsep.launches = 0
        t0 = time.perf_counter()
        out = search.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B5": fused_convsep.launches}
        idx, width = read_block_index(job_dir)
        npz_keys = set(np.load(os.path.join(job_dir, "weights", "models.npz")).keys())
    steps = out["steps"]
    log(f"  cli.search: {len(steps)} steps ({[s['phase'] for s in steps]}), {out['eval_images']} eval images, "
        f"{wall:.1f} s; B5 launches {launches['B5']}")
    for s in steps:
        log(f"    {s['phase']} e{s['epoch']} b{s['batch']}: loss {s['loss']:.5f} l1 {s['l1']:.5f} "
            f"speed {s['speed']:.3f} / {s['target']:.3f} skipped {s['skipped']:.0f}")
    n_steps = 3 * (8 * NAS_NUM_PATCHES // NAS_BATCH)  # three phases of one epoch, synthetic_isr has 8 images
    if len(steps) != n_steps or not all(np.isfinite([s[k] for k in ("loss", "l1", "speed")]).all() for s in steps):
        raise AssertionError(f"search: {len(steps)} steps, finite {[np.isfinite(s['loss']) for s in steps]}")
    want = B5_PER_FORWARD * (out["train_forwards"] + out["eval_images"])
    if launches["B5"] != want:
        raise AssertionError(f"search: B5 launches {launches['B5']}, expected {want}")
    if (idx, width) != (out["remain_idx"], out["remain_width"]) or len(width) != len(idx):
        raise AssertionError(f"block_index.txt last line {(idx, width)} != {(out['remain_idx'], out['remain_width'])}")
    params = argparse.Namespace(model_type="NAS_MODEL", num_blocks=NAS_BLOCKS, num_residual_units=NAS_UNITS,
                                scale=2, seed=0, width_search=True)
    model = get_model(params, device=dev)
    want_keys = set(jax_param_shapes(model))
    if npz_keys != want_keys:
        raise AssertionError(f"weights npz keys differ from the JAX layout: {sorted(npz_keys ^ want_keys)[:5]}")
    log(f"  final arch {len(idx)} blocks: {width}")
    log(f"  eval PSNR per epoch: {[round(e['synthetic_isr']['PSNR'], 4) for e in out['eval']]}")

    # steady state: one search step on a fixed batch, and one 678x1020 eval forward
    g = torch.Generator().manual_seed(5)
    lr = torch.rand((NAS_BATCH, NAS_PATCH, NAS_PATCH, 3), generator=g).to(dev)
    hr = torch.rand((NAS_BATCH, 2 * NAS_PATCH, 2 * NAS_PATCH, 3), generator=g).to(dev)
    ori = get_ori_speed(NAS_BLOCKS, NAS_UNITS)
    step = make_search_step(model, multistep_adam(jax_named_parameters(model), 1e-3, 100, 1),
                            SpeedLoss(scale=ori - 500.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step((lr, hr), 500.0), iters=10, warmup=3)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    x = torch.rand((1, SR_HR[0] // 2, SR_HR[1] // 2, 3), generator=g).to(dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        eval_ms = cuda_ms(lambda: model(x), iters=5, warmup=2)
        sr, speed = model(x)
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    if tuple(sr.shape) != (1, SR_HR[0], SR_HR[1], 3) or not torch.isfinite(sr).all():
        raise AssertionError(f"supernet eval: output {tuple(sr.shape)}, finite {bool(torch.isfinite(sr).all())}")
    log(f"  search step {step_ms:.3f} ms (batch {NAS_BATCH}, {NAS_PATCH}x{NAS_PATCH}), peak {step_peak:.3f} GiB; "
        f"supernet eval {eval_ms:.3f} ms per {x.shape[1]}x{x.shape[2]} image, peak {eval_peak:.3f} GiB")
    stats = dict(steps=steps, eval=out["eval"], train_forwards=out["train_forwards"], eval_images=out["eval_images"],
                 wall_s=wall, launches=launches, remain_idx=idx, remain_width=width, step_ms=step_ms,
                 step_peak_mem_gib=step_peak, eval_ms=eval_ms, eval_peak_mem_gib=eval_peak,
                 eval_speed_ms=float(speed))
    return stats, launches


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
            for line in ptxas_summary(os.path.join(_build.BUILD_DIR, f"{name}.log")):
                log(f"  {name}: {line}")
        report["build_s"] = secs

        log("kernels vs plain:")
        rows = phase_kernels(torch.Generator().manual_seed(0), dev)
        report["kernel_cases"] = rows
        log("small-model parity:")
        report["tiny_parity_err"] = phase_small_parity(dev)
        log("full-width serving:")
        stats, launches, windows, served = phase_serving(dev)
        report["serving"] = stats
        log("flow-cached serving at full width:")
        report["flow_cache"], launches = phase_flow_cache(dev, *served)
        del served
        log("small SISR parity:")
        report["tiny_sisr_parity_err"] = phase_sisr_parity(dev)
        log("shipped SISR weights and the eval entry point:")
        report["shipped"] = phase_shipped(dev)
        log("full-width SISR:")
        report["sisr"], sisr_main = phase_sisr_full(dev)
        log("SISR pretraining at full width:")
        report["pretrain"], train_main = phase_pretrain(dev)
        log("searched-net retraining:")
        report["retrain"] = phase_retrain(dev)
        log("tiny SISR training steps, card vs CPU:")
        report["train_parity"] = phase_train_parity(dev)
        log("small NAS supernet parity:")
        report["tiny_nas_parity"] = phase_nas_parity(dev)
        log("NAS search at full width:")
        report["search"], search_main = phase_search(dev)
        report["launches_sisr_eval"] = sisr_main
        launches = {**launches, **train_main, **search_main}
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
        entry("fused_convsep", "mobilesuperresolution_tpu_torch/csrc/fused_convsep.cu",
              "mobilesuperresolution_tpu/kernels/fused_convsep.py:68", "B5"),
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
