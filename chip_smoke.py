"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
1. device name, and the card's name and power limit from nvidia-smi;
2. build the hand kernels from mobilesuperresolution_tpu_torch/csrc with nvcc
   (ptxas's registers and spills per kernel; Q1's s8 wgmma in its SASS, and
   the tf32 tensor-core instructions of B1's and B2's f32 routes in theirs,
   with ptxas's C75xx notes);
3. each kernel against its plain PyTorch version on the card at the shapes
   the main path gives it, with kernel / plain / library-call times and the
   kernel's roofline bound (at the rate of the unit each product runs on:
   CUDA-core f32, 3xTF32 or bf16 tensor cores, named in the row); every f32
   case of B1 and B2 also twice against itself, bit for bit (B1's 8-warp
   f32 tiles on wgmma also against its mma.sync route), and B1 f32 at N =
   1, ragged 37x53 maps with channel tails, a 4x7 level and 128 samples at
   1x1, B2 f32 at odd crops, Cin 16 and 40 and the 3x3 form at s 3;
   B1 over all six pyramid levels of one window (30 launches), per level and
   summed, against cuDNN; B3 and B5 also at other widths (B3 16, 32, 64
   units; B5 16, 48, 24 -> 40 channels) and B5 at the eval shape for k 3, 5,
   7; B4 (3xTF32 / bf16 tensor cores) at x2, x3, x4 and at 18, 21, 24, 32
   body channels, with its issued against useful K; B5's search-shape cases
   with their device time per launch (torch.profiler) and the wrapper's
   host time per call; B1 at the flow cache's group (8 pair samples) and B3
   and B4 at the training step's batch (16 x 48x48) too; B1 over the VSR
   training step's six SpyNet levels (36 samples, f32: 30 launches, per
   level and summed, against cuDNN) and B2
   at its tail (20 x 64x64, f32 and bf16); B2 at 'single''s tail (2x2 over
   32 channels) and 'multi''s decode (3x3 over 18), f32 and bf16 at the
   training shape, and the decode at the serving window in bf16; B2 past
   64 conv channels at 'basic_origin''s upconvs (3x3, s 2, 64 -> 256, the
   leaky ReLU fused) at the serving window (bf16, 240x426 and 480x852) and
   the training step (f32, 20 x 64x64 and 128x128), with the library call
   (cuDNN conv, pixel_shuffle, leaky_relu); B4 at 'multi_v1''s tail (20 x
   64x64, body 18, s 4), f32 and bf16;
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
   device memory;
11. VSR training through its entry point (cli/train_vsr.py) at
   launchers/video_train_basic.sh's width (basic nf 24, 8 blocks, x4,
   10-frame clips, batch 2, 64x64 LR patches, lr 1e-4, f32) on synthetic_vsr
   (4 clips of 10 512x512 frames), two epochs of 4 steps with a whole-clip
   eval after each: finite losses, B1 30 and B2 once per forward, a weights
   npz with exactly the JAX model's keys and shapes, SpyNet bit-untouched;
   then the steady step in f32 and bf16 (CUDA events) with its device-busy
   share, launches and top kernels (torch.profiler);
12. resume round trips: that run stopped by --max_steps_per_run mid-epoch
   and resumed with --resume against the uninterrupted one (within the Adam
   drift bound, bit-equality reported), cli.pretrain the same way at a small
   depth, and cli.search stopped inside its width phase, whose resume
   finishes every phase;
13. cli/test_vsr.py on the trained npz: whole clips (the run's last eval
   PSNR), and bf16 windows plain and flow-cached, which agree;
14. three tiny VSR training steps on the card against the CPU, and
   FusedConvPixelShuffleFn's forward and gradients against autograd through
   the plain version at the training tail and a ragged shape, f32 and bf16;
15. a tiny float32 'single', 'multi', 'basic_mv', 'multi_v1' and
   'basic_origin' on the card against the CPU: the forward (B1 / B2 / B4 per
   forward as ZOO_PER_FORWARD) and two training steps;
16. cli/train_vsr.py for 'single' (32 channels, 8 blocks) and 'multi' (the
   search artifact's last line: 18 channels, one k7 block) at their
   launchers' width (x4, batch 2 x 10 frames, 64x64, lr 1e-4, f32) on the
   basic run's data, one epoch of 4 steps and a whole-clip eval: finite
   losses, B1 / B2 per forward ('single' 0 / 1, 'multi' 30 / 1), the JAX
   layout, 'multi''s flownet untouched; the steady step in f32 and bf16 with
   its busy share; cli/test_vsr.py on each npz;
17. cli/test_vsr_by_patch.py at launchers/video_test_patch.sh's settings
   (basic x4 on phase 11's npz, 64x64 patches, overlap 4/0, image_batch 10)
   on one synthetic 10-frame clip at REDS's 720x1280: the 4x100 array,
   finite, B1 30 and B2 1 per patch batch; the forward ms per patch batch
   (1 and 10 patches) and the patches per second end to end;
18. cli/serve.py streaming 'multi' (bf16, chunk 4, overlap 3) over 16
   426x240 frames: 16 1704x960 frames, B1 30 and B2 1 per window;
19. a REDS-with-MV tree written from a seed (4 clips of 10 512x512 frames
   whose LR frames translate by MV_SHIFT, motion.npy holding that shift):
   data/reds_with_mv.py's items carry it, and warping frame t-1 by it gives
   frame t;
20. cli/train_vsr.py as phase 16 for 'basic_mv' (nf 20, 8 blocks, on that
   tree: launchers/video_train_multi_with_mv.sh's width), 'multi_v1' (the
   artifact: launchers/video_train_naive.sh) and 'basic_origin' (nf 64, 30
   blocks, at launchers/video_train_basic.sh's data shape), one epoch of 4
   steps and an eval each: B1 / B2 / B4 per forward ('basic_mv' 0 / 1 / 0,
   'multi_v1' 30 / 0 / 1, 'basic_origin' 30 / 2 / 0), the steady steps,
   cli.test_vsr on each npz;
21. 'basic_origin' served in bf16 by StreamingVSR (10 426x240 frames, 3
   windows of 10) plain and flow-cached: 1080x1920 frames, B1 30 and B2 2
   per window, the cached stream within bf16_tol of the plain one, the
   window's ms;
22. the on-card latency table: kernels/timing.py's build_latency_table at
   the JAX harness's grid (6 ch_in x 4 splits x k 3/5/7 = 72 configs,
   240x426, method "loop"), after one split block per k at ch_in 32, full
   split, against its plain version: B5 launched once per timed block call,
   every row finite and >= 0, ms per config logged; the table goes to
   chiprun_out/<device kind>.npy (the port ships it as
   nas/speed_tables/nvidia_h100_80gb_hbm3.npy);
23. the search's latency paths through cli.search: --build_speed_table at
   16 blocks and 32 units (12 configs timed, a (12, 4) speed_table.npy, B5
   48 per forward), then at 4 blocks --speed_predictor tpu_v5_lite, and
   --speed_table auto (this card's packaged table) with --pretrained from a
   seeded reference-layout WDSR-B .pt (9 tensors copied), one width epoch
   each;
24. reference checkpoints: seeded state dicts with the reference's key
   names, each held bit-equal to the npz route with the same weights on the
   card: a WDSR-B x2 (16 blocks, 24 units) .pt through load_reference_wdsr
   and evaluate (B3 16 + B4 1 per image); 'basic_origin' (nf 64, 30
   blocks, mmedit's {"meta", "params"}), 'basic_mv', 'single' and 'multi'
   .pth through cli.test_vsr --eval_model (ZOO_PER_FORWARD); a SpyNet .pth
   through cli.train_vsr --spynet_weights for one step;
25. Q1s and Q1, the int8 dynamic-range conv's per-sample scale and the
   conv that quantizes with it (not TPU kernels: the JAX package's
   quantize_symmetric and XLA int8 conv), against their plain versions bit
   for bit (float inputs, f32 and bf16, with and without bias, the
   all-±127 edge, a row-window view) at the dual trunk's 54->48 and 48->48
   (426x240), SpyNet's five s2d convs at a window's finest level, WDSR-B's
   and ResultNet's convs at 678x1020 (k 1/3/5/7), with ms, plain, bound
   (Q1 int8 operations at 1,979 TOP/s or bytes, Q1s bytes) and for Q1
   cuDNN bf16 (the nearest library call, not the same function);
26. cli.serve --quantize int8 of mobile BasicVSR x4 (bf16, 16 426x240
   frames, chunk 4, overlap 3), plain and --flow_cache: Q1 and Q1s 200
   each per window (flow-cached 30 per flow group + 170 per window), B1 0,
   B2 1; the agreement PSNR with phase 5's float stream; the quantized
   window's ms, and the window bit-equal to its twin run with Q1s's and
   Q1's plain versions patched in (a seam of this script);
27. quantized evaluation: the shipped wdsr_b_x2 / result_net_x2 int8 on
   their held-out set (PSNR and its delta from the float report), through
   cli.pretrain / cli.retrain_searched --eval_only --quantize int8 beside the
   float runs (B3 = B4 = 0), cli.test_vsr --quantize int8 for 'basic',
   'single', 'multi' and 'basic_mv' with each first output held to the CPU's,
   and a tiny 'basic_origin' card vs CPU;
28. cli.export of the searched net (360x540) and of mobile BasicVSR (10
   frames of 360x540): the .pt2 checked on the card against the kernel
   forward, its export seconds, the artifact's and the port's ms;
29. cli.pretrain --eval_only --eval_tile 128 on the shipped wdsr_b_x2 at
   256x256 LR against the whole images (B3 / B4 per tile);
30. analysis.approx_ladder --config tiny on the card: the table and the JAX
   package's monotone properties;
31. result.log in the job dir of every entry-point run (run_cli checks each
   as it returns), and one cli.pretrain epoch with --xla_profile_steps 2
   writing one trace that names B3's kernel;
32. height-sharded SISR (parallel/halo.py): full-width WDSR-B x2 (radius 18)
   on phase 8's two 678x1020 images at S = 2 and 3, f32 and bf16, within
   f32_tol / bf16_tol of the full frame, 16 B3 + 1 B4 per window; ms and
   peak memory beside the full frame's;
33. cli.pretrain --spatial_shards 2 (parallel/spatial_train.py) at the
   launcher's width on 96x96 LR patches: one sharded step against the plain
   step on the same batch (loss within 1e-5 relative, every gradient within
   1e-5 of its largest magnitude), one CLI epoch (32 B3 + 2 B4 per training
   forward),
   and both steady steps with their peak memory;
34. height-sharded VSR (parallel/vsr_spatial.py): mobile BasicVSR (bf16) on
   serving's 10-frame 426x240 window at S = 2 and 4 and basic_origin (nf
   64, 30 blocks) at S = 2, within bf16_tol of the plain window, B1 30 and
   B2 1 (2) per forward; ms and peak memory (also before the
   reconstruction) beside the plain window's;
35. cli.serve --spatial_shards 2 over phase 5's frames, plain and
   --flow_cache, against phase 5's / 5b's streams;
36. cli.train_vsr --spatial_shards 2 for one epoch at
   launchers/video_train_basic.sh's width (its eval sharded too), its first
   loss against phase 11's, then cli.test_vsr with and without
   --spatial_shards 2 on its npz (PSNR within 1e-3 dB);
37. --distributed: cli.pretrain and cli.train_vsr as rank 0 of a one-rank
   NCCL group against the same runs without it (losses within 1e-5
   relative, weights within the Adam drift bound, the chief's files written
   once; two ranks need two cards: tests/test_torch_cuda.py's
   test_two_nccl_ranks_match_one_process, and gloo on the CPU);
38. the in-process data axis on phase 11's npz: cli.test_vsr --chunk_frames
   4 --chunk_overlap 2 with and without --chunk_data_parallel, and
   cli.test_vsr_by_patch at phase 17's settings with and without
   --data_parallel, each equal to its run without the flag (one card: a
   group is one window, a patch batch one patch), B1 30 and B2 1 per window
   or patch batch;
39. the native data cores (native/libloader.so, native/libimresize.so)
   loaded on this host, not the numpy path, each bit-equal to the numpy
   path at DIV2K's and 1080p's sizes, both timed;
40. cli.search --speed_predictor auto: this card's packaged predictor, B5
   12 per forward at 4 blocks;
41. cli.serve --quantize int8 --spatial_shards 2 over phase 26's frames,
   within the int8 bound of phase 26's unsharded int8 stream (each shard's
   trunk window has its own per-sample scale), with Q1's and Q1s's
   launches;
42. serving's data groups (parallel/mesh.py): mobile BasicVSR x4 (bf16)
   serves 4 lockstep streams of 8 426x240 frames at S = 2 through
   cli.serve's stream, plain and flow-cached, in the seam's D = 2 groups on
   the one card (``Mesh(slots=4)``): bit-equal to one group serving each
   half, within bf16_tol of one group serving all four streams (B1's tile
   choice follows the batch, so SpyNet's flows at half the batch round
   otherwise), B1 and B2 per window (each group runs its own SpyNet and
   reconstruction) and each stream's frames/s.

Prints the kernel table as one JSON line (launches from the slices' paths,
each count set to 0 before its path: B1 and B2 from the basic VSR training
run plus phases 16-18, 20, 21, 24, 26-30, 34-38 and 41, B3 from the
pretraining run and phases 24, 29, 32, 33 and 37, B4 from those and phase
20's 'multi_v1' runs and 28, B5 from the search and phases 22, 23 and 40,
Q1 and Q1s from phases 26, 27, 30 and 41, as many of each; B1 and B2 also from
phase 42; with each kernel's routes by dtype or shape, and B1's and B2's
float32 launches from phase 4 on), the
nvidia-smi line, and last ``{"ok": true,
"device": {...}}``. Details go to chiprun_out/chip_smoke.json. Needs CUDA;
imports nothing of JAX.
"""

import argparse
import json
import os
import re
import shutil
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
PEAK_RATES = {"f32": 67e12, "bf16": 989e12, "tf32x3": 495e12 / 3, "int8": 1979e12}
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
# VSR training at launchers/video_train_basic.sh's width: basic (nf 24, 8
# blocks), x4, 10-frame clips, batch 2, 64x64 LR patches, lr 1e-4, float32; on
# synthetic_vsr clips of 10 512x512 HR frames (128x128 LR, every SpyNet level
# even), 4 clips x 2 patches / batch 2 = 4 steps per epoch, two epochs
VSR_T, VSR_BATCH, VSR_PATCH, VSR_SCALE, VSR_LR = 10, 2, 64, 4, 1e-4
VSR_CLIPS, VSR_HR, VSR_NUM_PATCHES, VSR_EPOCHS = 4, 512, 2, 2
VSR_STEPS_PER_EPOCH = VSR_CLIPS * VSR_NUM_PATCHES // VSR_BATCH
# the VSR zoo at full width, trained as the basic model above for one epoch:
# 'single' (launchers/video_train_single.sh: 32 channels, 8 blocks, k 3) and
# 'multi' (launchers/video_train_multi.sh: the search artifact's last line,
# 18 channels, one k7 block); B1 and B2 launches per forward
ZOO_ARTIFACT = os.path.join(ROOT, "artifacts", "search_depth_tpu", "block_index.txt")
# the rest of the zoo at the same shape: 'basic_mv' (launchers/
# video_train_multi_with_mv.sh: nf 20, 8 blocks, on a REDS-with-MV tree),
# 'multi_v1' (launchers/video_train_naive.sh on the artifact: 18 channels,
# one k7 block; its tail is B4's function) and 'basic_origin' (the faithful
# BasicVSR at launchers/video_train_basic.sh's data shape: nf 64, 30 blocks,
# two B2 upconvs to 256 conv channels); B1, B2 and B4 launches per forward
ZOO_PER_FORWARD = {"single": {"B1": 0, "B2": 1, "B4": 0}, "multi": {"B1": B1_PER_WINDOW, "B2": 1, "B4": 0},
                   "basic_mv": {"B1": 0, "B2": 1, "B4": 0}, "multi_v1": {"B1": B1_PER_WINDOW, "B2": 0, "B4": 1},
                   "basic_origin": {"B1": B1_PER_WINDOW, "B2": 2, "B4": 0}}
# basic_origin's upconvs (3x3 SAME, s 2, 64 -> 256 conv channels, the leaky
# ReLU fused): at a 426x240 window and at its 2x map
UPCONV_CIN, UPCONV_CC = 64, 256
# the REDS-with-MV tree's motion: the LR frames translate by (dx, dy) pixels
# a frame, so every motion vector is that shift
MV_SHIFT = (2, 1)
# patch eval at launchers/video_test_patch.sh: basic x4, 64x64 patches,
# overlap 4/0, image_batch 10, one patch per forward (the CLI's default), on
# one synthetic 10-frame clip at REDS's frame size (720x1280 HR, 180x320 LR:
# 2 rows x 5 columns of patches)
PATCH_HR, PATCH, PATCH_OVERLAP = (720, 1280), 64, (4, 0)
N_PATCHES = 2 * 5
# serving's data groups: 4 lockstep streams of 8 frames, S = 2 shards, D = 2
# groups (the mesh's seam on one card)
GROUP_STREAMS, GROUP_FRAMES, GROUP_SHARDS = 4, 8, 2
# the on-card latency table: the JAX harness's grid (6 ch_in x 4 splits x k
# 3/5/7) at the NEMO protocol's LR size
LATENCY_HW = (240, 426)


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
    """The tensor-core basis of the products of B1-B5 for an I/O dtype: bf16
    for bfloat16, 3xTF32 for float32."""
    return "bf16" if dtype == torch.bfloat16 else "tf32x3"


def check_twice(name, fn, want, tol):
    """``check`` one call of ``fn`` against its plain version, then a second
    call bit for bit against the first (the f32 routes sum K in an order
    fixed by the shapes: no atomics, no split K)."""
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    err = check(name, got, want, tol)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two calls differ (max {float((got - again).abs().max())})")
    return got, err


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


def run_cli(main, argv):
    """An entry point's ``main(argv)``, then a check that it wrote
    ``<job_dir>/result.log`` (core/logging_tool.py); the job dirs seen so
    far are kept in LOGGED_JOBS for the logging phase."""
    out = main(argv)
    job_dir = argv[argv.index("--job_dir") + 1]
    path = os.path.join(job_dir, "result.log")
    if not os.path.getsize(path):
        raise AssertionError(f"{path} is empty")
    LOGGED_JOBS.append(job_dir)
    return out


LOGGED_JOBS = []


def reference_state_dict(kind, flat):
    """A state dict with the reference's key names and torch layouts holding
    the JAX-layout flat params ``flat`` of a model of ``kind`` ('wdsr',
    'spynet', 'basic_origin', 'basic_mv', 'single', 'multi'): the inverse of
    train/torch_convert.py's converters. OIHW conv weights, weight norm's
    g as (O, 1, 1, 1), ConvTranspose weights (Cin, Cout, kh, kw) unflipped."""

    def oihw(k):
        return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))

    sd = {}

    def wn(ours, theirs):
        sd[f"{theirs}.weight_v"] = oihw(flat[f"{ours}/v"])
        sd[f"{theirs}.weight_g"] = flat[f"{ours}/g"].reshape(-1, 1, 1, 1)
        sd[f"{theirs}.bias"] = flat[f"{ours}/b"]

    def plain(ours, theirs):
        sd[f"{theirs}.weight"] = oihw(flat[f"{ours}/kernel"])
        sd[f"{theirs}.bias"] = flat[f"{ours}/bias"]

    def transpose(ours, theirs):
        k = flat[f"{ours}/kernel"]
        sd[f"{theirs}.weight"] = np.ascontiguousarray(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        sd[f"{theirs}.bias"] = flat[f"{ours}/bias"]

    def spynet(scope, prefix):
        for key in flat:
            m = re.fullmatch(rf"{scope}level_(\d+)/conv(\d)_kernel", key)
            if m:
                lv, j = m.groups()
                plain_key = f"{prefix}basic_module.{lv}.basic_module.{2 * int(j)}"
                sd[f"{plain_key}.weight"] = oihw(flat[key])
                sd[f"{plain_key}.bias"] = flat[f"{scope}level_{lv}/conv{j}_bias"]

    def trunks():
        for key in flat:
            m = re.fullmatch(r"propagation/trunks/(backward|forward)_(conv0|block(\d+)_(conv[12]))_kernel", key)
            if m:
                d, _, i, c = m.groups()
                name = f"{d}_trunk.main.0" if i is None else f"{d}_trunk.main.2.{i}.{c}"
                sd[f"{name}.weight"] = oihw(flat[key])
                sd[f"{name}.bias"] = flat[key[: -len("kernel")] + "bias"]

    if kind == "wdsr":
        wn("WNConv_0", "head")
        i = 0
        while f"BasicBlock_{i}/WNConv_0/v" in flat:
            for j, layer in enumerate((0, 2, 3)):
                wn(f"BasicBlock_{i}/WNConv_{j}", f"body.{i}.body.{layer}")
            i += 1
        wn("WNConv_1", "tail")
        if "WNConv_2/v" in flat:
            wn("WNConv_2", "skip.0")
    elif kind == "spynet":
        spynet("", "")
    elif kind == "basic_origin":
        spynet("spynet/", "spynet.")
        trunks()
        for name in ("fusion", "upconv1", "upconv2", "conv_hr", "conv_last"):
            plain(f"{name}/Conv_0", name)
    elif kind == "basic_mv":
        trunks()
        plain("fusion/Conv_0", "fusion")
        transpose("conv_last", "conv_last")
    elif kind == "single":
        wn("encoder", "encoder")
        i = 0
        while f"block_{i}/WNConv_0/v" in flat:
            wn(f"block_{i}/WNConv_0", f"body.{i}.body.0.body.0")
            wn(f"block_{i}/WNConv_1", f"body.{i}.body.0.body.2")
            i += 1
        wn("body_tail", f"body.{i}")
        transpose("shuf", "shuf.0")
    elif kind == "multi":
        spynet("flownet/", "flownet.")
        wn("encode", "encode")
        wn("decode", "decode")
        i = 0
        while f"block_{i}/PlainConv_0/Conv_0/kernel" in flat:
            plain(f"block_{i}/PlainConv_0/Conv_0", f"body.{i}.body.0")
            plain(f"block_{i}/PlainConv_1/Conv_0", f"body.{i}.body.2")
            i += 1
    else:
        raise KeyError(kind)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


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


def sass_ops(name, pattern):
    """The distinct SASS instructions of lib<name>.so that match ``pattern``
    (cuobjdump -sass), and ptxas's C75xx notes per code from its build log."""
    from mobilesuperresolution_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", os.path.join(_build.BUILD_DIR, f"lib{name}.so")], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    notes = {}
    for ln in open(os.path.join(_build.BUILD_DIR, f"{name}.log")):
        m = re.search(r"\((C75\d+)\)", ln)
        if m:
            notes[m.group(1)] = notes.get(m.group(1), 0) + 1
    return sorted(set(re.findall(pattern, sass))), notes


def q1_sass():
    """Q1's tensor-core route in the built library: the distinct int8 wgmma
    instructions (IGMMA ... S8.S8) of its SASS, and ptxas's C75xx notes per
    code (C7517 is a warpgroup.wait injected before mbar_wait's timeout
    trap, a path never taken; C7512, C7513, C7515 and C7518 would mean
    serialised wgmma). Fails when there is no s8 wgmma."""
    ops, notes = sass_ops("qconv_int8", r"IGMMA\.\w+\.S8\.S8")
    log(f"  qconv_int8 SASS: {ops}; ptxas notes {notes}")
    if not ops:
        raise AssertionError("Q1's library holds no s8 wgmma (IGMMA ... S8.S8)")
    return dict(igmma=ops, ptxas_notes=notes)


def tf32_sass():
    """The f32 routes of B1 and B2 on the tensor cores: the distinct tf32
    instructions (HMMA.1688.F32.TF32 of mma.sync, HGMMA ... TF32 of wgmma)
    in the SASS of libconv5x5.so and libfused_tail.so, and ptxas's C75xx
    notes per code for each. Fails when either library has none."""
    out = {}
    for name in ("conv5x5", "fused_tail"):
        ops, notes = sass_ops(name, r"HMMA\.1688\.F32\.TF32|HGMMA\.\w+\.F32\.TF32")
        log(f"  {name} SASS: tf32 {ops}; ptxas notes {notes}")
        if not ops:
            raise AssertionError(f"lib{name}.so holds no tf32 tensor-core instruction "
                                 "(HMMA.1688.F32.TF32 / HGMMA TF32)")
        out[name] = dict(tf32=ops, ptxas_notes=notes)
    return out


def b1_routes_agree(tag, x, wt, b, relu, got):
    """B1 f32 without packed weights (the mma.sync route on 4-warp tiles)
    bit for bit against ``got`` (the packed weights' plan: wgmma on 8-warp
    tiles where the plan takes them): every plan sums each output in one
    order with the same tf32 products."""
    from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same, f32_plan

    other = conv5x5_same(x, wt, b, relu)
    torch.cuda.synchronize()
    if not torch.equal(other, got):
        raise AssertionError(f"{tag}: the mma.sync route differs from the wgmma route by "
                             f"{float((other - got).abs().max())}")
    shape = (*x.shape[:3], wt.shape[3])
    log(f"  {tag}: packed (plan {f32_plan(*shape, True)}) and unpacked (plan {f32_plan(*shape, False)}) bit-equal")


def conv5x5_flops(n, h, w, cin, cout):
    """The operations of a 5x5 SAME conv on an (n, h, w) map: its products
    with pixels of the image only (a tap's shift by dy rows meets max(0, h -
    |dy|) of them; products with the zero padding are not needed)."""
    def live(m):
        return sum(max(0, m - abs(d)) for d in range(-2, 3))

    return 2.0 * n * cin * cout * live(h) * live(w)


def phase_kernels(gen, dev):
    from mobilesuperresolution_tpu_torch.kernels.conv5x5 import (
        conv5x5_same,
        conv5x5_same_plain,
        f32_plan,
        pack_weights,
        pack_weights_f32,
    )
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
        # as SpyNet's prepare packs them, once
        wp = (pack_weights_f32 if dtype == torch.float32 else pack_weights)(wt) if cout % 64 == 0 else None
        want = conv5x5_same_plain(x, wt, b, relu)
        tag = f"B1 {nimg}x{h}x{w} {cin}->{cout} {str(dtype)[6:]}"
        if dtype == torch.float32:
            got, err = check_twice(tag, lambda: conv5x5_same(x, wt, b, relu, wp), want, f32_tol(want))
        else:
            got = conv5x5_same(x, wt, b, relu, wp)
            torch.cuda.synchronize()
            err = check(tag, got, want, bf16_tol(want))
        xn, wn, bb = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(), b.to(dtype)
        ms = cuda_ms(lambda: conv5x5_same(x, wt, b, relu, wp))
        plain_ms = cuda_ms(lambda: conv5x5_same_plain(x, wt, b, relu))
        lib_ms = cuda_ms(lambda: F.conv2d(xn, wn, bb, padding=2))
        flops = conv5x5_flops(nimg, h, w, cin, cout)
        bms, by, basis = bound_by_route([(flops, route(dtype))], nbytes(x, wt, b, got))
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by}; {basis})")
        rows["B1"].append(dict(case=tag, main_path=False, serving=dtype == torch.bfloat16 and nimg == n,
                               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                               bound_by=by, bound_basis=basis, gflop=flops / 1e9))

    # B1 f32 at the edges of its tiles (3xTF32): N = 1 at a large map,
    # ragged 37x53 with Cin 20 / Cout 8 and Cin 40 / Cout 96 tails, a coarse
    # 4x7 level, 128 samples at 1x1 (the folded tile past 36), and a batch
    # of 16 clips' 288 samples at 8x8 and 4x4 (whole images folded into the
    # wgmma route's tile); each with packed weights against its plain
    # version, twice against itself, and against the unpacked route
    for nimg, hh, ww, cin, cout, relu in [(1, 64, 112, 128, 256, True), (2, 37, 53, 20, 8, True),
                                          (1, 37, 53, 40, 96, False), (18, 4, 7, 32, 128, True),
                                          (128, 1, 1, 128, 256, True), (288, 8, 8, 128, 256, True),
                                          (288, 4, 4, 256, 256, True)]:
        x = rand((nimg, hh, ww, cin), torch.float32)
        wt = rand((5, 5, cin, cout), torch.float32, 1.0 / np.sqrt(25 * cin))
        b = rand((cout,), torch.float32, 0.1)
        wp = pack_weights_f32(wt)
        want = conv5x5_same_plain(x, wt, b, relu)
        tag = f"B1 edge {nimg}x{hh}x{ww} {cin}->{cout} float32"
        got, _ = check_twice(tag, lambda: conv5x5_same(x, wt, b, relu, wp), want, f32_tol(want))
        b1_routes_agree(tag, x, wt, b, relu, got)

    # B1 on the VSR training step's path (this slice's): SpyNet's six levels
    # for 64x64 LR patches, 2 clips x 9 pairs x 2 directions = 36 samples,
    # each level's five s2d convs at half its size (32x32 down to 1x1), f32
    nv = VSR_BATCH * (VSR_T - 1) * 2
    levels = []
    for lvl in range(6):
        lh = (VSR_PATCH // 2) >> lvl
        lv = dict(level=f"{nv}x{lh}x{lh}", ms=0.0, library_ms=0.0, bound_ms=0.0)
        for cin, cout, relu in shapes:
            x = rand((nv, lh, lh, cin), torch.float32)
            wt = rand((5, 5, cin, cout), torch.float32, 1.0 / np.sqrt(25 * cin))
            b = rand((cout,), torch.float32, 0.1)
            wp = pack_weights_f32(wt) if cout % 64 == 0 else None  # as SpyNet's prepare packs them, once
            want = conv5x5_same_plain(x, wt, b, relu)
            tag = f"B1 train {nv}x{lh}x{lh} {cin}->{cout} float32"
            got, err = check_twice(tag, lambda: conv5x5_same(x, wt, b, relu, wp), want, f32_tol(want))
            if f32_plan(nv, lh, lh, cout, wp is not None)[0] == 8:
                b1_routes_agree(tag, x, wt, b, relu, got)
            xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
            ms = cuda_ms(lambda: conv5x5_same(x, wt, b, relu, wp))
            plain_ms = cuda_ms(lambda: conv5x5_same_plain(x, wt, b, relu))
            lib_ms = cuda_ms(lambda: F.conv2d(xn, wn, b, padding=2))
            flops = conv5x5_flops(nv, lh, lh, cin, cout)
            bms, by, basis = bound_by_route([(flops, route(torch.float32))], nbytes(x, wt, b, got))
            log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by}; {basis})")
            rows["B1"].append(dict(case=tag, main_path=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bms, bound_by=by, bound_basis=basis,
                                   gflop=flops / 1e9))
            lv["ms"] += ms
            lv["library_ms"] += lib_ms
            lv["bound_ms"] += bms
        levels.append(lv)
        log(f"    level {lv['level']}: B1 f32 {lv['ms']:.4f} ms, library {lv['library_ms']:.4f}, "
            f"bound {lv['bound_ms']:.4f} (five convs)")
    rows["B1_f32_levels"] = levels

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
            lv["bound_ms"] += bound_by_route([(conv5x5_flops(n, lh, lw, cin, cout), "bf16")], nbytes(x, wt, b, got))[0]
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
    # the VSR training step's tail (this slice's path, f32; bf16 beside it):
    # 2 clips x 10 frames of 64x64, cropped to 257x257
    vp = VSR_PATCH
    tail_cases = [
        (T_WIN, H_LR, W_LR, 48, 2, 4, ((1, 2), (1, 2)), (4 * H_LR + 1, 4 * W_LR + 1), torch.bfloat16),
        (4, 120, 214, 16, 3, 2, ((1, 1), (1, 1)), None, torch.float32),
        (VSR_BATCH * VSR_T, vp, vp, 48, 2, 4, ((1, 2), (1, 2)), (4 * vp + 1, 4 * vp + 1), torch.float32),
        (VSR_BATCH * VSR_T, vp, vp, 48, 2, 4, ((1, 2), (1, 2)), (4 * vp + 1, 4 * vp + 1), torch.bfloat16),
    ]
    # the VSR zoo's tails at their training shape (2 clips x 10 frames of
    # 64x64): 'single''s 5x5 stride-4 transpose as a 2x2 conv over 32
    # channels, 'multi''s decode (3x3 SAME, 18 channels: a bf16 pixel of 36
    # bytes); and 'multi''s decode at the serving window's shape in bf16
    tail_cases = [(None, *c) for c in tail_cases]
    tail_cases += [("single", VSR_BATCH * VSR_T, vp, vp, 32, 2, 4, ((1, 2), (1, 2)), (4 * vp + 1, 4 * vp + 1), dt)
                   for dt in (torch.float32, torch.bfloat16)]
    tail_cases += [("multi", VSR_BATCH * VSR_T, vp, vp, 18, 3, 4, ((1, 1), (1, 1)), None, dt)
                   for dt in (torch.float32, torch.bfloat16)]
    tail_cases += [("multi", T_WIN, H_LR, W_LR, 18, 3, 4, ((1, 1), (1, 1)), None, torch.bfloat16)]
    # B2 f32 at the edges of its tile (3xTF32): odd crops of a ragged map,
    # Cin 16 and 40 (a K tail), and the 3x3 form at s 3 (27 conv channels)
    tail_cases += [(None, 2, 13, 21, 48, 2, 4, ((1, 2), (1, 2)), (51, 83), torch.float32),
                   (None, 2, 11, 19, 16, 2, 4, ((1, 2), (1, 2)), (45, 77), torch.float32),
                   (None, 1, 11, 19, 40, 2, 4, ((1, 2), (1, 2)), (43, 75), torch.float32),
                   (None, 2, 11, 19, 16, 3, 3, ((1, 1), (1, 1)), None, torch.float32)]
    for zoo, nb, hh, ww, cin, k, s, pad, crop, dtype in tail_cases:
        cc = 3 * s * s
        x = rand((nb, hh, ww, cin), dtype)
        kern = rand((k, k, cin, cc), dtype, 1.0 / np.sqrt(k * k * cin))
        b = rand((cc,), dtype, 0.1)
        want = fused_conv_pixel_shuffle_plain(x, kern, b, s, pad, crop)
        tag = f"B2 {nb}x{hh}x{ww}x{cin} {k}x{k} s{s} -> {tuple(want.shape)} {str(dtype)[6:]}"
        if dtype == torch.float32:
            got, err = check_twice(tag, lambda: fused_conv_pixel_shuffle(x, kern, b, s, pad, crop), want,
                                   f32_tol(want))
        else:
            got = fused_conv_pixel_shuffle(x, kern, b, s, pad, crop)
            torch.cuda.synchronize()
            err = check(tag, got, want, bf16_tol(want))
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
        bms, by, basis = bound_by_route([(flops, route(dtype))], nbytes(x, kern, b, got))
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by}; {basis})")
        train = zoo is None and nb == VSR_BATCH * VSR_T
        rows["B2"].append(dict(case=tag, main_path=train and dtype == torch.float32,
                               serving=zoo is None and not train and dtype == torch.bfloat16, zoo=zoo,
                               max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                               bound_basis=basis, gflop=flops / 1e9))

    # B2 past 64 conv channels: basic_origin's upconvs (3x3 SAME, s 2, 64 ->
    # 256 conv channels, the leaky ReLU fused) at the serving window's shapes
    # in bf16 (upconv1 on the 240x426 map, upconv2 on its 2x map) and at the
    # training step's (2 clips x 10 frames of 64x64, and 128x128) in f32; the
    # library call is cuDNN's conv, pixel_shuffle and leaky_relu
    up_cases = [(T_WIN, H_LR * f, W_LR * f, torch.bfloat16, f"upconv{f}") for f in (1, 2)]
    up_cases += [(VSR_BATCH * VSR_T, vp * f, vp * f, torch.float32, f"upconv{f}") for f in (1, 2)]
    for nb, hh, ww, dtype, name in up_cases:
        cin, cc = UPCONV_CIN, UPCONV_CC
        pad = ((1, 1), (1, 1))
        x = rand((nb, hh, ww, cin), dtype)
        kern = rand((3, 3, cin, cc), dtype, 1.0 / np.sqrt(9 * cin))
        b = rand((cc,), dtype, 0.1)
        want = fused_conv_pixel_shuffle_plain(x, kern, b, 2, pad, None, True)
        tag = f"B2 basic_origin {name} {nb}x{hh}x{ww}x{cin} 3x3 s2 {cc} + lrelu -> {tuple(want.shape)} {str(dtype)[6:]}"
        if dtype == torch.float32:
            got, err = check_twice(tag, lambda: fused_conv_pixel_shuffle(x, kern, b, 2, pad, None, True), want,
                                   f32_tol(want))
        else:
            got = fused_conv_pixel_shuffle(x, kern, b, 2, pad, None, True)
            torch.cuda.synchronize()
            err = check(tag, got, want, bf16_tol(want))
        del want
        xn, kn = x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        ms = cuda_ms(lambda: fused_conv_pixel_shuffle(x, kern, b, 2, pad, None, True), iters=10)
        plain_ms = cuda_ms(lambda: fused_conv_pixel_shuffle_plain(x, kern, b, 2, pad, None, True), iters=10)
        lib_ms = cuda_ms(lambda: F.leaky_relu(F.pixel_shuffle(F.conv2d(xn, kn, b, padding=1), 2), 0.1), iters=10)
        flops = 2.0 * nb * hh * ww * 9 * cin * cc
        bms, by, basis = bound_by_route([(flops, route(dtype))], nbytes(x, kern, b, got))
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by}; {basis})")
        rows["B2"].append(dict(case=tag, main_path=False, serving=dtype == torch.bfloat16, zoo="basic_origin",
                               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                               bound_by=by, bound_basis=basis, gflop=flops / 1e9))
        del x, got

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
    # and ResultNet's body widths 18, 21, 32, f32 and bf16; and multi_v1's
    # tail at its training shape (2 clips x 10 frames of 64x64, body 18, s 4)
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import _skip_plan
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import pack_weights as pack_b4

    b4_cases = [(1, hl, wl, c, s, dt) for c, s in ((SR_UNITS, SR_SCALE), (SR_UNITS, 3), (SR_UNITS, 4), (18, 2),
                                                   (21, 2), (32, 2)) for dt in (torch.float32, torch.bfloat16)]
    # the training step's batch of LR patches (cli/pretrain.py)
    b4_cases += [(TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, SR_UNITS, SR_SCALE, dt) for dt in (torch.float32,
                                                                                          torch.bfloat16)]
    b4_cases += [(VSR_BATCH * VSR_T, VSR_PATCH, VSR_PATCH, 18, VSR_SCALE, dt) for dt in (torch.float32,
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
                               zoo="multi_v1" if nb == VSR_BATCH * VSR_T else None,
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
                stream_fps_end_to_end=fps, downscale2=dict(spynet_ms=ds_flow_ms, b1_launches=ds_launches)), \
        launches, out


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
        res = run_cli(pretrain.main, [
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
    return stats, main_launches, lrs


def sisr_train_argv(job_dir):
    return ["--job_dir", job_dir, "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--scale",
            str(SR_SCALE), "--epochs", "1", "--num_patches", str(TRAIN_NUM_PATCHES), "--train_batch_size",
            str(TRAIN_BATCH), "--lr_patch_size", str(TRAIN_PATCH), "--learning_rate", "1e-3"]


def steady_step_ms(model, dev, patch=TRAIN_PATCH, make_step=None):
    """Mean ms of a SISR training step (``make_step(model, optimizer)``,
    default make_sisr_step; Adam) over 10 steps on one fixed batch of LR
    patches of ``patch``, CUDA events, after 3 warm-up steps; with the B3
    and B4 launches per step and the peak device memory."""
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    g = torch.Generator().manual_seed(6)
    lr = torch.rand((TRAIN_BATCH, patch, patch, 3), generator=g).to(dev)
    hr = torch.rand((TRAIN_BATCH, SR_SCALE * patch, SR_SCALE * patch, 3), generator=g).to(dev)
    model.train()
    step = (make_step or make_sisr_step)(model, multistep_adam(jax_named_parameters(model), 1e-3, 100, 1))
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
        out = run_cli(pretrain.main, argv)
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
        out = run_cli(retrain_searched.main, sisr_train_argv(job_dir) + ["--block_index", block_index])
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
        out = run_cli(search.main, argv)
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


def vsr_launches():
    """The VSR models' kernel counts: B1, B2 and B4 ('multi_v1''s tail), and
    B1's and B2's float32 launches among them (B1_f32, B2_f32)."""
    from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
        fused_conv_pixel_shuffle,
        fused_conv_pixel_shuffle_skip,
    )

    return {"B1": conv5x5_same.launches, "B2": fused_conv_pixel_shuffle.launches,
            "B4": fused_conv_pixel_shuffle_skip.launches, "B1_f32": conv5x5_same.f32_launches,
            "B2_f32": fused_conv_pixel_shuffle.f32_launches}


def reset_vsr_launches():
    from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
        fused_conv_pixel_shuffle,
        fused_conv_pixel_shuffle_skip,
    )

    conv5x5_same.launches = conv5x5_same.f32_launches = 0
    fused_conv_pixel_shuffle.launches = fused_conv_pixel_shuffle.f32_launches = 0
    fused_conv_pixel_shuffle_skip.launches = 0


def routes(launches):
    """A count dict without its float32 shares (the "_f32" keys): what the
    checks of each kernel's launches compare."""
    return {k: v for k, v in launches.items() if not k.endswith("_f32")}


def model_argv(kind):
    """The VSR entry points' model flags of one model type."""
    return ["--model_type", kind] + (["--model_path", ZOO_ARTIFACT] if kind in ("multi", "multi_v1") else [])


def vsr_argv(job_dir, kind="basic", mv_root=None):
    """The model and data flags of both VSR entry points: synthetic_vsr, or
    for 'basic_mv' the REDS-with-MV tree under ``mv_root``."""
    if kind == "basic_mv":
        data = ["--dataset", "reds_with_mv", "--eval_datasets", "reds_with_mv", "--data_dir", mv_root,
                "--cache_dir", "", "--val_image_batch", str(VSR_T)]
    else:
        data = ["--dataset", "synthetic_vsr", "--eval_datasets", "synthetic_vsr", "--synthetic_frames", str(VSR_T),
                "--synthetic_clips", str(VSR_CLIPS), "--synthetic_size", str(VSR_HR)]
    return ["--job_dir", job_dir, *data, *model_argv(kind), "--scale", str(VSR_SCALE), "--image_batch", str(VSR_T)]


def write_reds_mv_tree(root, seed=5):
    """A REDS-with-MV tree as data/reds_with_mv.py reads it, for 'basic_mv':
    train and val splits of VSR_CLIPS clips of VSR_T frames, VSR_HR square
    HR PNGs whose x4 LR frames (every 4th pixel) translate by MV_SHIFT
    pixels a frame, and each LR clip's hex-me16-ref1/motion.npy holding that
    shift as every pixel's vector (frame 0's zero, never read as a flow)."""
    from PIL import Image

    g = torch.Generator().manual_seed(seed)
    hr, dx, dy = VSR_HR, MV_SHIFT[0] * VSR_SCALE, MV_SHIFT[1] * VSR_SCALE
    lr = hr // VSR_SCALE
    for split in ("train", "val"):
        for c in range(VSR_CLIPS):
            tex = torch.rand((1, 3, hr // 16 + 8, hr // 16 + 8), generator=g)
            tex = F.interpolate(tex, size=(hr + dy * VSR_T, hr + dx * VSR_T), mode="bilinear", align_corners=False)
            tex = (tex[0].permute(1, 2, 0).numpy() * 255).round().astype(np.uint8)
            hr_dir = os.path.join(root, "REDS", split, f"{split}_sharp", f"{c:03d}")
            lr_dir = os.path.join(root, "REDS", split, f"{split}_sharp_bicubic", f"X{VSR_SCALE}", f"{c:03d}")
            os.makedirs(hr_dir)
            os.makedirs(os.path.join(lr_dir, "hex-me16-ref1"))
            for t in range(VSR_T):
                frame = tex[t * dy : t * dy + hr, t * dx : t * dx + hr]
                Image.fromarray(frame).save(os.path.join(hr_dir, f"{t:08d}.png"), compress_level=1)
                Image.fromarray(np.ascontiguousarray(frame[::VSR_SCALE, ::VSR_SCALE])).save(
                    os.path.join(lr_dir, f"{t:08d}.png"), compress_level=1)
            mv = np.broadcast_to(np.asarray(MV_SHIFT, np.float32), (VSR_T, lr, lr, 2)).copy()
            mv[0] = 0.0
            np.save(os.path.join(lr_dir, "hex-me16-ref1", "motion.npy"), mv)


def vsr_train_argv(job_dir, kind="basic", mv_root=None):
    return vsr_argv(job_dir, kind, mv_root) + ["--train_batch_size", str(VSR_BATCH), "--lr_patch_size", str(VSR_PATCH),
                                      "--num_patches", str(VSR_NUM_PATCHES), "--epochs", str(VSR_EPOCHS),
                                      "--learning_rate", str(VSR_LR)]


def vsr_step_stats(model, dev, mv=False, iters=10):
    """The steady VSR training step (make_vsr_step, the frozen-SpyNet Adam) on
    one fixed batch at the launcher's shape (``mv``: with MV_SHIFT motion
    vectors after the RGB channels): mean ms of ``iters`` steps after 3
    warm-up steps (CUDA events), B1 / B2 / B4 launches per step, the peak device
    memory, and one profiled step's kernel time, launches and busy share
    (torch.profiler, device-side events only)."""
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters
    from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

    g = torch.Generator().manual_seed(7)
    oh = VSR_SCALE * VSR_PATCH
    lr = torch.rand((VSR_BATCH, VSR_T, VSR_PATCH, VSR_PATCH, 3), generator=g)
    if mv:
        lr = torch.cat([lr, torch.tensor(MV_SHIFT, dtype=lr.dtype).expand(*lr.shape[:-1], 2)], dim=-1)
    lr = lr.to(dev)
    hr = torch.rand((VSR_BATCH, VSR_T, oh, oh, 3), generator=g).to(dev)
    named = jax_named_parameters(model)
    opt = vsr_multistep_adam(named, VSR_LR, 100, 1, trainable_mask=spynet_frozen_mask(named))
    model.train()
    step = make_vsr_step(model, opt, (oh, oh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_vsr_launches()
    ms = cuda_ms(lambda: step((lr, hr)), iters=iters, warmup=3)
    per_step = {k: v / (iters + 3) for k, v in vsr_launches().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, launches, top = profile_once(lambda: step((lr, hr)))
    return dict(ms=ms, launches_per_step=per_step, peak_gib=peak, profiled_device_ms=busy, busy_share=busy / ms,
                kernel_launches=launches, top_kernels=top)


def profile_once(fn):
    """One call of ``fn`` under torch.profiler: (device ms summed over the
    CUDA events, kernel launches, the 8 largest kernels as (name, count,
    ms)). Device activity only: with the host's too, one basic_origin step
    (~21,000 launches) took 15-16 s to profile against 5-6 (H100), for the
    same device time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(((e.key[:80], e.count, dev_us(e) / 1e3) for e in kernels), key=lambda r: -r[2])[:8]
    return busy, sum(e.count for e in kernels), top


def phase_vsr_train(dev, work):
    """VSR training through its entry point (cli/train_vsr.py) at the
    launcher's full width on synthetic_vsr: two epochs of 4 steps with a
    whole-clip eval of 4 clips after each; finite losses, B1 30 and B2 once
    per forward (training and eval), a weights npz with exactly the JAX
    model's keys and shapes, SpyNet bit-untouched; then the steady step in
    f32 and bf16 with its busy share and launches."""
    from mobilesuperresolution_tpu_torch.cli import train_vsr
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_param_shapes, load_params_npz, random_jax_params

    job = os.path.join(work, "vsr")
    reset_vsr_launches()
    t0 = time.perf_counter()
    out = run_cli(train_vsr.main, vsr_train_argv(job))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vsr_launches()
    steps = out["steps"]
    log(f"  cli.train_vsr: {len(steps)} steps, losses {[round(s['loss'], 6) for s in steps]}, {out['eval_clips']} "
        f"eval clips, eval PSNR {[round(e['synthetic_vsr']['PSNR'], 4) for e in out['eval']]}, {wall:.1f} s; "
        f"launches {launches}")
    if len(steps) != VSR_EPOCHS * VSR_STEPS_PER_EPOCH or not all(np.isfinite(s["loss"]) and s["skipped"] == 0
                                                                  for s in steps):
        raise AssertionError(f"train_vsr steps {[(s['loss'], s['skipped']) for s in steps]}")
    forwards = out["train_forwards"] + out["eval_clips"]
    if routes(launches) != {"B1": B1_PER_WINDOW * forwards, "B2": B2_PER_WINDOW * forwards, "B4": 0}:
        raise AssertionError(f"train_vsr launches {launches}, expected B1 30 and B2 1 per forward ({forwards})")
    model = get_vsr_model("basic", scale=VSR_SCALE, device=dev)
    want = jax_param_shapes(model)
    npz = np.load(os.path.join(job, "weights", "models.npz"))
    if {k: npz[k].shape for k in npz.files} != want:
        raise AssertionError("train_vsr npz keys or shapes differ from the JAX layout")
    init = random_jax_params(model, seed=0)
    spy = [k for k in want if k.startswith("spynet/")]
    moved = [k for k in want if k not in spy and not np.array_equal(npz[k], init[k])]
    if not all(np.array_equal(npz[k], init[k]) for k in spy) or not moved:
        raise AssertionError(f"SpyNet must stay bit-equal and the rest move: {len(moved)} trainable moved")
    log(f"  SpyNet's {len(spy)} tensors bit-untouched, {len(moved)} of {len(want) - len(spy)} trainable moved")
    stats = dict(steps=steps, eval=out["eval"], train_forwards=out["train_forwards"], eval_clips=out["eval_clips"],
                 wall_s=wall, launches=launches)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        m = get_vsr_model("basic", scale=VSR_SCALE, compute_dtype=dtype, device=dev)
        load_params_npz(m, init)
        st = vsr_step_stats(m, dev)
        stats[f"step_{name}"] = st
        log(f"  VSR train step {name}: {st['ms']:.3f} ms (batch {VSR_BATCH} x {VSR_T} frames, {VSR_PATCH}x{VSR_PATCH} "
            f"-> {VSR_SCALE * VSR_PATCH}), B1/B2 per step {st['launches_per_step']}, device busy "
            f"{st['profiled_device_ms']:.3f} ms ({st['busy_share']:.1%}) over {st['kernel_launches']} launches, peak "
            f"{st['peak_gib']:.3f} GiB")
        for k, c, t in st["top_kernels"]:
            log(f"    {t:8.3f} ms {c:5d}x {k}")
        if routes(st["launches_per_step"]) != {"B1": B1_PER_WINDOW, "B2": B2_PER_WINDOW, "B4": 0}:
            raise AssertionError(f"VSR step {name}: launches per step {st['launches_per_step']}")
        del m
    return stats, launches, job


def adam_drift_tol(lrs, betas):
    """How far two Adam runs whose gradients differ by rounding can part, per
    element: a bias-corrected Adam update moves an element by at most
    lr * (1 - b1) / sqrt(1 - b2) / sqrt(1 - b1^2 / b2) (Cauchy-Schwarz over
    the moment sums), so two runs by at most twice that summed over the
    steps."""
    b1, b2 = betas
    per_lr = (1 - b1) / np.sqrt(1 - b2) / np.sqrt(1 - b1 * b1 / b2)
    return 2 * per_lr * float(sum(lrs))


def npz_diff(a, b):
    za, zb = np.load(a), np.load(b)
    if set(za.files) != set(zb.files):
        raise AssertionError("npz keys differ")
    return max(float(np.abs(za[k] - zb[k]).max()) for k in za.files)


def phase_vsr_resume(dev, work, ref_job):
    """Resume round trips on the card: cli.train_vsr at full width stopped by
    --max_steps_per_run mid-epoch and resumed with --resume, against
    phase_vsr_train's uninterrupted run (grid_sample's backward sums with
    atomics, so the runs may part by rounding: held to adam_drift_tol);
    cli.pretrain at a small depth the same way (cuDNN deterministic, so
    expected bit-equal, held to the same kind of bound); and cli.search at
    a small depth stopped inside its width phase, whose resume completes
    every phase."""
    from mobilesuperresolution_tpu_torch.cli import pretrain, search, train_vsr
    from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
    from mobilesuperresolution_tpu_torch.train.state import multistep_lr

    out = {}
    job = os.path.join(work, "vsr_resume")
    stop = VSR_STEPS_PER_EPOCH - 1
    first = run_cli(train_vsr.main, vsr_train_argv(job) + ["--max_steps_per_run", str(stop)])
    second = run_cli(train_vsr.main, vsr_train_argv(job) + ["--resume"])
    if first.get("preempted") != {"epoch": 1, "batch": stop} or second.get("resumed") != {"epoch": 1, "batch": stop}:
        raise AssertionError(f"train_vsr resume: preempted {first.get('preempted')}, resumed {second.get('resumed')}")
    sched = multistep_lr(VSR_LR, VSR_STEPS_PER_EPOCH, VSR_EPOCHS, milestones=[VSR_EPOCHS // 2, VSR_EPOCHS * 8 // 10])
    tol = adam_drift_tol([sched(i) for i in range(VSR_EPOCHS * VSR_STEPS_PER_EPOCH)], (0.9, 0.99))
    err = npz_diff(os.path.join(job, "weights", "models.npz"), os.path.join(ref_job, "weights", "models.npz"))
    log(f"  cli.train_vsr stopped at epoch 1 batch {stop}, resumed: {len(second['steps'])} more steps; final weights "
        f"vs uninterrupted max |diff| {err:.3e} (tol {tol:.3e}), bit-equal {err == 0.0}")
    if not err <= tol:
        raise AssertionError(f"train_vsr resume parted from the uninterrupted run by {err} > {tol}")
    out["train_vsr"] = dict(max_abs_diff=err, tol=tol, bit_equal=err == 0.0)

    small = ["--dataset", "synthetic_isr", "--eval_datasets", "--num_blocks", "2", "--num_residual_units", "8",
             "--scale", "2", "--train_batch_size", "8", "--lr_patch_size", "16", "--num_patches", "2"]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name, extra in (("ref", []), ("job", ["--max_steps_per_run", "3"]), ("job", ["--resume"])):
            runs[name] = run_cli(pretrain.main, ["--job_dir", os.path.join(work, f"pt_{name}"), "--epochs", "2",
                                                 *small,
                                        *extra])
    finally:
        torch.backends.cudnn.deterministic = saved
    if runs["job"].get("resumed") != {"epoch": 2, "batch": 1}:
        raise AssertionError(f"pretrain resume: {runs['job'].get('resumed')}")
    tol = adam_drift_tol([multistep_lr(1e-3, 2, 2)(i) for i in range(4)], (0.9, 0.999))
    err = npz_diff(*(os.path.join(work, f"pt_{n}", "weights", "models.npz") for n in ("job", "ref")))
    log(f"  cli.pretrain (2 blocks, 8 units) stopped at epoch 2 batch 1, resumed: max |diff| {err:.3e} "
        f"(tol {tol:.3e}), bit-equal {err == 0.0}")
    if not err <= tol:
        raise AssertionError(f"pretrain resume parted from the uninterrupted run by {err} > {tol}")
    out["pretrain"] = dict(max_abs_diff=err, tol=tol, bit_equal=err == 0.0)

    sjob = os.path.join(work, "search_resume")
    common = ["--job_dir", sjob, *small, "--width_search", "--speed_target", "5", "--width_epochs", "2",
              "--epochs", "0", "--kernel_epochs", "1", "--log_steps", "1"]
    stopped = run_cli(search.main, common + ["--max_steps_per_run", "3"])
    resumed = run_cli(search.main, common + ["--resume"])
    phases = [(s["phase"], s["epoch"]) for s in resumed["steps"]]
    idx, width = read_block_index(sjob)
    log(f"  cli.search stopped {stopped.get('preempted')}, resumed {resumed.get('resumed')}: steps {phases}, final "
        f"arch {len(idx)} blocks")
    if (stopped.get("preempted") != {"phase": "width", "epoch": 2, "batch": 1}
            or phases != [("width", 2), ("kernel", 3), ("kernel", 3)] or len(width) != len(idx)):
        raise AssertionError(f"search resume: {stopped.get('preempted')}, {phases}")
    out["search"] = dict(preempted=stopped["preempted"], resumed=resumed["resumed"], steps=phases)
    return out


def phase_vsr_eval(dev, job, trained_psnr):
    """cli.test_vsr on phase_vsr_train's npz: whole clips (the PSNR of the
    run's last eval, the same weights and clips), then bf16 windows of 2
    frames with 2 of context (--chunk_frames, 5 windows per 10-frame clip),
    plain and flow-cached: the two within 0.01 dB PSNR and 1e-4 SSIM."""
    from mobilesuperresolution_tpu_torch.cli import test_vsr

    npz = os.path.join(job, "weights", "models.npz")
    argv = vsr_argv(os.path.join(job, "eval")) + ["--eval_model", npz]
    out = {}
    for name, extra in (("whole", []), ("chunked_bf16", ["--bf16", "--chunk_frames", "2", "--chunk_overlap", "2"]),
                        ("flow_cached_bf16", ["--bf16", "--chunk_frames", "2", "--chunk_overlap", "2",
                                              "--flow_cache"])):
        reset_vsr_launches()
        t0 = time.perf_counter()
        res = run_cli(test_vsr.main, argv + extra)["synthetic_vsr"]
        torch.cuda.synchronize()
        out[name] = dict(res, wall_s=time.perf_counter() - t0, launches=vsr_launches())
        log(f"  cli.test_vsr {name}: PSNR {res['PSNR']:.4f} SSIM {res['SSIM']:.4f} ({out[name]['wall_s']:.1f} s, "
            f"launches {out[name]['launches']})")
        if not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"test_vsr {name}: non-finite metrics {res}")
    if not abs(out["whole"]["PSNR"] - trained_psnr) <= 1e-3:
        raise AssertionError(f"test_vsr on the trained npz {out['whole']['PSNR']} != the run's eval {trained_psnr}")
    a, b = out["chunked_bf16"], out["flow_cached_bf16"]
    if not (abs(a["PSNR"] - b["PSNR"]) <= 0.01 and abs(a["SSIM"] - b["SSIM"]) <= 1e-4):
        raise AssertionError(f"flow-cached eval {b['PSNR']}, {b['SSIM']} vs plain windows {a['PSNR']}, {a['SSIM']}")
    return out


def phase_vsr_train_parity(dev):
    """Three VSR training steps of a tiny float32 BasicVSR (nf 8, 1 block,
    x4) on the card against the CPU: per-step losses within 1e-4, the first
    step's gradients within 1e-4 of each one's largest, the weights after
    the first update within 2 lr (Adam's first update is lr * sign(g), which
    rounding can flip on a near-zero gradient) and SpyNet untouched; then
    FusedConvPixelShuffleFn's forward and gradients on the card against
    autograd through the plain version at the training step's tail and a
    ragged shape, f32 and bf16."""
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
        FusedConvPixelShuffleFn,
        fused_conv_pixel_shuffle_plain,
    )
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
    from mobilesuperresolution_tpu_torch.train.checkpoint import (
        jax_named_parameters,
        load_params_npz,
        random_jax_params,
    )
    from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

    lr_rate = 1e-3
    g = torch.Generator().manual_seed(11)
    batches = [(torch.rand((1, 3, 32, 32, 3), generator=g), torch.rand((1, 3, 128, 128, 3), generator=g))
               for _ in range(3)]
    runs = []
    for d in ("cpu", dev):
        m = BasicVSR(num_feat=8, num_block=1, scale=4).to(d)
        load_params_npz(m, random_jax_params(m, seed=6))
        m.train()
        named = jax_named_parameters(m)
        step = make_vsr_step(m, vsr_multistep_adam(named, lr_rate, 3, 1, spynet_frozen_mask(named)), (128, 128))
        losses = []
        for i, (lr, hr) in enumerate(batches):
            losses.append(float(step((lr.to(d), hr.to(d)))["loss"]))
            if i == 0:
                grads = {k: p.grad.cpu() for k, p in named.items() if p.grad is not None}
                after = {k: p.detach().cpu().clone() for k, p in named.items()}
        runs.append((losses, grads, after))
    (l0, g0, w0), (l1, g1, w1) = runs
    lerr = max(abs(a - b) for a, b in zip(l0, l1))
    gerr = max(float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-3) for k in g0)
    werr = max(float((w1[k] - w0[k]).abs().max()) for k in w0)
    spy_grads = [k for k in g0 if k.startswith("spynet/")] + [k for k in g1 if k.startswith("spynet/")]
    log(f"  tiny VSR steps: losses card {l1}, CPU {l0}: max difference {lerr:.3e}; first-step gradients of "
        f"{len(g0)} parameters within {gerr:.3e} of each largest; weights after one update within {werr:.3e} "
        f"(tol {2 * lr_rate:.1e}); SpyNet gradients {len(spy_grads)}")
    if not (lerr <= 1e-4 and gerr <= 1e-4 and werr <= 2 * lr_rate + 1e-6 and not spy_grads
            and set(g0) == set(g1)):
        raise AssertionError(f"tiny VSR steps: losses {lerr}, gradients {gerr}, weights {werr}, spynet {spy_grads}")
    out = {"loss_err": lerr, "grad_err_rel": gerr, "weight_err": werr, "b2_grad": []}

    gen = torch.Generator().manual_seed(12)
    vp = VSR_PATCH
    cases = [(VSR_BATCH * VSR_T, vp, vp, 48, 2, 4, ((1, 2), (1, 2)), (4 * vp + 1, 4 * vp + 1)),
             (3, 37, 53, 16, 3, 2, ((1, 1), (1, 1)), None)]
    for nb, hh, ww, cin, k, s, pad, crop in cases:
        for dtype in (torch.float32, torch.bfloat16):
            cc = 3 * s * s
            x = ((torch.rand((nb, hh, ww, cin), generator=gen) * 2 - 1)).to(dev, dtype)
            kern = ((torch.rand((k, k, cin, cc), generator=gen) * 2 - 1) / np.sqrt(k * k * cin)).to(dev)
            b = (torch.rand((cc,), generator=gen) * 0.2 - 0.1).to(dev)
            res = []
            for fn in (lambda *a: FusedConvPixelShuffleFn.apply(*a, s, pad, crop),
                       lambda *a: fused_conv_pixel_shuffle_plain(*a, s, pad, crop)):
                leaves = [t.clone().requires_grad_(True) for t in (x, kern, b)]
                y = fn(*leaves)
                cot = torch.rand(y.shape, generator=torch.Generator().manual_seed(13)).to(dev, y.dtype) - 0.5
                y.backward(cot)
                res.append((y.detach(), [t.grad for t in leaves]))
            (y, grads), (y_want, grads_want) = res
            tol = bf16_tol if dtype == torch.bfloat16 else f32_tol
            tag = f"FusedConvPixelShuffleFn {nb}x{hh}x{ww}x{cin} {k}x{k} s{s} {str(dtype)[6:]}"
            errs = [check(f"{tag} forward", y, y_want, tol(y_want))]
            for name, gg, gw in zip(("dx", "dkernel", "dbias"), grads, grads_want):
                errs.append(check(f"{tag} {name}", gg, gw, tol(gw)))
            out["b2_grad"].append(dict(case=tag, errs=errs))
    return out


def phase_zoo_parity(dev):
    """A tiny float32 'single' (8 channels, 2 blocks), 'multi' and 'multi_v1'
    (the artifact [[8, 8, 3], [8, 6, 5]]), 'basic_mv' and 'basic_origin' (nf
    8, 1 block; basic_origin's upconv2 at 256 conv channels), x4 on 3
    frames of 64x64 (basic_mv with motion vectors of a few pixels), on the
    card against the CPU: the eval forward within 1e-4 of the largest output
    with B1 / B2 / B4 launched per forward as ZOO_PER_FORWARD says, then two
    training steps with losses within 1e-4 and the first step's gradients
    within 1e-4 of each one's largest, the frozen flow network without a
    gradient."""
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSROrigin
    from mobilesuperresolution_tpu_torch.models.mvvsr import MotionVectorVSR
    from mobilesuperresolution_tpu_torch.models.naive_multi import NaiveMultiModel
    from mobilesuperresolution_tpu_torch.models.naive_multi_v1 import NaiveMultiModelV1
    from mobilesuperresolution_tpu_torch.models.single_image import SingleImageModel
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, load_params_npz, random_jax_params
    from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

    makers = {"single": lambda: SingleImageModel(scale=4, channel=8, blocks=2, kernel=3),
              "multi": lambda: NaiveMultiModel(4, ((8, 8, 3), (8, 6, 5))),
              "basic_mv": lambda: MotionVectorVSR(num_feat=8, num_block=1, scale=4),
              "multi_v1": lambda: NaiveMultiModelV1(4, ((8, 8, 3), (8, 6, 5))),
              "basic_origin": lambda: BasicVSROrigin(num_feat=8, num_block=1, scale=4)}
    out = {}
    for kind, make in makers.items():
        g = torch.Generator().manual_seed(12)

        def clip(shape):
            x = torch.rand(shape, generator=g)
            if kind != "basic_mv":
                return x
            return torch.cat([x, torch.randn(shape, generator=g)[..., :2] * 1.5], dim=-1)

        flat = random_jax_params(make(), seed=3)
        x = clip((1, 3, 64, 64, 3))
        batches = [(clip((1, 3, 64, 64, 3)), torch.rand((1, 3, 256, 256, 3), generator=g)) for _ in range(2)]
        runs = []
        for d in ("cpu", dev):
            m = load_params_npz(make().to(d), flat).eval()
            reset_vsr_launches()
            with torch.inference_mode():
                y = m(x.to(d), 256, 256).cpu()
            launches = vsr_launches()
            m.train()
            named = jax_named_parameters(m)
            step = make_vsr_step(m, vsr_multistep_adam(named, 1e-3, 2, 1, spynet_frozen_mask(named)), (256, 256))
            losses = []
            for i, (lr, hr) in enumerate(batches):
                losses.append(float(step((lr.to(d), hr.to(d)))["loss"]))
                if i == 0:
                    grads = {k: p.grad.cpu() for k, p in named.items() if p.grad is not None}
            runs.append((y, launches, losses, grads))
        (y0, _, l0, g0), (y1, launches, l1, g1) = runs
        yerr = float((y1 - y0).abs().max()) / float(y0.abs().max())
        lerr = max(abs(a - b) for a, b in zip(l0, l1))
        gerr = max(float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-3) for k in g0)
        frozen = [k for k in list(g0) + list(g1) if k.startswith(("flownet/", "spynet/"))]
        log(f"  tiny {kind}: forward within {yerr:.3e} of the largest output, launches {launches}; losses card "
            f"{l1}, CPU {l0} (max difference {lerr:.3e}); first-step gradients of {len(g0)} parameters within "
            f"{gerr:.3e} of each largest")
        if not (yerr <= 1e-4 and lerr <= 1e-4 and gerr <= 1e-4 and not frozen and set(g0) == set(g1)
                and routes(launches) == ZOO_PER_FORWARD[kind]):
            raise AssertionError(f"tiny {kind} card vs CPU: forward {yerr}, losses {lerr}, gradients {gerr}, "
                                 f"flownet {frozen}, launches {launches}")
        out[kind] = dict(forward_err_rel=yerr, loss_err=lerr, grad_err_rel=gerr, launches=launches)
    return out


def phase_zoo_train(dev, work, kinds, mv_root=None):
    """cli.train_vsr for each zoo type of ``kinds`` at full width (as
    phase_vsr_train, one epoch of 4 steps and a whole-clip eval of 4 clips;
    synthetic_vsr, or for 'basic_mv' the REDS-with-MV tree under
    ``mv_root``): finite losses, B1 / B2 / B4 per forward as
    ZOO_PER_FORWARD, a weights npz with exactly the JAX model's keys and
    shapes, the flow network bit-untouched; the steady step in f32 and bf16
    with its busy share; then cli.test_vsr on each npz, whole clips (the
    run's last eval PSNR). Returns (stats, summed launches, {kind: npz
    path})."""
    from mobilesuperresolution_tpu_torch.cli import test_vsr, train_vsr
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_param_shapes, load_params_npz, random_jax_params

    stats, total, npzs = {}, dict.fromkeys(vsr_launches(), 0), {}
    for kind in kinds:
        job = os.path.join(work, f"vsr_{kind}")
        set_name = "reds_with_mv" if kind == "basic_mv" else "synthetic_vsr"
        reset_vsr_launches()
        t0 = time.perf_counter()
        out = run_cli(train_vsr.main, vsr_train_argv(job, kind, mv_root) + ["--epochs", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = vsr_launches()
        steps = out["steps"]
        forwards = out["train_forwards"] + out["eval_clips"]
        log(f"  cli.train_vsr {kind}: {len(steps)} steps, losses {[round(s['loss'], 6) for s in steps]}, "
            f"{out['eval_clips']} eval clips, eval PSNR {out['eval'][-1][set_name]['PSNR']:.4f} (bilinear "
            f"{out['eval'][-1][set_name]['bilinear_PSNR']:.4f}), {wall:.1f} s; launches {launches} over {forwards} "
            f"forwards")
        if len(steps) != VSR_STEPS_PER_EPOCH or not all(np.isfinite(s["loss"]) and s["skipped"] == 0 for s in steps):
            raise AssertionError(f"train_vsr {kind} steps {[(s['loss'], s['skipped']) for s in steps]}")
        if routes(launches) != {k: v * forwards for k, v in ZOO_PER_FORWARD[kind].items()}:
            raise AssertionError(f"train_vsr {kind} launches {launches}, expected {ZOO_PER_FORWARD[kind]} per forward")
        model = get_vsr_model(kind, scale=VSR_SCALE, device=dev, block_index_path=ZOO_ARTIFACT)
        want = jax_param_shapes(model)
        npzs[kind] = os.path.join(job, "weights", "models.npz")
        npz = np.load(npzs[kind])
        if {k: npz[k].shape for k in npz.files} != want:
            raise AssertionError(f"train_vsr {kind} npz keys or shapes differ from the JAX layout")
        init = random_jax_params(model, seed=0)
        frozen = [k for k in want if k.startswith(("flownet/", "spynet/"))]
        moved = [k for k in want if k not in frozen and not np.array_equal(npz[k], init[k])]
        if not all(np.array_equal(npz[k], init[k]) for k in frozen) or not moved:
            raise AssertionError(f"{kind}: the flow network must stay bit-equal and the rest move: {len(moved)} moved")
        st = dict(steps=steps, eval=out["eval"], train_forwards=out["train_forwards"], eval_clips=out["eval_clips"],
                  wall_s=wall, launches=launches, moved=len(moved), trainable=len(want) - len(frozen))
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            m = get_vsr_model(kind, scale=VSR_SCALE, compute_dtype=dtype, device=dev, block_index_path=ZOO_ARTIFACT)
            load_params_npz(m, init)
            # basic_origin's steps take ~0.5 s: 5 timed steps hold its mean
            ss = vsr_step_stats(m, dev, mv=kind == "basic_mv", iters=5 if kind == "basic_origin" else 10)
            st[f"step_{name}"] = ss
            log(f"  {kind} train step {name}: {ss['ms']:.3f} ms, B1/B2 per step {ss['launches_per_step']}, device "
                f"busy {ss['profiled_device_ms']:.3f} ms ({ss['busy_share']:.1%}) over {ss['kernel_launches']} "
                f"launches, peak {ss['peak_gib']:.3f} GiB")
            for k, c, t in ss["top_kernels"][:4]:
                log(f"    {t:8.3f} ms {c:5d}x {k}")
            if routes(ss["launches_per_step"]) != ZOO_PER_FORWARD[kind]:
                raise AssertionError(f"{kind} step {name}: launches per step {ss['launches_per_step']}")
            del m
        reset_vsr_launches()
        ev = run_cli(test_vsr.main, vsr_argv(os.path.join(job, "eval"), kind, mv_root)
                     + ["--eval_model", npzs[kind]])[set_name]
        st["test_vsr"] = dict(ev, launches=vsr_launches())
        trained = out["eval"][-1][set_name]["PSNR"]
        log(f"  cli.test_vsr {kind} on the npz: PSNR {ev['PSNR']:.4f} (run's last eval {trained:.4f}), launches "
            f"{st['test_vsr']['launches']}")
        if not abs(ev["PSNR"] - trained) <= 1e-3 or not all(np.isfinite(v) for v in ev.values()):
            raise AssertionError(f"test_vsr {kind}: {ev} against the run's eval PSNR {trained}")
        stats[kind] = st
        for k in total:
            total[k] += launches[k]
    return stats, total, npzs


def patch_argv(job, npz):
    """cli.test_vsr_by_patch at launchers/video_test_patch.sh's settings on
    one synthetic 10-frame clip at REDS's frame size."""
    return ["--job_dir", job, "--dataset", "synthetic_vsr", "--eval_datasets", "synthetic_vsr", "--model_type",
            "basic", "--scale", str(VSR_SCALE), "--image_batch", str(VSR_T), "--patch_h", str(PATCH), "--patch_w",
            str(PATCH), "--overlap_h", str(PATCH_OVERLAP[0]), "--overlap_w", str(PATCH_OVERLAP[1]),
            "--synthetic_frames", str(VSR_T), "--synthetic_clips", "1", "--synthetic_size",
            f"{PATCH_HR[0]}x{PATCH_HR[1]}", "--eval_model", npz]


def phase_patch_eval(dev, work, npz):
    """cli.test_vsr_by_patch at launchers/video_test_patch.sh's settings on
    phase_vsr_train's basic npz: the .npy's shape (4 rows x 10 patches x 10
    frames) and finiteness, B1 30 and B2 1 per patch batch; then the forward
    ms per patch batch (1 patch, the CLI's default, and all 10 in one) and
    evaluate_by_patch's patches per second end to end (statistics
    included). Returns (stats, launches)."""
    from mobilesuperresolution_tpu_torch.cli import test_vsr_by_patch
    from mobilesuperresolution_tpu_torch.core import modes
    from mobilesuperresolution_tpu_torch.data import get_dataset_module
    from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz

    job = os.path.join(work, "patch")
    size = f"{PATCH_HR[0]}x{PATCH_HR[1]}"
    argv = patch_argv(job, npz)
    reset_vsr_launches()
    t0 = time.perf_counter()
    res = run_cli(test_vsr_by_patch.main, argv)["synthetic_vsr"]
    wall = time.perf_counter() - t0
    launches = vsr_launches()
    arr = np.load(os.path.join(job, "run", f"basic_{PATCH}_{PATCH}_2.npy"))
    log(f"  cli.test_vsr_by_patch: array {arr.shape}, PSNR {arr[2].mean():.4f} bilinear {arr[3].mean():.4f}, "
        f"{wall:.2f} s, launches {launches}")
    if arr.shape != (4, N_PATCHES * VSR_T) or not np.isfinite(arr).all() or not np.array_equal(arr, res):
        raise AssertionError(f"patch eval array {arr.shape}, finite {np.isfinite(arr).all()}")
    if routes(launches) != {"B1": B1_PER_WINDOW * N_PATCHES, "B2": B2_PER_WINDOW * N_PATCHES, "B4": 0}:
        raise AssertionError(f"patch eval launches {launches} for {N_PATCHES} patch batches")

    params = argparse.Namespace(scale=VSR_SCALE, synthetic_size=size, synthetic_clips=1, synthetic_frames=VSR_T,
                                seed=0)
    batches = list(batch_iterator(get_dataset_module("synthetic_vsr").get_dataset(modes.EVAL, params)))
    model = get_vsr_model("basic", scale=VSR_SCALE, device=dev)
    load_params_npz(model, npz)
    lr = torch.from_numpy(batches[0][1]).to(dev)

    def fwd(x, oh, ow):
        with torch.inference_mode():
            return model(x, oh, ow)

    out = dict(array_shape=list(arr.shape), psnr=float(arr[2].mean()), bilinear_psnr=float(arr[3].mean()),
               cli_wall_s=wall, launches=launches, per_patch_batch={"B1": B1_PER_WINDOW, "B2": B2_PER_WINDOW})
    positions = test_vsr_by_patch.patch_positions(lr.shape[2], lr.shape[3], (PATCH, PATCH), PATCH_OVERLAP)
    with torch.inference_mode():
        for pb in (1, N_PATCHES):
            x = torch.cat([lr[:, :, sh : sh + PATCH, sw : sw + PATCH] for sh, sw in positions[:pb]]).contiguous()
            ms = cuda_ms(lambda: fwd(x, VSR_SCALE * PATCH, VSR_SCALE * PATCH), iters=10, warmup=2)
            busy, kernels, top = profile_once(lambda: fwd(x, VSR_SCALE * PATCH, VSR_SCALE * PATCH))
            t0 = time.perf_counter()
            test_vsr_by_patch.evaluate_by_patch(fwd, iter(batches), VSR_SCALE, (PATCH, PATCH), PATCH_OVERLAP, pb,
                                                device=dev)
            torch.cuda.synchronize()
            e2e = time.perf_counter() - t0
            out[f"patch_batch_{pb}"] = dict(forward_ms=ms, patches_per_s=N_PATCHES / e2e, wall_s=e2e,
                                            profiled_device_ms=busy, busy_share=busy / ms, kernel_launches=kernels,
                                            top_kernels=top)
            log(f"  patch batch {pb}: forward {ms:.3f} ms ({pb} x {VSR_T} frames of {PATCH}x{PATCH}), device busy "
                f"{busy:.3f} ms ({busy / ms:.1%}) over {kernels} launches; evaluate_by_patch {N_PATCHES / e2e:.2f} "
                f"patches/s end to end ({e2e:.3f} s, statistics included)")
            for k, c, t in top[:4]:
                log(f"    {t:8.3f} ms {c:5d}x {k}")
    return out, launches


def phase_zoo_serve(dev, work, npz):
    """A short cli.serve stream of 'multi' (the trained npz, bf16, chunk 4,
    overlap 3) over 16 synthetic 426x240 frames: 16 frames out at
    1704x960, B1 30 and B2 1 per window (4 windows and the warm-up one).
    Returns (stats, launches)."""
    import contextlib
    import io

    from PIL import Image

    from mobilesuperresolution_tpu_torch.cli import serve

    d = os.path.join(work, "serve_frames")
    os.makedirs(d)
    for i, fr in enumerate(synthetic_stream(N_STREAM_FRAMES, H_LR, W_LR, seed=2)):
        Image.fromarray((fr * 255).round().astype(np.uint8)).save(os.path.join(d, f"{i:04d}.png"))
    job = os.path.join(work, "serve_multi")
    argv = ["--job_dir", job, "--input_dir", d, *model_argv("multi"), "--eval_model", npz, "--bf16",
            "--chunk_frames", str(CHUNK), "--chunk_overlap", str(OVERLAP)]
    reset_vsr_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = run_cli(serve.main, argv)
    launches = vsr_launches()
    windows = len(range(0, N_STREAM_FRAMES, CHUNK)) + 1  # and the warm-up window
    names = sorted(os.listdir(os.path.join(job, "serve")))
    shape = np.asarray(Image.open(os.path.join(job, "serve", names[0]))).shape
    log(f"  cli.serve multi: {stats['frames']} frames of {shape}, {stats['fps_end_to_end']} frames/s end to end "
        f"(PNG writes included), launches {launches}")
    if stats["frames"] != N_STREAM_FRAMES or len(names) != N_STREAM_FRAMES or shape != (4 * H_LR, 4 * W_LR, 3):
        raise AssertionError(f"serve multi: {stats}, {len(names)} files of {shape}")
    if routes(launches) != {"B1": B1_PER_WINDOW * windows, "B2": B2_PER_WINDOW * windows, "B4": 0}:
        raise AssertionError(f"serve multi launches {launches} for {windows} windows")
    return dict(stats, launches=launches, windows=windows), launches


def phase_mv_data(work):
    """The REDS-with-MV tree (write_reds_mv_tree) through data/reds_with_mv.py:
    an eval clip's items carry MV_SHIFT as every vector of frames 1.., and
    warping frame t-1 by them (ops/warp.py, the propagation's warp) gives
    frame t away from the borders: the vectors are the model's forward
    flows. Returns (the tree's root, stats)."""
    from mobilesuperresolution_tpu_torch.core import modes
    from mobilesuperresolution_tpu_torch.data import reds_with_mv
    from mobilesuperresolution_tpu_torch.ops.warp import flow_warp

    root = os.path.join(work, "reds_mv")
    t0 = time.perf_counter()
    write_reds_mv_tree(root)
    wall = time.perf_counter() - t0
    params = argparse.Namespace(scale=VSR_SCALE, data_dir=root, image_batch=VSR_T, val_image_batch=VSR_T, seed=0)
    ds = reds_with_mv.get_dataset(modes.EVAL, params)
    _, lr, hr = ds[0]
    x = torch.from_numpy(lr)
    m = 4 * max(MV_SHIFT)
    warp_err = float((flow_warp(x[:-1, ..., :3], x[1:, ..., 3:], padding_mode="zeros") - x[1:, ..., :3])
                     [:, m:-m, m:-m].abs().max())
    mv_ok = bool((x[1:, ..., 3:] == torch.tensor(MV_SHIFT, dtype=x.dtype)).all())
    log(f"  REDS-with-MV tree: {len(ds)} eval clips of {lr.shape} LR / {hr.shape} HR, written in {wall:.2f} s; "
        f"vectors == {MV_SHIFT}: {mv_ok}; frame t-1 warped by them vs frame t: max |diff| {warp_err:.3e}")
    if len(ds) != VSR_CLIPS or lr.shape != (VSR_T, VSR_HR // VSR_SCALE, VSR_HR // VSR_SCALE, 5) or not mv_ok \
            or not warp_err <= 1e-5:
        raise AssertionError(f"REDS-with-MV items: {len(ds)} clips, {lr.shape}, vectors {mv_ok}, warp {warp_err}")
    return root, dict(clips=len(ds), lr_shape=list(lr.shape), write_s=wall, warp_err=warp_err)


def phase_origin_serve(dev):
    """basic_origin (nf 64, 30 blocks, x4) served in bf16 by StreamingVSR
    (chunk 4, overlap 3: 10-frame windows) over 10 426x240 frames: 10
    finite 1080x1920 frames, B1 30 and B2 2 per window (3 windows); then the
    flow-cached stream (serve/flow_cache.py) on the same frames, within
    bf16_tol of the plain one, B1 30 per flow group and B2 2 per window;
    then the ms of one window forward and of sr_fn. Returns (stats, summed
    launches)."""
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.models.basicvsr import compute_flows
    from mobilesuperresolution_tpu_torch.serve import FlowCachedStreamingVSR, StreamingVSR, make_flow_sr_fns
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    model = get_vsr_model("basic_origin", scale=4, compute_dtype=torch.bfloat16, device=dev)
    load_params_npz(model, random_jax_params(model, seed=0))
    per = ZOO_PER_FORWARD["basic_origin"]

    def apply_fn(x, oh, ow):
        with torch.inference_mode():
            return model(x, oh, ow)

    frames = synthetic_stream(T_WIN, H_LR, W_LR, seed=1)
    windows = len(range(0, T_WIN, CHUNK))
    stream = StreamingVSR(apply_fn, OH, OW, chunk=CHUNK, overlap=OVERLAP, device=dev)
    stream.warmup((H_LR, W_LR, 3))
    reset_vsr_launches()
    out, wall = run_stream(stream, frames)
    plain = vsr_launches()
    if len(out) != T_WIN or any(fr.shape != (OH, OW, 3) or not np.isfinite(fr).all() for fr in out):
        raise AssertionError(f"basic_origin stream: {len(out)} frames of {out[0].shape if out else None}")
    if routes(plain) != {k: v * windows for k, v in per.items()}:
        raise AssertionError(f"basic_origin stream launches {plain} for {windows} windows")

    flow_fn, sr_fn = make_flow_sr_fns(model, OH, OW)
    groups = []

    def counted_flow(ref, supp):
        groups.append(ref.shape[0])
        return flow_fn(ref, supp)

    cstream = FlowCachedStreamingVSR(counted_flow, sr_fn, OH, OW, chunk=CHUNK, overlap=OVERLAP, device=dev)
    cstream.warmup((H_LR, W_LR, 3))
    groups.clear()
    reset_vsr_launches()
    cout, cwall = run_stream(cstream, frames)
    cached = vsr_launches()
    want = torch.from_numpy(np.stack(out))
    err = check("basic_origin cached stream vs plain stream (bf16)", torch.from_numpy(np.stack(cout)), want,
                bf16_tol(want))
    if routes(cached) != {"B1": B1_PER_WINDOW * len(groups), "B2": per["B2"] * windows, "B4": 0}:
        raise AssertionError(f"basic_origin cached stream launches {cached} for {len(groups)} groups, "
                             f"{windows} windows")

    x = torch.from_numpy(np.stack(frames)[None]).to(dev)
    with torch.inference_mode():
        win_ms = cuda_ms(lambda: model(x, OH, OW), iters=3, warmup=1)
        ff, fb = compute_flows(model.spynet, x.to(torch.bfloat16))
        sr_ms = cuda_ms(lambda: sr_fn(x, ff, fb), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  basic_origin stream: {len(out)} frames in {windows} windows, {wall:.3f} s, launches {plain}; cached: "
        f"{len(groups)} flow groups, {cwall:.3f} s, launches {cached}; window forward {win_ms:.3f} ms "
        f"({T_WIN / win_ms * 1e3:.2f} frames/s), sr_fn {sr_ms:.3f} ms; peak {peak:.3f} GiB")
    total = {k: plain[k] + cached[k] for k in plain}
    return dict(frames=len(out), windows=windows, stream_wall_s=wall, cached_wall_s=cwall, launches=plain,
                cached_launches=cached, flow_groups=len(groups), cached_max_abs_err=err, window_ms=win_ms,
                window_fps=T_WIN / win_ms * 1e3, sr_fn_ms=sr_ms, peak_mem_gib=peak), total


def phase_latency_table(gen, dev):
    """The on-card latency table: kernels/timing.py::build_latency_table at
    the JAX harness's default grid (LATENCY_CH_IN x 4 splits x k 3/5/7 = 72
    configs, a 240x426 input, method "loop"), after one split block per k at
    ch_in 32, full split, against its plain version. Checks B5 launched once
    per timed block call, every row finite and >= 0; writes the table to
    chiprun_out/<device kind>.npy."""
    from mobilesuperresolution_tpu_torch.kernels import timing
    from mobilesuperresolution_tpu_torch.kernels.fused_convsep import fused_convsep, fused_convsep_plain
    from mobilesuperresolution_tpu_torch.nas.speed_estimator import device_kind

    errs = {}
    x = (torch.rand((1, *LATENCY_HW, 32), generator=gen) * 2 - 1).to(dev)
    for k in (3, 5, 7):
        w = timing.split_block_weights(32, k, seed=k, device=dev)
        with torch.inference_mode():
            got = timing.split_block(x, 32, w)
            want = timing.split_block(x, 32, w, branch=fused_convsep_plain)
        errs[k] = check(f"split block k{k} (ch_in 32, full split)", got, want, f32_tol(want))
    grid = timing.latency_grid()
    fused_convsep.launches = 0
    t0 = time.perf_counter()
    rows = []

    def progress(row):
        rows.append(row)
        log(f"    ch_in {row[0]:2d} split {row[1]:2d} k{row[2]}: {row[3]:.5f} ms")

    table = timing.build_latency_table(method="loop", device=dev, progress=progress)
    wall = time.perf_counter() - t0
    launches = fused_convsep.launches
    want_launches = len(grid) * timing.loop_calls(iters=50, reps=5, warmup=1)
    log(f"  build_latency_table: {len(table)} configs in {wall:.1f} s, B5 launches {launches} "
        f"(expected {want_launches})")
    if launches != want_launches:
        raise AssertionError(f"latency table: B5 launches {launches}, expected {want_launches}")
    if table.shape != (len(grid), 4) or table[:, :3].tolist() != [list(r) for r in grid]:
        raise AssertionError(f"latency table grid {table[:, :3].tolist()[:4]}... differs from the harness's")
    if not (np.isfinite(table).all() and (table[:, 3] >= 0).all()):
        raise AssertionError(f"latency table has non-finite or negative rows: {table[:, 3]}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{device_kind()}.npy")
    np.save(path, table)
    log(f"  table → {path}")
    return dict(rows=table.tolist(), wall_s=wall, block_max_abs_err=errs, launches=launches,
                kind=device_kind()), {"B5": launches}


def nas_argv(job_dir, blocks):
    """cli.search at launchers/search.sh's width (x2, 32 units, batch 16,
    patch 48) with ``blocks`` blocks, one epoch of the width phase only."""
    return ["--job_dir", job_dir, "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--scale",
            "2", "--num_blocks", str(blocks), "--num_residual_units", str(NAS_UNITS), "--width_search",
            "--speed_target", "500", "--width_epochs", "1", "--epochs", "0", "--kernel_epochs", "0",
            "--num_patches", str(NAS_NUM_PATCHES), "--train_batch_size", str(NAS_BATCH), "--lr_patch_size",
            str(NAS_PATCH), "--learning_rate", "1e-3"]


def phase_search_latency(work):
    """The search's latency paths through cli.search: --build_speed_table at
    16 blocks (12 configs timed on the card, then B5 48 times per forward),
    --speed_predictor tpu_v5_lite, and --speed_table auto (this card's
    packaged table) with --pretrained from a seeded reference-layout WDSR-B
    .pt (9 tensors), the last two at 4 blocks."""
    from mobilesuperresolution_tpu_torch.cli import search
    from mobilesuperresolution_tpu_torch.kernels import timing
    from mobilesuperresolution_tpu_torch.kernels.fused_convsep import fused_convsep
    from mobilesuperresolution_tpu_torch.models import BasicModel
    from mobilesuperresolution_tpu_torch.nas.speed_estimator import packaged_table_path
    from mobilesuperresolution_tpu_torch.train.checkpoint import random_jax_params

    stats, total = {}, 0
    job = os.path.join(work, "search_table")
    fused_convsep.launches = 0
    t0 = time.perf_counter()
    out = run_cli(search.main, nas_argv(job, NAS_BLOCKS) + ["--build_speed_table"])
    wall = time.perf_counter() - t0
    table = np.load(os.path.join(job, "speed_table.npy"))
    timed = len(timing.latency_grid((NAS_UNITS,))) * timing.loop_calls(iters=50, reps=5, warmup=1)
    want = timed + B5_PER_FORWARD * (out["train_forwards"] + out["eval_images"])
    log(f"  --build_speed_table: table {table.shape}, {out['train_forwards']} steps + {out['eval_images']} eval "
        f"images, {wall:.1f} s; B5 launches {fused_convsep.launches} (expected {want}: {timed} timed)")
    if table.shape != (12, 4) or not (np.isfinite(table).all() and (table[:, 3] >= 0).all()):
        raise AssertionError(f"--build_speed_table wrote {table.shape}: {table}")
    if fused_convsep.launches != want:
        raise AssertionError(f"--build_speed_table: B5 launches {fused_convsep.launches}, expected {want}")
    stats["build_speed_table"] = dict(table=table.tolist(), wall_s=wall, launches=fused_convsep.launches,
                                      steps=out["steps"])
    total += fused_convsep.launches

    own = packaged_table_path()
    wdsr = BasicModel(num_blocks=NAS_BLOCKS, num_residual_units=NAS_UNITS, scale=2)
    pt = os.path.join(work, "wdsr_b_x2_16_32.pt")
    torch.save(reference_state_dict("wdsr", random_jax_params(wdsr, seed=4)), pt)
    runs = {"speed_predictor": ["--speed_predictor", "tpu_v5_lite"],
            "speed_table_auto_pretrained": ["--speed_table", "auto", "--pretrained", "--pretrained_path", pt]}
    for name, flags in runs.items():
        job = os.path.join(work, f"search_{name}")
        fused_convsep.launches = 0
        t0 = time.perf_counter()
        out = run_cli(search.main, nas_argv(job, 4) + flags)
        wall = time.perf_counter() - t0
        text = open(os.path.join(job, "result.log")).read()
        speed = re.search(r"Supernet Speed: ([\d.]+) ms", text).group(1)
        forwards = out["train_forwards"] + out["eval_images"]
        log(f"  {' '.join(flags)}: supernet speed {speed} ms, {len(out['steps'])} steps, {wall:.1f} s, B5 "
            f"launches {fused_convsep.launches} ({forwards} forwards)" +
            (f"; {out['pretrained_copied']} tensors copied" if "pretrained_copied" in out else ""))
        if fused_convsep.launches != 3 * 4 * forwards or not all(np.isfinite(s["loss"]) for s in out["steps"]):
            raise AssertionError(f"search {name}: launches {fused_convsep.launches}, steps {out['steps']}")
        if name.startswith("speed_table_auto") and (own is None or f"latency table from {own}" not in text
                                                   or out.get("pretrained_copied") != 9):
            raise AssertionError(f"--speed_table auto resolved to {own!r}; copied {out.get('pretrained_copied')}")
        if name == "speed_predictor" and "tpu_v5_lite_predictor.msgpack" not in text:
            raise AssertionError("--speed_predictor tpu_v5_lite did not load the packaged predictor")
        stats[name] = dict(supernet_speed_ms=float(speed), wall_s=wall, launches=fused_convsep.launches,
                           pretrained_copied=out.get("pretrained_copied"), table=own)
        total += fused_convsep.launches
    return stats, {"B5": total}


def phase_reference_checkpoints(dev, work, mv_root):
    """Seeded state dicts with the reference's key names, each loaded
    through its entry point and held bit-equal to the npz route with the
    same weights: WDSR-B x2 (16 blocks, 24 units) .pt through
    load_reference_wdsr and the port's evaluate (B3 16 + B4 1 per image);
    'basic_origin' (as mmedit's {"meta", "params"}), 'basic_mv', 'single'
    and 'multi' .pth through cli.test_vsr --eval_model (B1 / B2 / B4 per
    forward as ZOO_PER_FORWARD); a SpyNet .pth through cli.train_vsr
    --spynet_weights for one step."""
    from mobilesuperresolution_tpu_torch.cli import test_vsr, train_vsr
    from mobilesuperresolution_tpu_torch.cli.common_cli import load_vsr_eval_params
    from mobilesuperresolution_tpu_torch.models import BasicModel, get_vsr_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params
    from mobilesuperresolution_tpu_torch.train.evaluate import evaluate
    from mobilesuperresolution_tpu_torch.train.torch_convert import load_reference_wdsr

    stats, total = {}, dict(dict.fromkeys(vsr_launches(), 0), B3=0)
    g = torch.Generator().manual_seed(24)
    # WDSR-B x2 through evaluate
    wdsr = BasicModel(num_blocks=SR_BLOCKS, num_residual_units=SR_UNITS, scale=SR_SCALE)
    flat = random_jax_params(wdsr, seed=5)
    pt = os.path.join(work, "wdsr_b_x2_16_24.pt")
    torch.save(reference_state_dict("wdsr", flat), pt)
    params, blocks, units = load_reference_wdsr(pt)
    if (blocks, units) != (SR_BLOCKS, SR_UNITS):
        raise AssertionError(f"load_reference_wdsr: {blocks} blocks, {units} units")
    from_pt = load_params_npz(BasicModel(blocks, units, SR_SCALE).to(dev), params).eval()
    from_npz = load_params_npz(BasicModel(blocks, units, SR_SCALE).to(dev), flat).eval()
    x = torch.rand((1, 96, 128, 3), generator=g).to(dev)
    reset_sisr_launches()
    with torch.inference_mode():
        a = from_pt(x)
        per_forward = sisr_launches()
        b = from_npz(x)
    results = {}
    reset_sisr_launches()
    for route, m in (("pt", from_pt), ("npz", from_npz)):

        def fwd(lr, oh, ow, m=m):
            with torch.inference_mode():
                return m(lr)

        results[route] = evaluate(fwd, held_out_batches(), scale=SR_SCALE, device=dev).as_dict()
        if route == "pt":
            eval_launches = sisr_launches()
    n_images = len(list(held_out_batches()))
    log(f"  wdsr .pt: bit-equal {torch.equal(a, b)}, launches per forward {per_forward}, evaluate PSNR "
        f"{results['pt']['PSNR']:.4f} (npz {results['npz']['PSNR']:.4f}) over {n_images} images, launches "
        f"{eval_launches}")
    if not torch.equal(a, b) or results["pt"] != results["npz"]:
        raise AssertionError("the .pt-loaded WDSR-B differs from the npz-loaded one")
    if per_forward != {"B3": B3_PER_IMAGE, "B4": B4_PER_IMAGE} or eval_launches != {
            "B3": B3_PER_IMAGE * n_images, "B4": B4_PER_IMAGE * n_images}:
        raise AssertionError(f"wdsr .pt launches {per_forward} per forward, {eval_launches} in evaluate")
    stats["wdsr_pt"] = dict(psnr=results["pt"]["PSNR"], launches=eval_launches)
    for k in ("B3", "B4"):
        total[k] += eval_launches[k]

    # the VSR zoo through cli.test_vsr --eval_model x.pth
    for kind in ("basic_origin", "basic_mv", "single", "multi"):
        set_name = "reds_with_mv" if kind == "basic_mv" else "synthetic_vsr"
        model = get_vsr_model(kind, scale=VSR_SCALE, device=dev, block_index_path=ZOO_ARTIFACT)
        flat = random_jax_params(model, seed=6)
        sd = reference_state_dict(kind, flat)
        if kind == "basic_origin":
            sd = {"meta": {"mmedit_version": "0.x", "epoch": 300}, "params": sd}
        pth, npz = os.path.join(work, f"{kind}.pth"), os.path.join(work, f"{kind}.npz")
        torch.save(sd, pth)
        np.savez(npz, **flat)
        by_pth = load_vsr_eval_params(pth, kind, get_vsr_model(kind, scale=VSR_SCALE, device=dev,
                                                               block_index_path=ZOO_ARTIFACT))
        by_npz = load_params_npz(model, npz)
        c = 5 if kind == "basic_mv" else 3
        clip = torch.rand((1, 4, 32, 48, c), generator=g).to(dev)
        with torch.inference_mode():
            a, b = by_pth(clip, 128, 192), by_npz(clip, 128, 192)
        runs = {}
        for route, path in (("pth", pth), ("npz", npz)):
            reset_vsr_launches()
            job = os.path.join(work, f"ckpt_{kind}_{route}")
            runs[route] = run_cli(test_vsr.main, vsr_argv(job, kind, mv_root) + ["--eval_model", path])[set_name]
            runs[f"{route}_launches"] = vsr_launches()
        clips = VSR_CLIPS
        want = {k: v * clips for k, v in ZOO_PER_FORWARD[kind].items()}
        log(f"  {kind} .pth: forward bit-equal {torch.equal(a, b)}; cli.test_vsr PSNR {runs['pth']['PSNR']:.4f} "
            f"(npz {runs['npz']['PSNR']:.4f}), launches {runs['pth_launches']} over {clips} clips")
        if not torch.equal(a, b) or runs["pth"] != runs["npz"]:
            raise AssertionError(f"{kind}: the .pth-loaded model differs from the npz-loaded one")
        if routes(runs["pth_launches"]) != want:
            raise AssertionError(f"{kind} .pth: launches {runs['pth_launches']}, expected {want}")
        stats[kind] = dict(psnr=runs["pth"]["PSNR"], launches=runs["pth_launches"])
        for k in ("B1", "B2", "B4", "B1_f32", "B2_f32"):
            total[k] += runs["pth_launches"][k]
        del model, by_pth, by_npz

    # a SpyNet .pth (mmedit's spynet. prefix) through cli.train_vsr, one step
    from mobilesuperresolution_tpu_torch.models import SpyNet

    spy = random_jax_params(SpyNet(), seed=7)
    spth, snpz = os.path.join(work, "spynet.pth"), os.path.join(work, "spynet.npz")
    torch.save({"params": {f"spynet.{k}": v for k, v in reference_state_dict("spynet", spy).items()}}, spth)
    np.savez(snpz, **spy)
    losses = {}
    for route, path in (("pth", spth), ("npz", snpz)):
        job = os.path.join(work, f"spynet_{route}")
        reset_vsr_launches()
        out = run_cli(train_vsr.main, vsr_train_argv(job) + ["--spynet_weights", path, "--max_steps_per_run", "1"])
        losses[route] = [s["loss"] for s in out["steps"]]
        launches = vsr_launches()
    log(f"  spynet .pth through cli.train_vsr: step losses {losses['pth']} (npz {losses['npz']}), launches "
        f"{launches}")
    if losses["pth"] != losses["npz"] or len(losses["pth"]) != 1 or routes(launches) != {
            "B1": B1_PER_WINDOW, "B2": 1, "B4": 0}:
        raise AssertionError(f"spynet .pth: losses {losses}, launches {launches}")
    stats["spynet_pth"] = dict(loss=losses["pth"][0], launches=launches)
    for k in ("B1", "B2", "B1_f32", "B2_f32"):
        total[k] += launches[k]
    return stats, total


def phase_logging_profiling(work):
    """result.log in every job dir of the entry points run so far, then one
    cli.pretrain epoch with --xla_profile_steps 2: one trace naming B3's
    kernel."""
    from mobilesuperresolution_tpu_torch.cli import pretrain

    present = [j for j in LOGGED_JOBS if os.path.isdir(j)]
    missing = [j for j in present if not os.path.exists(os.path.join(j, "result.log"))]
    log(f"  result.log written by all {len(LOGGED_JOBS)} entry-point runs so far ({len(present)} job dirs still "
        f"present, {len(missing)} of them without it)")
    if missing or not LOGGED_JOBS:
        raise AssertionError(f"result.log missing in {missing}")
    job = os.path.join(work, "profiled")
    t0 = time.perf_counter()
    run_cli(pretrain.main, sisr_train_argv(job) + ["--num_blocks", str(SR_BLOCKS), "--num_residual_units",
                                                   str(SR_UNITS), "--xla_profile_steps", "2"])
    wall = time.perf_counter() - t0
    traces = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(job, "profile")) for f in fs]
    text = open(traces[0]).read() if len(traces) == 1 else ""
    events = json.loads(text).get("traceEvents", []) if text else []
    b3 = sorted({e["name"] for e in events if "wdsr_block" in e.get("name", "")})
    log(f"  --xla_profile_steps 2: {traces}, {len(events)} events, {len(text) / 1e6:.2f} MB, B3's kernels {b3}; "
        f"{wall:.1f} s")
    if len(traces) != 1 or not b3:
        raise AssertionError(f"profile: traces {traces}, B3's kernel named {b3}")
    return dict(logged_jobs=len(LOGGED_JOBS), trace_events=len(events), trace_mb=len(text) / 1e6, b3_kernels=b3,
                wall_s=wall)


def q1_counts():
    """The int8 path's kernel counts: Q1, Q1s and the float kernels beside
    them."""
    from mobilesuperresolution_tpu_torch.kernels.qconv_int8 import act_scale, qconv_int8

    return dict(vsr_launches(), **sisr_launches(), Q1=qconv_int8.launches, Q1s=act_scale.launches)


def reset_q1_counts():
    from mobilesuperresolution_tpu_torch.kernels.qconv_int8 import act_scale, qconv_int8

    reset_vsr_launches()
    reset_sisr_launches()
    qconv_int8.launches = act_scale.launches = 0


def check_q1s(launches, where):
    """On the card a quantized conv is Q1s then Q1: as many of each."""
    if launches["Q1s"] != launches["Q1"]:
        raise AssertionError(f"{where}: Q1s {launches['Q1s']} launches against Q1's {launches['Q1']}")


def phase_q1_kernels(gen, dev):
    """Q1s and Q1 against their plain versions at every shape this slice
    launches them on, bit for bit (tolerance 0): float inputs uniform in
    [-3, 3], f32 and bf16, Q1 with and without bias; the all-±127 edge
    (inputs of exactly ±127 xs against weights of -127, the int32 edge);
    and the same inputs as a row window of a taller frame (a view, as
    height sharding passes them). Then each kernel's ms as the path runs
    it, its plain ms and its bound: Q1's int8 operations at the dense
    tensor-core rate, or bytes; Q1s's bytes of x. Q1 also beside cuDNN's
    bf16 conv of the same shape, the nearest library call (not the same
    function: PyTorch has no int8 conv on CUDA); no one PyTorch call
    computes Q1s's scale (abs, amax, a division and a floor)."""
    from mobilesuperresolution_tpu_torch.kernels.qconv_int8 import (
        act_scale,
        act_scale_plain,
        k_chunk,
        pack_weights,
        qconv_int8,
        qconv_int8_plain,
        tensor_cores,
    )

    n_pairs = 2 * (T_WIN - 1)
    cases = [("trunk conv0", 1, H_LR, W_LR, 54, 48, 3, True), ("trunk conv", 1, H_LR, W_LR, 48, 48, 3, True)]
    cases += [(f"SpyNet s2d {ci}->{co}", n_pairs, 128, 224, ci, co, 5, True)
              for ci, co in ((32, 128), (128, 256), (256, 128), (128, 64), (64, 8))]
    hs, ws = SR_HR[0] // SR_SCALE, SR_HR[1] // SR_SCALE
    cases += [(f"WDSR-B {name}", 1, hs, ws, ci, co, k, False)
              for name, ci, co, k in (("head", 3, 24, 3), ("expand", 24, 144, 1), ("linear", 144, 20, 1),
                                      ("3x3", 20, 24, 3), ("tail", 24, 12, 3), ("skip", 3, 12, 5))]
    cases += [(f"ResultNet k{k}", 1, hs, ws, c, c, k, False) for c, k in ((18, 3), (16, 5), (15, 7))]
    rows, srows = [], []
    for tag, n, h, w, ci, co, k, serving in cases:
        x32 = (torch.rand((n, h, w, ci), generator=gen) * 6 - 3).to(dev)
        wq = torch.randint(-127, 128, (co, ci, k, k), generator=gen, dtype=torch.int8).to(dev)
        ks = (torch.rand(co, generator=gen) * 1e-2 + 1e-4).to(dev)
        b = (torch.rand(co, generator=gen) - 0.5).to(dev)
        packed = {dt: pack_weights(wq, k_chunk(dt, ci, co, k)) for dt in (torch.float32, torch.bfloat16)}
        edge_w = torch.full_like(wq, -127)
        err = 0.0

        def same(what, got, want):
            nonlocal err
            err = max(err, float((got.float() - want.float()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"Q1 {tag}: {what} differs from its plain version (max {err})")

        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            tall = torch.zeros((n, h + 2, w, ci), dtype=dtype, device=dev)
            tall[:, 1:1 + h] = x
            view = tall[:, 1:1 + h]
            edge = torch.full_like(x, 63.5)  # 127 x 0.5, exact in bf16 too
            edge[..., 1::2] = -63.5
            for xin, name in ((x, "x"), (view, "view"), (edge, "edge")):
                xs = act_scale(xin)
                same(f"{name} {dtype} Q1s", xs, act_scale_plain(xin))
                for bias in (None, b):
                    w_, p_ = (edge_w, None) if name == "edge" else (wq, packed[dtype])
                    same(f"{name} {dtype} bias {bias is not None}", qconv_int8(xin, xs, w_, ks, bias, packed=p_),
                         qconv_int8_plain(xin, xs, w_, ks, bias))
        # timed as the path runs it: serving's convs in bf16 with the bias
        # inside (PlainConv), the SISR nets' in f32 with the bias after (WNConv)
        dtype, bias = (torch.bfloat16, b) if serving else (torch.float32, None)
        x = x32.to(dtype)
        xs = act_scale(x)
        ms = cuda_ms(lambda: qconv_int8(x, xs, wq, ks, bias, packed=packed[dtype]))
        plain_ms = cuda_ms(lambda: qconv_int8_plain(x, xs, wq, ks, bias), iters=3, warmup=1)
        s_ms = cuda_ms(lambda: act_scale(x))
        s_plain_ms = cuda_ms(lambda: act_scale_plain(x), iters=5, warmup=1)
        xb = x32.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb, bb = wq.to(torch.bfloat16), b.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: F.conv2d(xb, wb, bb, padding=k // 2))
        ops = 2.0 * n * h * w * ci * co * k * k
        out_bytes = n * h * w * co * x.element_size()
        bms, by, basis = bound_by_route([(ops, "int8")], nbytes(x, wq, xs, ks, b) + out_bytes)
        s_bms, s_by, _ = bound_by_route([(0.0, "int8")], nbytes(x, xs))
        route_name = f"wgmma s8, {k_chunk(dtype, ci, co, k)}-channel chunks" if tensor_cores(ci, co) else "dp4a"
        label = f"{tag} {n}x{h}x{w} {ci}->{co} k{k} {str(dtype)[6:]}"
        log(f"  Q1 {label} ({route_name}): equal to its plain version (f32/bf16, +/- bias, a view, the ±127 edge); "
            f"ms {ms:.4f} plain {plain_ms:.4f} cuDNN bf16 {lib_ms:.4f} bound {bms:.4f} ({by}; {basis}); "
            f"{ops / ms / 1e9:.1f} TOP/s; Q1s ms {s_ms:.4f} plain {s_plain_ms:.4f} bound {s_bms:.4f} ({s_by})")
        rows.append(dict(case=f"Q1 {label}", route=route_name, main_path=serving, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by, bound_basis=basis,
                         gop=ops / 1e9))
        srows.append(dict(case=f"Q1s {label}", main_path=serving, max_abs_err=0.0, ms=s_ms, plain_ms=s_plain_ms,
                          library_ms=None, bound_ms=s_bms, bound_by=s_by))
    return rows, srows


def read_pngs(d):
    from PIL import Image

    return [np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))]


def psnr_u8(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def phase_quantized_serving(dev, work, frames, float_out, flow_groups):
    """cli.serve --quantize int8 of mobile BasicVSR x4 (nf 24, 8 blocks,
    bf16, the float stream's seeded weights) over the 16 426x240 frames,
    chunk 4, overlap 3, plain and --flow_cache: 16 1080x1920 frames each;
    Q1 200 (SpyNet's 30 and the dual trunks' 17 x 10 steps), B1 0 and B2 1
    per window (flow-cached: Q1 30 per flow group and 170 per window), Q1s
    as many as Q1; the agreement PSNR of each stream's PNGs with the float
    stream's frames; then the quantized window forward's ms and frames/s,
    and the window bit-equal to its twin on Q1s's and Q1's plain versions."""
    import contextlib
    import io

    from PIL import Image

    from mobilesuperresolution_tpu_torch.cli import serve
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    d = os.path.join(work, "qserve_frames")
    os.makedirs(d)
    for i, fr in enumerate(frames):
        Image.fromarray((fr * 255).round().astype(np.uint8)).save(os.path.join(d, f"{i:04d}.png"))
    ref = [(np.clip(f, 0, 1) * 255).round() for f in float_out]
    windows = len(range(0, N_STREAM_FRAMES, CHUNK)) + 1  # and the warm-up window
    q1_sr, q1_flow = 17 * T_WIN, B1_PER_WINDOW
    out, total = {}, {}
    for name, extra, want_q1 in (("plain", [], (q1_flow + q1_sr) * windows),
                                 ("flow_cache", ["--flow_cache"], q1_flow * (flow_groups + 1) + q1_sr * windows)):
        job = os.path.join(work, f"qserve_{name}")
        argv = ["--job_dir", job, "--input_dir", d, "--bf16", "--chunk_frames", str(CHUNK), "--chunk_overlap",
                str(OVERLAP), "--height", str(OH), "--width", str(OW), "--quantize", "int8", *extra]
        reset_q1_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = run_cli(serve.main, argv)
        launches = q1_counts()
        check_q1s(launches, f"quantized serve {name}")
        got = read_pngs(os.path.join(job, "serve"))
        agreement = psnr_u8(np.stack(got), np.stack(ref))
        log(f"  cli.serve --quantize int8 {name}: {stats['frames']} frames of {got[0].shape}, "
            f"{stats['fps_end_to_end']} frames/s end to end (PNG writes included), agreement with the float stream "
            f"{agreement:.2f} dB, launches {launches}")
        if len(got) != N_STREAM_FRAMES or got[0].shape != (OH, OW, 3) or not agreement > 25.0:
            raise AssertionError(f"quantized serve {name}: {len(got)} frames of {got[0].shape}, agreement {agreement}")
        if (launches["Q1"], launches["B1"], launches["B2"]) != (want_q1, 0, B2_PER_WINDOW * windows):
            raise AssertionError(f"quantized serve {name}: launches {launches}, want Q1 {want_q1}, B1 0, "
                                 f"B2 {windows}")
        out[name] = dict(stats, agreement_db=agreement, launches=launches)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}

    model = get_vsr_model("basic", scale=4, compute_dtype=torch.bfloat16, device=dev, quantized=True)
    load_params_npz(model, random_jax_params(model, seed=0))
    x = torch.from_numpy(np.stack(frames[:T_WIN])[None]).to(dev)
    reset_q1_counts()
    with torch.inference_mode():
        y = model(x, OH, OW)
        torch.cuda.synchronize()
        per_window = q1_counts()
        win_ms = cuda_ms(lambda: model(x, OH, OW), iters=5, warmup=1)
        twin = plain_q1_twin(lambda: model(x, OH, OW))
    check_q1s(per_window, "quantized window")
    if per_window["Q1"] != q1_flow + q1_sr or per_window["B1"] != 0 or per_window["B2"] != 1 \
            or not torch.isfinite(y).all():
        raise AssertionError(f"quantized window: launches {per_window}, finite {bool(torch.isfinite(y).all())}")
    log(f"  quantized window forward {win_ms:.3f} ms = {T_WIN / win_ms * 1e3:.2f} frames/s; per window {per_window}; "
        f"bit-equal to its twin on Q1's and Q1s's plain versions: {torch.equal(twin, y)}")
    if not torch.equal(twin, y):
        raise AssertionError(f"quantized window: {int((twin != y).sum())} values differ from the plain-Q1 twin's, "
                             f"max {float((twin.float() - y.float()).abs().max())}")
    out["window"] = dict(ms=win_ms, fps=T_WIN / win_ms * 1e3, launches=per_window, plain_twin_equal=True)
    total = {k: total.get(k, 0) + v for k, v in per_window.items()}
    return out, total


def plain_q1_twin(fn):
    """fn() with ops.quant's Q1s and Q1 replaced by their plain versions (on
    the card's tensors): a test seam of this script, not a path of the
    program; the kernels' counts do not move."""
    from mobilesuperresolution_tpu_torch.kernels import qconv_int8 as q1
    from mobilesuperresolution_tpu_torch.ops import quant

    def plain(x, xs, wq, ks, bias=None, packed=None):
        return q1.qconv_int8_plain(x, q1.act_scale_plain(x) if xs is None else xs, wq, ks, bias)

    kernel, quant.qconv_int8 = quant.qconv_int8, plain
    try:
        before = q1.act_scale.launches, q1.qconv_int8.launches
        out = fn()
        if (q1.act_scale.launches, q1.qconv_int8.launches) != before:
            raise AssertionError("plain twin: a Q1 kernel was launched")
        return out
    finally:
        quant.qconv_int8 = kernel


def write_block_index(path, idx):
    with open(path, "w") as f:
        f.write(f"{([], [list(b) for b in idx])}\n")
    return path


def phase_quantized_eval(dev, work, mv_root):
    """The int8 models' evaluation: the shipped wdsr_b_x2 and result_net_x2
    quantized on their held-out set (PSNR and its delta from the float
    report) and through cli.pretrain / cli.retrain_searched --eval_only
    --quantize int8 beside the float runs (B3 = B4 = 0, Q1 per image: WDSR-B
    51, the searched net 11); cli.test_vsr --quantize int8 for 'basic',
    'single', 'multi' and 'basic_mv' at their launchers' width on seeded
    weights (Q1 per forward 200, 18, 34, 170; B1 0), each model's first
    output on the card held to the same model's on the CPU, and a tiny
    'basic_origin' the same way. Tolerance card vs CPU: 2e-2 of the largest
    output, mean 1e-3 (float32 convs in other orders upstream flip an
    occasional round-half activation, a one-step change that later layers
    carry)."""
    import contextlib
    import io

    from mobilesuperresolution_tpu_torch.cli import pretrain, retrain_searched, test_vsr
    from mobilesuperresolution_tpu_torch.core import modes
    from mobilesuperresolution_tpu_torch.data import get_dataset_module
    from mobilesuperresolution_tpu_torch.models import BasicModel, BasicVSROrigin, ResultNet, get_vsr_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params
    from mobilesuperresolution_tpu_torch.train.evaluate import evaluate

    out, total = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    per_image = {}
    for run, want in SHIPPED_PSNR.items():
        d = os.path.join(ROOT, "artifacts", "convergence", run)
        with open(os.path.join(d, "report.json")) as f:
            cfg = json.load(f)["config"]
        if run == "wdsr_b_x2":
            model = BasicModel(cfg["num_blocks"], cfg["num_residual_units"], cfg["scale"], quantized=True)
            per_image[run] = 1 + 3 * cfg["num_blocks"] + 2
        else:
            model = ResultNet(cfg["scale"], cfg["idx"], quantized=True)
            per_image[run] = 1 + len(cfg["idx"]) + 2
        model.to(dev)
        load_params_npz(model, os.path.join(d, "weights", "models.npz"))

        def fwd(lr, oh, ow):
            with torch.inference_mode():
                return model(lr)

        reset_q1_counts()
        res = evaluate(fwd, held_out_batches(), scale=cfg["scale"], device=dev).as_dict()
        launches = q1_counts()
        check_q1s(launches, f"{run} int8")
        add(launches)
        log(f"  {run} int8: PSNR {res['PSNR']:.4f} (float report {want}, delta {res['PSNR'] - want:+.4f} dB), "
            f"SSIM {res['SSIM']:.4f}; launches {launches}")
        if (launches["Q1"], launches["B3"], launches["B4"]) != (4 * per_image[run], 0, 0) or \
                not abs(res["PSNR"] - want) <= 1.0:
            raise AssertionError(f"{run} int8: PSNR {res['PSNR']}, launches {launches}")
        out[run] = dict(res, delta_db=res["PSNR"] - want, launches=launches)

    wdsr_npz = os.path.join(ROOT, "artifacts", "convergence", "wdsr_b_x2", "weights", "models.npz")
    wdsr_cfg = shipped_config("wdsr_b_x2")
    result_dir = os.path.join(ROOT, "artifacts", "convergence", "result_net_x2")
    with open(os.path.join(result_dir, "report.json")) as f:
        idx = json.load(f)["config"]["idx"]
    data = ["--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--eval_only"]
    cli_runs = (("pretrain", pretrain.main, ["--num_blocks", str(wdsr_cfg["num_blocks"]), "--num_residual_units",
                                             str(wdsr_cfg["num_residual_units"]), "--eval_model", wdsr_npz],
                 "wdsr_b_x2"),
                ("retrain_searched", retrain_searched.main,
                 ["--block_index", write_block_index(os.path.join(work, "result_net_x2.txt"), idx),
                  "--eval_model", os.path.join(result_dir, "weights", "models.npz")], "result_net_x2"))
    for name, main, extra, run in cli_runs:
        res = {}
        for q in ("none", "int8"):
            reset_q1_counts()
            res[q] = run_cli(main, ["--job_dir", os.path.join(work, f"q_{name}_{q}"), *data, *extra, "--quantize",
                                    q])["synthetic_isr"]
            launches = q1_counts()
            if q == "int8":
                check_q1s(launches, f"cli.{name} --quantize int8")
                add(launches)
                if (launches["Q1"], launches["B3"], launches["B4"]) != (8 * per_image[run], 0, 0):
                    raise AssertionError(f"cli.{name} --quantize int8: launches {launches}")
        log(f"  cli.{name} --eval_only on synthetic_isr: PSNR float {res['none']['PSNR']:.4f}, int8 "
            f"{res['int8']['PSNR']:.4f} (delta {res['int8']['PSNR'] - res['none']['PSNR']:+.4f} dB)")
        if not all(np.isfinite(v) for v in res["int8"].values()):
            raise AssertionError(f"cli.{name} int8: non-finite metrics {res['int8']}")
        out[f"cli_{name}"] = res

    vsr_data = ["--dataset", "synthetic_vsr", "--eval_datasets", "synthetic_vsr", "--synthetic_clips", "1",
                "--synthetic_frames", str(VSR_T), "--synthetic_size", "256"]
    per_forward = {"basic": B1_PER_WINDOW + 17 * VSR_T, "single": 1 + 2 * 8 + 1, "multi": B1_PER_WINDOW + 4,
                   "basic_mv": 17 * VSR_T}
    for kind, want_q1 in per_forward.items():
        job = os.path.join(work, f"q_test_vsr_{kind}")
        if kind == "basic_mv":
            argv = vsr_argv(job, kind, mv_root)
        else:
            argv = ["--job_dir", job, *vsr_data, *model_argv(kind), "--scale", str(VSR_SCALE), "--image_batch",
                    str(VSR_T)]
        reset_q1_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            res = run_cli(test_vsr.main, argv + ["--quantize", "int8"])[argv[argv.index("--eval_datasets") + 1]]
        launches = q1_counts()
        check_q1s(launches, f"cli.test_vsr {kind} --quantize int8")
        add(launches)
        params = argparse.Namespace(scale=VSR_SCALE, data_dir=mv_root, image_batch=VSR_T, val_image_batch=VSR_T,
                                    seed=0, synthetic_clips=1, synthetic_frames=VSR_T, synthetic_size="256")
        ds = get_dataset_module("reds_with_mv" if kind == "basic_mv" else "synthetic_vsr").get_dataset(modes.EVAL,
                                                                                                      params)
        clips = len(ds)
        want_b2 = 0 if kind == "multi" else 1
        if (launches["Q1"], launches["B1"], launches["B2"]) != (want_q1 * clips, 0, want_b2 * clips) or \
                not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"cli.test_vsr {kind} int8: {res}, launches {launches} for {clips} clips")
        lr = torch.from_numpy(np.asarray(ds[0][1])[None, :, :64, :64])
        outs = []
        for d in ("cpu", dev):
            m = get_vsr_model(kind, scale=VSR_SCALE, device=d, quantized=True,
                              block_index_path=ZOO_ARTIFACT if kind == "multi" else None)
            load_params_npz(m, random_jax_params(m, 0))
            oh, ow = VSR_SCALE * lr.shape[2], VSR_SCALE * lr.shape[3]
            with torch.inference_mode():
                outs.append(m(lr.to(d), oh, ow).float().cpu())
        err, mean = float((outs[1] - outs[0]).abs().max()), float((outs[1] - outs[0]).abs().mean())
        top = float(outs[0].abs().max())
        log(f"  cli.test_vsr {kind} --quantize int8: PSNR {res['PSNR']:.4f} over {clips} clip(s), launches "
            f"{launches}; first output card vs CPU max {err:.3e} mean {mean:.3e} (tol {2e-2 * top:.3e}, "
            f"{1e-3 * top:.3e})")
        if not (err <= 2e-2 * top and mean <= 1e-3 * top):
            raise AssertionError(f"{kind} int8 card vs CPU: max {err}, mean {mean}, largest output {top}")
        out[f"test_vsr_{kind}"] = dict(res, launches=launches, card_vs_cpu_max=err, card_vs_cpu_mean=mean)

    x = torch.from_numpy(np.random.default_rng(7).random((1, 3, 32, 32, 3), dtype=np.float32))
    outs = []
    for d in ("cpu", dev):
        m = BasicVSROrigin(num_feat=8, num_block=1, quantized=True).to(d)
        load_params_npz(m, random_jax_params(m, 7))
        with torch.inference_mode():
            outs.append(m(x.to(d), 128, 128).float().cpu())
    err, top = float((outs[1] - outs[0]).abs().max()), float(outs[0].abs().max())
    log(f"  tiny basic_origin int8 card vs CPU: max {err:.3e} (tol {2e-2 * top:.3e})")
    if not err <= 2e-2 * top:
        raise AssertionError(f"tiny basic_origin int8 card vs CPU {err}")
    out["tiny_basic_origin_err"] = err
    return out, total


def phase_export(dev, work):
    """cli.export of the searched net ('result', 360x540) and of mobile
    BasicVSR ('basic', 10 frames of 360x540, x4), each checked on the card
    by the CLI against the port's kernel forward (B4 1; B1 25 and B2 1: the
    coarsest SpyNet level, 12x17, runs direct); then the export seconds, and
    the artifact's ms and the port's ms on the card (the CLI's --time_iters
    3, after a warm-up call)."""
    import contextlib
    import io

    from mobilesuperresolution_tpu_torch.cli import export as export_cli

    out, total = {}, {}
    for kind, argv, want in (("result", ["--block_index", ZOO_ARTIFACT, "--scale", "2"], {"B4": 1}),
                             ("basic", ["--model_type", "basic", "--scale", "4"], {"B1": 25, "B2": 1})):
        argv = argv + ["--out", os.path.join(work, f"export_{kind}"), "--time_iters", "3"]
        reset_q1_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            res = export_cli.main(argv)
        launches = q1_counts()  # the check's forward, its warm-up and 3 timed calls
        if any(launches[k] != 5 * want.get(k, 0) for k in ("B1", "B2", "B4")):
            raise AssertionError(f"export {kind}: the check's launches {launches}, want 5 x {want}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        art_ms, port_ms = res["check"]["artifact_ms"], res["check"]["port_ms"]
        size = os.path.getsize(res["paths"]["pt2"]) / 1e6
        log(f"  cli.export {kind}: exported in {res['export_s']:.1f} s ({size:.1f} MB), artifact vs kernel forward on "
            f"the card max {res['check']['max_abs_err']:.3e} (tol {res['check']['tol']:.3e}); artifact {art_ms:.3f} "
            f"ms, port {port_ms:.3f} ms; the check's launches {launches}")
        out[kind] = dict(res["check"], export_s=res["export_s"], mb=size, launches=launches)
    return out, total


def shipped_config(run):
    with open(os.path.join(ROOT, "artifacts", "convergence", run, "report.json")) as f:
        return json.load(f)["config"]


def phase_tiled_eval(work):
    """cli.pretrain --eval_only --eval_tile 128 on the shipped wdsr_b_x2 over
    synthetic_isr at 512x512 (256x256 LR: 3 x 3 tiles of 128, 9 per image;
    radius 1 + blocks + 1 + 2) against the whole-image run: metrics within
    1e-3 dB (cuDNN's head conv may sum in another order per input shape; B3
    and B4 compute each pixel alike at any shape), B3 once per block and B4
    once per tile."""
    from mobilesuperresolution_tpu_torch.cli import pretrain

    npz = os.path.join(ROOT, "artifacts", "convergence", "wdsr_b_x2", "weights", "models.npz")
    cfg = shipped_config("wdsr_b_x2")
    argv = ["--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--synthetic_size", "512",
            "--eval_only", "--num_blocks", str(cfg["num_blocks"]), "--num_residual_units",
            str(cfg["num_residual_units"]), "--eval_model", npz]
    res, launches = {}, {}
    for name, extra in (("whole", []), ("tiled", ["--eval_tile", "128"])):
        reset_sisr_launches()
        t0 = time.perf_counter()
        res[name] = run_cli(pretrain.main, ["--job_dir", os.path.join(work, f"tile_{name}"), *argv, *extra])[
            "synthetic_isr"]
        torch.cuda.synchronize()
        launches[name] = dict(sisr_launches(), wall_s=time.perf_counter() - t0)
    tiles = 8 * 9
    d = {k: res["tiled"][k] - res["whole"][k] for k in res["whole"]}
    log(f"  --eval_tile 128: PSNR {res['tiled']['PSNR']:.6f} vs whole {res['whole']['PSNR']:.6f} (diff "
        f"{d['PSNR']:+.2e} dB, SSIM {d['SSIM']:+.2e}), tiles of (128, 128), 9 per 256x256 image; launches "
        f"{launches}")
    if (launches["tiled"]["B3"], launches["tiled"]["B4"]) != (cfg["num_blocks"] * tiles, tiles) or \
            not abs(d["PSNR"]) <= 1e-3:
        raise AssertionError(f"tiled eval: {res}, launches {launches}")
    return dict(res, diff=d, launches=launches, tile_shape=[128, 128], tiles_per_image=9), \
        {"B3": launches["tiled"]["B3"], "B4": launches["tiled"]["B4"]}


def phase_ladder():
    """analysis.approx_ladder --config tiny on the card: the table, and the
    JAX package's properties (tests/test_approx_ladder.py): agreement with
    the exact output rises with chunk overlap 0 < 2 < 4, flow_downscale 2
    beats 4, every flow / chunk delta within 3 dB, int8 agreement above 25
    dB with its delta within 3 dB. The overlap's rise is read on the frames
    whose windows hold no replicate-padded context (all frames at overlap
    0): a one-clip photometric SpyNet gives identical frames a non-zero
    flow, so the padded clip-edge windows may move the other way (the JAX
    package's note); the whole-clip order is logged beside it."""
    import contextlib
    import io

    from mobilesuperresolution_tpu_torch.analysis import approx_ladder

    reset_q1_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = approx_ladder.main(["--config", "tiny"])
    wall = time.perf_counter() - t0
    launches = q1_counts()
    check_q1s(launches, "ladder")
    for line in buf.getvalue().splitlines():
        log(f"  {line}")
    ags = [res["chunk_overlap"][ov].get("interior_agreement", res["chunk_overlap"][ov]["agreement"])
           for ov in (0, 2, 4)]
    whole = [res["chunk_overlap"][ov]["agreement"] for ov in (0, 2, 4)]
    a2, a4 = res["flow_downscale"][2]["agreement"], res["flow_downscale"][4]["agreement"]
    q = res["quantize_int8"]
    deltas = [r["delta"] for g in ("flow_downscale", "chunk_overlap") for r in res[g].values()]
    log(f"  ladder {wall:.1f} s, launches {launches}; agreement at overlap 0/2/4: interior {ags}, whole clip "
        f"{whole} (rising: {whole[0] < whole[1] < whole[2]})")
    if not (ags[0] < ags[1] < ags[2] and np.isfinite(ags[0]) and a2 > a4 and np.isfinite(a4)
            and all(abs(v) < 3.0 for v in deltas) and np.isfinite(q["agreement"]) and q["agreement"] > 25.0
            and abs(q["delta"]) < 3.0 and launches["Q1"] > 0):
        raise AssertionError(f"ladder properties: overlap {ags}, downscale {a2} {a4}, int8 {q}, deltas {deltas}")
    return dict(res=json.loads(json.dumps(res, default=str)), wall_s=wall, launches=launches), launches


def peak_gib_of(fn):
    """fn()'s result and the peak device memory (GiB) while it ran."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def staged_peak_gib(model, fn):
    """fn()'s peak device memory (GiB), and the peak reached before the VSR
    model's reconstruction began (SpyNet and the propagation)."""
    seen, orig = {}, model._reconstruct

    def reconstruct(*a, **kw):
        torch.cuda.synchronize()
        seen["pre"] = torch.cuda.max_memory_allocated() / 2**30
        return orig(*a, **kw)

    model._reconstruct = reconstruct
    try:
        _, peak = peak_gib_of(fn)
    finally:
        del model._reconstruct
    return peak, seen["pre"]


def phase_sharded_sisr(dev, lrs):
    """Full-width WDSR-B x2 (16 blocks, 24 units: radius 18) on phase 8's two
    678x1020 images through parallel/halo.py's spatially_sharded_apply at S =
    2 and 3 (678 = 2·3·113), f32 and bf16: within f32_tol / bf16_tol of the
    full-frame forward, 16 B3 + 1 B4 per window; ms and peak memory beside
    the full frame's."""
    from mobilesuperresolution_tpu_torch.models import get_model
    from mobilesuperresolution_tpu_torch.parallel.halo import receptive_radius_wdsr, spatially_sharded_apply
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    radius = receptive_radius_wdsr(SR_BLOCKS)
    stats, total = {"radius": radius}, {"B3": 0, "B4": 0}
    for name, bf16 in (("f32", False), ("bf16", True)):
        params = argparse.Namespace(model_type="BASIC_MODEL", num_blocks=SR_BLOCKS,
                                    num_residual_units=SR_UNITS, scale=SR_SCALE, bf16=bf16)
        model = get_model(params, device=dev)
        load_params_npz(model, random_jax_params(model, seed=0))
        tol = bf16_tol if bf16 else f32_tol
        with torch.inference_mode():
            wants = [model(x) for x in lrs]
            _, peak = peak_gib_of(lambda: model(lrs[0]))
            st = {"full": dict(ms=cuda_ms(lambda: model(lrs[0]), iters=10, warmup=2), peak_gib=peak)}
            for n in (2, 3):
                mesh = Mesh(n, dev)
                reset_sisr_launches()
                outs = [spatially_sharded_apply(model, x, mesh, radius, scale=SR_SCALE) for x in lrs]
                torch.cuda.synchronize()
                launches = sisr_launches()
                want_l = {"B3": B3_PER_IMAGE * n * SR_IMAGES, "B4": B4_PER_IMAGE * n * SR_IMAGES}
                if launches != want_l:
                    raise AssertionError(f"sharded SISR {name} S={n}: launches {launches}, want {want_l}")
                total = {k: total[k] + launches[k] for k in total}
                err = max(check(f"WDSR-B {name} S={n} image {i} vs full frame", o, w, tol(w))
                          for i, (o, w) in enumerate(zip(outs, wants)))
                _, peak = peak_gib_of(lambda: spatially_sharded_apply(model, lrs[0], mesh, radius, scale=SR_SCALE))
                ms = cuda_ms(lambda: spatially_sharded_apply(model, lrs[0], mesh, radius, scale=SR_SCALE), iters=10,
                             warmup=2)
                st[f"S{n}"] = dict(ms=ms, peak_gib=peak, max_abs_err=err, launches=launches)
            del outs, wants
        stats[name] = st
        log(f"  sharded WDSR-B {name}: " + "; ".join(f"{k} {v['ms']:.3f} ms, peak {v['peak_gib']:.3f} GiB"
                                                    for k, v in st.items()))
        del model
    return stats, total


def phase_spatial_pretrain(dev, work):
    """cli.pretrain --spatial_shards 2 for one epoch at the launcher's width
    (x2, 16 blocks, 24 units, batch 16, lr 1e-3, float32) on LR patches of 96
    (48 rows a shard >= 2 x radius 18): first one step of the sharded step
    and of the plain step from the same weights on the same batch, the loss
    within 1e-5 relative and every parameter's gradient (read after the
    step) within 1e-5 of its largest magnitude in the plain step; then
    the CLI epoch (2 steps, 32 B3 + 2 B4 per training forward, 16 + 1 per
    full-frame eval image); then the steady sharded and plain steps at that
    patch with their peak memory."""
    from mobilesuperresolution_tpu_torch.cli import pretrain
    from mobilesuperresolution_tpu_torch.core.device import no_tf32
    from mobilesuperresolution_tpu_torch.models import get_model
    from mobilesuperresolution_tpu_torch.parallel.halo import receptive_radius_wdsr
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.parallel.spatial_train import make_spatial_sisr_step
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, load_params_npz
    from mobilesuperresolution_tpu_torch.train.checkpoint import random_jax_params
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    n, patch, radius = 2, 2 * TRAIN_PATCH, receptive_radius_wdsr(SR_BLOCKS)
    mesh = Mesh(n, dev)

    def sharded(m, opt):
        return make_spatial_sisr_step(m, opt, mesh, radius, SR_SCALE)

    params = argparse.Namespace(model_type="BASIC_MODEL", num_blocks=SR_BLOCKS, num_residual_units=SR_UNITS,
                                scale=SR_SCALE, bf16=False)
    init = random_jax_params(get_model(params, device=dev), seed=0)
    g = torch.Generator().manual_seed(33)
    batch = (torch.rand((TRAIN_BATCH, patch, patch, 3), generator=g).to(dev),
             torch.rand((TRAIN_BATCH, SR_SCALE * patch, SR_SCALE * patch, 3), generator=g).to(dev))
    runs = []
    for make in (make_sisr_step, sharded):
        m = load_params_npz(get_model(params, device=dev), init).train()
        opt = multistep_adam(jax_named_parameters(m), 1e-3, 100, 1)
        with no_tf32():  # as cli.pretrain trains
            loss = float(make(m, opt)(batch)["loss"])
        runs.append((loss, {k: p.grad.clone() for k, p in m.named_parameters()}))
        del m, opt
    loss_err = abs(runs[1][0] - runs[0][0])
    # each gradient's error relative to its largest magnitude in the plain step
    g_err = {k: float((runs[1][1][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
             for k, g in runs[0][1].items()}
    worst = max(g_err, key=g_err.get)
    log(f"  first step sharded vs plain: loss {runs[1][0]:.6f} vs {runs[0][0]:.6f} (err {loss_err:.3e}), "
        f"{len(g_err)} gradients, largest relative err {g_err[worst]:.3e} ({worst})")
    if not (loss_err <= 1e-5 * abs(runs[0][0]) and g_err[worst] <= 1e-5):
        raise AssertionError(f"sharded first step: loss err {loss_err}, gradient {worst} relative err {g_err[worst]}")
    del runs

    job = os.path.join(work, "spatial_pretrain")
    argv = sisr_train_argv(job) + ["--num_blocks", str(SR_BLOCKS), "--num_residual_units", str(SR_UNITS),
                                   "--spatial_shards", str(n), "--synthetic_size", "256"]
    argv[argv.index("--lr_patch_size") + 1] = str(patch)
    argv[argv.index("--num_patches") + 1] = "4"  # 8 images x 4 patches / batch 16 = 2 steps
    reset_sisr_launches()
    t0 = time.perf_counter()
    out = run_cli(pretrain.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sisr_launches()
    steps = out["steps"]
    want_l = {"B3": SR_BLOCKS * (n * out["train_forwards"] + out["eval_images"]),
              "B4": n * out["train_forwards"] + out["eval_images"]}
    log(f"  cli.pretrain --spatial_shards {n}: {len(steps)} steps, losses {[round(s['loss'], 5) for s in steps]}, "
        f"{out['eval_images']} eval images, {wall:.1f} s; launches {launches}")
    if len(steps) != 2 or not all(np.isfinite(s["loss"]) and s["skipped"] == 0 for s in steps) or launches != want_l:
        raise AssertionError(f"spatial pretrain: steps {steps}, launches {launches}, want {want_l}")
    stats = dict(first_step_loss_err=loss_err, first_step_grad_rel_err=g_err[worst], steps=steps,
                 wall_s=wall, launches=launches)
    for name, make in (("plain", None), ("sharded", sharded)):
        m = load_params_npz(get_model(params, device=dev), init)
        ms, per_step, peak = steady_step_ms(m, dev, patch=patch, make_step=make)
        stats[f"step_{name}"] = dict(ms=ms, launches_per_step=per_step, peak_gib=peak)
        log(f"  pretrain step {name} (batch {TRAIN_BATCH}, {patch}x{patch}): {ms:.3f} ms, launches per step "
            f"{per_step}, peak {peak:.3f} GiB")
        del m
    return stats, launches


def phase_sharded_vsr(dev, frames):
    """Full-width mobile BasicVSR (nf 24, 8 blocks, bf16: rt 17, R 25 at
    max_disp 8) on serving's 10-frame 426x240 window through
    parallel/vsr_spatial.py at S = 2 and 4, and basic_origin (nf 64, 30
    blocks: rt 61, R 69) at S = 2: within bf16_tol of the plain window, B1 30
    and B2 1 (basic_origin 2) per forward; ms and peak memory beside the
    plain window's, each peak also as reached before the reconstruction;
    the flows' largest |dy| (the clip acts above 8)."""
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.models.basicvsr import compute_flows
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.parallel.vsr_spatial import spatial_basicvsr_forward
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    x = torch.from_numpy(np.stack(frames[:T_WIN])[None]).to(dev)
    stats, total = {}, dict.fromkeys(vsr_launches(), 0)
    for kind, shards, b2 in (("basic", (2, 4), 1), ("basic_origin", (2,), 2)):
        model = get_vsr_model(kind, scale=4, compute_dtype=torch.bfloat16, device=dev)
        load_params_npz(model, random_jax_params(model, seed=0))
        with torch.inference_mode():
            ff, fb = compute_flows(model.spynet, x.to(torch.bfloat16))
            dy = max(float(ff[..., 1].abs().max()), float(fb[..., 1].abs().max()))
            want = model(x, OH, OW)
            peak, pre = staged_peak_gib(model, lambda: model(x, OH, OW))
            st = {"max_abs_dy": dy, "plain": dict(ms=cuda_ms(lambda: model(x, OH, OW), iters=5, warmup=1),
                                                  peak_gib=peak, peak_before_recon_gib=pre)}
            for n in shards:
                mesh = Mesh(n, dev)

                def fwd():
                    return spatial_basicvsr_forward(model, x, OH, OW, mesh, max_disp=8)

                reset_vsr_launches()
                got = fwd()
                torch.cuda.synchronize()
                launches = vsr_launches()
                if routes(launches) != {"B1": B1_PER_WINDOW, "B2": b2, "B4": 0}:
                    raise AssertionError(f"sharded {kind} S={n}: launches {launches}")
                total = {k: total[k] + launches[k] for k in total}
                err = check(f"{kind} bf16 window S={n} vs plain", got, want, bf16_tol(want))
                del got
                peak, pre = staged_peak_gib(model, fwd)
                st[f"S{n}"] = dict(ms=cuda_ms(fwd, iters=5, warmup=1), peak_gib=peak, peak_before_recon_gib=pre,
                                   max_abs_err=err, launches=launches)
            del want
        stats[kind] = st
        log(f"  sharded {kind} window (flows' largest |dy| {dy:.3f}): " + "; ".join(
            f"{k} {v['ms']:.3f} ms, peak {v['peak_gib']:.3f} GiB ({v['peak_before_recon_gib']:.3f} before the "
            "reconstruction)" for k, v in st.items() if k != "max_abs_dy"))
        del model
    return stats, total


def phase_sharded_serve(work, float_out, cached_out):
    """cli.serve --spatial_shards 2 over phase 5's 16 frames (the PNGs
    phase 26 wrote), plain and --flow_cache, bf16, chunk 4, overlap 3: each
    stream's PNGs within bf16_tol (+ one 8-bit level) of phase 5's / 5b's
    float streams; B1 30 per window (cached: per flow group) and B2 1 per
    window."""
    import contextlib
    import io

    from mobilesuperresolution_tpu_torch.cli import serve

    d = os.path.join(work, "qserve_frames")
    out, total = {}, dict.fromkeys(vsr_launches(), 0)
    windows = len(range(0, N_STREAM_FRAMES, CHUNK)) + 1  # and the warm-up window
    for name, extra, ref in (("plain", [], float_out), ("flow_cache", ["--flow_cache"], cached_out)):
        job = os.path.join(work, f"sserve_{name}")
        argv = ["--job_dir", job, "--input_dir", d, "--bf16", "--chunk_frames", str(CHUNK), "--chunk_overlap",
                str(OVERLAP), "--height", str(OH), "--width", str(OW), "--spatial_shards", "2", *extra]
        reset_vsr_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = run_cli(serve.main, argv)
        launches = vsr_launches()
        got = np.stack(read_pngs(os.path.join(job, "serve"))).astype(np.float32)
        want = np.stack([(np.clip(f, 0, 1) * 255).round() for f in ref])
        err = float(np.abs(got - want).max())
        tol = 255 * 2.0 ** -6 * float(np.abs(np.stack(ref)).max()) + 1
        log(f"  cli.serve --spatial_shards 2 {name}: {stats['frames']} frames, {stats['fps_end_to_end']} frames/s end "
            f"to end (PNG writes included), max err {err:.1f} levels (tol {tol:.1f}), launches {launches}")
        if got.shape != (N_STREAM_FRAMES, OH, OW, 3) or not err <= tol:
            raise AssertionError(f"sharded serve {name}: {got.shape}, err {err} > {tol}")
        if launches["B2"] != B2_PER_WINDOW * windows or launches["B1"] % B1_PER_WINDOW or not launches["B1"]:
            raise AssertionError(f"sharded serve {name}: launches {launches} for {windows} windows")
        out[name] = dict(stats, max_err_levels=err, launches=launches)
        total = {k: total[k] + launches[k] for k in total}
    return out, total


def phase_spatial_vsr_train(dev, work, ref_steps):
    """cli.train_vsr --spatial_shards 2 for one epoch at
    launchers/video_train_basic.sh's width (64x64 LR patches: 32 rows a shard
    >= R 25) on phase 11's data, with its height-sharded eval (128 rows, 64
    a shard): finite losses, the first step's loss within 1e-5 relative of
    phase 11's (the same weights and batch), B1 30 and B2 1 per forward; then
    cli.test_vsr with and without --spatial_shards 2 on its npz: PSNR within
    1e-3 dB."""
    from mobilesuperresolution_tpu_torch.cli import test_vsr, train_vsr

    job = os.path.join(work, "spatial_vsr")
    argv = vsr_train_argv(job) + ["--spatial_shards", "2"]
    argv[argv.index("--epochs") + 1] = "1"
    reset_vsr_launches()
    t0 = time.perf_counter()
    out = run_cli(train_vsr.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vsr_launches()
    steps = out["steps"]
    forwards = out["train_forwards"] + out["eval_clips"]
    log(f"  cli.train_vsr --spatial_shards 2: {len(steps)} steps, losses {[round(s['loss'], 6) for s in steps]} "
        f"(unsharded first {ref_steps[0]['loss']:.6f}), eval PSNR {out['eval'][-1]['synthetic_vsr']['PSNR']:.4f}, "
        f"{wall:.1f} s; launches {launches}")
    if len(steps) != VSR_STEPS_PER_EPOCH or not all(np.isfinite(s["loss"]) and s["skipped"] == 0 for s in steps):
        raise AssertionError(f"spatial train_vsr steps {steps}")
    if not abs(steps[0]["loss"] - ref_steps[0]["loss"]) <= 1e-5 * abs(ref_steps[0]["loss"]):
        raise AssertionError(f"spatial train_vsr first loss {steps[0]['loss']} vs {ref_steps[0]['loss']}")
    if routes(launches) != {"B1": B1_PER_WINDOW * forwards, "B2": B2_PER_WINDOW * forwards, "B4": 0}:
        raise AssertionError(f"spatial train_vsr launches {launches} for {forwards} forwards")
    total = dict(launches)
    npz = os.path.join(job, "weights", "models.npz")
    ev = {}
    for name, extra in (("plain", []), ("sharded", ["--spatial_shards", "2"])):
        reset_vsr_launches()
        res = run_cli(test_vsr.main, vsr_argv(os.path.join(job, f"eval_{name}")) + ["--eval_model", npz] + extra)
        torch.cuda.synchronize()
        ev[name] = dict(res["synthetic_vsr"], launches=vsr_launches())
        total = {k: total[k] + ev[name]["launches"][k] for k in total}
    diff = abs(ev["sharded"]["PSNR"] - ev["plain"]["PSNR"])
    log(f"  cli.test_vsr on its npz: sharded PSNR {ev['sharded']['PSNR']:.5f}, plain {ev['plain']['PSNR']:.5f} "
        f"(diff {diff:.2e} dB)")
    if not diff <= 1e-3:
        raise AssertionError(f"sharded test_vsr PSNR {ev['sharded']['PSNR']} vs {ev['plain']['PSNR']}")
    return dict(steps=steps, eval=out["eval"], wall_s=wall, launches=launches, test_vsr=ev), total


def phase_distributed(work):
    """--distributed on the card: cli.pretrain (the launcher's width, 2
    steps + 8 eval images) and cli.train_vsr (video_train_basic.sh's width,
    one epoch of 2 steps + 4 eval clips) each run once plainly and once as
    rank 0 of a one-rank NCCL group (RANK=0 WORLD_SIZE=1 LOCAL_RANK=0, a free
    MASTER_PORT): every step's loss within 1e-5 relative of the plain run's,
    the weights within the Adam drift bound of the plain run's (one rank runs
    no collective; this bound only says how far two Adam runs can part), and
    the chief's files (result.log, metrics.jsonl, the npz, one checkpoint
    with run_meta's process count 1) written once. NCCL refuses two ranks on
    one card, so the two-rank mean is proven by
    tests/test_torch_cuda.py::test_two_nccl_ranks_match_one_process on a
    machine with two cards, and on the CPU with gloo
    (tests/test_torch_parallel_multiprocess.py)."""
    import socket

    import torch.distributed as dist

    from mobilesuperresolution_tpu_torch.cli import pretrain, train_vsr
    from mobilesuperresolution_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    runs = {
        "pretrain": (pretrain.main, lambda job: sisr_train_argv(job) + [
            "--num_blocks", str(SR_BLOCKS), "--num_residual_units", str(SR_UNITS), "--num_patches", "4"],
            (0.9, 0.999)),
        "train_vsr": (train_vsr.main, lambda job: vsr_train_argv(job) + ["--epochs", "1", "--num_patches", "1"],
                      (0.9, 0.99)),
    }
    out, total = {}, {}
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    for name, (main, argv, betas) in runs.items():
        res = {}
        for mode in ("plain", "distributed"):
            job = os.path.join(work, f"dist_{name}_{mode}")
            reset_sisr_launches()
            reset_vsr_launches()
            if mode == "distributed":
                os.environ.update(env)
            try:
                summary = run_cli(main, argv(job) + (["--distributed"] if mode == "distributed" else []))
                if mode == "distributed":
                    res["backend"], res["world"] = dist.get_backend(), distributed.process_count()
            finally:
                if mode == "distributed":
                    distributed.shutdown()
                    for k in env:
                        os.environ.pop(k)
            torch.cuda.synchronize()
            launches = {**sisr_launches(), **vsr_launches()}
            if mode == "distributed":
                total = {k: total.get(k, 0) + v for k, v in launches.items()}
            res[mode] = dict(losses=[s["loss"] for s in summary["steps"]], launches=launches)
            with open(os.path.join(job, "ckpt", "run_meta.json")) as f:
                meta = json.load(f)
            log_text = open(os.path.join(job, "result.log")).read()
            smooth = [json.loads(ln)["tag"] for ln in open(os.path.join(job, "metrics.jsonl"))].count(
                "training_loss_smooth")
            files = sorted(os.listdir(os.path.join(job, "ckpt")))
            if (meta["process_count"], log_text.count("Finish Training"), smooth, files) != (
                    1, 1, 1, ["1.pt", "run_meta.json"]):
                raise AssertionError(f"{name} {mode}: run_meta {meta}, result.log's finish lines "
                                     f"{log_text.count('Finish Training')}, smooth losses {smooth}, ckpt {files}")
        lrs = [VSR_LR if name == "train_vsr" else 1e-3] * len(res["plain"]["losses"])
        err = npz_diff(*(os.path.join(work, f"dist_{name}_{m}", "weights", "models.npz")
                         for m in ("plain", "distributed")))
        tol = adam_drift_tol(lrs, betas)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(res["distributed"]["losses"], res["plain"]["losses"]))
        log(f"  {name} --distributed: backend {res['backend']}, world size {res['world']}, losses "
            f"{[round(v, 6) for v in res['distributed']['losses']]} (plain {[round(v, 6) for v in res['plain']['losses']]}), "
            f"weights max err {err:.3e} (Adam drift bound {tol:.3e}), launches {res['distributed']['launches']}")
        if (res["backend"] != "nccl" or res["world"] != 1 or not err <= tol or not loss_err <= 1e-5
                or len(res["distributed"]["losses"]) != len(res["plain"]["losses"])):
            raise AssertionError(f"{name} --distributed: backend {res['backend']}, world {res['world']}, err {err}, "
                                 f"loss err {loss_err}")
        out[name] = dict(res, weight_err=err, weight_tol=tol, loss_rel_err=loss_err)
    return out, total


def phase_data_axis(work, job):
    """The in-process data axis on phase 11's npz: cli.test_vsr (bf16,
    --chunk_frames 4 --chunk_overlap 2: 3 windows per 10-frame clip) with
    and without --chunk_data_parallel, and cli.test_vsr_by_patch at phase
    17's settings with and without --data_parallel. Each run with the flag
    equals its run without it (one card: a group is one window, a patch
    batch one patch), B1 30 and B2 1 per window or patch batch; the data
    slots and each run's wall seconds. Returns (stats, launches)."""
    from mobilesuperresolution_tpu_torch.cli import test_vsr, test_vsr_by_patch
    from mobilesuperresolution_tpu_torch.parallel.mesh import make_mesh

    npz = os.path.join(job, "weights", "models.npz")
    slots = [str(d) for d in make_mesh(spatial=1, device="cuda").data_devices]
    chunk, overlap = 4, 2
    windows = VSR_CLIPS * len(range(0, VSR_T, chunk))
    out, total, results = {"data_slots": slots}, dict.fromkeys(vsr_launches(), 0), {}
    runs = (("windows", [], windows), ("windows_data_parallel", ["--chunk_data_parallel"], windows),
            ("patches", [], N_PATCHES), ("patches_data_parallel", ["--data_parallel"], N_PATCHES))
    for name, flag, per in runs:
        sub = os.path.join(work, f"data_axis_{name}")
        if name.startswith("windows"):
            main, argv = test_vsr.main, vsr_argv(sub) + ["--eval_model", npz, "--bf16", "--chunk_frames", str(chunk),
                                                         "--chunk_overlap", str(overlap), *flag]
        else:
            main, argv = test_vsr_by_patch.main, patch_argv(sub, npz) + flag
        reset_vsr_launches()
        t0 = time.perf_counter()
        res = run_cli(main, argv)["synthetic_vsr"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = vsr_launches()
        out[name] = dict(wall_s=wall, launches=launches,
                         result=res if isinstance(res, dict) else dict(psnr=float(res[2].mean()), shape=res.shape))
        log(f"  {' '.join(flag) or 'plain'} ({name.split('_')[0]}): {wall:.2f} s, launches {launches}, "
            f"{out[name]['result']}")
        if routes(launches) != {"B1": B1_PER_WINDOW * per, "B2": B2_PER_WINDOW * per, "B4": 0}:
            raise AssertionError(f"{name}: launches {launches} for {per} windows or patch batches")
        results[name] = res
        total = {k: total[k] + launches[k] for k in total}
    if results["windows"] != results["windows_data_parallel"]:
        raise AssertionError(f"--chunk_data_parallel {results['windows_data_parallel']} != the plain windows "
                             f"{results['windows']}")
    if not np.array_equal(results["patches"], results["patches_data_parallel"]):
        raise AssertionError("--data_parallel's patch array differs from the plain run's")
    log(f"  data slots {slots}: each run with the flag equals its run without it")
    return out, total


def phase_native_cores(work):
    """The native data cores on the card machine's host: the committed
    native/libloader.so and native/libimresize.so load (not the numpy path),
    and each binding is bit-equal to the port's numpy path with both timed
    (host ms, mean of 3 after one warm-up): the SISR degrade (a 1356x2040
    DIV2K-sized image to x1/2), YUV420 to RGB of a 1080x1920 frame, and a
    NEMO window of 10 raw 1080x1920 frames."""
    from mobilesuperresolution_tpu_torch.data import native_imresize, native_loader
    from mobilesuperresolution_tpu_torch.data.imresize import imresize_np
    from mobilesuperresolution_tpu_torch.data.yuv import yuv420_to_rgb

    if not (native_loader.native_available() and native_imresize.native_available()):
        raise AssertionError("the committed native libraries did not load here: the numpy path would run")
    rng = np.random.default_rng(39)

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            res = fn()
        return (time.perf_counter() - t0) / 3 * 1e3, res

    img = rng.integers(0, 256, SR_HR + (3,), dtype=np.uint8)
    h, w = 1080, 1920
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8) for _ in range(2))
    d = os.path.join(work, "raw_window")
    os.makedirs(d)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(T_WIN)]
    paths = [os.path.join(d, f"{i:04d}.raw") for i in range(T_WIN)]
    for f, p in zip(frames, paths):
        f.tofile(p)
    cases = {
        "imresize_1356x2040_x0.5": (lambda: native_imresize.imresize_u8(img, scalar_scale=0.5),
                                    lambda: imresize_np(img, scalar_scale=0.5)),
        "yuv420_to_rgb_1080x1920": (lambda: native_loader.yuv420_to_rgb(y, u, v), lambda: yuv420_to_rgb(y, u, v)),
        "raw_window_10x1080x1920": (lambda: native_loader.load_raw_window(paths, (h, w, 3)),
                                    lambda: np.stack([np.fromfile(p, np.uint8).reshape(h, w, 3) for p in paths])),
    }
    out = {}
    for name, (native, numpy_path) in cases.items():
        native_ms, got = host_ms(native)
        numpy_ms, want = host_ms(numpy_path)
        if got is None or got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"native {name} differs from the numpy path")
        out[name] = dict(native_ms=native_ms, numpy_ms=numpy_ms, speedup=numpy_ms / native_ms)
        log(f"  {name}: native {native_ms:.2f} ms, numpy {numpy_ms:.2f} ms (x{numpy_ms / native_ms:.1f}), "
            "bit-equal")
    return out


def phase_predictor_auto(work):
    """cli.search --speed_predictor auto at 4 blocks (the width phase, one
    epoch): it loads this card's packaged predictor
    (nas/speed_tables/<device kind>_predictor.msgpack), B5 12 per forward."""
    from mobilesuperresolution_tpu_torch.cli import search
    from mobilesuperresolution_tpu_torch.kernels.fused_convsep import fused_convsep
    from mobilesuperresolution_tpu_torch.nas.speed_model import packaged_predictor_path

    own = packaged_predictor_path()
    job = os.path.join(work, "search_predictor_auto")
    fused_convsep.launches = 0
    t0 = time.perf_counter()
    out = run_cli(search.main, nas_argv(job, 4) + ["--speed_predictor", "auto"])
    wall = time.perf_counter() - t0
    text = open(os.path.join(job, "result.log")).read()
    speed = float(re.search(r"Supernet Speed: ([\d.]+) ms", text).group(1))
    forwards = out["train_forwards"] + out["eval_images"]
    log(f"  --speed_predictor auto → {own}: supernet speed {speed} ms, {len(out['steps'])} steps, {wall:.1f} s, B5 "
        f"launches {fused_convsep.launches} ({forwards} forwards)")
    if own is None or f"MLP latency predictor from {own}" not in text:
        raise AssertionError(f"--speed_predictor auto resolved to {own!r}")
    if fused_convsep.launches != 3 * 4 * forwards or not all(np.isfinite(s["loss"]) for s in out["steps"]):
        raise AssertionError(f"--speed_predictor auto: launches {fused_convsep.launches}, steps {out['steps']}")
    return dict(predictor=own, supernet_speed_ms=speed, wall_s=wall, launches=fused_convsep.launches), \
        {"B5": fused_convsep.launches}


def phase_sharded_int8_serve(work):
    """cli.serve --quantize int8 --spatial_shards 2 over phase 26's 16
    frames (bf16, chunk 4, overlap 3): each shard's trunk window takes its
    own per-sample int8 scale, so the stream is held to phase 26's unsharded
    int8 stream within the int8 bound (1e-2 of the largest output, + one
    8-bit level), not bit for bit; Q1 30 (SpyNet, whole frames) + 17 per
    trunk call per step, one call per card the shards sit on, B1 0, B2 1 per
    window."""
    import contextlib
    import io

    from mobilesuperresolution_tpu_torch.cli import serve
    from mobilesuperresolution_tpu_torch.parallel.mesh import make_mesh

    d = os.path.join(work, "qserve_frames")
    job = os.path.join(work, "qserve_sharded")
    argv = ["--job_dir", job, "--input_dir", d, "--bf16", "--chunk_frames", str(CHUNK), "--chunk_overlap",
            str(OVERLAP), "--height", str(OH), "--width", str(OW), "--quantize", "int8", "--spatial_shards", "2"]
    windows = len(range(0, N_STREAM_FRAMES, CHUNK)) + 1  # and the warm-up window
    cards = len(set(make_mesh(spatial=2, device="cuda").devices))
    want_q1 = (B1_PER_WINDOW + 17 * T_WIN * cards) * windows
    reset_q1_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = run_cli(serve.main, argv)
    launches = q1_counts()
    check_q1s(launches, "sharded int8 serve")
    got = np.stack(read_pngs(os.path.join(job, "serve"))).astype(np.float32)
    want = np.stack(read_pngs(os.path.join(work, "qserve_plain", "serve"))).astype(np.float32)
    err = float(np.abs(got - want).max())
    tol = 1e-2 * float(want.max()) + 1
    log(f"  cli.serve --quantize int8 --spatial_shards 2: {stats['frames']} frames, {stats['fps_end_to_end']} "
        f"frames/s end to end, max err {err:.1f} levels against the unsharded int8 stream (tol {tol:.2f}), "
        f"agreement {psnr_u8(got, want):.2f} dB, launches {launches}")
    if got.shape != want.shape or not err <= tol:
        raise AssertionError(f"sharded int8 serve: {got.shape} vs {want.shape}, err {err} > {tol}")
    if (launches["Q1"], launches["B1"], launches["B2"]) != (want_q1, 0, B2_PER_WINDOW * windows):
        raise AssertionError(f"sharded int8 serve: launches {launches}, want Q1 {want_q1}, B1 0, B2 {windows}")
    return dict(stats, max_err_levels=err, tol_levels=tol, agreement_db=psnr_u8(got, want), launches=launches), \
        {k: launches[k] for k in ("Q1", "Q1s", "B2")}


def phase_data_groups(dev):
    """Serving's data groups: mobile BasicVSR x4 (bf16, seeded weights)
    serves GROUP_STREAMS lockstep streams of GROUP_FRAMES 426x240 frames at
    S = 2 through cli.serve's stream (``make_stream``), plain and
    flow-cached. With the seam (``Mesh(2, card, slots=4)``: D = 2 groups on
    the one card) group g serves streams 2g and 2g + 1, SpyNet, the sharded
    trunk and the reconstruction on its own; the result must equal one
    group serving each half bit for bit, and one group serving all four
    within bf16_tol: B1 picks its tile from the grid size, which follows
    the batch, so SpyNet's flows at half the batch may round otherwise (one
    bf16 ulp of the output on an H100 80GB HBM3). B1 and B2 per window
    (grouped: each group's 30 and 1; flow-cached B1 per flow group) and
    every run's frames/s end to end (host copies included, the warm-up
    window not). Returns (stats, launches)."""
    from mobilesuperresolution_tpu_torch.cli.serve import make_stream
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    model = get_vsr_model("basic", scale=4, compute_dtype=torch.bfloat16, device=dev)
    load_params_npz(model, random_jax_params(model, seed=0))
    streams = [synthetic_stream(GROUP_FRAMES, H_LR, W_LR, seed=42 + k) for k in range(GROUP_STREAMS)]
    frames = [np.stack([s[i] for s in streams]) for i in range(GROUP_FRAMES)]
    windows = len(range(0, GROUP_FRAMES, CHUNK))
    half = GROUP_STREAMS // 2
    stats = {}
    reset_vsr_launches()
    for name, flow_cache in (("plain", False), ("flow_cache", True)):
        grouped = None
        for label, mesh, sel in (("grouped", Mesh(GROUP_SHARDS, dev, slots=2 * GROUP_SHARDS), slice(None)),
                                 ("one_group", Mesh(GROUP_SHARDS, dev), slice(None)),
                                 ("half0", Mesh(GROUP_SHARDS, dev), slice(0, half)),
                                 ("half1", Mesh(GROUP_SHARDS, dev), slice(half, None))):
            n = len(range(GROUP_STREAMS)[sel])
            stream = make_stream(model, mesh, OH, OW, CHUNK, OVERLAP, n, dev, flow_cache=flow_cache)
            stream.warmup((H_LR, W_LR, 3))
            before = vsr_launches()
            out, wall = run_stream(stream, [f[sel] for f in frames])
            launches = {k: v - before[k] for k, v in vsr_launches().items()}
            got = np.stack(out, 1)
            if got.shape != (n, GROUP_FRAMES, OH, OW, 3) or not np.isfinite(got).all():
                raise AssertionError(f"data groups {name} {label}: shape {got.shape} or non-finite frames")
            row = {"groups": len(mesh.groups), "streams": n, "wall_s": wall, "fps_end_to_end": n * GROUP_FRAMES / wall,
                   "launches": launches, "B1_per_window": launches["B1"] / windows,
                   "B2_per_window": launches["B2"] / windows}
            if grouped is None:
                grouped = got
            else:
                row["max_abs_err_vs_grouped"] = err = float(np.abs(grouped[sel] - got).max())
                row["bit_equal"] = bool(np.array_equal(grouped[sel], got))
                row["tol"] = bf16_tol(torch.from_numpy(got))
            log(f"  {name} {label}: {len(mesh.groups)} group(s), {n} streams, {row['fps_end_to_end']:.2f} frames/s "
                f"end to end, B1 {row['B1_per_window']:.0f} / B2 {row['B2_per_window']:.0f} per window"
                + (f", max |grouped - this| {err}" if label != "grouped" else ""))
            stats[f"{name}_{label}"] = row
            del got, out
        groups_b2 = stats[f"{name}_grouped"]["launches"]["B2"]
        if groups_b2 != 2 * B2_PER_WINDOW * windows or stats[f"{name}_grouped"]["launches"]["B1"] % (
                2 * B1_PER_WINDOW) or not stats[f"{name}_grouped"]["launches"]["B1"]:
            raise AssertionError(f"data groups {name}: grouped launches {stats[f'{name}_grouped']['launches']} for "
                                 f"{windows} windows of 2 groups")
        for label in ("half0", "half1"):
            if not stats[f"{name}_{label}"]["bit_equal"]:
                raise AssertionError(f"data groups {name}: the grouped stream differs from {label} by "
                                     f"{stats[f'{name}_{label}']['max_abs_err_vs_grouped']}")
        whole = stats[f"{name}_one_group"]
        if not whole["max_abs_err_vs_grouped"] <= whole["tol"]:
            raise AssertionError(f"data groups {name}: the grouped stream differs from one group by "
                                 f"{whole['max_abs_err_vs_grouped']} > {whole['tol']}")
        del grouped
    del model
    torch.cuda.empty_cache()
    return stats, vsr_launches()


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
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    marks = []

    def phase(title):
        """Log the next phase's title; keep the wall seconds of the last one."""
        now = time.perf_counter()
        if marks:
            report.setdefault("phase_s", {})[marks[-1][0]] = round(now - marks[-1][1], 3)
        if title is None:
            log("wall s per phase: " + ", ".join(f"{k} {v}" for k, v in report["phase_s"].items()))
            return
        marks.append((title.rstrip(":"), now))
        log(title)

    try:
        from mobilesuperresolution_tpu_torch.kernels import _build

        secs = _build.build()
        log(f"built kernels {_build.SOURCES} in {secs:.1f} s")
        for name in _build.SOURCES:
            for line in ptxas_summary(os.path.join(_build.BUILD_DIR, f"{name}.log")):
                log(f"  {name}: {line}")
        report["build_s"] = secs
        report["q1_sass"] = q1_sass()
        report["tf32_sass"] = tf32_sass()

        phase("kernels vs plain:")
        rows = phase_kernels(torch.Generator().manual_seed(0), dev)
        report["kernel_cases"] = rows
        phase("small-model parity:")
        report["tiny_parity_err"] = phase_small_parity(dev)
        phase("full-width serving:")
        stats, launches, windows, served = phase_serving(dev)
        report["serving"] = stats
        phase("flow-cached serving at full width:")
        report["flow_cache"], launches, q_cached_out = phase_flow_cache(dev, *served)
        q_frames, q_float_out = served[1], served[2]  # for the quantized and the sharded streams
        del served
        phase("small SISR parity:")
        report["tiny_sisr_parity_err"] = phase_sisr_parity(dev)
        phase("shipped SISR weights and the eval entry point:")
        report["shipped"] = phase_shipped(dev)
        phase("full-width SISR:")
        report["sisr"], sisr_main, sisr_images = phase_sisr_full(dev)
        phase("SISR pretraining at full width:")
        report["pretrain"], train_main = phase_pretrain(dev)
        phase("searched-net retraining:")
        report["retrain"] = phase_retrain(dev)
        phase("tiny SISR training steps, card vs CPU:")
        report["train_parity"] = phase_train_parity(dev)
        phase("small NAS supernet parity:")
        report["tiny_nas_parity"] = phase_nas_parity(dev)
        phase("NAS search at full width:")
        report["search"], search_main = phase_search(dev)
        phase("VSR training at full width:")
        report["vsr_train"], vsr_main, vsr_job = phase_vsr_train(dev, work)
        phase("resume round trips:")
        report["vsr_resume"] = phase_vsr_resume(dev, work, vsr_job)
        phase("VSR evaluation entry point:")
        report["vsr_eval"] = phase_vsr_eval(dev, vsr_job, report["vsr_train"]["eval"][-1]["synthetic_vsr"]["PSNR"])
        phase("tiny VSR training steps, card vs CPU, and B2's gradients:")
        report["vsr_train_parity"] = phase_vsr_train_parity(dev)
        phase("tiny 'single', 'multi', 'basic_mv', 'multi_v1' and 'basic_origin', card vs CPU:")
        report["zoo_parity"] = phase_zoo_parity(dev)
        phase("'single' and 'multi' training at full width:")
        report["zoo_train"], zoo_main, zoo_npz = phase_zoo_train(dev, work, ("single", "multi"))
        phase("patch-tiled VSR eval at full width:")
        report["patch_eval"], patch_main = phase_patch_eval(dev, work, os.path.join(vsr_job, "weights", "models.npz"))
        phase("'multi' serving:")
        report["zoo_serve"], serve_main = phase_zoo_serve(dev, work, zoo_npz["multi"])
        phase("the REDS-with-MV tree:")
        mv_root, report["mv_data"] = phase_mv_data(work)
        phase("'basic_mv', 'multi_v1' and 'basic_origin' training at full width:")
        report["zoo_rest_train"], rest_main, _ = phase_zoo_train(dev, work, ("basic_mv", "multi_v1", "basic_origin"),
                                                                 mv_root)
        phase("'basic_origin' serving, plain and flow-cached:")
        report["origin_serve"], origin_main = phase_origin_serve(dev)
        phase("on-card latency table:")
        report["latency_table"], table_main = phase_latency_table(torch.Generator().manual_seed(22), dev)
        phase("the search's latency paths:")
        report["search_latency"], search_latency_main = phase_search_latency(work)
        phase("reference checkpoints:")
        report["reference_checkpoints"], ckpt_main = phase_reference_checkpoints(dev, work, mv_root)
        phase("Q1, the int8 conv, against its plain version:")
        rows["Q1"], rows["Q1s"] = phase_q1_kernels(torch.Generator().manual_seed(26), dev)
        phase("quantized serving at full width:")
        report["quantized_serving"], q_serve_main = phase_quantized_serving(
            dev, work, q_frames, q_float_out, report["flow_cache"]["groups"])
        phase("quantized evaluation:")
        report["quantized_eval"], q_eval_main = phase_quantized_eval(dev, work, mv_root)
        phase("export:")
        report["export"], export_main = phase_export(dev, work)
        phase("tiled SISR eval:")
        report["tiled_eval"], tiled_main = phase_tiled_eval(work)
        phase("the approximation ladder:")
        report["ladder"], ladder_main = phase_ladder()
        phase("logging and profiling:")
        report["logging_profiling"] = phase_logging_profiling(work)
        phase("height-sharded SISR forward:")
        report["sharded_sisr"], p_sisr = phase_sharded_sisr(dev, sisr_images)
        del sisr_images
        phase("cli.pretrain --spatial_shards 2:")
        report["spatial_pretrain"], p_pretrain = phase_spatial_pretrain(dev, work)
        phase("height-sharded VSR forward:")
        report["sharded_vsr"], p_vsr = phase_sharded_vsr(dev, q_frames)
        phase("cli.serve --spatial_shards 2:")
        report["sharded_serve"], p_serve = phase_sharded_serve(work, q_float_out, q_cached_out)
        del q_frames, q_float_out, q_cached_out
        phase("cli.train_vsr / cli.test_vsr --spatial_shards 2:")
        report["spatial_vsr_train"], p_vsr_train = phase_spatial_vsr_train(dev, work, report["vsr_train"]["steps"])
        phase("--distributed on the card:")
        report["distributed"], p_dist = phase_distributed(work)
        phase("the in-process data axis:")
        report["data_axis"], a_data = phase_data_axis(work, vsr_job)
        phase("the native data cores:")
        report["native_cores"] = phase_native_cores(work)
        phase("cli.search --speed_predictor auto:")
        report["predictor_auto"], a_pred = phase_predictor_auto(work)
        phase("cli.serve --quantize int8 --spatial_shards 2:")
        report["sharded_int8_serve"], a_qshard = phase_sharded_int8_serve(work)
        phase("serving's data groups:")
        report["data_groups"], g_groups = phase_data_groups(dev)
        phase(None)
        report["launches_sisr_eval"] = sisr_main
        report["launches_serving"] = launches
        # B1, B2 and B4: the basic VSR training run and the VSR paths after
        # it, each count set to 0 before its path; B4 also from pretraining
        parts = dict(basic_train=vsr_main, zoo_train=zoo_main, patch_eval=patch_main, multi_serve=serve_main,
                     zoo_rest_train=rest_main, origin_serve=origin_main, reference_checkpoints=ckpt_main)
        vsr_paths = {k: sum(p[k] for p in parts.values()) for k in ("B1", "B2", "B4", "B1_f32", "B2_f32")}
        report["launches_vsr_paths"] = parts
        # B5: the search, the latency table and the search's latency paths
        b5_parts = dict(search=search_main, latency_table=table_main, search_latency=search_latency_main)
        report["launches_b5_paths"] = b5_parts
        launches = {"B5": sum(p["B5"] for p in b5_parts.values()), "B3": train_main["B3"] + ckpt_main["B3"],
                    "B1": vsr_paths["B1"], "B2": vsr_paths["B2"], "B4": train_main["B4"] + vsr_paths["B4"],
                    "Q1": 0, "Q1s": 0, "B1_f32": vsr_paths["B1_f32"], "B2_f32": vsr_paths["B2_f32"]}
        # this slice's paths: the int8 stream and evals, the export checks,
        # tiled eval and the ladder, each count set to 0 before its path
        q_parts = dict(quantized_serving=q_serve_main, quantized_eval=q_eval_main, export=export_main,
                       tiled_eval=tiled_main, ladder=ladder_main)
        report["launches_deployment_paths"] = q_parts
        # the parallel layer's paths (phases 32-37), each count set to 0
        # before its path
        p_parts = dict(sharded_sisr=p_sisr, spatial_pretrain=p_pretrain, sharded_vsr=p_vsr, sharded_serve=p_serve,
                       spatial_vsr_train=p_vsr_train, distributed=p_dist)
        report["launches_parallel_paths"] = p_parts
        # the data axis, the predictor and sharded int8 serving (phases
        # 38-41), each count set to 0 before its path
        a_parts = dict(data_axis=a_data, predictor_auto=a_pred, sharded_int8_serve=a_qshard)
        report["launches_queue_a_paths"] = a_parts
        # serving's data groups (phase 42), its counts set to 0 before it
        g_parts = dict(data_groups=g_groups)
        report["launches_data_group_paths"] = g_parts
        for key in launches:
            launches[key] += sum(p.get(key, 0) for parts in (q_parts, p_parts, a_parts, g_parts)
                                 for p in parts.values())
        # B1's and B2's float32 routes: their share of the same paths' counts
        for key in ("B1", "B2"):
            if not 0 <= launches[f"{key}_f32"] <= launches[key]:
                raise AssertionError(f"{key}: {launches[f'{key}_f32']} float32 launches of {launches[key]} in all")
        report["f32_route_launches"] = {key: launches[f"{key}_f32"] for key in ("B1", "B2")}
        log(f"float32 routes' launches on the paths: {report['f32_route_launches']}")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def entry(name, source, replaces, key, routes):
        on_path = [r for r in rows[key] if r["main_path"]]
        return {
            "name": name, "route": "cuda", "routes": routes, "source": source, "replaces": replaces,
            **({"f32_launches": launches[f"{key}_f32"]} if f"{key}_f32" in launches else {}),
            "launches": launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in rows[key]),
            "ms": sum(r["ms"] for r in on_path),
            "plain_ms": sum(r["plain_ms"] for r in on_path),
            "bound_ms": sum(r["bound_ms"] for r in on_path),
            "bound_by": max(on_path, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if any(r["library_ms"] is None for r in on_path) else
            sum(r["library_ms"] for r in on_path),
        }

    # each kernel's routes, by the dtype or shape its host code routes on
    mma = {"bfloat16": "mma.sync m16n8k16 bf16", "float32": "3xTF32 mma.sync m16n8k8"}
    kernels = {"kernels": [
        entry("conv5x5_same", "mobilesuperresolution_tpu_torch/csrc/conv5x5.cu",
              "mobilesuperresolution_tpu/kernels/conv5x5.py:107", "B1",
              {"bfloat16": "wgmma m64nNk16 bf16",
               "float32": "3xTF32: wgmma m64nNk8 on 8-warp tiles (packed weights), else mma.sync m16n8k8 "
                          "(the same bits)"}),
        entry("fused_conv_pixel_shuffle", "mobilesuperresolution_tpu_torch/csrc/fused_tail.cu",
              "mobilesuperresolution_tpu/kernels/fused_tail.py:85", "B2", mma),
        entry("fused_wdsr_block", "mobilesuperresolution_tpu_torch/csrc/fused_wdsr_block.cu",
              "mobilesuperresolution_tpu/kernels/fused_wdsr_block.py:110", "B3", mma),
        entry("fused_conv_pixel_shuffle_skip", "mobilesuperresolution_tpu_torch/csrc/fused_tail.cu",
              "mobilesuperresolution_tpu/kernels/fused_tail.py:85", "B4", mma),
        entry("fused_convsep", "mobilesuperresolution_tpu_torch/csrc/fused_convsep.cu",
              "mobilesuperresolution_tpu/kernels/fused_convsep.py:68", "B5",
              {k: f"depthwise on the CUDA cores, 1x1 on {v}" for k, v in mma.items()}),
        # not TPU kernels: the XLA int8 conv of the JAX package's qconv2d and
        # its per-sample activation scale
        entry("qconv_int8", "mobilesuperresolution_tpu_torch/csrc/qconv_int8.cu",
              "mobilesuperresolution_tpu/ops/quant.py:86", "Q1",
              {"Cin >= 16 and Cout >= 8": "wgmma m64nNk32 s8", "else": "__dp4a"}),
        entry("act_scale", "mobilesuperresolution_tpu_torch/csrc/qconv_int8.cu",
              "mobilesuperresolution_tpu/ops/quant.py:84", "Q1s", {"any": "CUDA cores, atomicMax"}),
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
