// Kernel B1: 5x5 SAME convolution, NHWC, + bias, optional ReLU.
//
// Replaces the Pallas kernel mobilesuperresolution_tpu/kernels/conv5x5.py::
// conv5x5_same (25 shifted-tap GEMMs with an f32 accumulator). On the main
// path it runs SpyNet's five space-to-depth convs per pyramid level
// (32->128, 128->256, 256->128, 128->64 with ReLU, 64->8 without), in bf16
// when serving and in f32 when training (below).
// At the finest level (N=18, 128x224) the 128->256 and 256->128 convs are
// ~846 GFLOP each, so the op is bound by tensor-core throughput (989 TFLOP/s
// bf16), except 64->8, which is bound by bytes.
//
// bf16 design: an implicit GEMM on Hopper's warpgroup MMA. M is a 2-D tile of
// output pixels, N the output channels (up to 128 per tile), K the 25 taps x
// Cin.
// - A block is two warpgroups. Each warpgroup owns MW m64 row groups; a warp's
//   16 rows of an m64 are 16 consecutive pixels of one output row, so the block
//   tile is (8 MW) rows x 16 columns.
// - Shared memory holds two buffers of the (tile + 4)-halo of one Cin chunk
//   (KC channels) and a ring of weight stages, each the KC x N weights of TPS
//   consecutive taps. The halo is copied with 16-byte cp.async (src-size 0
//   zero-fills pixels outside the image and channels past Cin); the next
//   chunk's halo is in flight during the current chunk, and stages are
//   copied up to 4 (TPS 5) or 5 (TPS 1) ahead.
// - Weights: the caller may pass them packed (kernels/conv5x5.py::
//   pack_weights, once, in SpyNet's prepare) in the stages' own layout; one
//   thread then copies a stage with a few bulk copies (cp.async.bulk) that
//   complete on the stage's mbarrier. That took the 128->256 conv from 2.10 to
//   1.72 ms on an H100: 1024 per-thread 16-byte copies per stage had cost the
//   warps that feed the tensor cores. Otherwise (no packing, Cin not a
//   multiple of KC, Cout not of 64, N below 64) every thread copies 16-byte
//   pieces with cp.async.
// - A tap (dy, dx) shifts the A tile by whole pixels, which a wgmma shared-
//   memory descriptor cannot express, so A goes to registers with ldmatrix
//   (one row address per lane into the shifted halo). The halo's 16-byte
//   chunks are XOR-swizzled by pixel index, so each 8-lane ldmatrix phase hits
//   8 distinct bank groups.
// - B is read by wgmma from shared memory through a descriptor, MN-major
//   (HWIO keeps Cout contiguous; imm-trans-b 1): 128-byte-swizzled atoms of 8
//   k x 64 n for N tiles of 64 and 128, 8x8 core matrices without swizzle for
//   narrower ones. f32 accumulators stay in registers, started by the first
//   wgmma with scale-d 0; one wgmma batch stays in flight while the next
//   tap's A is loaded.
// - Epilogue: bias and ReLU in f32, one rounding to bf16, through a padded
//   shared-memory stage, then 16-byte stores (a tile row of N = Cout channels
//   is contiguous in NHWC). Ragged H, W and Cout are masked.
// - The tile per launch is picked on the host (launch_bf16, tuned on the
//   H100): M 256 x N 128 with KC 32 and TPS 5 for the wide convs, N = Cout
//   with KC 16 for the narrow ones, smaller tiles at small pyramid levels so
//   that the grid fills the card.
// - What bounds it now: at ~52 % of the bf16 peak on the wide convs, a tap
//   moves ~100 KB through shared memory per block (wgmma's B reads, ldmatrix,
//   the weight copies) for 4.2 MFLOP, close to the SM's shared-memory rate at
//   the tensor-core rate, and a block barrier per stage keeps the two
//   warpgroups in step. Next: A from shared memory by descriptor (dx-shifted
//   halo copies), TMA multicast of the weight stages across a cluster, warp
//   specialisation (per-slot mbarriers alone, without a producer warp, were
//   slower here: thread 0 waiting stalls its whole warpgroup).
// - Cin or Cout not a multiple of 8 (never on the main path) stage through a
//   synchronous zero-filling loop: right, not fast.
//
// f32 (the VSR training step, f32 eval and the zoo's f32 forwards: 36
// samples at 32x32 down to 1x1 in a training step): 3xTF32 on the tensor
// cores (hopper.cuh's Tf32x3: hi = tf32(v), lo = v - hi, lo·hi + hi·lo +
// hi·hi summed in f32), so no operand loses its low bits. The step's 30
// convs are 2 x 36 x (1024 + 256 + 64 + 16 + 4 + 1) x 25 x (32·128 +
// 128·256 + 256·128 + 128·64 + 64·8) ≈ 192 GFLOP: 1.2 ms at 3xTF32 (165
// TFLOP/s, a third of the TF32 dense rate), bound by operations at the fine
// levels (the coarse levels' bound is a few µs each). Two routes, picked per
// call by f32_plan (below) from the shape, the SM count and whether packed
// weights were given, that give the same bits:
// each output sums K chunk by chunk (8 channels), tap by tap (dy, then dx),
// an order fixed by Cin alone, with the same three tf32 products a k-step
// (on an H100 wgmma m64nNk8 and mma.sync m16n8k8 round each k-step's sum
// alike; chip_smoke.py holds the two routes bit-equal). So two calls, a
// height-sharded window and any tile give the same bits. No atomics, no
// split K.
// - The M tile is a box of ti images x tr rows x tc columns: 1 x 16 x 16 or
//   1 x 8 x 16 on large maps, and at maps of at most half a tile whole
//   images folded together (8 x 4 x 4, 32 x 2 x 2, 128 x 1 x 1), so no
//   thread computes a position outside the image. Taps whose shift lies
//   wholly outside the image (|dy| > H - 1 or |dx| > W - 1) add exact zeros
//   and are skipped: the halo margin is min(2, H - 1) x min(2, W - 1), and
//   at 1x1 only the centre tap is left.
// - Both halo an 8-channel chunk at a pixel stride of 48 bytes (ldmatrix
//   phases free of bank conflicts), copied by 16-byte cp.async (zero-filled
//   outside the images and past Cin; 4-byte pieces for Cin not a multiple of
//   4), and take A by ldmatrix.x4, which over 32-bit elements leaves the
//   tf32 A fragment in PTX order, split in registers.
// - wgmma (conv5x5_tf32_wgmma_kernel; 8-warp tiles of 256 positions, 16 x
//   16 or whole images folded, and 64 or 128 channels, where the weights
//   come packed and such tiles fill half the SMs: SpyNet's 32x32 and 16x16
//   levels at 36 samples, coarser ones in larger batches): two
//   warpgroups, two m64 row groups each, three wgmma a tap. B, tf32 hi and
//   lo, is K-major in the 32-byte swizzle (tf32 has no transpose), packed
//   once on the host (kernels/conv5x5.py::pack_weights_f32: SpyNet's weights
//   are frozen, packed in its prepare) and copied a live tap row at a time
//   by bulk copies on a ring of mbarriers; one batch stays in flight while
//   the next tap's A loads; one block barrier per tap row.
// - mma.sync (conv5x5_tf32_kernel; the rest: 4 warps of two m16 tiles, N
//   up to 64 channels, halved while the grid has fewer blocks than SMs): a
//   ring of 2-4 stages (as many as leave room for two blocks an SM, where two
//   stages do), each an 8-channel halo and those channels' weights for the
//   live taps as they lie in HWIO (rows of (nb | 1) x 8 floats: a warp's
//   4-byte B loads on 32 banks), split in registers, so nothing is packed;
//   each product's three passes run over all 2 x nb accumulators in turn.
// - Epilogue: bias and ReLU in f32, stored from the accumulators (a quad's 8
//   channels are one 32-byte run).
// What bounds it now: at the fine levels the tf32 rate the kernels reach
// (wgmma's k8 step is short: per FLOP it issues twice bf16's instructions),
// times the three products; at the coarse levels each block's chain of Cin
// / 8 chunks x live taps, where mma.sync's shorter latency beats wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

using namespace hopper;

namespace {

// ---- bf16: wgmma implicit GEMM ----
constexpr int G_TW = 16;              // tile columns: one warp's 16 A rows
constexpr int G_HALO_W = G_TW + 4;
constexpr int G_WGS = 2;              // warpgroups per block
constexpr int G_THREADS = 128 * G_WGS;
constexpr int G_SMEM_MAX = 232448;    // 227 KB, the most one block may opt in to
constexpr int G_TAPS = 25;

template <int NT, int MW, int KC, int TPS>
struct Cfg {
  static constexpr int TH = 4 * G_WGS * MW;     // tile rows
  static constexpr int HALO_H = TH + 4;
  static constexpr int CP = KC / 8;             // 16-byte chunks per halo pixel
  static constexpr int KS = KC / 16;            // wgmma k-steps per tap
  static constexpr int HALO_BYTES = HALO_H * G_HALO_W * KC * 2;
  static constexpr int TAP_BYTES = KC * NT * 2; // one tap's weights for one chunk
  static constexpr int WSTAGE_BYTES = TPS * TAP_BYTES;
  static constexpr int FIT = (G_SMEM_MAX - 2 * HALO_BYTES) / WSTAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // Stages are copied this many ahead. A stage is refilled two stages after
  // its last reader started (one wgmma batch stays in flight), and the next
  // chunk's halo, copied with the chunk's first stage, must land before the
  // chunk's last stage.
  static constexpr int DIST = STAGES - 2 < G_TAPS / TPS - 1 ? STAGES - 2 : G_TAPS / TPS - 1;
  static constexpr int OUT_PITCH = NT * 2 + 16; // epilogue stage row (bytes), padded
  static constexpr int PIPE_BYTES = 2 * HALO_BYTES + STAGES * WSTAGE_BYTES;
  static constexpr int OUT_BYTES = TH * G_TW * OUT_PITCH;
  static constexpr int BAR_OFF = PIPE_BYTES > OUT_BYTES ? PIPE_BYTES : OUT_BYTES;  // one mbarrier per stage
  static constexpr int SMEM = BAR_OFF + STAGES * 8;
  // N tiles of 64 and 128 keep B in 128-byte-swizzled atoms (8 k x 64 n),
  // narrower ones in 8x8 core matrices without swizzle
  static constexpr bool SW128 = NT % 64 == 0;
  static_assert(STAGES >= 3 && DIST >= 1 && SMEM <= G_SMEM_MAX && G_TAPS % TPS == 0 && BAR_OFF % 8 == 0 &&
                    (!SW128 || (2 * HALO_BYTES) % 1024 == 0),
                "bad tile");
};

// 16-byte chunk c of halo pixel p sits at chunk position swz(p, c): 8
// consecutive pixels then cover all 8 bank groups for every chunk count.
template <int CP>
__device__ __forceinline__ int swz(int p, int c) {
  return c ^ ((p / (8 / CP)) % CP);
}

// A fragments of iteration `it` (tap it % 25 of chunk it / 25): for each m64
// row group and k-step, the warp's 16 pixels x 16 channels.
template <int NT, int MW, int KC, int TPS>
__device__ __forceinline__ void load_a(uint32_t (&a)[MW][KC / 16][4], uint32_t halo_s, int it, int wg,
                                       int warp, int lane) {
  using C = Cfg<NT, MW, KC, TPS>;
  const int tap = it % G_TAPS, dy = tap / 5, dx = tap % 5;
  const uint32_t base = halo_s + ((it / G_TAPS) & 1) * C::HALO_BYTES;
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    const int p = ((wg * MW + m) * 4 + warp + dy) * G_HALO_W + (lane & 15) + dx;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks)
      ldmatrix_x4(a[m][ks], base + p * (KC * 2) + (swz<C::CP>(p, ks * 2 + (lane >> 4)) << 4));
  }
}

// Issue the wgmma batch of iteration `it` (one tap) on its weight stage.
template <int NT, int MW, int KC, int TPS>
__device__ __forceinline__ void mma_step(float (&acc)[MW][NT / 2], const uint32_t (&a)[MW][KC / 16][4],
                                         uint32_t wring_s, int it) {
  using C = Cfg<NT, MW, KC, TPS>;
  const uint32_t base = wring_s + (it / TPS % C::STAGES) * C::WSTAGE_BYTES + (it % TPS) * C::TAP_BYTES;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    const uint64_t desc = C::SW128 ? desc_sw128(base + ks * 2 * NT * 16, 1024, NT * 16)
                                   : desc_interleave(base + ks * 2 * (NT / 8) * 128, (NT / 8) * 128, 128);
#pragma unroll
    for (int m = 0; m < MW; ++m) Wgmma<NT>::mma(acc[m], a[m][ks], desc, it > 0 || ks > 0);
  }
  wgmma_commit();
}

template <int NT, int MW, int KC, int TPS>
__global__ void __launch_bounds__(G_THREADS, 1) conv5x5_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ wp, const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
    int H, int W, int Cin, int Cout, int tiles_w, int tiles_h, int relu) {
  using C = Cfg<NT, MW, KC, TPS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* halo = smem;                       // [2][HALO_H * G_HALO_W][KC], swizzled chunks
  unsigned char* wring = smem + 2 * C::HALO_BYTES;  // [STAGES][TPS][KC / 8] x (NT / 64 atoms or NT / 8 cores)
  const uint32_t halo_s = smem_u32(halo), wring_s = smem_u32(wring), bar_s = smem_u32(smem + C::BAR_OFF);

  const int tile = blockIdx.x;
  const int tx = tile % tiles_w;
  const int ty = (tile / tiles_w) % tiles_h;
  const int img = tile / (tiles_w * tiles_h);
  const int y0 = ty * C::TH, x0 = tx * G_TW, n0 = blockIdx.y * NT;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool vec = (Cin % 8) == 0 && (Cout % 8) == 0;
  // Weights packed in swizzled atoms (wp, when given; kernels/conv5x5.py::
  // pack_weights): each stage is TPS * KC / 8 contiguous runs, copied by one
  // thread with bulk copies that complete on the stage's mbarrier.
  const bool bulk = wp != nullptr;
  if (bulk && tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(bar_s + s * 8, 1);
    fence_mbar_init();
  }
  if (bulk) __syncthreads();
  const int nchunks = (Cin + KC - 1) / KC;
  const int iters = nchunks * G_TAPS;
  const size_t img_px = size_t(img) * H * W;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  auto issue_halo = [&](int buf, int chunk) {
    for (int idx = tid; idx < C::HALO_H * G_HALO_W * C::CP; idx += G_THREADS) {
      const int p = idx / C::CP, c = idx % C::CP;
      const int gy = y0 + p / G_HALO_W - 2, gx = x0 + p % G_HALO_W - 2;
      const int ch = chunk * KC + c * 8;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int off = buf * C::HALO_BYTES + p * (KC * 2) + (swz<C::CP>(p, c) << 4);
      const __nv_bfloat16* src = x + (img_px + size_t(gy) * W + gx) * Cin + ch;
      if (vec) {
        const bool ok = inside && ch < Cin;
        cp_async16(halo_s + off, ok ? src : x, ok);
      } else {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(halo + off);
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k] = (inside && ch + k < Cin) ? src[k] : zero;
      }
    }
  };
  auto issue_w = [&](int st) {  // stage st: taps st * TPS .. + TPS - 1 of one chunk
    const int chunk = st * TPS / G_TAPS, tap0 = st * TPS % G_TAPS;
    if (bulk) {
      if (tid == 0) {
        // Output channels past Cout are not copied: they feed only columns
        // the epilogue masks. K never has a tail here (Cin % KC == 0).
        const int bytes = min(NT, Cout - n0) * 16;  // per 8 k: NT / 64 atoms of 1 KB
        const uint32_t bar = bar_s + (st % C::STAGES) * 8;
        mbar_arrive_expect_tx(bar, TPS * (KC / 8) * bytes);
        for (int tl = 0; tl < TPS; ++tl)
          for (int kg = 0; kg < KC / 8; ++kg)
            bulk_copy_g2s(wring_s + (st % C::STAGES) * C::WSTAGE_BYTES + tl * C::TAP_BYTES + kg * NT * 16,
                          wp + ((size_t(tap0 + tl) * (Cin / 8) + chunk * (KC / 8) + kg) * Cout + n0) * 8, bytes, bar);
      }
      return;
    }
    for (int idx = tid; idx < TPS * KC * (NT / 8); idx += G_THREADS) {
      const int ng = idx % (NT / 8), k = idx / (NT / 8) % KC, tl = idx / (NT / 8) / KC;
      const int c = chunk * KC + k, n = n0 + ng * 8, tap = tap0 + tl;
      const int off = (st % C::STAGES) * C::WSTAGE_BYTES + tl * C::TAP_BYTES +
                      (C::SW128 ? ((k >> 3) * (NT / 64) + (ng >> 3)) * 1024 + (k & 7) * 128 + (((ng & 7) ^ (k & 7)) << 4)
                                : ((k >> 3) * (NT / 8) + ng) * 128 + (k & 7) * 16);
      const __nv_bfloat16* src = w + (size_t(tap) * Cin + c) * Cout + n;
      if (vec) {
        const bool ok = c < Cin && n < Cout;
        cp_async16(wring_s + off, ok ? src : w, ok);
      } else {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(wring + off);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = (c < Cin && n + j < Cout) ? src[j] : zero;
      }
    }
  };

  float acc[MW][NT / 2];  // set by the first wgmma (acc 0): no zeroing moves
  uint32_t a0[MW][C::KS][4], a1[MW][C::KS][4];

  // Prologue: the first chunk's halo and the first DIST weight stages, one
  // cp.async group per stage (group j holds stage j's weights, unless they
  // are copied in bulk).
  const int nstages = iters / TPS;
  issue_halo(0, 0);
#pragma unroll 1
  for (int j = 0; j < C::DIST; ++j) {
    if (j < nstages) issue_w(j);
    cp_async_commit();
  }

  // One iteration is one tap. At a stage's first tap: wait for its copies
  // (cp.async group it / TPS; the halo's and, unless bulk, the weights') and
  // for every warpgroup to be done with the stage about to be refilled (a
  // block barrier), then issue the copies of stage it / TPS + DIST (and, at a
  // chunk's first tap, the next chunk's halo); bulk weights are then waited
  // for on the stage's mbarrier. Every tap: start the wgmma batch, let the
  // previous batch retire, then load the next tap's A into the registers that
  // batch read.
#define CONV5X5_STEP(IT, CUR, NXT)                                                             \
  {                                                                                            \
    if ((IT) % TPS == 0) {                                                                     \
      cp_async_wait<C::DIST - 1>();                                                            \
      fence_proxy_async();                                                                     \
      __syncthreads();                                                                         \
      if ((IT) / TPS + C::DIST < nstages) issue_w((IT) / TPS + C::DIST);                       \
      if ((IT) % G_TAPS == 0 && (IT) / G_TAPS + 1 < nchunks)                                   \
        issue_halo(((IT) / G_TAPS + 1) & 1, (IT) / G_TAPS + 1);                                \
      cp_async_commit();                                                                       \
      if (bulk) mbar_wait(bar_s + (IT) / TPS % C::STAGES * 8, (IT) / TPS / C::STAGES & 1);     \
    }                                                                                          \
    if ((IT) == 0) load_a<NT, MW, KC, TPS>(CUR, halo_s, 0, wg, warp, lane);                    \
    mma_step<NT, MW, KC, TPS>(acc, CUR, wring_s, (IT));                                        \
    wgmma_wait<1>();                                                                           \
    if ((IT) + 1 < iters) load_a<NT, MW, KC, TPS>(NXT, halo_s, (IT) + 1, wg, warp, lane);      \
  }
#pragma unroll 1
  for (int it = 0; it < iters; it += 2) {
    CONV5X5_STEP(it, a0, a1)
    if (it + 1 < iters) CONV5X5_STEP(it + 1, a1, a0)
  }
#undef CONV5X5_STEP
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MW; ++m) fence_operands(acc[m]);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring: reuse it as the output stage

  // Epilogue: bias, ReLU, one rounding, into [pixel][NT] rows of OUT_PITCH bytes.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    const int prow = (wg * MW + m) * 4 + warp;
#pragma unroll
    for (int q = 0; q < NT / 8; ++q) {
      const int n = n0 + 8 * q + 2 * t;
      const float b0 = n < Cout ? bias[n] : 0.f, b1 = n + 1 < Cout ? bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[m][4 * q + 2 * h] + b0, v1 = acc[m][4 * q + 2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int p = prow * G_TW + g + 8 * h;
        *reinterpret_cast<uint32_t*>(smem + p * C::OUT_PITCH + (8 * q + 2 * t) * 2) = pack_bf16x2(v0, v1);
      }
    }
  }
  __syncthreads();
  const int nvalid = min(NT, Cout - n0);
  if (Cout % 8 == 0) {
    for (int idx = tid; idx < C::TH * G_TW * (NT / 8); idx += G_THREADS) {
      const int p = idx / (NT / 8), c8 = idx % (NT / 8);
      const int oy = y0 + p / G_TW, ox = x0 + p % G_TW;
      if (oy < H && ox < W && c8 * 8 < nvalid)
        *reinterpret_cast<uint4*>(y + (img_px + size_t(oy) * W + ox) * Cout + n0 + c8 * 8) =
            *reinterpret_cast<const uint4*>(smem + p * C::OUT_PITCH + c8 * 16);
    }
  } else {
    for (int idx = tid; idx < C::TH * G_TW * NT; idx += G_THREADS) {
      const int p = idx / NT, c = idx % NT;
      const int oy = y0 + p / G_TW, ox = x0 + p % G_TW;
      if (oy < H && ox < W && c < nvalid)
        y[(img_px + size_t(oy) * W + ox) * Cout + n0 + c] =
            *reinterpret_cast<const __nv_bfloat16*>(smem + p * C::OUT_PITCH + c * 2);
    }
  }
}

template <int NT, int MW, int KC, int TPS>
cudaError_t launch_wgmma(const void* x, const void* w, const void* wp, const float* b, void* y, int n, int h,
                         int wd, int cin, int cout, int relu, cudaStream_t stream) {
  using C = Cfg<NT, MW, KC, TPS>;
  cudaError_t err = cudaFuncSetAttribute(conv5x5_wgmma_kernel<NT, MW, KC, TPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + G_TW - 1) / G_TW, tiles_h = (h + C::TH - 1) / C::TH;
  dim3 grid(tiles_w * tiles_h * n, (cout + NT - 1) / NT);
  conv5x5_wgmma_kernel<NT, MW, KC, TPS><<<grid, G_THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      C::SW128 && cin % KC == 0 && cout % 64 == 0 ? static_cast<const __nv_bfloat16*>(wp) : nullptr, b,
      static_cast<__nv_bfloat16*>(y), h, wd, cin, cout, tiles_w, tiles_h, relu);
  return cudaGetLastError();
}

// Tile for one launch (tuned on the H100 at SpyNet's pyramid levels): N = Cout
// rounded up to a power of two, at most 128 (Cout 256 runs as two N tiles:
// M 256 x N 128 per block halves the weight bytes per FLOP of M 128 x N 256);
// Cin chunks of 32 (16 below Cin 32) and five taps per weight stage. For the
// wide convs at small maps, where that grid would fill less than half the
// SMs, M 64 x N 64 with Cin chunks of 64; N 64 tiles are halved in height
// when the grid has fewer blocks than the card has SMs.
cudaError_t launch_bf16(const void* x, const void* w, const void* wp, const float* b, void* y, int n, int h,
                        int wd, int cin, int cout, int relu, cudaStream_t s) {
  auto blocks = [&](int nt, int mw) {
    return long(n) * ((h + 8 * mw - 1) / (8 * mw)) * ((wd + G_TW - 1) / G_TW) * ((cout + nt - 1) / nt);
  };
  constexpr int SMS = 132;
  int nt = 8;
  while (nt < cout && nt < 128) nt *= 2;
  if (nt == 128 && cin >= 64 && blocks(128, 2) < SMS / 2)
    return launch_wgmma<64, 1, 64, 5>(x, w, wp, b, y, n, h, wd, cin, cout, relu, s);
  switch (nt) {
    case 128:
      if (cin >= 32) return launch_wgmma<128, 2, 32, 5>(x, w, wp, b, y, n, h, wd, cin, cout, relu, s);
      return launch_wgmma<128, 2, 16, 5>(x, w, wp, b, y, n, h, wd, cin, cout, relu, s);
    case 64:
      if (blocks(64, 2) < SMS) return launch_wgmma<64, 1, 16, 5>(x, w, wp, b, y, n, h, wd, cin, cout, relu, s);
      return launch_wgmma<64, 2, 16, 5>(x, w, wp, b, y, n, h, wd, cin, cout, relu, s);
    case 32: return launch_wgmma<32, 2, 16, 5>(x, w, wp, b, y, n, h, wd, cin, cout, relu, s);
    case 16: return launch_wgmma<16, 2, 16, 5>(x, w, wp, b, y, n, h, wd, cin, cout, relu, s);
    default: return launch_wgmma<8, 2, 16, 5>(x, w, wp, b, y, n, h, wd, cin, cout, relu, s);
  }
}

// ---- f32: 3xTF32 implicit GEMM on mma.sync m16n8k8 ----
constexpr int F_KC = 8;       // input channels per stage: one k-step
constexpr int F_PSTR = 48;    // halo pixel stride (bytes): 8 f32 and 16 of padding, an odd number of 16-byte chunks
constexpr int F_STAGES_MAX = 4;

// Tile of one f32 launch: the M tile, ti images x tr rows x tc columns, as
// f32_plan (below) picks it, and what follows from it.
struct F32Tile {
  int ti, tr, tc;         // the M tile
  int mh, mw;             // halo margins min(2, H - 1), min(2, W - 1): taps past them read only zeros
  int tiles_w, tiles_h;   // tiles along W and H; blockIdx.x runs over them, then over groups of ti images
  int stages;             // pipeline depth (2 .. F_STAGES_MAX)
  __host__ __device__ int hh() const { return tr + 2 * mh; }
  __host__ __device__ int hw() const { return tc + 2 * mw; }
  __host__ __device__ int taps() const { return (2 * mh + 1) * (2 * mw + 1); }
  __host__ __device__ int halo_bytes() const { return (ti * hh() * hw() * F_PSTR + 127) / 128 * 128; }
  // one stage: the halo of 8 input channels and their weights for every live
  // tap, rows of s floats
  __host__ __device__ int stage_bytes(int s) const { return halo_bytes() + taps() * F_KC * s * 4; }
};

// cp.async.wait_group with a runtime count of groups left pending (0 .. 2).
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  if (pending <= 0) cp_async_wait<0>();
  else if (pending == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

template <int NB>
__global__ void __launch_bounds__(128, 1) conv5x5_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ y, int N, int H, int W, int Cin, int Cout, int relu, F32Tile tl) {
  // S: a weight row's stride in floats, 8 mod 16, so a warp's B loads (rows
  // t and t + 4, columns g) hit 32 distinct banks
  constexpr int THR = 128, NT = NB * 8, S = (NB | 1) * 8;
  // the alignment every kernel of this file declares for its one dynamic
  // buffer (they share the symbol); this kernel needs 128
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int hh = tl.hh(), hw = tl.hw(), hpx = tl.ti * hh * hw, ntx = 2 * tl.mw + 1, taps = tl.taps();
  const int halo_bytes = tl.halo_bytes(), stage_bytes = tl.stage_bytes(S);
  const int tile = blockIdx.x;
  const int x0 = tile % tl.tiles_w * tl.tc, y0 = tile / tl.tiles_w % tl.tiles_h * tl.tr;
  const int i0 = tile / (tl.tiles_w * tl.tiles_h) * tl.ti, n0 = blockIdx.y * NT;
  const int nchunks = (Cin + F_KC - 1) / F_KC, tsz = tl.ti * tl.tr * tl.tc;
  const bool vx = Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vw = Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const uint32_t smem_s = smem_u32(smem);

  // Stage chunk `chunk` (input channels 8 chunk .. + 7) into buffer buf: the
  // halo, ti x hh x hw pixels (zero outside the images and past Cin), and
  // the weights of the live taps, [tap][k][n0 .. n0 + NT) (zero past Cin and
  // Cout).
  auto stage = [&](int buf, int chunk) {
    const uint32_t hs = smem_s + buf * stage_bytes, ws = hs + halo_bytes;
    const int c0 = chunk * F_KC;
    for (int idx = tid; idx < hpx * 2; idx += THR) {
      const int p = idx >> 1, h = idx & 1;
      const int i = p / (hh * hw), r = p / hw - i * hh, c = p % hw;
      const int img = i0 + i, gy = y0 + r - tl.mh, gx = x0 + c - tl.mw, ch = c0 + 4 * h;
      const bool inside = img < N && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = inside ? x + ((size_t(img) * H + gy) * W + gx) * Cin + ch : x;
      const uint32_t dst = hs + p * F_PSTR + 16 * h;
      if (vx) {
        cp_async16(dst, inside && ch < Cin ? src : x, inside && ch < Cin);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = inside && ch + e < Cin;
          cp_async_small<4>(dst + 4 * e, ok ? src + e : x, ok);
        }
      }
    }
    for (int idx = tid; idx < taps * F_KC * (NT / 4); idx += THR) {
      const int q = idx % (NT / 4), k = idx / (NT / 4) % F_KC, tp = idx / (NT / 4 * F_KC);
      const int tap = (tp / ntx + 2 - tl.mh) * 5 + tp % ntx + 2 - tl.mw;
      const int c = c0 + k, n = n0 + 4 * q;
      const float* src = w + (size_t(tap) * Cin + c) * Cout + n;
      const uint32_t dst = ws + ((tp * F_KC + k) * S + 4 * q) * 4;
      if (vw) {
        const bool ok = c < Cin && n < Cout;
        cp_async16(dst, ok ? src : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = c < Cin && n + e < Cout;
          cp_async_small<4>(dst + 4 * e, ok ? src + e : w, ok);
        }
      }
    }
  };

  // This lane's ldmatrix row of each m16 tile: the halo pixel of its M
  // position at tap (-mh, -mw) (pixel 0 past the tile: read, never stored);
  // and the output pixel of accumulator rows g, g + 8 (-1 outside).
  int apix[2], opix[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = warp * 32 + mi * 16 + (lane & 15);
    apix[mi] = m < tsz ? (m / (tl.tr * tl.tc) * hh + m / tl.tc % tl.tr) * hw + m % tl.tc : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mo = warp * 32 + mi * 16 + g + 8 * h;
      const int img = i0 + mo / (tl.tr * tl.tc), oy = y0 + mo / tl.tc % tl.tr, ox = x0 + mo % tl.tc;
      opix[mi][h] = mo < tsz && img < N && oy < H && ox < W ? (img * H + oy) * W + ox : -1;
    }
  }

  float acc[2][NB][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][q][e] = 0.f;

  // A ring of tl.stages buffers, chunks copied stages - 1 ahead; one
  // cp.async group per chunk (empty past the last), one block barrier per
  // chunk. Each output sums K in one order, chunk by chunk (8 channels), tap
  // by tap (dy, then dx): fixed by Cin alone (a skipped tap adds exact zeros).
  const int ahead = tl.stages - 1;
  for (int j = 0; j < ahead; ++j) {
    if (j < nchunks) stage(j, j);
    cp_async_commit();
  }
#pragma unroll 1
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait_upto(ahead - 1);  // chunk ch's group is in
    __syncthreads();                // ... for every thread; and every warp is done with chunk ch - 1's buffer
    if (ch + ahead < nchunks) stage((ch + ahead) % tl.stages, ch + ahead);
    cp_async_commit();
    const int buf = ch % tl.stages;
    const uint32_t hs = smem_s + buf * stage_bytes;
    const float* ws = reinterpret_cast<const float*>(smem + buf * stage_bytes + halo_bytes) + t * S + g;
#pragma unroll 1
    for (int tp = 0; tp < taps; ++tp) {
      const int off = tp / ntx * hw + tp % ntx;
      Tf32x3::A af[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t r[4];
        ldmatrix_x4(r, hs + (apix[mi] + off) * F_PSTR + (lane >> 4) * 16);
        af[mi] = Tf32x3::split_a(r);
      }
      // B: rows t and t + 4 of the tap's 8, columns 8q + g
      const float* wr = ws + tp * F_KC * S;
      Tf32x3::B bf[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q) bf[q] = Tf32x3::split_b(wr[8 * q], wr[4 * S + 8 * q]);
      mma_tf32x3<2, NB>(acc, af, bf);
    }
  }
  cp_async_wait<0>();

  // Epilogue: bias, ReLU, straight to y (a quad's 8 channels are one 32-byte run).
  float bv[NB][2];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 8 * q + 2 * t + e;
      bv[q][e] = n < Cout ? bias[n] : 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (opix[mi][h] < 0) continue;
      float* out = y + size_t(opix[mi][h]) * Cout;
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int n = n0 + 8 * q + 2 * t;
        float v0 = acc[mi][q][2 * h] + bv[q][0], v1 = acc[mi][q][2 * h + 1] + bv[q][1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (Cout % 2 == 0 && n + 1 < Cout) {
          *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
        } else {
          if (n < Cout) out[n] = v0;
          if (n + 1 < Cout) out[n + 1] = v1;
        }
      }
    }
}

template <int NB>
cudaError_t launch_tf32(const float* x, const float* w, const float* b, float* y, int n, int h, int wd, int cin,
                        int cout, int relu, F32Tile tl, cudaStream_t stream) {
  constexpr int S = (NB | 1) * 8;
  const int smem = tl.stages * tl.stage_bytes(S);
  auto kern = conv5x5_tf32_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long blocks = long(tl.tiles_w) * tl.tiles_h * ((n + tl.ti - 1) / tl.ti);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kern<<<dim3(unsigned(blocks), (cout + NB * 8 - 1) / (NB * 8)), 128, smem, stream>>>(
      x, w, b, y, n, h, wd, cin, cout, relu, tl);
  return cudaGetLastError();
}

// ---- f32, 16 x 16 tiles of 64 or 128 channels: 3xTF32 on wgmma m64nNk8 ----

constexpr int T_TAP_BYTES_PER_ROW = 32;  // one output channel's k-step: 8 tf32, K-major
constexpr int T_RING_MAX = 6;

// Shared-memory layout of one tf32 wgmma launch: two halos (one 8-channel
// chunk each, pixel stride F_PSTR), a ring of weight stages (one tap row of
// the live taps, hi and lo, NT K-major rows of 32 bytes each), one mbarrier
// per stage.
template <int NT>
struct TLayout {
  int halo, stage, ring, bars, total;
  __host__ __device__ TLayout(const F32Tile& tl, int stages) {
    halo = (tl.ti * tl.hh() * tl.hw() * F_PSTR + 1023) / 1024 * 1024;
    stage = (2 * tl.mw + 1) * 2 * NT * T_TAP_BYTES_PER_ROW;
    ring = 2 * halo;
    bars = ring + stages * stage;
    total = bars + stages * 8;
  }
};

// Three wgmma of one tap (lo·hi, hi·lo, hi·hi), for each m64 row group, on
// the stage at `slot` (tap tx's hi rows, then its lo rows).
template <int NT, int MW>
__device__ __forceinline__ void tf32_batch(float (&acc)[MW][NT / 2], Tf32x3::A (&a)[MW], uint32_t slot, int tx,
                                           bool first) {
  const uint32_t hi = slot + tx * 2 * NT * T_TAP_BYTES_PER_ROW, lo = hi + NT * T_TAP_BYTES_PER_ROW;
  const uint64_t dhi = desc_sw32_kmajor(hi, 256), dlo = desc_sw32_kmajor(lo, 256);
  // A's split and the accumulators settle before the fence (else ptxas
  // injects its own, C7519)
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    fence_operands(a[m].hi);
    fence_operands(a[m].lo);
    fence_operands(acc[m]);
  }
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < MW; ++m) WgmmaTf32<NT>::mma(acc[m], a[m].lo, dhi, !first);
#pragma unroll
  for (int m = 0; m < MW; ++m) WgmmaTf32<NT>::mma(acc[m], a[m].hi, dlo, 1);
#pragma unroll
  for (int m = 0; m < MW; ++m) WgmmaTf32<NT>::mma(acc[m], a[m].hi, dhi, 1);
  wgmma_commit();
#pragma unroll
  for (int m = 0; m < MW; ++m) fence_operands(acc[m]);
}

template <int NT>
__global__ void __launch_bounds__(256, 1) conv5x5_tf32_wgmma_kernel(
    const float* __restrict__ x, const float* __restrict__ wp, const float* __restrict__ bias,
    float* __restrict__ y, int N, int H, int W, int Cin, int Cout, int relu, F32Tile tl) {
  constexpr int MW = 2, THR = 256;  // two warpgroups, two m64 row groups each
  extern __shared__ __align__(1024) unsigned char smem[];
  const TLayout<NT> L(tl, tl.stages);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int hh = tl.hh(), hw = tl.hw(), hpx = tl.ti * hh * hw, ntx = 2 * tl.mw + 1, nty = 2 * tl.mh + 1;
  const int tile = blockIdx.x;
  const int x0 = tile % tl.tiles_w * tl.tc, y0 = tile / tl.tiles_w % tl.tiles_h * tl.tr;
  const int i0 = tile / (tl.tiles_w * tl.tiles_h) * tl.ti, n0 = blockIdx.y * NT;
  const int nchunks = (Cin + F_KC - 1) / F_KC, nstages = nchunks * nty, iters = nstages * ntx;
  const int tsz = tl.ti * tl.tr * tl.tc;
  const bool vx = Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const uint32_t smem_s = smem_u32(smem), ring_s = smem_s + L.ring, bar_s = smem_s + L.bars;
  // this block's rows of the packed weights: tile n0 / 64, rows n0 % 64 ..
  const float* wt = wp + size_t(n0 / 64) * nchunks * 25 * 2 * 64 * 8 + (n0 % 64) * 8;

  if (tid == 0) {
    for (int s = 0; s < tl.stages; ++s) mbar_init(bar_s + s * 8, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // The halo of chunk c (input channels 8c .. 8c + 7) into buffer buf, zero
  // outside the images and past Cin.
  auto issue_halo = [&](int c, int buf) {
    for (int idx = tid; idx < hpx * 2; idx += THR) {
      const int p = idx >> 1, h = idx & 1;
      const int i = p / (hh * hw), r = p / hw - i * hh, cc = p % hw;
      const int img = i0 + i, gy = y0 + r - tl.mh, gx = x0 + cc - tl.mw, ch = c * F_KC + 4 * h;
      const bool inside = img < N && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = inside ? x + ((size_t(img) * H + gy) * W + gx) * Cin + ch : x;
      const uint32_t dst = smem_s + buf * L.halo + p * F_PSTR + 16 * h;
      if (vx) {
        cp_async16(dst, inside && ch < Cin ? src : x, inside && ch < Cin);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = inside && ch + e < Cin;
          cp_async_small<4>(dst + 4 * e, ok ? src + e : x, ok);
        }
      }
    }
  };
  // Weight stage j (chunk j / nty, live tap row j % nty): hi and lo rows of
  // each live tap of the row, 2 ntx bulk copies on the stage's mbarrier.
  auto issue_w = [&](int j) {
    const int c = j / nty, ky = j % nty + 2 - tl.mh, slot = j % tl.stages;
    const uint32_t bar = bar_s + slot * 8, bytes = NT * T_TAP_BYTES_PER_ROW;
    mbar_arrive_expect_tx(bar, 2 * ntx * bytes);
    for (int tx = 0; tx < ntx; ++tx) {
      const int tap = ky * 5 + tx + 2 - tl.mw;
      for (int hl = 0; hl < 2; ++hl)
        for (int sub = 0; sub < NT / 64; ++sub)  // N tiles of 128 read two packed tiles of 64
          bulk_copy_g2s(ring_s + slot * L.stage + (2 * tx + hl) * bytes + sub * 64 * T_TAP_BYTES_PER_ROW,
                        wt + size_t(sub) * nchunks * 25 * 2 * 64 * 8 + ((size_t(c) * 25 + tap) * 2 + hl) * 64 * 8,
                        64 * T_TAP_BYTES_PER_ROW, bar);
    }
  };

  // This lane's ldmatrix row of each m64 group: the halo pixel of its M
  // position at tap (-mh, -mw) (pixel 0 past the tile: read, never stored);
  // and the output pixel of accumulator rows g, g + 8 (-1 outside).
  int apix[MW], opix[MW][2];
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    const int m0 = (wg * MW + m) * 64 + warp * 16;
    const int mi = m0 + (lane & 15);
    apix[m] = mi < tsz ? (mi / (tl.tr * tl.tc) * hh + mi / tl.tc % tl.tr) * hw + mi % tl.tc : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mo = m0 + g + 8 * h;
      const int img = i0 + mo / (tl.tr * tl.tc), oy = y0 + mo / tl.tc % tl.tr, ox = x0 + mo % tl.tc;
      opix[m][h] = mo < tsz && img < N && oy < H && ox < W ? (img * H + oy) * W + ox : -1;
    }
  }
  auto load_a = [&](Tf32x3::A (&a)[MW], int c, int dyi, int tx) {
    const uint32_t base = smem_s + (c & 1) * L.halo + (lane >> 4) * 16;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      uint32_t r[4];
      ldmatrix_x4(r, base + (apix[m] + dyi * hw + tx) * F_PSTR);
      a[m] = Tf32x3::split_a(r);
    }
  };

  // Prologue: the first stages' weights, chunk 0's halo (then chunk 1's in
  // flight), the first tap's A.
  const int dist = tl.stages - 2;
  if (tid == 0)
    for (int j = 0; j < dist && j < nstages; ++j) issue_w(j);
  issue_halo(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (nchunks > 1) issue_halo(1, 1);
  cp_async_commit();

  float acc[MW][NT / 2];  // set by the first wgmma (scale-d 0): no zeroing moves
  Tf32x3::A a0[MW], a1[MW];
  load_a(a0, 0, 0, 0);

  // One iteration is one live tap of one chunk: three wgmma per m64 group.
  // At a stage's first tap: a block barrier (every warpgroup's batches but
  // the last retired: stage j - 2's slot is free), the copy of stage j +
  // dist, the wait for stage j's bytes. Every tap: start the batch, let the
  // previous one retire, then load the next tap's A into the registers it
  // read; into a new chunk first the wait for its halo and a block barrier
  // (chunk c - 1's buffer is free), then chunk c + 1's halo into it. Each
  // output sums K chunk by chunk, tap by tap: fixed by Cin.
  int c = 0, dyi = 0, tx = 0, j = 0;
#define TF32_STEP(IT, CUR, NXT)                                                                 \
  {                                                                                             \
    if (tx == 0) {                                                                              \
      __syncthreads();                                                                          \
      if (tid == 0 && j + dist < nstages) issue_w(j + dist);                                    \
      mbar_wait(bar_s + (j % tl.stages) * 8, (j / tl.stages) & 1);                              \
    }                                                                                           \
    tf32_batch<NT, MW>(acc, CUR, ring_s + (j % tl.stages) * L.stage, tx, (IT) == 0);            \
    wgmma_wait<1>();                                                                            \
    if (++tx == ntx) {                                                                          \
      tx = 0;                                                                                   \
      ++j;                                                                                      \
      if (++dyi == nty) {                                                                       \
        dyi = 0;                                                                                \
        if (++c < nchunks) {                                                                    \
          cp_async_wait<0>();                                                                   \
          __syncthreads();                                                                      \
          if (c + 1 < nchunks) issue_halo(c + 1, (c + 1) & 1);                                  \
          cp_async_commit();                                                                    \
        }                                                                                       \
      }                                                                                         \
    }                                                                                           \
    if ((IT) + 1 < iters) load_a(NXT, c, dyi, tx);                                              \
  }
#pragma unroll 1
  for (int it = 0; it < iters; it += 2) {
    TF32_STEP(it, a0, a1)
    if (it + 1 < iters) TF32_STEP(it + 1, a1, a0)
  }
#undef TF32_STEP
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MW; ++m) fence_operands(acc[m]);

  // Epilogue: acc[m][4q + 2h + e] is row g + 8h of the warp's 16 in m64 group
  // m, channel n0 + 8q + 2t + e; bias and ReLU, straight to y.
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (opix[m][h] < 0) continue;
      float* out = y + size_t(opix[m][h]) * Cout;
#pragma unroll
      for (int q = 0; q < NT / 8; ++q) {
        const int n = n0 + 8 * q + 2 * t;
        float v0 = acc[m][4 * q + 2 * h] + (n < Cout ? bias[n] : 0.f);
        float v1 = acc[m][4 * q + 2 * h + 1] + (n + 1 < Cout ? bias[n + 1] : 0.f);
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (Cout % 2 == 0 && n + 1 < Cout) {
          *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
        } else {
          if (n < Cout) out[n] = v0;
          if (n + 1 < Cout) out[n + 1] = v1;
        }
      }
    }
}

template <int NT>
cudaError_t launch_tf32_wgmma(const float* x, const float* wp, const float* b, float* y, int n, int h, int wd,
                              int cin, int cout, int relu, F32Tile tl, cudaStream_t stream) {
  // the most ring stages (3 .. T_RING_MAX) that fit beside the two halos
  tl.stages = T_RING_MAX;
  while (tl.stages > 3 && TLayout<NT>(tl, tl.stages).total > G_SMEM_MAX) --tl.stages;
  const int smem = TLayout<NT>(tl, tl.stages).total;
  if (smem > G_SMEM_MAX) return cudaErrorInvalidConfiguration;
  auto kern = conv5x5_tf32_wgmma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long blocks = long(tl.tiles_w) * tl.tiles_h * ((n + tl.ti - 1) / tl.ti);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kern<<<dim3(unsigned(blocks), (cout + NT - 1) / NT), 256, smem, stream>>>(x, wp, b, y, n, h, wd, cin, cout, relu,
                                                                            tl);
  return cudaGetLastError();
}

// The f32 tile of an (n, h, wd) map and cout output channels on `sms` SMs,
// the weights packed for wgmma or not. A block of `warps` warps computes an
// M tile of ti images x tr rows x tc columns (at most 32 positions a warp)
// for nb x 8 output channels. A map of at most half a tile folds ti whole
// images into one tile; a larger one is cut into tiles of up to 16 columns.
// With packed weights, 8 warps run wgmma on 256 positions and 64 channels
// (128 where Cout is a multiple of 128 and such tiles still fill half the
// SMs) where tiles of 64 fill at least half the SMs. Else 4 warps run
// mma.sync, nb (at most 8) halved while the grid is short of the blocks the
// SMs hold at once (two each where two stages fit half the shared memory)
// and the halved grid still fits them: at the coarse levels a block's time
// is its chain of chunks and taps, not its width. Every plan sums each
// output's K in one order with the same tf32 products: the result does not
// depend on it.
struct F32Plan {
  int warps, nb;
  F32Tile tl;
};

F32Plan f32_plan(int n, int h, int wd, int cout, bool packed, int sms) {
  auto tile = [&](int m) {
    F32Tile tl{};
    tl.mh = std::min(2, h - 1);
    tl.mw = std::min(2, wd - 1);
    if (long(h) * wd <= m / 2) {
      tl.ti = m / (h * wd);
      tl.tr = h;
      tl.tc = wd;
    } else {
      tl.ti = 1;
      tl.tc = std::min(wd, 16);
      tl.tr = std::min(h, m / tl.tc);
    }
    tl.tiles_w = (wd + tl.tc - 1) / tl.tc;
    tl.tiles_h = (h + tl.tr - 1) / tl.tr;
    return tl;
  };
  auto blocks = [&](int nb, int m) {
    const F32Tile tl = tile(m);
    return (long(n) + tl.ti - 1) / tl.ti * tl.tiles_h * tl.tiles_w * ((cout + 8 * nb - 1) / (8 * nb));
  };
  auto slots = [&](int nb) {
    return long(sms) * (2 * tile(128).stage_bytes((nb | 1) * 8) <= G_SMEM_MAX / 2 ? 2 : 1);
  };
  int nb = std::min(8, (cout + 7) / 8);
  if (packed && nb == 8 && blocks(8, 256) >= sms / 2)
    return {8, cout % 128 == 0 && blocks(16, 256) >= sms / 2 ? 16 : 8, tile(256)};
  while (nb > 1 && blocks(nb, 128) < slots(nb) && blocks((nb + 1) / 2, 128) <= slots((nb + 1) / 2))
    nb = (nb + 1) / 2;
  return {4, nb, tile(128)};
}

}  // namespace

// bf16: x (n, h, wd, cin), w (5, 5, cin, cout), y (n, h, wd, cout), all bf16
// and contiguous; b (cout,) f32. wp: null, or the same weights packed as
// (25, cin / 8, cout / 64, 8, 64) contiguous in swizzled atoms
// (kernels/conv5x5.py::pack_weights), which the weight stages of N tiles of
// 64 and 128 then copy in bulk. Launches on `stream`, does not synchronise,
// returns cudaGetLastError() after the launch.
extern "C" int conv5x5_same_launch(const void* x, const void* w, const void* wp, const void* b, void* y, int n,
                                   int h, int wd, int cin, int cout, int relu, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0) return int(cudaErrorInvalidValue);
  return int(launch_bf16(x, w, wp, static_cast<const float*>(b), y, n, h, wd, cin, cout, relu,
                         static_cast<cudaStream_t>(stream)));
}

// f32 on the tensor cores (3xTF32): x (n, h, wd, cin), w (5, 5, cin, cout),
// b (cout,), y (n, h, wd, cout), all f32 and contiguous, n h wd < 2^31. wp:
// null, or kernels/conv5x5.py::pack_weights_f32(w), which the wgmma route
// reads (taken only where it is given). The tile is f32_plan's on this
// device's SMs. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after the launch.
extern "C" int conv5x5_same_f32_launch(const void* x, const void* w, const void* wp, const void* b, void* y, int n,
                                       int h, int wd, int cin, int cout, int relu, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || long(n) * h * wd > 0x7fffffffL)
    return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return int(err);
  const F32Plan p = f32_plan(n, h, wd, cout, wp != nullptr, sms);
  F32Tile tl = p.tl;
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.warps == 8) {
    const float* pf = static_cast<const float*>(wp);
    if (p.nb == 16) return int(launch_tf32_wgmma<128>(xf, pf, bf, yf, n, h, wd, cin, cout, relu, tl, s));
    return int(launch_tf32_wgmma<64>(xf, pf, bf, yf, n, h, wd, cin, cout, relu, tl, s));
  }
  const int nb = p.nb;
  // the most stages (2 .. 4) that leave room for two blocks an SM, where two
  // stages do, else for one
  const int stage = tl.stage_bytes((nb | 1) * 8), half = G_SMEM_MAX / 2;
  tl.stages = std::min(F_STAGES_MAX, (2 * stage <= half ? half : G_SMEM_MAX) / stage);
  if (tl.stages < 2) return int(cudaErrorInvalidConfiguration);
  const float* wf = static_cast<const float*>(w);
  switch (nb) {
#define B1_NB(NB) \
  case NB: return int(launch_tf32<NB>(xf, wf, bf, yf, n, h, wd, cin, cout, relu, tl, s));
    B1_NB(1) B1_NB(2) B1_NB(3) B1_NB(4) B1_NB(5) B1_NB(6) B1_NB(7) B1_NB(8)
#undef B1_NB
    default: return int(cudaErrorInvalidValue);
  }
}

// f32_plan's tile for tests and logs: plan[0..4] = warps, nb, ti, tr, tc.
extern "C" int conv5x5_same_f32_plan(int n, int h, int wd, int cout, int packed, int sms, int* plan) {
  if (n <= 0 || h <= 0 || wd <= 0 || cout <= 0 || sms <= 0 || long(n) * h * wd > 0x7fffffffL)
    return int(cudaErrorInvalidValue);
  const F32Plan p = f32_plan(n, h, wd, cout, packed != 0, sms);
  const int out[5] = {p.warps, p.nb, p.tl.ti, p.tl.tr, p.tl.tc};
  std::copy(out, out + 5, plan);
  return 0;
}
