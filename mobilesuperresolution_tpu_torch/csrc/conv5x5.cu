// Kernel B1: 5x5 SAME convolution, NHWC, + bias, optional ReLU.
//
// Replaces the Pallas kernel mobilesuperresolution_tpu/kernels/conv5x5.py::
// conv5x5_same (25 shifted-tap GEMMs with an f32 accumulator). On the main
// path it runs SpyNet's five space-to-depth convs per pyramid level
// (32->128, 128->256, 256->128, 128->64 with ReLU, 64->8 without), in bf16.
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
// f32: the CUDA cores in full f32 FMA (no TF32), so it agrees with a float32
// reference to accumulation order; 8 x 32 pixel tile, 16 output channels per
// thread, halo and weights staged 8 input channels at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int TH = 8;    // f32 path: output rows per block
constexpr int TW = 32;   // f32 path: output columns per block
constexpr int HALO_H = TH + 4;
constexpr int HALO_W = TW + 4;
constexpr int THREADS = 256;
constexpr int F_KC = 8;   // f32 path: input channels per step
constexpr int F_TN = 16;  // f32 path: output channels per thread

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

__global__ void __launch_bounds__(THREADS) conv5x5_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, int H, int W,
    int Cin, int Cout, int tiles_w, int tiles_h, int relu) {
  __shared__ float halo[HALO_H * HALO_W * F_KC];
  __shared__ float wts[25 * F_KC * F_TN];

  const int tile = blockIdx.x;
  const int tx = tile % tiles_w;
  const int ty = (tile / tiles_w) % tiles_h;
  const int img = tile / (tiles_w * tiles_h);
  const int ly = threadIdx.x / TW, lx = threadIdx.x % TW;
  const int n0 = blockIdx.y * F_TN;
  const size_t img_off = size_t(img) * H * W;

  float acc[F_TN];
#pragma unroll
  for (int n = 0; n < F_TN; ++n) acc[n] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += F_KC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < HALO_H * HALO_W * F_KC; idx += THREADS) {
      const int k = idx % F_KC, p = idx / F_KC;
      const int gy = ty * TH + p / HALO_W - 2, gx = tx * TW + p % HALO_W - 2;
      const int c = c0 + k;
      halo[idx] = (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin)
                      ? x[(img_off + size_t(gy) * W + gx) * Cin + c]
                      : 0.f;
    }
    for (int idx = threadIdx.x; idx < 25 * F_KC * F_TN; idx += THREADS) {
      const int n = idx % F_TN, r = idx / F_TN;
      const int k = r % F_KC, tap = r / F_KC;
      const int c = c0 + k;
      wts[idx] = (c < Cin && n0 + n < Cout) ? w[(size_t(tap) * Cin + c) * Cout + n0 + n] : 0.f;
    }
    __syncthreads();
    for (int tap = 0; tap < 25; ++tap) {
      const float* a = halo + ((ly + tap / 5) * HALO_W + lx + tap % 5) * F_KC;
      const float* wt = wts + tap * F_KC * F_TN;
#pragma unroll
      for (int k = 0; k < F_KC; ++k) {
        const float av = a[k];
#pragma unroll
        for (int n = 0; n < F_TN; ++n) acc[n] = fmaf(av, wt[k * F_TN + n], acc[n]);
      }
    }
  }

  const int oy = ty * TH + ly, ox = tx * TW + lx;
  if (oy < H && ox < W) {
    float* out = y + (img_off + size_t(oy) * W + ox) * Cout;
#pragma unroll
    for (int n = 0; n < F_TN; ++n) {
      if (n0 + n < Cout) {
        float v = acc[n] + bias[n0 + n];
        out[n0 + n] = relu ? fmaxf(v, 0.f) : v;
      }
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

}  // namespace

// x (n, h, wd, cin), w (5, 5, cin, cout), y (n, h, wd, cout), all contiguous,
// bf16 when is_bf16 else f32; b (cout,) f32. wp: null, or (bf16 only) the
// same weights packed as (25, cin / 8, cout / 64, 8, 64) contiguous in
// swizzled atoms (kernels/conv5x5.py::pack_weights), which the weight stages
// of N tiles of 64 and 128 then copy in bulk. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after the launch.
extern "C" int conv5x5_same_launch(const void* x, const void* w, const void* wp,
                                   const void* b, void* y, int n, int h, int wd,
                                   int cin, int cout, int relu, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b);
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0)
    return int(cudaErrorInvalidValue);
  if (is_bf16) return int(launch_bf16(x, w, wp, bias, y, n, h, wd, cin, cout, relu, s));
  const int tiles_w = (wd + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h * n, (cout + F_TN - 1) / F_TN);
  conv5x5_f32_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(y), h, wd, cin, cout, tiles_w, tiles_h, relu);
  return int(cudaGetLastError());
}
