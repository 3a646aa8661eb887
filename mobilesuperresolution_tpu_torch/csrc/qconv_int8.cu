// Kernels Q1s and Q1: the int8 dynamic-range SAME convolution of float NHWC
// activations, quantized per sample inside the kernels, exact int32
// accumulation, the rescale and the bias fused in the epilogue.
//
// Not a TPU kernel: they replace the per-sample quantization
// (quantize_symmetric) and the XLA int8 convolution (conv_general_dilated of
// int8 operands into int32) of mobilesuperresolution_tpu/ops/quant.py::
// qconv2d, which PyTorch cannot run on CUDA (F.conv2d has no int8 CUDA path).
// The weight is quantized per output channel once (wq int8, ks (Co,) f32)
// and packed once by kernels/qconv_int8.py::pack_weights. Two launches a conv:
//
//   Q1s  xs[n] = max(max|x[n]| / 127, 1e-12)                       (N,) f32
//   Q1   q = clip(round_half_even(x / xs[n]), -127, 127)
//        y[n, p, co] = float(sum_{tap, ci} q[n, p + tap, ci] * wq[co, ci, tap])
//                      * (xs[n] * ks[co]) (+ bias[co])
//
// in the JAX package's order, each operation rounded once (a correctly
// rounded division, no fused multiply-add), then rounded to x's type (f32
// or bf16, to nearest even). Integer sums are exact in any order (|acc| <=
// 127^2 * 6,400 < 2^31 at SpyNet's widest K), so both equal their plain
// versions bit for bit.
//
// Q1s: a grid over each sample's elements (16-byte loads where the layout
// allows), the max of |x| taken on the float bit patterns (exact, and
// ordered as unsigned integers for non-negative floats); each block's max
// goes to a per-sample word by atomicMax, and the last block of a sample
// (an atomic count) turns it into xs[n] and sets both words back to 0. The
// scratch is allocated zeroed once per device and stream, so a call costs
// one launch. Bound: the bytes of x.
//
// Q1, tensor-core route (Cin >= 16 and Cout >= 8): an implicit GEMM on
// Hopper's int8 warpgroup MMA, on B1's skeleton (conv5x5.cu). M is a 16 x
// 16 tile of output pixels (two warpgroups, each two m64 row groups; a
// warp's 16 rows are 16 consecutive pixels of one output row), N the output
// channels (8 to 128 per tile; Cout 144 as three tiles of 48, 256 as two of
// 128), K the k*k taps x Cin in chunks of KC channels: one tap of a chunk is
// KC / 32 k-steps (wgmma m64nNk32 .s32.s8.s8). KC is 64 for bf16 inputs of
// more than 32 channels into N tiles of 64 or 128 with k <= 5 (twice the
// products per wgmma batch for the same loop overhead: 1.64 -> 1.22 ms on
// SpyNet's 128 -> 256), else 32.
// - The float (tile + k - 1)-halo of one chunk is copied by cp.async (16-
//   or 4-byte pieces as the layout allows, zero-filled outside the image and
//   past Cin; element copies otherwise) into one of two float buffers, two
//   chunks ahead. While the tensor cores work on chunk c, the threads
//   quantize chunk c + 1's float halo into one of two int8 halos, a share
//   of it after each tap's wgmma is issued (KC bytes a pixel, its 16-byte
//   pieces permuted by pixel so that an 8-lane ldmatrix phase hits 8 bank
//   groups): the division is paid once per staged element, not per tap.
//   The loop counts taps and chunks without integer division.
// - A goes to registers with ldmatrix from the int8 halo, shifted per tap
//   (the int8 A fragment is byte for byte the bf16 one); one wgmma batch
//   stays in flight while the next tap's A is loaded.
// - B is K-major (8-bit wgmma has no transpose): per k-step NT rows of 32
//   bytes, in the 32-byte swizzle, packed on the host in exactly the order
//   of a ring of weight stages (4 k-steps each, up to 8 stages), each copied
//   by one bulk copy that completes on the stage's mbarrier; a block barrier
//   per stage frees the slot it refills.
// - s32 accumulators stay in registers, started by the first wgmma with
//   scale-d 0. The epilogue is the exact one below, with xs * ks and the
//   bias read from shared memory, into an output tile in shared memory (the
//   halos' and the ring's bytes), then stored in 16-byte pieces. Direct
//   4-byte stores with per-column loads of ks had taken half of a
//   32 -> 128 block's cycles.
// What bounds it (per-phase clock64 counts on an H100, SpyNet's finest
// level): SpyNet's wide convs run at ~700 TOP/s, 35 % of the int8 peak;
// a 256 -> 128 block spends ~36 % of its cycles quantizing the next chunk
// (the rounding's latency, one word a tap in each thread), ~21 % in the
// stage barrier, ~18 % in the prologue (the first chunk's halo from
// device memory, which nothing overlaps: one block per SM at 230
// registers), ~12 % issuing wgmma and ~1 % waiting for it. Short-K convs
// (32 -> 128, the trunk's 54/48 -> 48 at 240x426, bound by bytes at ~4.4
// us) are dominated by the prologue (41-47 %). Next: a persistent block
// that stages the next tile's first chunk during this tile's products, and
// the quantization's share in pairs for ILP. Tried and slower: a producer
// warpgroup (96 threads cannot quantize a halo as fast as 256; ptxas
// serialised N = 128 for registers, C7512), three batches in flight (C7513
// serialisation), empty mbarriers per slot in place of the stage barrier.
//
// Q1, CUDA-core route (Cin < 16 or Cout < 8: WDSR-B's 3 -> 24 head, the 3
// -> 12 skip, SpyNet's direct 16 -> 2; a wgmma tile would be mostly zero
// padding): PR 14's __dp4a kernel, its staging now quantizing as it loads.
// A block of 128 threads owns an 8 x 16 pixel tile and CO_T output
// channels; the input channels go in chunks of 16, whose halo is staged as
// 4 int32 words per pixel (a fifth pads the stride), the chunk's weights as
// one contiguous slab of the packed weight. Odd k in {1, 3, 5, 7}, groups 1.
// The host picks the route by shape; both are hand kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr float EPS = 1e-12f;
constexpr int SMEM_MAX = 232448;  // 227 KB, the most one block may opt in to

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// JAX's rounding of one value: clip(round_half_even(v / s), -127, 127), the
// division correctly rounded. r = 1 / s rounded: v * r is within 2^-16 of
// v / s wherever the rounding matters (|v / s| < 128; past it both clip),
// and fl(v / s) within 2^-18, so both round to the same integer unless v * r
// lies within 2^-14 of a half-integer; those rare values take the division.
__device__ __forceinline__ uint32_t quantize(float v, float s, float r) {
  float q = __fmul_rn(v, r), f = rintf(q);
  if (fabsf(fabsf(__fsub_rn(q, f)) - 0.5f) < 0x1p-14f) f = rintf(__fdiv_rn(v, s));
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(f, -127.f), 127.f))) & 0xffu;
}
__device__ __forceinline__ uint32_t quantize4(const float (&v)[4], float s, float r) {
  return quantize(v[0], s, r) | (quantize(v[1], s, r) << 8) | (quantize(v[2], s, r) << 16) |
         (quantize(v[3], s, r) << 24);
}

// JAX's epilogue of one value: acc as f32, times (xs * ks), then + bias;
// each step rounded once (no contraction).
__device__ __forceinline__ float rescale(int acc, float scale, const float* bias, int co) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return bias != nullptr ? __fadd_rn(v, bias[co]) : v;
}

// ---- Q1s: the per-sample scale ----

constexpr int S_THREADS = 256;

// |v| of each float in a 16-byte piece, as unsigned bit patterns, maxed.
__device__ __forceinline__ uint32_t amax_bits(uint4 u, float*) {
  return max(max(u.x & 0x7fffffffu, u.y & 0x7fffffffu), max(u.z & 0x7fffffffu, u.w & 0x7fffffffu));
}
__device__ __forceinline__ uint32_t amax_bits(uint4 u, __nv_bfloat16*) {
  // a bf16's float is its 16 bits shifted up
  auto two = [](uint32_t w) { return max((w & 0x7fffu) << 16, w & 0x7fff0000u); };
  return max(max(two(u.x), two(u.y)), max(two(u.z), two(u.w)));
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS) act_scale_kernel(const T* __restrict__ x, float* __restrict__ xs,
                                                             unsigned* __restrict__ scratch, int rows,
                                                             int64_t row_len, int64_t s_n, int64_t s_h, int vec) {
  const int n = blockIdx.y;
  const T* xn = x + n * s_n;
  const int64_t stride = int64_t(gridDim.x) * S_THREADS;
  uint32_t m = 0;
  if (vec) {  // 16-byte pieces: rows of whole pieces, 16-byte aligned
    constexpr int V = 16 / sizeof(T);
    const int64_t per_row = row_len / V;
    for (int64_t i = int64_t(blockIdx.x) * S_THREADS + threadIdx.x; i < per_row * rows; i += stride) {
      const int64_t r = rows == 1 ? 0 : i / per_row;
      m = max(m, amax_bits(*reinterpret_cast<const uint4*>(xn + r * s_h + (i - r * per_row) * V),
                           static_cast<T*>(nullptr)));
    }
  } else {
    for (int64_t i = int64_t(blockIdx.x) * S_THREADS + threadIdx.x; i < row_len * rows; i += stride) {
      const int64_t r = rows == 1 ? 0 : i / row_len;
      m = max(m, __float_as_uint(load_f(xn + r * s_h + (i - r * row_len))) & 0x7fffffffu);
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ uint32_t warp_max[S_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < S_THREADS / 32; ++w) m = max(m, warp_max[w]);
  unsigned* sample_max = scratch + n;
  unsigned* done = scratch + gridDim.y + n;
  atomicMax(sample_max, m);
  __threadfence();
  if (atomicAdd(done, 1u) != gridDim.x - 1) return;
  // the sample's last block: every block's max is in; reset the scratch
  __threadfence();
  const float s = __fdiv_rn(__uint_as_float(atomicExch(sample_max, 0u)), 127.f);
  *done = 0;
  xs[n] = s < EPS ? EPS : s;  // a NaN max stays NaN, as torch's clamp_min
}

// ---- Q1, tensor-core route ----

constexpr int Q_TW = 16;                   // tile columns: one warp's 16 A rows
constexpr int Q_WGS = 2;                   // warpgroups per block
constexpr int Q_MW = 2;                    // m64 row groups per warpgroup
constexpr int Q_TH = 4 * Q_WGS * Q_MW;     // tile rows
constexpr int Q_THREADS = 128 * Q_WGS;
constexpr int Q_KSTEP = 32;                // input channels (bytes) of one wgmma k-step
constexpr int Q_TPS = 4;                   // k-steps per weight stage

__host__ __device__ constexpr int round1024(int b) { return (b + 1023) / 1024 * 1024; }

// KC input channels per chunk: 32, or 64 (two k-steps per tap: twice the
// products per wgmma batch; bf16 with k <= 5, where its halos fit).
template <typename T, int NT, int KC>
struct QCfg {
  static constexpr int KS = KC / Q_KSTEP;          // k-steps per tap
  static constexpr int K_MAX = KC == 64 ? 5 : 7;   // the largest kernel the shared memory holds
  static constexpr int STEP_BYTES = NT * Q_KSTEP;  // one k-step of B: NT rows of 32 bytes
  static constexpr int STAGE_BYTES = Q_TPS * STEP_BYTES;
  static constexpr int HALO_MAX = (Q_TH + K_MAX - 1) * (Q_TW + K_MAX - 1);
  static constexpr int FIT =
      (SMEM_MAX - 2 * round1024(HALO_MAX * KC * int(sizeof(T))) - 2 * round1024(HALO_MAX * KC) - 64 - 8 * NT) /
      STAGE_BYTES;
  // N tiles up to 48 keep a ring of 4 stages and 128 registers, so that two
  // blocks share an SM (the trunk's 48-channel convs: one block's staging
  // overlaps the other's products)
  static constexpr int MAX_STAGES = NT <= 48 ? 4 : 8;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int MIN_BLOCKS = NT <= 48 ? 2 : 1;
  // Stages are copied this many ahead: a stage is refilled once the last
  // batch that read it has retired (one batch of KS k-steps stays in
  // flight).
  static constexpr int DIST = STAGES - 1 - (KS + Q_TPS - 1) / Q_TPS;
  static_assert(STAGES >= 3 && DIST >= 1 && Q_TPS % KS == 0 && STAGE_BYTES % 256 == 0 &&
                    Q_TH * Q_TW * (NT * int(sizeof(T)) + 16) + STAGES * 8 + 8 * NT <= SMEM_MAX,
                "bad tile");
};

// The layout of one block's shared memory for kernel size k: two float
// halos, two int8 halos, the ring of weight stages (256-byte aligned for the
// swizzle); after the loop the same bytes hold the output tile (a padded row
// of NT channels per pixel). Then one mbarrier per stage, and the tile's
// rescale factors xs * ks and biases.
template <typename T, int NT, int KC>
struct QSmem {
  static constexpr int OUT_PITCH = NT * int(sizeof(T)) + 16;
  int halo_w, halo_px, fbuf, ibuf, ring, bars, coef, total;
  __host__ __device__ QSmem(int k) {
    halo_w = Q_TW + k - 1;
    halo_px = (Q_TH + k - 1) * halo_w;
    fbuf = round1024(halo_px * KC * int(sizeof(T)));
    ibuf = round1024(halo_px * KC);
    ring = 2 * fbuf + 2 * ibuf;
    const int pipe = ring + QCfg<T, NT, KC>::STAGES * QCfg<T, NT, KC>::STAGE_BYTES;
    const int out = Q_TH * Q_TW * OUT_PITCH;
    bars = pipe > out ? pipe : out;
    coef = bars + QCfg<T, NT, KC>::STAGES * 8;
    total = coef + 2 * NT * 4;
  }
};

// 16-byte piece c of int8 halo pixel p (KC bytes, KC / 16 pieces) sits at
// position c ^ ((p / (8 / pieces)) % pieces): 8 consecutive pixels then hit
// 8 distinct bank groups for every piece.
template <int KC>
__device__ __forceinline__ int ipos(int p, int c) {
  constexpr int CP = KC / 16;
  return c ^ ((p / (8 / CP)) % CP);
}

// A fragments of tap (dy, dx): for each m64 row group and k-step the warp's
// 16 pixels x 32 channels, from the int8 halo at `base`.
template <int KC>
__device__ __forceinline__ void load_a(uint32_t (&a)[Q_MW][KC / Q_KSTEP][4], uint32_t base, int halo_w, int dy,
                                       int dx, int wg, int warp, int lane) {
#pragma unroll
  for (int m = 0; m < Q_MW; ++m) {
    const int p = ((wg * Q_MW + m) * 4 + warp + dy) * halo_w + (lane & 15) + dx;
#pragma unroll
    for (int ks = 0; ks < KC / Q_KSTEP; ++ks)
      ldmatrix_x4(a[m][ks], base + p * KC + (ipos<KC>(p, 2 * ks + (lane >> 4)) << 4));
  }
}

// Issue the wgmma batch of iteration `it` (its KS k-steps) on the weight ring.
template <typename T, int NT, int KC>
__device__ __forceinline__ void mma_step(int (&acc)[Q_MW][NT / 2], const uint32_t (&a)[Q_MW][KC / Q_KSTEP][4],
                                         uint32_t ring_s, int it) {
  using C = QCfg<T, NT, KC>;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    const int step = it * C::KS + ks;
    const uint32_t b = ring_s + (step / Q_TPS % C::STAGES) * C::STAGE_BYTES + (step % Q_TPS) * C::STEP_BYTES;
    const uint64_t desc = desc_sw32_kmajor(b, 256);
#pragma unroll
    for (int m = 0; m < Q_MW; ++m) WgmmaS8<NT>::mma(acc[m], a[m][ks], desc, it > 0 || ks > 0);
  }
  wgmma_commit();
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

template <typename T, int NT, int KC>
__global__ void __launch_bounds__(Q_THREADS, QCfg<T, NT, KC>::MIN_BLOCKS) qconv_wgmma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wp, const float* __restrict__ xs,
    const float* __restrict__ ks, const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
    int Cout, int k, int64_t s_n, int64_t s_h, int tiles_w, int tiles_h, int vec) {
  using C = QCfg<T, NT, KC>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const QSmem<T, NT, KC> L(k);
  const uint32_t smem_s = smem_u32(smem), ibuf_s = smem_s + 2 * L.fbuf, ring_s = smem_s + L.ring,
                 bar_s = smem_s + L.bars;

  const int tile = blockIdx.x;
  const int tx = tile % tiles_w, ty = (tile / tiles_w) % tiles_h, img = tile / (tiles_w * tiles_h);
  const int y0 = ty * Q_TH, x0 = tx * Q_TW, n0 = blockIdx.y * NT;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kk = k * k, nchunks = (Cin + KC - 1) / KC, iters = nchunks * kk, steps = iters * C::KS;
  const int nstages = (steps + Q_TPS - 1) / Q_TPS;
  const int words = L.halo_px * (KC / 4);                        // 4-channel words of one int8 halo
  const int jobs = (words + Q_THREADS - 1) / Q_THREADS;          // of them per thread
  const int jobs_per_tap = (jobs + kk - 1) / kk;
  const float sx = xs[img], rx = __frcp_rn(sx);
  const T* xn = x + img * s_n;
  const int8_t* wt = wp + int64_t(blockIdx.y) * steps * C::STEP_BYTES;  // this N tile's k-steps

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(bar_s + s * 8, 1);
    fence_mbar_init();
  }
  // the epilogue's factors, in JAX's order: xs * ks rounded once, the bias
  float* coef = reinterpret_cast<float*>(smem + L.coef);
  for (int i = tid; i < NT; i += Q_THREADS) {
    const int co = n0 + i;
    coef[i] = co < Cout ? __fmul_rn(sx, ks[co]) : 0.f;
    coef[NT + i] = co < Cout && bias != nullptr ? bias[co] : 0.f;
  }
  __syncthreads();

  // The float halo of one chunk into float buffer `buf`: cp.async pieces of
  // `vec` bytes (16 or 4), zero-filled outside the image and past Cin; with
  // vec 0 element by element (a layout no piece fits).
  auto issue_halo = [&](int chunk, int buf) {
    const int c0 = chunk * KC;
    if (vec) {
      const int cpp = vec / int(sizeof(T)), ppx = KC / cpp;  // channels per piece, pieces per pixel
      for (int idx = tid; idx < L.halo_px * ppx; idx += Q_THREADS) {
        const int p = idx / ppx, ch = c0 + (idx - p * ppx) * cpp;
        const int gy = y0 + p / L.halo_w - k / 2, gx = x0 + p % L.halo_w - k / 2;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < Cin;
        const T* src = ok ? xn + gy * s_h + int64_t(gx) * Cin + ch : x;
        const uint32_t dst = smem_s + buf * L.fbuf + (p * KC + ch - c0) * int(sizeof(T));
        if (vec == 16)
          cp_async16(dst, src, ok);
        else
          cp_async_small<4>(dst, src, ok);
      }
    } else {
      T* fbuf = reinterpret_cast<T*>(smem + buf * L.fbuf);
      for (int idx = tid; idx < L.halo_px * KC; idx += Q_THREADS) {
        const int p = idx / KC, ch = c0 + idx % KC;
        const int gy = y0 + p / L.halo_w - k / 2, gx = x0 + p % L.halo_w - k / 2;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < Cin;
        fbuf[idx] = ok ? xn[gy * s_h + int64_t(gx) * Cin + ch] : from_float<T>(0.f);
      }
    }
  };
  // Quantize this thread's words job .. job + count - 1 of float halo `buf`
  // into int8 halo `buf`: word idx is pixel idx / (KC / 4), channels 4
  // (idx % (KC / 4)) .. + 3, placed by ipos.
  auto quantize_halo = [&](int buf, int job, int count) {
    const T* src = reinterpret_cast<const T*>(smem + buf * L.fbuf);
    unsigned char* dst = smem + 2 * L.fbuf + buf * L.ibuf;
    for (int j = job; j < job + count && j < jobs; ++j) {
      const int idx = tid + j * Q_THREADS;
      if (idx >= words) break;
      const int p = idx / (KC / 4), w = idx % (KC / 4);
      float v[4];
      load4(src + p * KC + 4 * w, v);
      *reinterpret_cast<uint32_t*>(dst + p * KC + (ipos<KC>(p, w >> 2) << 4) + (w & 3) * 4) = quantize4(v, sx, rx);
    }
  };
  // Weight stage st (k-steps st * TPS ..): one bulk copy on its mbarrier.
  auto issue_w = [&](int st) {
    const int first = st * Q_TPS, n = min(Q_TPS, steps - first);
    const uint32_t bar = bar_s + (st % C::STAGES) * 8, bytes = n * C::STEP_BYTES;
    mbar_arrive_expect_tx(bar, bytes);
    bulk_copy_g2s(ring_s + (st % C::STAGES) * C::STAGE_BYTES, wt + int64_t(first) * C::STEP_BYTES, bytes, bar);
  };

  int acc[Q_MW][NT / 2];  // set by the first wgmma (acc 0): no zeroing moves
  uint32_t a0[Q_MW][C::KS][4], a1[Q_MW][C::KS][4];

  // Prologue: the first DIST weight stages; the first two chunks' float
  // halos; the first quantized whole while the second lands; the third
  // chunk's halo in flight. Chunk c's float halo sits in float buffer c & 1 and its int8
  // halo in int8 buffer c & 1.
  if (tid == 0)
    for (int s = 0; s < C::DIST && s < nstages; ++s) issue_w(s);
  issue_halo(0, 0);
  cp_async_commit();
  if (nchunks > 1) issue_halo(1, 1);
  cp_async_commit();
  cp_async_wait<1>();  // the first chunk's halo; the second's lands while it is quantized
  __syncthreads();
  quantize_halo(0, 0, jobs);
  cp_async_wait<0>();
  __syncthreads();
  if (nchunks > 2) issue_halo(2, 0);
  cp_async_commit();
  load_a<KC>(a0, ibuf_s, L.halo_w, 0, 0, wg, warp, lane);

  // One iteration is one tap (dy, dx) of one chunk c, KS k-steps, counted
  // without divisions. At a stage's first k-step: a block barrier (every
  // warpgroup is done with the stage about to be refilled), the copy of the
  // stage DIST ahead, and the wait for this stage's bytes. Every iteration:
  // start the wgmma batch, let the previous batch retire, quantize this
  // tap's share of chunk c + 1's halo. Into a new chunk: wait for the float
  // halo of the chunk after it and for the block (chunk c + 1's int8 halo is
  // whole, chunk c's float buffer free), and start the copy of chunk c + 2's
  // halo into that buffer. Then load the next tap's A into the registers
  // the retired batch read.
  int c = 0, dy = 0, dx = 0, job = 0;
#define Q1_STEP(IT, CUR, NXT)                                                                          \
  {                                                                                                    \
    if ((IT) * C::KS % Q_TPS == 0) {                                                                   \
      const int st = (IT) * C::KS / Q_TPS;                                                             \
      __syncthreads();                                                                                 \
      if (tid == 0 && st + C::DIST < nstages) issue_w(st + C::DIST);                                   \
      mbar_wait(bar_s + st % C::STAGES * 8, st / C::STAGES & 1);                                       \
    }                                                                                                  \
    mma_step<T, NT, KC>(acc, CUR, ring_s, (IT));                                                       \
    wgmma_wait<1>();                                                                                   \
    if (c + 1 < nchunks) {                                                                             \
      quantize_halo((c + 1) & 1, job, jobs_per_tap);                                                   \
      job += jobs_per_tap;                                                                             \
    }                                                                                                  \
    if (++dx == k) {                                                                                   \
      dx = 0;                                                                                          \
      if (++dy == k) {                                                                                 \
        dy = 0;                                                                                        \
        job = 0;                                                                                       \
        if (++c < nchunks) {                                                                           \
          cp_async_wait<0>();                                                                          \
          __syncthreads();                                                                             \
          if (c + 2 < nchunks) issue_halo(c + 2, c & 1);                                               \
          cp_async_commit();                                                                           \
        }                                                                                              \
      }                                                                                                \
    }                                                                                                  \
    if ((IT) + 1 < iters) load_a<KC>(NXT, ibuf_s + (c & 1) * L.ibuf, L.halo_w, dy, dx, wg, warp, lane); \
  }
#pragma unroll 1
  for (int it = 0; it < iters; it += 2) {
    Q1_STEP(it, a0, a1)
    if (it + 1 < iters) Q1_STEP(it + 1, a1, a0)
  }
#undef Q1_STEP
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < Q_MW; ++m) fence_operands(acc[m]);

  // Epilogue: acc[m][4q + 2h + e] is pixel (prow, g + 8h), channel 8q + 2t
  // + e. Rescaled and rounded into the output tile in shared memory (every
  // warp is done with the halos and the ring), then stored in 16-byte pieces
  // (a pixel's NT channels are contiguous in NHWC), or element by element
  // when a pixel's Cout channels are not whole pieces.
  __syncthreads();
  using Q = QSmem<T, NT, KC>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < Q_MW; ++m) {
    const int prow = (wg * Q_MW + m) * 4 + warp;
#pragma unroll
    for (int q = 0; q < NT / 8; ++q) {
      const int col = 8 * q + 2 * t;
      const float k0 = coef[col], k1 = coef[col + 1], b0 = coef[NT + col], b1 = coef[NT + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fmul_rn(__int2float_rn(acc[m][4 * q + 2 * h]), k0);
        float v1 = __fmul_rn(__int2float_rn(acc[m][4 * q + 2 * h + 1]), k1);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        store_pair(reinterpret_cast<T*>(smem + (prow * Q_TW + g + 8 * h) * Q::OUT_PITCH) + col, v0, v1);
      }
    }
  }
  __syncthreads();
  const int nvalid = min(NT, Cout - n0);
  if ((Cout * int(sizeof(T))) % 16 == 0) {
    constexpr int PIECES = NT * int(sizeof(T)) / 16, PER = 16 / int(sizeof(T));
    for (int idx = tid; idx < Q_TH * Q_TW * PIECES; idx += Q_THREADS) {
      const int p = idx / PIECES, c = idx % PIECES;
      const int oy = y0 + p / Q_TW, ox = x0 + p % Q_TW;
      if (oy < H && ox < W && c * PER < nvalid)
        *reinterpret_cast<uint4*>(y + ((int64_t(img) * H + oy) * W + ox) * Cout + n0 + c * PER) =
            *reinterpret_cast<const uint4*>(smem + p * Q::OUT_PITCH + c * 16);
    }
  } else {
    for (int idx = tid; idx < Q_TH * Q_TW * NT; idx += Q_THREADS) {
      const int p = idx / NT, c = idx % NT;
      const int oy = y0 + p / Q_TW, ox = x0 + p % Q_TW;
      if (oy < H && ox < W && c < nvalid)
        y[((int64_t(img) * H + oy) * W + ox) * Cout + n0 + c] =
            reinterpret_cast<const T*>(smem + p * Q::OUT_PITCH)[c];
    }
  }
}

template <typename T, int NT, int KC>
cudaError_t launch_wgmma(const T* x, const int8_t* wp, const float* xs, const float* ks, const float* bias, T* y,
                         int n, int h, int wd, int cin, int cout, int k, int64_t s_n, int64_t s_h, int vec,
                         cudaStream_t s) {
  using C = QCfg<T, NT, KC>;
  if (k > C::K_MAX) return cudaErrorInvalidValue;
  const QSmem<T, NT, KC> L(k);
  static unsigned opted_in = 0;  // the devices this kernel may take K_MAX's shared memory on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(opted_in >> dev & 1u)) {
    err = cudaFuncSetAttribute(qconv_wgmma_kernel<T, NT, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               QSmem<T, NT, KC>(C::K_MAX).total);
    if (err != cudaSuccess) return err;
    if (dev < 32) opted_in |= 1u << dev;
  }
  const int tiles_w = (wd + Q_TW - 1) / Q_TW, tiles_h = (h + Q_TH - 1) / Q_TH;
  dim3 grid(tiles_w * tiles_h * n, (cout + NT - 1) / NT);
  qconv_wgmma_kernel<T, NT, KC><<<grid, Q_THREADS, L.total, s>>>(x, wp, xs, ks, bias, y, h, wd, cin, cout, k, s_n,
                                                                 s_h, tiles_w, tiles_h, vec);
  return cudaGetLastError();
}

// ---- Q1, CUDA-core route ----

constexpr int TH = 8, TW = 16, THREADS = TH * TW;
constexpr int CHUNK = 16;  // input channels per staged chunk (4 words)
constexpr int WORDS = CHUNK / 4;
constexpr int PIX_STRIDE = WORDS + 1;

// The (tile + k - 1)-halo of one chunk, quantized as it is read: 4 channels
// a word, the lowest in its low byte; zero outside the image and past Cin.
template <int K, typename T>
__device__ __forceinline__ void stage_input(int* s_in, const T* __restrict__ xn, float sx, float rx, int h, int wd,
                                            int cin, int64_t s_h, int c0, int y0, int x0) {
  constexpr int HH = TH + K - 1, HW = TW + K - 1;
  for (int i = threadIdx.x; i < HH * HW * WORDS; i += THREADS) {
    const int g = i % WORDS, p = i / WORDS;
    const int gy = y0 + p / HW - K / 2, gx = x0 + p % HW - K / 2;
    const int c = c0 + 4 * g;
    uint32_t u = 0;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd && c < cin) {
      const T* src = xn + gy * s_h + int64_t(gx) * cin + c;
      for (int j = 0; j < 4 && c + j < cin; ++j) u |= quantize(load_f(src + j), sx, rx) << (8 * j);
    }
    s_in[p * PIX_STRIDE + g] = static_cast<int>(u);
  }
}

template <int K, int CO_T, typename T>
__global__ void __launch_bounds__(THREADS) qconv_dp4a_kernel(
    const T* __restrict__ x, const int* __restrict__ wp, const float* __restrict__ xs, const float* __restrict__ ks,
    const float* __restrict__ bias, T* __restrict__ y, int h, int wd, int cin, int cout, int64_t s_n, int64_t s_h,
    int tiles_w, int tiles_h, int chunks) {
  constexpr int HW = TW + K - 1;
  constexpr int IN_WORDS = (TH + K - 1) * HW * PIX_STRIDE;
  constexpr int W_WORDS = K * K * WORDS * CO_T;
  __shared__ __align__(16) int s_in[IN_WORDS];
  __shared__ __align__(16) int s_w[W_WORDS];

  const int tile = blockIdx.x;
  const int n = tile / (tiles_w * tiles_h);
  const int ty0 = (tile / tiles_w) % tiles_h * TH, tx0 = tile % tiles_w * TW;
  const int cot = blockIdx.y;
  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const float sx = xs[n], rx = __frcp_rn(sx);

  int acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = 0;

  const int4* wsrc = reinterpret_cast<const int4*>(wp + static_cast<int64_t>(cot) * chunks * W_WORDS);
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();
    stage_input<K>(s_in, x + n * s_n, sx, rx, h, wd, cin, s_h, ch * CHUNK, ty0, tx0);
    for (int i = threadIdx.x; i < W_WORDS / 4; i += THREADS)
      reinterpret_cast<int4*>(s_w)[i] = wsrc[static_cast<int64_t>(ch) * (W_WORDS / 4) + i];
    __syncthreads();
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int* px = s_in + ((ty + ky) * HW + tx + kx) * PIX_STRIDE;
#pragma unroll
        for (int g = 0; g < WORDS; ++g) {
          const int a = px[g];
          const int4* wv = reinterpret_cast<const int4*>(s_w + ((ky * K + kx) * WORDS + g) * CO_T);
#pragma unroll
          for (int q = 0; q < CO_T / 4; ++q) {
            const int4 w4 = wv[q];
            acc[4 * q + 0] = __dp4a(a, w4.x, acc[4 * q + 0]);
            acc[4 * q + 1] = __dp4a(a, w4.y, acc[4 * q + 1]);
            acc[4 * q + 2] = __dp4a(a, w4.z, acc[4 * q + 2]);
            acc[4 * q + 3] = __dp4a(a, w4.w, acc[4 * q + 3]);
          }
        }
      }
    }
  }

  const int oy = ty0 + ty, ox = tx0 + tx;
  if (oy >= h || ox >= wd) return;
  const int64_t base = ((static_cast<int64_t>(n) * h + oy) * wd + ox) * cout;
#pragma unroll
  for (int j = 0; j < CO_T; ++j) {
    const int co = cot * CO_T + j;
    if (co >= cout) break;
    y[base + co] = from_float<T>(rescale(acc[j], __fmul_rn(sx, ks[co]), bias, co));
  }
}

template <int K, int CO_T, typename T>
cudaError_t launch_k(const T* x, const int* wp, const float* xs, const float* ks, const float* bias, T* y, int n,
                     int h, int wd, int cin, int cout, int64_t s_n, int64_t s_h, cudaStream_t s) {
  const int tiles_w = (wd + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const int chunks = (cin + CHUNK - 1) / CHUNK;
  dim3 grid(tiles_w * tiles_h * n, (cout + CO_T - 1) / CO_T);
  qconv_dp4a_kernel<K, CO_T, T><<<grid, THREADS, 0, s>>>(x, wp, xs, ks, bias, y, h, wd, cin, cout, s_n, s_h, tiles_w,
                                                         tiles_h, chunks);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_co(int co_t, const T* x, const int* wp, const float* xs, const float* ks, const float* bias, T* y,
                      int n, int h, int wd, int cin, int cout, int64_t s_n, int64_t s_h, cudaStream_t s) {
  switch (co_t) {
    case 8: return launch_k<K, 8>(x, wp, xs, ks, bias, y, n, h, wd, cin, cout, s_n, s_h, s);
    case 16: return launch_k<K, 16>(x, wp, xs, ks, bias, y, n, h, wd, cin, cout, s_n, s_h, s);
    case 32: return launch_k<K, 32>(x, wp, xs, ks, bias, y, n, h, wd, cin, cout, s_n, s_h, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_typed(const T* x, const void* wp, const float* xs, const float* ks, const float* bias, T* y, int n,
                         int h, int wd, int cin, int cout, int k, int64_t s_n, int64_t s_h, int tile,
                         int tensor_cores, int kc, int vec, cudaStream_t s) {
  if (tensor_cores) {
    if (k != 1 && k != 3 && k != 5 && k != 7) return cudaErrorInvalidValue;
    auto w8 = static_cast<const int8_t*>(wp);
#define Q1_LAUNCH(NT, KC) launch_wgmma<T, NT, KC>(x, w8, xs, ks, bias, y, n, h, wd, cin, cout, k, s_n, s_h, vec, s)
    if (kc == 64) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (tile == 64) return Q1_LAUNCH(64, 64);
        if (tile == 128) return Q1_LAUNCH(128, 64);
      }
      return cudaErrorInvalidValue;
    }
    if (kc != 32) return cudaErrorInvalidValue;
    switch (tile) {
      case 8: return Q1_LAUNCH(8, 32);
      case 16: return Q1_LAUNCH(16, 32);
      case 24: return Q1_LAUNCH(24, 32);
      case 32: return Q1_LAUNCH(32, 32);
      case 48: return Q1_LAUNCH(48, 32);
      case 64: return Q1_LAUNCH(64, 32);
      case 128: return Q1_LAUNCH(128, 32);
      default: return cudaErrorInvalidValue;
    }
#undef Q1_LAUNCH
  }
  auto w = static_cast<const int*>(wp);
  switch (k) {
    case 1: return launch_co<1>(tile, x, w, xs, ks, bias, y, n, h, wd, cin, cout, s_n, s_h, s);
    case 3: return launch_co<3>(tile, x, w, xs, ks, bias, y, n, h, wd, cin, cout, s_n, s_h, s);
    case 5: return launch_co<5>(tile, x, w, xs, ks, bias, y, n, h, wd, cin, cout, s_n, s_h, s);
    case 7: return launch_co<7>(tile, x, w, xs, ks, bias, y, n, h, wd, cin, cout, s_n, s_h, s);
    default: return cudaErrorInvalidValue;
  }
}

// Q1s on `s`: the grid over each sample's elements (about 8 pieces a
// thread, at most ~8 blocks per SM in all).
cudaError_t launch_act_scale(const void* x, float* xs, unsigned* scratch, int n, int h, int wd, int c, int64_t s_n,
                             int64_t s_h, int is_bf16, cudaStream_t s) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || n > 65535) return cudaErrorInvalidValue;
  const int es = is_bf16 ? 2 : 4, v = 16 / es;
  int64_t row = int64_t(wd) * c;
  if (h == 1 || s_h == row) {  // the sample is one contiguous run
    row *= h;
    h = 1;
  }
  const bool vec = row % v == 0 && (h == 1 || s_h % v == 0) && (n == 1 || s_n % v == 0) &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int64_t pieces = row * h / (vec ? v : 1);
  const int64_t want = (pieces + S_THREADS * 8 - 1) / (S_THREADS * 8), cap = 132 * 8 / n;
  dim3 grid(unsigned(want < 1 ? 1 : want > cap ? (cap < 1 ? 1 : cap) : want), n);
  if (is_bf16)
    act_scale_kernel<<<grid, S_THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x), xs, scratch, h, row, s_n, s_h,
                                                vec);
  else
    act_scale_kernel<<<grid, S_THREADS, 0, s>>>(static_cast<const float*>(x), xs, scratch, h, row, s_n, s_h, vec);
  return cudaGetLastError();
}

}  // namespace

// Q1s. x (N, H, W, C) f32, or bf16 when is_bf16, with element strides s_n,
// s_h and W, C dense (a row of W * C contiguous elements); xs (N,) f32 out;
// scratch 2N uint32 words, zero before the call and zero after it.
extern "C" int act_scale_launch(const void* x, void* xs, void* scratch, int n, int h, int wd, int c, long long s_n,
                                long long s_h, int is_bf16, void* stream) {
  return int(launch_act_scale(x, static_cast<float*>(xs), static_cast<unsigned*>(scratch), n, h, wd, c, s_n, s_h,
                              is_bf16, static_cast<cudaStream_t>(stream)));
}

// Q1, after Q1s when `scratch` is not null (then xs is Q1s's output). x as
// for Q1s; wp the packed weight (kernels/qconv_int8.py::pack_weights:
// K-major int8 k-steps in N tiles of `tile` and chunks of kc channels on the
// tensor cores, int32 words in output-channel tiles of `tile` on the CUDA
// cores); xs (N,), ks
// (Cout,) and bias (Cout,) or null, f32; y (N, H, W, Cout) contiguous, x's
// type. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after each launch.
extern "C" int qconv_int8_launch(const void* x, const void* wp, void* xs, void* scratch, const void* ks,
                                 const void* bias, void* y, int n, int h, int wd, int cin, int cout, int k,
                                 long long s_n, long long s_h, int tile, int tensor_cores, int kc, int is_bf16,
                                 void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fxs = static_cast<float*>(xs);
  if (scratch != nullptr) {
    const cudaError_t err = launch_act_scale(x, fxs, static_cast<unsigned*>(scratch), n, h, wd, cin, s_n, s_h,
                                             is_bf16, s);
    if (err != cudaSuccess) return int(err);
  }
  auto fks = static_cast<const float*>(ks), fb = static_cast<const float*>(bias);
  const int es = is_bf16 ? 2 : 4;
  const auto fits = [&](int b) {  // cp.async pieces of b bytes: whole pieces a pixel, aligned rows
    return (cin * es) % b == 0 && (h == 1 || (s_h * es) % b == 0) && (n == 1 || (s_n * es) % b == 0) &&
           reinterpret_cast<uintptr_t>(x) % b == 0;
  };
  const int vec = fits(16) ? 16 : fits(4) ? 4 : 0;
  if (is_bf16)
    return int(launch_typed(static_cast<const __nv_bfloat16*>(x), wp, fxs, fks, fb, static_cast<__nv_bfloat16*>(y),
                            n, h, wd, cin, cout, k, s_n, s_h, tile, tensor_cores, kc, vec, s));
  return int(launch_typed(static_cast<const float*>(x), wp, fxs, fks, fb, static_cast<float*>(y), n, h, wd, cin,
                          cout, k, s_n, s_h, tile, tensor_cores, kc, vec, s));
}
