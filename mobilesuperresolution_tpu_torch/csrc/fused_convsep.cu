// Kernel B5: the fused separable conv of the NAS supernet's ConvSep branch,
//   y = relu(depthwise_KxK(x) + b_d) . W_p + b_p,
// with the depthwise output kept in registers, never in device memory.
//
// Replaces the Pallas kernel mobilesuperresolution_tpu/kernels/
// fused_convsep.py::fused_convsep (depthwise KxK SAME + bias, ReLU, 1x1
// C -> C_out + bias, f32 accumulate). At the search's shape, (16, 48, 48, 32)
// -> 32 with K = 7, one launch moves 9.4 MB and does 0.19 GFLOP (5,184 FLOP
// per pixel: 2 K^2 C depthwise + 2 C C_out pointwise), a 2.8 us bound that
// launch overhead exceeds; at the supernet's eval shape (1, 678, 1020, 32)
// the bytes (177 MB) and the f32 operations (3.6 GFLOP) both bound it near
// 53 us. An unfused chain writes and reads the C-channel depthwise output.
//
// Design: persistent blocks of 8 warps, each block walking 8 x 32 output
// tiles, one warp per tile row.
// - Halo: the next tile's (8 + K - 1) x (32 + K - 1) input halo is copied
//   channel-interleaved (NHWC, as it lies in memory) by cp.async, 16 bytes
//   per copy where trap (b)'s swizzle applies, else in pairs of channels
//   (8 bytes f32, 4 bytes bf16; zero-filled outside the image and past C),
//   into the second of two buffers while this tile computes (one buffer
//   where two would cost the second block on the SM, as at K = 7, which then
//   overlaps the copies). Odd C stage by plain loads.
// - Weights: each block stages the depthwise taps and biases (zero-padded to
//   the k-step) and W_p, which it packs itself into mma B-fragment order
//   (TF32 hi/lo split for f32), once: they change every search step, so
//   nothing is packed on the host.
// - Depthwise, register-blocked: lane (g, t) computes 4 consecutive pixels
//   (4g .. 4g + 3 of its warp's row) for 2 channels per 8, sliding a
//   (K + 3)-pixel window through registers: (K + 3) / (4K) shared loads per
//   FMA instead of one.
// - 1x1 on mma.sync: the two m16 tiles of a warp take rows g and g + 8 as
//   pixels (4g, 4g + 1) and (4g + 2, 4g + 3), so the ReLU'd depthwise values
//   a lane holds are its A fragments as they lie (hopper.cuh's element view):
//   3xTF32 for f32 I/O, bf16 for bf16 I/O, f32 accumulate; + b_p in the
//   epilogue, stored 8 (f32) or 4 (bf16) bytes per lane and pixel.
// Widths: any C and C_out from 1 to 64 (the supernet's C = C_out = units),
// K in {3, 5, 7}; C_out is compiled for 16, 32 and 64 accumulator columns.
//
// Traps:
// (a) Any H and W: the Pallas kernel asserts H % tile == 0 and materialises
//     overlapping row windows in HBM, both TPU layout rules. Here the halo
//     comes from global memory with a bounds check and ragged tiles mask
//     their stores (678 rows of a DIV2K validation image at x2).
// (b) Bank conflicts: a warp's window loads are pixels 4g + i, channels
//     2t, 2t + 1. Staged by pairs, a pixel stride of = 2 (mod 4) words (f32)
//     or an odd number of words (bf16) puts the 8 g on distinct banks. Staged
//     by 16-byte chunks (f32, C a multiple of 4, channels padded to 32 or 64:
//     the main path), the stride is the 128-byte-aligned channel count and
//     chunk q of a pixel in column col sits at q ^ 2((col / 4) mod 4): the
//     four g of a half-warp then read four different chunk pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int TH = 8, TW = 32;  // output tile: one warp per row, 4 pixels per lane group
constexpr int THREADS = 32 * TH;
constexpr int SMEM_MAX = 232448;      // per block
constexpr size_t SMEM_PER_SM = 233472;  // per SM, 1 KB of it reserved per block

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }


// Shared-memory plan of one launch (host-computed, passed by value).
struct Plan {
  int kc;       // channels padded to the k-step
  int ps;       // halo pixel stride, elements
  int cu;       // elements per staging copy: 4 (16 bytes, swizzled), 2 (a pair) or 1 (plain loads)
  int nbuf;     // halo buffers: 2 (prefetch) or 1
  int halo_el;  // elements per halo buffer
  int wfloats;  // floats before the halo: packed W_p, b_p, depthwise taps, b_d
};

template <typename T, int K, int NT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) convsep_kernel(
    const T* __restrict__ x, const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ wp, const float* __restrict__ bp, T* __restrict__ y, int H, int W, int C,
    int CO, int tiles_w, int tiles_h, int ntiles, Plan pl) {
  using P = typename PolicyOf<T>::type;
  constexpr int KG = P::KG, BW = P::BW, PAD = K / 2;
  constexpr int HH = TH + K - 1, HW = TW + K - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KC = pl.kc, PS = pl.ps, S = KC / KG;
  float* wps = reinterpret_cast<float*>(smem);  // [S][NT][32][BW]
  float* bps = wps + S * NT * 32 * BW;          // [NT * 8]
  float* wds = bps + NT * 8;                    // [K*K][KC]
  float* bds = wds + K * K * KC;                // [KC]
  T* halo = reinterpret_cast<T*>(reinterpret_cast<float*>(smem) + pl.wfloats);  // [nbuf][HH * HW][PS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (blockIdx.x >= ntiles) return;

  // weights, once per block
  for (int i = tid; i < S * NT * 32; i += THREADS) {
    const int l = i % 32, j = (i / 32) % NT, s = i / (32 * NT), n = 8 * j + (l >> 2);
    P::pack_b(wps + i * BW, [&](int k) { return (k < C && n < CO) ? wp[k * CO + n] : 0.f; }, s, l & 3);
  }
  for (int i = tid; i < NT * 8; i += THREADS) bps[i] = i < CO ? bp[i] : 0.f;
  for (int i = tid; i < K * K * KC; i += THREADS) {
    const int c = i % KC;
    wds[i] = c < C ? wd[(i / KC) * C + c] : 0.f;
  }
  for (int i = tid; i < KC; i += THREADS) bds[i] = i < C ? bd[i] : 0.f;

  // halo staging: this thread copies copy unit `unit` (cu channels) of halo
  // columns col0, col0 + col_step, ..., every row of each. With 16-byte
  // units the 4-channel chunk q of a pixel in column col sits at chunk
  // q ^ swz(col) (trap (b)); the mask `swm` is 0 for the other layouts.
  const int cu = pl.cu, swm = cu == 4 ? 6 : 0;
  const int units = KC / cu;
  const int unit = tid % units, col0 = tid / units, col_step = THREADS / units;
  auto swz = [&](int col) { return (((col >> 2) & 3) << 1) & swm; };
  const T zero = from_float<T>(0.f);
  auto decode = [&](int tile, int& img, int& y0, int& x0) {
    const int tx = tile % tiles_w, ty = (tile / tiles_w) % tiles_h;
    img = tile / (tiles_w * tiles_h);
    y0 = ty * TH;
    x0 = tx * TW;
  };
  auto stage = [&](int buf, int tile) {
    int img, y0, x0;
    decode(tile, img, y0, x0);
    if (tid >= col_step * units) return;
    const int c = cu * unit;
    for (int col = col0; col < HW; col += col_step) {
      const int gx = x0 - PAD + col;
      const bool col_ok = gx >= 0 && gx < W && c < C;
      const T* src = x + (size_t(img) * H * W + (col_ok ? gx : 0)) * C + c;
      T* dst = halo + buf * pl.halo_el + col * PS + (cu == 4 ? 4 * (unit ^ swz(col)) : c);
#pragma unroll
      for (int r = 0; r < HH; ++r) {
        const int gy = y0 - PAD + r;
        const bool ok = col_ok && gy >= 0 && gy < H;
        const T* sp = ok ? src + size_t(gy) * W * C : x;
        if (cu == 4) {
          cp_async16(smem_u32(dst + r * HW * PS), sp, ok);
        } else if (cu == 2) {
          cp_async_small<2 * sizeof(T)>(smem_u32(dst + r * HW * PS), sp, ok);
        } else {
          dst[r * HW * PS] = ok ? *sp : zero;
        }
      }
    }
  };

  const int first = blockIdx.x;
  stage(0, first);
  cp_async_commit();
  for (int tile = first, it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int buf = pl.nbuf == 2 ? (it & 1) : 0;
    if (pl.nbuf == 2 && tile + gridDim.x < ntiles) {
      stage(buf ^ 1, tile + gridDim.x);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* hb = halo + buf * pl.halo_el;
    int img, y0, x0;
    decode(tile, img, y0, x0);

    float acc[2][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = bps[8 * j + 2 * t], b1 = bps[8 * j + 2 * t + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[mt][j][0] = acc[mt][j][2] = b0;
        acc[mt][j][1] = acc[mt][j][3] = b1;
      }
    }
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      float v[2][KG / 2];  // element views of the two m16 tiles
#pragma unroll
      for (int pp = 0; pp < KG / 8; ++pp) {
        const int ch = KG * s + 8 * pp + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(bds + ch);
        float2 d[4] = {b, b, b, b};
        // where the pair lies in pixels of columns 4g + 4j .. 4g + 4j + 3
        int at[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) at[j] = (((ch >> 2) ^ swz(4 * (g + j))) << 2) + (ch & 3);
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const T* row = hb + ((warp + ky) * HW + 4 * g) * PS;
          float2 win[K + 3];
#pragma unroll
          for (int i = 0; i < K + 3; ++i) win[i] = load_pair(row + i * PS + at[i / 4]);
          const float* wrow = wds + ky * K * KC + ch;
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const float2 w = *reinterpret_cast<const float2*>(wrow + kx * KC);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              d[r].x = fmaf(win[r + kx].x, w.x, d[r].x);
              d[r].y = fmaf(win[r + kx].y, w.y, d[r].y);
            }
          }
        }
        // tile 0: rows g, g + 8 = pixels 4g, 4g + 1; tile 1: 4g + 2, 4g + 3
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          v[mt][4 * pp + 0] = fmaxf(d[2 * mt].x, 0.f);
          v[mt][4 * pp + 1] = fmaxf(d[2 * mt].y, 0.f);
          v[mt][4 * pp + 2] = fmaxf(d[2 * mt + 1].x, 0.f);
          v[mt][4 * pp + 3] = fmaxf(d[2 * mt + 1].y, 0.f);
        }
      }
      const typename P::A a0 = P::make_a(v[0]), a1 = P::make_a(v[1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const typename P::B b = P::load_b(wps + ((s * NT + j) * 32 + lane) * BW);
        P::mma(acc[0][j], a0, b);
        P::mma(acc[1][j], a1, b);
      }
    }

    const int oy = y0 + warp;
    const bool pairs = CO % 2 == 0;
    if (oy < H) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ox = x0 + 4 * g + 2 * mt + h;
          if (ox >= W) continue;  // trap (a)
          T* out = y + ((size_t(img) * H + oy) * W + ox) * CO;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int ch = 8 * j + 2 * t;
            if (ch >= CO) continue;
            if (pairs) {
              store_pair(out + ch, acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
            } else {
              out[ch] = from_float<T>(acc[mt][j][2 * h]);
              if (ch + 1 < CO) out[ch + 1] = from_float<T>(acc[mt][j][2 * h + 1]);
            }
          }
        }
    }
    __syncthreads();  // this halo buffer is free for the next tiles
    if (pl.nbuf == 1 && tile + gridDim.x < ntiles) {
      stage(0, tile + gridDim.x);
      cp_async_commit();
    }
  }
}

// Per-instantiation launch state: the opted-in shared memory and the grid
// for a shared-memory size, kept so that a call costs one launch (the search
// launches this kernel 48 times per forward at a host-bound shape).
struct LaunchCache {
  int smem_set = 0;
  int smem_for_grid = -1;
  int grid_per_sm = 0;
};

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks per SM a launch aims for: two (16 warps) where 128 registers a
// thread hold the accumulators without spills, else one.
__host__ __device__ constexpr int blocks_per_sm(int nt, int k, bool bf16) { return nt <= 4 && !(bf16 && k == 7) ? 2 : 1; }

template <typename T, int K, int NT, int MINB = blocks_per_sm(NT, K, sizeof(T) == 2)>
cudaError_t launch(const void* x, const float* wd, const float* bd, const float* wp, const float* bp, void* y,
                   int n, int h, int w, int c, int co, cudaStream_t stream) {
  using P = typename PolicyOf<T>::type;
  static LaunchCache cache;
  Plan pl;
  pl.kc = round_up(c, P::KG);
  // trap (b): kc is a multiple of 8 (f32) or 16 (bf16) elements, so kc + 2
  // is = 2 (mod 4) f32 words, or an odd number of words in bf16
  pl.ps = pl.kc + 2;
  pl.cu = c % 2 ? 1 : 2;
  if (sizeof(T) == 4 && c % 4 == 0 && pl.kc % 32 == 0) {
    // 16-byte copies (half the copy requests of pairs); the pixel stride is
    // then a multiple of 128 bytes and the chunk swizzle keeps the window
    // reads conflict-free
    pl.cu = 4;
    pl.ps = pl.kc;
  }
  pl.wfloats = (pl.kc / P::KG) * NT * 32 * P::BW + NT * 8 + K * K * pl.kc + pl.kc;
  const size_t halo_bytes = round_up((TH + K - 1) * (TW + K - 1) * pl.ps * int(sizeof(T)), 16);
  pl.halo_el = int(halo_bytes / sizeof(T));
  // two halo buffers (prefetch) if MINB blocks still fit on an SM, else one
  // (the other block on the SM overlaps the copies), else whatever fits
  const size_t fixed = size_t(pl.wfloats) * 4, budget = SMEM_PER_SM / MINB - 1024;
  pl.nbuf = fixed + 2 * halo_bytes <= budget ? 2 : fixed + halo_bytes <= budget ? 1
            : fixed + 2 * halo_bytes <= size_t(SMEM_MAX) ? 2 : 1;
  const int smem = int(fixed + pl.nbuf * halo_bytes);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = convsep_kernel<T, K, NT, MINB>;
  cudaError_t err;
  if (smem > cache.smem_set) {
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return err;
    cache.smem_set = smem;
  }
  if (smem != cache.smem_for_grid) {
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem)) != cudaSuccess)
      return err;
    cache.grid_per_sm = std::max(per_sm, 1);
    cache.smem_for_grid = smem;
  }
  const int tiles_w = (w + TW - 1) / TW, tiles_h = (h + TH - 1) / TH, ntiles = tiles_w * tiles_h * n;
  const int grid = std::max(1, std::min(ntiles, cache.grid_per_sm * sm_count()));
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), wd, bd, wp, bp, static_cast<T*>(y), h, w, c, co,
                                        tiles_w, tiles_h, ntiles, pl);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t by_width(int co, const void* x, const float* wd, const float* bd, const float* wp, const float* bp,
                     void* y, int n, int h, int w, int c, cudaStream_t st) {
  if (co <= 16) return launch<T, K, 2>(x, wd, bd, wp, bp, y, n, h, w, c, co, st);
  if (co <= 32) return launch<T, K, 4>(x, wd, bd, wp, bp, y, n, h, w, c, co, st);
  return launch<T, K, 8>(x, wd, bd, wp, bp, y, n, h, w, c, co, st);
}

template <typename T>
cudaError_t dispatch(int k, int co, const void* x, const float* wd, const float* bd, const float* wp,
                     const float* bp, void* y, int n, int h, int w, int c, cudaStream_t st) {
  switch (k) {
    case 3: return by_width<T, 3>(co, x, wd, bd, wp, bp, y, n, h, w, c, st);
    case 5: return by_width<T, 5>(co, x, wd, bd, wp, bp, y, n, h, w, c, st);
    case 7: return by_width<T, 7>(co, x, wd, bd, wp, bp, y, n, h, w, c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, h, w, c) bf16 or f32; w_depth (k, k, c), b_depth (c,), w_point
// (c, c_out), b_point (c_out,) f32; y (n, h, w, c_out) in x's dtype; all
// contiguous, y not aliasing x. Takes 1 <= c, c_out <= 64 and k in {3, 5, 7};
// anything else returns cudaErrorInvalidValue. Launches on `stream`, does not
// synchronise, returns cudaGetLastError() after the launch.
extern "C" int fused_convsep_launch(const void* x, const void* wd, const void* bd, const void* wp, const void* bp,
                                    void* y, int n, int h, int w, int c, int c_out, int k, int is_bf16,
                                    void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c < 1 || c > 64 || c_out < 1 || c_out > 64) return int(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return int(dispatch<__nv_bfloat16>(k, c_out, x, f(wd), f(bd), f(wp), f(bp), y, n, h, w, c, st));
  return int(dispatch<float>(k, c_out, x, f(wd), f(bd), f(wp), f(bp), y, n, h, w, c, st));
}
