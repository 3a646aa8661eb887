// Kernel B2: conv (KH x KW, per-side zero padding) + bias + depth-to-space(s)
// + crop, written once.
//
// Replaces the Pallas kernel mobilesuperresolution_tpu/kernels/fused_tail.py::
// fused_conv_pixel_shuffle (3x3 SAME conv to s^2*C channels, + bias, then
// depth-to-space with conv channel c*s^2 + i*s + j -> pixel offset (i, j) of
// channel c). Generalised so one kernel serves both that 3x3/pad-1 form and
// the main-path reconstruction tail (ops/layers.py::SubpixelConvTranspose):
// a 2x2 conv with pad ((1,2),(1,2)), 48 -> 48 channels, s = 4, cropped to
// (4h+1, 4w+1). At (10, 240, 426, 48) -> (10, 961, 1705, 3) that is ~19 GFLOP
// and ~196 MB in bf16, so the op is bound by bytes (0.059 ms on an H100): the
// (s^2*C)-channel conv output never goes to device memory, and only pixels
// inside the crop are computed and written.
//
// bf16 design (the main path): an implicit GEMM on the tensor cores,
// mma.sync m16n8k16 with ldmatrix. M is a tile of 8 x 16 conv positions (a
// warp owns two rows: two m16 tiles), K is KH*KW*Cin (192 on the path), N
// the conv channels rounded up to 8 (48). The op is bound by bytes, so
// mma.sync is enough: the 19 GFLOP need ~0.03 ms at its rate against the
// 0.059 ms bytes bound, and wgmma's 64-row tiles would not fit the 8 x 16
// tile. The grid is persistent (as many blocks as fit, each walking tiles):
// - the weights (bf16, rounded by the wrapper) are staged once per block;
// - the input halo is staged as bf16 with 16-byte cp.async (zero-filled
//   outside the image and past Cin), double-buffered: the next tile's copy
//   is in flight during this tile's MMAs. Pixel and weight-row strides are
//   odd multiples of 16 bytes, so ldmatrix phases are free of bank
//   conflicts;
// - the epilogue adds the bias in f32, rounds once, writes the depth-to-space
//   tile into the tile's own (now free) halo buffer in output order, then
//   copies it out one output row per warp, consecutive lanes on consecutive
//   4-byte words (a row of y is 2-byte aligned only: one element is peeled).
//   The crop masks the last partial tiles.
// Any KH, KW, padding, s, crop and Cin (Cc <= 64) are taken: weights too large
// to stage at once are staged per chunk of input channels and group of kernel
// rows (slower; never on the path), and Cin or Cc not a multiple of 8 stage
// through a synchronous zero-filling loop.
//
// f32 design (and B4): one thread per low-resolution conv position, holding
// all conv output channels (<= 64) in f32 registers. A block covers 16 x 16
// positions; the input halo tile and the weights are staged in shared memory
// 8 input channels at a time (as f32; bf16 inputs are widened exactly), so
// every weight read is a broadcast. The epilogue adds the bias and scatters
// each channel to its depth-to-space pixel, rounding once to the working
// dtype. CUDA-core FMA, full f32.
//
// Kernel B4 is the CUDA-core kernel with a second source: the WDSR / ResultNet
// tail (mobilesuperresolution_tpu/models/wdsr_basic.py:67-73,
// result_net.py:74-77), depth_to_space(conv3x3(body) + conv5x5(x_skip) +
// bias, s), where the 5x5 skip conv reads the mean-subtracted 3-channel
// input with its own SAME padding. The skip conv accumulates into the same
// registers before the epilogue, so the sum is written once. At the SISR
// path's shape, body (1, 678, 1020, 24) 3x3 -> 12 and skip (1, 678, 1020, 3)
// 5x5 -> 12 at s = 2, that is 4.8 GFLOP and ~108 MB in f32. Both kernels run
// the same staged loop (accumulate_conv, once per source) and the same
// epilogue (store_shuffled); each has its own C entry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int TILE = 16;   // conv positions per block side
constexpr int CK = 8;      // input channels staged per step
constexpr int THREADS = TILE * TILE;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Accumulate one zero-padded KH x KW conv of x (n, H, W, Cin) into acc, for
// the conv position (ty*TILE + ly, tx*TILE + lx). halo [HH][HW][CK] and wts
// [KH*KW][CK][CO] are the block's shared staging buffers.
template <typename T, int CO>
__device__ __forceinline__ void accumulate_conv(
    float (&acc)[CO], float* halo, float* wts, const T* __restrict__ x,
    const float* __restrict__ w, int img, int H, int W, int Cin, int KH, int KW,
    int pad_t, int pad_l, int Cc, int tx, int ty, int ly, int lx) {
  const int HH = TILE + KH - 1, HW = TILE + KW - 1;
  const size_t img_off = size_t(img) * H * W;
  for (int c0 = 0; c0 < Cin; c0 += CK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < HH * HW * CK; idx += THREADS) {
      const int k = idx % CK, p = idx / CK;
      const int gy = ty * TILE + p / HW - pad_t, gx = tx * TILE + p % HW - pad_l;
      const int c = c0 + k;
      halo[idx] = (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin)
                      ? to_f32(x[(img_off + size_t(gy) * W + gx) * Cin + c])
                      : 0.f;
    }
    for (int idx = threadIdx.x; idx < KH * KW * CK * CO; idx += THREADS) {
      const int n = idx % CO, r = idx / CO;
      const int k = r % CK, tap = r / CK;
      const int c = c0 + k;
      wts[idx] = (c < Cin && n < Cc) ? w[(size_t(tap) * Cin + c) * Cc + n] : 0.f;
    }
    __syncthreads();
    for (int ky = 0; ky < KH; ++ky) {
      for (int kx = 0; kx < KW; ++kx) {
        const float* a = halo + ((ly + ky) * HW + lx + kx) * CK;
        const float* wt = wts + (ky * KW + kx) * CK * CO;
#pragma unroll
        for (int k = 0; k < CK; ++k) {
          const float av = a[k];
#pragma unroll
          for (int n = 0; n < CO; ++n) acc[n] = fmaf(av, wt[k * CO + n], acc[n]);
        }
      }
    }
  }
}

// Add the bias and scatter conv channel n = c*s^2 + i*s + j of position
// (cy, cx) to pixel (cy*s + i, cx*s + j) of channel c, inside the crop.
template <typename T, int CO>
__device__ __forceinline__ void store_shuffled(const float (&acc)[CO], const float* __restrict__ bias,
                                               T* __restrict__ y, int img, int cy, int cx, int Cc,
                                               int s, int out_h, int out_w) {
  const int ss = s * s, C = Cc / ss;
#pragma unroll
  for (int n = 0; n < CO; ++n) {
    if (n < Cc) {
      const int c = n / ss, i = (n % ss) / s, j = n % s;
      const int oy = cy * s + i, ox = cx * s + j;
      if (oy < out_h && ox < out_w)
        y[((size_t(img) * out_h + oy) * out_w + ox) * C + c] = from_f32<T>(acc[n] + bias[n]);
    }
  }
}

template <typename T, int CO>
__global__ void __launch_bounds__(THREADS) fused_tail_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
    int KH, int KW, int pad_t, int pad_l, int Cc, int s, int Hc, int Wc,
    int out_h, int out_w, int tiles_w, int tiles_h) {
  extern __shared__ float smem[];
  float* halo = smem;                                         // [HH][HW][CK]
  float* wts = smem + (TILE + KH - 1) * (TILE + KW - 1) * CK;  // [KH*KW][CK][CO]

  const int tile = blockIdx.x;
  const int tx = tile % tiles_w;
  const int ty = (tile / tiles_w) % tiles_h;
  const int img = tile / (tiles_w * tiles_h);
  const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
  const int cy = ty * TILE + ly, cx = tx * TILE + lx;

  float acc[CO];
#pragma unroll
  for (int n = 0; n < CO; ++n) acc[n] = 0.f;
  accumulate_conv<T, CO>(acc, halo, wts, x, w, img, H, W, Cin, KH, KW, pad_t, pad_l, Cc, tx, ty, ly, lx);
  if (cy >= Hc || cx >= Wc) return;
  store_shuffled<T, CO>(acc, bias, y, img, cy, cx, Cc, s, out_h, out_w);
}

// Shape of one conv source: its input map, channels, kernel and padding.
struct Source {
  int H, W, Cin, KH, KW, pad_t, pad_l;
};

template <typename T, int CO>
__global__ void __launch_bounds__(THREADS) fused_tail_skip_kernel(
    const T* __restrict__ x, const float* __restrict__ w, Source src,
    const T* __restrict__ x2, const float* __restrict__ w2, Source src2,
    const float* __restrict__ bias, T* __restrict__ y, int Cc, int s, int Hc, int Wc,
    int out_h, int out_w, int tiles_w, int tiles_h, int halo_floats) {
  extern __shared__ float smem[];
  float* halo = smem;               // [HH][HW][CK], the larger source's
  float* wts = smem + halo_floats;  // [KH*KW][CK][CO]

  const int tile = blockIdx.x;
  const int tx = tile % tiles_w;
  const int ty = (tile / tiles_w) % tiles_h;
  const int img = tile / (tiles_w * tiles_h);
  const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
  const int cy = ty * TILE + ly, cx = tx * TILE + lx;

  float acc[CO];
#pragma unroll
  for (int n = 0; n < CO; ++n) acc[n] = 0.f;
  accumulate_conv<T, CO>(acc, halo, wts, x, w, img, src.H, src.W, src.Cin, src.KH, src.KW,
                         src.pad_t, src.pad_l, Cc, tx, ty, ly, lx);
  accumulate_conv<T, CO>(acc, halo, wts, x2, w2, img, src2.H, src2.W, src2.Cin, src2.KH,
                         src2.KW, src2.pad_t, src2.pad_l, Cc, tx, ty, ly, lx);
  if (cy >= Hc || cx >= Wc) return;
  store_shuffled<T, CO>(acc, bias, y, img, cy, cx, Cc, s, out_h, out_w);
}

// Call f with the smallest register width (a std::integral_constant) that
// holds cc <= 64 conv channels.
template <typename F>
cudaError_t by_width(int cc, F&& f) {
  if (cc <= 16) return f(std::integral_constant<int, 16>());
  if (cc <= 48) return f(std::integral_constant<int, 48>());
  return f(std::integral_constant<int, 64>());
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* b, void* y, int n,
                   int h, int wd, int cin, int kh, int kw, int pad_t, int pad_l,
                   int cc, int s, int hc, int wc, int out_h, int out_w,
                   cudaStream_t stream) {
  return by_width(cc, [&](auto width) {
    constexpr int CO = decltype(width)::value;
    const size_t smem = (size_t(TILE + kh - 1) * (TILE + kw - 1) * CK + size_t(kh) * kw * CK * CO) * 4;
    cudaError_t err = cudaFuncSetAttribute(
        fused_tail_kernel<T, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const int tiles_w = (wc + TILE - 1) / TILE, tiles_h = (hc + TILE - 1) / TILE;
    fused_tail_kernel<T, CO><<<tiles_w * tiles_h * n, THREADS, smem, stream>>>(
        static_cast<const T*>(x), w, b, static_cast<T*>(y), h, wd, cin, kh, kw,
        pad_t, pad_l, cc, s, hc, wc, out_h, out_w, tiles_w, tiles_h);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_skip(const void* x, const float* w, const Source& src, const void* x2,
                        const float* w2, const Source& src2, const float* b, void* y, int n,
                        int cc, int s, int hc, int wc, int out_h, int out_w, cudaStream_t stream) {
  return by_width(cc, [&](auto width) {
    constexpr int CO = decltype(width)::value;
    const size_t halo1 = size_t(TILE + src.KH - 1) * (TILE + src.KW - 1);
    const size_t halo2 = size_t(TILE + src2.KH - 1) * (TILE + src2.KW - 1);
    const size_t wts1 = size_t(src.KH) * src.KW * CO;
    const size_t wts2 = size_t(src2.KH) * src2.KW * CO;
    const int halo_floats = int(std::max(halo1, halo2) * CK);
    const size_t smem = (halo_floats + std::max(wts1, wts2) * CK) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_tail_skip_kernel<T, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const int tiles_w = (wc + TILE - 1) / TILE, tiles_h = (hc + TILE - 1) / TILE;
    fused_tail_skip_kernel<T, CO><<<tiles_w * tiles_h * n, THREADS, smem, stream>>>(
        static_cast<const T*>(x), w, src, static_cast<const T*>(x2), w2, src2, b,
        static_cast<T*>(y), cc, s, hc, wc, out_h, out_w, tiles_w, tiles_h, halo_floats);
    return cudaGetLastError();
  });
}

bool bad_geometry(int n, int hc, int wc, int cin, int cc, int s) {
  return n <= 0 || hc <= 0 || wc <= 0 || cin <= 0 || cc <= 0 || cc > 64 || s <= 0 ||
         cc % (s * s) != 0;
}

// ---- B2 in bf16: tensor cores (mma.sync m16n8k16), persistent grid ----

constexpr int M_TH = 8;    // conv rows per tile (two per warp)
constexpr int M_TW = 16;   // conv columns per tile (one m16 per conv row)
constexpr int M_THREADS = 128;
constexpr int M_SMEM_MAX = 232448;

// Shared-memory plan of one launch, computed on the host and passed by value.
struct MmaPlan {
  int kch;          // input channels per halo chunk (multiple of 16)
  int kyg;          // kernel rows whose weights are staged together
  int hw;           // halo width, M_TW + KW - 1
  int pstr;         // halo pixel stride in bytes: an odd number of 16-byte chunks
  int wstr;         // weight row stride in bytes: an odd number of 16-byte chunks
  int halo_bytes;   // one halo buffer; once its tile's MMAs are done, the tile's output stage
  int wts_bytes;
};

template <int NB>
__device__ __forceinline__ void tail_mma_piece(float (&acc)[2][NB][4], uint32_t halo_s, uint32_t wts_s,
                                               const MmaPlan& pl, int KW, int ky0, int ky1, int ksteps,
                                               int warp, int lane) {
  for (int ky = ky0; ky < ky1; ++ky) {
    for (int kx = 0; kx < KW; ++kx) {
      const int row0 = ((ky - ky0) * KW + kx) * pl.kch;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int p = (2 * warp + mi + ky) * pl.hw + (lane & 15) + kx;
          ldmatrix_x4(a[mi], halo_s + p * pl.pstr + (ks * 2 + (lane >> 4)) * 16);
        }
        const int krow = row0 + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t b[NB][2];
#pragma unroll
        for (int q = 0; q + 1 < NB; q += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, wts_s + krow * pl.wstr + (q + (lane >> 4)) * 16);
          b[q][0] = r[0]; b[q][1] = r[1]; b[q + 1][0] = r[2]; b[q + 1][1] = r[3];
        }
        if (NB % 2) ldmatrix_x2_trans(b[NB - 1], wts_s + krow * pl.wstr + (NB - 1) * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int q = 0; q < NB; ++q) mma_16816(acc[mi][q], a[mi], b[q]);
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(M_THREADS) fused_tail_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H, int W, int Cin,
    int KH, int KW, int pad_t, int pad_l, int Cc, int s, int Hc, int Wc, int out_h, int out_w,
    int tiles_w, int tiles_h, int ntiles, MmaPlan pl) {
  extern __shared__ __align__(128) unsigned char tail_smem[];
  unsigned char* halo = tail_smem;                     // [2][HH * hw] pixels of pstr bytes
  unsigned char* wts = tail_smem + 2 * pl.halo_bytes;  // [kyg * KW * kch] rows of wstr bytes
  const uint32_t halo_s = smem_u32(halo), wts_s = smem_u32(wts);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ss = s * s, C = Cc / ss, HH = M_TH + KH - 1;
  const int cin_pad = (Cin + 15) / 16 * 16;
  const int nchunks = (cin_pad + pl.kch - 1) / pl.kch, nkg = (KH + pl.kyg - 1) / pl.kyg;
  const bool resident = nchunks == 1 && nkg == 1;
  const bool vec_x = Cin % 8 == 0, vec_w = Cc % 8 == 0;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // Where conv channel n = c*s^2 + i*s + j of a position lands in the output
  // stage, relative to the position's top-left pixel; -1 past Cc.
  int off[NB][2];
  float bv[NB][2];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * q + 2 * t + e;
      off[q][e] = n < Cc ? (((n % ss) / s) * (M_TW * s) + n % s) * C + n / ss : -1;
      bv[q][e] = n < Cc ? bias[n] : 0.f;
    }

  auto tile_origin = [&](int tile, int& img, int& cy0, int& cx0) {
    const int tx = tile % tiles_w, ty = (tile / tiles_w) % tiles_h;
    img = tile / (tiles_w * tiles_h);
    cy0 = ty * M_TH;
    cx0 = tx * M_TW;
  };
  auto stage_halo = [&](int buf, int tile, int chunk) {
    int img, cy0, cx0;
    tile_origin(tile, img, cy0, cx0);
    const int cpp = pl.kch / 8;
    const size_t img_px = size_t(img) * H * W;
    for (int idx = tid; idx < HH * pl.hw * cpp; idx += M_THREADS) {
      const int p = idx / cpp, c = idx % cpp;
      const int gy = cy0 + p / pl.hw - pad_t, gx = cx0 + p % pl.hw - pad_l;
      const int ch = chunk * pl.kch + c * 8;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int o = buf * pl.halo_bytes + p * pl.pstr + c * 16;
      const __nv_bfloat16* src = x + (img_px + size_t(gy) * W + gx) * Cin + ch;
      if (vec_x) {
        const bool ok = inside && ch < Cin;
        cp_async16(halo_s + o, ok ? src : x, ok);
      } else {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(halo + o);
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k] = (inside && ch + k < Cin) ? src[k] : zero;
      }
    }
  };
  auto stage_wts = [&](int chunk, int ky0, int ky1) {
    const int rows = (ky1 - ky0) * KW * pl.kch;
    for (int idx = tid; idx < rows * NB; idx += M_THREADS) {
      const int r = idx / NB, j = idx % NB;
      const int ky = ky0 + r / (KW * pl.kch), kx = (r / pl.kch) % KW, c = chunk * pl.kch + r % pl.kch;
      const int o = r * pl.wstr + j * 16;
      const __nv_bfloat16* src = w + ((size_t(ky) * KW + kx) * Cin + c) * Cc + 8 * j;
      if (vec_w) {
        const bool ok = c < Cin && 8 * j < Cc;
        cp_async16(wts_s + o, ok ? src : w, ok);
      } else {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(wts + o);
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k] = (c < Cin && 8 * j + k < Cc) ? src[k] : zero;
      }
    }
  };
  // Bias, one rounding, depth-to-space into the output stage (halo buffer sb,
  // free once the tile's MMAs are done), then the stage's rows out to y, one
  // row per warp, consecutive lanes on consecutive 4-byte words.
  auto finish = [&](float (&acc)[2][NB][4], int tile, int sb) {
    __nv_bfloat16* ost = reinterpret_cast<__nv_bfloat16*>(halo + sb * pl.halo_bytes);  // [M_TH*s][M_TW*s][C]
    int img, cy0, cx0;
    tile_origin(tile, img, cy0, cx0);
    const int row_el = M_TW * s * C;  // elements in one stage row
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int base = ((2 * warp + mi) * s * (M_TW * s) + (g + 8 * h) * s) * C;
#pragma unroll
        for (int q = 0; q < NB; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (off[q][e] >= 0) ost[base + off[q][e]] = __float2bfloat16(acc[mi][q][2 * h + e] + bv[q][e]);
      }
    __syncthreads();
    const int oy0 = cy0 * s, ox0 = cx0 * s;
    const int nel = min(M_TW * s, out_w - ox0) * C;
    for (int rr = warp; rr < M_TH * s; rr += M_THREADS / 32) {
      const int oy = oy0 + rr;
      if (oy >= out_h) break;
      // a row of y is 2-byte aligned only: peel one element to reach 4 bytes
      const size_t ge = ((size_t(img) * out_h + oy) * out_w + ox0) * C;
      const int head = int(ge & 1);
      const __nv_bfloat16* srow = ost + rr * row_el;
      __nv_bfloat16* grow = y + ge;
      if (head && lane == 0) grow[0] = srow[0];
      for (int e0 = head + 2 * lane; e0 < nel; e0 += 64) {
        if (e0 + 1 < nel) {
          __nv_bfloat162 v;
          v.x = srow[e0];
          v.y = srow[e0 + 1];
          *reinterpret_cast<__nv_bfloat162*>(grow + e0) = v;
        } else {
          grow[e0] = srow[e0];
        }
      }
    }
    __syncthreads();  // the stage is read out before its buffer takes a halo again
  };
  auto zero_acc = [&](float (&acc)[2][NB][4]) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][q][e] = 0.f;
  };

  float acc[2][NB][4];
  const int first = blockIdx.x;
  if (resident) {
    // Weights once per block; the next tile's halo is in flight while this
    // tile computes.
    stage_wts(0, 0, KH);
    cp_async_commit();
    stage_halo(0, first, 0);
    cp_async_commit();
    for (int tile = first, buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
      if (tile + gridDim.x < ntiles) {
        stage_halo(buf ^ 1, tile + gridDim.x, 0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      zero_acc(acc);
      tail_mma_piece<NB>(acc, halo_s + buf * pl.halo_bytes, wts_s, pl, KW, 0, KH, cin_pad / 16, warp, lane);
      __syncthreads();  // every warp is done with the halo buffer: it becomes the output stage
      finish(acc, tile, buf);
    }
  } else {
    // Geometries whose weights do not fit at once: chunks of input channels
    // and groups of kernel rows, each staged synchronously.
    for (int tile = first; tile < ntiles; tile += gridDim.x) {
      zero_acc(acc);
      for (int chunk = 0; chunk < nchunks; ++chunk) {
        const int ksteps = min(pl.kch, cin_pad - chunk * pl.kch) / 16;
        for (int ky0 = 0; ky0 < KH; ky0 += pl.kyg) {
          const int ky1 = min(KH, ky0 + pl.kyg);
          __syncthreads();
          if (ky0 == 0) stage_halo(0, tile, chunk);
          stage_wts(chunk, ky0, ky1);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          tail_mma_piece<NB>(acc, halo_s, wts_s, pl, KW, ky0, ky1, ksteps, warp, lane);
        }
      }
      __syncthreads();
      finish(acc, tile, 0);
    }
  }
}

// The largest channel chunk, then the most kernel rows, whose staging fits.
bool plan_mma(int kh, int kw, int cin, int cc, int nb, MmaPlan& pl) {
  const int cin_pad = (cin + 15) / 16 * 16;
  pl.hw = M_TW + kw - 1;
  pl.wstr = (nb | 1) * 16;
  const int stage_bytes = M_TH * M_TW * cc * 2;
  for (int kch = cin_pad; kch >= 16; kch -= 16) {
    for (int kyg = kh; kyg >= 1; --kyg) {
      pl.kch = kch;
      pl.kyg = kyg;
      pl.pstr = (kch / 8 + 1) * 16;
      pl.halo_bytes = std::max((M_TH + kh - 1) * pl.hw * pl.pstr, stage_bytes);
      pl.wts_bytes = kyg * kw * kch * pl.wstr;
      if (2 * pl.halo_bytes + pl.wts_bytes <= M_SMEM_MAX) return true;
    }
  }
  return false;
}

template <int NB>
cudaError_t launch_mma_nb(const void* x, const void* w, const float* b, void* y, int n, int h,
                          int wd, int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s,
                          int hc, int wc, int out_h, int out_w, cudaStream_t stream) {
  MmaPlan pl;
  if (!plan_mma(kh, kw, cin, cc, NB, pl)) return cudaErrorInvalidConfiguration;
  const int smem = 2 * pl.halo_bytes + pl.wts_bytes;
  auto kern = fused_tail_mma_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, M_THREADS, smem)) != cudaSuccess)
    return err;
  const int tiles_w = (wc + M_TW - 1) / M_TW, tiles_h = (hc + M_TH - 1) / M_TH;
  const int ntiles = tiles_w * tiles_h * n;
  const int grid = std::max(1, std::min(ntiles, std::max(per_sm, 1) * sms));
  kern<<<grid, M_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), b,
      static_cast<__nv_bfloat16*>(y), h, wd, cin, kh, kw, pad_t, pad_l, cc, s, hc, wc, out_h, out_w,
      tiles_w, tiles_h, ntiles, pl);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const void* w, const float* b, void* y, int n, int h, int wd,
                       int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s, int hc, int wc,
                       int out_h, int out_w, cudaStream_t st) {
  switch ((cc + 7) / 8) {
#define TAIL_NB(NB) \
  case NB: return launch_mma_nb<NB>(x, w, b, y, n, h, wd, cin, kh, kw, pad_t, pad_l, cc, s, hc, wc, out_h, out_w, st);
    TAIL_NB(1) TAIL_NB(2) TAIL_NB(3) TAIL_NB(4) TAIL_NB(5) TAIL_NB(6) TAIL_NB(7) TAIL_NB(8)
#undef TAIL_NB
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B2 in f32. x (n, h, wd, cin), w (kh, kw, cin, cc), b (cc,) and y (n, out_h,
// out_w, cc / s^2), all f32 and contiguous. hc, wc: conv output positions to
// compute (those that reach the crop). Launches on `stream`, does not
// synchronise, returns cudaGetLastError() after the launch.
extern "C" int fused_conv_pixel_shuffle_launch(
    const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
    int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s, int hc,
    int wc, int out_h, int out_w, void* stream) {
  if (bad_geometry(n, hc, wc, cin, cc, s)) return int(cudaErrorInvalidValue);
  return int(launch<float>(x, static_cast<const float*>(w), static_cast<const float*>(b), y, n, h, wd, cin, kh,
                           kw, pad_t, pad_l, cc, s, hc, wc, out_h, out_w, static_cast<cudaStream_t>(stream)));
}

// B2 in bf16 on the tensor cores: x (n, h, wd, cin) bf16; w (kh, kw, cin, cc)
// bf16; b (cc,) f32; y (n, out_h, out_w, cc / s^2) bf16, all contiguous.
// Otherwise as fused_conv_pixel_shuffle_launch.
extern "C" int fused_conv_pixel_shuffle_bf16_launch(
    const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
    int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s, int hc,
    int wc, int out_h, int out_w, void* stream) {
  if (bad_geometry(n, hc, wc, cin, cc, s) || kh <= 0 || kw <= 0) return int(cudaErrorInvalidValue);
  return int(launch_mma(x, w, static_cast<const float*>(b), y, n, h, wd, cin, kh, kw, pad_t, pad_l, cc, s,
                        hc, wc, out_h, out_w, static_cast<cudaStream_t>(stream)));
}

// B4. As B2 over two sources summed before the bias: x (n, h, wd, cin) with
// w (kh, kw, cin, cc), and x2 (n, h2, wd2, cin2) in x's dtype with w2 (kh2,
// kw2, cin2, cc), each zero-padded by its own (pad_t, pad_l).
extern "C" int fused_conv_pixel_shuffle_skip_launch(
    const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
    int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s, int hc,
    int wc, int out_h, int out_w, const void* x2, const void* w2, int h2, int wd2,
    int cin2, int kh2, int kw2, int pad2_t, int pad2_l, int is_bf16, void* stream) {
  if (bad_geometry(n, hc, wc, cin, cc, s) || !x2 || !w2 || cin2 <= 0) return int(cudaErrorInvalidValue);
  const Source src{h, wd, cin, kh, kw, pad_t, pad_l};
  const Source src2{h2, wd2, cin2, kh2, kw2, pad2_t, pad2_l};
  const float* wf = static_cast<const float*>(w);
  const float* w2f = static_cast<const float*>(w2);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return int(launch_skip<__nv_bfloat16>(x, wf, src, x2, w2f, src2, bf, y, n, cc, s, hc, wc, out_h, out_w, st));
  return int(launch_skip<float>(x, wf, src, x2, w2f, src2, bf, y, n, cc, s, hc, wc, out_h, out_w, st));
}
