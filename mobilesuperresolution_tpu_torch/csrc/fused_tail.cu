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
// and ~196 MB in bf16, so the op is bound by bytes: the (s^2*C)-channel conv
// output never goes to device memory, and only pixels inside the crop are
// computed and written.
//
// Design: one thread per low-resolution conv position, holding all conv
// output channels (<= 64) in f32 registers. A block covers 16 x 16 positions;
// the input halo tile and the weights are staged in shared memory 8 input
// channels at a time (as f32; bf16 inputs are widened exactly), so every
// weight read is a broadcast. The epilogue adds the bias and scatters each
// channel to its depth-to-space pixel, rounding once to the working dtype.
// CUDA-core FMA, no tensor cores yet.
//
// Kernel B4 is the same kernel with a second source: the WDSR / ResultNet
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

}  // namespace

// B2. x (n, h, wd, cin) bf16 or f32; w (kh, kw, cin, cc) f32; b (cc,) f32;
// y (n, out_h, out_w, cc / s^2) in x's dtype, all contiguous. hc, wc: conv
// output positions to compute (those that reach the crop). Launches on
// `stream`, does not synchronise, returns cudaGetLastError() after the launch.
extern "C" int fused_conv_pixel_shuffle_launch(
    const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
    int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s, int hc,
    int wc, int out_h, int out_w, int is_bf16, void* stream) {
  if (bad_geometry(n, hc, wc, cin, cc, s)) return int(cudaErrorInvalidValue);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return int(launch<__nv_bfloat16>(x, wf, bf, y, n, h, wd, cin, kh, kw, pad_t, pad_l, cc, s, hc, wc, out_h, out_w, st));
  return int(launch<float>(x, wf, bf, y, n, h, wd, cin, kh, kw, pad_t, pad_l, cc, s, hc, wc, out_h, out_w, st));
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
