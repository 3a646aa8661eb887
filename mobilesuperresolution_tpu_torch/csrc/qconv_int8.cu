// Kernel Q1: int8 dynamic-range SAME convolution, NHWC, exact int32
// accumulation, the rescale and the bias fused in the epilogue.
//
// Not a TPU kernel: it replaces the XLA int8 convolution of
// mobilesuperresolution_tpu/ops/quant.py::qconv2d (conv_general_dilated of
// int8 operands with preferred_element_type int32), which PyTorch cannot run
// on CUDA (F.conv2d has no int8 CUDA path). The caller quantizes the
// activation per sample (xq int8, xs (N,) f32) and the kernel per output
// channel (ks (Co,) f32, the weight packed once by kernels/qconv_int8.py::
// pack_weights); the kernel computes
//
//   y[n, p, co] = float(sum_{tap, ci} xq[n, p + tap, ci] * wq[co, ci, tap])
//                 * (xs[n] * ks[co]) (+ bias[co])
//
// in that order, each operation rounded once (no fused multiply-add), then
// rounds to f32 or bf16 (round to nearest even): the JAX package's order, so
// the result equals the float64-exact plain version bit for bit.
//
// Design (simple first, CUDA cores): a block of 128 threads owns an 8 x 16
// tile of output pixels and CO_T output channels; a thread owns one pixel
// and CO_T int32 accumulators. The input channels go in chunks of 16: the
// (tile + k - 1)-halo of one chunk is staged in shared memory as 4 int32
// words per pixel (a fifth word pads the stride against bank conflicts),
// zero outside the image and past Cin, so any Cin works (3, 8, 46, 54, ...);
// the chunk's k x k x 4 x CO_T weight words follow as one contiguous slab of
// the packed weight. Each (tap, word) is one __dp4a per output channel, the
// weights read as 16-byte broadcasts. Odd k in {1, 3, 5, 7}, groups 1.
// Widest reduction on the paths: SpyNet's 5x5 over 256 channels, K = 6,400,
// |acc| <= 127^2 * 6,400 < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16, THREADS = TH * TW;
constexpr int CHUNK = 16;       // input channels per staged chunk (4 words)
constexpr int WORDS = CHUNK / 4;
constexpr int PIX_STRIDE = WORDS + 1;

template <int K>
__device__ __forceinline__ void stage_input(int* s_in, const int8_t* __restrict__ x, int n, int h, int wd,
                                            int cin, int c0, int y0, int x0) {
  constexpr int HH = TH + K - 1, HW = TW + K - 1;
  const bool words = (cin & 3) == 0;
  for (int i = threadIdx.x; i < HH * HW * WORDS; i += THREADS) {
    const int g = i % WORDS, p = i / WORDS;
    const int gy = y0 + p / HW - K / 2, gx = x0 + p % HW - K / 2;
    const int c = c0 + 4 * g;
    int v = 0;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd && c < cin) {
      const int8_t* src = x + ((static_cast<int64_t>(n) * h + gy) * wd + gx) * cin + c;
      if (words) {
        v = *reinterpret_cast<const int*>(src);
      } else {
        uint32_t u = 0;
        for (int j = 0; j < 4 && c + j < cin; ++j) u |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * j);
        v = static_cast<int>(u);
      }
    }
    s_in[p * PIX_STRIDE + g] = v;
  }
}

template <int K, int CO_T, bool BF16>
__global__ void __launch_bounds__(THREADS) qconv_int8_kernel(
    const int8_t* __restrict__ x, const int* __restrict__ wp, const float* __restrict__ xs,
    const float* __restrict__ ks, const float* __restrict__ bias, void* __restrict__ y, int h, int wd, int cin,
    int cout, int tiles_w, int tiles_h, int chunks) {
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

  int acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = 0;

  const int4* wsrc = reinterpret_cast<const int4*>(wp + static_cast<int64_t>(cot) * chunks * W_WORDS);
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();
    stage_input<K>(s_in, x, n, h, wd, cin, ch * CHUNK, ty0, tx0);
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
  const float sx = xs[n];
  const int64_t base = ((static_cast<int64_t>(n) * h + oy) * wd + ox) * cout;
#pragma unroll
  for (int j = 0; j < CO_T; ++j) {
    const int co = cot * CO_T + j;
    if (co >= cout) break;
    // JAX's order: acc as f32, times (xs * ks), then + bias; no contraction
    float v = __fmul_rn(__int2float_rn(acc[j]), __fmul_rn(sx, ks[co]));
    if (bias != nullptr) v = __fadd_rn(v, bias[co]);
    if (BF16)
      static_cast<__nv_bfloat16*>(y)[base + co] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(y)[base + co] = v;
  }
}

template <int K, int CO_T>
cudaError_t launch_k(const int8_t* x, const int* wp, const float* xs, const float* ks, const float* bias, void* y,
                     int n, int h, int wd, int cin, int cout, int is_bf16, cudaStream_t s) {
  const int tiles_w = (wd + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const int chunks = (cin + CHUNK - 1) / CHUNK;
  dim3 grid(tiles_w * tiles_h * n, (cout + CO_T - 1) / CO_T);
  if (is_bf16)
    qconv_int8_kernel<K, CO_T, true><<<grid, THREADS, 0, s>>>(x, wp, xs, ks, bias, y, h, wd, cin, cout, tiles_w,
                                                              tiles_h, chunks);
  else
    qconv_int8_kernel<K, CO_T, false><<<grid, THREADS, 0, s>>>(x, wp, xs, ks, bias, y, h, wd, cin, cout, tiles_w,
                                                               tiles_h, chunks);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_co(int co_t, const int8_t* x, const int* wp, const float* xs, const float* ks, const float* bias,
                      void* y, int n, int h, int wd, int cin, int cout, int is_bf16, cudaStream_t s) {
  switch (co_t) {
    case 8: return launch_k<K, 8>(x, wp, xs, ks, bias, y, n, h, wd, cin, cout, is_bf16, s);
    case 16: return launch_k<K, 16>(x, wp, xs, ks, bias, y, n, h, wd, cin, cout, is_bf16, s);
    case 32: return launch_k<K, 32>(x, wp, xs, ks, bias, y, n, h, wd, cin, cout, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xq (N, H, W, Cin) int8; wp the packed weight (kernels/qconv_int8.py::
// pack_weights, output-channel tile co_t); xs (N,), ks (Cout,) and bias
// (Cout,) or null, f32; y (N, H, W, Cout) f32, or bf16 when is_bf16.
extern "C" int qconv_int8_launch(const void* xq, const void* wp, const void* xs, const void* ks, const void* bias,
                                 void* y, int n, int h, int wd, int cin, int cout, int k, int co_t, int is_bf16,
                                 void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto x8 = static_cast<const int8_t*>(xq);
  auto w = static_cast<const int*>(wp);
  auto fxs = static_cast<const float*>(xs), fks = static_cast<const float*>(ks), fb = static_cast<const float*>(bias);
  switch (k) {
    case 1: return int(launch_co<1>(co_t, x8, w, fxs, fks, fb, y, n, h, wd, cin, cout, is_bf16, s));
    case 3: return int(launch_co<3>(co_t, x8, w, fxs, fks, fb, y, n, h, wd, cin, cout, is_bf16, s));
    case 5: return int(launch_co<5>(co_t, x8, w, fxs, fks, fb, y, n, h, wd, cin, cout, is_bf16, s));
    case 7: return int(launch_co<7>(co_t, x8, w, fxs, fks, fb, y, n, h, wd, cin, cout, is_bf16, s));
    default: return int(cudaErrorInvalidValue);
  }
}
