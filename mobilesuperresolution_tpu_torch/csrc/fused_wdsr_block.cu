// Kernel B3: the fused WDSR-B residual block,
//   y = x + conv_KxK(zero_pad(W2 . relu(W1 . x + b1) + b2)) + b3,
// with the 6C-channel expansion kept in registers, never in device memory.
//
// Replaces the Pallas kernel mobilesuperresolution_tpu/kernels/
// fused_wdsr_block.py::fused_wdsr_block (1x1 C->6C, ReLU, 1x1 6C->M, KxK
// M->C, + residual; weights arrive weight-normed). At the SISR path's shape,
// one block on a (1, 678, 1020, 24) map with E = 144, M = 20, K = 3, the work
// is 21,312 FLOP per pixel (14.7 GFLOP) against 133 MB of f32 I/O: bound by
// f32 operations (0.22 ms at 67 TFLOP/s) in f32 and by bytes in bf16. An
// unfused chain writes and reads the 144-channel f32 expansion, ~800 MB per
// block; this kernel never does.
//
// Design: one block per 16x16 output tile. Phase 1: one thread per position
// of the tile plus its (K/2)-pixel halo (18x18 = 324 for K = 3) loads the C
// input channels into registers and loops over the E expansion channels:
// h = relu(w1[:, e] . x + b1[e]) is a C-term dot product, then M
// accumulators take h * w2[e, :]. w1, w2, w3 and the biases sit in shared
// memory (about 43 KB f32), read as broadcasts. The M-channel h2 of the tile
// goes to shared memory ([M][positions], conflict-free), 26 KB. Phase 2:
// one thread per output pixel runs the KxK conv M->C from shared memory,
// adds b3 and the residual, rounds once to the I/O dtype and stores. f32
// FMA on CUDA cores throughout; bf16 inputs are widened exactly.
//
// Traps:
// (a) h2 is zero at positions outside the image: the reference pads the KxK
//     conv's input, i.e. AFTER the 1x1 chain. Padding x instead would give
//     relu(b1) . w2 + b2 != 0 on the border ring. Halo threads outside the
//     image write zeros (fused_wdsr_block.py:58-74 masks the same way).
// (b) Any H and W: the Pallas kernel asserts H % tile == 0, a TPU layout
//     rule; here ragged tiles mask their loads and stores (678 LR rows of a
//     DIV2K validation image at x2 are not a multiple of 16).
// (c) Halo cost: phase 1 recomputes the 1x1 chain on the halo, (18*18) /
//     (16*16) = 1.27x that chain's work, ~24.7k FLOP per output pixel
//     against the 21.3k the block needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int up4(int n) { return (n + 3) / 4 * 4; }

template <int C, int E, int M, int K>
struct Geometry {
  static_assert(C % 4 == 0 && M % 4 == 0 && K % 2 == 1, "C, M multiples of 4; K odd");
  static constexpr int P = K / 2;
  static constexpr int HS = TILE + K - 1;              // halo tile side
  static constexpr int HP = HS * HS;                   // halo positions
  static constexpr int THREADS = (HP + 31) / 32 * 32;  // >= TILE * TILE
  // shared memory, in floats; every array starts on a 16-byte boundary
  static constexpr int W1 = 0;                         // [E][C]
  static constexpr int B1 = W1 + up4(E * C);           // [E]
  static constexpr int W2 = B1 + up4(E);               // [E][M]
  static constexpr int B2 = W2 + up4(E * M);           // [M]
  static constexpr int W3 = B2 + up4(M);               // [K*K][M][C]
  static constexpr int B3 = W3 + up4(K * K * M * C);   // [C]
  static constexpr int H2 = B3 + up4(C);               // [M][HP]
  static constexpr int FLOATS = H2 + M * HP;
};

template <typename T, int C, int E, int M, int K>
__global__ void __launch_bounds__(Geometry<C, E, M, K>::THREADS) wdsr_block_kernel(
    const T* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const float* __restrict__ b3, T* __restrict__ y,
    int H, int W, int tiles_w, int tiles_h) {
  using G = Geometry<C, E, M, K>;
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem + G::W1;
  float* b1s = smem + G::B1;
  float* w2s = smem + G::W2;
  float* b2s = smem + G::B2;
  float* w3s = smem + G::W3;
  float* b3s = smem + G::B3;
  float* h2s = smem + G::H2;

  // w1 arrives (C, E); stage it as [E][C] so one expansion channel's weights
  // are contiguous. w2 (E, M) and w3 (K, K, M, C) keep their layouts.
  for (int i = threadIdx.x; i < E * C; i += G::THREADS) w1s[i] = w1[(i % C) * E + i / C];
  for (int i = threadIdx.x; i < E * M; i += G::THREADS) w2s[i] = w2[i];
  for (int i = threadIdx.x; i < K * K * M * C; i += G::THREADS) w3s[i] = w3[i];
  for (int i = threadIdx.x; i < E; i += G::THREADS) b1s[i] = b1[i];
  for (int i = threadIdx.x; i < M; i += G::THREADS) b2s[i] = b2[i];
  for (int i = threadIdx.x; i < C; i += G::THREADS) b3s[i] = b3[i];
  __syncthreads();

  const int tile = blockIdx.x;
  const int tx = tile % tiles_w;
  const int ty = (tile / tiles_w) % tiles_h;
  const int img = tile / (tiles_w * tiles_h);
  const size_t img_off = size_t(img) * H * W;

  // phase 1: h2 at every position of the tile and its halo
  const int p = threadIdx.x;
  if (p < G::HP) {
    const int gy = ty * TILE + p / G::HS - G::P, gx = tx * TILE + p % G::HS - G::P;
    float acc[M];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float xv[C];
      const T* xp = x + (img_off + size_t(gy) * W + gx) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) xv[c] = to_f32(xp[c]);
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = b2s[m];
#pragma unroll 2
      for (int e = 0; e < E; ++e) {
        const float4* wr = reinterpret_cast<const float4*>(w1s + e * C);
        float h = b1s[e];
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 w = wr[q];
          h = fmaf(xv[4 * q], w.x, h);
          h = fmaf(xv[4 * q + 1], w.y, h);
          h = fmaf(xv[4 * q + 2], w.z, h);
          h = fmaf(xv[4 * q + 3], w.w, h);
        }
        h = fmaxf(h, 0.f);
        const float4* vr = reinterpret_cast<const float4*>(w2s + e * M);
#pragma unroll
        for (int q = 0; q < M / 4; ++q) {
          const float4 v = vr[q];
          acc[4 * q] = fmaf(h, v.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(h, v.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(h, v.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(h, v.w, acc[4 * q + 3]);
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = 0.f;  // trap (a): zero outside the image
    }
#pragma unroll
    for (int m = 0; m < M; ++m) h2s[m * G::HP + p] = acc[m];
  }
  __syncthreads();

  // phase 2: KxK conv M -> C, + b3 + residual, one thread per output pixel
  if (threadIdx.x >= TILE * TILE) return;
  const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
  const int oy = ty * TILE + ly, ox = tx * TILE + lx;
  if (oy >= H || ox >= W) return;  // trap (b): ragged tile
  float out[C];
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = b3s[c];
#pragma unroll
  for (int ky = 0; ky < K; ++ky) {
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
      const float* hp = h2s + (ly + ky) * G::HS + lx + kx;
      const float* wt = w3s + (ky * K + kx) * M * C;
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const float hv = hp[m * G::HP];
        const float4* wr = reinterpret_cast<const float4*>(wt + m * C);
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 w = wr[q];
          out[4 * q] = fmaf(hv, w.x, out[4 * q]);
          out[4 * q + 1] = fmaf(hv, w.y, out[4 * q + 1]);
          out[4 * q + 2] = fmaf(hv, w.z, out[4 * q + 2]);
          out[4 * q + 3] = fmaf(hv, w.w, out[4 * q + 3]);
        }
      }
    }
  }
  const size_t o = (img_off + size_t(oy) * W + ox) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) y[o + c] = from_f32<T>(to_f32(x[o + c]) + out[c]);
}

template <typename T, int C, int E, int M, int K>
cudaError_t launch(const void* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3, void* y, int n,
                   int h, int w, cudaStream_t stream) {
  using G = Geometry<C, E, M, K>;
  const size_t smem = size_t(G::FLOATS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wdsr_block_kernel<T, C, E, M, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tiles_w = (w + TILE - 1) / TILE, tiles_h = (h + TILE - 1) / TILE;
  wdsr_block_kernel<T, C, E, M, K><<<tiles_w * tiles_h * n, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), w1, b1, w2, b2, w3, b3, static_cast<T*>(y), h, w, tiles_w,
      tiles_h);
  return cudaGetLastError();
}

}  // namespace

// x (n, h, w, c) bf16 or f32; w1 (c, e), b1 (e,), w2 (e, m), b2 (m,),
// w3 (k, k, m, c), b3 (c,) f32; y (n, h, w, c) in x's dtype; all contiguous,
// y not aliasing x. Instantiated for (c, e, m, k) = (24, 144, 20, 3), the
// WDSR-B block at 24 residual units; anything else returns
// cudaErrorInvalidValue. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after the launch.
extern "C" int fused_wdsr_block_launch(const void* x, const void* w1, const void* b1,
                                       const void* w2, const void* b2, const void* w3,
                                       const void* b3, void* y, int n, int h, int w, int c,
                                       int e, int m, int k, int is_bf16, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return int(cudaErrorInvalidValue);
  if (!(c == 24 && e == 144 && m == 20 && k == 3)) return int(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return int(launch<__nv_bfloat16, 24, 144, 20, 3>(x, f(w1), f(b1), f(w2), f(b2), f(w3),
                                                     f(b3), y, n, h, w, st));
  return int(launch<float, 24, 144, 20, 3>(x, f(w1), f(b1), f(w2), f(b2), f(w3), f(b3), y,
                                           n, h, w, st));
}
