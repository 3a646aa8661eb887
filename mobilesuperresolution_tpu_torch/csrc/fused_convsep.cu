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
// Design: one block of 256 threads per 16x16 output tile. The tile's input
// and its (K-1)-pixel halo are staged in shared memory as f32 channel planes
// ([C][rows][RS]), zero outside the image (SAME zero padding); the
// depthwise weights as [C][K*K] and W_p as [C][C_out]. One thread per output
// pixel walks the C channels: the K*K depthwise taps of channel c (weights
// loaded to registers as float4s), + b_d, ReLU, then C_out FMAs into its
// output accumulators with W_p's row c read as float4 broadcasts. bf16 inputs
// widen exactly at staging; the f32 sums round once to the I/O dtype.
//
// Traps:
// (a) Any H and W: the Pallas kernel asserts H % tile == 0 and materialises
//     overlapping row windows in HBM, both TPU layout rules. Here the halo
//     comes from global memory with a bounds check and ragged tiles mask
//     their stores (678 rows of a DIV2K validation image at x2).
// (b) Bank conflicts: a warp is 16 pixels of tile row r and 16 of row r + 8,
//     and the plane's row stride RS is = 2 (mod 4), so the two half-warps'
//     reads differ by 8 RS = 16 (mod 32) banks and never collide. Planes are
//     = 1 (mod 8) floats long, so the staging writes (4 channels per thread)
//     spread over the banks too.
// (c) Shared memory: at K = 7, C = 32 the halo tile is 22x22x32 f32 = 62 KB,
//     74 KB with the weights, above the 48 KB default: the launcher opts in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;

constexpr int up4(int n) { return (n + 3) / 4 * 4; }

template <int C, int CO, int K>
struct Geometry {
  static_assert(C % 4 == 0 && CO % 4 == 0 && K % 2 == 1, "C, C_out multiples of 4; K odd");
  static constexpr int P = K / 2;
  static constexpr int HS = TILE + K - 1;                   // halo tile side
  static constexpr int RS = HS % 4 == 2 ? HS : HS + 2;      // row stride, = 2 (mod 4)
  static constexpr int PLANE = (HS * RS + 7) / 8 * 8 + 1;   // = 1 (mod 8)
  static constexpr int KKP = up4(K * K);                    // taps per channel, padded
  // shared memory, in floats; the weight arrays start on 16-byte boundaries
  static constexpr int WD = 0;                              // [C][KKP]
  static constexpr int WP = WD + C * KKP;                   // [C][CO]
  static constexpr int BD = WP + C * CO;                    // [C]
  static constexpr int BP = BD + up4(C);                    // [CO]
  static constexpr int XS = BP + up4(CO);                   // [C][PLANE]
  static constexpr int FLOATS = XS + C * PLANE;
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

template <typename T, int C, int CO, int K>
__global__ void __launch_bounds__(THREADS) convsep_kernel(
    const T* __restrict__ x, const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ wp, const float* __restrict__ bp, T* __restrict__ y, int H,
    int W, int tiles_w, int tiles_h) {
  using G = Geometry<C, CO, K>;
  extern __shared__ __align__(16) float smem[];
  float* wds = smem + G::WD;
  float* wps = smem + G::WP;
  float* bds = smem + G::BD;
  float* bps = smem + G::BP;
  float* xs = smem + G::XS;

  // w_depth arrives (K, K, C): stage it as [C][KKP] so one channel's taps
  // are contiguous (the pad taps are never read)
  for (int i = threadIdx.x; i < K * K * C; i += THREADS) wds[(i % C) * G::KKP + i / C] = wd[i];
  for (int i = threadIdx.x; i < C * CO; i += THREADS) wps[i] = wp[i];
  for (int i = threadIdx.x; i < C; i += THREADS) bds[i] = bd[i];
  for (int i = threadIdx.x; i < CO; i += THREADS) bps[i] = bp[i];

  const int tile = blockIdx.x;
  const int tx = tile % tiles_w;
  const int ty = (tile / tiles_w) % tiles_h;
  const int img = tile / (tiles_w * tiles_h);
  const size_t img_off = size_t(img) * H * W;

  // stage the halo tile, 4 channels per thread and step: neighbouring
  // threads read neighbouring channel groups of one pixel (coalesced)
  constexpr int C4 = C / 4;
  for (int i = threadIdx.x; i < G::HS * G::HS * C4; i += THREADS) {
    const int c0 = (i % C4) * 4, pos = i / C4;
    const int r = pos / G::HS, col = pos % G::HS;
    const int gy = ty * TILE + r - G::P, gx = tx * TILE + col - G::P;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) load4(x + (img_off + size_t(gy) * W + gx) * C + c0, v);
    float* dst = xs + c0 * G::PLANE + r * G::RS + col;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j * G::PLANE] = v[j];
  }
  __syncthreads();

  // trap (b): lanes 0-15 take row `warp`, lanes 16-31 row `warp + 8`
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lx = lane & 15, ly = warp + ((lane >> 4) << 3);
  const int oy = ty * TILE + ly, ox = tx * TILE + lx;
  if (oy >= H || ox >= W) return;  // trap (a): ragged tile

  float out[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) out[o] = bps[o];
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    float w[G::KKP];
#pragma unroll
    for (int q = 0; q < G::KKP / 4; ++q) load4(wds + c * G::KKP + 4 * q, w + 4 * q);
    const float* xp = xs + c * G::PLANE + ly * G::RS + lx;
    float acc = bds[c];
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) acc = fmaf(xp[ky * G::RS + kx], w[ky * K + kx], acc);
    }
    acc = fmaxf(acc, 0.f);
    const float4* wr = reinterpret_cast<const float4*>(wps + c * CO);
#pragma unroll
    for (int q = 0; q < CO / 4; ++q) {
      const float4 v = wr[q];
      out[4 * q] = fmaf(acc, v.x, out[4 * q]);
      out[4 * q + 1] = fmaf(acc, v.y, out[4 * q + 1]);
      out[4 * q + 2] = fmaf(acc, v.z, out[4 * q + 2]);
      out[4 * q + 3] = fmaf(acc, v.w, out[4 * q + 3]);
    }
  }
  T* yp = y + (img_off + size_t(oy) * W + ox) * CO;
#pragma unroll
  for (int q = 0; q < CO / 4; ++q) store4(yp + 4 * q, out + 4 * q);
}

template <typename T, int C, int CO, int K>
cudaError_t launch(const void* x, const float* wd, const float* bd, const float* wp,
                   const float* bp, void* y, int n, int h, int w, cudaStream_t stream) {
  using G = Geometry<C, CO, K>;
  const size_t smem = size_t(G::FLOATS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      convsep_kernel<T, C, CO, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tiles_w = (w + TILE - 1) / TILE, tiles_h = (h + TILE - 1) / TILE;
  convsep_kernel<T, C, CO, K><<<tiles_w * tiles_h * n, THREADS, smem, stream>>>(
      static_cast<const T*>(x), wd, bd, wp, bp, static_cast<T*>(y), h, w, tiles_w, tiles_h);
  return cudaGetLastError();
}

template <typename T, int C, int CO>
cudaError_t dispatch_k(int k, const void* x, const float* wd, const float* bd, const float* wp,
                       const float* bp, void* y, int n, int h, int w, cudaStream_t st) {
  switch (k) {
    case 3: return launch<T, C, CO, 3>(x, wd, bd, wp, bp, y, n, h, w, st);
    case 5: return launch<T, C, CO, 5>(x, wd, bd, wp, bp, y, n, h, w, st);
    case 7: return launch<T, C, CO, 7>(x, wd, bd, wp, bp, y, n, h, w, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int c, int co, int k, const void* x, const float* wd, const float* bd,
                     const float* wp, const float* bp, void* y, int n, int h, int w,
                     cudaStream_t st) {
  if (c == 32 && co == 32) return dispatch_k<T, 32, 32>(k, x, wd, bd, wp, bp, y, n, h, w, st);
  if (c == 8 && co == 8) return dispatch_k<T, 8, 8>(k, x, wd, bd, wp, bp, y, n, h, w, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (n, h, w, c) bf16 or f32; w_depth (k, k, c), b_depth (c,), w_point
// (c, c_out), b_point (c_out,) f32; y (n, h, w, c_out) in x's dtype; all
// contiguous, y not aliasing x. Instantiated for (c, c_out) in {(32, 32),
// (8, 8)} (the supernet at 32 units and the tiny parity width) and k in
// {3, 5, 7}; anything else returns cudaErrorInvalidValue. Launches on
// `stream`, does not synchronise, returns cudaGetLastError() after the launch.
extern "C" int fused_convsep_launch(const void* x, const void* wd, const void* bd,
                                    const void* wp, const void* bp, void* y, int n, int h,
                                    int w, int c, int c_out, int k, int is_bf16,
                                    void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return int(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return int(dispatch<__nv_bfloat16>(c, c_out, k, x, f(wd), f(bd), f(wp), f(bp), y, n, h, w, st));
  return int(dispatch<float>(c, c_out, k, x, f(wd), f(bd), f(wp), f(bp), y, n, h, w, st));
}
