// Kernel B3: the fused WDSR-B residual block,
//   y = x + conv_KxK(zero_pad(W2 . relu(W1 . x + b1) + b2)) + b3,
// with the 6C-channel expansion kept in registers, never in device memory.
//
// Replaces the Pallas kernel mobilesuperresolution_tpu/kernels/
// fused_wdsr_block.py::fused_wdsr_block (1x1 C->6C, ReLU, 1x1 6C->M, KxK
// M->C, + residual; weights arrive weight-normed). At the SISR path's shape,
// one block on a (1, 678, 1020, 24) map with E = 144, M = 20, K = 3, the work
// is 21,312 FLOP per pixel (14.7 GFLOP) against 133 MB of f32 I/O: on CUDA
// cores it is bound by f32 operations (0.22 ms at 67 TFLOP/s). This kernel
// runs the three products on the tensor cores (mma.sync), so in f32 its
// bound is 3x the work at the TF32 rate (3xTF32), and in bf16 the bytes.
// An unfused chain writes and reads the 144-channel expansion; this kernel
// never does.
//
// Design (persistent blocks of 8 warps; one 14x14 output tile at a time,
// whose 16x16 halo is one m16 tile per halo row, two per warp):
// - Weights: packed once on the host (kernels/fused_wdsr_block.py::
//   pack_weights) into mma B-fragment order, padded to the kernel's
//   compile-time widths, split into tf32 hi/lo for f32. Each block copies
//   them into shared memory once, by cp.async, where they fit with the
//   activations (C <= 24 in f32, C <= 48 in bf16); otherwise the
//   products read them from global memory (L1/L2).
// - x: the next tile's 16x16 halo is copied by 16-byte cp.async (zero-filled
//   outside the image) into the second of two buffers while this tile
//   computes. Channel counts whose pixel is not a multiple of 16 bytes are
//   staged by plain loads (slower; never on the path).
// - GEMM 1 and 2 (each warp two halo rows = two m16 tiles): for each chunk
//   of 16 expansion channels, h1 = relu(x W1 + b1) in accumulators, which
//   are GEMM 2's A fragments as they lie (hopper.cuh, the fragment
//   policies): h2 += h1 W2. h2 is written to shared memory, zero at
//   positions outside the image (trap (a)).
// - GEMM 3: the KxK conv as K^2 shifted-tap products over the 196 output
//   pixels (13 m16 tiles, two per warp), A read from the h2 tile; + b3 +
//   the residual from the staged x, rounded once, stored masked (trap (b)).
// - f32 I/O: 3xTF32 (hi·hi + hi·lo + lo·hi, f32 accumulate): near-f32
//   accuracy. bf16 I/O: bf16 operands (x exact; weights, h1 and h2 rounded
//   to bf16), f32 accumulate.
// Widths: every C from 8 to 64 with E = int(6C), M = int(0.84C) (WDSR-B's
// BasicBlock), K = 3: instantiated for padded widths CW in {8, 16, 24, 32,
// 48, 64}; the packing zero-pads K and N to the MMA granularity, and the
// true C and E are run-time values.
//
// Traps:
// (a) h2 is zero at positions outside the image: the reference pads the KxK
//     conv's input, i.e. AFTER the 1x1 chain. Padding x instead would give
//     relu(b1) . w2 + b2 != 0 on the border ring.
// (b) Any H and W: the Pallas kernel asserts H % tile == 0, a TPU layout
//     rule; here ragged tiles mask their stores (678 LR rows of a DIV2K
//     validation image at x2 are not a multiple of 14).
// (c) Halo cost: GEMM 1 and 2 run on the 16x16 halo of a 14x14 tile,
//     1.31x their work per output pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int K3 = 3;                  // the conv's kernel size
constexpr int TO = 14;                 // output tile side
constexpr int HS = TO + K3 - 1;        // halo tile side: one m16 tile per halo row
constexpr int HP = HS * HS;            // halo positions
constexpr int OUT_PX = TO * TO;        // output pixels per tile
constexpr int SMEM_MAX = 232448;
constexpr int MT = 2;                  // m16 tiles (halo rows) per warp: each B fragment feeds two
constexpr int THREADS = 32 * HS / MT;  // 8 warps cover the 16 halo rows
static_assert(HS == 16 && (OUT_PX + 15) / 16 <= MT * THREADS / 32, "m16 tiles: one per halo row, MT per warp");

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
// A row stride >= n that is = 8 (mod 16) elements: the element-view loads of
// a warp (rows g, columns 2t) then hit distinct banks, f32 and bf16 alike.
__host__ __device__ constexpr int stride_for(int n) { return (n + 7) / 16 * 16 + 8; }

template <typename T, int CW>
struct Geo {
  using P = typename PolicyOf<T>::type;
  static constexpr int KG = P::KG, BW = P::BW;
  static constexpr int KC = round_up(CW, KG);           // GEMM 1 depth (input channels)
  static constexpr int MK = round_up(int(0.84 * CW), KG);  // GEMM 2 width, GEMM 3 depth
  static constexpr int NC = CW;                         // GEMM 3 width (output channels)
  static constexpr int S1 = KC / KG, NM = MK / 8, S3 = MK / KG, NN = NC / 8;
  static constexpr int XS = stride_for(KC), HST = stride_for(MK);
  static constexpr int A_REGS = int(sizeof(typename P::A) / 4);  // registers per A fragment
  static constexpr bool HOLD = S1 * MT * A_REGS <= 48;  // keep GEMM 1's A in registers
  // packed layout (floats), for EP = E rounded up to 16
  __host__ __device__ static constexpr int w1_floats(int ep) { return S1 * (ep / 8) * 32 * BW; }
  __host__ __device__ static constexpr int w2_floats(int ep) { return (ep / KG) * NM * 32 * BW; }
  __host__ __device__ static constexpr int w3_floats() { return K3 * K3 * S3 * NN * 32 * BW; }
  __host__ __device__ static constexpr int floats(int ep) { return w1_floats(ep) + w2_floats(ep) + w3_floats() + ep + MK + NC; }
  static constexpr size_t act_bytes() { return (size_t(2) * HP * XS + size_t(HP) * HST) * sizeof(T); }
  // weights staged in shared memory when they fit beside the activations at
  // the widest E this width takes (E = 6 CW); otherwise read from global
  static constexpr bool STAGE = act_bytes() + size_t(floats(round_up(int(6.0 * CW), 16))) * 4 <= SMEM_MAX;
};

template <typename T, int CW>
__global__ void __launch_bounds__(THREADS, 1) wdsr_block_kernel(
    const T* __restrict__ x, const float* __restrict__ packed, T* __restrict__ y, int H, int W, int C,
    int EP, int tiles_w, int tiles_h, int ntiles) {
  using G = Geo<T, CW>;
  constexpr int NWARPS = THREADS / 32;
  using P = typename G::P;
  constexpr int KG = G::KG, BW = G::BW, XS = G::XS, HST = G::HST;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                        // [2][HP][XS]
  T* hs = xs + 2 * HP * XS;                                  // [HP][HST]
  float* ws = reinterpret_cast<float*>(hs + HP * HST);       // the packed weights, when staged

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int o_w2 = G::w1_floats(EP), o_w3 = o_w2 + G::w2_floats(EP), o_b1 = o_w3 + G::w3_floats();
  const int o_b2 = o_b1 + EP, o_b3 = o_b2 + G::MK, nw = o_b3 + G::NC;
  const T zero = from_float<T>(0.f);

  // x: 16-byte chunks by cp.async when a pixel is a whole number of them;
  // the pad columns [C, XS) are then zeroed once here and never written.
  constexpr int EL16 = 16 / int(sizeof(T));
  const bool vec = C % EL16 == 0;
  if (vec) {
    const int padc = XS - C;
    for (int i = tid; i < 2 * HP * padc; i += THREADS) xs[(i / padc) * XS + C + i % padc] = zero;
  }
  const int cpp = vec ? C / EL16 : G::KC;  // copy units per pixel
  const int unit = tid % cpp, p_first = tid / cpp, p_step = THREADS / cpp;

  auto decode = [&](int tile, int& img, int& y0, int& x0) {
    const int tx = tile % tiles_w, ty = (tile / tiles_w) % tiles_h;
    img = tile / (tiles_w * tiles_h);
    y0 = ty * TO - 1;
    x0 = tx * TO - 1;
  };
  auto stage_x = [&](int buf, int tile) {
    int img, y0, x0;
    decode(tile, img, y0, x0);
    T* dst = xs + buf * HP * XS;
    if (tid >= p_step * cpp) return;
    for (int p = p_first; p < HP; p += p_step) {
      const int gy = y0 + p / HS, gx = x0 + p % HS;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = x + ((size_t(img) * H + (in ? gy : 0)) * W + (in ? gx : 0)) * C;
      if (vec) {
        cp_async16(smem_u32(dst + p * XS + unit * EL16), src + unit * EL16, in);
      } else {
        dst[p * XS + unit] = (in && unit < C) ? src[unit] : zero;
      }
    }
  };

  if (blockIdx.x < ntiles) {
    if constexpr (G::STAGE)
      for (int i = 4 * tid; i < nw; i += 4 * THREADS) cp_async16(smem_u32(ws + i), packed + i, true);
    stage_x(0, blockIdx.x);
    cp_async_commit();
  }
  const float* wb = G::STAGE ? ws : packed;

  for (int tile = blockIdx.x, buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < ntiles) {
      stage_x(buf ^ 1, tile + gridDim.x);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xb = xs + buf * HP * XS;
    int img, y0, x0;
    decode(tile, img, y0, x0);

    // ---- GEMM 1 + 2 on this warp's halo rows ----
    {
      float acc2[MT][G::NM][4];
#pragma unroll
      for (int n = 0; n < G::NM; ++n) {
        const float b0 = wb[o_b2 + 8 * n + 2 * t], b1v = wb[o_b2 + 8 * n + 2 * t + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc2[mt][n][0] = acc2[mt][n][2] = b0;
          acc2[mt][n][1] = acc2[mt][n][3] = b1v;
        }
      }
      const T* xr[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) xr[mt] = xb + (16 * (MT * warp + mt) + g) * XS;
      typename P::A held[G::HOLD ? G::S1 : 1][MT];
      if constexpr (G::HOLD) {
#pragma unroll
        for (int s = 0; s < G::S1; ++s)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) held[s][mt] = P::load_a(xr[mt], xr[mt] + 8 * XS, s, t);
      }
#pragma unroll 1
      for (int ec = 0; ec < EP / 16; ++ec) {
        float acc1[MT][2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float b0 = wb[o_b1 + 16 * ec + 8 * j + 2 * t], b1v = wb[o_b1 + 16 * ec + 8 * j + 2 * t + 1];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc1[mt][j][0] = acc1[mt][j][2] = b0;
            acc1[mt][j][1] = acc1[mt][j][3] = b1v;
          }
        }
#pragma unroll
        for (int s = 0; s < G::S1; ++s) {
          typename P::A a[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (G::HOLD) a[mt] = held[s][mt];
            else a[mt] = P::load_a(xr[mt], xr[mt] + 8 * XS, s, t);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const typename P::B b = P::load_b(wb + ((s * (EP / 8) + 2 * ec + j) * 32 + lane) * BW);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) P::mma(acc1[mt][j], a[mt], b);
          }
        }
        // relu; the accumulators are GEMM 2's A in the element view
#pragma unroll
        for (int st = 0; st < 16 / KG; ++st) {
          typename P::A a[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float v[KG / 2];
#pragma unroll
            for (int i = 0; i < KG / 2; ++i) v[i] = fmaxf(acc1[mt][st + i / 4][i % 4], 0.f);
            a[mt] = P::make_a(v);
          }
#pragma unroll
          for (int n = 0; n < G::NM; ++n) {
            const typename P::B b = P::load_b(wb + o_w2 + (((ec * (16 / KG) + st) * G::NM + n) * 32 + lane) * BW);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) P::mma(acc2[mt][n], a[mt], b);
          }
        }
      }
      // h2 to shared memory, zero outside the image (trap (a))
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int hr = MT * warp + mt;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int hc = g + 8 * h, gy = y0 + hr, gx = x0 + hc;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          T* dst = hs + (hr * HS + hc) * HST + 2 * t;
#pragma unroll
          for (int n = 0; n < G::NM; ++n)
            store_pair(dst + 8 * n, in ? acc2[mt][n][2 * h] : 0.f, in ? acc2[mt][n][2 * h + 1] : 0.f);
        }
      }
    }
    __syncthreads();

    // ---- GEMM 3: the KxK conv over the output pixels, + b3 + x ----
    {
      float acc3[MT][G::NN][4];
#pragma unroll
      for (int n = 0; n < G::NN; ++n) {
        const float b0 = wb[o_b3 + 8 * n + 2 * t], b1v = wb[o_b3 + 8 * n + 2 * t + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc3[mt][n][0] = acc3[mt][n][2] = b0;
          acc3[mt][n][1] = acc3[mt][n][3] = b1v;
        }
      }
      int pos[MT][2];  // halo position of each row's top-left tap (pixel 0 for pad rows)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * (warp + NWARPS * mt) + g + 8 * h, qq = q < OUT_PX ? q : 0;
          pos[mt][h] = (qq / TO) * HS + qq % TO;
        }
#pragma unroll 1
      for (int tap = 0; tap < K3 * K3; ++tap) {
        const int off = (tap / K3) * HS + tap % K3;
#pragma unroll
        for (int s = 0; s < G::S3; ++s) {
          typename P::A a[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            a[mt] = P::load_a(hs + (pos[mt][0] + off) * HST, hs + (pos[mt][1] + off) * HST, s, t);
#pragma unroll
          for (int n = 0; n < G::NN; ++n) {
            const typename P::B b = P::load_b(wb + o_w3 + (((tap * G::S3 + s) * G::NN + n) * 32 + lane) * BW);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) P::mma(acc3[mt][n], a[mt], b);
          }
        }
      }
      const int oy0 = y0 + 1, ox0 = x0 + 1;
      const bool pairs = C % 2 == 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * (warp + NWARPS * mt) + g + 8 * h;
          const int oy = oy0 + q / TO, ox = ox0 + q % TO;
          if (q >= OUT_PX || oy >= H || ox >= W) continue;  // trap (b)
          const T* res = xb + (pos[mt][h] + HS + 1) * XS;   // the centre tap's x
          T* out = y + ((size_t(img) * H + oy) * W + ox) * C;
#pragma unroll
          for (int n = 0; n < G::NN; ++n) {
            const int ch = 8 * n + 2 * t;
            if (ch >= C) continue;
            const float v0 = acc3[mt][n][2 * h] + to_float(res[ch]);
            const float v1 = acc3[mt][n][2 * h + 1] + to_float(res[ch + 1]);
            if (pairs) {
              store_pair(out + ch, v0, v1);
            } else {
              out[ch] = from_float<T>(v0);
              if (ch + 1 < C) out[ch + 1] = from_float<T>(v1);
            }
          }
        }
    }
    __syncthreads();  // h2 and this x buffer are free for the next tiles
  }
}

template <typename T, int CW>
cudaError_t launch(const void* x, const float* packed, void* y, int n, int h, int w, int c, int e,
                   cudaStream_t stream) {
  using G = Geo<T, CW>;
  const int ep = round_up(e, 16);
  const int smem = int(G::act_bytes() + (G::STAGE ? size_t(G::floats(ep)) * sizeof(float) : 0));
  auto kern = wdsr_block_kernel<T, CW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem)) != cudaSuccess)
    return err;
  const int tiles_w = (w + TO - 1) / TO, tiles_h = (h + TO - 1) / TO, ntiles = tiles_w * tiles_h * n;
  const int grid = std::max(1, std::min(ntiles, std::max(per_sm, 1) * sms));
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), packed, static_cast<T*>(y), h, w, c, ep,
                                        tiles_w, tiles_h, ntiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int c, const void* x, const float* packed, void* y, int n, int h, int w, int e,
                     cudaStream_t st) {
  if (c <= 8) return launch<T, 8>(x, packed, y, n, h, w, c, e, st);
  if (c <= 16) return launch<T, 16>(x, packed, y, n, h, w, c, e, st);
  if (c <= 24) return launch<T, 24>(x, packed, y, n, h, w, c, e, st);
  if (c <= 32) return launch<T, 32>(x, packed, y, n, h, w, c, e, st);
  if (c <= 48) return launch<T, 48>(x, packed, y, n, h, w, c, e, st);
  return launch<T, 64>(x, packed, y, n, h, w, c, e, st);
}

}  // namespace

// x (n, h, w, c) bf16 or f32; packed: kernels/fused_wdsr_block.py::
// pack_weights(w1, b1, w2, b2, w3, b3, dtype) for the block's (c, e = int(6c),
// m = int(0.84c), k = 3), f32 words; y (n, h, w, c) in x's dtype; all
// contiguous, y not aliasing x. Takes 8 <= c <= 64; anything else returns
// cudaErrorInvalidValue. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after the launch.
extern "C" int fused_wdsr_block_launch(const void* x, const void* packed, void* y, int n, int h, int w, int c,
                                       int e, int m, int k, int is_bf16, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c < 8 || c > 64 || k != K3) return int(cudaErrorInvalidValue);
  if (e != int(6.0 * c) || m != int(0.84 * c)) return int(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return int(dispatch<__nv_bfloat16>(c, x, p, y, n, h, w, e, st));
  return int(dispatch<float>(c, x, p, y, n, h, w, e, st));
}
