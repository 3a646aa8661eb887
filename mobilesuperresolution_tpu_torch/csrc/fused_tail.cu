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
// Design (both dtypes, fused_tail_mma_kernel): an implicit GEMM on the tensor
// cores with mma.sync and ldmatrix. M is a tile of 8 x 16 conv positions (a
// warp owns two rows: two m16 tiles), K is KH*KW*Cin (192 on the bf16 path),
// N the conv channels of one group rounded up to 8. A bf16 block is 4 warps;
// an f32 block 8, its two halves splitting N (one block an SM at
// basic_origin's upconvs: two warps a scheduler keep the tensor pipe
// busier than one; 10 % faster there on an H100). bf16 runs m16n8k16; f32
// runs 3xTF32 on m16n8k8 (hopper.cuh's Tf32x3: hi = tf32(v), lo = v - hi,
// lo·hi + hi·lo + hi·hi summed in f32), split in the kernel as each fragment
// is loaded, so training's live weights need no packing on the host. A k-step
// is 32 bytes of a pixel in both dtypes (16 bf16, 8 f32), so one ldmatrix.x4
// address pattern loads A for both: over 32-bit elements it leaves the tf32
// fragment in PTX order. B is read by ldmatrix.trans in bf16 and by two
// 4-byte loads a lane in f32 (ldmatrix cannot transpose 32-bit elements);
// the weight row stride, (NB | 1) x 8 elements, keeps both free of bank
// conflicts. The grid is persistent (as many blocks as fit, each walking
// tiles):
// - the weights (rounded to the I/O dtype by the wrapper) are staged once
//   per block;
// - the input halo is staged with 16-byte cp.async (zero-filled outside the
//   image and past Cin), double-buffered: the next tile's copy is in flight
//   during this tile's MMAs. The pixel stride is an odd multiple of 16 bytes,
//   so ldmatrix phases are free of bank conflicts;
// - the epilogue adds the bias in f32, rounds once, writes the depth-to-space
//   tile into the tile's own (now free) halo buffer in output order, then
//   copies it out one output row per warp, consecutive lanes on consecutive
//   4-byte words (a bf16 row of y is 2-byte aligned only: one element is
//   peeled). The crop masks the last partial tiles.
// Bounds: the bf16 main path (10, 240, 426, 48) -> (10, 961, 1705, 3) is
// bound by bytes (0.059 ms; its 19 GFLOP need ~0.03 ms at mma.sync's rate).
// f32 at basic_origin's upconv2, (20, 128, 128, 64) 3x3 -> 256 conv
// channels, is 96.6 GFLOP: 0.59 ms at 3xTF32 (165 TFLOP/s, a third of the
// TF32 dense rate), bound by operations; what bounds the kernel is
// mma.sync's TF32 rate, a fraction of wgmma's, times the three products per
// term, and one block of 8 warps an SM (a group's 92 KB of weights beside
// two halos). The f32 VSR tail (20, 64, 64, 48) 2x2 -> 48, s 4, is bound by
// bytes (0.009 ms).
// Any KH, KW, padding, s <= 8, crop, Cin and Cc are taken: weights too large
// to stage at once are staged per chunk of input channels and group of kernel
// rows (slower; never on the paths), and Cin or Cc not a multiple of a
// 16-byte piece stage through a synchronous zero-filling loop. Each output's
// K is summed in an order fixed by KH, KW, Cin, Cc and s (the plan), never by
// N, H or W: two calls, and a height-sharded window, give the same bits.
//
// Channel groups: the conv channels are tiled over the grid's y dimension in
// groups, each a multiple of s^2, so a group owns whole output channels of
// the shuffle: at most 64 in bf16 (64 for s 1, 2, 4 and 8, 63 for s 3); in
// f32 64 where the group's weights and two halos fit shared memory at once,
// else at most 32 (or s^2 when s^2 > 32). BasicVSROrigin's upconvs (3x3, 64
// -> 256 conv channels, s 2) run as 4 groups of 64 in bf16 (74 KB of
// weights; all 256 channels' 295 KB would not fit) and 8 groups of 32 in f32
// (92 KB; a group of 64 is 166 KB, too much beside two 49 KB halos). A
// group's stage then holds Cg / s^2 of the output channels of each pixel,
// and the copy-out writes them as runs at the pixel stride. The blocks of the
// groups walk the same tiles in the same order, so a tile's halo is read from
// device memory about once and from L2 by the others.
// Optional epilogue: leaky ReLU (slope 0.1) after the bias, in f32 before the
// one rounding (elementwise, so it commutes with the shuffle and the crop).
//
// Kernel B4 is the WDSR / ResultNet tail
// (mobilesuperresolution_tpu/models/wdsr_basic.py:67-74, result_net.py:74-77):
// depth_to_space(conv3x3(body) + conv5x5(x_skip) + bias, s), where the 5x5
// skip conv reads the mean-subtracted input (<= 3 channels, 3 in the models).
// At the SISR path's shape, body (1, 678, 1020, 24) 3x3 -> 12 and skip
// (1, 678, 1020, 3) 5x5 -> 12 at s = 2, it is 4.83 GFLOP and ~108 MB in f32
// (54 MB in bf16): bound by bytes on the tensor cores (0.032 ms in f32 at the
// 3xTF32 rate, 0.016 ms in bf16). Design (tail_skip_kernel):
// - One implicit GEMM on mma.sync with one set of f32 accumulators: M is a
//   tile of 8 x 16 conv positions (a warp owns two conv rows, two m16 tiles),
//   N the conv channels rounded up to 16 (12 -> 16, 27 -> 32, 48 -> 48), K
//   the body segment (3 kernel rows) followed by the skip segment (5 kernel
//   rows). f32 I/O runs 3xTF32 (m16n8k8), bf16 I/O bf16 (m16n8k16), with
//   hopper.cuh's Tf32x3 / Bf16 fragment policies.
// - Row-contiguous K: a halo stores each pixel's channels at a fixed stride
//   (cp, zero-padded), so the KW taps of one kernel row are KW*cp contiguous
//   values of one halo row, read as one K run rounded up to the k-step; the
//   values past KW*cp meet zero weight rows. The 3-channel skip is staged at
//   stride 3 in f32 (a kernel row is 15 values, 16 issued: K 80 for 75
//   useful) and 4 in bf16 (20 values, 32 issued: K 160), instead of a k-step
//   per tap (K 200 in TF32, 400 in bf16). The body's cp
//   (kernels/fused_tail.py::_pixel_stride) keeps the A loads of a warp free of
//   bank conflicts where that is cheaper than the extra K.
// - Weights: packed once on the host (kernels/fused_tail.py::pack_weights)
//   into fragment order (TF32 hi/lo split for f32) with the fused bias,
//   copied into shared memory once per block where they fit (every width in
//   bf16; f32 up to about 40 KB of activations), else read through L1.
// - Persistent grid, one block barrier per tile. The next tile's body halo
//   is copied during this tile's MMAs: one TMA box (zero-filled outside the
//   image and past Cin; every width whose pixel is a whole number of 16-byte
//   chunks, as WDSR-B's are) or, for the others, 4-byte cp.async units (bf16
//   of an odd width: elements). Its skip
//   halo (12 or 6 bytes a pixel, not copyable in aligned units) is loaded
//   into registers before the MMAs and written to the other skip buffer at
//   its stride after the epilogue. Staging by 128 threads' copies
//   stalled on the memory queue for as long as the body's MMAs took.
// - Epilogue, per warp (a warp's two conv rows are its own 2s output rows):
//   bias in f32, one rounding, depth-to-space into the warp's stage in
//   output order, then its rows out to y as one TMA box (clipped at the
//   image's edges) where a y row is a whole number of 16-byte chunks, else
//   row by row with coalesced 4-byte stores; the padded channels (27 -> 32
//   at x3) are never staged.
// Takes 1 <= Cin <= 64, skip channels <= 3, conv channels <= 64, any s and
// any H, W; kernels/fused_tail.py raises on the rest.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int GROUP_MAX = 64;      // conv channels one block computes, at most
constexpr int GROUP_MAX_F32 = 32;  // f32, where a group of GROUP_MAX does not stage at once
constexpr float LRELU_SLOPE = 0.1f;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Conv channels of one group: the most, up to gmax, that are a multiple of
// s^2 (s^2 itself when s^2 > gmax; s^2 <= GROUP_MAX), never more than cc.
inline int group_width(int cc, int s, int gmax = GROUP_MAX) {
  const int ss = s * s, g = ss > gmax ? ss : gmax / ss * ss;
  return cc < g ? cc : g;
}

__device__ __forceinline__ float epilogue(float v, int act) {
  return (act && v < 0.f) ? v * LRELU_SLOPE : v;
}

bool bad_geometry(int n, int hc, int wc, int cin, int cc, int s) {
  return n <= 0 || hc <= 0 || wc <= 0 || cin <= 0 || cc <= 0 || s <= 0 || s * s > GROUP_MAX || cc % (s * s) != 0;
}

// ---- B2: tensor cores (mma.sync: m16n8k16 bf16, 3xTF32 m16n8k8 f32), persistent grid ----

constexpr int M_TH = 8;    // conv rows per tile (two per warp)
constexpr int M_TW = 16;   // conv columns per tile (one m16 per conv row)
constexpr int M_THREADS = 128;
constexpr int M_SMEM_MAX = 232448;

// Shared-memory plan of one launch, computed on the host and passed by value.
struct MmaPlan {
  int gw;           // conv channels of one group (a multiple of s^2)
  int kch;          // input channels per halo chunk (a multiple of the k-step)
  int kyg;          // kernel rows whose weights are staged together
  int hw;           // halo width, M_TW + KW - 1
  int pstr;         // halo pixel stride in bytes: an odd number of 16-byte chunks
  int wstr;         // weight row stride in bytes: (NB | 1) x 8 elements
  int halo_bytes;   // one halo buffer; once its tile's MMAs are done, the tile's output stage
  int wts_bytes;
};

// The products of kernel rows ky0 .. ky1 - 1 over `ksteps` k-steps of the
// staged chunk, for the warp's two m16 tiles and NB n8 tiles (bf16).
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

// The f32 form of tail_mma_piece (3xTF32, the same K order: ky, kx, k-step)
// for NB n8 tiles from tile q0, loading the next step's fragments while this
// step's products run. B (k t, n g) and (k t + 4, n g) of each n8 tile come
// by 4-byte loads: the row stride, 8 mod 16 words, puts a warp's 32 loads on
// 32 banks.
template <int NB>
__device__ __forceinline__ void tail_mma_piece_f32(float (&acc)[2][NB][4], uint32_t halo_s,
                                                   const unsigned char* wts, const MmaPlan& pl, int KW, int ky0,
                                                   int ky1, int ksteps, int warp, int q0, int lane) {
  const int g = lane >> 2, t = lane & 3, w4 = pl.wstr / 4;
  const int steps = (ky1 - ky0) * KW * ksteps;
  uint32_t a[2][4];
  float b[NB][2];
  auto load = [&](int ky, int kx, int ks) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int p = (2 * warp + mi + ky) * pl.hw + (lane & 15) + kx;
      ldmatrix_x4(a[mi], halo_s + p * pl.pstr + (ks * 2 + (lane >> 4)) * 16);
    }
    const float* wr =
        reinterpret_cast<const float*>(wts + (((ky - ky0) * KW + kx) * pl.kch + 8 * ks + t) * pl.wstr) + 8 * q0 + g;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      b[q][0] = wr[8 * q];
      b[q][1] = wr[4 * w4 + 8 * q];
    }
  };
  int ky = ky0, kx = 0, ks = 0;
  load(ky, kx, ks);
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const Tf32x3::A af[2] = {Tf32x3::split_a(a[0]), Tf32x3::split_a(a[1])};
    Tf32x3::B bf[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) bf[q] = Tf32x3::split_b(b[q][0], b[q][1]);
    if (++ks == ksteps) {
      ks = 0;
      if (++kx == KW) {
        kx = 0;
        ++ky;
      }
    }
    if (i + 1 < steps) load(ky, kx, ks);
    mma_tf32x3<2, NB>(acc, af, bf);
  }
}

// The warps of a block and the n8 tiles each computes: bf16 4 warps, each
// all NB tiles of its two conv rows; f32 8 warps, the block's two halves
// splitting the NB tiles (3xTF32 issues three products a term: with one
// block an SM, two warps a scheduler keep its tensor pipe fed). A weight row
// holds WN x NBW tiles (the last one zero-padded where NB is odd).
template <typename T, int NB>
struct TailWarps {
  static constexpr int WN = sizeof(T) == 4 ? 2 : 1;  // warps along N
  static constexpr int THREADS = 128 * WN;
  static constexpr int NBW = (NB + WN - 1) / WN;     // n8 tiles a warp
};

// Up to 48 conv channels a block (NB <= 6: the serving tails) the bf16
// kernel keeps to <= 170 registers a thread, so that 3 blocks fit an SM;
// without the bound ptxas gave NB 6 226 registers, 2 blocks per SM, and the
// serving tail ran slower on an H100. Wider groups (BasicVSROrigin's
// upconvs) stage 74+ KB of weights, 1 block per SM, and keep every register:
// capped, they ran slower. f32 keeps every register too.
template <typename T, int NB>
__global__ void __launch_bounds__(TailWarps<T, NB>::THREADS, sizeof(T) == 4 || NB > 6 ? 1 : 3) fused_tail_mma_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
    int KH, int KW, int pad_t, int pad_l, int Cc, int s, int Hc, int Wc, int out_h, int out_w,
    int tiles_w, int tiles_h, int ntiles, int act, MmaPlan pl) {
  constexpr int KG = PolicyOf<T>::type::KG, EPC = 16 / int(sizeof(T));  // k per step; elements a 16-byte piece
  constexpr int THR = TailWarps<T, NB>::THREADS, NBW = TailWarps<T, NB>::NBW;
  using T2 = typename std::conditional<sizeof(T) == 2, __nv_bfloat162, float2>::type;
  extern __shared__ __align__(128) unsigned char tail_smem[];
  unsigned char* halo = tail_smem;                     // [2][HH * hw] pixels of pstr bytes
  unsigned char* wts = tail_smem + 2 * pl.halo_bytes;  // [kyg * KW * kch] rows of wstr bytes
  const uint32_t halo_s = smem_u32(halo), wts_s = smem_u32(wts);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, q0 = (warp >> 2) * NBW;  // the warp's conv rows 2 wm, 2 wm + 1; its n8 tiles from q0
  const int ss = s * s, C = Cc / ss, HH = M_TH + KH - 1;
  // this block's channel group: conv channels n0 .. n0 + Cg - 1, output
  // channels c0 .. c0 + Cs - 1 of C
  const int gw = pl.gw, n0 = blockIdx.y * gw, Cg = min(gw, Cc - n0);
  const int Cs = Cg / ss, c0 = n0 / ss;
  const int cin_pad = round_up(Cin, KG);
  const int nchunks = (cin_pad + pl.kch - 1) / pl.kch, nkg = (KH + pl.kyg - 1) / pl.kyg;
  const bool resident = nchunks == 1 && nkg == 1;
  const bool vec_x = Cin % EPC == 0, vec_w = Cc % EPC == 0 && gw % EPC == 0;
  const T zero = from_float<T>(0.f);

  // Where the group's conv channel n (n0 + n = c*s^2 + i*s + j) of a position
  // lands in the output stage, relative to the position's top-left pixel; -1
  // past the group.
  int off[NBW][2];
  float bv[NBW][2];
#pragma unroll
  for (int q = 0; q < NBW; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * (q0 + q) + 2 * t + e;
      off[q][e] = n < Cg ? (((n % ss) / s) * (M_TW * s) + n % s) * Cs + n / ss : -1;
      bv[q][e] = n < Cg ? bias[n0 + n] : 0.f;
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
    const int cpp = pl.kch / EPC;
    const size_t img_px = size_t(img) * H * W;
    for (int idx = tid; idx < HH * pl.hw * cpp; idx += THR) {
      const int p = idx / cpp, c = idx % cpp;
      const int gy = cy0 + p / pl.hw - pad_t, gx = cx0 + p % pl.hw - pad_l;
      const int ch = chunk * pl.kch + c * EPC;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int o = buf * pl.halo_bytes + p * pl.pstr + c * 16;
      const T* src = x + (img_px + size_t(gy) * W + gx) * Cin + ch;
      if (vec_x) {
        const bool ok = inside && ch < Cin;
        cp_async16(halo_s + o, ok ? src : x, ok);
      } else {
        T* dst = reinterpret_cast<T*>(halo + o);
#pragma unroll
        for (int k = 0; k < EPC; ++k) dst[k] = (inside && ch + k < Cin) ? src[k] : zero;
      }
    }
  };
  auto stage_wts = [&](int chunk, int ky0, int ky1) {
    constexpr int PIECES = NB * 8 / EPC;  // 16-byte pieces of a weight row
    const int rows = (ky1 - ky0) * KW * pl.kch;
    for (int idx = tid; idx < rows * PIECES; idx += THR) {
      const int r = idx / PIECES, j = idx % PIECES;
      const int ky = ky0 + r / (KW * pl.kch), kx = (r / pl.kch) % KW, c = chunk * pl.kch + r % pl.kch;
      const int o = r * pl.wstr + j * 16;
      const T* src = w + ((size_t(ky) * KW + kx) * Cin + c) * Cc + n0 + EPC * j;
      if (vec_w) {
        const bool ok = c < Cin && EPC * j < Cg;
        cp_async16(wts_s + o, ok ? src : w, ok);
      } else {
        T* dst = reinterpret_cast<T*>(wts + o);
#pragma unroll
        for (int k = 0; k < EPC; ++k) dst[k] = (c < Cin && EPC * j + k < Cg) ? src[k] : zero;
      }
    }
  };
  // Bias (and the activation), one rounding, depth-to-space into the output
  // stage (halo buffer sb, free once the tile's MMAs are done), then the
  // stage's rows out to y, one row per warp, consecutive lanes on consecutive
  // 4-byte words.
  auto finish = [&](float (&acc)[2][NBW][4], int tile, int sb) {
    T* ost = reinterpret_cast<T*>(halo + sb * pl.halo_bytes);  // [M_TH*s][M_TW*s][Cs]
    int img, cy0, cx0;
    tile_origin(tile, img, cy0, cx0);
    const int row_el = M_TW * s * Cs;  // elements in one stage row
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int base = ((2 * wm + mi) * s * (M_TW * s) + (g + 8 * h) * s) * Cs;
#pragma unroll
        for (int q = 0; q < NBW; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (off[q][e] >= 0) ost[base + off[q][e]] = from_float<T>(epilogue(acc[mi][q][2 * h + e] + bv[q][e], act));
      }
    __syncthreads();
    const int oy0 = cy0 * s, ox0 = cx0 * s;
    const int npx = min(M_TW * s, out_w - ox0), nel = npx * Cs;
    if (Cs != C) {
      // one group of several: each pixel's Cs channels are a run at stride C
      // in y; channel pairs where runs and stride are even (whole 32-byte
      // sectors at s 2: 16 of 64 channels in bf16), else elements
      const bool pairs = Cs % 2 == 0 && C % 2 == 0 && c0 % 2 == 0;
      for (int rr = warp; rr < M_TH * s; rr += THR / 32) {
        const int oy = oy0 + rr;
        if (oy >= out_h) break;
        const T* srow = ost + rr * row_el;
        T* grow = y + ((size_t(img) * out_h + oy) * out_w + ox0) * C + c0;
        if (pairs) {
          for (int e = 2 * lane; e < nel; e += 64)
            *reinterpret_cast<T2*>(grow + (e / Cs) * C + e % Cs) = *reinterpret_cast<const T2*>(srow + e);
        } else {
          for (int e = lane; e < nel; e += 32) grow[(e / Cs) * C + e % Cs] = srow[e];
        }
      }
      __syncthreads();  // the stage is read out before its buffer takes a halo again
      return;
    }
    for (int rr = warp; rr < M_TH * s; rr += THR / 32) {
      const int oy = oy0 + rr;
      if (oy >= out_h) break;
      const size_t ge = ((size_t(img) * out_h + oy) * out_w + ox0) * C;
      const T* srow = ost + rr * row_el;
      T* grow = y + ge;
      if constexpr (sizeof(T) == 4) {
        for (int e = lane; e < nel; e += 32) grow[e] = srow[e];
      } else {
        // a row of y is 2-byte aligned only: peel one element to reach 4 bytes
        const int head = int(ge & 1);
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
    }
    __syncthreads();  // the stage is read out before its buffer takes a halo again
  };
  auto zero_acc = [&](float (&acc)[2][NBW][4]) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < NBW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][q][e] = 0.f;
  };

  float acc[2][NBW][4];
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
      if constexpr (sizeof(T) == 2)
        tail_mma_piece<NB>(acc, halo_s + buf * pl.halo_bytes, wts_s, pl, KW, 0, KH, cin_pad / KG, warp, lane);
      else
        tail_mma_piece_f32<NBW>(acc, halo_s + buf * pl.halo_bytes, wts, pl, KW, 0, KH, cin_pad / KG, wm, q0, lane);
      __syncthreads();  // every warp is done with the halo buffer: it becomes the output stage
      finish(acc, tile, buf);
    }
  } else {
    // Geometries whose weights do not fit at once: chunks of input channels
    // and groups of kernel rows, each staged synchronously.
    for (int tile = first; tile < ntiles; tile += gridDim.x) {
      zero_acc(acc);
      for (int chunk = 0; chunk < nchunks; ++chunk) {
        const int ksteps = min(pl.kch, cin_pad - chunk * pl.kch) / KG;
        for (int ky0 = 0; ky0 < KH; ky0 += pl.kyg) {
          const int ky1 = min(KH, ky0 + pl.kyg);
          __syncthreads();
          if (ky0 == 0) stage_halo(0, tile, chunk);
          stage_wts(chunk, ky0, ky1);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          if constexpr (sizeof(T) == 2)
            tail_mma_piece<NB>(acc, halo_s, wts_s, pl, KW, ky0, ky1, ksteps, warp, lane);
          else
            tail_mma_piece_f32<NBW>(acc, halo_s, wts, pl, KW, ky0, ky1, ksteps, wm, q0, lane);
        }
      }
      __syncthreads();
      finish(acc, tile, 0);
    }
  }
}

// The largest channel chunk, then the most kernel rows, whose staging fits,
// for groups of gw conv channels. True with kch = Cin rounded up to the
// k-step and kyg = KH when the weights stay resident.
template <typename T>
bool plan_mma(int kh, int kw, int cin, int gw, MmaPlan& pl) {
  constexpr int KG = PolicyOf<T>::type::KG, es = int(sizeof(T));
  const int cin_pad = round_up(cin, KG);
  pl.gw = gw;
  pl.hw = M_TW + kw - 1;
  const int wn = es == 4 ? 2 : 1, nbp = ((gw + 7) / 8 + wn - 1) / wn * wn;  // TailWarps' WN x NBW tiles
  pl.wstr = (nbp | 1) * 8 * es;
  const int stage_bytes = M_TH * M_TW * gw * es;
  for (int kch = cin_pad; kch >= KG; kch -= KG) {
    for (int kyg = kh; kyg >= 1; --kyg) {
      pl.kch = kch;
      pl.kyg = kyg;
      pl.pstr = (kch * es / 16 + 1) * 16;
      pl.halo_bytes = std::max((M_TH + kh - 1) * pl.hw * pl.pstr, stage_bytes);
      pl.wts_bytes = kyg * kw * kch * pl.wstr;
      if (2 * pl.halo_bytes + pl.wts_bytes <= M_SMEM_MAX) return true;
    }
  }
  return false;
}

template <typename T, int NB>
cudaError_t launch_mma_nb(const void* x, const void* w, const float* b, void* y, int n, int h,
                          int wd, int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s,
                          int hc, int wc, int out_h, int out_w, int act, const MmaPlan& pl,
                          cudaStream_t stream) {
  const int groups = (cc + pl.gw - 1) / pl.gw;
  if (groups > 65535) return cudaErrorInvalidValue;
  const int smem = 2 * pl.halo_bytes + pl.wts_bytes;
  auto kern = fused_tail_mma_kernel<T, NB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  constexpr int threads = TailWarps<T, NB>::THREADS;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) != cudaSuccess)
    return err;
  const int tiles_w = (wc + M_TW - 1) / M_TW, tiles_h = (hc + M_TH - 1) / M_TH;
  const int ntiles = tiles_w * tiles_h * n;
  // persistent: the resident blocks are shared out among the groups (never
  // more than fit: a block past them would run its whole share after the rest)
  const int per_group = std::max(1, std::max(per_sm, 1) * sms / groups);
  const int grid = std::max(1, std::min(ntiles, per_group));
  kern<<<dim3(grid, groups), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b, static_cast<T*>(y), h, wd, cin, kh, kw, pad_t,
      pad_l, cc, s, hc, wc, out_h, out_w, tiles_w, tiles_h, ntiles, act, pl);
  return cudaGetLastError();
}

// Plan the groups (bf16: of <= 64; f32: of <= 64 where the weights stay
// resident, else of <= 32), then dispatch on the group's n8 tiles.
template <typename T>
cudaError_t launch_mma(const void* x, const void* w, const float* b, void* y, int n, int h, int wd,
                       int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s, int hc, int wc,
                       int out_h, int out_w, int act, cudaStream_t st) {
  MmaPlan pl;
  const bool wide = plan_mma<T>(kh, kw, cin, group_width(cc, s), pl);
  if (sizeof(T) == 4 && !(wide && pl.kch == round_up(cin, 8) && pl.kyg == kh)) {
    MmaPlan narrow;
    if (plan_mma<T>(kh, kw, cin, group_width(cc, s, GROUP_MAX_F32), narrow)) pl = narrow;
    else if (!wide) return cudaErrorInvalidConfiguration;
  } else if (!wide) {
    return cudaErrorInvalidConfiguration;
  }
  switch ((pl.gw + 7) / 8) {
#define TAIL_NB(NB)                                                                                              \
  case NB:                                                                                                       \
    return launch_mma_nb<T, NB>(x, w, b, y, n, h, wd, cin, kh, kw, pad_t, pad_l, cc, s, hc, wc, out_h, out_w, act, \
                                pl, st);
    TAIL_NB(1) TAIL_NB(2) TAIL_NB(3) TAIL_NB(4) TAIL_NB(5) TAIL_NB(6) TAIL_NB(7) TAIL_NB(8)
#undef TAIL_NB
    default: return cudaErrorInvalidValue;
  }
}


// ---- B4: the WDSR / ResultNet tail on the tensor cores ----

constexpr int S_K = 3;     // body kernel size
constexpr int S_K2 = 5;    // skip kernel size
constexpr int S_C2 = 3;    // skip channels, at most
constexpr int S_BAR_BYTES = 128;  // two mbarriers, padded to keep what follows 128-byte aligned

// Shared-memory plan of one B4 launch, computed on the host, passed by value.
struct SkipPlan {
  int cp;          // body halo pixel stride (elements): Cin zero-padded, even
  int ksb;         // k-steps of one body kernel row: ceil(3 cp / KG)
  int hwb;         // body halo width (pixels), the K runs' overshoot included
  int halo_bytes;  // one body halo buffer
  int tma;         // 1: the body halo is one TMA box (a pixel of whole 16-byte chunks)
  int tma_out;     // 1: a warp's output rows are one TMA box (a y row of whole 16-byte chunks)
  int unit;        // else the halo's cp.async unit: 4 bytes, or 0: element by element
  int upp;         // then units per pixel
  uint64_t m_upp, m_hwb;  // ceil(2^32 / upp), ceil(2^32 / hwb): the staging loop divides by a multiply
};

// n / d for 0 <= n < 2^16 and d < 2^16 given m = ceil(2^32 / d): the error
// n (m - 2^32 / d) / 2^32 stays below 1 / d. (On an H100, runtime divisions
// made the cp.async staging of 18- and 21-channel f32 bodies 22 % slower.)
__device__ __forceinline__ int div_by(int n, uint64_t m) { return int((uint64_t(n) * m) >> 32); }
constexpr uint64_t div_magic(int d) { return ((uint64_t(1) << 32) + d - 1) / d; }

template <typename T>
struct SkipGeo {
  using P = typename PolicyOf<T>::type;
  static constexpr int KG = P::KG, BW = P::BW;
  // skip halo pixel stride: f32 reads the skip's A by 4-byte loads, so 3
  // channels a pixel (a kernel row is 15 values, 16 issued); bf16 reads
  // channel pairs, so 4 (20 values, 32 issued)
  static constexpr int CP2 = sizeof(T) == 4 ? 3 : 4;
  static constexpr int KS2 = (S_K2 * CP2 + KG - 1) / KG;  // k-steps of one skip kernel row: 2
  static constexpr int HHS = M_TH + S_K2 - 1;              // skip halo rows
  static constexpr int HWS = M_TW + (KS2 * KG - 1) / CP2;  // skip halo width (pixels) the K runs reach
  static constexpr int SLOTS = HHS * HWS * CP2;
  static constexpr int NSK = (SLOTS + M_THREADS - 1) / M_THREADS;  // skip values a thread carries
  static constexpr int SKIP_BYTES = round_up(SLOTS * int(sizeof(T)), 128);
  // packed floats: body fragments, skip fragments, bias
  __host__ __device__ static constexpr int body_floats(int ksb, int nb) { return S_K * ksb * nb * 32 * BW; }
  __host__ __device__ static constexpr int skip_floats(int nb) { return S_K2 * KS2 * nb * 32 * BW; }
  __host__ __device__ static constexpr int floats(int ksb, int nb) {
    return body_floats(ksb, nb) + skip_floats(nb) + 8 * nb;
  }
  // a warp's output stage: its two conv rows of M_TW positions, cc channels
  __host__ __device__ static constexpr int stage_bytes(int cc) { return round_up(2 * M_TW * cc * int(sizeof(T)), 128); }
};

// The skip's A fragment of k-step s: f32 pixels of 3 channels are 4-byte
// aligned only, so the element view is read by 4-byte loads; bf16 takes the
// policy's pair loads.
template <typename P, typename T>
__device__ __forceinline__ typename P::A load_a_skip(const T* rg, const T* rg8, int s, int t) {
  if constexpr (sizeof(T) == 4) {
    const int k = P::KG * s + 2 * t;
    const float v[4] = {rg[k], rg[k + 1], rg8[k], rg8[k + 1]};
    return P::make_a(v);
  } else {
    return P::load_a(rg, rg8, s, t);
  }
}

// One output stage row (nel elements) out to y: consecutive lanes on
// consecutive 4-byte words. A bf16 row is 2-byte aligned only: one element
// is peeled to reach 4 bytes.
__device__ __forceinline__ void store_row(float* dst, const float* src, int nel, int lane) {
  for (int e = lane; e < nel; e += 32) dst[e] = src[e];
}
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const __nv_bfloat16* src, int nel, int lane) {
  const int head = int((reinterpret_cast<uintptr_t>(dst) >> 1) & 1);
  if (head && lane == 0) dst[0] = src[0];
  for (int e0 = head + 2 * lane; e0 < nel; e0 += 64) {
    if (e0 + 1 < nel) {
      __nv_bfloat162 v;
      v.x = src[e0];
      v.y = src[e0 + 1];
      *reinterpret_cast<__nv_bfloat162*>(dst + e0) = v;
    } else {
      dst[e0] = src[e0];
    }
  }
}

// bf16 fits three blocks an SM at 128 threads when capped at 170 registers
template <typename T, int NB, bool WS>
__global__ void __launch_bounds__(M_THREADS, sizeof(T) == 2 ? 3 : 1) tail_skip_kernel(
    const T* __restrict__ x, const T* __restrict__ x2, const float* __restrict__ packed, T* __restrict__ y,
    int H, int W, int Cin, int C2, int Cc, int s, int tiles_w, int tiles_h, int ntiles, SkipPlan pl,
    const __grid_constant__ CUtensorMap tmap, const __grid_constant__ CUtensorMap tmap_y) {
  using G = SkipGeo<T>;
  using P = typename G::P;
  constexpr int BW = G::BW, HWS = G::HWS, CP2 = G::CP2;
  extern __shared__ __align__(128) unsigned char skip_smem[];
  // the two body halo buffers' TMA mbarriers, [2] body halos, [2] skip
  // halos, [4] warp output stages, the packed weights (WS); each 128-byte
  // aligned, as TMA needs
  const uint32_t bar_s = smem_u32(skip_smem);
  unsigned char* halo = skip_smem + S_BAR_BYTES;
  T* hs = reinterpret_cast<T*>(halo + 2 * pl.halo_bytes);
  const int stage_bytes = G::stage_bytes(Cc);
  T* ost = reinterpret_cast<T*>(halo + 2 * pl.halo_bytes + 2 * G::SKIP_BYTES + (threadIdx.x >> 5) * stage_bytes);
  float* ws = reinterpret_cast<float*>(halo + 2 * pl.halo_bytes + 2 * G::SKIP_BYTES + 4 * stage_bytes);
  const uint32_t halo_s = smem_u32(halo);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ss = s * s, C = Cc / ss, out_h = H * s, out_w = W * s;
  const int cp = pl.cp, ksb = pl.ksb, hwb = pl.hwb, es = int(sizeof(T));
  const int o_skip = G::body_floats(ksb, NB), o_bias = o_skip + G::skip_floats(NB);
  const T zero = from_float<T>(0.f);

  // Where conv channel n = c*s^2 + i*s + j of a position lands in the warp's
  // output stage, relative to the position's top-left pixel (-1 past Cc),
  // and its bias.
  int off[NB][2];
  float bv[NB][2];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * q + 2 * t + e;
      off[q][e] = n < Cc ? (((n % ss) / s) * (M_TW * s) + n % s) * C + n / ss : -1;
      bv[q][e] = packed[o_bias + n];
    }

  auto tile_origin = [&](int tile, int& img, int& cy0, int& cx0) {
    const int tx = tile % tiles_w, ty = (tile / tiles_w) % tiles_h;
    img = tile / (tiles_w * tiles_h);
    cy0 = ty * M_TH;
    cx0 = tx * M_TW;
  };
  // The body halo of a tile, (M_TH + 2) x hwb pixels of cp channels, every
  // element written: zero outside the image and past Cin. One TMA box, or
  // 4-byte cp.async units, or elements.
  auto stage_body = [&](int buf, int tile) {
    int img, cy0, cx0;
    tile_origin(tile, img, cy0, cx0);
    if (pl.tma) {
      if (tid == 0) {
        mbar_arrive_expect_tx(bar_s + 8 * buf, (M_TH + S_K - 1) * hwb * cp * es);
        tma_load_4d(halo_s + buf * pl.halo_bytes, &tmap, 0, cx0 - 1, cy0 - 1, img, bar_s + 8 * buf);
      }
      return;
    }
    const int el = pl.unit ? pl.unit / es : 1;  // elements per unit
    const T* xi = x + size_t(img) * H * W * Cin;
    unsigned char* hb = halo + buf * pl.halo_bytes;
    for (int idx = tid; idx < (M_TH + S_K - 1) * hwb * pl.upp; idx += M_THREADS) {
      const int p = div_by(idx, pl.m_upp), u = idx - p * pl.upp;
      const int r = div_by(p, pl.m_hwb);
      const int gy = cy0 + r - 1, gx = cx0 + p - r * hwb - 1;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && u * el < Cin;
      const T* src = ok ? xi + (size_t(gy) * W + gx) * Cin + u * el : x;
      const int o = (p * cp + u * el) * es;
      if (pl.unit) cp_async_small<4>(halo_s + buf * pl.halo_bytes + o, src, ok);
      else *reinterpret_cast<T*>(hb + o) = ok ? *src : zero;
    }
  };
  // The skip halo of a tile, (M_TH + 4) x HWS pixels of CP2 channels (zero
  // past C2), into registers (loads in flight during the MMAs) ...
  auto load_skip = [&](T (&v)[G::NSK], int tile) {
    int img, cy0, cx0;
    tile_origin(tile, img, cy0, cx0);
    const T* xi = x2 + size_t(img) * H * W * C2;
#pragma unroll
    for (int k = 0; k < G::NSK; ++k) {
      const int idx = tid + k * M_THREADS, p = idx / CP2, c = idx % CP2;
      const int gy = cy0 + p / HWS - S_K2 / 2, gx = cx0 + p % HWS - S_K2 / 2;
      const bool ok = idx < G::SLOTS && c < C2 && gy >= 0 && gy < H && gx >= 0 && gx < W;
      v[k] = ok ? xi[(size_t(gy) * W + gx) * C2 + c] : zero;
    }
  };
  // ... and from them into a skip halo buffer.
  auto store_skip = [&](const T (&v)[G::NSK], int buf) {
#pragma unroll
    for (int k = 0; k < G::NSK; ++k)
      if (tid + k * M_THREADS < G::SLOTS) hs[buf * (G::SKIP_BYTES / es) + tid + k * M_THREADS] = v[k];
  };

  if (blockIdx.x >= ntiles) return;
  if (pl.tma && tid == 0) {
    mbar_init(bar_s, 1);
    mbar_init(bar_s + 8, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if constexpr (WS) {
    const int nw = G::floats(ksb, NB);
    for (int i = 4 * tid; i < nw; i += 4 * M_THREADS) cp_async16(smem_u32(ws + i), packed + i, true);
  }
  const float* wb = WS ? ws : packed;
  stage_body(0, blockIdx.x);
  cp_async_commit();
  T sk[G::NSK];
  load_skip(sk, blockIdx.x);
  store_skip(sk, 0);

  float acc[2][NB][4];
  for (int tile = blockIdx.x, buf = 0, j = 0; tile < ntiles; tile += gridDim.x, buf ^= 1, ++j) {
    const int next = tile + gridDim.x;
    cp_async_wait<0>();
    if (pl.tma) mbar_wait(bar_s + 8 * buf, (j >> 1) & 1);  // buffer buf's (j / 2)-th box
    // This tile's halos are in; every warp is done with the previous tile,
    // whose buffers (buf ^ 1) take the next tile's halos.
    __syncthreads();
    if (next < ntiles) {
      stage_body(buf ^ 1, next);
      cp_async_commit();
      load_skip(sk, next);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][q][e] = 0.f;

    // body: 3 kernel rows, each one K run of ksb k-steps along a halo row
    // (the k-step loop outside, so a step's three rows load together)
    const T* hb = reinterpret_cast<const T*>(halo + buf * pl.halo_bytes) + ((2 * warp) * hwb + g) * cp;
#pragma unroll 1
    for (int st = 0; st < ksb; ++st) {
#pragma unroll
      for (int ky = 0; ky < S_K; ++ky) {
        const T* r0 = hb + ky * hwb * cp;
        const T* r1 = r0 + hwb * cp;
        const typename P::A a0 = P::load_a(r0, r0 + 8 * cp, st, t);
        const typename P::A a1 = P::load_a(r1, r1 + 8 * cp, st, t);
        const float* bp = wb + ((ky * ksb + st) * NB * 32 + lane) * BW;
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const typename P::B b = P::load_b(bp + q * 32 * BW);
          P::mma(acc[0][q], a0, b);
          P::mma(acc[1][q], a1, b);
        }
      }
    }
    // skip: 5 kernel rows of KS2 k-steps along the skip halo
    const T* hsb = hs + buf * (G::SKIP_BYTES / es) + ((2 * warp) * HWS + g) * CP2;
#pragma unroll
    for (int ky = 0; ky < S_K2; ++ky) {
      const T* r0 = hsb + ky * HWS * CP2;
      const T* r1 = r0 + HWS * CP2;
#pragma unroll
      for (int st = 0; st < G::KS2; ++st) {
        const typename P::A a0 = load_a_skip<P>(r0, r0 + 8 * CP2, st, t);
        const typename P::A a1 = load_a_skip<P>(r1, r1 + 8 * CP2, st, t);
        const float* bp = wb + o_skip + ((ky * G::KS2 + st) * NB * 32 + lane) * BW;
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const typename P::B b = P::load_b(bp + q * 32 * BW);
          P::mma(acc[0][q], a0, b);
          P::mma(acc[1][q], a1, b);
        }
      }
    }

    // Epilogue, the warp's own: bias, one rounding, depth-to-space of its two
    // conv rows into its stage in output order, then its 2s output rows out
    // to y.
    int img, cy0, cx0;
    tile_origin(tile, img, cy0, cx0);
    const int row_el = M_TW * s * C;
    if (pl.tma_out) {  // the stage's previous box has been read out
      if (lane == 0) tma_store_wait_read();
      __syncwarp();
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int base = mi * s * row_el + (g + 8 * h) * s * C;
#pragma unroll
        for (int q = 0; q < NB; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (off[q][e] >= 0) ost[base + off[q][e]] = from_float<T>(acc[mi][q][2 * h + e] + bv[q][e]);
      }
    const int oy0 = (cy0 + 2 * warp) * s, ox0 = cx0 * s;
    if (pl.tma_out) {
      fence_proxy_async();  // the stage's writes, visible to the TMA engine
      __syncwarp();
      if (lane == 0) tma_store_3d(&tmap_y, ox0 * C, oy0, img, smem_u32(ost));
    } else {
      __syncwarp();
      const int nel = min(M_TW * s, out_w - ox0) * C;
      for (int rr = 0; rr < 2 * s && oy0 + rr < out_h; ++rr)
        store_row(y + ((size_t(img) * out_h + oy0 + rr) * out_w + ox0) * C, ost + rr * row_el, nel, lane);
      __syncwarp();  // the stage is read out before the next tile writes it
    }
    // last, to give the loads the epilogue's time too
    if (next < ntiles) store_skip(sk, buf ^ 1);
  }
  if (pl.tma_out && lane == 0) tma_store_wait_read();  // the stage outlives its last box's read
}

template <typename T, int NB, bool WS>
cudaError_t launch_skip_nb(const void* x, const void* x2, const float* packed, void* y, int n, int h, int w,
                           int cin, int c2, int cc, int s, const SkipPlan& pl, const CUtensorMap& tmap,
                           const CUtensorMap& tmap_y, int smem, cudaStream_t stream) {
  auto kern = tail_skip_kernel<T, NB, WS>;
  // the shared-memory attribute and the resident blocks, kept per device and
  // size (the host's work per call)
  static int last_dev = -1, last_smem = -1, resident = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, M_THREADS, smem)) != cudaSuccess)
      return err;
    last_dev = dev;
    last_smem = smem;
    resident = std::max(per_sm, 1) * sms;
  }
  const int tiles_w = (w + M_TW - 1) / M_TW, tiles_h = (h + M_TH - 1) / M_TH, ntiles = tiles_w * tiles_h * n;
  const int grid = std::max(1, std::min(ntiles, resident));
  kern<<<grid, M_THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(x2), packed,
                                          static_cast<T*>(y), h, w, cin, c2, cc, s, tiles_w, tiles_h, ntiles, pl,
                                          tmap, tmap_y);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map of `rank` dimensions (innermost first) with zero fill
// outside the tensor; false where cuTensorMapEncodeTiled refuses it.
bool tensor_map(CUtensorMap& tmap, CUtensorMapDataType type, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault,
                                &q) != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return false;
    }
  }
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(&tmap, type, rank, const_cast<void*>(base), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Plan a launch for the body pixel stride cp, stage the weights where they
// fit, and dispatch on the padded conv-channel width (16, 32, 48, 64).
template <typename T>
cudaError_t launch_skip(const void* x, const void* x2, const float* packed, void* y, int n, int h, int w,
                        int cin, int cp, int c2, int cc, int s, cudaStream_t st) {
  using G = SkipGeo<T>;
  const int es = int(sizeof(T));
  SkipPlan pl;
  pl.cp = cp;
  pl.ksb = (S_K * cp + G::KG - 1) / G::KG;
  pl.hwb = M_TW + (pl.ksb * G::KG - 1) / cp;
  pl.halo_bytes = round_up((M_TH + S_K - 1) * pl.hwb * cp * es, 128);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const CUtensorMapDataType type = es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // x (n, h, w, cin) read as boxes of one body halo, (cp, hwb, M_TH + 2, 1):
  // the channels past cin and the pixels outside the image read as zero
  CUtensorMap tmap = {}, tmap_y = {};
  const cuuint64_t ces = cuuint64_t(cin) * es;
  const cuuint64_t xd[4] = {cuuint64_t(cin), cuuint64_t(w), cuuint64_t(h), cuuint64_t(n)};
  const cuuint64_t xs[3] = {ces, ces * w, ces * w * h};
  const cuuint32_t xb[4] = {cuuint32_t(cp), cuuint32_t(pl.hwb), cuuint32_t(M_TH + S_K - 1), 1};
  pl.tma = (cin * es) % 16 == 0 && (cp * es) % 16 == 0 && xa % 16 == 0;
  if (pl.tma && !tensor_map(tmap, type, x, 4, xd, xs, xb)) return cudaErrorNotSupported;
  pl.unit = (cin * es) % 4 == 0 && xa % 4 == 0 ? 4 : 0;
  pl.upp = pl.unit ? cp * es / pl.unit : cp;
  pl.m_upp = div_magic(pl.upp);
  pl.m_hwb = div_magic(pl.hwb);
  // y (n, s h, s w C) written as boxes of a warp's 2s output rows of M_TW
  // positions; the part past the image is not written
  const int C = cc / (s * s);
  const cuuint64_t row = cuuint64_t(s) * w * C;
  const cuuint64_t yd[3] = {row, cuuint64_t(s) * h, cuuint64_t(n)}, ys[2] = {row * es, row * es * s * h};
  const cuuint32_t yb[3] = {cuuint32_t(M_TW * s * C), cuuint32_t(2 * s), 1};
  pl.tma_out = (row * es) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 && M_TW * s * C <= 256 &&
               tensor_map(tmap_y, type, y, 3, yd, ys, yb);
  const int nb = 2 * ((cc + 15) / 16);
  const int base = S_BAR_BYTES + 2 * pl.halo_bytes + 2 * G::SKIP_BYTES + 4 * G::stage_bytes(cc);
  const int smem_ws = base + G::floats(pl.ksb, nb) * 4;
  if (base > M_SMEM_MAX) return cudaErrorInvalidConfiguration;
  const bool ws = smem_ws <= M_SMEM_MAX;
  const int smem = ws ? smem_ws : base;
  switch (nb) {
#define SKIP_NB(NB)                                                                                            \
  case NB:                                                                                                     \
    if (ws) return launch_skip_nb<T, NB, true>(x, x2, packed, y, n, h, w, cin, c2, cc, s, pl, tmap, tmap_y, smem, st); \
    if constexpr (std::is_same<T, float>::value)                                                              \
      return launch_skip_nb<T, NB, false>(x, x2, packed, y, n, h, w, cin, c2, cc, s, pl, tmap, tmap_y, smem, st); \
    return cudaErrorInvalidConfiguration;
    SKIP_NB(2) SKIP_NB(4) SKIP_NB(6) SKIP_NB(8)
#undef SKIP_NB
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B2 in f32 (3xTF32 on the tensor cores). x (n, h, wd, cin), w (kh, kw,
// cin, cc), b (cc,) and y (n, out_h, out_w, cc / s^2), all f32 and
// contiguous; cc a multiple of s^2, s^2 <= 64. hc, wc: conv output positions
// to compute (those that reach the crop). act 1: leaky ReLU (slope 0.1)
// after the bias; 0: none. Launches on `stream`, does not synchronise,
// returns cudaGetLastError() after the launch.
extern "C" int fused_conv_pixel_shuffle_launch(
    const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
    int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s, int hc,
    int wc, int out_h, int out_w, int act, void* stream) {
  if (bad_geometry(n, hc, wc, cin, cc, s) || kh <= 0 || kw <= 0) return int(cudaErrorInvalidValue);
  return int(launch_mma<float>(x, w, static_cast<const float*>(b), y, n, h, wd, cin, kh, kw, pad_t, pad_l, cc, s,
                               hc, wc, out_h, out_w, act, static_cast<cudaStream_t>(stream)));
}

// B2 in bf16 on the tensor cores: x (n, h, wd, cin) bf16; w (kh, kw, cin, cc)
// bf16; b (cc,) f32; y (n, out_h, out_w, cc / s^2) bf16, all contiguous.
// Otherwise as fused_conv_pixel_shuffle_launch.
extern "C" int fused_conv_pixel_shuffle_bf16_launch(
    const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
    int cin, int kh, int kw, int pad_t, int pad_l, int cc, int s, int hc,
    int wc, int out_h, int out_w, int act, void* stream) {
  if (bad_geometry(n, hc, wc, cin, cc, s) || kh <= 0 || kw <= 0) return int(cudaErrorInvalidValue);
  return int(launch_mma<__nv_bfloat16>(x, w, static_cast<const float*>(b), y, n, h, wd, cin, kh, kw, pad_t, pad_l,
                                       cc, s, hc, wc, out_h, out_w, act, static_cast<cudaStream_t>(stream)));
}


// B4: depth_to_space(conv3x3(x) + conv5x5(x2) + bias, s), both SAME. x (n, h,
// w, cin) and x2 (n, h, w, c2) in one dtype (f32, or bf16 when is_bf16);
// packed: kernels/fused_tail.py::pack_weights(kernel, kernel_skip, bias,
// dtype) for body pixel stride cp, f32 words; y (n, s*h, s*w, cc / s^2) in
// x's dtype; all contiguous. Takes 1 <= cin <= 64, cin <= cp <= 80 with cp
// even, 1 <= c2 <= 3, cc <= 64 a multiple of s^2; anything else returns
// cudaErrorInvalidValue. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after the launch.
extern "C" int fused_conv_pixel_shuffle_skip_launch(const void* x, const void* x2, const void* packed, void* y,
                                                    int n, int h, int w, int cin, int cp, int c2, int cc, int s,
                                                    int is_bf16, void* stream) {
  if (bad_geometry(n, h, w, cin, cc, s) || cc > 64 || cin > 64 || cp < cin || cp > 80 || cp % 2 || c2 < 1 || c2 > S_C2)
    return int(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return int(launch_skip<__nv_bfloat16>(x, x2, p, y, n, h, w, cin, cp, c2, cc, s, st));
  return int(launch_skip<float>(x, x2, p, y, n, h, w, cin, cp, c2, cc, s, st));
}
