// Hopper building blocks shared by the hand kernels (B1 in conv5x5.cu, B2 and
// B4 in fused_tail.cu, B3 in fused_wdsr_block.cu, B5 in fused_convsep.cu):
// cp.async with zero fill, bulk and TMA tensor copies completing on
// mbarriers, ldmatrix, mma.sync
// (m16n8k16 bf16, m16n8k8 tf32, and the Tf32x3 / Bf16 fragment policies of
// B3, B4 and B5; Tf32x3's split of ldmatrix-loaded fragments and
// mma_tf32x3 for the f32 routes of B1 and B2) and warpgroup wgmma (A in
// registers, B read from shared memory through a descriptor: bf16 and tf32
// for B1, s8 for Q1 in qconv_int8.cu). Raw PTX through inline asm keeps nvcc
// at seconds.
// Needs sm_90a for wgmma.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy. With valid false nothing is read and the
// 16 bytes are zero-filled (src-size 0); src must still be a device address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4- or 8-byte global -> shared copy (cp.async.ca), zero-filled when !valid.
template <int N>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src, bool valid) {
  static_assert(N == 4 || N == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
               "r"(valid ? N : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b for one m16n8k16 tile: bf16 in, f32 accumulate (mma.sync).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b for one m16n8k8 tile: tf32 in (the low 13 mantissa bits of each
// operand are ignored), f32 accumulate.
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// f32 -> tf32, round to nearest (ties away), as the f32 bit pattern.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// ---- mma.sync fragment policies (B3, B4, B5; Tf32x3 also B1 and B2 in f32) ----
//
// Both policies see a k-step of A the same way: lane (g, t) of a warp holds
// rows g and g + 8 of the m16 tile at columns 2t and 2t + 1 of each group of
// 8 columns ("element view", v[0..3] = (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1), then the next group of 8). That is exactly the accumulator
// fragment of an n8 tile, so a product's output feeds the next product's A
// with no shuffle. B fragments are packed once per lane in the same order:
// (B[k0 + 2t][n0 + g], B[k0 + 2t + 1][n0 + g]) per group of 8 rows.
//
// Tf32x3 (f32 I/O): k-steps of 8 on mma m16n8k8 tf32. The PTX A fragment
// holds columns t and t + 4; the packed K order maps logical column t to
// column 2t and t + 4 to 2t + 1, so the element view above is the fragment.
// Each operand is split into hi = tf32(v) and lo = v - hi, and the product
// is lo·hi + hi·lo + hi·hi in f32 (3xTF32): ~f32 accuracy on the tensor
// cores, the small terms first. A packed B lane is a float4 (hi0, hi1, lo0,
// lo1).
// Bf16 (bf16 I/O): k-steps of 16 on mma m16n8k16 bf16 (two groups of 8);
// a packed B lane is two bf16x2 words, (rows 2t, 2t+1), (rows 8+2t, 9+2t).
struct Tf32x3 {
  static constexpr int KG = 8;   // k per step
  static constexpr int BW = 4;   // floats per packed B lane
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ A make_a(const float (&v)[4]) {
    A a;
    const float o[4] = {v[0], v[2], v[1], v[3]};  // fragment order: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.hi[i] = tf32_rna(o[i]);
      a.lo[i] = __float_as_uint(o[i] - __uint_as_float(a.hi[i]));
    }
    return a;
  }
  static __device__ __forceinline__ B load_b(const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    B b;
    b.hi[0] = __float_as_uint(q.x);
    b.hi[1] = __float_as_uint(q.y);
    b.lo[0] = __float_as_uint(q.z);
    b.lo[1] = __float_as_uint(q.w);
    return b;
  }
  // Pack the B lane (s, t) of one n column: get(k) is B[k][n].
  template <typename F>
  static __device__ __forceinline__ void pack_b(float* dst, F&& get, int s, int t) {
    const float v0 = get(KG * s + 2 * t), v1 = get(KG * s + 2 * t + 1);
    const float h0 = __uint_as_float(tf32_rna(v0)), h1 = __uint_as_float(tf32_rna(v1));
    *reinterpret_cast<float4*>(dst) = make_float4(h0, h1, v0 - h0, v1 - h1);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_1688_tf32(d, a.lo, b.hi);
    mma_1688_tf32(d, a.hi, b.lo);
    mma_1688_tf32(d, a.hi, b.hi);
  }
  // The element view of k-step s from an f32 row pair in shared memory.
  static __device__ __forceinline__ A load_a(const float* rg, const float* rg8, int s, int t) {
    const float2 p = *reinterpret_cast<const float2*>(rg + KG * s + 2 * t);
    const float2 q = *reinterpret_cast<const float2*>(rg8 + KG * s + 2 * t);
    const float v[4] = {p.x, p.y, q.x, q.y};
    return make_a(v);
  }
  // Split an A fragment already in PTX order, (g, t), (g+8, t), (g, t+4),
  // (g+8, t+4): what ldmatrix.x4 leaves from a 16 x 8 f32 tile whose rows are
  // 32 bytes (lanes 0-15 on rows 0-15 at bytes 0-15, lanes 16-31 at 16-31).
  static __device__ __forceinline__ A split_a(const uint32_t (&r)[4]) {
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.hi[i] = tf32_rna(__uint_as_float(r[i]));
      a.lo[i] = __float_as_uint(__uint_as_float(r[i]) - __uint_as_float(a.hi[i]));
    }
    return a;
  }
  // Split a B fragment in PTX order: (k t, n g), (k t + 4, n g).
  static __device__ __forceinline__ B split_b(float v0, float v1) {
    B b;
    b.hi[0] = tf32_rna(v0);
    b.hi[1] = tf32_rna(v1);
    b.lo[0] = __float_as_uint(v0 - __uint_as_float(b.hi[0]));
    b.lo[1] = __float_as_uint(v1 - __uint_as_float(b.hi[1]));
    return b;
  }
};

// d[m][q] += a[m] b[q] in 3xTF32 over M x NB tiles, one pass over every
// accumulator per product, so consecutive mma.sync are independent; each
// accumulator still takes lo·hi, hi·lo, hi·hi, Tf32x3::mma's order.
template <int M, int NB>
__device__ __forceinline__ void mma_tf32x3(float (&d)[M][NB][4], const Tf32x3::A (&a)[M],
                                           const Tf32x3::B (&b)[NB]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int q = 0; q < NB; ++q) mma_1688_tf32(d[m][q], a[m].lo, b[q].hi);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int q = 0; q < NB; ++q) mma_1688_tf32(d[m][q], a[m].hi, b[q].lo);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int q = 0; q < NB; ++q) mma_1688_tf32(d[m][q], a[m].hi, b[q].hi);
}

struct Bf16 {
  static constexpr int KG = 16;
  static constexpr int BW = 2;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ A make_a(const float (&v)[8]) {
    A a;
    a.r[0] = pack_bf16x2(v[0], v[1]);
    a.r[1] = pack_bf16x2(v[2], v[3]);
    a.r[2] = pack_bf16x2(v[4], v[5]);
    a.r[3] = pack_bf16x2(v[6], v[7]);
    return a;
  }
  static __device__ __forceinline__ B load_b(const float* p) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    B b;
    b.r[0] = q.x;
    b.r[1] = q.y;
    return b;
  }
  template <typename F>
  static __device__ __forceinline__ void pack_b(float* dst, F&& get, int s, int t) {
    const int k = KG * s + 2 * t;
    uint2 q;
    q.x = pack_bf16x2(get(k), get(k + 1));
    q.y = pack_bf16x2(get(k + 8), get(k + 9));
    *reinterpret_cast<uint2*>(dst) = q;
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) { mma_16816(d, a.r, b.r); }
  static __device__ __forceinline__ A load_a(const __nv_bfloat16* rg, const __nv_bfloat16* rg8, int s, int t) {
    A a;
    a.r[0] = *reinterpret_cast<const uint32_t*>(rg + KG * s + 2 * t);
    a.r[1] = *reinterpret_cast<const uint32_t*>(rg8 + KG * s + 2 * t);
    a.r[2] = *reinterpret_cast<const uint32_t*>(rg + KG * s + 8 + 2 * t);
    a.r[3] = *reinterpret_cast<const uint32_t*>(rg8 + KG * s + 8 + 2 * t);
    return a;
  }
};

// The policy of an I/O type: f32 runs 3xTF32, bf16 runs bf16.
template <typename T> struct PolicyOf;
template <> struct PolicyOf<float> { using type = Tf32x3; };
template <> struct PolicyOf<__nv_bfloat16> { using type = Bf16; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
// Two consecutive values of a row as f32 (8-byte f32 or 4-byte bf16 load).
__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// mbarrier in shared memory (phase-parity protocol).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive once and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed. A phase that never
// completes (a byte count that does not match its copies) traps after ~10 s,
// a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) asm volatile("trap;");
  }
}
// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to this CTA's shared memory through the async proxy; its
// completion counts `bytes` transactions on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// TMA: the box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory (128-byte aligned), zero-filled where the box leaves the
// tensor (negative coordinates included); completion counts the box's bytes
// on `bar`. tmap: the address of a __grid_constant__ CUtensorMap parameter.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst), "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// TMA: shared memory (128-byte aligned) to the box of a 3-D tensor map at
// (c0, c1, c2); the part of the box outside the tensor is not written.
// Completes in the thread's bulk group: commit, then wait before the shared
// memory is written again (tma_store_wait_read) or the block exits.
__device__ __forceinline__ void tma_store_3d(const void* tmap, int c0, int c1, int c2, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(tmap),
               "r"(c0), "r"(c1), "r"(c2), "r"(src)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads its operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an in-flight wgmma writes, so the compiler moves no use
// of them across a wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of wgmma, no swizzle ("interleave"): the
// operand is made of 8x8 core matrices of 16-bit values, each 128 contiguous
// bytes (8 rows of 16 bytes). For an MN-major operand (B here: the rows of a
// core matrix are 8 consecutive k, each holding 8 consecutive n) `lbo` is the
// byte step between core matrices along K and `sbo` the step along N.
__device__ __forceinline__ uint64_t desc_interleave(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32);
}

// The same for the 128-byte swizzle: atoms of 8 rows x 128 bytes (1 KB,
// 1024-byte aligned) in which the 16-byte chunk c of row r sits at chunk
// position c ^ r. For an MN-major operand a row is one k and 64 consecutive
// n; `lbo` is the byte step between atoms along N, `sbo` along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return desc_interleave(saddr, lbo, sbo) | (1ull << 62);
}

// The 32-byte swizzle for a K-major operand (the only major 8-bit wgmma
// takes): atoms of 8 rows x 32 bytes (256 B, 256-byte aligned), a row one n
// and the 32 k of one k-step, its 16-byte half h at position h ^ ((row >> 2)
// & 1). The k-step fits the swizzle's width, so the leading offset is unused;
// `sbo` is the byte step between groups of 8 rows.
__device__ __forceinline__ uint64_t desc_sw32_kmajor(uint32_t saddr, uint32_t sbo) {
  return desc_interleave(saddr, 16, sbo) | (3ull << 62);
}

// wgmma m64nNk16, bf16 x bf16 -> f32: d = a b + (acc ? d : 0). Starting a sum
// with acc 0, rather than zeroing d with moves, keeps ptxas from serialising
// the wgmma pipeline (C7515). A is the warpgroup's 64x16
// tile in registers (each warp 16 rows, laid out as mma.sync's A fragment,
// i.e. as ldmatrix.x4 leaves it); B (16 x N) is MN-major in shared memory
// (imm-trans-b 1), described by desc_b. Accumulator d[4q + 2h + e] of a thread
// (lane = 4g + t of warp w) is row 16w + g + 8h, column 8q + 2t + e.
template <int N>
struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

// wgmma m64nNk8, tf32 x tf32 -> f32: d = a b + (acc ? d : 0). A is the
// warpgroup's 64x8 tile in registers (each warp 16 rows, laid out as
// mma.sync m16n8k8's tf32 A fragment, i.e. as ldmatrix.x4 leaves a 16 x 8
// f32 tile); B (8 x N) is K-major in shared memory in the 32-byte swizzle
// (tf32 has no transpose), described by desc_b. Only the top 19 bits of each
// operand are read. Accumulator d[4q + 2h + e] sits where the bf16 one does.
// On an H100 its per-k-step sums equal mma.sync m16n8k8's bit for bit
// (B1's two f32 routes, checked in chip_smoke.py).
template <int N>
struct WgmmaTf32;

template <> struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};


// wgmma m64nNk32, s8 x s8 -> s32: d = a b + (acc ? d : 0), exact. A is the
// warpgroup's 64x32 tile in registers, laid out as for bf16 above (four b32
// per thread, each 4 consecutive k: the bytes ldmatrix.x4 leaves); B (32 x N)
// is K-major in shared memory (8-bit wgmma has no transpose), described by
// desc_b. Accumulator d[4q + 2h + e] sits where the bf16 one does.
template <int N>
struct WgmmaS8;

template <> struct WgmmaS8<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct WgmmaS8<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct WgmmaS8<24> {
  static __device__ __forceinline__ void mma(int (&d)[12], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct WgmmaS8<48> {
  static __device__ __forceinline__ void mma(int (&d)[24], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

template <> struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  }
};

}  // namespace hopper
