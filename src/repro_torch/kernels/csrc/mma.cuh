// Tensor-core building blocks shared by the flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): cp.async copies, ldmatrix,
// the 3xTF32 split, mma.sync in tf32 and bf16, and the two products both
// kernels are made of.
//
// The products, for one warp and a 16-row A:
// - abt: C (16 x N) += A (16 x K) B^T, A's and B's rows in shared memory
//   with the same padded stride, K the inner dim (S = Q K^T in the
//   forward; S, S^T, dP and dP^T in the backward).
// - pb: C (16 x N) += P (16 x K) B, P in m16n8 accumulator registers, B's
//   K rows in shared memory (P V in the forward; dV, dK and dQ in the
//   backward).
// f32 inputs take three TF32 passes (small * big + big * small +
// big * big, accumulated in f32), bf16 inputs one bf16 pass with an f32
// accumulator.
//
// Accumulator layout of an m16n8 tile (both instructions): lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t, 2t + 1
// as c[0], c[1] (row g) and c[2], c[3] (row g + 8).
//
// In pb's tf32 path the k index inside a k-step of 8 is permuted (MMA k
// index t holds column 2t of P, t + 4 holds 2t + 1), the same way for P
// and B, so P feeds the MMA from the accumulators without a shuffle; the
// sum is unchanged.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with valid false it writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte asynchronous copy; with valid false it writes 4 zero bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small: big = tf32(x) rounded to nearest, small the f32
// remainder x - big (exact), of which the MMA reads the TF32 part (its top
// 19 bits; truncating there costs ~2^-21 |x|, the order of the small *
// small term the split leaves out).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// Not volatile: register operands only, so the compiler may interleave
// MMAs of independent accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// c (16 x N) += A B^T, f32 inputs, 3xTF32. sa: the warp's 16 rows of A;
// sb: N rows of B. ldmatrix reads f32 fragments too: an 8 x 8 b16 matrix
// is 8 rows of 4 floats, and lane (g, t) receives float (g, t), the tf32
// A and B layout. Each pass runs over the k-step's independent n-tiles
// before the next pass adds to them, small terms first.
template <int K, int N, int LD>
__device__ __forceinline__ void abt_f32(float (&c)[N / 8][4],
                                        const float* sa, const float* sb,
                                        int lane) {
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    uint32_t qa[4], ab[4], as[4];  // rows 0-7 | 8-15, columns t | t + 4
    ldsm_x4(qa, sa + ((i & 1) * 8 + r) * LD + ks * 8 + (i >> 1) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(__uint_as_float(qa[e]), ab[e], as[e]);
    uint32_t bb[N / 8][2], bs[N / 8][2];
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t kb[4];  // B rows 16np + 0..7 | 8..15, columns t | t + 4
      ldsm_x4(kb, sb + (np * 16 + (i >> 1) * 8 + r) * LD + ks * 8 +
                      (i & 1) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(__uint_as_float(kb[e]), bb[2 * np + (e >> 1)][e & 1],
                   bs[2 * np + (e >> 1)][e & 1]);
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
      mma_tf32(c[nt], as, bb[nt][0], bb[nt][1]);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
      mma_tf32(c[nt], ab, bs[nt][0], bs[nt][1]);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
      mma_tf32(c[nt], ab, bb[nt][0], bb[nt][1]);
  }
}

// c (16 x N) += P B, f32, 3xTF32; P (16 x K) in accumulator registers, B
// K rows of stride LD. The output n-tiles go in groups of 4, three passes
// per group.
template <int N, int K, int LD>
__device__ __forceinline__ void pb_f32(float (&c)[N / 8][4],
                                       const float (&p)[K / 8][4],
                                       const float* sb, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    // MMA k index t is P's column 2t, t + 4 is 2t + 1 (see the note)
    uint32_t ab[4], as[4];
    split_tf32(p[kk][0], ab[0], as[0]);
    split_tf32(p[kk][2], ab[1], as[1]);
    split_tf32(p[kk][1], ab[2], as[2]);
    split_tf32(p[kk][3], ab[3], as[3]);
    const float* br = sb + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n0 = 0; n0 < N / 8; n0 += 4) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(br[(n0 + j) * 8], bb[j][0], bs[j][0]);
        split_tf32(br[LD + (n0 + j) * 8], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_tf32(c[n0 + j], as, bb[j][0], bb[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_tf32(c[n0 + j], ab, bs[j][0], bs[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_tf32(c[n0 + j], ab, bb[j][0], bb[j][1]);
    }
  }
}

// The A fragments of abt_bf16: the warp's 16 rows of A, K columns.
template <int K, int LD>
__device__ __forceinline__ void load_a_bf16(uint32_t (&af)[K / 16][4],
                                            const __nv_bfloat16* sa,
                                            int lane) {
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    ldsm_x4(af[ks], sa + ((i & 1) * 8 + r) * LD + ks * 16 + (i >> 1) * 8);
}

// c = A B^T, bf16; A's fragments already in registers (load_a_bf16).
template <int K, int N, int LD>
__device__ __forceinline__ void abt_bf16(float (&c)[N / 8][4],
                                         const uint32_t (&af)[K / 16][4],
                                         const __nv_bfloat16* sb, int lane) {
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];  // B rows 16np + 0..7 | 8..15, k low | high half
      ldsm_x4(b, sb + (np * 16 + (i >> 1) * 8 + r) * LD + ks * 16 +
                     (i & 1) * 8);
      mma_bf16(c[2 * np], af[ks], b[0], b[1]);
      mma_bf16(c[2 * np + 1], af[ks], b[2], b[3]);
    }
  }
}

// c = A B^T, bf16; A's 16 rows read from shared memory a k-step at a time.
template <int K, int N, int LD>
__device__ __forceinline__ void abt_bf16(float (&c)[N / 8][4],
                                         const __nv_bfloat16* sa,
                                         const __nv_bfloat16* sb, int lane) {
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, sa + ((i & 1) * 8 + r) * LD + ks * 16 + (i >> 1) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, sb + (np * 16 + (i >> 1) * 8 + r) * LD + ks * 16 +
                     (i & 1) * 8);
      mma_bf16(c[2 * np], af, b[0], b[1]);
      mma_bf16(c[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// c += P B, bf16; P rounded to bf16 from the accumulators.
template <int N, int K, int LD>
__device__ __forceinline__ void pb_bf16(float (&c)[N / 8][4],
                                        const float (&p)[K / 8][4],
                                        const __nv_bfloat16* sb, int lane) {
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];  // B rows low | high half, columns 16np + 0..7 | 8..15
      ldsm_x4_trans(b, sb + (kk * 16 + (i & 1) * 8 + r) * LD + np * 16 +
                           (i >> 1) * 8);
      mma_bf16(c[2 * np], a, b[0], b[1]);
      mma_bf16(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// c += A B^T for either input type, A's and B's rows in shared memory.
template <int K, int N, int LD, typename T>
__device__ __forceinline__ void abt(float (&c)[N / 8][4], const T* sa,
                                   const T* sb, int lane) {
  if constexpr (sizeof(T) == 4)
    abt_f32<K, N, LD>(c, sa, sb, lane);
  else
    abt_bf16<K, N, LD>(c, sa, sb, lane);
}

template <int N, int K, int LD, typename T>
__device__ __forceinline__ void pb(float (&c)[N / 8][4],
                                   const float (&p)[K / 8][4], const T* sb,
                                   int lane) {
  if constexpr (sizeof(T) == 4)
    pb_f32<N, K, LD>(c, p, sb, lane >> 2, lane & 3);
  else
    pb_bf16<N, K, LD>(c, p, sb, lane);
}

// Columns [c0, c1) of rows [0, nrows) set to zero by a block of
// NTHREADS: the head-dim padding, which the tile copies never write.
template <int NTHREADS, typename T>
__device__ void zero_cols(T* base, int nrows, int ld, int c0, int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int idx = threadIdx.x; idx < nrows * w; idx += NTHREADS) {
    const int r = idx / w;
    base[r * ld + c0 + idx - r * w] = from_float<T>(0.f);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace repro
