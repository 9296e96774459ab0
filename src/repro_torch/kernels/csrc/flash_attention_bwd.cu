// Flash attention backward with grouped KV heads: dQ, dK and dV from
// (q, k, v, out, lse, dO).
//
// Replaces the backward of the reference's custom VJP,
// src/repro/kernels/xla_flash.py:_flash_bwd (the TPU path's gradient of
// its flash attention; there is no Pallas backward). What it computes:
// with S = scale * Q K^T under the forward's mask (the causal diagonal
// offset by sk - sq, a window with causal only, keys past sk hidden),
//   P = exp(S - lse),  delta = rowsum(dO * O),  dS = P * (dP - delta),
//   dP = dO V^T,  dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO,
// dK and dV summing the GQA group's H / KV query heads onto their kv head.
// O is read in its stored dtype, as the reference reads it (:185-186).
// A row whose lse is +inf (it sees no key; the forward writes +inf there)
// has P = 0: zero dQ and nothing added to dK or dV.
//
// Layouts (contiguous): q, dO-like (B, Sq, H, D[v]); k, v (B, Sk, KV,
// D[v]); lse and delta f32 (B, Sq, H), the forward's lse layout. D and Dv
// are multiples of 8, D up to 192, Dv up to 128, as the forward takes.
// Every product is f32 FMA on the CUDA cores (inputs of either dtype are
// widened to f32 in shared memory); outputs are written in the inputs'
// dtype.
//
// What bounds it. At the training shape (llama3.2-1b, B 2, Sq = Sk 4096,
// 32/8 heads, D 64, causal) the work is 2 (3 D + 2 Dv) operations per
// (query, key) pair the mask keeps: 3.44e11, against 0.27 GB moved, so
// operations bound it: 5.13 ms at the 67 TFLOP/s of f32 FMA, which is the
// arithmetic this kernel uses (3xTF32 on the tensor cores, 2.08 ms, is
// the redesign). The two kernels below compute S and dP once each, so the
// kernel does 4.8e11 of them.
//
// Design: three launches, no atomics, deterministic.
// - flash_bwd_delta: delta = rowsum(dO * O), a warp a row.
// - flash_bwd_dkdv: a CTA per (kv tile of 64 keys, kv head, batch) keeps
//   its K, V tiles and its dK, dV accumulators resident and loops over the
//   packed q rows (position * G + g, the forward's packing) of the WHOLE
//   GQA group that can see the tile, 64 at a time: the group is folded
//   inside the CTA, which needs no atomics (the reference's :211-218).
// - flash_bwd_dq: a CTA per (64 packed q rows, kv head, batch) keeps Q,
//   dO and its dQ accumulator and loops over the kv tiles the rows see.
// Both skip the tiles that the mask hides from every row, and schedule
// the longest CTAs first. 256 threads as a 16 x 16 grid; each thread owns
// rows ty + 16 i and columns tx + 16 j of every 64-row tile it computes
// (a 4 x 4 micro-tile of S and dP; 4 x Dv/16 of dV, 4 x D/16 of dK and
// dQ). Shared rows are padded to an odd stride, so the column reads of
// 16 threads fall in 16 banks. Head dims are padded with zeros to
// DQK = DV = 32, 64 or 128 (D, Dv <= 128), or DQK 192 with DV 128.
// Shared memory at DQK = DV = 64: 100 KiB, two CTAs an SM; at 192 / 128:
// 198 KiB, one.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kBM = 64;        // packed q rows a tile
constexpr int kBN = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kBN + 1;  // padded stride of the P and dS tiles
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

template <int DQK, int DV>
struct Geo {
  static constexpr int kLdK = DQK + 1;  // Q, K rows (odd strides)
  static constexpr int kLdV = DV + 1;   // dO, V rows
  // dkdv: K, V, Q, dO tiles, P and dS, lse and delta of 64 rows
  static constexpr size_t kSmemKV =
      sizeof(float) * (static_cast<size_t>(kBN + kBM) * (kLdK + kLdV) +
                       2 * kBM * kLdP + 2 * kBM);
  // dq: Q, dO, K, V tiles, dS, lse and delta
  static constexpr size_t kSmemQ =
      sizeof(float) * (static_cast<size_t>(kBM + kBN) * (kLdK + kLdV) +
                       kBM * kLdP + 2 * kBM);
  static constexpr int kMinBlocks = 2 * kSmemKV <= 227 * 1024 ? 2 : 1;
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(a), v[1] = __high2float(a);
  v[2] = __low2float(b), v[3] = __high2float(b);
}

// Rows [0, nrows) of a tile into f32 shared memory of stride LD, columns
// [0, ncols) (a multiple of 4); off(rr) is row rr's element offset in
// src, or -1 for a row past the edge, which is written as zeros.
template <typename T, int LD, typename Off>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int nrows, int ncols, Off off) {
  const int cpr = ncols >> 2;
  for (int idx = threadIdx.x; idx < nrows * cpr; idx += kThreads) {
    const int rr = idx / cpr, c = (idx - rr * cpr) << 2;
    const long long o = off(rr);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (o >= 0) load4(src + o + c, v);
    float* d = dst + rr * LD + c;
    d[0] = v[0], d[1] = v[1], d[2] = v[2], d[3] = v[3];
  }
}

// Columns [c0, c1) of rows [0, nrows) set to zero: the head-dim padding,
// which the tile loads never write.
__device__ void zero_cols(float* base, int nrows, int ld, int c0, int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int idx = threadIdx.x; idx < nrows * w; idx += kThreads) {
    const int r = idx / w;
    base[r * ld + c0 + idx - r * w] = 0.f;
  }
}

// acc[i][j] += sum_c a[(ty + 16 i) * LDA + c] * b[(tx + 16 j) * LDB + c]:
// a 64 x 64 product of two row-major tiles over their padded dim.
template <int DIM, int LDA, int LDB>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < DIM; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LDA + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * LDB + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_m a[m * LDA + ty + 16 i] * b[m * LDB + tx + 16 j] over
// the tile's 64 rows m: a transposed 64-row tile times a row-major one.
template <int N, int LDA, int LDB>
__device__ __forceinline__ void mm_tn(float (&acc)[4][N / 16],
                                      const float* a, const float* b, int ty,
                                      int tx) {
#pragma unroll 4
  for (int m = 0; m < kBM; ++m) {
    float x[4], y[N / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[m * LDA + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) y[j] = b[m * LDB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_n a[(ty + 16 i) * LDA + n] * b[n * LDB + tx + 16 j] over
// a tile's 64 keys n: a row-major tile times a row-major one.
template <int N, int LDA, int LDB>
__device__ __forceinline__ void mm_nn(float (&acc)[4][N / 16],
                                      const float* a, const float* b, int ty,
                                      int tx) {
#pragma unroll 4
  for (int n = 0; n < kBN; ++n) {
    float x[4], y[N / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LDA + n];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) y[j] = b[n * LDB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Whether packed row r (position r / grp) sees key j.
__device__ __forceinline__ bool visible(int qpos, int j, int sk, int causal,
                                        int window) {
  return j < sk &&
         (!causal || (j <= qpos && (window <= 0 || qpos - j < window)));
}

// P and dS of one (64 rows x 64 keys) tile from S and dP in registers,
// written to shared memory. qp[i]: row ty + 16 i's position + offset, or
// INT_MIN past the edge; lse2 and delta: the tile's rows.
__device__ __forceinline__ void p_and_ds(const float (&s)[4][4],
                                         const float (&dp)[4][4],
                                         const int (&qp)[4], int kv0,
                                         const float* lse2,
                                         const float* delta, float* sP,
                                         float* sdS, int sk, int causal,
                                         int window, float scale_log2, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l2 = lse2[r], dl = delta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      const bool keep = qp[i] != INT_MIN &&
                        visible(qp[i], kv0 + n, sk, causal, window);
      const float p = keep ? exp2f(s[i][j] * scale_log2 - l2) : 0.f;
      if (sP != nullptr) sP[r * kLdP + n] = p;
      sdS[r * kLdP + n] = p * (dp[i][j] - dl);
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// delta = rowsum(dO * O) in f32 for every (b, position, head) row; a warp
// a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long nrows, int dv) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= nrows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + row * dv;
  const T* drow = dout + row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc = fmaf(repro::to_float(drow[c]), repro::to_float(orow[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// The packed rows [row_lo, row_hi) of a (batch, kv head) that can see keys
// [kv0, kv0 + kBN).
__device__ __forceinline__ void rows_seeing(int kv0, int sq, int sk, int grp,
                                            int causal, int window,
                                            int& row_lo, int& row_hi) {
  const int offset = sk - sq;
  int pos_lo = 0, pos_hi = sq - 1;
  if (causal) {
    pos_lo = max(0, kv0 - offset);
    if (window > 0)
      pos_hi = min(sq - 1, min(kv0 + kBN, sk) - 1 - offset + window - 1);
  }
  row_lo = pos_lo * grp;
  row_hi = pos_hi >= pos_lo ? (pos_hi + 1) * grp : row_lo;
}

// dK, dV of one kv tile, summed over the GQA group's rows.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, (Geo<DQK, DV>::kMinBlocks))
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dvo, int sq, int sk, int h,
               int kvh, int d, int dv, int causal, int window, float scale) {
  using G = Geo<DQK, DV>;
  constexpr int LDK = G::kLdK, LDV = G::kLdV;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                 // kBN x LDK
  float* sV = sK + kBN * LDK;       // kBN x LDV
  float* sQ = sV + kBN * LDV;       // kBM x LDK
  float* sdO = sQ + kBM * LDK;      // kBM x LDV
  float* sP = sdO + kBM * LDV;      // kBM x kLdP
  float* sdS = sP + kBM * kLdP;     // kBM x kLdP
  float* sL = sdS + kBM * kLdP;     // kBM: lse, log2 units
  float* sD = sL + kBM;             // kBM: delta

  const int grp = h / kvh, rows = sq * grp, offset = sk - sq;
  const int kv0 = blockIdx.x * kBN;  // low kv tiles see the most rows
  const int kh = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float scale_log2 = scale * kLog2e;

  zero_cols(sK, kBN, LDK, d, DQK);
  zero_cols(sQ, kBM, LDK, d, DQK);
  zero_cols(sV, kBN, LDV, dv, DV);
  zero_cols(sdO, kBM, LDV, dv, DV);
  const auto key_off = [&](int stride) {
    return [=](int rr) -> long long {
      const int j = kv0 + rr;
      return j < sk ? ((static_cast<long long>(bb) * sk + j) * kvh + kh) *
                          stride
                    : -1;
    };
  };
  load_tile<T, LDK>(sK, k, kBN, d, key_off(d));
  load_tile<T, LDV>(sV, v, kBN, dv, key_off(dv));

  float acc_k[4][DQK / 16], acc_v[4][DV / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DQK / 16; ++j) acc_k[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 16; ++j) acc_v[i][j] = 0.f;
  }

  int row_lo, row_hi;
  rows_seeing(kv0, sq, sk, grp, causal, window, row_lo, row_hi);
  for (int m0 = row_lo; m0 < row_hi; m0 += kBM) {
    // packed row m0 + rr: position (m0 + rr) / grp, its head in the group
    const auto row_index = [=](int rr) -> long long {
      const int r = m0 + rr;
      if (r >= min(row_hi, rows)) return -1;
      const int pos = r / grp;
      return (static_cast<long long>(bb) * sq + pos) * h + kh * grp + r -
             pos * grp;
    };
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, LDK>(sQ, q, kBM, d, [=](int rr) {
      const long long i = row_index(rr);
      return i < 0 ? -1 : i * d;
    });
    load_tile<T, LDV>(sdO, dout, kBM, dv, [=](int rr) {
      const long long i = row_index(rr);
      return i < 0 ? -1 : i * dv;
    });
    for (int rr = threadIdx.x; rr < kBM; rr += kThreads) {
      const long long i = row_index(rr);
      sL[rr] = i < 0 ? INFINITY : lse[i] * kLog2e;
      sD[rr] = i < 0 ? 0.f : delta[i];
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<DQK, LDK, LDK>(s, sQ, sK, ty, tx);
    mm_nt<DV, LDV, LDV>(dp, sdO, sV, ty, tx);
    int qp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty + 16 * i;
      qp[i] = r < min(row_hi, rows) ? r / grp + offset : INT_MIN;
    }
    p_and_ds(s, dp, qp, kv0, sL, sD, sP, sdS, sk, causal, window,
             scale_log2, ty, tx);
    __syncthreads();
    mm_tn<DV, kLdP, LDV>(acc_v, sP, sdO, ty, tx);
    mm_tn<DQK, kLdP, LDK>(acc_k, sdS, sQ, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = kv0 + ty + 16 * i;
    if (j >= sk) continue;
    const long long row = (static_cast<long long>(bb) * sk + j) * kvh + kh;
#pragma unroll
    for (int c = 0; c < DQK / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(dk + row * d + col, acc_k[i][c] * scale);
    }
#pragma unroll
    for (int c = 0; c < DV / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) store(dvo + row * dv + col, acc_v[i][c]);
    }
  }
}

// dQ of 64 packed rows of one (batch, kv head), over the kv tiles they see.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, (Geo<DQK, DV>::kMinBlocks))
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int sq, int sk, int h, int kvh, int d,
             int dv, int causal, int window, float scale) {
  using G = Geo<DQK, DV>;
  constexpr int LDK = G::kLdK, LDV = G::kLdV;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                 // kBM x LDK
  float* sdO = sQ + kBM * LDK;      // kBM x LDV
  float* sK = sdO + kBM * LDV;      // kBN x LDK
  float* sV = sK + kBN * LDK;       // kBN x LDV
  float* sdS = sV + kBN * LDV;      // kBM x kLdP
  float* sL = sdS + kBM * kLdP;     // kBM
  float* sD = sL + kBM;             // kBM

  const int grp = h / kvh, rows = sq * grp, offset = sk - sq;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest tiles first
  const int kh = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float scale_log2 = scale * kLog2e;

  zero_cols(sQ, kBM, LDK, d, DQK);
  zero_cols(sK, kBN, LDK, d, DQK);
  zero_cols(sdO, kBM, LDV, dv, DV);
  zero_cols(sV, kBN, LDV, dv, DV);
  const auto row_index = [=](int rr) -> long long {
    const int r = m0 + rr;
    if (r >= rows) return -1;
    const int pos = r / grp;
    return (static_cast<long long>(bb) * sq + pos) * h + kh * grp + r -
           pos * grp;
  };
  load_tile<T, LDK>(sQ, q, kBM, d, [=](int rr) {
    const long long i = row_index(rr);
    return i < 0 ? -1 : i * d;
  });
  load_tile<T, LDV>(sdO, dout, kBM, dv, [=](int rr) {
    const long long i = row_index(rr);
    return i < 0 ? -1 : i * dv;
  });
  for (int rr = threadIdx.x; rr < kBM; rr += kThreads) {
    const long long i = row_index(rr);
    sL[rr] = i < 0 ? INFINITY : lse[i] * kLog2e;
    sD[rr] = i < 0 ? 0.f : delta[i];
  }

  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    qp[i] = r < rows ? r / grp + offset : INT_MIN;
  }
  // the kv tiles any real row of this tile can see
  const int pos_first = m0 / grp;
  const int pos_last = (min(m0 + kBM, rows) - 1) / grp;
  int kv_lo = 0, kv_hi = sk;
  if (causal) {
    kv_hi = min(sk, pos_last + offset + 1);
    if (window > 0) kv_lo = max(0, pos_first + offset - window + 1);
  }

  float acc[4][DQK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DQK / 16; ++j) acc[i][j] = 0.f;

  for (int kv0 = (kv_lo / kBN) * kBN; kv0 < kv_hi; kv0 += kBN) {
    const auto key_off = [=](int stride) {
      return [=](int rr) -> long long {
        const int j = kv0 + rr;
        return j < sk ? ((static_cast<long long>(bb) * sk + j) * kvh + kh) *
                            stride
                      : -1;
      };
    };
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, LDK>(sK, k, kBN, d, key_off(d));
    load_tile<T, LDV>(sV, v, kBN, dv, key_off(dv));
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<DQK, LDK, LDK>(s, sQ, sK, ty, tx);
    mm_nt<DV, LDV, LDV>(dp, sdO, sV, ty, tx);
    p_and_ds(s, dp, qp, kv0, sL, sD, nullptr, sdS, sk, causal, window,
             scale_log2, ty, tx);
    __syncthreads();
    mm_nn<DQK, kLdP, LDK>(acc, sdS, sK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row_index(ty + 16 * i);
    if (row < 0) continue;
#pragma unroll
    for (int c = 0; c < DQK / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(dq + row * d + col, acc[i][c] * scale);
    }
  }
}

// The shared-memory opt-in of one kernel, once per device.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, std::once_flag (&once)[kMaxDevices],
                   cudaError_t (&err)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] {
    err[dev] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  });
  return err[dev];
}

template <typename T, int DQK, int DV>
int launch_dh(const T* q, const T* k, const T* v, const T* o, const T* dout,
              const float* lse, float* delta, T* dq, T* dk, T* dvo, int b,
              int sq, int sk, int h, int kvh, int d, int dv, int causal,
              int window, float scale, cudaStream_t stream) {
  using G = Geo<DQK, DV>;
  auto kv_kernel = flash_bwd_dkdv<T, DQK, DV>;
  auto q_kernel = flash_bwd_dq<T, DQK, DV>;
  static std::once_flag kv_once[kMaxDevices], q_once[kMaxDevices];
  static cudaError_t kv_err[kMaxDevices], q_err[kMaxDevices];
  cudaError_t e = opt_in(kv_kernel, G::kSmemKV, kv_once, kv_err);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in(q_kernel, G::kSmemQ, q_once, q_err);
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long nrows = static_cast<long long>(b) * sq * h;
  const int rows_per_cta = kThreads / 32;
  flash_bwd_delta<T><<<static_cast<unsigned>((nrows + rows_per_cta - 1) /
                                              rows_per_cta),
                       kThreads, 0, stream>>>(o, dout, delta, nrows, dv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = sq * (h / kvh);
  q_kernel<<<dim3((rows + kBM - 1) / kBM, kvh, b), kThreads, G::kSmemQ,
             stream>>>(q, k, v, dout, lse, delta, dq, sq, sk, h, kvh, d, dv,
                       causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (sk > 0)
    kv_kernel<<<dim3((sk + kBN - 1) / kBN, kvh, b), kThreads, G::kSmemKV,
                stream>>>(q, k, v, dout, lse, delta, dk, dvo, sq, sk, h, kvh,
                          d, dv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dvo, int b, int sq, int sk, int h, int kvh, int d,
           int dv, int causal, int window, float scale, cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || d <= 0 || d > 192 || dv <= 0 ||
      dv > 128 || d % 8 != 0 || dv % 8 != 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *tdo = static_cast<const T*>(dout);
  T *tdq = static_cast<T*>(dq), *tdk = static_cast<T*>(dk),
    *tdv = static_cast<T*>(dvo);
#define REPRO_BWD(DQK, DV)                                                   \
  launch_dh<T, DQK, DV>(tq, tk, tv, to, tdo, lse, delta, tdq, tdk, tdv, b,   \
                        sq, sk, h, kvh, d, dv, causal, window, scale, stream)
  if (d > 128) return REPRO_BWD(192, 128);
  const int dmax = d > dv ? d : dv;
  if (dmax <= 32) return REPRO_BWD(32, 32);
  if (dmax <= 64) return REPRO_BWD(64, 64);
  return REPRO_BWD(128, 128);
#undef REPRO_BWD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: the forward's (B, Sq, H) f32;
// delta: (B, Sq, H) f32 scratch; dq, dk, dv in the inputs' dtype.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int dtype, int b, int sq, int sk, int h,
                                   int kvh, int d, int dvd, int causal,
                                   int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, sk, h,
                         kvh, d, dvd, causal, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq,
                                 sk, h, kvh, d, dvd, causal, window, scale,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
