// Flash attention backward with grouped KV heads, on the H100's tensor
// cores: dQ, dK and dV from (q, k, v, out, lse, dO).
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
// Layouts (contiguous, 16-byte aligned): q, dO-like (B, Sq, H, D[v]);
// k, v (B, Sk, KV, D[v]); lse and delta f32 (B, Sq, H), the forward's lse
// layout. D and Dv are multiples of 8, D up to 192, Dv up to 128, as the
// forward takes. Outputs are written in the inputs' dtype.
//
// What bounds it. At the training shape (llama3.2-1b, B 2, Sq = Sk 4096,
// 32/8 heads, D 64, causal) the five products need 2 (3 D + 2 Dv)
// operations per (query, key) pair the mask keeps: 3.44e11, against
// 0.27 GB moved, so operations bound it. f32 inputs take the forward's
// 3xTF32 split (mma.cuh): as accurate as f32 FMA, and the least time to
// it on this card, 3 x 3.44e11 at 495 TFLOP/s = 2.08 ms (one TF32 pass
// misses the backward's 5e-4 bar; tests/test_torch_kernels.py -k 3xtf32).
// bf16 inputs take one bf16 MMA with an f32 accumulator, P and dS rounded
// to bf16 only as MMA operands: 0.35 ms at 989 TFLOP/s.
//
// Design: three launches, no atomics, deterministic (two calls give
// bit-equal results). Every product is mma.sync (m16n8k8 tf32 or
// m16n8k16 bf16), one warp per 16 rows of its output.
// - flash_bwd_delta: delta = rowsum(dO * O), a warp a row.
// - flash_bwd_dkdv: the forward's loop with the roles swapped. A CTA per
//   (64 keys, kv head, batch), each of its 4 warps owning 16 keys, keeps K
//   and V resident and walks the packed q rows (position * G + g, the
//   forward's packing) of the WHOLE GQA group that can see its keys, BM
//   at a time: the group folds inside the CTA, with no atomics (the
//   reference's :211-218). Per q tile a warp computes S^T = K Q^T and
//   dP^T = V dO^T in accumulator registers, turns them there into
//   P^T = exp2(S^T scale log2e - lse2[col]) and
//   dS^T = P^T (dP^T - delta[col]) (lse and delta are per query, so per
//   column, read from the tile's shared arrays), and feeds both straight
//   from the registers as the A operand of dV += P^T dO and
//   dK += dS^T Q (mma.cuh's pb). P and dS never touch shared memory.
// - flash_bwd_dq: the forward's loop plus one product. A CTA per (64
//   packed q rows, kv head, batch), a warp 16 rows: S = Q K^T and
//   dP = dO V^T in registers, dS there, dQ += dS K from the registers.
// - Q, dO, lse and delta (dkdv) and K, V (dq) arrive through a 2-stage
//   cp.async ring, 16-byte copies (4-byte for lse and delta), zero-filled
//   past the edge: the next tile's copy is in flight while this tile's
//   MMAs run. Both kernels skip the tiles that the mask hides from every
//   row, mask only the tiles that cross an edge, and schedule the
//   longest CTAs first.
// - dK, dV and dQ take each tile's products in a zeroed register tile,
//   added to the running sum with rounding (pb_into). The tensor cores'
//   f32 accumulation truncates: added straight in, the training shape's
//   16384 packed rows left dV ~1.6e-3 from its plain version; through the
//   tile, ~1.8e-5.
// - Why the dQ kernel computes S and dP again (7 products where 5 would
//   do, 1.4x the minimal work at D = Dv): a dQ without atomics needs
//   either that, or a partial dQ per kv tile summed afterwards, 64 tiles
//   x 67 MB = 4.3 GB at the training shape.
// - Why mma.sync and not wgmma: wgmma wants B, and A unless it comes from
//   registers, in shared memory in its own swizzled layout, with a
//   64-row warpgroup tile; the dV and dK products would need P^T and dS^T
//   as B-side operands in shared memory, written every q tile. mma.sync
//   takes them from the accumulators. wgmma is the next step.
// - Shared rows are padded by 16 bytes, which makes the ldmatrix reads and
//   pb's scalar f32 reads conflict-free (mma.cuh). Head dims are padded
//   with zeros, written once: Q and K to DQK, dO and V to DV. DQK = DV =
//   32, 64 or 128 covers every D, Dv <= 128; D in (128, 192] takes DQK
//   192 with DV 128.
// - Registers: dkdv holds dK (16 x DQK) and dV (16 x DV) a warp, plus S^T
//   and dP^T (16 x BM): BM is 64 at DQK + DV <= 128 and 16 above, so the
//   accumulators stay at 128-176 a thread. dq takes BN 64 keys a step
//   (f32: 32 at DQK 128, 16 at 192). bf16 keeps the K/V (dkdv) or Q/dO
//   (dq) A fragments in registers at DQK + DV <= 128 and reads them a
//   k-step at a time above that.
//   Shared memory, dkdv = (64 + 2 BM) rows x (LDK + LDV) + 16 BM B of lse
//   and delta; dq = (64 + 2 BN) rows x (LDK + LDV). CTAs an SM by shared
//   memory (__launch_bounds__ says so), and ptxas -v (sm_90a, CUDA 12.8):
//   registers a thread, spill stores / loads in bytes:
//     instance      dkdv                         dq
//     f32  32/32    55 KiB, 2, 201 regs, 0/0     54 KiB, 2, 208, 0/0
//     f32  64/64    103 KiB, 2, 233, 0/0         102 KiB, 2, 215, 0/0
//     f32 128/128   99.25 KiB, 2, 255, 16/16     132 KiB, 1, 224, 0/0
//     f32 192/128   123.25 KiB, 1, 255, 16/16    123 KiB, 1, 253, 0/0
//     bf16 32/32    31 KiB, 2, 183, 0/0          30 KiB, 2, 154, 0/0
//     bf16 64/64    55 KiB, 2, 250, 0/0          54 KiB, 2, 204, 0/0
//     bf16 128/128  51.25 KiB, 2, 255, 4/8       102 KiB, 2, 221, 0/0
//     bf16 192/128  63.25 KiB, 2, 255, 12/8      126 KiB, 1, 255, 0/0
//   The D 64 instances, the training shape's, do not spill; the dkdv
//   instances at DQK >= 128 spill 4-16 bytes a thread.
// - cudaFuncSetAttribute runs once per kernel instance and device.
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "mma.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 128;        // 4 warps of 16 rows each
constexpr int kStages = 2;
constexpr int kDeltaThreads = 256;   // a warp a row
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry of one (type, padded Q/K head dim, padded V head dim)
// instance; DV <= DQK.
template <typename T, int DQK, int DV>
struct Geo {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per copy
  static constexpr int kLdK = DQK + kVec;  // padded row stride, Q and K
  static constexpr int kLdV = DV + kVec;   // padded row stride, dO and V
  static constexpr int kKeys = 64;         // dkdv: keys a CTA
  static constexpr int kBM =               // dkdv: packed q rows a step
      DQK + DV <= 128 ? 64 : 16;
  static constexpr int kRows = 64;         // dq: packed q rows a CTA
  static constexpr int kBN =               // dq: keys a step
      sizeof(T) == 2 ? 64 : (DQK <= 64 ? 64 : (DQK <= 128 ? 32 : 16));
  static constexpr size_t kSmemKV =
      sizeof(T) * static_cast<size_t>(kKeys + kStages * kBM) *
          (kLdK + kLdV) +
      sizeof(float) * 2 * kStages * kBM;
  static constexpr size_t kSmemQ =
      sizeof(T) * static_cast<size_t>(kRows + kStages * kBN) * (kLdK + kLdV);
  // CTAs an SM holds: two while both fit the SM's 227 KiB
  static constexpr int kMinBlocksKV = 2 * kSmemKV <= 227 * 1024 ? 2 : 1;
  static constexpr int kMinBlocksQ = 2 * kSmemQ <= 227 * 1024 ? 2 : 1;
  // bf16: A fragments held in registers across the tiles
  static constexpr bool kHoldA = sizeof(T) == 2 && DQK + DV <= 128;
};

// acc += P B (mma.cuh's pb) through tiles of their own: the MMAs add into
// a zeroed tile, which is then added to acc in f32 with rounding to
// nearest. The tensor cores' f32 accumulation truncates; adding straight
// into acc, whose sums run over up to G Sq rows (16384 at the training
// shape, 3 MMAs a k-step of 8), let those truncations pile up to ~1e-3 of
// acc, the error of one TF32 pass. The tile is acc's row of N columns up
// to 64, and 32-column chunks above that, so it costs at most 32
// registers.
template <int N, int K, int LD, typename T>
__device__ __forceinline__ void pb_into(float (&acc)[N / 8][4],
                                        const float (&p)[K / 8][4],
                                        const T* sb, int lane) {
  constexpr int NC = N <= 64 ? N : 32;  // columns a chunk
  static_assert(N % NC == 0, "whole chunks");
#pragma unroll
  for (int c0 = 0; c0 < N; c0 += NC) {
    float c[NC / 8][4];
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
    pb<NC, K, LD>(c, p, sb + c0, lane);
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 / 8 + nt][e] += c[nt][e];
  }
}

// Whether a query at position qpos (offset applied) sees key j.
__device__ __forceinline__ bool visible(int qpos, int j, int sk, int causal,
                                        int window) {
  return j < sk &&
         (!causal || (j <= qpos && (window <= 0 || qpos - j < window)));
}

// delta = rowsum(dO * O) in f32 for every (b, position, head) row; a warp
// a row.
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long nrows, int dv) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kDeltaThreads / 32) + (threadIdx.x >> 5);
  if (row >= nrows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + row * dv;
  const T* drow = dout + row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc = fmaf(to_float(drow[c]), to_float(orow[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// The packed rows [row_lo, row_hi) of a (batch, kv head) that can see
// keys [kv0, kv0 + bn).
__device__ __forceinline__ void rows_seeing(int kv0, int bn, int sq, int sk,
                                            int grp, int causal, int window,
                                            int& row_lo, int& row_hi) {
  const int offset = sk - sq;
  int pos_lo = 0, pos_hi = sq - 1;
  if (causal) {
    pos_lo = max(0, kv0 - offset);
    if (window > 0)
      pos_hi = min(sq - 1, min(kv0 + bn, sk) - 1 - offset + window - 1);
  }
  row_lo = pos_lo * grp;
  row_hi = pos_hi >= pos_lo ? (pos_hi + 1) * grp : row_lo;
}

// Element offset of packed row r (position r / grp, head kh * grp +
// r % grp) of batch bb in a (B, Sq, H, width) tensor, over width.
__device__ __forceinline__ size_t packed_row(int r, int grp, int bb, int sq,
                                             int h, int kh) {
  const int pos = r / grp;
  return (static_cast<size_t>(bb) * sq + pos) * h + kh * grp + r - pos * grp;
}

// dK, dV of 64 keys, summed over the GQA group's rows.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads,
                                  (Geo<T, DQK, DV>::kMinBlocksKV))
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dvo, int sq, int sk, int h,
               int kvh, int d, int dv, int causal, int window, float scale) {
  using G = Geo<T, DQK, DV>;
  constexpr int BN = G::kKeys, BM = G::kBM, LDK = G::kLdK, LDV = G::kLdV;
  constexpr int VEC = G::kVec, CPR = DQK / VEC;  // 16-byte chunks a row
  static_assert(DV <= DQK, "dO's and V's rows are copied in DQK's loop");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // BN x LDK
  T* sQ = sK + BN * LDK;                   // kStages x BM x LDK
  T* sV = sQ + kStages * BM * LDK;         // BN x LDV
  T* sdO = sV + BN * LDV;                  // kStages x BM x LDV
  float* sL = reinterpret_cast<float*>(sdO + kStages * BM * LDV);
  float* sD = sL + kStages * BM;           // lse, delta: kStages x BM each

  const int grp = h / kvh, offset = sk - sq;
  const int kv0 = blockIdx.x * BN;  // low kv tiles see the most rows: first
  const int kh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  int row_lo, row_hi;  // row_hi <= sq * grp
  rows_seeing(kv0, BN, sq, sk, grp, causal, window, row_lo, row_hi);
  const int ntiles = (row_hi - row_lo + BM - 1) / BM;

  // head-dim padding stays zero: the copies never write it
  zero_cols<kThreads>(sK, BN + kStages * BM, LDK, d, DQK);
  zero_cols<kThreads>(sV, BN + kStages * BM, LDV, dv, DV);

  if (ntiles > 0) {
    for (int idx = tid; idx < BN * CPR; idx += kThreads) {
      const int rr = idx / CPR, c = (idx % CPR) * VEC;
      const int j = kv0 + rr;
      const bool ok = j < sk;
      const size_t row =
          (static_cast<size_t>(bb) * sk + (ok ? j : 0)) * kvh + kh;
      if (c < d) cp_async16(sK + rr * LDK + c, k + row * d + c, ok);
      if (c < dv) cp_async16(sV + rr * LDV + c, v + row * dv + c, ok);
    }
  }
  cp_async_commit();

  // Q, dO, lse and delta of q tile `tile` into `stage`; rows past row_hi
  // are zeros
  auto load_q = [&](int tile, int stage) {
    const int m0 = row_lo + tile * BM;
    T* dq_ = sQ + stage * BM * LDK;
    T* ddo = sdO + stage * BM * LDV;
    for (int idx = tid; idx < BM * CPR; idx += kThreads) {
      const int rr = idx / CPR, c = (idx % CPR) * VEC;
      const int r = m0 + rr;
      const bool ok = r < row_hi;
      const size_t row = packed_row(ok ? r : 0, grp, bb, sq, h, kh);
      if (c < d) cp_async16(dq_ + rr * LDK + c, q + row * d + c, ok);
      if (c < dv) cp_async16(ddo + rr * LDV + c, dout + row * dv + c, ok);
    }
    for (int rr = tid; rr < BM; rr += kThreads) {
      const int r = m0 + rr;
      const bool ok = r < row_hi;
      const size_t row = packed_row(ok ? r : 0, grp, bb, sq, h, kh);
      cp_async4(sL + stage * BM + rr, lse + row, ok);
      cp_async4(sD + stage * BM + rr, delta + row, ok);
    }
  };
  if (ntiles > 0) load_q(0, 0);
  cp_async_commit();

  const T* sKw = sK + warp * 16 * LDK;  // this warp's 16 keys
  const T* sVw = sV + warp * 16 * LDV;
  const int key0 = kv0 + warp * 16 + g;  // this lane's keys key0, key0 + 8
  uint32_t kf[G::kHoldA ? DQK / 16 : 1][4], vf[G::kHoldA ? DV / 16 : 1][4];
  float acc_k[DQK / 8][4], acc_v[DV / 8][4];
#pragma unroll
  for (int nt = 0; nt < DQK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[nt][e] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < ntiles) load_q(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this tile have landed
    __syncthreads();
    if constexpr (G::kHoldA) {
      if (tile == 0) {
        load_a_bf16<DQK, LDK>(kf, sKw, lane);
        load_a_bf16<DV, LDV>(vf, sVw, lane);
      }
    }
    const int m0 = row_lo + tile * BM;
    const T* sQs = sQ + stage * BM * LDK;
    const T* sdOs = sdO + stage * BM * LDV;
    const float* sLs = sL + stage * BM;
    const float* sDs = sD + stage * BM;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns q rows
    float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    if constexpr (G::kHoldA) {
      abt_bf16<DQK, BM, LDK>(s, kf, sQs, lane);
      abt_bf16<DV, BM, LDV>(dp, vf, sdOs, lane);
    } else {
      abt<DQK, BM, LDK>(s, sKw, sQs, lane);
      abt<DV, BM, LDV>(dp, sVw, sdOs, lane);
    }

    const int pos_first = m0 / grp;
    const int pos_last = (min(m0 + BM, row_hi) - 1) / grp;
    const bool mask =
        m0 + BM > row_hi || kv0 + BN > sk ||
        (causal && (kv0 + BN - 1 > pos_first + offset ||
                    (window > 0 && pos_last + offset - kv0 >= window)));
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);  // the tile's q row
        float p = exp2f(s[nt][e] * scale_log2 - sLs[c] * kLog2e);
        if (mask) {
          const int r = m0 + c;
          if (!(r < row_hi && visible(r / grp + offset, key0 + 8 * (e >> 1),
                                      sk, causal, window)))
            p = 0.f;
        }
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDs[c]);
      }

    pb_into<DV, BM, LDV>(acc_v, s, sdOs, lane);   // dV += P^T dO
    pb_into<DQK, BM, LDK>(acc_k, dp, sQs, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = key0 + 8 * hh;
    if (j >= sk) continue;
    const size_t row = (static_cast<size_t>(bb) * sk + j) * kvh + kh;
#pragma unroll
    for (int nt = 0; nt < DQK / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < d)
        store2(dk + row * d + c, acc_k[nt][2 * hh] * scale,
               acc_k[nt][2 * hh + 1] * scale);
    }
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < dv)
        store2(dvo + row * dv + c, acc_v[nt][2 * hh], acc_v[nt][2 * hh + 1]);
    }
  }
}

// dQ of 64 packed rows of one (batch, kv head), over the kv tiles they see.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads,
                                  (Geo<T, DQK, DV>::kMinBlocksQ))
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int sq, int sk, int h, int kvh, int d,
             int dv, int causal, int window, float scale) {
  using G = Geo<T, DQK, DV>;
  constexpr int BM = G::kRows, BN = G::kBN, LDK = G::kLdK, LDV = G::kLdV;
  constexpr int VEC = G::kVec, CPR = DQK / VEC;
  static_assert(DV <= DQK, "dO's and V's rows are copied in DQK's loop");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // BM x LDK
  T* sK = sQ + BM * LDK;                   // kStages x BN x LDK
  T* sdO = sK + kStages * BN * LDK;        // BM x LDV
  T* sV = sdO + BM * LDV;                  // kStages x BN x LDV

  const int grp = h / kvh, rows = sq * grp, offset = sk - sq;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest tiles first
  const int kh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  // kv positions any real row of this tile can see
  const int pos_first = m0 / grp;
  const int pos_last = (min(m0 + BM, rows) - 1) / grp;
  int kv_lo = 0, kv_hi = sk;
  if (causal) {
    kv_hi = min(sk, pos_last + offset + 1);
    if (window > 0) kv_lo = max(0, pos_first + offset - window + 1);
  }
  const int t_lo = kv_lo / BN;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN : t_lo;

  zero_cols<kThreads>(sQ, BM + kStages * BN, LDK, d, DQK);
  zero_cols<kThreads>(sdO, BM + kStages * BN, LDV, dv, DV);

  for (int idx = tid; idx < BM * CPR; idx += kThreads) {
    const int rr = idx / CPR, c = (idx % CPR) * VEC;
    const int r = m0 + rr;
    const bool ok = r < rows;
    const size_t row = packed_row(ok ? r : 0, grp, bb, sq, h, kh);
    if (c < d) cp_async16(sQ + rr * LDK + c, q + row * d + c, ok);
    if (c < dv) cp_async16(sdO + rr * LDV + c, dout + row * dv + c, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int tile, int stage) {
    T* dk_ = sK + stage * BN * LDK;
    T* dv_ = sV + stage * BN * LDV;
    for (int idx = tid; idx < BN * CPR; idx += kThreads) {
      const int rr = idx / CPR, c = (idx % CPR) * VEC;
      const int j = tile * BN + rr;
      const bool ok = j < sk;
      const size_t row =
          (static_cast<size_t>(bb) * sk + (ok ? j : 0)) * kvh + kh;
      if (c < d) cp_async16(dk_ + rr * LDK + c, k + row * d + c, ok);
      if (c < dv) cp_async16(dv_ + rr * LDV + c, v + row * dv + c, ok);
    }
  };
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();

  // this lane's rows r0, r0 + 8: lse in log2 units (+inf past the edge, so
  // P = 0 there), delta, and the query position
  const int r0 = m0 + warp * 16 + g;
  float l2[2], dl[2];
  int qp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    const bool ok = r < rows;
    const size_t row = packed_row(ok ? r : 0, grp, bb, sq, h, kh);
    l2[hh] = ok ? lse[row] * kLog2e : INFINITY;
    dl[hh] = ok ? delta[row] : 0.f;
    qp[hh] = r / grp + offset;
  }

  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  const T* sQw = sQ + warp * 16 * LDK;
  const T* sdOw = sdO + warp * 16 * LDV;
  uint32_t qf[G::kHoldA ? DQK / 16 : 1][4], dof[G::kHoldA ? DV / 16 : 1][4];
  if constexpr (G::kHoldA) {
    load_a_bf16<DQK, LDK>(qf, sQw, lane);
    load_a_bf16<DV, LDV>(dof, sdOw, lane);
  }

  float acc[DQK / 8][4];
#pragma unroll
  for (int nt = 0; nt < DQK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int stage = (tile - t_lo) & 1;
    if (tile + 1 < t_hi) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const T* sKs = sK + stage * BN * LDK;
    const T* sVs = sV + stage * BN * LDV;

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    if constexpr (G::kHoldA) {
      abt_bf16<DQK, BN, LDK>(s, qf, sKs, lane);   // S = Q K^T
      abt_bf16<DV, BN, LDV>(dp, dof, sVs, lane);  // dP = dO V^T
    } else {
      abt<DQK, BN, LDK>(s, sQw, sKs, lane);
      abt<DV, BN, LDV>(dp, sdOw, sVs, lane);
    }

    const int kv0 = tile * BN;
    const bool mask =
        kv0 + BN > sk ||
        (causal && (kv0 + BN - 1 > pos_first + offset ||
                    (window > 0 && pos_last + offset - kv0 >= window)));
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * scale_log2 - l2[e >> 1]);
        if (mask && !visible(qp[e >> 1], kv0 + nt * 8 + 2 * t + (e & 1), sk,
                             causal, window))
          p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
      }

    pb_into<DQK, BN, LDK>(acc, dp, sKs, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= rows) continue;
    const size_t row = packed_row(r, grp, bb, sq, h, kh);
#pragma unroll
    for (int nt = 0; nt < DQK / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < d)
        store2(dq + row * d + c, acc[nt][2 * hh] * scale,
               acc[nt][2 * hh + 1] * scale);
    }
  }
}

// The shared-memory opt-in of one kernel, once per device.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem,
                   std::once_flag (&once)[kMaxDevices],
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
  using G = Geo<T, DQK, DV>;
  auto kv_kernel = flash_bwd_dkdv<T, DQK, DV>;
  auto q_kernel = flash_bwd_dq<T, DQK, DV>;
  static std::once_flag kv_once[kMaxDevices], q_once[kMaxDevices];
  static cudaError_t kv_err[kMaxDevices], q_err[kMaxDevices];
  cudaError_t e = opt_in(kv_kernel, G::kSmemKV, kv_once, kv_err);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in(q_kernel, G::kSmemQ, q_once, q_err);
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long nrows = static_cast<long long>(b) * sq * h;
  const int rows_per_cta = kDeltaThreads / 32;
  flash_bwd_delta<T><<<static_cast<unsigned>((nrows + rows_per_cta - 1) /
                                              rows_per_cta),
                       kDeltaThreads, 0, stream>>>(o, dout, delta, nrows, dv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = sq * (h / kvh);
  q_kernel<<<dim3((rows + G::kRows - 1) / G::kRows, kvh, b), kThreads,
             G::kSmemQ, stream>>>(q, k, v, dout, lse, delta, dq, sq, sk, h,
                                  kvh, d, dv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (sk > 0)
    kv_kernel<<<dim3((sk + G::kKeys - 1) / G::kKeys, kvh, b), kThreads,
                G::kSmemKV, stream>>>(q, k, v, dout, lse, delta, dk, dvo, sq,
                                      sk, h, kvh, d, dv, causal, window,
                                      scale);
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
