// Backward of the fused selective scan (csrc/mamba_scan.cu).
//
// Replaces no Pallas kernel: the reference has no backward kernel for its
// scan. Off the TPU its gradient is autodiff of the associative scan in
// src/repro/kernels/ops.py:mamba_chunk (:101-115); the hybrid trains on
// the card only with a backward kernel beside the forward one. From the
// forward's inputs and the cotangents dy (B, L, D) and dh (B, D, N) of
// y and h_last it gives
//
//   g_t = dy_t C_t + a_{t+1} g_{t+1}       (g_L = dy_L C_L + dh)
//   dC_t = sum_d dy_t h_t                  dB_t = sum_d g_t (dt_t x_t)
//   ddt_t = (sum_n g_t B_t) x_t + sum_n g_t h_{t-1} a_t A
//   dx_t = (sum_n g_t B_t) dt_t            dA = sum_{b,t} g_t h_{t-1} a_t dt_t
//   dh0 = a_1 g_1
//
// with a_t = exp(dt_t A); the plain version is ref.mamba_scan_bwd_ref.
// Layouts as the forward's, all contiguous: dt, x, dy, ddt, dx (B, L, D) in
// T; b, c, db, dc (B, L, N) in T; a, da (D, N), h0, dh, dh0 (B, D, N) f32.
// N is 8, 16, 32 or 64; D and L are any. b, c, a, h0 and dh must be
// 16-byte aligned (the wrapper copies one that is not).
//
// What bounds it on the H100. Bytes: dt, x, dy read and ddt, dx written
// once, 5 B L D sizeof(T), with the small B, C, A and state terms, 88 MB at
// the hybrid's training chunk (B 1, L 256, D 16384, N 16, f32): 0.026 ms at
// 3.35 TB/s. Exponentials: B L D N = 67 M a_t, 0.016 ms on the
// special-function units at one each. Neither sets the time. Each step of
// a warp (four states of eight channels at N 16) reads or shuffles ~26
// shared-memory wavefronts in the walk (dt, x, dy, h_{t-1}, four B and
// four C a lane, nine shuffles, the sums' store), 10 in the replay and 6 in
// pass 1, and an SM's shared-memory pipe takes one a clock: ~170 K clocks
// an SM at the training chunk, most of the kernel's time on the card
// (PERF.md, PR 34); pass 1 runs at the special-function units' 8 clocks a
// warp's exponential. The design:
// - a channel's N states are split over G = N / 4 lanes, four states a
//   lane, so B 1 at D 16384 is 65,536 threads; a CTA holds 64 channels (32
//   at N 64): 128, 256, 512, 512 threads for N 8, 16, 32, 64, with the
//   registers capped at 128 a thread so an SM holds 16 warps (12 at N 8,
//   where shared memory allows 3 CTAs);
// - h_{t-1} is needed from the last step down, and running the recurrence
//   backwards, h_{t-1} = (h_t - u_t) / a_t, fails where a_t underflows.
//   So pass 1 runs the forward recurrence over all segments of K = 16
//   steps but the last and stores the state entering each (a checkpoint in
//   the workspace, B (L / K - 2) D N floats); pass 2 takes the segments
//   from the last down, replays each from its checkpoint, keeping every
//   a_t of the segment in registers and every h_t in shared memory, and
//   walks it back from its last step. Each a_t is made at most twice, in
//   pass 1 and in the replay: (L - K + L) / L a (b, t, d, n), 1.9375 at
//   L 256. Every exponential is the forward's ex2.approx.ftz of
//   dt * A log2(e), with A log2(e) made in one multiply, so a replayed h_t
//   is the h_t the forward carried, bit for bit. The last segment's rows
//   past L are zeros, steps that leave h and the carried gradient as they
//   are (the replay takes no exponential there), so the unrolled walk has
//   no guard but on its stores;
// - the segments go through a two-slot ring in shared memory, filled by
//   cp.async while the CTA works on the other slot: pass 1's dt, x, B, pass
//   2's dt, x, dy, B, C and checkpoint, 16 bytes a copy where a row is
//   16-byte aligned, else 4 (a bf16 pair whose address is not 4-byte
//   aligned is two plain loads); channels past D are zero-filled. A
//   segment's B and C are then spread, in f32, into four copies, one for
//   each order of a lane's states below, so a lane reads its four B (or
//   C) of a step in one 16-byte load;
// - ddt and dx: each lane sums its four states, the G lanes of a channel
//   add theirs by shuffles (the first stage leaves ddt on the lower half,
//   dx on the upper), one lane writes each;
// - dB and dC sum over d. Each step a lane holds 8 terms (dB and dC of its
//   four states), summed over the channels of the warp by a butterfly of
//   shuffles that halves them a stage. The states' order in a lane is
//   permuted by its lane bits (position i holds state 4j + (i ^ m)), so
//   the two stages that split the states take no select; the stage that
//   splits dB from dC takes two. The warps' sums go to shared memory (a
//   warp reuses its slice of the h_t row it has walked past) and are added
//   in warp order: one partial a CTA a step to the workspace. A second kernel, a CTA a row (b, t), adds the CTAs'
//   partials, each thread a strided run, then a tree over the threads.
//   dA sums over B: each lane keeps its four sums over t in registers and
//   writes them as batch row b's partial (at B 1 dA itself), summed in
//   batch order by a third kernel. No atomics, so two calls give equal
//   bits.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kSeg = 16;              // K: steps of a segment
constexpr int kQ = 4;                 // states a lane
constexpr int kReduceThreads = 256;
constexpr int kSumThreads = 512;    // the dB/dC reduce: a row a CTA
constexpr float kLog2e = 1.4426950408889634f;

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

template <int N>
struct BwdShape {
  static constexpr int kG = N / kQ;                         // lanes a channel
  static constexpr int kW = 32 / kG;                        // channels a warp
  static constexpr int kThreads = N <= 16 ? 16 * N : 512;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kChannels = kThreads / kG;           // a CTA: 64 or 32
  static constexpr int kMinBlocks = 512 / kThreads;         // 128 registers
  static constexpr int kVals = 2 * N;                       // dB, dC a step
  // the butterfly over the warp's channels: stages (lane offsets 16 down
  // to G), the first (up to) two of them split the states
  static constexpr int kFly = log2i(kW);
  static constexpr int kStateStages = kFly < 2 ? kFly : 2;
  static constexpr int kKeep = 8 >> kStateStages;  // terms a lane has left
};

template <typename T, int N>
struct __align__(16) BwdSlot {
  static constexpr int kC = BwdShape<N>::kChannels;
  T dt[kSeg][kC];
  T x[kSeg][kC];
  T dy[kSeg][kC];
  T b[kSeg][N];
  T c[kSeg][N];
  float4 ck[BwdShape<N>::kThreads];   // the segment's entering state
};

template <typename T, int N>
struct BwdSmem {
  BwdSlot<T, N> slot[2];
  float4 h[kSeg][BwdShape<N>::kThreads];   // h_t of each step, by lane
  // the segment's B and C in f32, four copies: copy m holds element
  // n ^ m at n, the order of a lane whose m it is
  float bc[2][4][kSeg][N];
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// asynchronous copies to shared memory; src_bytes < size zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v[i] <- v[i ^ m] for m in 0..3: natural order <-> a lane's order
__device__ __forceinline__ void permute4(float (&v)[4], int m) {
  const bool s1 = m & 1, s2 = m & 2;
  float t0 = s1 ? v[1] : v[0], t1 = s1 ? v[0] : v[1];
  float t2 = s1 ? v[3] : v[2], t3 = s1 ? v[2] : v[3];
  v[0] = s2 ? t2 : t0; v[2] = s2 ? t0 : t2;
  v[1] = s2 ? t3 : t1; v[3] = s2 ? t1 : t3;
}

// rows [0, kSeg) of a (rows, d_model) array, channels d0 .. d0 + C - 1
// (`live` of them in D), from `src` = its element (row0, d0) into
// dst[k][0 .. C): rows past `steps` and channels past `live` zeroed. With
// `vec` (rows 16-byte aligned) each thread takes a fixed set of 16-byte
// chunks; else 4-byte copies spread over the CTA.
template <typename T, int C, int TH>
__device__ __forceinline__ void stage_rows(T (*dst)[C], const T* src,
                                           int steps, int d_model, int live,
                                           bool vec) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    constexpr int kPerRow = C / kV, kTotal = kSeg * kPerRow;
#pragma unroll
    for (int it = 0; it < (kTotal + TH - 1) / TH; ++it) {
      const int c = static_cast<int>(threadIdx.x) + it * TH;
      if (kTotal % TH != 0 && c >= kTotal) break;
      const int k = c / kPerRow, e = (c % kPerRow) * kV;
      const bool ok = k < steps && e < live;
      cp_async16(&dst[k][e], ok ? src + k * d_model + e : src,
                 ok ? min(kV, live - e) * static_cast<int>(sizeof(T)) : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < kSeg * C / (4 / sizeof(T)); i += TH) {
    if (sizeof(T) == 4) {
      const int k = i / C, e = i % C;
      const bool ok = k < steps && e < live;
      cp_async4(&dst[k][e], ok ? src + k * d_model + e : src, ok ? 4 : 0);
    } else {
      // bf16 pairs: one 4-byte copy where the pair's address is 4-byte
      // aligned, else two plain loads
      const int k = i / (C / 2), e = (i % (C / 2)) * 2;
      const T* p = src + k * d_model + e;
      const int valid = k < steps ? max(0, min(2, live - e)) : 0;
      const T zero = repro::from_float<T>(0.f);
      if (valid > 0 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
        cp_async4(&dst[k][e], p, valid * 2);
      } else {
        dst[k][e] = valid > 0 ? p[0] : zero;
        dst[k][e + 1] = valid > 1 ? p[1] : zero;
      }
    }
  }
}

// kSeg N contiguous elements (`valid` of them read, the rest zeroed)
template <typename T, int N, int TH>
__device__ __forceinline__ void stage_flat(T* dst, const T* src,
                                           int valid) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  constexpr int kTotal = kSeg * N / kV;
#pragma unroll
  for (int it = 0; it < (kTotal + TH - 1) / TH; ++it) {
    const int c = static_cast<int>(threadIdx.x) + it * TH;
    if (kTotal % TH != 0 && c >= kTotal) break;
    const int bytes = max(0, min(kV, valid - c * kV)) *
                      static_cast<int>(sizeof(T));
    cp_async16(dst + c * kV, bytes ? src + c * kV : src, bytes);
  }
}

// one of the segment's B or C (`src`, kSeg x N) into its four f32 copies
// `dst`; rows past `steps` zeroed
template <typename T, int N, int TH>
__device__ __forceinline__ void spread(float (*dst)[kSeg][N], const T* src,
                                       int steps) {
  constexpr int Q = N / 4, kTotal = 4 * kSeg * Q;
#pragma unroll
  for (int it = 0; it < (kTotal + TH - 1) / TH; ++it) {
    const int e = static_cast<int>(threadIdx.x) + it * TH;
    if (kTotal % TH != 0 && e >= kTotal) break;
    const int qd = e % Q, k = (e / Q) % kSeg, mm = e / (Q * kSeg);
    const T* row = src + k * N + 4 * qd;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < steps) {
      v.x = repro::to_float(row[mm]);
      v.y = repro::to_float(row[1 ^ mm]);
      v.z = repro::to_float(row[2 ^ mm]);
      v.w = repro::to_float(row[3 ^ mm]);
    }
    *reinterpret_cast<float4*>(&dst[mm][k][4 * qd]) = v;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(BwdShape<N>::kThreads,
                                  BwdShape<N>::kMinBlocks)
mamba_scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ h0,
                      const T* __restrict__ dy, const float* __restrict__ dh,
                      T* __restrict__ ddt, T* __restrict__ dx,
                      float* __restrict__ dh0, float4* __restrict__ ckpt,
                      float* __restrict__ part_bc,
                      float* __restrict__ part_da, int len, int d_model,
                      bool vec) {
  using S = BwdShape<N>;
  constexpr int K = kSeg;
  constexpr int G = S::kG;
  constexpr int C = S::kChannels;
  constexpr int V = S::kVals;
  constexpr int TH = S::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<T, N>& sm = *reinterpret_cast<BwdSmem<T, N>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = lane % G;                       // states 4j .. 4j + 3
  const int cl = warp * S::kW + lane / G;       // channel in the CTA
  const int bb = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int d = d0 + cl;
  const bool live = d < d_model;
  const int live_ch = min(C, d_model - d0);
  // position i of a lane holds state 4j + (i ^ m), m from the lane bits
  // of the butterfly's state stages (offsets 16 and 8)
  const int m = (S::kStateStages >= 1 ? ((lane >> 4) & 1) << 1 : 0) |
                (S::kStateStages >= 2 ? (lane >> 3) & 1 : 0);
  const int ob = 4 * j + m;   // state of position i: ob ^ i
  const float* bq = &sm.bc[0][m][0][4 * j];    // B of position i, step k:
  const float* cq = &sm.bc[1][m][0][4 * j];    // bq[k N + i]; C likewise
  // where this lane leaves its dB / dC sums in a walked h_t row
  const int sb_at = warp * 32 * 4 + ob +
                    (S::kFly >= 3 ? ((lane >> 2) & 1) * N : 0);
  const size_t row = static_cast<size_t>(bb) * len;          // (b, t = 0)
  const size_t ch = (static_cast<size_t>(bb) * d_model + d) * N + 4 * j;
  const int segs = (len + K - 1) / K;
  const int jobs = 2 * segs - 1;   // pass 1: segs - 1, pass 2: segs
  const float4* ck_in = reinterpret_cast<const float4*>(h0);
  // the checkpoint of segment s (1 .. segs - 2), this lane's four states
  auto ck_at = [&](int s) -> float4* {
    return ckpt + ((static_cast<size_t>(bb) * (segs - 2) + s - 1) *
                   gridDim.x + blockIdx.x) * TH + tid;
  };

  // job q into slot q & 1: pass 1's segment q (dt, x, B), or pass 2's
  // segment 2 segs - 2 - q (also dy, C and the entering state)
  auto issue = [&](int q) {
    BwdSlot<T, N>& sl = sm.slot[q & 1];
    const bool fwd = q < segs - 1;
    const int s = fwd ? q : 2 * segs - 2 - q;
    const int steps = min(K, len - s * K);
    const size_t r0 = row + static_cast<size_t>(s) * K;
    const size_t at = r0 * d_model + d0;
    stage_rows<T, C, TH>(sl.dt, dt + at, steps, d_model, live_ch, vec);
    stage_rows<T, C, TH>(sl.x, x + at, steps, d_model, live_ch, vec);
    stage_flat<T, N, TH>(&sl.b[0][0], bm + r0 * N, steps * N);
    if (fwd) return;
    stage_rows<T, C, TH>(sl.dy, dy + at, steps, d_model, live_ch, vec);
    stage_flat<T, N, TH>(&sl.c[0][0], cm + r0 * N, steps * N);
    if (s == 0)
      cp_async16(&sl.ck[tid], live ? h0 + ch : h0, live ? 16 : 0);
    else if (s < segs - 1)
      cp_async16(&sl.ck[tid], ck_at(s), 16);
  };

  float av[kQ], a2[kQ], h[kQ], r[kQ], da[kQ];
  {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 va = live ? *reinterpret_cast<const float4*>(
                                 a + static_cast<size_t>(d) * N + 4 * j)
                           : z;
    const float4 vh = live ? ck_in[ch / 4] : z;
    const float4 vr = live ? reinterpret_cast<const float4*>(dh)[ch / 4] : z;
    av[0] = va.x; av[1] = va.y; av[2] = va.z; av[3] = va.w;
    h[0] = vh.x; h[1] = vh.y; h[2] = vh.z; h[3] = vh.w;
    r[0] = vr.x; r[1] = vr.y; r[2] = vr.z; r[3] = vr.w;
    permute4(av, m);
    permute4(h, m);
    permute4(r, m);
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      a2[i] = av[i] * kLog2e;
      da[i] = 0.f;
    }
  }

  issue(0);
  cp_async_commit();
  for (int q = 0; q < jobs; ++q) {
    cp_async_wait_all();
    __syncthreads();   // job q has landed; every thread is done with q - 1
    BwdSlot<T, N>& sl = sm.slot[q & 1];
    const bool fwd = q < segs - 1;
    const int s = fwd ? q : 2 * segs - 2 - q;
    const int t0 = s * K;
    const int steps = min(K, len - t0);
    spread<T, N, TH>(sm.bc[0], &sl.b[0][0], steps);
    if (!fwd) spread<T, N, TH>(sm.bc[1], &sl.c[0][0], steps);
    if (q + 1 < jobs) issue(q + 1);   // in flight while q is worked
    cp_async_commit();
    __syncthreads();   // B and C spread

    if (fwd) {
      // pass 1: segment q forwards; its end state enters segment q + 1
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float dtv = repro::to_float(sl.dt[k][cl]);
        const float bx = dtv * repro::to_float(sl.x[k][cl]);
        const float4 b4 = *reinterpret_cast<const float4*>(bq + k * N);
        const float bv[kQ] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const float ab = ex2(dtv * a2[i]);
          h[i] = fmaf(ab, h[i], bx * bv[i]);
        }
      }
      if (q + 1 < segs - 1)
        *ck_at(q + 1) = make_float4(h[0], h[1], h[2], h[3]);
      continue;
    }

    // pass 2: segment s replayed from its entering state, then walked back
    // from its last step (rows past L are zeros: steps that leave h and
    // the carried gradient as they are)
    if (s == segs - 1 && s > 0) {
      sl.ck[tid] = make_float4(h[0], h[1], h[2], h[3]);
    } else if (s == 0) {
      const float4 e = sl.ck[tid];
      float v[kQ] = {e.x, e.y, e.z, e.w};
      permute4(v, m);
      sl.ck[tid] = make_float4(v[0], v[1], v[2], v[3]);
    }
    float ab[K][kQ];
    {
      const float4 e = sl.ck[tid];
      h[0] = e.x; h[1] = e.y; h[2] = e.z; h[3] = e.w;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dtv = repro::to_float(sl.dt[k][cl]);
      const float bx = dtv * repro::to_float(sl.x[k][cl]);
      const float4 b4 = *reinterpret_cast<const float4*>(bq + k * N);
      const float bv[kQ] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        ab[k][i] = k < steps ? ex2(dtv * a2[i]) : 1.f;
        h[i] = fmaf(ab[k][i], h[i], bx * bv[i]);
      }
      if (k < K - 1) sm.h[k][tid] = make_float4(h[0], h[1], h[2], h[3]);
    }
    // ddt on the group's lower half, dx on its upper: one lane of each
    // writes, walking its column up from the segment's last row
    const bool up = (lane & (G / 2)) != 0;
    const bool writer = live && (j & (G / 2 - 1)) == 0;
    T* out = (up ? dx : ddt) + (row + t0 + K - 1) * d_model + d;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      {
        const float4 e = k > 0 ? sm.h[k - 1][tid] : sl.ck[tid];
        const float hp[kQ] = {e.x, e.y, e.z, e.w};   // h_{t-1}
        const float dtv = repro::to_float(sl.dt[k][cl]);
        const float xv = repro::to_float(sl.x[k][cl]);
        const float dyv = repro::to_float(sl.dy[k][cl]);
        const float bx = dtv * xv;
        const float4 b4 = *reinterpret_cast<const float4*>(bq + k * N);
        const float4 c4 = *reinterpret_cast<const float4*>(cq + k * N);
        const float bv[kQ] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[kQ] = {c4.x, c4.y, c4.z, c4.w};
        float v[2 * kQ];
        float dbx = 0.f, dsum = 0.f;
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const float g = fmaf(dyv, cv[i], r[i]);
          v[2 * i] = g * bx;             // dB_t, this channel's term
          v[2 * i + 1] = dyv * h[i];     // dC_t, this channel's term
          dbx = fmaf(g, bv[i], dbx);
          r[i] = ab[k][i] * g;
          const float ga = r[i] * hp[i];
          dsum = fmaf(ga, av[i], dsum);
          da[i] = fmaf(ga, dtv, da[i]);
          h[i] = hp[i];
        }
        {
          const float p0 = fmaf(dbx, xv, dsum), p1 = dbx * dtv;
          float acc = (up ? p1 : p0) +
                      __shfl_xor_sync(0xffffffffu, up ? p0 : p1, G / 2);
#pragma unroll
          for (int o = G / 4; o > 0; o /= 2)
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
          if (writer && k < steps) *out = repro::from_float<T>(acc);
          out -= d_model;
        }
        // dB and dC over the warp's channels
        if constexpr (S::kStateStages >= 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] += __shfl_xor_sync(0xffffffffu, v[i + 4], 16);
        }
        if constexpr (S::kStateStages >= 2) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            v[i] += __shfl_xor_sync(0xffffffffu, v[i + 2], 8);
        }
        if constexpr (S::kFly >= 3) {
          const bool up = (lane & 4) != 0;
          v[0] = (up ? v[1] : v[0]) +
                 __shfl_xor_sync(0xffffffffu, up ? v[0] : v[1], 4);
        }
        if constexpr (S::kFly >= 4)
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
        __syncwarp();   // the warp is past its reads of h row k
        float* sb = reinterpret_cast<float*>(&sm.h[k][0]) + sb_at;
        if constexpr (S::kFly >= 3) {
          if (S::kFly == 3 || (lane & 2) == 0) sb[0] = v[0];
        } else {
#pragma unroll
          for (int e = 0; e < S::kKeep; ++e)
            sb[(e & 1) * N + ((ob ^ (e >> 1)) - ob)] = v[e];
        }
      }
    }
    __syncthreads();   // every warp's sums of the segment are in
    for (int i = tid; i < steps * V; i += TH) {
      const int k = i / V, vi = i % V;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < S::kWarps; ++w)
        acc += reinterpret_cast<const float*>(&sm.h[k][w * 32])[vi];
      part_bc[((row + t0 + k) * gridDim.x + blockIdx.x) * V + vi] = acc;
    }
  }
  cp_async_wait_all();

  if (live) {
    permute4(r, m);
    permute4(da, m);
    reinterpret_cast<float4*>(dh0)[ch / 4] = make_float4(r[0], r[1], r[2],
                                                         r[3]);
    reinterpret_cast<float4*>(part_da)[ch / 4] =
        make_float4(da[0], da[1], da[2], da[3]);
  }
}

// dB and dC of row (b, t): the CTAs' partials, each thread a strided run
// of them in order, then a tree over the runs
template <typename T, int N>
__global__ void __launch_bounds__(kSumThreads)
mamba_scan_bwd_bc(const float* __restrict__ part, T* __restrict__ db,
                  T* __restrict__ dc, int parts) {
  constexpr int V = 2 * N;
  constexpr int R = kSumThreads / V;   // runs
  __shared__ float acc[R][V];
  const long long rw = blockIdx.x;
  const int v = threadIdx.x % V, q = threadIdx.x / V;
  const float* p = part + rw * parts * V + v;
  float s = 0.f;
#pragma unroll 4
  for (int i = q; i < parts; i += R) s += p[static_cast<size_t>(i) * V];
  acc[q][v] = s;
  __syncthreads();
#pragma unroll
  for (int w = R / 2; w > 0; w /= 2) {
    if (q < w) acc[q][v] += acc[q + w][v];
    __syncthreads();
  }
  if (q == 0) {
    if (v < N)
      db[rw * N + v] = repro::from_float<T>(acc[0][v]);
    else
      dc[rw * N + v - N] = repro::from_float<T>(acc[0][v]);
  }
}

// dA: the batch rows' partials summed in batch order
__global__ void __launch_bounds__(kReduceThreads)
mamba_scan_bwd_da(const float* __restrict__ part, float* __restrict__ da,
                  int batch, long long dn) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= dn) return;
  float s = 0.f;
  for (int b = 0; b < batch; ++b) s += part[b * dn + i];
  da[i] = s;
}

// floats of the workspace: checkpoints, dB/dC partials, dA partials
template <int N>
void workspace(int batch, int len, int d_model, long long* ckpt,
               long long* bc, long long* parts_da) {
  using S = BwdShape<N>;
  const long long ctas = (d_model + S::kChannels - 1) / S::kChannels;
  const long long segs = (len + kSeg - 1) / kSeg;
  *ckpt = static_cast<long long>(batch) * (segs > 2 ? segs - 2 : 0) * ctas *
          S::kThreads * kQ;
  *bc = static_cast<long long>(batch) * len * ctas * S::kVals;
  *parts_da = batch > 1 ? static_cast<long long>(batch) * d_model * N : 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int N>
int launch_n(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a, const void* h0, const void* dy, const void* dh,
             void* ddt, void* dx, void* db, void* dc, void* da, void* dh0,
             void* work, int batch, int len, int d_model,
             cudaStream_t stream) {
  using S = BwdShape<N>;
  if (!aligned16(bm) || !aligned16(cm) || !aligned16(a) || !aligned16(h0) ||
      !aligned16(dh) || !aligned16(da) || !aligned16(dh0) ||
      !aligned16(work))
    return static_cast<int>(cudaErrorMisalignedAddress);
  long long n_ckpt, n_bc, n_da;
  workspace<N>(batch, len, d_model, &n_ckpt, &n_bc, &n_da);
  float* ckpt = static_cast<float*>(work);
  float* part_bc = ckpt + n_ckpt;
  float* part_da = batch > 1 ? part_bc + n_bc : static_cast<float*>(da);
  const size_t smem = sizeof(BwdSmem<T, N>);
  cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<T, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = (static_cast<size_t>(d_model) * sizeof(T)) % 16 == 0 &&
                   aligned16(dt) && aligned16(x) && aligned16(dy);
  const int ctas = (d_model + S::kChannels - 1) / S::kChannels;
  mamba_scan_bwd_kernel<T, N><<<dim3(ctas, batch), S::kThreads, smem,
                                 stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const T*>(dy), static_cast<const float*>(dh),
      static_cast<T*>(ddt), static_cast<T*>(dx), static_cast<float*>(dh0),
      reinterpret_cast<float4*>(ckpt), part_bc, part_da, len, d_model, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(batch) * len;
  mamba_scan_bwd_bc<T, N><<<static_cast<unsigned>(rows), kSumThreads, 0,
                            stream>>>(part_bc, static_cast<T*>(db),
                                      static_cast<T*>(dc), ctas);
  e = cudaGetLastError();
  if (e != cudaSuccess || batch == 1) return static_cast<int>(e);
  const long long dn = static_cast<long long>(d_model) * N;
  mamba_scan_bwd_da<<<static_cast<unsigned>(
      (dn + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
      stream>>>(part_da, static_cast<float*>(da), batch, dn);
  return static_cast<int>(cudaGetLastError());
}

// the main kernel's grid and how many of its CTAs one SM holds at once
template <typename T, int N>
int plan_n(int batch, int d_model, int* grid, int* ctas_per_sm) {
  using S = BwdShape<N>;
  const size_t smem = sizeof(BwdSmem<T, N>);
  *grid = (d_model + S::kChannels - 1) / S::kChannels * batch;
  cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<T, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, mamba_scan_bwd_kernel<T, N>, S::kThreads, smem));
}

template <typename T>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, const void* h0, const void* dy, const void* dh,
           void* ddt, void* dx, void* db, void* dc, void* da, void* dh0,
           void* work, int batch, int len, int d_model, int n,
           cudaStream_t stream) {
  // d_model < 2^27: a segment's row offsets k d_model fit an int
  if (batch <= 0 || d_model <= 0 || len <= 0 || batch > 65535 ||
      d_model >= (1 << 27))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 8: return launch_n<T, 8>(dt, x, bm, cm, a, h0, dy, dh, ddt, dx, db,
                                  dc, da, dh0, work, batch, len, d_model,
                                  stream);
    case 16: return launch_n<T, 16>(dt, x, bm, cm, a, h0, dy, dh, ddt, dx,
                                    db, dc, da, dh0, work, batch, len,
                                    d_model, stream);
    case 32: return launch_n<T, 32>(dt, x, bm, cm, a, h0, dy, dh, ddt, dx,
                                    db, dc, da, dh0, work, batch, len,
                                    d_model, stream);
    case 64: return launch_n<T, 64>(dt, x, bm, cm, a, h0, dy, dh, ddt, dx,
                                    db, dc, da, dh0, work, batch, len,
                                    d_model, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int plan(int batch, int d_model, int n, int* grid, int* ctas_per_sm) {
  switch (n) {
    case 8: return plan_n<T, 8>(batch, d_model, grid, ctas_per_sm);
    case 16: return plan_n<T, 16>(batch, d_model, grid, ctas_per_sm);
    case 32: return plan_n<T, 32>(batch, d_model, grid, ctas_per_sm);
    case 64: return plan_n<T, 64>(batch, d_model, grid, ctas_per_sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// floats of the workspace mamba_scan_bwd takes for these sizes
extern "C" int mamba_scan_bwd_workspace(int batch, int len, int d_model,
                                        int n, long long* floats) {
  long long c = 0, b = 0, a = 0;
  switch (n) {
    case 8: workspace<8>(batch, len, d_model, &c, &b, &a); break;
    case 16: workspace<16>(batch, len, d_model, &c, &b, &a); break;
    case 32: workspace<32>(batch, len, d_model, &c, &b, &a); break;
    case 64: workspace<64>(batch, len, d_model, &c, &b, &a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  *floats = c + b + a;
  return 0;
}

// dtype of dt, x, b, c, dy and their gradients: 0 = float32, 1 = bfloat16
extern "C" int mamba_scan_bwd(const void* dt, const void* x, const void* bm,
                              const void* cm, const void* a, const void* h0,
                              const void* dy, const void* dh, void* ddt,
                              void* dx, void* db, void* dc, void* da,
                              void* dh0, void* work, int dtype, int batch,
                              int len, int d_model, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dt, x, bm, cm, a, h0, dy, dh, ddt, dx, db, dc, da,
                         dh0, work, batch, len, d_model, n, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dt, x, bm, cm, a, h0, dy, dh, ddt, dx, db,
                                 dc, da, dh0, work, batch, len, d_model, n,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the grid of mamba_scan_bwd's main kernel for these sizes and how many of
// its CTAs one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int mamba_scan_bwd_plan(int dtype, int batch, int len,
                                   int d_model, int n, int* grid,
                                   int* ctas_per_sm) {
  (void)len;
  if (dtype == 0) return plan<float>(batch, d_model, n, grid, ctas_per_sm);
  if (dtype == 1)
    return plan<__nv_bfloat16>(batch, d_model, n, grid, ctas_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
