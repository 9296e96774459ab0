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
// N is 8, 16, 32 or 64; D and L are any.
//
// What bounds it on the H100. Bytes: dt, x, dy read and ddt, dx written
// once, 5 B L D sizeof(T), with the small B, C, A and state terms, 88 MB at
// the hybrid's training chunk (B 1, L 256, D 16384, N 16, f32): 0.026 ms at
// 3.35 TB/s. Exponentials: the backward needs a_t for every (b, t, d, n),
// B L D N = 67 M of them, 0.016 ms on the special-function units. So it is
// bound by bytes. The design is the simple one: one thread a (b, d)
// channel, as the forward, so at B 1 the card holds only D threads, a few
// warps an SM, and the kernel is bound by the latency of each thread's
// sequential chain, not by the bytes or the exponentials:
// - h_{t-1} is needed from the last step down. Running the recurrence
//   backwards, h_{t-1} = (h_t - u_t) / a_t, fails where a_t underflows, so
//   the states are rebuilt forwards: a first pass over L stores the state
//   entering every segment of K = 256 / N steps (a checkpoint in the
//   workspace, B L / K D N floats); the reverse pass replays each segment
//   from its checkpoint into shared memory (K N states a thread, 64 KB a
//   CTA of 64 channels) and walks it from its last step down;
// - every exponential is the forward's ex2.approx.ftz of dt * A log2(e),
//   with A log2(e) made in one multiply, so the replayed h_t is the h_t the
//   forward carried, bit for bit;
// - a segment's dt, x, dy, B and C are staged in shared memory by the CTA
//   before it is walked, so no step waits on device memory;
// - ddt and dx sum over N inside the thread that owns the channel. dB and
//   dC sum over D, across threads and CTAs: each step the 2N values of a
//   warp are summed by a butterfly of shuffles that leaves each lane one
//   (or more) of the sums, written as the warp's partial; a second kernel
//   sums the partials of the D / 32 warps in warp order. dA sums over B:
//   each thread keeps its channel's N sums over t in registers and writes
//   them as batch row b's partial, summed in batch order by a third kernel.
//   No atomics, so two calls give equal bits.
// A wave of several channels a thread and a cp.async ring are later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;          // channels of a CTA, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kStates = 256;          // K N: a thread's states of a segment
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct BwdShape {
  static constexpr int kSeg = kStates / N;  // K: 32, 16, 8 or 4 steps
  static constexpr int kVals = 2 * N;       // dB and dC of a step
};

template <typename T, int N>
struct BwdSmem {
  float h[BwdShape<N>::kSeg][N][kThreads];  // h_{t-1} of each step
  T dt[BwdShape<N>::kSeg][kThreads];
  T x[BwdShape<N>::kSeg][kThreads];
  T dy[BwdShape<N>::kSeg][kThreads];
  T b[BwdShape<N>::kSeg][N];
  T c[BwdShape<N>::kSeg][N];
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Sum M values a lane over the lanes of a warp, scattered: at each stage
// (lane offset O) a lane keeps one half of its values and adds its
// partner's copy of that half. After the stages for O = 16 .. 1, lane l
// holds in v[0 .. M/32 - 1] the sums of values l M/32 + j (M >= 32); with
// M = 16 the stages stop at O = 2 and lane l holds value l / 2, summed over
// the 16 lanes that share bit 0 of l.
template <int M, int O, int V>
__device__ __forceinline__ void butterfly(float (&v)[V], int lane) {
  if constexpr (M > 1 && O > 0) {
    constexpr int H = M / 2;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    butterfly<H, O / 2>(v, lane);
  }
}

// a segment of `steps` steps from row `row0` = (b, t0) into shared memory:
// each thread its own channel's dt, x (and dy), the CTA B (and C)
template <typename T, int N>
__device__ __forceinline__ void stage(BwdSmem<T, N>& sm, const T* dt,
                                      const T* x, const T* dy, const T* bm,
                                      const T* cm, size_t row0, int steps,
                                      int d, bool live, int d_model,
                                      bool reverse) {
  const int tid = threadIdx.x;
  const T zero = repro::from_float<T>(0.f);
  for (int k = 0; k < steps; ++k) {
    const size_t off = (row0 + k) * d_model + d;
    sm.dt[k][tid] = live ? dt[off] : zero;
    sm.x[k][tid] = live ? x[off] : zero;
    if (reverse) sm.dy[k][tid] = live ? dy[off] : zero;
  }
  for (int i = tid; i < steps * N; i += kThreads) {
    const int k = i / N, n = i % N;
    sm.b[k][n] = bm[(row0 + k) * N + n];
    if (reverse) sm.c[k][n] = cm[(row0 + k) * N + n];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ h0,
                      const T* __restrict__ dy, const float* __restrict__ dh,
                      T* __restrict__ ddt, T* __restrict__ dx,
                      float* __restrict__ dh0, float* __restrict__ ckpt,
                      float* __restrict__ part_bc,
                      float* __restrict__ part_da, int len, int d_model) {
  using S = BwdShape<N>;
  constexpr int K = S::kSeg;
  constexpr int V = S::kVals;
  constexpr int R = V >= 32 ? V / 32 : 1;   // sums a lane writes a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<T, N>& sm = *reinterpret_cast<BwdSmem<T, N>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bb = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < d_model;
  const int warps = gridDim.x * kWarps;
  const int w = blockIdx.x * kWarps + tid / 32;
  const size_t row = static_cast<size_t>(bb) * len;        // (b, t = 0)
  const size_t ch = (static_cast<size_t>(bb) * d_model + d) * N;
  const int segs = (len + K - 1) / K;

  float av[N], a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[static_cast<size_t>(d) * N + n] : 0.f;
    a2[n] = av[n] * kLog2e;
    h[n] = live ? h0[ch + n] : 0.f;
  }

  // pass 1: the state entering each segment, into the workspace
  for (int s = 0; s < segs; ++s) {
    if (live) {
      float* cp = ckpt + ((static_cast<size_t>(bb) * segs + s) * d_model +
                          d) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) cp[n] = h[n];
    }
    if (s + 1 == segs) break;
    stage(sm, dt, x, dy, bm, cm, row + s * K, K, d, live, d_model, false);
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const float dtv = repro::to_float(sm.dt[k][tid]);
      const float bx = dtv * repro::to_float(sm.x[k][tid]);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float a_bar = ex2(dtv * a2[n]);
        h[n] = fmaf(a_bar, h[n], bx * repro::to_float(sm.b[k][n]));
      }
    }
    __syncthreads();
  }

  // pass 2: each segment replayed from its checkpoint, then walked back
  float r[N], da[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    r[n] = live ? dh[ch + n] : 0.f;
    da[n] = 0.f;
  }
  for (int s = segs - 1; s >= 0; --s) {
    const int t0 = s * K;
    const int steps = min(K, len - t0);
    stage(sm, dt, x, dy, bm, cm, row + t0, steps, d, live, d_model, true);
    if (live) {
      const float* cp = ckpt + ((static_cast<size_t>(bb) * segs + s) *
                                d_model + d) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = cp[n];
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < steps; ++k) {
      const float dtv = repro::to_float(sm.dt[k][tid]);
      const float bx = dtv * repro::to_float(sm.x[k][tid]);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        sm.h[k][n][tid] = h[n];
        const float a_bar = ex2(dtv * a2[n]);
        h[n] = fmaf(a_bar, h[n], bx * repro::to_float(sm.b[k][n]));
      }
    }
#pragma unroll 1
    for (int k = steps - 1; k >= 0; --k) {
      const float dtv = repro::to_float(sm.dt[k][tid]);
      const float xv = repro::to_float(sm.x[k][tid]);
      const float dyv = repro::to_float(sm.dy[k][tid]);
      const float bx = dtv * xv;
      float vals[V];
      float dbx = 0.f, dsum = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float hp = sm.h[k][n][tid];
        const float a_bar = ex2(dtv * a2[n]);
        const float bv = repro::to_float(sm.b[k][n]);
        const float ht = fmaf(a_bar, hp, bx * bv);
        const float g = fmaf(dyv, repro::to_float(sm.c[k][n]), r[n]);
        vals[n] = g * bx;              // dB_t, this channel's term
        vals[N + n] = dyv * ht;        // dC_t, this channel's term
        dbx = fmaf(g, bv, dbx);
        const float ga = g * hp * a_bar;
        dsum = fmaf(ga, av[n], dsum);
        da[n] = fmaf(ga, dtv, da[n]);
        r[n] = a_bar * g;
      }
      const size_t t_row = row + t0 + k;
      if (live) {
        ddt[t_row * d_model + d] = repro::from_float<T>(fmaf(dbx, xv, dsum));
        dx[t_row * d_model + d] = repro::from_float<T>(dbx * dtv);
      }
      butterfly<V, 16>(vals, lane);
      float* pp = part_bc + (t_row * warps + w) * V;
      if constexpr (V < 32) {
        // the 16 lanes that share bit 0 summed so far: add the other half
        vals[0] += __shfl_xor_sync(0xffffffffu, vals[0], 1);
        if ((lane & 1) == 0) pp[lane >> 1] = vals[0];
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) pp[lane * R + j] = vals[j];
      }
    }
    __syncthreads();   // the segment's B and C read before the next stage
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dh0[ch + n] = r[n];
      part_da[ch + n] = da[n];
    }
  }
}

// dB and dC of row (b, t): the warps' partials summed in warp order
template <typename T, int N>
__global__ void __launch_bounds__(kReduceThreads)
mamba_scan_bwd_bc(const float* __restrict__ part, T* __restrict__ db,
                  T* __restrict__ dc, long long rows, int warps) {
  constexpr int V = 2 * N;
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= rows * V) return;
  const long long r = i / V;
  const int v = static_cast<int>(i % V);
  const float* p = part + r * warps * V + v;
  float s = 0.f;
#pragma unroll 8
  for (int w = 0; w < warps; ++w) s += p[static_cast<size_t>(w) * V];
  if (v < N)
    db[r * N + v] = repro::from_float<T>(s);
  else
    dc[r * N + v - N] = repro::from_float<T>(s);
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
  constexpr int K = BwdShape<N>::kSeg;
  const long long ctas = (d_model + kThreads - 1) / kThreads;
  const long long segs = (len + K - 1) / K;
  *ckpt = static_cast<long long>(batch) * segs * d_model * N;
  *bc = static_cast<long long>(batch) * len * ctas * kWarps * 2 * N;
  *parts_da = static_cast<long long>(batch) * d_model * N;
}

template <typename T, int N>
int launch_n(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a, const void* h0, const void* dy, const void* dh,
             void* ddt, void* dx, void* db, void* dc, void* da, void* dh0,
             void* work, int batch, int len, int d_model,
             cudaStream_t stream) {
  long long n_ckpt, n_bc, n_da;
  workspace<N>(batch, len, d_model, &n_ckpt, &n_bc, &n_da);
  float* ckpt = static_cast<float*>(work);
  float* part_bc = ckpt + n_ckpt;
  float* part_da = part_bc + n_bc;
  const size_t smem = sizeof(BwdSmem<T, N>);
  cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<T, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = (d_model + kThreads - 1) / kThreads;
  mamba_scan_bwd_kernel<T, N><<<dim3(ctas, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const T*>(dy), static_cast<const float*>(dh),
      static_cast<T*>(ddt), static_cast<T*>(dx), static_cast<float*>(dh0),
      ckpt, part_bc, part_da, len, d_model);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(batch) * len;
  mamba_scan_bwd_bc<T, N><<<static_cast<unsigned>(
      (rows * 2 * N + kReduceThreads - 1) / kReduceThreads),
      kReduceThreads, 0, stream>>>(part_bc, static_cast<T*>(db),
                                    static_cast<T*>(dc), rows,
                                    ctas * kWarps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long dn = static_cast<long long>(d_model) * N;
  mamba_scan_bwd_da<<<static_cast<unsigned>(
      (dn + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
      stream>>>(part_da, static_cast<float*>(da), batch, dn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, const void* h0, const void* dy, const void* dh,
           void* ddt, void* dx, void* db, void* dc, void* da, void* dh0,
           void* work, int batch, int len, int d_model, int n,
           cudaStream_t stream) {
  if (batch <= 0 || d_model <= 0 || len <= 0 || batch > 65535)
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
