// Fused selective scan of the Mamba block: one thread per (batch, channel).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py:mamba_scan
// (_mamba_kernel): a_bar = exp(dt * A), h_t = a_bar * h_{t-1} +
// (dt * x) * B_t, y_t = <h_t, C_t>, with the f32 state h carried over the
// sequence, y returned in x's type and the last state in f32.
//
// Layouts (all contiguous): dt, x, y (B, L, D); b, c (B, L, N); a (D, N)
// f32; h0, h_out (B, D, N) f32. N is 8, 16, 32 or 64; D and L are any.
//
// Design. The TPU kernel walks (batch, D blocks of 256, chunks) with the
// chunk axis in order and the state in VMEM scratch. Here the recurrence
// over t is a loop inside one thread that owns one channel d and keeps
// its N state values and its row of A in registers, so nothing is
// carried between CTAs and any L >= 1 takes one launch (the model calls
// once per chunk with the state passed through h0, as the reference's
// ops.mamba_chunk calls the TPU kernel with chunk = L). A CTA holds 128
// consecutive channels of one batch row. Every thread of the CTA reads
// the same B_t and C_t, and neighbouring threads read neighbouring dt/x,
// so the CTA stages a tile of timesteps (dt, x for its channels, B
// and C whole) in shared memory with coalesced loads, all in flight at
// once, then steps through it; y is stored each step, coalesced along d.
// Channels past D (D = 192 in the reference's sweep) load and store
// nothing but take part in the staging and the barriers.
//
// What bounds it on the H100. Bytes: each input read once and each
// output written once is (3 B L D + 2 B L N) sizeof(T) + (D N + 2 B D N) 4
// bytes, 420.8 MB at the hybrid's prefill chunk (B 8, L 256, D 16384,
// N 16), 0.126 ms at 3.35 TB/s; at decode (L = 1) the state in and out
// is most of the 17.8 MB. It does B L D N exponentials, 537 M at the
// prefill chunk, which need about as long on the special-function units
// (~4e12 a second), and ~7 f32 operations per (b, t, d, n). The t loop
// is sequential, so the parallelism is B D threads (131,072 at B 8,
// D 16384): enough to fill the card at prefill and at decode alike. A
// chunk-parallel scan is later work. Arithmetic is f32 with the accurate
// expf (no --use_fast_math), for the reference's 2e-5 bar.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // channels per CTA


template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ h0,
                  T* __restrict__ y, float* __restrict__ h_out, int len,
                  int d_model) {
  // timesteps staged per pass: 32 (16 for N = 64) keeps the static shared
  // memory (dt and x for 128 channels, B and C) at 36 KB for N = 16 and
  // at most 40 KB for every N the kernel takes
  constexpr int kTile = N <= 32 ? 32 : 16;
  __shared__ float s_dt[kTile][kThreads];
  __shared__ float s_x[kTile][kThreads];
  __shared__ float s_b[kTile][N];
  __shared__ float s_c[kTile][N];

  const int tid = threadIdx.x;
  const int bb = blockIdx.y;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + tid;
  const bool live = d < d_model;

  float h[N], av[N];
  if (live) {
    const float4* hp = reinterpret_cast<const float4*>(
        h0 + (static_cast<size_t>(bb) * d_model + d) * N);
    const float4* ap = reinterpret_cast<const float4*>(
        a + static_cast<size_t>(d) * N);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 hv = hp[i], va = ap[i];
      h[4 * i] = hv.x; h[4 * i + 1] = hv.y; h[4 * i + 2] = hv.z;
      h[4 * i + 3] = hv.w;
      av[4 * i] = va.x; av[4 * i + 1] = va.y; av[4 * i + 2] = va.z;
      av[4 * i + 3] = va.w;
    }
  }

  const size_t row = static_cast<size_t>(bb) * len;  // (b, t = 0)
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int steps = min(kTile, len - t0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll 8
    for (int t = 0; t < steps; ++t) {
      const size_t off = (row + t0 + t) * d_model + d;
      s_dt[t][tid] = live ? repro::to_float(dt[off]) : 0.f;
      s_x[t][tid] = live ? repro::to_float(x[off]) : 0.f;
    }
    for (int i = tid; i < steps * N; i += kThreads) {
      const size_t off = (row + t0) * N + i;
      s_b[i / N][i % N] = repro::to_float(bm[off]);
      s_c[i / N][i % N] = repro::to_float(cm[off]);
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const float dt_t = s_dt[t][tid];
      const float bx = dt_t * s_x[t][tid];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float a_bar = expf(dt_t * av[n]);
        h[n] = a_bar * h[n] + bx * s_b[t][n];
        acc += h[n] * s_c[t][n];
      }
      y[(row + t0 + t) * d_model + d] = repro::from_float<T>(acc);
    }
  }

  if (live) {
    float4* hp = reinterpret_cast<float4*>(
        h_out + (static_cast<size_t>(bb) * d_model + d) * N);
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      hp[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
}

template <typename T>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, const void* h0, void* y, void* h_out, int batch,
           int len, int d_model, int n, cudaStream_t stream) {
  if (batch <= 0 || d_model <= 0) return 0;
  if (len <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d_model + kThreads - 1) / kThreads, batch);
  const T* dtp = static_cast<const T*>(dt);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(bm);
  const T* cp = static_cast<const T*>(cm);
  const float* ap = static_cast<const float*>(a);
  const float* hp = static_cast<const float*>(h0);
  T* yp = static_cast<T*>(y);
  float* hop = static_cast<float*>(h_out);
#define REPRO_MAMBA_CASE(NN)                                               \
  if (n == NN) {                                                           \
    mamba_scan_kernel<T, NN><<<grid, kThreads, 0, stream>>>(               \
        dtp, xp, bp, cp, ap, hp, yp, hop, len, d_model);                   \
    return static_cast<int>(cudaGetLastError());                           \
  }
  REPRO_MAMBA_CASE(8)
  REPRO_MAMBA_CASE(16)
  REPRO_MAMBA_CASE(32)
  REPRO_MAMBA_CASE(64)
#undef REPRO_MAMBA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype of dt, x, b, c and y: 0 = float32, 1 = bfloat16
extern "C" int mamba_scan_fwd(const void* dt, const void* x, const void* bm,
                              const void* cm, const void* a, const void* h0,
                              void* y, void* h_out, int dtype, int batch,
                              int len, int d_model, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dt, x, bm, cm, a, h0, y, h_out, batch, len, d_model,
                         n, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dt, x, bm, cm, a, h0, y, h_out, batch, len,
                                 d_model, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
