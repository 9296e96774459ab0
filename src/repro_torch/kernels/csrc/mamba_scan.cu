// Fused selective scan of the Mamba block.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py:mamba_scan
// (_mamba_kernel): a_bar = exp(dt * A), h_t = a_bar * h_{t-1} +
// (dt * x) * B_t, y_t = <h_t, C_t>, with the f32 state h carried over the
// sequence, y returned in x's type and the last state in f32.
//
// Layouts (all contiguous): dt, x, y (B, L, D); b, c (B, L, N); a (D, N)
// f32; h0, h_out (B, D, N) f32. N is 8, 16, 32 or 64; D and L are any.
// Every call is one launch: L = 1 (a decode step) takes the step kernel,
// any longer L the scan kernel.
//
// What bounds it on the H100. Bytes: each input read once and each
// output written once is (3 B L D + 2 B L N) sizeof(T) + (D N + 2 B D N) 4
// bytes, 420.8 MB at the hybrid's prefill chunk (B 8, L 256, D 16384,
// N 16, f32), 0.126 ms at 3.35 TB/s. Exponentials: B L D N of them, 537 M
// at that chunk, and the special-function units do 16 a clock per SM:
// 0.128 ms at 1.98 GHz on 132 SMs, as long as the bytes. The rest is ~5
// f32 operations per (b, t, d, n) on the FMA pipe (0.05-0.06 ms). So the
// scan kernel is built to keep the SFUs and the memory busy at once:
// - each exponential is one ex2.approx.ftz (MUFU.EX2) of dt * A', with
//   A' = A log2(e) made once in registers: one multiply and one MUFU op
//   an element, where the accurate expf adds a range reduction on the FMA
//   pipe. ex2.approx is within 2 ulp (the bound CUDA states for exp2f,
//   the same instruction); tests/test_torch_mamba.py emulates this
//   arithmetic at twice that error and holds it to the 2e-5 bar;
// - a thread carries two channels for N <= 16 (one for larger N), each
//   with its N state values and its row of A' in registers: 32
//   independent exponentials a step, and a grid of 512 CTAs of 128
//   threads at the prefill chunk that 4 CTAs an SM hold in one wave
//   (the launch bounds cap the registers at 128 a thread for that);
// - dt and x for the CTA's 256 channels and B and C for its batch row go
//   through a 3-stage ring of 4 timesteps in shared memory filled by
//   16-byte cp.async copies, so two stages are in flight while the CTA
//   scans the third (rows whose length or address is not a multiple of
//   16 bytes take plain loads into the same ring);
// - y is summed as N/4 chains of 4 products, added pairwise.
// The t loop is sequential, so the parallelism is B D channels; a
// chunk-parallel scan is later work.
//
// At L = 1 the state in and out (16.8 MB at B 8, D 16384, N 16) is most
// of the bytes, and there is no scan: the step kernel gives each channel
// N/4 threads, each holding four state values, so a warp's 16-byte
// loads and stores of h0, A and h_out cover consecutive addresses, and
// y is the same pairwise sum of chains, taken with shuffles.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;      // threads of a scan CTA
constexpr int kSteps = 4;          // timesteps a ring stage holds
constexpr int kStages = 3;         // ring depth
constexpr int kStepThreads = 256;  // threads of a step CTA
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct ScanShape {
  static constexpr int kPerThread = N <= 16 ? 2 : 1;       // channels
  static constexpr int kChannels = kThreads * kPerThread;  // per CTA
  static constexpr int kMinBlocks = N <= 32 ? 4 : 2;       // per SM
  static constexpr int kQuads = N / 4;
};

template <typename T, int N>
struct __align__(16) ScanStage {
  T dt[kSteps][ScanShape<N>::kChannels];
  T x[kSteps][ScanShape<N>::kChannels];
  T b[kSteps][N];
  T c[kSteps][N];
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 16-byte asynchronous copy to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// four consecutive values of a shared row, as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// one row of `count` elements of T into shared memory: 16-byte copies
// when `vec` (the row's start and length are multiples of 16 bytes),
// else plain loads; `live` elements are read, the rest zeroed
template <typename T, int kCount>
__device__ __forceinline__ void stage_rows(T (*dst)[kCount], const T* src,
                                           size_t row_stride, int rows,
                                           int live, bool vec, int first,
                                           int stride) {
  constexpr int kVE = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = kCount / kVE;
  if (vec) {
    for (int i = first; i < rows * kChunks; i += stride) {
      const int r = i / kChunks, e = (i % kChunks) * kVE;
      const bool ok = e < live;
      cp_async16(&dst[r][e], ok ? src + r * row_stride + e : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = first; i < rows * kCount; i += stride) {
      const int r = i / kCount, e = i % kCount;
      dst[r][e] = e < live ? src[r * row_stride + e]
                           : repro::from_float<T>(0.f);
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_stage(ScanStage<T, N>& s, const T* dt,
                                           const T* x, const T* bm,
                                           const T* cm, size_t t_row,
                                           int steps, int d0, int d_model,
                                           bool vec, bool bc_vec) {
  constexpr int kC = ScanShape<N>::kChannels;
  const size_t off = t_row * d_model + d0;
  const int live = min(kC, d_model - d0);
  stage_rows<T, kC>(s.dt, dt + off, d_model, steps, live, vec, threadIdx.x,
                    kThreads);
  stage_rows<T, kC>(s.x, x + off, d_model, steps, live, vec, threadIdx.x,
                    kThreads);
  // B on the first half of the threads, C on the second
  const int half = kThreads / 2;
  const bool on_b = threadIdx.x < half;
  stage_rows<T, N>(on_b ? s.b : s.c, (on_b ? bm : cm) + t_row * N, N, steps,
                   N, bc_vec, threadIdx.x % half, half);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, ScanShape<N>::kMinBlocks)
mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ h0,
                  T* __restrict__ y, float* __restrict__ h_out, int len,
                  int d_model, bool vec, bool bc_vec) {
  using S = ScanShape<N>;
  constexpr int P = S::kPerThread;
  constexpr int Q = S::kQuads;
  __shared__ ScanStage<T, N> ring[kStages];

  const int tid = threadIdx.x;
  const int bb = blockIdx.y;
  const int d0 = blockIdx.x * S::kChannels;
  const size_t row = static_cast<size_t>(bb) * len;  // (b, t = 0)
  const int tiles = (len + kSteps - 1) / kSteps;

  // the first stages go in flight before the state is read
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles)
      load_stage(ring[k], dt, x, bm, cm, row + k * kSteps,
                 min(kSteps, len - k * kSteps), d0, d_model, vec, bc_vec);
    cp_async_commit();
  }

  float h[P][N], a2[P][N];
  bool live[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int d = d0 + tid + p * kThreads;
    live[p] = d < d_model;
    const float4* hp = reinterpret_cast<const float4*>(
        h0 + (static_cast<size_t>(bb) * d_model + d) * N);
    const float4* ap = reinterpret_cast<const float4*>(
        a + static_cast<size_t>(d) * N);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 hv = live[p] ? hp[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 av = live[p] ? ap[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      h[p][4 * q] = hv.x; h[p][4 * q + 1] = hv.y;
      h[p][4 * q + 2] = hv.z; h[p][4 * q + 3] = hv.w;
      a2[p][4 * q] = av.x * kLog2e; a2[p][4 * q + 1] = av.y * kLog2e;
      a2[p][4 * q + 2] = av.z * kLog2e; a2[p][4 * q + 3] = av.w * kLog2e;
    }
  }

  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage k
    __syncthreads();               // everyone's; stage k - 1 consumed
    const int kn = k + kStages - 1;
    if (kn < tiles)
      load_stage(ring[kn % kStages], dt, x, bm, cm, row + kn * kSteps,
                 min(kSteps, len - kn * kSteps), d0, d_model, vec, bc_vec);
    cp_async_commit();
    const ScanStage<T, N>& s = ring[k % kStages];
    const int t0 = k * kSteps;
    const int steps = min(kSteps, len - t0);
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t >= steps) break;
      float dtv[P], bx[P], acc[P][Q];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        dtv[p] = repro::to_float(s.dt[t][tid + p * kThreads]);
        bx[p] = dtv[p] * repro::to_float(s.x[t][tid + p * kThreads]);
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 b4 = load4(&s.b[t][4 * q]);
        const float4 c4 = load4(&s.c[t][4 * q]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = 4 * q + j;
            const float a_bar = ex2(dtv[p] * a2[p][n]);
            h[p][n] = fmaf(a_bar, h[p][n], bx[p] * bv[j]);
            acc[p][q] = j == 0 ? h[p][n] * cv[j]
                               : fmaf(h[p][n], cv[j], acc[p][q]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        // pairwise: the order the step kernel's shuffles take
#pragma unroll
        for (int w = 1; w < Q; w *= 2)
#pragma unroll
          for (int q = 0; q < Q; q += 2 * w) acc[p][q] += acc[p][q + w];
        if (live[p])
          y[(row + t0 + t) * d_model + d0 + tid + p * kThreads] =
              repro::from_float<T>(acc[p][0]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!live[p]) continue;
    float4* hp = reinterpret_cast<float4*>(
        h_out + (static_cast<size_t>(bb) * d_model + d0 + tid + p * kThreads)
        * N);
#pragma unroll
    for (int q = 0; q < Q; ++q)
      hp[q] = make_float4(h[p][4 * q], h[p][4 * q + 1], h[p][4 * q + 2],
                          h[p][4 * q + 3]);
  }
}

// L = 1: N / 4 threads a channel, four state values each
template <typename T, int N>
__global__ void __launch_bounds__(kStepThreads)
mamba_step_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ h0,
                  T* __restrict__ y, float* __restrict__ h_out, int d_model,
                  long long channels) {
  constexpr int G = N / 4;
  const long long gid =
      static_cast<long long>(blockIdx.x) * kStepThreads + threadIdx.x;
  const bool live = gid / G < channels;
  // dead lanes compute on the last channel: every lane takes the shuffles
  const long long ch = live ? gid / G : channels - 1;   // b * D + d
  const int j = static_cast<int>(gid % G);
  const int bb = static_cast<int>(ch / d_model);
  const int d = static_cast<int>(ch % d_model);

  const float4 hv = reinterpret_cast<const float4*>(h0)[ch * G + j];
  const float4 av =
      reinterpret_cast<const float4*>(a)[static_cast<size_t>(d) * G + j];
  const float dtv = repro::to_float(dt[ch]);
  const float bx = dtv * repro::to_float(x[ch]);
  const T* bp = bm + static_cast<size_t>(bb) * N + 4 * j;
  const T* cp = cm + static_cast<size_t>(bb) * N + 4 * j;
  float hn[4] = {hv.x, hv.y, hv.z, hv.w};
  const float an[4] = {av.x, av.y, av.z, av.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a_bar = ex2(dtv * (an[i] * kLog2e));
    hn[i] = fmaf(a_bar, hn[i], bx * repro::to_float(bp[i]));
    acc = i == 0 ? hn[i] * repro::to_float(cp[i])
                 : fmaf(hn[i], repro::to_float(cp[i]), acc);
  }
#pragma unroll
  for (int w = 1; w < G; w *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (!live) return;
  reinterpret_cast<float4*>(h_out)[ch * G + j] =
      make_float4(hn[0], hn[1], hn[2], hn[3]);
  if (j == 0) y[ch] = repro::from_float<T>(acc);
}

template <typename T, int N>
int launch_n(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a, const void* h0, void* y, void* h_out, int batch,
             int len, int d_model, cudaStream_t stream) {
  const T* dtp = static_cast<const T*>(dt);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(bm);
  const T* cp = static_cast<const T*>(cm);
  const float* ap = static_cast<const float*>(a);
  const float* hp = static_cast<const float*>(h0);
  T* yp = static_cast<T*>(y);
  float* hop = static_cast<float*>(h_out);
  if (len == 1) {
    const long long channels = static_cast<long long>(batch) * d_model;
    const long long threads = channels * (N / 4);
    const unsigned blocks = static_cast<unsigned>(
        (threads + kStepThreads - 1) / kStepThreads);
    mamba_step_kernel<T, N><<<blocks, kStepThreads, 0, stream>>>(
        dtp, xp, bp, cp, ap, hp, yp, hop, d_model, channels);
  } else {
    const auto addr = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p);
    };
    const bool vec = (static_cast<size_t>(d_model) * sizeof(T)) % 16 == 0 &&
                     (addr(dt) | addr(x)) % 16 == 0;
    const bool bc_vec = (addr(bm) | addr(cm)) % 16 == 0;
    const dim3 grid((d_model + ScanShape<N>::kChannels - 1) /
                        ScanShape<N>::kChannels,
                    batch);
    mamba_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
        dtp, xp, bp, cp, ap, hp, yp, hop, len, d_model, vec, bc_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// the grid of a call and the CTAs of its kernel an SM holds at once
template <typename T, int N>
int plan_n(int batch, int len, int d_model, int* grid, int* ctas_per_sm) {
  if (len == 1) {
    const long long threads = static_cast<long long>(batch) * d_model *
                              (N / 4);
    *grid = static_cast<int>((threads + kStepThreads - 1) / kStepThreads);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, mamba_step_kernel<T, N>, kStepThreads, 0));
  }
  *grid = (d_model + ScanShape<N>::kChannels - 1) /
          ScanShape<N>::kChannels * batch;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, mamba_scan_kernel<T, N>, kThreads, 0));
}

template <typename T>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, const void* h0, void* y, void* h_out, int batch,
           int len, int d_model, int n, cudaStream_t stream) {
  if (batch <= 0 || d_model <= 0) return 0;
  if (len <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 8: return launch_n<T, 8>(dt, x, bm, cm, a, h0, y, h_out, batch, len,
                                  d_model, stream);
    case 16: return launch_n<T, 16>(dt, x, bm, cm, a, h0, y, h_out, batch,
                                    len, d_model, stream);
    case 32: return launch_n<T, 32>(dt, x, bm, cm, a, h0, y, h_out, batch,
                                    len, d_model, stream);
    case 64: return launch_n<T, 64>(dt, x, bm, cm, a, h0, y, h_out, batch,
                                    len, d_model, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int plan(int batch, int len, int d_model, int n, int* grid,
         int* ctas_per_sm) {
  switch (n) {
    case 8: return plan_n<T, 8>(batch, len, d_model, grid, ctas_per_sm);
    case 16: return plan_n<T, 16>(batch, len, d_model, grid, ctas_per_sm);
    case 32: return plan_n<T, 32>(batch, len, d_model, grid, ctas_per_sm);
    case 64: return plan_n<T, 64>(batch, len, d_model, grid, ctas_per_sm);
  }
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

// the grid mamba_scan_fwd launches for these sizes, and how many of its
// CTAs one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int mamba_scan_plan(int dtype, int batch, int len, int d_model,
                               int n, int* grid, int* ctas_per_sm) {
  if (dtype == 0) return plan<float>(batch, len, d_model, n, grid,
                                     ctas_per_sm);
  if (dtype == 1) return plan<__nv_bfloat16>(batch, len, d_model, n, grid,
                                             ctas_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
