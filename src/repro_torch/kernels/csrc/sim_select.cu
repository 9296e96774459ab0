// The planner sweep's order statistics: for each candidate, the values
// of ranks r0 <= r1 in the multiset of its row of k latencies and a
// segment of m latencies shared by every candidate (the queries that
// never reach the varied stage).
//
// Replaces the reference's host tail of the sweep, which is numpy, not
// Pallas: src/repro/sim/jax_backend.py grid_stage_percentiles,
// `np.partition(lat, kth)` and `part[prev], part[nxt]` (:566-573). The
// two values are exact members of the multiset, so the host's lerp of
// them equals np.percentile bit for bit.
//
// What bounds it on the H100: bytes. Each (C, k) row is read from
// device memory once a pass; a pass is a few integer operations an
// element. The design keeps the passes over device memory few.
//
// Design: a CTA a candidate, an MSB-first radix select over the 64-bit
// order-preserving keys of the values, 8 bits a digit. A pass counts
// the next digit of the survivors (the elements whose higher digits
// equal the prefix found so far) in a shared-memory histogram; warp 0
// finds each rank's bin and narrows the prefix. The two ranks share the
// histogram until their bins differ, then keep one each. Counts are
// added warp-aggregated (__match_any_sync), since the high digits of a
// row are few and would otherwise queue on one shared address. Once the
// survivors fit in shared memory (kCap keys), the next pass from device
// memory also copies them there, and later passes read only those.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kDigits = 64 / kBits;
constexpr int kCap = 8192;            // survivors copied to shared memory
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr unsigned long long kSign = 1ull << 63;

// Keys ordered as numpy orders the doubles: a non-negative value sets
// the sign bit, a negative one flips every bit, and NaN (which numpy
// sorts last) maps above +inf. -0.0 would order below +0.0, which numpy
// takes as equal; the sweep's latencies hold no -0.0.
__device__ __forceinline__ unsigned long long order_key(double x) {
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(x));
  if (x != x) return ~0ull;
  return (u & kSign) ? ~u : (u | kSign);
}

__device__ __forceinline__ double key_value(unsigned long long key) {
  return __longlong_as_double(
      static_cast<long long>((key & kSign) ? (key ^ kSign) : ~key));
}

enum Source { kGlobal = 0, kGlobalCompact = 1, kShared = 2 };

struct State {
  unsigned long long prefix[2];       // each rank's digits found so far
  long long rank[2];                  // each rank among its survivors
  int split;                          // the ranks' prefixes differ
  int source;                         // where the next pass reads
  unsigned fill;                      // keys copied to shared memory
  int bin[2];
  long long below[2];
};

// Warp 0: the bin of `h` (kBins counts) that holds `rank`, and the count
// of the bins before it. Lane l sums bins 8l .. 8l + 7.
__device__ __forceinline__ void find_bin(const unsigned* __restrict__ h,
                                         long long rank, int lane, int* bin,
                                         long long* below) {
  constexpr int kPer = kBins / 32;
  unsigned c[kPer];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = h[kPer * lane + j];
    sum += c[j];
  }
  unsigned inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  const long long exc = inc - sum;
  const unsigned owner =
      __ballot_sync(kFull, exc <= rank && rank < static_cast<long long>(inc));
  if (lane == __ffs(owner) - 1) {
    long long acc = exc;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (rank < acc + c[j]) {
        *bin = kPer * lane + j;
        *below = acc;
        break;
      }
      acc += c[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
sim_select_kernel(const double* __restrict__ rows, long long k,
                  const double* __restrict__ seg, long long m, long long r0,
                  long long r1, double* __restrict__ out) {
  extern __shared__ unsigned long long buf[];   // kCap survivor keys
  __shared__ unsigned hist[2 * kBins];
  __shared__ State st;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned lt = (1u << lane) - 1;
  const double* row = rows + static_cast<size_t>(blockIdx.x) * k;
  const long long total = k + m;
  if (tid == 0) {
    st.prefix[0] = st.prefix[1] = 0;
    st.rank[0] = r0;
    st.rank[1] = r1;
    st.split = 0;
    st.source = kGlobal;
    st.fill = 0;
  }
  for (int d = 0; d < kDigits; ++d) {
    const int shift = 64 - kBits * (d + 1);
    const unsigned long long hmask = d == 0 ? 0ull : ~0ull << (shift + kBits);
    for (int i = tid; i < 2 * kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    const unsigned long long p0 = st.prefix[0], p1 = st.prefix[1];
    const bool split = st.split;
    const int source = st.source;
    // every thread of a warp calls this together (match, ballot)
    auto visit = [&](unsigned long long key, bool ok) {
      const unsigned long long top = key & hmask;
      const unsigned digit = static_cast<unsigned>(key >> shift) & (kBins - 1);
      const unsigned code = !ok ? kNone
                          : top == p0 ? digit
                          : (split && top == p1) ? kBins + digit : kNone;
      const unsigned peers = __match_any_sync(kFull, code);
      if (code != kNone && lane == __ffs(peers) - 1)
        atomicAdd(&hist[code], __popc(peers));
      if (source == kGlobalCompact) {
        const unsigned keep = __ballot_sync(kFull, code != kNone);
        if (keep) {
          unsigned at = 0;
          if (lane == 0) at = atomicAdd(&st.fill, __popc(keep));
          at = __shfl_sync(kFull, at, 0);
          if (code != kNone) buf[at + __popc(keep & lt)] = key;
        }
      }
    };
    if (source == kShared) {
      const int n = static_cast<int>(st.fill);
      for (int base = 0; base < n; base += kThreads) {
        const int i = base + tid;
        visit(i < n ? buf[i] : 0ull, i < n);
      }
    } else {
      for (long long base = 0; base < total;
           base += static_cast<long long>(kThreads) * kUnroll) {
        double v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long i = base + u * kThreads + tid;
          v[u] = i >= total ? 0.0 : i < k ? __ldcs(row + i)
                                          : __ldg(seg + (i - k));
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          visit(order_key(v[u]), base + u * kThreads + tid < total);
      }
    }
    __syncthreads();
    if (tid < 32) {
      find_bin(hist, st.rank[0], lane, &st.bin[0], &st.below[0]);
      find_bin(split ? hist + kBins : hist, st.rank[1], lane, &st.bin[1],
               &st.below[1]);
      __syncwarp();
      if (lane == 0) {
        const int b0 = st.bin[0], b1 = st.bin[1];
        st.prefix[0] = p0 | (static_cast<unsigned long long>(b0) << shift);
        st.prefix[1] = (split ? p1 : p0) |
                       (static_cast<unsigned long long>(b1) << shift);
        st.rank[0] -= st.below[0];
        st.rank[1] -= st.below[1];
        const unsigned left = hist[b0] + (split ? hist[kBins + b1]
                                          : b1 != b0 ? hist[b1] : 0u);
        st.split = split || b1 != b0;
        if (source == kGlobalCompact) {
          st.source = kShared;
        } else if (source == kGlobal && left <= kCap) {
          st.source = kGlobalCompact;
          st.fill = 0;
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[2 * static_cast<size_t>(blockIdx.x)] = key_value(st.prefix[0]);
    out[2 * static_cast<size_t>(blockIdx.x) + 1] = key_value(st.prefix[1]);
  }
}

}  // namespace

// rows: lanes x k float64; seg: m float64 (any pointer when m is 0);
// 0 <= r0 <= r1 < k + m < 2^32; out: lanes x 2 float64, the values of
// ranks r0 and r1 in each row's multiset with the segment.
extern "C" int sim_select(const void* rows, long long k, const void* seg,
                          long long m, int lanes, long long r0, long long r1,
                          void* out, void* stream) {
  if (lanes <= 0) return 0;
  const int smem = kCap * static_cast<int>(sizeof(unsigned long long));
  cudaError_t rc = cudaFuncSetAttribute(
      sim_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  sim_select_kernel<<<lanes, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rows), k, static_cast<const double*>(seg),
      m, r0, r1, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
