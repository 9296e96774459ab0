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
// What bounds it on the H100: bytes. Each (C, k) row has to be read
// from device memory once; the rest is a few integer operations a key.
//
// Both paths are an MSB-first radix select over the 64-bit
// order-preserving keys of the values, 8 bits a digit (the cluster
// path's first, kWideBits). A pass counts
// the next digit of the survivors (the keys whose higher digits equal
// the prefix found so far) in a shared-memory histogram; one warp finds
// each rank's bin (find_bin) and narrows the prefix. The two ranks
// share the histogram until their bins differ, then keep one each.
//
// The cluster path (k + m <= kClusterCap): a thread-block cluster of
// kCluster CTAs a candidate reads the row and the segment from device
// memory once, into the cluster's distributed shared memory. Warp w of
// CTA r copies keys [(8 r + w) R, (8 r + w + 1) R) of the row followed
// by the segment, R = ceil((k + m) / (8 kCluster)) rounded up to even,
// with cp.async: 16 bytes a copy between a scalar head and tail, the
// slot shifted by one key where the source is only 8-byte aligned (a
// row of odd k). The cluster's least and greatest key give the prefix
// that every key shares, and the first digit starts below it. Every
// pass then runs from shared memory and costs one cluster.sync(): the
// first counts a digit of kWideBits (2048 bins of 16-bit counts; each
// CTA reads the cluster's sums of 64 groups of bins, then the bins of
// each rank's group), so that most rows are narrowed to a few hundred
// keys at once. Each later pass counts 8 bits: each warp counts and
// compacts its own survivors in place (ballot order, so a write never
// passes a read), and every CTA sums the CTAs' histograms through
// distributed shared memory and finds the same bins (histograms are
// double-buffered by pass). A pass that finds each rank's survivors to
// be one key repeated ends the select. Once the survivors number at
// most kGather, they are appended to CTA 0's shared memory, the other
// CTAs exit, and warp 0 of CTA 0 finishes alone. Counts are plain
// shared-memory atomics: on the H100 the cluster's barriers, not the
// atomics, set the time of a pass, so the design spends few of them.
//
// The stream path (larger rows): a CTA a candidate reads the row from
// device memory a pass, until the survivors fit kCap keys of shared
// memory; the next pass also copies them there, and later passes read
// only those. Its counts are added warp-aggregated (__match_any_sync),
// since the high digits of a row are few.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;         // a CTA of the stream path
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kDigits = 64 / kBits;
constexpr int kCap = 8192;            // survivors copied to shared memory
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr unsigned long long kSign = 1ull << 63;

constexpr int kWarps = 8;             // a CTA of the cluster path
constexpr int kThreadsC = 32 * kWarps;
constexpr int kCluster = 16;          // CTAs a candidate (non-portable)
constexpr int kRegionCap = 3072;      // keys a warp holds
constexpr long long kClusterCap =
    static_cast<long long>(kCluster) * kWarps * kRegionCap;
constexpr int kGather = 1024;         // survivors CTA 0 finishes alone
constexpr int kIlp = 4;               // keys in flight a lane
constexpr int kWideBits = 11;         // the cluster path's first digit
constexpr int kWide = 1 << kWideBits;
constexpr int kGroups = 64;           // of kWide / kGroups bins each
constexpr int kSmemMax =
    (kWarps * (kRegionCap + 2) + kGather) *
    static_cast<int>(sizeof(unsigned long long));
constexpr int kMaxDevices = 64;
static_assert(2 * kCluster == 32 && kWarps % 2 == 0,
              "a warp reads the cluster's warp ends, two lanes a CTA");

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

// The stream path's state: where its next pass reads.
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

// Warp 0: the bin of `h` (kN counts) that holds `rank`, and the count
// of the bins before it. Lane l sums the l-th kN / 32 bins.
template <int kN = kBins>
__device__ __forceinline__ void find_bin(const unsigned* __restrict__ h,
                                         long long rank, int lane, int* bin,
                                         long long* below) {
  constexpr int kPer = kN / 32;
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A warp's asynchronous copies of src[0, cnt) (device memory) to
// dst[0, cnt) (shared memory): 16 bytes a copy between a scalar head and
// tail where src and dst agree modulo 16, else 8.
__device__ __forceinline__ void copy_span(double* dst, const double* src,
                                          int cnt, int lane) {
  auto copy8 = [](double* d, const double* g) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(d)), "l"(g) : "memory");
  };
  const unsigned long long s = reinterpret_cast<uintptr_t>(src);
  if (((s ^ smem_addr(dst)) & 15) != 0) {
    for (int j = lane; j < cnt; j += 32) copy8(dst + j, src + j);
    return;
  }
  const int head = cnt > 0 && (s & 15) != 0 ? 1 : 0;
  if (lane < head) copy8(dst, src);
  const int pairs = (cnt - head) >> 1;
  for (int j = lane; j < pairs; j += 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst + head + 2 * j)), "l"(src + head + 2 * j)
                 : "memory");
  if (lane == 0 && ((cnt - head) & 1)) copy8(dst + cnt - 1, src + cnt - 1);
}

// The least of `lo` and the greatest of `hi` over the warp, in every lane.
__device__ __forceinline__ void warp_ends(unsigned long long& lo,
                                          unsigned long long& hi) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned long long a = __shfl_xor_sync(kFull, lo, o);
    const unsigned long long b = __shfl_xor_sync(kFull, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
}

// What every CTA of a cluster knows alike after each pass.
struct Sel {
  unsigned long long prefix[2];       // each rank's digits found so far
  long long rank[2];                  // each rank among its survivors
  int rem;                            // key bits below the prefixes
  int split;                          // the ranks' prefixes differ
  int gather;                         // few survivors: move them to CTA 0
  int bin[2];
  long long below[2];
};

// The next digit: the bits [shift, rem) below the prefixes.
struct Digit {
  unsigned long long hmask, p0, p1;
  int shift;
  unsigned dmask;
  bool split;
};

__device__ __forceinline__ Digit digit_of(const Sel& st) {
  const int rem = st.rem;
  const int width = rem < kBits ? rem : kBits;
  return Digit{rem == 64 ? 0ull : ~0ull << rem, st.prefix[0], st.prefix[1],
               rem - width, (1u << width) - 1, st.split != 0};
}

// A warp's pass over its survivors mine[0, cnt): with kCount, the next
// digit of each key under p0 (bins 0..255) or p1 (256..511) into h, and
// each rank's survivors' least and greatest key into ends (every lane);
// the survivors compacted in place (a key moves only down, after the
// warp has read it). Returns their count.
template <bool kCount>
__device__ __forceinline__ int scan(unsigned long long* mine, int cnt,
                                    const Digit& d, unsigned* h,
                                    unsigned long long* ends, int lane) {
  const unsigned lt = (1u << lane) - 1;
  int kept = 0;
  unsigned long long lo0 = ~0ull, hi0 = 0, lo1 = ~0ull, hi1 = 0;
  for (int base = 0; base < cnt; base += 32 * kIlp) {
    unsigned long long key[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int i = base + 32 * u + lane;
      key[u] = i < cnt ? mine[i] : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int i = base + 32 * u + lane;
      const unsigned long long top = key[u] & d.hmask;
      const unsigned digit =
          static_cast<unsigned>(key[u] >> d.shift) & d.dmask;
      const unsigned code = i >= cnt ? kNone
                          : top == d.p0 ? digit
                          : (d.split && top == d.p1) ? kBins + digit : kNone;
      const unsigned keep = __ballot_sync(kFull, code != kNone);
      const int at = kept + __popc(keep & lt);
      if (code != kNone && at != i) mine[at] = key[u];
      kept += __popc(keep);
      if constexpr (kCount) {
        if (code != kNone) atomicAdd(&h[code], 1u);
        if (code < kBins) {
          lo0 = key[u] < lo0 ? key[u] : lo0;
          hi0 = key[u] > hi0 ? key[u] : hi0;
        } else if (code != kNone) {
          lo1 = key[u] < lo1 ? key[u] : lo1;
          hi1 = key[u] > hi1 ? key[u] : hi1;
        }
      }
    }
  }
  if constexpr (kCount) {
    warp_ends(lo0, hi0);
    warp_ends(lo1, hi1);
    ends[0] = lo0;
    ends[1] = hi0;
    ends[2] = lo1;
    ends[3] = hi1;
  }
  return kept;
}

// Warp 0: each rank's bin in tot (the second rank's in tot + kBins once
// the ranks split); narrow the prefixes, or end the select where each
// rank's survivors are one key repeated (ends). Every lane then reads st.
__device__ __forceinline__ void decide(Sel& st, const unsigned* tot,
                                       const unsigned long long* ends,
                                       const Digit& d, bool local, int lane) {
  find_bin(tot, st.rank[0], lane, &st.bin[0], &st.below[0]);
  find_bin(d.split ? tot + kBins : tot, st.rank[1], lane, &st.bin[1],
           &st.below[1]);
  __syncwarp();
  if (lane == 0) {
    const bool same0 = ends[0] == ends[1];
    const bool same1 = d.split ? ends[2] == ends[3] : same0;
    if (same0 && same1) {
      st.prefix[0] = ends[0];
      st.prefix[1] = d.split ? ends[2] : ends[0];
      st.rem = 0;
    } else {
      const int b0 = st.bin[0], b1 = st.bin[1];
      st.prefix[0] = d.p0 | (static_cast<unsigned long long>(b0) << d.shift);
      st.prefix[1] = (d.split ? d.p1 : d.p0) |
                     (static_cast<unsigned long long>(b1) << d.shift);
      st.rank[0] -= st.below[0];
      st.rank[1] -= st.below[1];
      const unsigned left = tot[b0] + (d.split ? tot[kBins + b1]
                                       : b1 != b0 ? tot[b1] : 0u);
      st.split = d.split || b1 != b0;
      st.rem = d.shift;
      st.gather = !local && d.shift > 0 && left <= kGather;
    }
  }
  __syncwarp();
}

// grid (lanes * kCluster), cluster (kCluster, 1, 1), kThreadsC threads,
// dynamic shared memory (kWarps * (region + 2) + kGather) keys; region
// is even.
__global__ void __launch_bounds__(kThreadsC, 3)
sim_select_cluster_kernel(const double* __restrict__ rows, long long k,
                          const double* __restrict__ seg, long long m,
                          long long r0, long long r1, int region,
                          double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned long long keys[];
  __shared__ unsigned hist[2][2 * kBins];       // by pass parity
  __shared__ unsigned tot[2 * kBins];           // the cluster's sums
  __shared__ unsigned long long ends[2][4];     // by pass parity: each
  __shared__ unsigned long long ends_all[4];    // rank's survivors' ends
  __shared__ unsigned long long wlo[kWarps], whi[kWarps];
  __shared__ unsigned wide[kWide / 2];          // first digit: 16-bit counts
  __shared__ unsigned groups[kGroups];          // its sums of kWide / kGroups
  __shared__ unsigned fill;                     // CTA 0: keys gathered
  __shared__ Sel st;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long cand = blockIdx.x / kCluster;
  const long long n = k + m;
  unsigned long long* const gath = keys + kWarps * (region + 2);

  // 1. this warp's keys [lo, hi) of the row followed by the segment, one
  // copy from device memory, placed so that it agrees modulo 16
  const long long lo =
      (static_cast<long long>(rank) * kWarps + warp) * region;
  const long long hi = n < lo + region ? n : lo + region;
  int cnt = hi > lo ? static_cast<int>(hi - lo) : 0;
  const double* first = lo < k ? rows + cand * k + lo : seg + (lo - k);
  const int off =
      cnt > 0 && (reinterpret_cast<uintptr_t>(first) & 15) != 0 ? 1 : 0;
  unsigned long long* mine = keys + warp * (region + 2) + off;
  double* raw = reinterpret_cast<double*>(mine);
  if (cnt > 0) {
    const long long e = hi < k ? hi : k;
    if (e > lo)
      copy_span(raw, rows + cand * k + lo, static_cast<int>(e - lo), lane);
    const long long s = lo > k ? lo : k;
    if (hi > s)
      copy_span(raw + (s - lo), seg + (s - k), static_cast<int>(hi - s),
                lane);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  // 2. the order keys, in place, and their least and greatest
  unsigned long long klo = ~0ull, khi = 0;
  for (int base = 0; base < cnt; base += 32 * kIlp) {
    double x[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int i = base + 32 * u + lane;
      x[u] = i < cnt ? raw[i] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int i = base + 32 * u + lane;
      if (i < cnt) {
        const unsigned long long key = order_key(x[u]);
        mine[i] = key;
        klo = key < klo ? key : klo;
        khi = key > khi ? key : khi;
      }
    }
  }
  warp_ends(klo, khi);
  if (lane == 0) {
    wlo[warp] = klo;
    whi[warp] = khi;
  }
  if (tid == 0) fill = 0;
  for (int i = tid; i < 2 * kBins; i += kThreadsC) hist[1][i] = 0;
  for (int i = tid; i < kWide / 2; i += kThreadsC) wide[i] = 0;
  if (tid < 4) ends[1][tid] = tid & 1 ? 0ull : ~0ull;
  cluster.sync();
  if (warp == 0) {
    // the prefix that every key of the multiset shares: lane l reads
    // warps 4 (l / 16) .. 4 (l / 16) + 3 of CTA l % 16
    unsigned long long a = ~0ull, b = 0;
    const unsigned long long* plo = cluster.map_shared_rank(wlo, lane & 15);
    const unsigned long long* phi = cluster.map_shared_rank(whi, lane & 15);
#pragma unroll
    for (int j = 0; j < kWarps / 2; ++j) {
      const unsigned long long x = plo[(lane >> 4) * (kWarps / 2) + j];
      const unsigned long long y = phi[(lane >> 4) * (kWarps / 2) + j];
      a = x < a ? x : a;
      b = y > b ? y : b;
    }
    warp_ends(a, b);
    if (lane == 0) {
      const int rem = a == b ? 0 : 64 - __clzll(static_cast<long long>(a ^ b));
      st.prefix[0] = st.prefix[1] = rem == 64 ? 0ull : a & (~0ull << rem);
      st.rank[0] = r0;
      st.rank[1] = r1;
      st.rem = rem;
      st.split = 0;
      st.gather = 0;
    }
  }
  __syncthreads();

  // 3. the first pass counts every key (they all share the prefix) and
  // compacts none. Its digit is kWideBits wide, in 16-bit counts: each
  // CTA sums them in groups before the barrier, and every CTA reads the
  // cluster's group sums, then the bins of each rank's group
  if (st.rem > 0) {
    const int width = st.rem < kWideBits ? st.rem : kWideBits;
    const int shift = st.rem - width;
    const unsigned dmask = (1u << width) - 1;
    for (int base = 0; base < cnt; base += 32 * kIlp) {
      unsigned long long key[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int i = base + 32 * u + lane;
        key[u] = i < cnt ? mine[i] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if (base + 32 * u + lane < cnt) {
          const unsigned b = static_cast<unsigned>(key[u] >> shift) & dmask;
          atomicAdd(&wide[b >> 1], 1u << ((b & 1) << 4));
        }
    }
    __syncthreads();
    {
      // thread t sums bins 8t .. 8t + 7; four threads a group
      static_assert(kWide / kThreadsC == 8 && kWide / kGroups == 32, "groups");
      unsigned sum = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned w = wide[4 * tid + j];
        sum += (w & 0xffffu) + (w >> 16);
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      if ((tid & 3) == 0) groups[tid >> 2] = sum;
    }
    cluster.sync();                   // every CTA's counts are written
    if (tid < kGroups) {
      unsigned sum = 0;
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        sum += cluster.map_shared_rank(groups, q)[tid];
      tot[tid] = sum;
    }
    __syncthreads();
    if (warp == 0) {
      find_bin<kGroups>(tot, st.rank[0], lane, &st.bin[0], &st.below[0]);
      find_bin<kGroups>(tot, st.rank[1], lane, &st.bin[1], &st.below[1]);
    }
    __syncthreads();
    if (tid < 64) {
      // the cluster's counts of the 32 bins of each rank's group
      const int b = (st.bin[tid >> 5] << 5) + (tid & 31);
      unsigned sum = 0;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const unsigned w = cluster.map_shared_rank(wide, q)[b >> 1];
        sum += b & 1 ? w >> 16 : w & 0xffffu;
      }
      tot[kGroups + tid] = sum;
    }
    __syncthreads();
    if (warp == 0) {
      const int g0 = st.bin[0], g1 = st.bin[1];
      const long long a0 = st.below[0], a1 = st.below[1];
      __syncwarp();
      find_bin<32>(tot + kGroups, st.rank[0] - a0, lane, &st.bin[0],
                   &st.below[0]);
      find_bin<32>(tot + kGroups + 32, st.rank[1] - a1, lane, &st.bin[1],
                   &st.below[1]);
      __syncwarp();
      if (lane == 0) {
        const int j0 = st.bin[0], j1 = st.bin[1];
        const int b0 = 32 * g0 + j0, b1 = 32 * g1 + j1;
        const unsigned long long p = st.prefix[0];
        st.prefix[0] = p | (static_cast<unsigned long long>(b0) << shift);
        st.prefix[1] = p | (static_cast<unsigned long long>(b1) << shift);
        st.rank[0] -= a0 + st.below[0];
        st.rank[1] -= a1 + st.below[1];
        const unsigned left =
            tot[kGroups + j0] + (b1 != b0 ? tot[kGroups + 32 + j1] : 0u);
        st.split = b1 != b0;
        st.rem = shift;
        st.gather = shift > 0 && left <= kGather;
      }
    }
    __syncthreads();
  }

  // 4. the next passes, over the survivors
  for (int pass = 1; st.rem > 0 && !st.gather; ++pass) {
    const Digit d = digit_of(st);
    unsigned* h = hist[pass & 1];
    unsigned long long* e = ends[pass & 1];
    unsigned long long mine_ends[4];
    cnt = scan<true>(mine, cnt, d, h, mine_ends, lane);
    if (lane == 0 && cnt > 0) {
      atomicMin(&e[0], mine_ends[0]);
      atomicMax(&e[1], mine_ends[1]);
      atomicMin(&e[2], mine_ends[2]);
      atomicMax(&e[3], mine_ends[3]);
    }
    cluster.sync();                   // every CTA's histogram is written
    const int bins = d.split ? 2 * kBins : kBins;
    for (int b = tid; b < bins; b += kThreadsC) {
      unsigned sum = 0;
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        sum += cluster.map_shared_rank(h, q)[b];
      tot[b] = sum;
    }
    if (warp == kWarps - 1) {
      unsigned long long a0 = ~0ull, b0 = 0, a1 = ~0ull, b1 = 0;
      if (lane < kCluster) {
        const unsigned long long* c = cluster.map_shared_rank(e, lane);
        a0 = c[0];
        b0 = c[1];
        a1 = c[2];
        b1 = c[3];
      }
      warp_ends(a0, b0);
      warp_ends(a1, b1);
      if (lane == 0) {
        ends_all[0] = a0;
        ends_all[1] = b0;
        ends_all[2] = a1;
        ends_all[3] = b1;
      }
    }
    // the next pass's buffers: every peer has read them (last pass's sums)
    for (int i = tid; i < 2 * kBins; i += kThreadsC) hist[(pass + 1) & 1][i] = 0;
    if (tid < 4) ends[(pass + 1) & 1][tid] = tid & 1 ? 0ull : ~0ull;
    __syncthreads();
    if (warp == 0) decide(st, tot, ends_all, d, false, lane);
    __syncthreads();
  }
  if (st.rem == 0) {
    cluster.sync();                   // no CTA leaves while a peer reads it
    if (rank == 0 && tid == 0) {
      out[2 * cand] = key_value(st.prefix[0]);
      out[2 * cand + 1] = key_value(st.prefix[1]);
    }
    return;
  }

  // 4. few survivors: each warp compacts its own and appends them to CTA
  // 0's shared memory; then warp 0 of CTA 0 goes on alone
  cnt = scan<false>(mine, cnt, digit_of(st), nullptr, nullptr, lane);
  unsigned at = 0;
  if (lane == 0 && cnt > 0) at = atomicAdd(cluster.map_shared_rank(&fill, 0), cnt);
  at = __shfl_sync(kFull, at, 0);
  unsigned long long* dst = cluster.map_shared_rank(gath, 0) + at;
  for (int j = lane; j < cnt; j += 32) dst[j] = mine[j];
  cluster.sync();                     // gathered; no CTA reads a peer again
  if (rank != 0 || warp != 0) return;
  mine = gath;
  cnt = static_cast<int>(fill);
  for (int pass = 0; st.rem > 0; ++pass) {
    const Digit d = digit_of(st);
    unsigned* h = hist[pass & 1];
    for (int i = lane; i < 2 * kBins; i += 32) h[i] = 0;
    __syncwarp();
    unsigned long long mine_ends[4];
    cnt = scan<true>(mine, cnt, d, h, mine_ends, lane);
    __syncwarp();
    decide(st, h, mine_ends, d, true, lane);
  }
  if (lane == 0) {
    out[2 * cand] = key_value(st.prefix[0]);
    out[2 * cand + 1] = key_value(st.prefix[1]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
sim_select_stream_kernel(const double* __restrict__ rows, long long k,
                         const double* __restrict__ seg, long long m,
                         long long r0, long long r1,
                         double* __restrict__ out) {
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

cudaError_t prepare() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] {
    err[dev] = cudaFuncSetAttribute(
        sim_select_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kCap * static_cast<int>(sizeof(unsigned long long)));
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncSetAttribute(
          sim_select_cluster_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncSetAttribute(
          sim_select_cluster_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  });
  return err[dev];
}

// Keys a warp of the cluster path holds: an even count, so that every
// warp's slot of region + 2 keys starts 16-byte aligned.
int region_of(long long n) {
  constexpr long long kWarpsAll = static_cast<long long>(kCluster) * kWarps;
  const long long r = (n + kWarpsAll - 1) / kWarpsAll;
  return static_cast<int>(r + (r & 1));
}

int cluster_smem(long long n) {
  return (kWarps * (region_of(n) + 2) + kGather) *
         static_cast<int>(sizeof(unsigned long long));
}

// The cluster path: launch, or, with clusters != nullptr, write
// cudaOccupancyMaxActiveClusters of that launch instead. Returns the
// cudaError_t.
int select_cluster(const double* rows, long long k, const double* seg,
                   long long m, int lanes, long long r0, long long r1,
                   double* out, cudaStream_t stream, int* clusters) {
  if (k + m > kClusterCap) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(lanes) * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreadsC, 1, 1);
  cfg.dynamicSmemBytes = cluster_smem(k + m);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        clusters, sim_select_cluster_kernel, &cfg));
  err = cudaLaunchKernelEx(&cfg, sim_select_cluster_kernel, rows, k, seg, m,
                           r0, r1, region_of(k + m), out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int select_stream(const double* rows, long long k, const double* seg,
                  long long m, int lanes, long long r0, long long r1,
                  double* out, cudaStream_t stream) {
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  sim_select_stream_kernel<<<lanes, kThreads,
                             kCap * sizeof(unsigned long long), stream>>>(
      rows, k, seg, m, r0, r1, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: lanes x k float64; seg: m float64 (any pointer when m is 0);
// 0 <= r0 <= r1 < k + m < 2^32; out: lanes x 2 float64, the values of
// ranks r0 and r1 in each row's multiset with the segment. One launch:
// the cluster path when k + m <= kClusterCap, else the stream path.
extern "C" int sim_select(const void* rows, long long k, const void* seg,
                          long long m, int lanes, long long r0, long long r1,
                          void* out, void* stream) {
  if (lanes <= 0) return 0;
  const double* r = static_cast<const double*>(rows);
  const double* s = static_cast<const double*>(seg);
  double* o = static_cast<double*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k + m <= kClusterCap)
    return select_cluster(r, k, s, m, lanes, r0, r1, o, st, nullptr);
  return select_stream(r, k, s, m, lanes, r0, r1, o, st);
}

// The launch sim_select makes for these sizes: path 1 (cluster) or 0
// (stream), its CTAs a candidate, their dynamic shared memory in bytes,
// and the clusters (cluster path) or CTAs (stream path) of it that the
// device holds at once. Returns the cudaError_t.
extern "C" int sim_select_plan(long long k, long long m, int lanes,
                               int* path, int* cluster, int* smem,
                               int* resident) {
  if (k + m <= kClusterCap) {
    *path = 1;
    *cluster = kCluster;
    *smem = cluster_smem(k + m);
    return select_cluster(nullptr, k, nullptr, m, lanes > 0 ? lanes : 1, 0,
                          0, nullptr, nullptr, resident);
  }
  *path = 0;
  *cluster = 1;
  *smem = kCap * static_cast<int>(sizeof(unsigned long long));
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sim_select_stream_kernel, kThreads, *smem);
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *resident = per_sm * sms;
  return static_cast<int>(rc);
}

