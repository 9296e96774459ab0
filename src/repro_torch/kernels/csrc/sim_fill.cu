// The planner's FIFO fill: one stage's batch-boundary recurrence over a
// sorted input queue, for a grid of candidate (LUT, batch, replicas,
// timeout) lanes over a static replica pool, or for one lane whose pool
// grows and shrinks with (t, +1/-1) replica events.
//
// Replaces the reference's device code for the planner sweep, which is
// XLA, not Pallas: src/repro/sim/jax_backend.py _static_fill_core (a
// lax.scan vmapped over candidates in _grid_seg_fn) and _dynamic_fill_fn
// (the scan with in-step event application). Both are bit-identical to
// the numpy fill (repro_torch.sim.queueing._FifoFill); so is this file.
// The recurrence only compares, takes maxima and minima, and adds, all
// in float64: there is no product for the compiler to contract into an
// FMA, and the adds are written __dadd_rn all the same. Maxima and
// minima are the numpy fill's own ternaries (`r0 if r0 > f else f`),
// not fmax/fmin.
//
// What bounds it on the H100: neither bytes nor operations, but the
// length of each lane's chain of dependent steps. A lane's batches
// follow one another: batch j starts when the pool's earliest free
// replica and the head of the queue allow, which needs batch j-1's
// completion in the pool. The least time by the bytes rule (the (C, k)
// float64 outputs written once, the queue read once) is a fraction of a
// millisecond; the kernel takes what its longest lane's steps take, so
// the design shortens a step.
//
// Design of the static fill: a warp a lane (candidate). Its pool, kept
// sorted, lives in registers, one slot a thread, when it has at most 32
// replicas: the minimum is lane 0's slot, a completion's rank is
// popc(ballot(slot < end)) - 1 and the shift one __shfl_down_sync, and
// the next minimum is min(second slot, end), known before the shift
// lands. A larger pool lives in the warp's shared memory (the same
// rank, counted 32 slots at a time). The LUT is copied to shared
// memory. The batch boundary, the first arrival past the start within
// the batch limit, is a ballot and __ffs over the queue: where every
// batch limit is at most 32 (the planner's grids), the warp holds the
// queue in registers, two windows of 32 queries, and loads the window
// after next when the queue moves past one, so that no step waits on
// memory, and writes the completions, or in the grid path their
// latencies, a window of 32 at a time in one coalesced store; else each
// step loads ready[ptr, ptr + 32) (an eff of 128 takes up to four
// loads) and stores its batch's outputs. 1200 candidates are 38,400
// threads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kRegSlots = 32;         // pools up to this size in registers
constexpr int kWinLimit = 32;         // batch limits up to this: windows
constexpr long long kMaxQueries = (1ll << 31) - 65;   // 32-bit indices
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;   // a block's dynamic shared memory
constexpr double kFarFuture = 1e18;   // repro_torch.sim.queueing._FAR_FUTURE

// One past the last queued arrival in [ptr, limit) at or before t: the
// numpy fill's _fill_boundary on a sorted queue.
__device__ __forceinline__ long long boundary(const double* __restrict__ ready,
                                              long long ptr, long long limit,
                                              double t) {
  long long i = ptr;
  while (i < limit && __ldg(ready + i) <= t) ++i;
  return i;
}

// Batch formation at the pool's minimum f: the start, the boundary, and
// the optional formation-timeout hold (a batch that cannot fill now
// waits until it fills or its head has waited timeout_s).
__device__ __forceinline__ long long form(const double* __restrict__ ready,
                                          long long k, long long ptr,
                                          long long eff, double timeout_s,
                                          double f, double* start_out) {
  const double r0 = __ldg(ready + ptr);
  double start = r0 > f ? r0 : f;
  const long long full = ptr + eff;
  const long long limit = full < k ? full : k;
  long long hi = boundary(ready, ptr, limit, start);
  if (timeout_s > 0.0 && hi < limit) {
    const double hold_until = __dadd_rn(r0, timeout_s);
    if (hold_until > start) {
      const double fill_t = full - 1 < k ? __ldg(ready + full - 1)
                                         : kFarFuture;
      const double held = fill_t > start ? fill_t : start;
      start = hold_until < held ? hold_until : held;
      hi = boundary(ready, ptr, limit, start);
    }
  }
  *start_out = start;
  return hi;
}

// Insert t into a sorted pool of n entries (n < cap) after every entry
// below it.
__device__ __forceinline__ void insert_sorted(double* __restrict__ pool,
                                              long long n, double t) {
  long long j = n;
  while (j > 0 && !(pool[j - 1] < t)) {
    pool[j] = pool[j - 1];
    --j;
  }
  pool[j] = t;
}

// The warp's form of `boundary`: the first index of [ptr, limit) whose
// arrival is not at or before t, else limit. `win` is this thread's
// ready[ptr + l], loaded by the caller; the next windows of 32 are
// loaded here. Exact for any queue: the linear walk stops at the first
// such index, and __ffs takes the lowest set lane.
__device__ __forceinline__ int warp_boundary(const double* __restrict__ ready,
                                             int ptr, int limit, double t,
                                             double win, int l) {
  unsigned m = __ballot_sync(kFull, ptr + l < limit && !(win <= t));
  if (m) return ptr + __ffs(m) - 1;
  for (int base = ptr + 32; base < limit; base += 32) {
    const bool in = base + l < limit;
    const double v = in ? __ldg(ready + base + l) : 0.0;
    m = __ballot_sync(kFull, in && !(v <= t));
    if (m) return base + __ffs(m) - 1;
  }
  return limit;
}

// The latency of a query that completes at `end`: np.maximum(base_last,
// end), numpy's (a >= b || isnan(a)) ? a : b, less the arrival, plus
// rpc, in numpy's order of operations.
__device__ __forceinline__ double latency(double base_last, double arrival,
                                          double end, double rpc) {
  const double last = (base_last >= end || isnan(base_last)) ? base_last
                                                              : end;
  return __dadd_rn(__dsub_rn(last, arrival), rpc);
}

// kRegs: the pool in registers (pool_cap <= 32), else in shared memory.
// kWin: every lane's batch limit is at most 32, and the warp keeps the
// queue (and the latency inputs) in registers, two windows of 32
// queries from wbase: a step reads none of them from memory, and the
// window after next is loaded when the queue moves past the first,
// long before a step needs it. A step only notes each of its queries'
// completion in the thread that holds it; the warp writes a window's 32
// outputs in one store once the queue has moved past it. Else each step
// loads its window and writes its batch.
// kLatency: write each query's latency, else its completion `end`.
// Indices are 32-bit (the wrapper holds k below 2^31 - 64): a step is one
// chain of dependent instructions, and the card issues a warp's in
// order, so the step is written with as few of them, and as few
// branches, as it can be.
template <bool kRegs, bool kWin, bool kLatency>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sim_fill_static_kernel(const double* __restrict__ ready, int k,
                       const double* __restrict__ luts, int lut_stride,
                       const int64_t* __restrict__ eff,
                       const double* __restrict__ timeout,
                       double* __restrict__ pools, int pool_cap, int lanes,
                       double* __restrict__ out,
                       int64_t* __restrict__ batches,
                       int64_t* __restrict__ n_batches,
                       const double* __restrict__ base_last,
                       const double* __restrict__ arrivals, double rpc) {
  extern __shared__ double smem[];
  const int w = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const int lane = blockIdx.x * (blockDim.x >> 5) + w;
  if (lane >= lanes) return;          // a whole warp: no block barrier
  const int per_warp = lut_stride + (kRegs ? 0 : pool_cap);
  double* lut = smem + static_cast<size_t>(w) * per_warp;
  double* pool = lut + lut_stride;    // the shared pool (kRegs false)
  const double* lut_g = luts + static_cast<size_t>(lane) * lut_stride;
  for (int i = l; i < lut_stride; i += 32) lut[i] = lut_g[i];
  double* pool_g = pools + static_cast<size_t>(lane) * pool_cap;
  double slot = INFINITY;             // this thread's slot (kRegs)
  if constexpr (kRegs) {
    if (l < pool_cap) slot = pool_g[l];
  } else {
    for (int i = l; i < pool_cap; i += 32) pool[i] = pool_g[i];
  }
  __syncwarp();
  // the pool's least and (kRegs) second-least free times
  double f = kRegs ? __shfl_sync(kFull, slot, 0) : pool[0];
  double f2 = kRegs ? __shfl_sync(kFull, slot, 1) : 0.0;
  const int b_max = static_cast<int>(eff[lane]);
  const double timeout_s = timeout[lane];
  double* row = out + static_cast<size_t>(lane) * k;
  int64_t* brow = batches ? batches + static_cast<size_t>(lane) * k
                          : nullptr;
  // the two windows (kWin): this thread's query wbase + l of the first,
  // wbase + 32 + l of the second; past the queue, +inf
  int wbase = 0;
  double c_r = INFINITY, c_b = 0.0, c_a = 0.0, c_e = 0.0;
  double n_r = INFINITY, n_b = 0.0, n_a = 0.0, n_e = 0.0;
  // a window's outputs: each thread's query, if it is before `upto`
  auto flush = [&](int base, double b, double a, double e, int upto) {
    if (base + l < upto) row[base + l] = kLatency ? latency(b, a, e, rpc) : e;
  };
  auto load = [&](int i, double& r, double& b, double& a) {
    r = i < k ? __ldg(ready + i) : INFINITY;
    if constexpr (kLatency) {
      b = i < k ? __ldg(base_last + i) : 0.0;
      a = i < k ? __ldg(arrivals + i) : 0.0;
    }
  };
  if constexpr (kWin) {
    load(l, c_r, c_b, c_a);
    load(32 + l, n_r, n_b, n_a);
  }
  int ptr = 0, nb = 0;
  // every step takes at least the head of the queue (the start is never
  // before it), so k steps bound the loop
  for (int step = 0; step < k && ptr < k; ++step) {
    const int full = ptr + b_max;
    const int limit = full < k ? full : k;
    double r0;
    double bl = 0.0, arr = 0.0;       // this thread's query ptr + l (!kWin)
    unsigned c_mask = 0, n_mask = 0;  // [ptr, limit) in the windows (kWin)
    if constexpr (kWin) {
      // a step moves the queue at most 32 on, so one move of the windows
      // keeps ptr in the first
      if (ptr >= wbase + 32) {
        flush(wbase, c_b, c_a, c_e, ptr);
        wbase += 32;
        c_r = n_r;
        c_b = n_b;
        c_a = n_a;
        c_e = n_e;
        load(wbase + 32 + l, n_r, n_b, n_a);
      }
      const int lo = ptr - wbase;
      const int lim = limit - wbase;
      c_mask = (kFull << lo) & (lim >= 32 ? kFull : ~(kFull << lim));
      n_mask = lim > 32 ? ~(kFull << (lim - 32)) : 0u;
      r0 = __shfl_sync(kFull, c_r, lo);
    } else {
      const bool in = ptr + l < limit;
      c_r = in ? __ldg(ready + ptr + l) : 0.0;
      if constexpr (kLatency) {
        if (in) {
          bl = __ldg(base_last + ptr + l);
          arr = __ldg(arrivals + ptr + l);
        }
      }
      r0 = __ldg(ready + ptr);
    }
    // the first query of [ptr, limit) that arrives after t, else limit
    auto boundary_at = [&](double t) -> int {
      if constexpr (kWin) {
        const unsigned long long m =
            (__ballot_sync(kFull, !(c_r <= t)) & c_mask) |
            (static_cast<unsigned long long>(
                 __ballot_sync(kFull, !(n_r <= t)) & n_mask) << 32);
        return m ? wbase + __ffsll(m) - 1 : limit;
      } else {
        return warp_boundary(ready, ptr, limit, t, c_r, l);
      }
    };
    double start = r0 > f ? r0 : f;
    int hi = boundary_at(start);
    if (timeout_s > 0.0 && hi < limit) {
      const double hold_until = __dadd_rn(r0, timeout_s);
      if (hold_until > start) {
        double fill_t = kFarFuture;
        if constexpr (kWin) {
          const int j = full - 1 - wbase;
          const double v = __shfl_sync(kFull, j < 32 ? c_r : n_r, j & 31);
          if (full - 1 < k) fill_t = v;
        } else {
          if (full - 1 < k) fill_t = __ldg(ready + full - 1);
        }
        const double held = fill_t > start ? fill_t : start;
        start = hold_until < held ? hold_until : held;
        hi = boundary_at(start);
      }
    }
    const double end = __dadd_rn(start, lut[hi - ptr]);
    // pop the minimum and push `end`: the slots below `end` move one
    // left and `end` takes the last of them. A pool whose minimum is not
    // below `end` holds an equal value there and stays as it is (the
    // scan's rank -1, which moves no slot here).
    if constexpr (kRegs) {
      const int p = __popc(__ballot_sync(kFull, slot < end)) - 1;
      const double up = __shfl_down_sync(kFull, slot, 1);
      slot = l < p ? up : (l == p ? end : slot);
      f = f < end ? (f2 < end ? f2 : end) : f;
      f2 = __shfl_sync(kFull, slot, 1);
    } else if (f < end) {
      int below = 0;
      for (int c = 0; c < pool_cap; c += 32) {
        const unsigned m = __ballot_sync(
            kFull, c + l < pool_cap && pool[c + l] < end);
        below += __popc(m);
        if (m != kFull) break;        // sorted: no later slot is below
      }
      const int p = below - 1;
      for (int c = 0; c < p; c += 32) {
        const int i = c + l;
        const double v = i < p ? pool[i + 1] : 0.0;
        __syncwarp();
        if (i < p) pool[i] = v;
        __syncwarp();
      }
      if (l == 0) pool[p] = end;
      __syncwarp();
      f = pool[0];
    }
    // the batch's outputs: noted in the windows, or contiguous stores
    if constexpr (kWin) {
      const int lo = ptr - wbase;
      const int h = hi - wbase;
      c_e = l >= lo && l < h ? end : c_e;
      n_e = l + 32 < h ? end : n_e;
    } else {
      for (int base = ptr; base < hi; base += 32) {
        const int i = base + l;
        if (i < hi) {
          if constexpr (kLatency) {
            double b = bl, a = arr;
            if (base != ptr) {
              b = __ldg(base_last + i);
              a = __ldg(arrivals + i);
            }
            row[i] = latency(b, a, end, rpc);
          } else {
            row[i] = end;
          }
        }
      }
    }
    if (brow && l == 0) brow[nb] = hi - ptr;
    ++nb;
    ptr = hi;
  }
  if constexpr (kWin) {
    flush(wbase, c_b, c_a, c_e, ptr);
    flush(wbase + 32, n_b, n_a, n_e, ptr);
  }
  if (n_batches && l == 0) n_batches[lane] = nb;
  if constexpr (kRegs) {
    if (l < pool_cap) pool_g[l] = slot;
  } else {
    for (int i = l; i < pool_cap; i += 32) pool_g[i] = pool[i];
  }
}

// One lane, one thread: each iteration is one step of the numpy fill's
// run_dynamic (and of the scan's _dynamic_fill_fn): fast-forward to the
// next event when the pool is empty, give the rest of the queue
// _FAR_FUTURE when no event will ever add a replica, or pop the minimum,
// apply the events up to the dispatch instant, retire the popped replica
// if a removal is pending by then (removals retire in the order of their
// event times, rem_t), else serve one batch. Events are unit-expanded.
// The pool has room for every replica the events can add.
__global__ void __launch_bounds__(1)
sim_fill_dynamic_kernel(const double* __restrict__ ready, long long k,
                        const double* __restrict__ lut, long long b_max,
                        double timeout_s, double* __restrict__ pool,
                        long long n_free, const double* __restrict__ ev_t,
                        const int64_t* __restrict__ ev_d, long long m,
                        const double* __restrict__ rem_t, long long trips,
                        double* __restrict__ done,
                        int64_t* __restrict__ batches,
                        int64_t* __restrict__ n_batches) {
  long long ptr = 0, ev_i = 0, rem_app = 0, rem_ret = 0, nb = 0;
  auto apply_events = [&](double bound) {
    while (ev_i < m && ev_t[ev_i] <= bound) {
      if (ev_d[ev_i] > 0) {
        insert_sorted(pool, n_free, ev_t[ev_i]);
        ++n_free;
      } else {
        ++rem_app;
      }
      ++ev_i;
    }
  };
  for (long long trip = 0; trip < trips && ptr < k; ++trip) {
    if (n_free == 0) {
      if (ev_i < m) {
        apply_events(ev_t[ev_i]);
        continue;
      }
      for (long long i = ptr; i < k; ++i) done[i] = kFarFuture;
      ptr = k;
      break;
    }
    const double f = pool[0];
    for (long long j = 1; j < n_free; ++j) pool[j - 1] = pool[j];
    --n_free;
    const double r0 = __ldg(ready + ptr);
    const double dispatch = r0 > f ? r0 : f;
    apply_events(dispatch);
    if (rem_ret < rem_app && rem_t[rem_ret] <= dispatch) {
      ++rem_ret;
      continue;
    }
    double start;
    const long long hi = form(ready, k, ptr, b_max, timeout_s, f, &start);
    const double end = __dadd_rn(start, lut[hi - ptr]);
    for (long long i = ptr; i < hi; ++i) done[i] = end;
    batches[nb++] = hi - ptr;
    ptr = hi;
    insert_sorted(pool, n_free, end);
    ++n_free;
  }
  *n_batches = nb;
}

template <bool kRegs, bool kWin, bool kLatency>
cudaError_t launch_static(const void* ready, long long k, const void* luts,
                          int lut_stride, const void* eff,
                          const void* timeout, void* pools, int pool_cap,
                          int lanes, void* out, void* batches,
                          void* n_batches, const void* base_last,
                          const void* arrivals, double rpc,
                          cudaStream_t stream) {
  const size_t per_warp = sizeof(double) *
      (static_cast<size_t>(lut_stride) + (kRegs ? 0 : pool_cap));
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * per_warp > kMaxSmem) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = sim_fill_static_kernel<kRegs, kWin, kLatency>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int blocks = (lanes + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, stream>>>(
      static_cast<const double*>(ready), static_cast<int>(k),
      static_cast<const double*>(luts), lut_stride,
      static_cast<const int64_t*>(eff), static_cast<const double*>(timeout),
      static_cast<double*>(pools), pool_cap, lanes, static_cast<double*>(out),
      static_cast<int64_t*>(batches), static_cast<int64_t*>(n_batches),
      static_cast<const double*>(base_last),
      static_cast<const double*>(arrivals), rpc);
  return cudaGetLastError();
}

}  // namespace

// ready: k + eff_max float64, +inf past the queue; luts: lanes rows of
// lut_stride float64; eff: lanes int64; timeout: lanes float64; pools:
// lanes rows of pool_cap float64 (each sorted: 0 for each replica, +inf
// after), updated in place; out: lanes x k float64. batches (lanes x k
// int64) and n_batches (lanes int64) may both be null. With base_last
// and arrivals (k float64 each, in sorted-queue order) out receives each
// query's latency, else its completion.
extern "C" int sim_fill_static(const void* ready, long long k,
                               const void* luts, int lut_stride,
                               const void* eff, const void* timeout,
                               void* pools, int pool_cap, int lanes,
                               void* out, void* batches, void* n_batches,
                               const void* base_last, const void* arrivals,
                               double rpc, void* stream) {
  if (lanes <= 0 || k <= 0) return 0;
  if (k > kMaxQueries) return static_cast<int>(cudaErrorInvalidValue);
  const bool regs = pool_cap <= kRegSlots;
  const bool win = lut_stride - 1 <= kWinLimit;
  const bool latency = base_last != nullptr;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_FILL_LAUNCH(R, W, L)                                         \
  launch_static<R, W, L>(ready, k, luts, lut_stride, eff, timeout, pools,  \
                         pool_cap, lanes, out, batches, n_batches,         \
                         base_last, arrivals, rpc, s)
#define REPRO_FILL_LAUNCH_RW(R, W)                                         \
  (latency ? REPRO_FILL_LAUNCH(R, W, true) : REPRO_FILL_LAUNCH(R, W, false))
  const cudaError_t rc =
      regs ? (win ? REPRO_FILL_LAUNCH_RW(true, true)
                  : REPRO_FILL_LAUNCH_RW(true, false))
           : (win ? REPRO_FILL_LAUNCH_RW(false, true)
                  : REPRO_FILL_LAUNCH_RW(false, false));
#undef REPRO_FILL_LAUNCH_RW
#undef REPRO_FILL_LAUNCH
  return static_cast<int>(rc);
}

// pool: room for every replica the events can add, sorted, its first
// n_free entries the initial replicas' 0; ev_t/ev_d: m unit events;
// rem_t: the removal events' times in order; done: k float64; batches:
// k int64; n_batches: one int64.
extern "C" int sim_fill_dynamic(const void* ready, long long k,
                                const void* lut, long long eff,
                                double timeout_s, void* pool, long long n_free,
                                const void* ev_t, const void* ev_d,
                                long long m, const void* rem_t,
                                long long trips, void* done, void* batches,
                                void* n_batches, void* stream) {
  if (k <= 0) return 0;
  sim_fill_dynamic_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(ready), k, static_cast<const double*>(lut),
      eff, timeout_s, static_cast<double*>(pool), n_free,
      static_cast<const double*>(ev_t), static_cast<const int64_t*>(ev_d), m,
      static_cast<const double*>(rem_t), trips, static_cast<double*>(done),
      static_cast<int64_t*>(batches), static_cast<int64_t*>(n_batches));
  return static_cast<int>(cudaGetLastError());
}
