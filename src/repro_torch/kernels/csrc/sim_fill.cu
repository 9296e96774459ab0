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
// FMA, and the two adds are written __dadd_rn all the same. Maxima and
// minima are the numpy fill's own ternaries (`r0 if r0 > f else f`),
// not fmax/fmin.
//
// What bounds it on the H100: neither bytes nor operations, but the
// length of each lane's chain of dependent steps. A lane's batches
// follow one another: batch j starts when the pool's earliest free
// replica and the head of the queue allow, which needs batch j-1's
// completion in the pool. So a lane is one thread, and the grid's
// parallelism is its candidate count: a 1200-candidate sweep runs 1200
// threads, well under 1 % of the 270,336 the card's 132 SMs hold. The
// least time by the bytes rule (the (C, k) float64 completions written
// once, the queue read once) is a fraction of a millisecond; the kernel
// takes what its longest lane's steps take. Lanes are laid out by the
// caller in order of expected step count, so a warp's lanes end near
// together.
//
// Design. The scan's sorted replica buffer carries over: the pool of a
// lane is its own row of a global scratch array (any replica count, no
// cap), kept sorted, so the minimum is slot 0, and a completion replaces
// it by shifting the smaller entries one slot left and writing it at its
// rank, count(free < end) - 1. Every lane reads the one sorted queue
// through the read-only path; the batch boundary is the count of queued
// arrivals at or before the start, within the batch limit, which on a
// sorted queue is the first arrival past it. Each lane writes the
// completion of every query, in sorted-queue order, to its row of the
// (C, k) output, so the host needs no expansion of (end, count) pairs;
// with a batch buffer it also writes the batch sizes (single fills).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerBlock = 32;
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

// Pop the minimum of a sorted pool and push `end`: the entries below
// `end` move one slot left and `end` takes the last of their slots. A
// pool whose minimum is not below `end` holds an equal value there and
// stays as it is (the scan's rank -1).
__device__ __forceinline__ void replace_min(double* __restrict__ pool, int cap,
                                            double end) {
  if (!(pool[0] < end)) return;
  int j = 1;
  while (j < cap && pool[j] < end) {
    pool[j - 1] = pool[j];
    ++j;
  }
  pool[j - 1] = end;
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

__global__ void __launch_bounds__(kLanesPerBlock)
sim_fill_static_kernel(const double* __restrict__ ready, long long k,
                       const double* __restrict__ luts, int lut_stride,
                       const int64_t* __restrict__ eff,
                       const double* __restrict__ timeout,
                       double* __restrict__ pools, int pool_cap, int lanes,
                       double* __restrict__ done,
                       int64_t* __restrict__ batches,
                       int64_t* __restrict__ n_batches) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const double* lut = luts + static_cast<size_t>(lane) * lut_stride;
  const long long b_max = eff[lane];
  const double timeout_s = timeout[lane];
  double* pool = pools + static_cast<size_t>(lane) * pool_cap;
  double* out = done + static_cast<size_t>(lane) * k;
  int64_t* bout = batches ? batches + static_cast<size_t>(lane) * k : nullptr;
  long long ptr = 0, nb = 0;
  // every step takes at least the head of the queue (the start is never
  // before it), so k steps bound the loop
  for (long long step = 0; step < k && ptr < k; ++step) {
    double start;
    const long long hi = form(ready, k, ptr, b_max, timeout_s, pool[0],
                              &start);
    const double end = __dadd_rn(start, __ldg(lut + (hi - ptr)));
    for (long long i = ptr; i < hi; ++i) out[i] = end;
    if (bout) bout[nb] = hi - ptr;
    ++nb;
    ptr = hi;
    replace_min(pool, pool_cap, end);
  }
  if (n_batches) n_batches[lane] = nb;
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

}  // namespace

// ready: k + eff_max float64, +inf past the queue; luts: lanes rows of
// lut_stride float64; eff: lanes int64; timeout: lanes float64; pools:
// lanes rows of pool_cap float64 (each sorted: 0 for each replica, +inf
// after), updated in place; done: lanes x k float64. batches (lanes x k
// int64) and n_batches (lanes int64) may both be null.
extern "C" int sim_fill_static(const void* ready, long long k,
                               const void* luts, int lut_stride,
                               const void* eff, const void* timeout,
                               void* pools, int pool_cap, int lanes,
                               void* done, void* batches, void* n_batches,
                               void* stream) {
  if (lanes <= 0 || k <= 0) return 0;
  const int blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  sim_fill_static_kernel<<<blocks, kLanesPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(ready), k, static_cast<const double*>(luts),
      lut_stride, static_cast<const int64_t*>(eff),
      static_cast<const double*>(timeout), static_cast<double*>(pools),
      pool_cap, lanes, static_cast<double*>(done),
      static_cast<int64_t*>(batches), static_cast<int64_t*>(n_batches));
  return static_cast<int>(cudaGetLastError());
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
