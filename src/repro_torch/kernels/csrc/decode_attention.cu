// Decode attention: one query token per sequence against a KV cache,
// with grouped KV heads, split across the CTAs of a thread-block cluster
// (flash-decoding with the combine inside the cluster).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (_decode_kernel): the G = H / KV query heads of a GQA
// group share one kv head; only the first valid_len cache slots count,
// and with window > 0 only the last `window` of them ((valid_len - 1 -
// k_pos) < window); online softmax in f32; output in q's type.
//
// Layouts (all contiguous): q (B, 1, H, D), k (B, Smax, KV, D),
// v (B, Smax, KV, Dv) -- the cache's own layout, read where it lies (the
// TPU wrapper's swapaxes would copy the cache on every step) --
// out (B, 1, H, Dv). D, Dv <= 128 and multiples of 8; any G.
//
// What bounds it on the H100: bytes. Each call reads 2 * B * (valid_len
// - lo) * KV * D * itemsize of cache: 33.6 MB at the served shape (B 8,
// 1024 slots, 32/8 heads, D 64, f32), 10.0 us at 3.35 TB/s. Its 4 FLOP
// per (head, key, dim) are 67 MFLOP there, 1.0 us at the 67 TFLOP/s of
// f32 FMA. A single TF32 tensor-core pass would miss the repo's 2e-5 f32
// bar, and the products are a tenth of the bound, so the arithmetic is
// f32 FMA on the CUDA cores. On the card the FMAs still cost about as
// much as the copies (PERF.md): what they cost is the instructions and
// shared-memory reads that feed them and the latency of their shuffles,
// so the design keeps q in registers, reads each K and V byte from
// shared memory once per CTA, and reduces across lanes as little as the
// online softmax allows.
//
// Design.
// - One launch. The grid is (splits, KV x head_groups, B) and the
//   cluster (splits, 1, 1), splits <= 8 (the portable cluster size). CTA
//   `rank` of a cluster walks `chunk` keys of [lo, valid_len) for up to
//   4 q heads of one kv head's group (head_groups = ceil(G / 4) CTAs
//   share a kv head and read its K/V mostly from L2; 4 heads of q fill 64
//   registers a lane, and 8 heads a CTA measured no faster). Its partial
//   (m, l, acc) per head stays in its own shared memory. After
//   cluster.sync(), rank r combines heads r, r + splits, ... reading
//   every peer's partial through distributed shared memory: it rescales
//   by 2^(m_i - max m), divides, and writes out. A second cluster.sync()
//   keeps each CTA alive until its peers have read it. No global
//   scratch, no second kernel.
// - A cp.async ring of 3 stages in the input type (bf16 tiles take half
//   the bytes): tiles n + 1 and n + 2 are in flight while tile n is
//   scored, 2 x 16 KB per CTA in f32, with up to 4 CTAs an SM (deeper
//   rings measured no faster). Each warp copies and reads only its own
//   rows of a tile, so the walk has no block-wide barrier. The masked
//   tail of a chunk is zero-filled by cp.async's src-size operand, so no
//   slot at or past valid_len is read. Each lane copies fixed 16-byte
//   columns, so a tile costs it a few adds a copy.
// - Two width classes, W = 64 and 128 (D, Dv <= W). Warp w scores keys
//   KPW w .. KPW w + KPW - 1 of each tile, LPK lanes a key (W 64: 8 keys
//   of a 32-key tile, 4 lanes a key; W 128: 4 keys of a 16-key tile, 8
//   lanes a key), each lane a 1/LPK share of the row's 16-byte chunks
//   against the 4 heads' q, which the lane holds in registers (64 f32).
//   Halving shuffles (a reduce-scatter) leave part j of a key with the
//   whole dot of head j % 4, so each lane runs the online softmax of one
//   head: the max shared across the warp's keys, the sum per key slot
//   until the end, exp2 of log2-scaled scores (one MUFU op). For the PV
//   product a lane holds W / 32 output dims of every head, takes the
//   heads' rescale factors by shuffles and reads each key's 4 p values
//   with one broadcast load.
// - Shared-memory rows are padded to whole 128-byte lines and their
//   16-byte chunks XOR-swizzled by row parity (chunk c of row r sits at
//   c ^ 4 (r & 1)): the 16-byte async writes stay whole, and the score
//   reads (a quarter-warp reads 4 chunks of two neighbouring rows, or 8
//   of one) and the V reads (a warp reads one row) are free of bank
//   conflicts.
// - valid_len comes as a host int: no device-to-host copy, and Smax has
//   no divisibility rule. A row with no key gives 0, as the plain
//   version does (the TPU kernel floors l at 1e-30 instead).
// - cudaFuncSetAttribute runs once per template instance and device.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;       // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 4;           // q heads per CTA
constexpr int kStages = 3;
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// The geometry of one (storage type, width class W) instance: D and Dv
// are at most W.
template <typename T, int W>
struct Geo {
  static constexpr int kLanesPerKey = W == 64 ? 4 : 8;
  static constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  static constexpr int kTile = kWarps * kKeysPerWarp;     // keys a stage
  static constexpr int kVE = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int kRowChunks = W * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kLaneChunks = kRowChunks / kLanesPerKey;
  static constexpr int kEPL = W / 32;                      // out dims a lane
  // shared-memory row: whole 128-byte lines
  static constexpr int kPitch = (kRowChunks > 8 ? kRowChunks : 8) * 16;
  static constexpr int kPBytes = kTile * kHeads * 4;       // p per key
  static constexpr int kStageBytes = 2 * kTile * kPitch;   // K rows, V rows
  static constexpr int kPartFloats = W + 4;                // m, l, 0, 0, acc
  static constexpr int kPartBytes = (kWarps + 1) * kHeads * kPartFloats * 4;
  static constexpr int kRingBytes = kStages * kStageBytes > kPartBytes
                                        ? kStages * kStageBytes
                                        : kPartBytes;
  static constexpr int kSmem = kPBytes + kRingBytes;
};

__device__ __forceinline__ int swizzle(int row) { return (row & 1) << 2; }

// 2^x in one MUFU instruction (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with valid false it reads nothing and
// writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16 bytes of one chunk as f32 values: 4 floats, or 8 bf16 (a bf16
// is the high half of the f32 of the same value).
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// EPL consecutive values of type T at p (EPL * sizeof(T) <= 16 bytes,
// aligned to its size) as f32.
template <typename T, int EPL>
__device__ __forceinline__ void load_vals(const unsigned char* p,
                                          float* out) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (EPL == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
    } else {
      const float2 f = *reinterpret_cast<const float2*>(p);
      out[0] = f.x; out[1] = f.y;
    }
  } else {
    if constexpr (EPL == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      out[0] = __uint_as_float(u.x << 16);
      out[1] = __uint_as_float(u.x & 0xffff0000u);
      out[2] = __uint_as_float(u.y << 16);
      out[3] = __uint_as_float(u.y & 0xffff0000u);
    } else {
      const unsigned u = *reinterpret_cast<const unsigned*>(p);
      out[0] = __uint_as_float(u << 16);
      out[1] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

// grid (splits, KV * groups, B), cluster (splits, 1, 1).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 4)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int smax,
                        int h, int kvh, int d, int dv, int lo, int hi,
                        int chunk, int groups, float scale) {
  using G = Geo<T, W>;
  constexpr int LPK = G::kLanesPerKey, KPW = G::kKeysPerWarp;
  constexpr int TILE = G::kTile, VE = G::kVE, EPL = G::kEPL;
  constexpr int PS = G::kPartFloats;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sP = reinterpret_cast<float*>(smem);  // TILE keys x kHeads
  unsigned char* ring = smem + G::kPBytes;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int kh = blockIdx.y / groups, grp = blockIdx.y - kh * groups;
  const int bb = blockIdx.z;
  const int g_heads = h / kvh;
  const int hpg = (g_heads + groups - 1) / groups;  // heads per group
  const int head0 = kh * g_heads + grp * hpg;       // first q head here
  const int gc = min(hpg, g_heads - grp * hpg);     // heads here, 1 .. 4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kc = d * static_cast<int>(sizeof(T)) / 16;   // chunks of a K row
  const int vc = dv * static_cast<int>(sizeof(T)) / 16;  // ... of a V row
  const int s0 = lo + rank * chunk;
  const int s1 = min(hi, s0 + chunk);
  const int ntiles = s1 > s0 ? (s1 - s0 + TILE - 1) / TILE : 0;

  // Each warp copies its own KPW rows of every tile, so the warps never
  // wait for each other inside the walk. A lane copies one fixed 16-byte
  // column of those K rows (and one of the V rows), every
  // rows-per-pass-th row: its column, first row and steps are worked out
  // once, and a tile adds only its first slot.
  const size_t k_stride = static_cast<size_t>(kvh) * d;   // slot to slot
  const size_t v_stride = static_cast<size_t>(kvh) * dv;
  const T* kb = k + static_cast<size_t>(bb) * smax * k_stride +
                static_cast<size_t>(kh) * d;
  const T* vb = v + static_cast<size_t>(bb) * smax * v_stride +
                static_cast<size_t>(kh) * dv;
  const int wrow0 = warp * KPW, wrow1 = wrow0 + KPW;  // this warp's rows
  const int k_rows = 32 / kc, v_rows = 32 / vc;
  const int k_col = lane % kc, v_col = lane % vc;
  const int k_row0 = lane < k_rows * kc ? wrow0 + lane / kc : wrow1;
  const int v_row0 = lane < v_rows * vc ? wrow0 + lane / vc : wrow1;
  // src: the tile's first slot in this lane's column (t0 < s1, so a
  // valid address); rows at or past s1 read nothing (that address
  // stands in) and are zero-filled.
  auto load_rows = [&](unsigned char* dst, int col, int row0, int rows,
                       const T* src, size_t stride, int t0) {
    constexpr int kFullRows = 32 / G::kRowChunks;  // rows a pass
    const size_t step = rows * stride;
    const T* p = src + row0 * stride;
    if (rows == kFullRows) {  // a full-width row: a fixed trip count
#pragma unroll
      for (int j = 0; j < KPW / kFullRows; ++j, p += step) {
        const int r = row0 + j * kFullRows;
        const bool ok = t0 + r < s1;
        cp_async16(dst + r * G::kPitch + ((col ^ swizzle(r)) << 4),
                   ok ? p : src, ok);
      }
      return;
    }
    for (int r = row0; r < wrow1; r += rows, p += step) {
      const bool ok = t0 + r < s1;
      cp_async16(dst + r * G::kPitch + ((col ^ swizzle(r)) << 4),
                 ok ? p : src, ok);
    }
  };
  auto load_tile = [&](int tile, int stage) {
    const int t0 = s0 + tile * TILE;
    unsigned char* sk = ring + stage * G::kStageBytes;
    if (k_row0 < wrow1)
      load_rows(sk, k_col, k_row0, k_rows,
                kb + static_cast<size_t>(t0) * k_stride + k_col * VE,
                k_stride, t0);
    if (v_row0 < wrow1)
      load_rows(sk + TILE * G::kPitch, v_col, v_row0, v_rows,
                vb + static_cast<size_t>(t0) * v_stride + v_col * VE,
                v_stride, t0);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t, t);
    cp_async_commit();
  }

  // While the first tiles are in flight: this lane's share of q, its
  // chunks part, part + LPK, ... of each head, in the log2 domain (heads
  // past gc and chunks past the row are 0).
  const int key = lane / LPK, part = lane % LPK;
  const int row = warp * KPW + key;  // this lane's key in a tile
  float qr[kHeads][G::kLaneChunks * VE];
  const float qscale = scale * kLog2e;
  const T* qg = q + (static_cast<size_t>(bb) * h + head0) * d;
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int i = 0; i < G::kLaneChunks; ++i) {
      const int c = part + i * LPK;
      float f[VE] = {};
      if (g < gc && c < kc)
        unpack(*reinterpret_cast<const uint4*>(qg + g * d + c * VE), f, T());
#pragma unroll
      for (int e = 0; e < VE; ++e) qr[g][i * VE + e] = f[e] * qscale;
    }

  // The softmax state of head `own` = part % 4, which this lane's key
  // slot tracks: the warp's running max m (log2 domain) and the slot's
  // share of the sum l (its keys' p; summed over the slots at the end).
  // And per head, the lane's EPL output dims of the unnormalised
  // accumulator.
  const int own = part % kHeads;
  float m_own = -INFINITY, l_own = 0.f, acc[kHeads][EPL];
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  const bool dv_lane = lane * EPL < dv;
  const int v_byte = lane * EPL * static_cast<int>(sizeof(T));

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // this warp's rows of tile t landed
    __syncwarp();  // ... for every lane, and its rows of t - 1 are done
    if (t + kStages - 1 < ntiles)
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();

    const int t0 = s0 + t * TILE;
    const int wrows = min(KPW, s1 - t0 - warp * KPW);
    if (wrows <= 0) continue;  // warp-uniform: no key of this warp here
    const unsigned char* sk = ring + (t % kStages) * G::kStageBytes;
    const unsigned char* sv = sk + TILE * G::kPitch;

    // scores of this lane's key against the 4 heads, over its chunks
    float s[kHeads] = {};
    const unsigned char* krow = sk + row * G::kPitch;
#pragma unroll
    for (int i = 0; i < G::kLaneChunks; ++i) {
      const int c = part + i * LPK;
      if (c < kc) {
        float kf[VE];
        unpack(*reinterpret_cast<const uint4*>(
                   krow + ((c ^ swizzle(row)) << 4)),
               kf, T());
#pragma unroll
        for (int g = 0; g < kHeads; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            s[g] = fmaf(qr[g][i * VE + e], kf[e], s[g]);
      }
    }

    // The LPK lanes of a key hold partial dots of the 4 heads. Halving
    // exchanges (reduce-scatter) leave lane part with the whole dot of
    // head own: 3 shuffles (4 at LPK 8) where a sum per head takes 8.
    {
      const bool b0 = part & 1, b1 = part & 2;
      float k0 = b0 ? s[1] : s[0], k1 = b0 ? s[3] : s[2];
      k0 += __shfl_xor_sync(0xffffffffu, b0 ? s[0] : s[1], 1);
      k1 += __shfl_xor_sync(0xffffffffu, b0 ? s[2] : s[3], 1);
      s[0] = (b1 ? k1 : k0) +
             __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 2);
#pragma unroll
      for (int off = kHeads; off < LPK; off <<= 1)
        s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);
    }
    // online softmax of head own over the warp's keys; p -> sP, and
    // each head's rescale factor to every lane
    const float x = key < wrows ? s[0] : -INFINITY;
    float mx = x;
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_own, mx);         // finite: wrows >= 1
    const float alpha = fast_exp2(m_own - m_new);  // 0 on the first tile
    const float p = fast_exp2(x - m_new);          // 0 past the keys
    l_own = fmaf(l_own, alpha, p);
    m_own = m_new;
    if (part < kHeads) sP[row * kHeads + own] = p;
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      const float a =
          __shfl_sync(0xffffffffu, alpha, (lane & ~(kHeads - 1)) | g);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= a;
    }
    __syncwarp();

    // acc += p V over the warp's keys (p is 0, and V zero-filled, past
    // the keys); a lane holds dims lane * EPL ...
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) {
      const int r = warp * KPW + kk;
      float vf[EPL] = {};
      if (dv_lane)
        load_vals<T, EPL>(sv + r * G::kPitch +
                              (((v_byte >> 4) ^ swizzle(r)) << 4) +
                              (v_byte & 15),
                          vf);
      const float4 p4 = *reinterpret_cast<const float4*>(sP + r * kHeads);
      const float p[kHeads] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < kHeads; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(p[g], vf[e], acc[g][e]);
    }
  }
  // each key slot holds its share of l: sum over the warp's slots
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
    l_own += __shfl_xor_sync(0xffffffffu, l_own, off);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the partials

  // the four warps' partials W -> the CTA's partial P, in shared memory
  float* Wp = reinterpret_cast<float*>(ring);
  float* P = Wp + kWarps * kHeads * PS;
  if (lane < kHeads) {  // lane g = part g of key 0 holds head g's m, l
    float* wp = Wp + (warp * kHeads + lane) * PS;
    wp[0] = m_own;
    wp[1] = l_own;
  }
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    float* wp = Wp + (warp * kHeads + g) * PS;
    if (dv_lane)
#pragma unroll
      for (int e = 0; e < EPL; ++e) wp[4 + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  if (warp < gc) {  // warp g merges head g
    const int g = warp;
    float mw[kWarps], m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = Wp[(w * kHeads + g) * PS];
      m = fmaxf(m, mw[w]);
    }
    float l = 0.f, a[EPL] = {};
    if (m != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* wp = Wp + (w * kHeads + g) * PS;
        const float wt = fast_exp2(mw[w] - m);
        l = fmaf(wt, wp[1], l);
        if (dv_lane)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            a[e] = fmaf(wt, wp[4 + lane * EPL + e], a[e]);
      }
    }
    float* pp = P + g * PS;
    if (lane == 0) {
      pp[0] = m;
      pp[1] = l;
    }
    if (dv_lane)
#pragma unroll
      for (int e = 0; e < EPL; ++e) pp[4 + lane * EPL + e] = a[e];
  }
  cluster.sync();  // every CTA's P is written and visible to the cluster

  // rank r combines heads r, r + splits, ...: out = sum_i w_i acc_i /
  // sum_i w_i l_i with w_i = 2^(m_i - max_j m_j); no key gives 0
  const int g = rank + splits * warp;
  if (g < gc) {
    const float* pp[kMaxSplits];
    float mp[kMaxSplits], m = -INFINITY;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      pp[p] = cluster.map_shared_rank(P, p < splits ? p : 0) + g * PS;
      mp[p] = p < splits ? pp[p][0] : -INFINITY;
      m = fmaxf(m, mp[p]);
    }
    float l = 0.f, a[EPL] = {};
    if (m != -INFINITY) {
#pragma unroll
      for (int p = 0; p < kMaxSplits; ++p) {
        if (p < splits) {
          const float wt = fast_exp2(mp[p] - m);
          l = fmaf(wt, pp[p][1], l);
          if (dv_lane)
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              a[e] = fmaf(wt, pp[p][4 + lane * EPL + e], a[e]);
        }
      }
    }
    if (dv_lane) {
      T* orow = o + (static_cast<size_t>(bb) * h + head0 + g) * dv +
                lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        orow[e] = repro::from_float<T>(l > 0.f ? a[e] / l : 0.f);
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its P
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int b, smax, h, kvh, d, dv, lo, hi, splits, chunk, groups;
  float scale;
};

// clusters == nullptr: launch; else write the number of clusters of this
// configuration that the device can hold at once. Returns the
// cudaError_t.
template <typename T, int W>
int run(const Args& a, cudaStream_t stream, int* clusters) {
  auto kernel = decode_attention_kernel<T, W>;
  constexpr int kSmem = Geo<T, W>::kSmem;
  static std::once_flag once[kMaxDevices];
  static cudaError_t attr_err[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[dev], [&] {
    attr_err[dev] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  });
  if (attr_err[dev] != cudaSuccess) return static_cast<int>(attr_err[dev]);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.kvh * a.groups, a.b);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q),
                           static_cast<const T*>(a.k),
                           static_cast<const T*>(a.v), static_cast<T*>(a.o),
                           a.smax, a.h, a.kvh, a.d, a.dv, a.lo, a.hi, a.chunk,
                           a.groups, a.scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream, int* clusters) {
  if (a.kvh <= 0 || a.h <= 0 || a.h % a.kvh != 0 || a.groups <= 0 ||
      a.d <= 0 || a.d > 128 || a.dv <= 0 || a.dv > 128 || a.d % 8 ||
      a.dv % 8 || a.lo < 0 || a.lo > a.hi || a.hi > a.smax ||
      a.splits <= 0 || a.splits > kMaxSplits || a.chunk <= 0 ||
      static_cast<long long>(a.splits) * a.chunk < a.hi - a.lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g_heads = a.h / a.kvh;
  const int hpg = (g_heads + a.groups - 1) / a.groups;
  if (hpg > kHeads || (a.groups - 1) * hpg >= g_heads)
    return static_cast<int>(cudaErrorInvalidValue);  // a group > 4 or empty
  if (a.d <= 64 && a.dv <= 64) return run<T, 64>(a, stream, clusters);
  return run<T, 128>(a, stream, clusters);
}

int entry(const Args& a, int dtype, cudaStream_t stream, int* clusters) {
  if (dtype == 0) return dispatch<float>(a, stream, clusters);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, stream, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Keys [lo, hi) count; a cluster of
// `splits` (<= 8) CTAs per (kv head, head group, batch) takes `chunk`
// keys each; `groups` CTAs share a kv head's G q heads, at most 4 each.
// One kernel launch; returns its cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, int dtype,
                                    int b, int smax, int h, int kvh, int d,
                                    int dv, int lo, int hi, int splits,
                                    int chunk, int groups, float scale,
                                    void* stream) {
  if (b <= 0 || h <= 0) return 0;
  const Args a{q, k, v, o, b, smax, h, kvh, d, dv, lo, hi, splits, chunk,
               groups, scale};
  return entry(a, dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// cudaOccupancyMaxActiveClusters of the launch that decode_attention_fwd
// would make with these arguments (b = 1): the clusters of `splits`
// CTAs that the device holds at once. Returns the cudaError_t.
extern "C" int decode_attention_max_clusters(int dtype, int h, int kvh,
                                             int d, int dv, int splits,
                                             int groups, int* clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, 1, splits, h, kvh, d, dv,
               0, splits, splits, 1, groups, 1.f};
  return entry(a, dtype, nullptr, clusters);
}
