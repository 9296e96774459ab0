// Flash attention forward (prefill/score path) with grouped KV heads, on
// the H100's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel): online-softmax attention with f32
// running max, denominator and accumulator; q head h reads kv head
// h / (H / KV) without expanding K/V; the causal diagonal is offset by
// sk - sq and a window keeps keys with q_pos - k_pos < window; the output
// is cast to q's type. Rows that see no key give 0, as the plain version
// does. With a non-null lse pointer the kernel also writes each row's
// f32 logsumexp of the scaled scores, m + log(l) in natural units
// (xla_flash.py:147-152), in the reference's (B, Sq, H) layout, and +inf
// for a row that sees no key; flash_attention_bwd.cu reads it. With a
// null pointer nothing else changes: the served CUDA graphs replay the
// same kernel.
//
// Layouts (all contiguous, 16-byte aligned): q (B, Sq, H, D),
// k (B, Sk, KV, D), v (B, Sk, KV, Dv), out (B, Sq, H, Dv). D and Dv are
// multiples of 8, D up to 192 and Dv up to 128 (DeepSeek-V3's MLA
// prefill sends D 192 = 128 + 64 RoPE dims with Dv 128, at G 1 over 128
// heads, as the TPU kernel takes it).
//
// What bounds it. At the hybrid's prefill (B 8, 512 tokens, 64 q heads
// over 8, D 128) the causal work is 34.4 GFLOP against 302 MB, so
// operations bound it. Every config computes in f32 and the repo's f32
// bar is 2e-5: one TF32 pass misses it by ~50x, so f32 inputs take the
// 3xTF32 split, x = big + small with big = tf32(x) and small the
// remainder x - big, each product accumulated in f32 as small*big +
// big*small + big*big. That is as accurate as f32 FMA and the least time
// to it on this card: 3 x 34.4 GFLOP at 495 TFLOP/s = 0.209 ms. bf16
// inputs take one bf16 MMA with an f32 accumulator.
//
// Design.
// - Instruction: mma.sync.aligned.m16n8k8 (tf32) and m16n8k16 (bf16),
//   one warp per 16 query rows. wgmma would need both operands of the
//   second product in shared memory in its own swizzled layout, and P
//   rewritten there every kv tile; mma.sync takes P straight from the
//   score accumulators in registers. wgmma is the next step.
// - The GQA group shares its K/V tiles. The G = H / KV query heads of
//   one kv head fill the rows of a CTA's q tile position-major (row =
//   position * G + g), so each K/V tile is read once per group, and the
//   causal/window range of a tile is that of its 64 / G positions. Any
//   G works; at the served Sq = 32, G = 4, a (batch, kv head) has two
//   full tiles, and B 8 x 8 kv heads give 128 CTAs. MLA expands its K/V
//   a head, so there G = 1 and a tile is 64 positions of one head.
// - K/V through a 2-stage cp.async ring (16-byte copies, zero-filled
//   past Sk): the next tile's copy is in flight while this tile's MMAs
//   run. Q is read once, by the same 16-byte copies. Tiles that the
//   causal/window mask hides from every row are never loaded, and the
//   mask is applied only to tiles that cross an edge. Longest q tiles
//   are scheduled first.
// - Shared memory rows are padded by 16 bytes, which makes every
//   fragment read below conflict-free (ldmatrix rows fall in distinct
//   16-byte bank groups; the f32 V reads of lanes (g, t) hit banks
//   8t + g). Head dims are padded with zeros, written once: Q and K to
//   DQK, V and the output to DV. DQK = DV = 32, 64 or 128 covers every
//   D, Dv <= 128 (the larger of the two sets both); D in (128, 192]
//   takes DQK = 192 with DV = 128, so V's tiles and the O accumulator
//   do not grow with the RoPE dims.
//   Budget at DQK = DV = 128, 128 threads: f32 (64 + 2 x 2 x 32 rows) x
//   132 x 4 B = 99 KiB with 32-row kv tiles; bf16 (64 + 2 x 2 x 64) x 136
//   x 2 B = 85 KiB with 64-row tiles; two CTAs (8 warps) an SM either
//   way. At DQK 192 / DV 128: f32 (64 + 2 x 32) x 196 x 4 + 2 x 32 x 132
//   x 4 B = 131 KiB, one CTA an SM (__launch_bounds__ says so); bf16
//   (64 + 2 x 64) x 200 x 2 + 2 x 64 x 136 x 2 B = 109 KiB, two.
// - The products are mma.cuh's: S = Q K^T is abt, P V is pb (in f32
//   pb_into: pb into a zeroed tile, added to O with rounding), which
//   feeds P to the MMA from the score accumulators without a shuffle.
// - cudaFuncSetAttribute runs once per template instance and device.
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "mma.cuh"

namespace {

using namespace repro;

constexpr int kBM = 64;        // packed q rows per CTA: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile geometry of one (type, padded Q/K head dim, padded V head dim)
// instance; DV <= DQK.
template <typename T, int DQK, int DV>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per copy
  static constexpr int kLdK = DQK + kVec;     // padded row stride, Q and K
  static constexpr int kLdV = DV + kVec;      // padded row stride, V
  static constexpr int kBN = (sizeof(T) == 4 && DQK > 64) ? 32 : 64;
  static constexpr size_t kSmem =
      sizeof(T) * (static_cast<size_t>(kBM + kStages * kBN) * kLdK +
                   static_cast<size_t>(kStages * kBN) * kLdV);
  // CTAs an SM holds: two while both fit the SM's 227 KiB
  static constexpr int kMinBlocks = 2 * kSmem <= 227 * 1024 ? 2 : 1;
};

// One CTA per (q tile of 64 packed rows, kv head, batch).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, (Tile<T, DQK, DV>::kMinBlocks))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int h, int kvh,
                 int d, int dv, int causal, int window, float scale_log2) {
  using Geo = Tile<T, DQK, DV>;
  constexpr int BN = Geo::kBN, LD = Geo::kLdK, LDV = Geo::kLdV;
  constexpr int VEC = Geo::kVec;
  constexpr int CPR = DQK / VEC;  // 16-byte chunks per padded Q/K row
  constexpr bool kF32 = std::is_same<T, float>::value;
  static_assert(DV <= DQK, "V's rows are copied in Q/K's chunk loop");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // kBM x LD
  T* sK = sQ + kBM * LD;                   // kStages x BN x LD
  T* sV = sK + kStages * BN * LD;          // kStages x BN x LDV

  const int grp = h / kvh;    // q heads per kv head
  const int rows = sq * grp;  // packed rows of one (batch, kv head)
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest tiles first
  const int kh = blockIdx.y, bb = blockIdx.z;
  const int offset = sk - sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // kv positions any real row of this tile can see
  const int pos_first = m0 / grp;
  const int pos_last = (min(m0 + kBM, rows) - 1) / grp;
  int kv_lo = 0, kv_hi = sk;
  if (causal) {
    kv_hi = min(sk, pos_last + offset + 1);
    if (window > 0) kv_lo = max(0, pos_first + offset - window + 1);
  }
  const int t_lo = kv_lo / BN;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN : t_lo;

  // head-dim padding stays zero: the copies never write it
  zero_cols<kThreads>(sQ, kBM + kStages * BN, LD, d, DQK);
  zero_cols<kThreads>(sV, kStages * BN, LDV, dv, DV);

  // Q: packed row m0 + rr is position (m0 + rr) / grp, head
  // kh * grp + (m0 + rr) % grp
  for (int idx = tid; idx < kBM * CPR; idx += kThreads) {
    const int rr = idx / CPR, c = (idx % CPR) * VEC;
    if (c >= d) continue;
    const int r = m0 + rr;
    const bool ok = r < rows;
    const int pos = ok ? r / grp : 0;
    const int head = kh * grp + (ok ? r - pos * grp : 0);
    const T* src =
        q + ((static_cast<size_t>(bb) * sq + pos) * h + head) * d + c;
    cp_async16(sQ + rr * LD + c, src, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int tile, int stage) {
    T* dk = sK + stage * BN * LD;
    T* dvv = sV + stage * BN * LDV;
    for (int idx = tid; idx < BN * CPR; idx += kThreads) {
      const int rr = idx / CPR, c = (idx % CPR) * VEC;
      const int j = tile * BN + rr;
      const bool ok = j < sk;
      const size_t row =
          (static_cast<size_t>(bb) * sk + (ok ? j : 0)) * kvh + kh;
      if (c < d) cp_async16(dk + rr * LD + c, k + row * d + c, ok);
      if (c < dv) cp_async16(dvv + rr * LDV + c, v + row * dv + c, ok);
    }
  };
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  const T* sQw = sQ + warp * 16 * LD;
  uint32_t qf[kF32 ? 1 : DQK / 16][4];
  if constexpr (!kF32) {
    load_a_bf16<DQK, LD>(qf, sQw, lane);
  }

  const int r0 = m0 + warp * 16 + g;  // this lane's rows r0, r0 + 8
  const int qp[2] = {r0 / grp + offset, (r0 + 8) / grp + offset};
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int stage = (tile - t_lo) & 1;
    if (tile + 1 < t_hi) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const T* sKs = sK + stage * BN * LD;
    const T* sVs = sV + stage * BN * LDV;

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if constexpr (kF32)
      abt_f32<DQK, BN, LD>(s, sQw, sKs, lane);
    else
      abt_bf16<DQK, BN, LD>(s, qf, sKs, lane);

    const int kv0 = tile * BN;
    const bool mask =
        kv0 + BN > sk ||
        (causal && (kv0 + BN - 1 > pos_first + offset ||
                    (window > 0 && pos_last + offset - kv0 >= window)));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (mask) {
          const int j = kv0 + nt * 8 + 2 * t + (e & 1);
          const int p = qp[e >> 1];
          const bool keep = j < sk && (!causal || (j <= p && (window <= 0 ||
                                                            p - j < window)));
          x = keep ? x : -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mref[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_i[hh], mx[hh]);
      // every key so far masked: keep the (zero) state, p = 0
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m_i[hh] - m_new);
      mref[hh] = m_new == -INFINITY ? 0.f : m_new;
      m_i[hh] = m_new;
      l_i[hh] *= alpha;
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt) {
        acc[nt][2 * hh] *= alpha;
        acc[nt][2 * hh + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mref[e >> 1]);
        l_i[e >> 1] += s[nt][e];
      }

    // f32: through a zeroed tile, added with rounding; straight into acc
    // the MMAs' truncations pile up over the Sk keys (mma.cuh's
    // pb_into). bf16 rounds P to 8 bits before the MMA, which is far
    // more than that pile-up, so it adds straight into acc.
    if constexpr (kF32)
      pb_into<DV, BN, LDV>(acc, s, sVs, lane);
    else
      pb_bf16<DV, BN, LDV>(acc, s, sVs, lane);
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_i[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int r = r0 + 8 * hh;
    if (r >= rows) continue;
    const int pos = r / grp;
    const int head = kh * grp + r - pos * grp;
    const size_t row = (static_cast<size_t>(bb) * sq + pos) * h + head;
    if (lse != nullptr && t == 0)
      lse[row] = l > 0.f ? (m_i[hh] + log2f(l)) * kLn2 : INFINITY;
    T* orow = o + row * dv;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < dv)
        store2(orow + c, acc[nt][2 * hh] * inv, acc[nt][2 * hh + 1] * inv);
    }
  }
}

template <typename T, int DQK, int DV>
int launch_dh(const void* q, const void* k, const void* v, void* o,
              float* lse, int b, int sq, int sk, int h, int kvh, int d,
              int dv, int causal, int window, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = Tile<T, DQK, DV>::kSmem;
  auto kernel = flash_fwd_kernel<T, DQK, DV>;
  // the shared-memory opt-in, once per instance and device
  static std::once_flag once[kMaxDevices];
  static cudaError_t attr_err[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[dev], [&] {
    attr_err[dev] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  });
  if (attr_err[dev] != cudaSuccess) return static_cast<int>(attr_err[dev]);
  const int rows = sq * (h / kvh);
  const dim3 grid((rows + kBM - 1) / kBM, kvh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, h, kvh, d,
      dv, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kvh, int d, int dv, int causal,
           int window, float scale, cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || d <= 0 || d > 192 || dv <= 0 ||
      dv > 128 || d % 8 != 0 || dv % 8 != 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d > 128)
    return launch_dh<T, 192, 128>(q, k, v, o, lse, b, sq, sk, h, kvh, d,
                                  dv, causal, window, scale, stream);
  const int dmax = d > dv ? d : dv;
  if (dmax <= 32)
    return launch_dh<T, 32, 32>(q, k, v, o, lse, b, sq, sk, h, kvh, d, dv,
                                causal, window, scale, stream);
  if (dmax <= 64)
    return launch_dh<T, 64, 64>(q, k, v, o, lse, b, sq, sk, h, kvh, d, dv,
                                causal, window, scale, stream);
  return launch_dh<T, 128, 128>(q, k, v, o, lse, b, sq, sk, h, kvh, d, dv,
                                causal, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse: null, or (B, Sq, H) float32
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int b, int sq, int sk, int h,
                                   int kvh, int d, int dv, int causal,
                                   int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch<float>(q, k, v, o, l, b, sq, sk, h, kvh, d, dv, causal,
                         window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, l, b, sq, sk, h, kvh, d, dv,
                                 causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
