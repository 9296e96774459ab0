// Decode attention: one query token per sequence against a KV cache,
// with grouped KV heads, split across CTAs (flash-decoding).
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
// out (B, 1, H, Dv). D, Dv <= 128 and multiples of 8; G <= 16.
//
// Design. The TPU grid is (B, KV, kv blocks) with the kv blocks walked in
// order and (m, l, acc) carried in VMEM. B * KV is only 64 at the served
// shape (B = 8, KV = 8) against 132 SMs, so here the valid keys
// [lo, valid_len) are cut into `splits` chunks of `chunk` keys, and one
// CTA of 128 threads takes one (chunk, kv head, batch). It walks its
// chunk in tiles of 64 keys: all four warps stage the K and V tile in
// shared memory as f32 with 16-byte global loads (the rows of one kv head
// are D elements apart from the next head's, so each row is one
// contiguous run), then warp w takes the query heads g = w, w + 4, ...;
// a lane scores keys lane and lane + 32 of the tile against each of its
// heads, the warp reduces max and sum with shuffles, and lane holds
// output dims lane, lane + 32, ... of the accumulator. The CTA writes its
// unnormalised partial (m, l, acc) per head to scratch; a second kernel,
// one warp per (batch, head), rescales the partials by exp(m_i - max m)
// and divides. valid_len comes as a host int, so no slot at or past it
// is read and no device-to-host copy is needed; Smax has no divisibility
// rule. A chunk with no valid key (possible only for an empty range)
// leaves m = -inf, l = 0, acc = 0 and so contributes exactly nothing; a
// row with no key at all gives 0, as the plain version does (the TPU
// kernel floors l at 1e-30 instead).
//
// Arithmetic is f32 FMA throughout, with no TF32, so f32 inputs meet the
// repo's 2e-5 tolerance. What bounds it on the H100: bytes. Each call
// reads 2 * B * (valid_len - lo) * KV * D * itemsize of cache (33.6 MB at
// the served shape, valid_len = 1024, f32: 10 us at 3.35 TB/s); its 4
// FLOP per (head, key, dim) take a tenth of that at the f32 FMA rate.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // keys per shared-memory tile
constexpr int kKeysPerLane = kTile / 32;
constexpr int kMaxHeadsPerWarp = 4;  // G <= 16
constexpr int kLoadBatch = 8;   // 16-byte loads in flight per thread

// The 16 bytes of one load as f32 values: 4 floats, or 8 bf16 (a bf16 is
// the high half of the f32 of the same value).
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

// Stage rows [0, rows) of a tile of K (width dk) and V (width dv) as f32:
// K at stride dk + 1 (an odd stride: the lanes of a warp read 32 rows at
// once in distinct banks), V at stride dv.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ k,
                                          size_t k_stride, int dk,
                                          const T* __restrict__ v,
                                          size_t v_stride, int dv, int rows,
                                          float* sK, float* sV) {
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte load
  const int vk = dk / VE, vv = dv / VE;
  const int nk = rows * vk, total = nk + rows * vv;
  for (int base = 0; base < total; base += kThreads * kLoadBatch) {
    uint4 buf[kLoadBatch] = {};
#pragma unroll
    for (int i = 0; i < kLoadBatch; ++i) {
      const int idx = base + i * kThreads + threadIdx.x;
      if (idx < nk) {
        const int r = idx / vk, c = (idx - r * vk) * VE;
        buf[i] = *reinterpret_cast<const uint4*>(k + r * k_stride + c);
      } else if (idx < total) {
        const int j = idx - nk, r = j / vv, c = (j - r * vv) * VE;
        buf[i] = *reinterpret_cast<const uint4*>(v + r * v_stride + c);
      }
    }
#pragma unroll
    for (int i = 0; i < kLoadBatch; ++i) {
      const int idx = base + i * kThreads + threadIdx.x;
      float e[VE];
      unpack(buf[i], e, T());
      if (idx < nk) {
        const int r = idx / vk, c = (idx - r * vk) * VE;
#pragma unroll
        for (int t = 0; t < VE; ++t) sK[r * (dk + 1) + c + t] = e[t];
      } else if (idx < total) {
        const int j = idx - nk, r = j / vv, c = (j - r * vv) * VE;
#pragma unroll
        for (int t = 0; t < VE; ++t) sV[r * dv + c + t] = e[t];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DVL: output dims per lane (Dv <= 32 * DVL).
// grid (splits, KV, B). Partials: ml (B, KV, splits, G, 2) as (m, l);
// acc (B, KV, splits, G, Dv).
template <typename T, int DVL>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ ml,
                    float* __restrict__ acc_out, int smax, int h, int kvh,
                    int d, int dv, int lo, int hi, int chunk, float scale) {
  extern __shared__ float smem[];
  const int g_heads = h / kvh;
  float* sQ = smem;                          // G x d
  float* sK = sQ + g_heads * d;              // kTile x (d + 1)
  float* sV = sK + kTile * (d + 1);          // kTile x dv

  const int split = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int splits = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = lo + split * chunk;
  const int s1 = min(hi, s0 + chunk);

  const T* qg = q + (static_cast<size_t>(bb) * h + kh * g_heads) * d;
  for (int i = threadIdx.x; i < g_heads * d; i += kThreads)
    sQ[i] = repro::to_float(qg[i]);

  float m_i[kMaxHeadsPerWarp], l_i[kMaxHeadsPerWarp];
  float acc[kMaxHeadsPerWarp][DVL];
#pragma unroll
  for (int hw = 0; hw < kMaxHeadsPerWarp; ++hw) {
    m_i[hw] = -INFINITY;
    l_i[hw] = 0.f;
#pragma unroll
    for (int i = 0; i < DVL; ++i) acc[hw][i] = 0.f;
  }

  // consecutive cache slots of one kv head are KV * width elements apart
  const size_t k_stride = static_cast<size_t>(kvh) * d;
  const size_t v_stride = static_cast<size_t>(kvh) * dv;
  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int rows = min(kTile, s1 - t0);
    __syncthreads();  // every warp is done with the previous tile (and sQ)
    const size_t slot = static_cast<size_t>(bb) * smax + t0;
    load_tile<T>(k + slot * k_stride + kh * d, k_stride, d,
                 v + slot * v_stride + kh * dv, v_stride, dv, rows, sK, sV);
    __syncthreads();

#pragma unroll
    for (int hw = 0; hw < kMaxHeadsPerWarp; ++hw) {
      const int g = warp + hw * kWarps;
      if (g >= g_heads) continue;  // warp-uniform
      const float* qr = sQ + g * d;
      float s[kKeysPerLane];
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) s[kk] = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        const float qv = qr[dd];
#pragma unroll
        for (int kk = 0; kk < kKeysPerLane; ++kk)
          s[kk] = fmaf(qv, sK[(lane + 32 * kk) * (d + 1) + dd], s[kk]);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        s[kk] = (lane + 32 * kk < rows) ? s[kk] * scale : -INFINITY;
        mx = fmaxf(mx, s[kk]);
      }
      const float m_new = fmaxf(m_i[hw], warp_max(mx));  // finite: rows >= 1
      const float alpha = expf(m_i[hw] - m_new);          // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        s[kk] = expf(s[kk] - m_new);  // 0 for keys past the tile's rows
        psum += s[kk];
      }
      l_i[hw] = l_i[hw] * alpha + warp_sum(psum);
      m_i[hw] = m_new;
#pragma unroll
      for (int i = 0; i < DVL; ++i) acc[hw][i] *= alpha;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const int jmax = min(32, rows - 32 * kk);
        for (int j = 0; j < jmax; ++j) {
          const float p = __shfl_sync(0xffffffffu, s[kk], j);
          const float* vr = sV + (32 * kk + j) * dv;
#pragma unroll
          for (int i = 0; i < DVL; ++i) {
            const int dd = lane + 32 * i;
            if (dd < dv) acc[hw][i] = fmaf(p, vr[dd], acc[hw][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int hw = 0; hw < kMaxHeadsPerWarp; ++hw) {
    const int g = warp + hw * kWarps;
    if (g >= g_heads) continue;
    const size_t row = ((static_cast<size_t>(bb) * kvh + kh) * splits + split) * g_heads + g;
    if (lane == 0) {
      ml[2 * row] = m_i[hw];
      ml[2 * row + 1] = l_i[hw];
    }
#pragma unroll
    for (int i = 0; i < DVL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < dv) acc_out[row * dv + dd] = acc[hw][i];
    }
  }
}

// One warp per (batch, head): out = sum_i w_i acc_i / sum_i w_i l_i with
// w_i = exp(m_i - max_j m_j); a row with no key gives 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ml,
                      const float* __restrict__ acc, T* __restrict__ o,
                      int b, int h, int kvh, int dv, int splits) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= b * h) return;  // warp-uniform
  const int g_heads = h / kvh;
  const int bb = row / h, hh = row - bb * h;
  const int kh = hh / g_heads, g = hh - kh * g_heads;
  const size_t first = (static_cast<size_t>(bb) * kvh + kh) * splits;
  auto part = [&](int s) { return (first + s) * g_heads + g; };

  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[2 * part(s)]);
  float l = 0.f;
  if (m != -INFINITY)
    for (int s = 0; s < splits; ++s)
      l += expf(ml[2 * part(s)] - m) * ml[2 * part(s) + 1];
  T* orow = o + static_cast<size_t>(row) * dv;
  for (int dd = lane; dd < dv; dd += 32) {
    float num = 0.f;
    if (m != -INFINITY)
      for (int s = 0; s < splits; ++s)
        num = fmaf(expf(ml[2 * part(s)] - m), acc[part(s) * dv + dd], num);
    orow[dd] = repro::from_float<T>(l > 0.f ? num / l : 0.f);
  }
}

template <typename T, int DVL>
int launch_dvl(const void* q, const void* k, const void* v, void* o,
               float* ml, float* acc, int b, int smax, int h, int kvh, int d,
               int dv, int lo, int hi, int splits, int chunk, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(h / kvh) * d + static_cast<size_t>(kTile) * (d + 1) +
       static_cast<size_t>(kTile) * dv);
  auto kernel = decode_split_kernel<T, DVL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, kvh, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ml, acc, smax, h, kvh, d, dv, lo, hi, chunk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = b * h;
  decode_combine_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      ml, acc, static_cast<T*>(o), b, h, kvh, dv, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* ml,
           float* acc, int b, int smax, int h, int kvh, int d, int dv, int lo,
           int hi, int splits, int chunk, float scale, cudaStream_t stream) {
  if (b <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || h / kvh > kWarps * kMaxHeadsPerWarp ||
      d <= 0 || d > 128 || dv <= 0 || dv > 128 || d % 8 || dv % 8 ||
      lo < 0 || hi > smax || splits <= 0 || chunk <= 0 || chunk % kTile ||
      static_cast<long long>(splits) * chunk < hi - lo)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dv <= 32)
    return launch_dvl<T, 1>(q, k, v, o, ml, acc, b, smax, h, kvh, d, dv, lo,
                            hi, splits, chunk, scale, stream);
  if (dv <= 64)
    return launch_dvl<T, 2>(q, k, v, o, ml, acc, b, smax, h, kvh, d, dv, lo,
                            hi, splits, chunk, scale, stream);
  return launch_dvl<T, 4>(q, k, v, o, ml, acc, b, smax, h, kvh, d, dv, lo,
                          hi, splits, chunk, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Keys [lo, hi) count; `splits` CTAs
// per (kv head, batch) take `chunk` keys each (a multiple of 64).
// ml: f32 scratch of B * KV * splits * G * 2; acc: f32 scratch of
// B * KV * splits * G * Dv.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* ml,
                                    void* acc, int dtype, int b, int smax,
                                    int h, int kvh, int d, int dv, int lo,
                                    int hi, int splits, int chunk,
                                    float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mlf = static_cast<float*>(ml);
  float* accf = static_cast<float*>(acc);
  if (dtype == 0)
    return launch<float>(q, k, v, o, mlf, accf, b, smax, h, kvh, d, dv, lo,
                         hi, splits, chunk, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, mlf, accf, b, smax, h, kvh, d,
                                 dv, lo, hi, splits, chunk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
