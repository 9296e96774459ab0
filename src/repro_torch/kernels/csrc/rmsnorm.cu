// Fused RMSNorm over the last dimension: one warp per row, or one CTA per
// row for few rows and for rows past D 4096.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel): y = (x * rsqrt(mean(x^2) + eps)) cast to x's type,
// then multiplied by scale in x's type.
//
// What bounds it on the H100: bytes. It does ~4 operations per element
// against 2 * sizeof(T) bytes moved, far below the card's balance point,
// so the least time is 2 * rows * D * sizeof(T) over the HBM rate. The
// design reads x from device memory exactly once: each thread keeps its
// slice of the row in registers (vectors of 4 elements, loaded 16 bytes
// at a time for f32 and 8 for bf16), the sum of squares is reduced in
// f32 with warp shuffles, and the normalized row is written from the
// same registers. Rows are independent, so the TPU's row-block grid
// becomes a flat grid with no carried state. Many rows take a warp per
// row, 4 warps a CTA, which keeps many independent loads in flight per
// SM. Fewer than kSmallRows rows (4 per SM; the served 256 x 2048 is 256
// rows) would leave SMs idle that way (64 CTAs on 132 SMs), so each row
// takes a CTA of 128 threads, every SM gets work, and the warps' partial
// sums meet in shared memory. Rows wider than 4096 (the hybrid's d_model
// of 8192) would need more registers than a lane has for one warp, so
// they take a CTA of 256 threads per row whatever the row count.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kSmallRows = 4 * 132;  // below: a CTA per row

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

// VPL: 4-element vectors per lane, so D <= 128 * VPL.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp shares the row
  const int nvec = d >> 2;
  const T* xr = x + static_cast<size_t>(row) * d;

  float v[VPL][4];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = lane + 32 * j;
    if (i < nvec) {
      load4(xr + 4 * i, v[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) ss = fmaf(v[j][e], v[j][e], ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  T* orow = out + static_cast<size_t>(row) * d;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = lane + 32 * j;
    if (i < nvec) {
      float s[4], y[4];
      load4(scale + 4 * i, s);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = repro::round_to<T>(repro::round_to<T>(v[j][e] * r) * s[e]);
      store4(orow + 4 * i, y);
    }
  }
}

// THREADS per row, VPT 4-element vectors per thread, so
// D <= 4 * THREADS * VPT.
template <typename T, int THREADS, int VPT>
__global__ void __launch_bounds__(THREADS)
rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, int d, float eps) {
  __shared__ float partial[THREADS / 32];
  const int tid = threadIdx.x;
  const int nvec = d >> 2;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;

  float v[VPT][4];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = tid + THREADS * j;
    if (i < nvec) {
      load4(xr + 4 * i, v[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) ss = fmaf(v[j][e], v[j][e], ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) ss += partial[w];
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  T* orow = out + row * d;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = tid + THREADS * j;
    if (i < nvec) {
      float s[4], y[4];
      load4(scale + 4 * i, s);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = repro::round_to<T>(repro::round_to<T>(v[j][e] * r) * s[e]);
      store4(orow + 4 * i, y);
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
#define REPRO_RMSNORM_ROW_CASE(THREADS, N)                              \
  if (vpt <= N) {                                                       \
    rmsnorm_row_kernel<T, THREADS, N><<<rows, THREADS, 0, stream>>>(    \
        xp, sp, op, d, eps);                                            \
    return static_cast<int>(cudaGetLastError());                        \
  }
  if (d > 4096) {
    const int vpt = (d / 4 + 255) / 256;
    REPRO_RMSNORM_ROW_CASE(256, 8)
    REPRO_RMSNORM_ROW_CASE(256, 16)
    return static_cast<int>(cudaErrorInvalidValue);  // D > 16384
  }
  if (rows < kSmallRows) {
    const int vpt = (d / 4 + 127) / 128;
    REPRO_RMSNORM_ROW_CASE(128, 1)
    REPRO_RMSNORM_ROW_CASE(128, 2)
    REPRO_RMSNORM_ROW_CASE(128, 4)
    REPRO_RMSNORM_ROW_CASE(128, 8)
  }
#undef REPRO_RMSNORM_ROW_CASE
  const int vpl = (d / 4 + 31) / 32;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
#define REPRO_RMSNORM_CASE(N)                                            \
  if (vpl <= N) {                                                        \
    rmsnorm_kernel<T, N><<<grid, block, 0, stream>>>(xp, sp, op, rows, d, \
                                                     eps);               \
    return static_cast<int>(cudaGetLastError());                         \
  }
  REPRO_RMSNORM_CASE(1)
  REPRO_RMSNORM_CASE(2)
  REPRO_RMSNORM_CASE(4)
  REPRO_RMSNORM_CASE(8)
  REPRO_RMSNORM_CASE(16)
  REPRO_RMSNORM_CASE(32)
#undef REPRO_RMSNORM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int rows, int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps,
                               static_cast<cudaStream_t>(stream));
}
