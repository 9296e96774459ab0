// Fused RMSNorm over the last dimension: one warp per row.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel): y = (x * rsqrt(mean(x^2) + eps)) cast to x's type,
// then multiplied by scale in x's type.
//
// What bounds it on the H100: bytes. It does ~4 operations per element
// against 2 * sizeof(T) bytes moved, far below the card's balance point,
// so the least time is 2 * rows * D * sizeof(T) over the HBM rate. The
// design reads x from device memory exactly once: each lane keeps its
// slice of the row in registers (VPL vectors of 4 elements, loaded 16
// bytes at a time for f32 and 8 for bf16), the sum of squares is reduced
// in f32 with warp shuffles, and the normalized row is written from the
// same registers. A warp per row keeps many independent loads in flight
// per SM; rows are independent, so the TPU's row-block grid becomes a
// flat grid of warps with no carried state.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

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

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vpl = (d / 4 + 31) / 32;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
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
  return static_cast<int>(cudaErrorInvalidValue);  // D > 4096
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
