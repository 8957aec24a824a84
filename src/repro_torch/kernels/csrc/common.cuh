// Shared helpers for the hand-written Hopper kernels of repro_torch.
// Every source is compiled on its own into a shared library with a plain
// C interface (see kernels/common.py); each C entry returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once
#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dtype codes shared with kernels/common.py::DTYPE_CODES
enum DType { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace rt
