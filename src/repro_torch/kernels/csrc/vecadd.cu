// Vector addition x + y, the paper's benchmark app 3.
//
// Replaces the TPU kernel repro/kernels/vecadd/vecadd.py::vecadd: a 1-D
// element-wise sum, output in the input dtype. The TPU wrapper pads n to
// a multiple of its 16384-element block; this kernel takes any n with no
// padding copy.
//
// What bounds it on an H100: bytes. It reads 2n and writes n elements and
// does n additions, far below the card's ~20 FLOP per byte fp32 balance
// point, so the least time is 3 * n * sizeof(T) / 3.35 TB/s.
//
// Design: one 16-byte vector of each operand a thread (float4, or 8 x
// bf16) while all three pointers are 16-byte aligned, then a scalar tail;
// the grid covers n in one pass (a grid-stride loop takes over only past
// 2^31 - 1 blocks). bf16 is added in fp32 and rounded once, exactly as
// the plain `x + y` rounds it. A grid capped at 16 blocks an SM that
// strides lost ~4% to `torch.add`; more vectors a thread and streaming
// cache hints gained nothing (PERF.md, the vecadd row).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT) vecadd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
    long long n, int vec_ok) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = vec_ok ? n / V : 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    const uint4 a = reinterpret_cast<const uint4*>(x)[i];
    const uint4 b = reinterpret_cast<const uint4*>(y)[i];
    uint4 c;
    const T* pa = reinterpret_cast<const T*>(&a);
    const T* pb = reinterpret_cast<const T*>(&b);
    T* pc = reinterpret_cast<T*>(&c);
#pragma unroll
    for (int j = 0; j < V; ++j)
      pc[j] = rt::from_float<T>(rt::to_float(pa[j]) + rt::to_float(pb[j]));
    reinterpret_cast<uint4*>(out)[i] = c;
  }
  for (long long i = nvec * V + first; i < n; i += stride)
    out[i] = rt::from_float<T>(rt::to_float(x[i]) + rt::to_float(y[i]));
}

template <typename T>
int launch(const void* x, const void* y, void* out, long long n,
           cudaStream_t st) {
  const int vec_ok = ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(y) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = vec_ok ? n / (16 / sizeof(T)) + 1 : n;
  long long blocks = (work + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;   // then it strides
  vecadd_kernel<T><<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), n, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vecadd(const void* x, const void* y, void* out, long long n,
                      int dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch<float>(x, y, out, n, st);
  if (dtype == rt::kBFloat16) return launch<__nv_bfloat16>(x, y, out, n, st);
  return (int)cudaErrorInvalidValue;
}
