// On-device sampling: token = argmax(logits + noise * T) per row; T = 0
// is greedy, T > 0 is Gumbel-max sampling at temperature T. Among equal
// maxima the lowest index wins (np.argmax / torch.argmax semantics).
//
// Replaces the TPU kernel repro/kernels/decode_attention/
// decode_attention.py::sample_tokens (_sample_kernel), which walks the
// vocabulary in 2048-wide blocks with a strict ">" to keep the first
// maximum across blocks.
//
// What bounds it on an H100: bytes — two fp32 rows of V values read once
// (8 * V bytes per row, 1.2 MB per row at V = 152064), one int written;
// 2 FLOP per column.
//
// Design: one CTA of 1024 threads per row. Each thread walks the row with
// a 1024 stride, so its own candidates arrive in increasing index order
// and a strict ">" keeps its first maximum; then a warp and a block
// reduction of (value, index) pairs in which the lower index wins a tie.
// The score is formed as round(l + round(n * T)) with no fused
// multiply-add, so it is bit-identical to the plain PyTorch version.
#include "common.cuh"

namespace {

constexpr int NT = 1024;

__device__ __forceinline__ void pick(float& v, int& i, float v2, int i2) {
  if (i2 >= 0 && (i < 0 || v2 > v || (v2 == v && i2 < i))) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(NT) sample_tokens_kernel(
    const float* __restrict__ logits, const float* __restrict__ noise,
    const float* __restrict__ temps, int* __restrict__ out, int V) {
  __shared__ float sv[NT / 32];
  __shared__ int si[NT / 32];
  const int b = blockIdx.x;
  const float* lr = logits + (size_t)b * V;
  const float* nr = noise + (size_t)b * V;
  const float t = temps[b];
  float best = -INFINITY;
  int bi = -1;
  for (int c = threadIdx.x; c < V; c += NT) {
    const float s = __fadd_rn(lr[c], __fmul_rn(nr[c], t));
    if (bi < 0 || s > best) {
      best = s;
      bi = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
    pick(best, bi, v2, i2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = sv[lane];
    bi = si[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
      pick(best, bi, v2, i2);
    }
    if (lane == 0) out[b] = bi;
  }
}

}  // namespace

extern "C" int sample_tokens(const void* logits, const void* noise,
                             const void* temps, void* out, int B, int V,
                             void* stream) {
  if (B <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  sample_tokens_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(noise),
      static_cast<const float*>(temps), static_cast<int*>(out), V);
  return (int)cudaGetLastError();
}
