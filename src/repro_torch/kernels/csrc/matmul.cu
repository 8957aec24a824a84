// Tiled GEMM (M,K) @ (K,N) with an fp32 accumulator, the paper's
// benchmark app 1.
//
// Replaces the TPU kernel repro/kernels/matmul/matmul.py::matmul: a
// blocked product whose fp32 accumulator stays on chip across the K
// reduction and whose output is written once, in the input dtype. The TPU
// wrapper pads M, K and N to 256/512/256 blocks; this kernel masks the
// ragged edges on load and store, with no padded copies.
//
// What bounds it on an H100: operations at the shapes the apps use
// (4096^3 is 137 GFLOP against 100 MB of operands). fp32 runs as true
// fp32 FMAs (no TF32), whose peak is 67 TFLOP/s; bf16 is converted to
// fp32 on load and runs on the same FMA units, so it is far from the
// 989 TFLOP/s tensor-core bound. Tensor cores (mma/wgmma) are later work.
//
// Design: one 256-thread CTA per 128 x 128 output tile, K in steps of 32.
// The A tile is staged transposed and the B tile as is, both as fp32 in
// shared memory; each thread keeps an 8 x 8 register micro-tile of the
// accumulator over rows ty + 16 i and columns tx + 16 j, so the shared
// reads of one k step are broadcasts or consecutive words (no bank
// conflicts) and global loads of both tiles are coalesced.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int NT = 256;
constexpr int TM = 8, TN = 8;          // micro-tile per thread

template <typename T>
__global__ void __launch_bounds__(NT) matmul_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    int M, int K, int N) {
  __shared__ float As[BK][BM + 1];     // transposed: As[k][m]
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? rt::to_float(a[(size_t)gm * K + gk])
                                    : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? rt::to_float(b[(size_t)gk * N + gn])
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = rt::from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int M, int K, int N,
           cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T><<<grid, NT, 0, st>>>(static_cast<const T*>(a),
                                        static_cast<const T*>(b),
                                        static_cast<T*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int matmul(const void* a, const void* b, void* out, int M, int K,
                      int N, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch<float>(a, b, out, M, K, N, st);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16>(a, b, out, M, K, N, st);
  return (int)cudaErrorInvalidValue;
}
