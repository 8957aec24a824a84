// RG-LRU linear-recurrence scan h_t = a_t * h_{t-1} + b_t (recurrentgemma).
//
// Replaces the TPU kernel repro/kernels/rglru_scan/rglru_scan.py
// ::rglru_scan: the same streaming scan in fp32 (the TPU kernel carries h
// in VMEM across sequential grid steps; here each thread carries its
// channel's h in a register over the whole sequence). The TPU wrapper
// pads S and D with a=1, b=0; this kernel masks the ragged edge itself.
//
// What bounds it on an H100: bytes. It reads a and b and writes h once
// (12 B per element, 1 multiply and 1 add), so the least time is
// (2 B*S*D + B*D) * 4 B in, B*S*D * 4 B out at 3.35 TB/s. The recurrence
// is serial in S, so the only parallelism is B*D: at the serving shape
// (B=1, D=2560) that is 10 CTAs of 256 threads on 132 SMs, and the
// kernel is bound by the latency of its dependent chain, not by bytes.
//
// Design: one thread per (batch row, channel), adjacent channels in
// adjacent lanes, so each step's loads and stores coalesce across the
// warp. a_t and b_t do not depend on h, so the loop loads U steps ahead
// into registers before it runs their U dependent updates. The update
// rounds the product and the sum apart (__fmul_rn, __fadd_rn), as the
// plain `a * h + b` does, so the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int U = 8;            // steps loaded ahead of their updates

__global__ void __launch_bounds__(NT) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ out, int S, int D) {
  const int d = blockIdx.x * NT + threadIdx.x;
  const int row = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)row * S * D + d;
  float h = h0[(size_t)row * D + d];
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t off = base + (size_t)(t + u) * D;
      av[u] = a[off];
      bv[u] = b[off];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      out[base + (size_t)(t + u) * D] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t off = base + (size_t)t * D;
    h = __fadd_rn(__fmul_rn(a[off], h), b[off]);
    out[off] = h;
  }
}

}  // namespace

extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* out, int B, int S, int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((D + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, D);
  return (int)cudaGetLastError();
}
