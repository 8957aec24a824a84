// RG-LRU linear-recurrence scan h_t = a_t * h_{t-1} + b_t (recurrentgemma).
//
// Replaces the TPU kernel repro/kernels/rglru_scan/rglru_scan.py
// ::rglru_scan: the same streaming scan in fp32 (the TPU kernel carries h
// in VMEM across sequential grid steps over S; here one lane carries its
// channel's h in a register over the whole sequence). The TPU wrapper
// pads S and D with a=1, b=0; this kernel masks the ragged edges itself.
//
// What bounds it on an H100: bytes. It reads a and b and writes h once
// (12 B per element, 1 multiply and 1 add), so the least time is
// (2 B*S*D + B*D) * 4 B in, B*S*D * 4 B out at 3.35 TB/s: 0.00120 ms at
// (1, 130, 2560), 0.150 ms at (4, 4096, 2560). The recurrence is serial
// in S and is kept in that order, so the kernel stays bit-equal to the
// plain version: the update rounds the product and the sum apart
// (__fmul_rn, __fadd_rn), as the plain `a * h + b` does. The chain is one
// multiply and one add a step (~8 cycles, ~20 us at S = 4096, under the
// bytes' 150 us); what held the thread-a-channel form back was too few
// CTAs (B*D/256) and too few bytes in flight (8 steps a thread).
//
// Design: one warp a CTA, one batch row and a tile of TILE = 16
// channels: B * D / 16 CTAs, 160 at (1, 130, 2560), where every path of
// the port runs the scan (the engine prefills one request at a time),
// and 640 at B = 4. a and b stream through a ring of STAGES stages of
// STEPS steps x TILE channels in shared memory (4 KB a stage), filled by
// 16-byte cp.async copies (4-byte ones when D % 4 != 0 or a base is
// misaligned) issued by the same warp STAGES - 1 stages ahead of the
// stage its lanes run. Lane = channel takes a stage's a and b into
// registers and runs the chain there, storing each step's h straight to
// device memory: a step of the tile is one 64-byte segment a warp store,
// so the writes coalesce without a pass through shared memory. Rows past
// S and channels past D are never copied, stored or run: no padding copy.
// What is left at B = 1 is the copies' latency: one warp's cp.async
// stream fills its ring at ~14 GB/s (PERF.md), so more, narrower CTAs
// finish sooner there; tiles of 32 (one 128-byte line a step) were 22%
// slower at (1, 130, 2560) and 4-5% faster only at (4, 4096, 2560), a
// shape no path runs (PERF.md).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;        // channels a CTA
constexpr int STEPS = 32;       // steps a stage
constexpr int STAGES = 3;       // stages in the ring
constexpr int NT = 32;          // one warp

// cp.async of VEC floats (16 or 4 bytes)
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// stage <- steps [t0, t0 + n) of channels [d0, d0 + TILE) of a and b
// (rows past n and channels past D are left alone); one commit group
template <int VEC>
__device__ __forceinline__ void fill_stage(float* stage, const float* a,
                                           const float* b, int t0, int n,
                                           int d0, int D) {
  constexpr int PER_ROW = TILE / VEC;
  for (int v = threadIdx.x; v < STEPS * PER_ROW; v += NT) {
    const int row = v / PER_ROW, col = (v % PER_ROW) * VEC;
    if (row < n && d0 + col < D) {
      const size_t off = (size_t)(t0 + row) * D + d0 + col;
      cp_async<VEC>(stage + row * TILE + col, a + off);
      cp_async<VEC>(stage + STEPS * TILE + row * TILE + col, b + off);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid (cdiv(D, TILE), B), one warp a CTA
template <int VEC>
__global__ void __launch_bounds__(NT) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ out, int S, int D) {
  constexpr int STAGE_FLOATS = 2 * STEPS * TILE;  // a, then b
  extern __shared__ __align__(16) float ring[];   // STAGES x STAGE_FLOATS
  const int lane = threadIdx.x, row = blockIdx.y;
  const int d0 = blockIdx.x * TILE, d = d0 + lane;
  const size_t base = (size_t)row * S * D;
  a += base;
  b += base;
  const int nch = (S + STEPS - 1) / STEPS;
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nch)
      fill_stage<VEC>(ring + k * STAGE_FLOATS, a, b, k * STEPS,
                      min(STEPS, S - k * STEPS), d0, D);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const bool live = lane < TILE && d < D;
  float h = live ? h0[(size_t)row * D + d] : 0.f;
  float* o = out + base + d;
  for (int k = 0; k < nch; ++k) {
    const int next = k + STAGES - 1;       // into the stage run at k - 1
    if (next < nch)
      fill_stage<VEC>(ring + (next % STAGES) * STAGE_FLOATS, a, b,
                      next * STEPS, min(STEPS, S - next * STEPS), d0, D);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    __syncwarp();                          // stage k landed for every lane
    const float* sa = ring + (k % STAGES) * STAGE_FLOATS + lane;
    const float* sb = sa + STEPS * TILE;
    const int t0 = k * STEPS, n = min(STEPS, S - t0);
    if (live) {
      if (n == STEPS) {
        // the stage's a and b into registers first, so the chain waits
        // on no shared-memory load
        float av[STEPS], bv[STEPS];
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          av[i] = sa[i * TILE];
          bv[i] = sb[i * TILE];
        }
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
          o[(size_t)(t0 + i) * D] = h;
        }
      } else {
        for (int i = 0; i < n; ++i) {
          h = __fadd_rn(__fmul_rn(sa[i * TILE], h), sb[i * TILE]);
          o[(size_t)(t0 + i) * D] = h;
        }
      }
    }
    __syncwarp();                          // stage k read before refilled
  }
}

template <int VEC>
int launch(const float* a, const float* b, const float* h0, float* out,
           int B, int S, int D, cudaStream_t st) {
  constexpr int SMEM = STAGES * 2 * STEPS * TILE * (int)sizeof(float);
  static_assert(SMEM <= 48 * 1024, "ring above the default shared memory");
  const dim3 grid((D + TILE - 1) / TILE, B);
  rglru_scan_kernel<VEC><<<grid, NT, SMEM, st>>>(a, b, h0, out, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* out, int B, int S, int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fh = static_cast<const float*>(h0);
  float* fo = static_cast<float*>(out);
  const bool vec = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                   reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  return vec ? launch<4>(fa, fb, fh, fo, B, S, D, st)
             : launch<1>(fa, fb, fh, fo, B, S, D, st);
}
