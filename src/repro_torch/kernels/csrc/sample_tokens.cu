// On-device sampling: token = argmax(logits + noise * T) per row; T = 0
// is greedy, T > 0 is Gumbel-max sampling at temperature T.
//
// Replaces the TPU kernel repro/kernels/decode_attention/
// decode_attention.py::sample_tokens (_sample_kernel), which walks the
// vocabulary in 2048-wide blocks with a strict ">" to keep the first
// maximum across blocks.
//
// The order (np.argmax / torch.argmax): scores are ordered totally, a NaN
// above +inf; among equal scores, and among NaNs, the lowest index wins;
// -0.0 and +0.0 are equal; an all -inf row picks 0. A thread walks its
// columns in increasing order and takes a score that is greater than its
// best, or a NaN when its best is none: so it keeps its first maximum
// and its first NaN. Across threads and CTAs each best becomes a 64-bit
// key, high word the float's bits made orderable as an unsigned integer
// (every NaN mapped to the top, -0.0 to +0.0), low word ~index, and the
// token is the largest key's index. A max of keys is exact and does not
// depend on the order it is taken in: every run gives the same token.
//
// What bounds it on an H100: bytes — two fp32 rows of V values read once
// (8 * V bytes per row, 1.2 MB at V = 152064), one int written; 2 FLOP
// per column. The score is formed as round(l + round(n * T)) with no
// fused multiply-add, so it is bit-identical to the plain PyTorch version;
// noise is read on greedy rows too (T = 0 with an infinite noise value
// gives a NaN score there, as in the plain version).
//
// Design: a row is split over a thread block cluster of `ctas` CTAs (up
// to 16, non-portable above 8), so B rows use B * ctas SMs, not B. CTA r
// takes the columns [r * share, (r + 1) * share) (the wrapper's plan,
// kernels/decode_attention/ops.py::sample_plan; share a multiple of 4,
// so interior edges are 16-byte aligned when the row is). Its 512
// threads load the slice's 16-byte-aligned body as float4 vectors, U = 4
// of each row in flight a thread before any is used (64 KB a CTA): a
// slice of up to 8192 columns takes one round of latency, V = 152064 and
// 256000 at 16 CTAs a row two. The unaligned head and tail of a slice (and all of it when
// logits and noise are misaligned against each other) take scalar
// loads. A warp and a block reduction of the keys give the CTA's key.
// The merge pushes: each CTA stores its key into slot r of rank 0's
// shared memory (distributed shared memory) and arrives on an mbarrier
// there; rank 0 waits for all of them, takes the max and writes the
// token, and no CTA waits for another to finish. The one cluster
// barrier, which makes rank 0's mbarrier visible before anyone arrives
// on it, is split: arrived at the start, waited on at the end. One
// launch, no atomics, no scratch buffer, no host sync. (A ring of 1-D
// bulk copies into shared memory, and a pull merge between two full
// cluster barriers, were slower: PERF.md.)
#include <stdint.h>

#include "decode_core.cuh"

namespace {

constexpr int NT = 512;
constexpr int U = 4;            // vectors of each row in flight a thread
constexpr int CLUSTER_MAX = 16;

__device__ __forceinline__ float score(float l, float n, float t) {
  return __fadd_rn(l, __fmul_rn(n, t));
}

// a thread's walk, in increasing column order: keep the first maximum
// and the first NaN (bi < 0: nothing seen yet)
__device__ __forceinline__ void take(float s, int i, float& best, int& bi) {
  if (bi < 0 || s > best || (s != s && best == best)) {
    best = s;
    bi = i;
  }
}

// the key of score s at column i: larger key = the better pick
__device__ __forceinline__ uint64_t key_of(float s, int i) {
  uint32_t u;
  if (s != s) {
    u = 0xffffffffu;                           // every NaN above +inf
  } else {
    u = s == 0.f ? 0u : __float_as_uint(s);    // -0.0 == +0.0
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((uint64_t)u << 32) | (uint32_t)~(uint32_t)i;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint64_t warp_max64(uint64_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t y = __shfl_xor_sync(0xffffffffu, x, off);
    x = y > x ? y : x;
  }
  return x;
}

// dynamic shared memory, in 8-byte words: NT / 32 warp keys, the merge's
// CLUSTER_MAX slots (read in rank 0 only), its mbarrier
constexpr int SMEM_WORDS = NT / 32 + CLUSTER_MAX + 1;

// grid (ctas, 1, B) in clusters of (ctas, 1, 1)
__global__ void __launch_bounds__(NT) sample_tokens_kernel(
    const float* __restrict__ logits, const float* __restrict__ noise,
    const float* __restrict__ temps, int* __restrict__ out, int V,
    int share) {
  extern __shared__ uint64_t keys[];
  uint64_t* slots = keys + NT / 32;
  const uint32_t bar = smem_addr(slots + CLUSTER_MAX);
  const uint32_t rank = blockIdx.x, ns = gridDim.x;  // one cluster a row
  const int tid = threadIdx.x, b = blockIdx.z;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(ns)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  const float* lr = logits + (size_t)b * V;
  const float* nr = noise + (size_t)b * V;
  const float t = temps[b];
  const int c0 = blockIdx.x * share, c1 = min(V, c0 + share);

  // the body: from the first 16-byte boundary of the logits row on, in
  // whole vectors, when the noise row is aligned there too
  const int skew = (int)((reinterpret_cast<uintptr_t>(lr + c0) & 15) / 4);
  int v0 = min(c1, c0 + ((4 - skew) & 3));
  int v1 = v0 + (c1 - v0) / 4 * 4;
  if (reinterpret_cast<uintptr_t>(nr + v0) & 15) v0 = v1 = c1;

  float best = 0.f;
  int bi = -1;
  for (int c = c0 + tid; c < v0; c += NT)          // head
    take(score(lr[c], nr[c], t), c, best, bi);
  const float4* L = reinterpret_cast<const float4*>(lr + v0);
  const float4* N = reinterpret_cast<const float4*>(nr + v0);
  const int n4 = (v1 - v0) / 4;
  for (int j0 = tid; j0 < n4; j0 += U * NT) {      // body
    float4 l[U], z[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u * NT < n4) {
        l[u] = __ldg(L + j0 + u * NT);
        z[u] = __ldg(N + j0 + u * NT);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NT, i = v0 + 4 * j;
      if (j < n4) {
        take(score(l[u].x, z[u].x, t), i, best, bi);
        take(score(l[u].y, z[u].y, t), i + 1, best, bi);
        take(score(l[u].z, z[u].z, t), i + 2, best, bi);
        take(score(l[u].w, z[u].w, t), i + 3, best, bi);
      }
    }
  }
  for (int c = v1 + tid; c < c1; c += NT)          // tail
    take(score(lr[c], nr[c], t), c, best, bi);

  uint64_t key = warp_max64(bi < 0 ? 0 : key_of(best, bi));
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) keys[warp] = key;
  __syncthreads();
  if (tid >= 32) return;
  key = warp_max64(lane < NT / 32 ? keys[lane] : 0);
  if (tid != 0) return;

  // the CTA's key -> slot `rank` of rank 0, then an arrival there
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  asm volatile("st.shared::cluster.u64 [%0], %1;\n" ::"r"(
                   in_rank(smem_addr(slots + rank), 0)),
               "l"(key)
               : "memory");
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          in_rank(bar, 0))
      : "memory");
  if (rank != 0) return;
  uint32_t done = 0, tries = 0;              // every rank's key is in
  do {
    if (++tries == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  } while (!done);
  for (uint32_t r = 0; r < ns; ++r) key = slots[r] > key ? slots[r] : key;
  out[b] = (int)~(uint32_t)key;
}

}  // namespace

// ctas, share: the wrapper's plan (1 <= ctas <= 16, share a positive
// multiple of 4, the ctas slices covering [0, V) with none empty)
extern "C" int sample_tokens(const void* logits, const void* noise,
                             const void* temps, void* out, int B, int V,
                             int ctas, int share, void* stream) {
  if (B <= 0 || B > 65535 || V <= 0 || ctas < 1 || ctas > CLUSTER_MAX ||
      share <= 0 || share % 4 != 0 || (long long)(ctas - 1) * share >= V ||
      (long long)ctas * share < V)
    return (int)cudaErrorInvalidValue;
  static int allowed[16] = {};
  return dc::launch_clusters(
      sample_tokens_kernel, allowed, NT, ctas, 1, B,
      SMEM_WORDS * sizeof(uint64_t), static_cast<cudaStream_t>(stream),
      static_cast<const float*>(logits), static_cast<const float*>(noise),
      static_cast<const float*>(temps), static_cast<int*>(out), V, share);
}
