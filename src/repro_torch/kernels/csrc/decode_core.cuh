// The split walk shared by the decode-attention kernels of
// fused_paged_decode.cu (a page pool behind a block table) and
// decode_attention.cu (contiguous ring caches): one query token per
// (slot, kv head) against a run of valid K/V rows, with an fp32 softmax.
//
// Grid (splits, Hkv, B), one thread block cluster of `splits` CTAs per
// (kv head, slot), up to 16 (above 8 a non-portable cluster size, which
// Hopper allows). CTA r of a cluster takes the valid rows of the logical
// range [r * share, (r + 1) * share) — `splits` and `share` come from the
// wrapper's split plan (static shapes and the SM count, never from a
// length or position on the device): one wave of at most two CTAs an SM.
// A Rows policy maps a logical row to its K and V addresses (page and
// offset, the step's new token, or a ring slot); rows outside [a, e) are
// never read.
//
// Per CTA: the rows stream through a ring of NSTAGE tiles in shared
// memory by 16-byte cp.async, so the next tiles are in flight while this
// one computes; a tile's rows past e are zero-filled (cp.async with source
// size 0 reads no device memory). The threads (128 for one query head a
// kv head, 256 for a group: more channels for its heads) form channels:
// a lane group of LPT lanes holds one row's hd dims, DPL per lane; a
// channel owns up to GPC query heads of the group (HG head groups) and
// every RP-th row of a tile (RP row phases). A channel takes the scores
// of RC rows at a time for its heads (one shuffle reduction a row and
// head), then one max and one rescale per head, then P·V in fp32; m, l
// and its share of the accumulator stay in registers. After the walk the
// channels merge through shared memory into the CTA's partial (m, l,
// acc) and the cluster merges through distributed shared memory: CTA r
// merges a slice of the G·hd outputs over the ranks in rank order (a
// fixed order: the same inputs give the same bits) and writes it. Softmax runs in base 2 (scores
// pre-multiplied by log2 e) from a finite -1e30 start; an empty share
// reports m = -1e30, l = 0.
#pragma once
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace dc {

namespace cg = cooperative_groups;

constexpr int NSTAGE = 3;                // tiles in the cp.async ring
constexpr int TILE_BYTES = 8192;         // K bytes of one tile (V the same)
constexpr int RING_BYTES = NSTAGE * 2 * TILE_BYTES;
constexpr int GPC_MAX = 4;               // query heads per channel
constexpr int CLUSTER_MAX = 16;          // non-portable above 8

// threads of a CTA: one query head a kv head needs few channels; a group
// (GPC_MAX heads a channel) gets twice the channels for its heads
__host__ __device__ constexpr int block_threads(int gpc) {
  return gpc == 1 ? 128 : 256;
}
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The lanes see a row as HP = pow2_ceil(HD) dims, so a row's lanes divide
// a warp: at hd 96 and 112 (HP 128) the lanes past hd (LIVE and up) hold
// zeros and read and write nothing. A tile holds TR whole rows, HD apart
// in shared memory: the most that fit in TILE_BYTES, a multiple of the
// channel count (at 128 threads: 40 and 32 rows at hd 96 and 112 in bf16,
// 20 and 16 in fp32).
template <typename T, int HD, int NT>
struct Shape {
  static constexpr int NW = NT / 32;
  static constexpr int ES = sizeof(T);
  static constexpr int VEC = 16 / ES;                        // per 16 B
  static constexpr int HP = pow2_ceil(HD);
  static constexpr int DPL = VEC > HP / 32 ? VEC : HP / 32;  // dims a lane
  static constexpr int LPT = HP / DPL;                       // lanes a row
  static constexpr int LIVE = HD / DPL;                      // ... with dims
  static constexpr int SUB = 32 / LPT;                       // rows a warp
  static constexpr int NCH = NW * SUB;                       // channels
  static constexpr int TR = TILE_BYTES / (HD * ES) / NCH * NCH;  // rows a tile
  static constexpr int RC = TR / NCH;                        // rows a chunk
  static constexpr int VPR = HD / VEC;                       // vectors a row
  static constexpr int VPT = (TR * VPR + NT - 1) / NT;       // a thread's
  static_assert(HD % DPL == 0 && 32 % LPT == 0 && RC >= 1 &&
                    NCH >= GPC_MAX,
                "unsupported head dim");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N elements from a 16-byte-aligned address, as floats
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&dst)[N]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < N / V; ++j) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[j];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[j * V + i] = rt::to_float(e[i]);
  }
}

// a lane's DPL dims of a shared-memory row, or zeros on a lane past hd
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, bool live,
                                         float (&dst)[N]) {
  if (live) {
    load_f<T, N>(p, dst);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = 0.f;
  }
}

// a dead slot: every CTA of the cluster writes its slice of zeros and
// leaves before any cluster barrier
template <typename T>
__device__ __forceinline__ void zero_slice(T* ob, int E) {
  const int ns = gridDim.x, per = (E + ns - 1) / ns;
  const int e0 = blockIdx.x * per, e1 = min(E, e0 + per);
  for (int i = e0 + threadIdx.x; i < e1; i += blockDim.x)
    ob[i] = rt::from_float<T>(0.f);
}

// The walk over this CTA's valid rows [a, e) and the cluster merge; the
// CTA writes its slice of ob (G query heads x HD, the group of one kv
// head). Needs RING_BYTES of dynamic shared memory at smem; every CTA of
// the cluster must call it (the merge has two cluster barriers).
template <typename T, int HD, int GPC, class Rows>
__device__ __forceinline__ void walk_and_merge(const Rows& rows,
                                               const T* __restrict__ qb,
                                               T* __restrict__ ob, int G,
                                               int a, int e, float scale2,
                                               unsigned char* smem) {
  constexpr int NT = block_threads(GPC);
  using S = Shape<T, HD, NT>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane % S::LPT;
  const bool live = li < S::LIVE;          // false only past hd 96 / 112
  const int ch = warp * S::SUB + lane / S::LPT;
  int HG = 1;                              // head groups: HG * GPC >= G
  while (HG * GPC < G) HG <<= 1;
  const int RP = S::NCH / HG;              // row phases
  const int hg = ch % HG, rp = ch / HG;

  float q[GPC][S::DPL], acc[GPC][S::DPL], m[GPC], l[GPC];
#pragma unroll
  for (int i = 0; i < GPC; ++i) {
    const int g = hg + i * HG;
    if (g < G && live) {
      load_f<T, S::DPL>(qb + g * HD + li * S::DPL, q[i]);
    } else {
#pragma unroll
      for (int d = 0; d < S::DPL; ++d) q[i][d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < S::DPL; ++d) acc[i][d] = 0.f;
    m[i] = NEG;
    l[i] = 0.f;
  }

  T* ring = reinterpret_cast<T*>(smem);
  const int n = e > a ? e - a : 0;
  const int ntiles = (n + S::TR - 1) / S::TR;
  // tile t into stage t % NSTAGE; always one commit group, empty past the
  // last tile, so the wait counts stay uniform
  auto fetch = [&](int t) {
    if (t < ntiles) {
      T* kd = ring + (size_t)(t % NSTAGE) * 2 * S::TR * HD;
      T* vd = kd + S::TR * HD;
#pragma unroll
      for (int j = 0; j < S::VPT; ++j) {
        const int v = tid + j * NT;
        if (S::TR * S::VPR % NT != 0 && v >= S::TR * S::VPR) break;
        const int r = v / S::VPR, c = (v % S::VPR) * S::VEC;
        const int x = a + t * S::TR + r;
        const bool ok = x < e;
        const T* ks = rows.k_base();
        const T* vs = rows.v_base();
        if (ok) {
          rows.at(x, ks, vs);
          ks += c;
          vs += c;
        }
        cp_async16(kd + r * HD + c, ks, ok);
        cp_async16(vd + r * HD + c, vs, ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) fetch(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();                       // tile t landed; t-1 consumed
    fetch(t + NSTAGE - 1);
    const T* kt = ring + (size_t)(t % NSTAGE) * 2 * S::TR * HD;
    const T* vt = kt + S::TR * HD;
    const int nv = min(S::TR, n - t * S::TR);
    for (int r0 = 0; r0 < nv; r0 += S::RC * RP) {
      float s[S::RC][GPC];
#pragma unroll
      for (int k = 0; k < S::RC; ++k) {
        const int r = r0 + rp + k * RP;
        float kv[S::DPL];
        load_row(kt + r * HD + li * S::DPL, live, kv);
#pragma unroll
        for (int i = 0; i < GPC; ++i) {
          float part = 0.f;
#pragma unroll
          for (int d = 0; d < S::DPL; ++d) part = fmaf(q[i][d], kv[d], part);
#pragma unroll
          for (int off = S::LPT / 2; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          s[k][i] = r < nv ? part * scale2 : -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < GPC; ++i) {
        float mx = m[i];
#pragma unroll
        for (int k = 0; k < S::RC; ++k) mx = fmaxf(mx, s[k][i]);
        const float alpha = exp2f(m[i] - mx);
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < S::RC; ++k) {
          s[k][i] = exp2f(s[k][i] - mx);   // a masked row: exactly 0
          sum += s[k][i];
        }
        m[i] = mx;
        l[i] = fmaf(l[i], alpha, sum);
#pragma unroll
        for (int d = 0; d < S::DPL; ++d) acc[i][d] *= alpha;
      }
#pragma unroll
      for (int k = 0; k < S::RC; ++k) {
        const int r = r0 + rp + k * RP;
        float vv[S::DPL];
        load_row(vt + r * HD + li * S::DPL, live, vv);
#pragma unroll
        for (int i = 0; i < GPC; ++i)
#pragma unroll
          for (int d = 0; d < S::DPL; ++d)
            acc[i][d] = fmaf(s[k][i], vv[d], acc[i][d]);
      }
    }
  }

  // the channels' states → the CTA's partial, in row-phase order
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free
  // at most 8,192 + 2 * 64 + 2 * 16 floats (G = 16, hd 256, 256 threads),
  // within the ring's 12,288
  float* pacc = reinterpret_cast<float*>(smem);   // [RP][G][HD]
  float* pm = pacc + RP * G * HD;                  // [RP][G]
  float* pl = pm + RP * G;
  float* cm = pl + RP * G;                         // [G]
  float* cl = cm + G;
  float* cacc = pacc;    // [G][HD], over row phase 0: each element is read
                         // and then written by the same thread
#pragma unroll
  for (int i = 0; i < GPC; ++i) {
    const int g = hg + i * HG;
    if (g < G) {
      if (live)
#pragma unroll
        for (int d = 0; d < S::DPL; ++d)
          pacc[(rp * G + g) * HD + li * S::DPL + d] = acc[i][d];
      if (li == 0) {
        pm[rp * G + g] = m[i];
        pl[rp * G + g] = l[i];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += NT) {
    const int g = idx / HD;
    float mx = NEG;
    for (int p = 0; p < RP; ++p) mx = fmaxf(mx, pm[p * G + g]);
    float sum = 0.f, x = 0.f;
    for (int p = 0; p < RP; ++p) {
      const float w = exp2f(pm[p * G + g] - mx);
      sum = fmaf(pl[p * G + g], w, sum);
      x = fmaf(pacc[p * G * HD + idx], w, x);
    }
    cacc[idx] = x;
    if (idx % HD == 0) {
      cm[g] = mx;
      cl[g] = sum;
    }
  }

  // the cluster's partials → this CTA's slice of the output, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ns = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int E = G * HD, per = (E + ns - 1) / ns;
  const int e0 = rank * per, e1 = min(E, e0 + per);
  for (int idx = e0 + tid; idx < e1; idx += NT) {
    const int g = idx / HD;
    float mx = NEG;
    for (int r = 0; r < ns; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(cm, r)[g]);
    float sum = 0.f, x = 0.f;
    for (int r = 0; r < ns; ++r) {
      const float w = exp2f(cluster.map_shared_rank(cm, r)[g] - mx);
      sum = fmaf(cluster.map_shared_rank(cl, r)[g], w, sum);
      x = fmaf(cluster.map_shared_rank(cacc, r)[idx], w, x);
    }
    ob[idx] = rt::from_float<T>(x / fmaxf(sum, 1e-30f));
  }
  cluster.sync();                          // no CTA leaves while read
}

// Launch `kernel` on a (splits, Hkv, B) grid of `nt`-thread CTAs in
// clusters of `splits` with `smem` bytes of dynamic shared memory.
// `allowed` holds, per device, the largest size already allowed for this
// kernel; the first launch on a device also allows clusters above 8.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int* allowed, int nt,
                    int splits, int Hkv, int B, size_t smem, cudaStream_t st,
                    Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  if ((int)smem > allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dc
