// Paged decode attention: one query token per serving slot against a
// shared physical page pool. Two entries, one kernel template:
//
// * fused_paged_decode_attention (HAS_NEW) replaces the TPU kernel
//   repro/kernels/decode_attention/decode_attention.py
//   ::fused_paged_decode_attention (_fused_kernel): the step's new K/V
//   are substituted at logical index lengths-1 (the pool does not hold
//   them yet);
// * paged_decode_attention (!HAS_NEW) replaces ::paged_decode_attention
//   (_paged_kernel): every valid token is read from the pool.
//
// Same contract as the TPU kernels — lengths count the valid tokens,
// lengths == 0 (a dead slot) writes zeros, a sliding window keeps
// tok >= len - window, the softmax runs in fp32 from a finite -1e30
// start.
//
// What bounds it on an H100: bytes. Each slot reads its live K/V rows
// once (len * Hkv * hd * 2 * sizeof(T)) and does 4 * G * hd FLOP a row,
// ~1 FLOP a byte. At the serving shapes (B=4, a few hundred tokens) that
// is well under a microsecond of HBM time, so what sets the pace is
// latency: how many CTAs walk how long a chain of dependent page loads.
// One CTA per (kv head, slot) gave 64 CTAs for qwen (16 kv heads) and 4
// for recurrentgemma's MQA on 132 SMs, each walking every page of its
// slot one after another.
//
// Design (decode_core.cuh): the walk is split. A cluster of `splits` CTAs
// per (kv head, slot), each taking a page-aligned share of the slot's
// logical tokens (the wrapper's split plan, from static shapes only: one
// wave of at most two CTAs an SM, 4 a pair for qwen, 16 for the MQA of
// recurrentgemma, whose 10 query heads get 256 threads). A CTA reads its
// share of the block table into shared memory once, then streams its
// valid rows as 16-byte cp.async copies through a 3-tile ring (the next
// tiles in flight while
// one computes; a masked row is never read, so a NaN left in a recycled
// page cannot reach p * v). Scores are taken per chunk of rows, with one
// max and one rescale per chunk and head; m, l and the accumulator live
// in registers. The cluster merges its partials through distributed
// shared memory in rank order within the same launch: one launch a call,
// no host sync, the same bits every run.
#include "decode_core.cuh"

namespace {

template <typename T, bool HAS_NEW>
struct PagedRows {
  const T* kp;            // pool rows of this kv head (offset hk * HD)
  const T* vp;
  const T* kn;            // the step's new K/V row of (slot, kv head)
  const T* vn;
  const int* tab;         // this CTA's block-table entries, from page0
  int page0, ps, last;
  size_t tok_stride;      // Hkv * HD

  __device__ __forceinline__ const T* k_base() const { return kp; }
  __device__ __forceinline__ const T* v_base() const { return vp; }
  __device__ __forceinline__ void at(int x, const T*& k, const T*& v) const {
    if (HAS_NEW && x == last) {
      k = kn;
      v = vn;
      return;
    }
    const int j = x / ps;
    const size_t off =
        ((size_t)tab[j - page0] * ps + (size_t)(x - j * ps)) * tok_stride;
    k = kp + off;
    v = vp + off;
  }
};

template <typename T, int HD, int GPC, bool HAS_NEW>
__global__ void __launch_bounds__(dc::block_threads(GPC))
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ lengths,
    const int* __restrict__ block_tables, T* __restrict__ out, int Hq,
    int Hkv, int ps, int nb, int window, int share, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int len = lengths[b];
  T* ob = out + ((size_t)b * Hq + (size_t)hk * G) * HD;
  if (len <= 0) {                          // dead slot: the whole cluster
    dc::zero_slice(ob, G * HD);
    return;
  }
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int t0 = blockIdx.x * share;
  const int a = max(t0, lo);
  const int e = min(min(t0 + share, len), nb * ps);
  int* tab = reinterpret_cast<int*>(smem + dc::RING_BYTES);
  const int page0 = a / ps;
  if (e > a)
    for (int j = page0 + (int)threadIdx.x; j <= (e - 1) / ps;
         j += blockDim.x)
      tab[j - page0] = block_tables[(size_t)b * nb + j];
  __syncthreads();
  const size_t tok_stride = (size_t)Hkv * HD;
  const PagedRows<T, HAS_NEW> rows{
      k_pages + (size_t)hk * HD, v_pages + (size_t)hk * HD,
      HAS_NEW ? k_new + ((size_t)b * Hkv + hk) * HD : nullptr,
      HAS_NEW ? v_new + ((size_t)b * Hkv + hk) * HD : nullptr,
      tab, page0, ps, len - 1, tok_stride};
  dc::walk_and_merge<T, HD, GPC>(rows,
                                 q + ((size_t)b * Hq + (size_t)hk * G) * HD,
                                 ob, G, a, e, scale2, smem);
}

template <typename T, int HD, int GPC, bool HAS_NEW>
int launch(const void* q, const void* kn, const void* vn, const void* kp,
           const void* vp, const int* lens, const int* bt, void* out, int B,
           int Hq, int Hkv, int ps, int nb, int window, int splits,
           int share, float scale, cudaStream_t st) {
  static int allowed[16] = {};
  const size_t smem = dc::RING_BYTES + sizeof(int) * (size_t)(share / ps);
  return dc::launch_clusters(
      paged_decode_kernel<T, HD, GPC, HAS_NEW>, allowed,
      dc::block_threads(GPC), splits, Hkv, B, smem, st,
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lens, bt, static_cast<T*>(out), Hq, Hkv,
      ps, nb, window, share, scale * dc::LOG2E);
}

template <typename T, int HD, bool HAS_NEW>
int launch_g(const void* q, const void* kn, const void* vn, const void* kp,
             const void* vp, const int* lens, const int* bt, void* out,
             int B, int Hq, int Hkv, int ps, int nb, int window, int splits,
             int share, float scale, cudaStream_t st) {
  if (Hq == Hkv)
    return launch<T, HD, 1, HAS_NEW>(q, kn, vn, kp, vp, lens, bt, out, B, Hq,
                                     Hkv, ps, nb, window, splits, share,
                                     scale, st);
  return launch<T, HD, dc::GPC_MAX, HAS_NEW>(q, kn, vn, kp, vp, lens, bt,
                                             out, B, Hq, Hkv, ps, nb, window,
                                             splits, share, scale, st);
}

template <typename T, bool HAS_NEW>
int launch_hd(const void* q, const void* kn, const void* vn, const void* kp,
              const void* vp, const int* lens, const int* bt, void* out,
              int B, int Hq, int Hkv, int hd, int ps, int nb, int window,
              int splits, int share, float scale, cudaStream_t st) {
#define RT_FD_CASE(HD_)                                                     \
  case HD_:                                                                 \
    return launch_g<T, HD_, HAS_NEW>(q, kn, vn, kp, vp, lens, bt, out, B,   \
                                     Hq, Hkv, ps, nb, window, splits, share, \
                                     scale, st);
  switch (hd) {
    RT_FD_CASE(16)
    RT_FD_CASE(32)
    RT_FD_CASE(64)
    RT_FD_CASE(96)
    RT_FD_CASE(112)
    RT_FD_CASE(128)
    RT_FD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_FD_CASE
}

template <bool HAS_NEW>
int dispatch(const void* q, const void* k_new, const void* v_new,
             const void* k_pages, const void* v_pages, const void* lengths,
             const void* block_tables, void* out, int dtype, int B, int Hq,
             int Hkv, int hd, int ps, int nb, int window, int splits,
             int share, float scale, void* stream) {
  // G <= GPC_MAX * 4 (four head groups at most); the split plan gives
  // whole pages, at most CLUSTER_MAX CTAs a cluster
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 4 * dc::GPC_MAX ||
      ps <= 0 || nb <= 0 || splits < 1 || splits > dc::CLUSTER_MAX ||
      share <= 0 || share % ps != 0 ||
      (long long)splits * share < (long long)nb * ps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int* bt = static_cast<const int*>(block_tables);
  if (dtype == rt::kFloat32)
    return launch_hd<float, HAS_NEW>(q, k_new, v_new, k_pages, v_pages, lens,
                                     bt, out, B, Hq, Hkv, hd, ps, nb, window,
                                     splits, share, scale, st);
  if (dtype == rt::kBFloat16)
    return launch_hd<__nv_bfloat16, HAS_NEW>(
        q, k_new, v_new, k_pages, v_pages, lens, bt, out, B, Hq, Hkv, hd, ps,
        nb, window, splits, share, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused_paged_decode_attention(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* lengths, const void* block_tables,
    void* out, int dtype, int B, int Hq, int Hkv, int hd, int ps, int nb,
    int window, int splits, int share, float scale, void* stream) {
  return dispatch<true>(q, k_new, v_new, k_pages, v_pages, lengths,
                        block_tables, out, dtype, B, Hq, Hkv, hd, ps, nb,
                        window, splits, share, scale, stream);
}

// lengths count the valid tokens, all of them in the pool
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* block_tables, void* out, int dtype,
    int B, int Hq, int Hkv, int hd, int ps, int nb, int window, int splits,
    int share, float scale, void* stream) {
  return dispatch<false>(q, nullptr, nullptr, k_pages, v_pages, lengths,
                         block_tables, out, dtype, B, Hq, Hkv, hd, ps, nb,
                         window, splits, share, scale, stream);
}
