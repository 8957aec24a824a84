// One-token GQA decode attention over contiguous ring caches.
//
// Replaces the TPU kernel repro/kernels/decode_attention/
// decode_attention.py::decode_attention (_kernel): q (B,1,Hq,hd) against
// per-slot ring caches k/v (B,C,Hkv,hd) sharing one scalar position pos.
// A slot is valid if slot <= pos or the ring is full (pos >= C); with a
// window, only slots whose ring age (pos%C - slot) mod C is < window.
// Softmax is fp32 from a finite -1e30 start; the output is written in the
// input dtype. hd in {16, 32, 64, 96, 112, 128, 256}, Hq / Hkv up to 16.
//
// The valid slots are always the last n = min(pos+1, C[, window]) slots
// in ring order, ending at pos % C: logical row j in [0, n) is slot
// (start + j) mod C, at most two contiguous runs. The kernel reads
// exactly those and never any other slot, so a NaN in an unwritten slot
// cannot reach p * v (the TPU kernel multiplies p = 0 into every slot it
// visits). pos is read from a device int32 when one is given, so a
// decode step needs no host sync; otherwise it is the value passed by
// the host.
//
// What bounds it on an H100: bytes. Each (slot, kv head) reads its n live
// K and V rows once (2 * n * hd * sizeof(T)) and does 4 * G * hd FLOP a
// row: ~1 FLOP a byte, far below the card's balance point. At B=4, 16
// kv heads and a full 4096-slot ring that is 67 MB, 20 us at 3.35 TB/s.
// One CTA per (kv head, slot) put 64 CTAs on 132 SMs, each streaming
// 4,096 rows with 32 in flight (~730 GB/s).
//
// Design (decode_core.cuh, shared with the paged kernels): a cluster of
// `splits` CTAs per (kv head, slot), each taking a contiguous share of
// the logical rows [0, C) (4 x 1024 at that shape: 256 CTAs, one wave of
// ~2 an SM; 8 x 512 needed two waves, since only 62 clusters of 8 fit at
// once); each streams its rows through a 3-tile cp.async ring of 8 KB K +
// 8 KB V tiles, up to 32 KB a CTA in flight; scores per chunk of rows,
// one max and one rescale per chunk and head, state in registers; the
// cluster merges its partials through distributed shared memory in rank
// order within the same launch.
#include "decode_core.cuh"

namespace {

template <typename T>
struct RingRows {
  const T* k;             // slot 0 of (slot b, kv head)
  const T* v;
  int start, C;
  size_t row;             // Hkv * HD

  __device__ __forceinline__ const T* k_base() const { return k; }
  __device__ __forceinline__ const T* v_base() const { return v; }
  __device__ __forceinline__ void at(int x, const T*& kr,
                                     const T*& vr) const {
    int slot = start + x;
    if (slot >= C) slot -= C;
    kr = k + (size_t)slot * row;
    vr = v + (size_t)slot * row;
  }
};

template <typename T, int HD, int GPC>
__global__ void __launch_bounds__(dc::block_threads(GPC))
    ring_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    const int* __restrict__ pos_ptr, int pos_val, int C, int Hq, int Hkv,
    int window, int share, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int pos = pos_ptr != nullptr ? *pos_ptr : pos_val;
  int n = pos >= C ? C : pos + 1;
  if (window > 0 && window < n) n = window;
  T* ob = out + ((size_t)b * Hq + (size_t)hk * G) * HD;
  if (n <= 0) {                            // the whole cluster leaves
    dc::zero_slice(ob, G * HD);
    return;
  }
  int start = pos % C - n + 1;             // first valid slot in ring order
  if (start < 0) start += C;
  const int a = blockIdx.x * share;
  const int e = min(a + share, n);
  const size_t row = (size_t)Hkv * HD;
  const size_t base = ((size_t)b * C * Hkv + hk) * HD;
  const RingRows<T> rows{k + base, v + base, start, C, row};
  dc::walk_and_merge<T, HD, GPC>(rows,
                                 q + ((size_t)b * Hq + (size_t)hk * G) * HD,
                                 ob, G, a, e, scale2, smem);
}

template <typename T, int HD, int GPC>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* pos_ptr, int pos_val, int B, int C, int Hq, int Hkv,
           int window, int splits, int share, float scale, cudaStream_t st) {
  static int allowed[16] = {};
  return dc::launch_clusters(
      ring_decode_kernel<T, HD, GPC>, allowed, dc::block_threads(GPC),
      splits, Hkv, B, (size_t)dc::RING_BYTES, st, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), pos_ptr, pos_val, C, Hq, Hkv, window, share,
      scale * dc::LOG2E);
}

template <typename T, int HD>
int launch_g(const void* q, const void* k, const void* v, void* out,
             const int* pos_ptr, int pos_val, int B, int C, int Hq, int Hkv,
             int window, int splits, int share, float scale,
             cudaStream_t st) {
  if (Hq == Hkv)
    return launch<T, HD, 1>(q, k, v, out, pos_ptr, pos_val, B, C, Hq, Hkv,
                            window, splits, share, scale, st);
  return launch<T, HD, dc::GPC_MAX>(q, k, v, out, pos_ptr, pos_val, B, C, Hq,
                                    Hkv, window, splits, share, scale, st);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              const int* pos_ptr, int pos_val, int B, int C, int Hq, int Hkv,
              int hd, int window, int splits, int share, float scale,
              cudaStream_t st) {
#define RT_RD_CASE(HD_)                                                   \
  case HD_:                                                               \
    return launch_g<T, HD_>(q, k, v, out, pos_ptr, pos_val, B, C, Hq, Hkv, \
                            window, splits, share, scale, st);
  switch (hd) {
    RT_RD_CASE(16)
    RT_RD_CASE(32)
    RT_RD_CASE(64)
    RT_RD_CASE(96)
    RT_RD_CASE(112)
    RT_RD_CASE(128)
    RT_RD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_RD_CASE
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, const void* pos_ptr, int pos_val,
                                int dtype, int B, int C, int Hq, int Hkv,
                                int hd, int window, int splits, int share,
                                float scale, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > 4 * dc::GPC_MAX || splits < 1 ||
      splits > dc::CLUSTER_MAX || share <= 0 ||
      (long long)splits * share < C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(pos_ptr);
  if (dtype == rt::kFloat32)
    return launch_hd<float>(q, k, v, out, pp, pos_val, B, C, Hq, Hkv, hd,
                            window, splits, share, scale, st);
  if (dtype == rt::kBFloat16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, pp, pos_val, B, C, Hq, Hkv,
                                    hd, window, splits, share, scale, st);
  return (int)cudaErrorInvalidValue;
}
