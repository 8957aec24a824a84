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
// tok >= len - window, the online softmax runs in fp32 from a finite
// -1e30 start.
//
// What bounds it on an H100: bytes. Each slot reads its live K/V rows
// once (len * Hkv * hd * 2 * sizeof(T)) and does 4 * G * hd FLOP per row;
// at the serving shapes (B=4, Hkv=16, hd=64, a few hundred tokens) that
// is ~1 MB, well under a microsecond of HBM time, so in practice the
// kernel is bound by latency: a chain of dependent page loads per CTA.
// recurrentgemma's MQA (Hkv=1, G=10, hd=256) gives only B CTAs.
//
// Design: one CTA per (kv head, slot); the CTA reads its own length and
// block-table entries (no scalar prefetch on this card) and walks only
// the pages that hold live tokens. One warp per token row computes the
// scores of all G query heads of the group from one load of the row, so
// the G heads share every K/V page read. Masked rows are never loaded:
// a NaN left in a recycled page cannot reach p * v. Per page, one thread
// per head updates the running max and sum, then the CTA updates the
// fp32 accumulator (kept in shared memory) with the page's V rows.
#include "common.cuh"

namespace {

constexpr int NT = 128;

template <typename T, int HD, bool HAS_NEW>
__global__ void __launch_bounds__(NT) fused_paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ lengths,
    const int* __restrict__ block_tables, T* __restrict__ out, int Hq,
    int Hkv, int ps, int nb, int window, float scale) {
  constexpr int CPL = (HD + 31) / 32;     // dims per lane
  extern __shared__ float sm[];
  const int G = Hq / Hkv;
  float* q_s = sm;                        // G * HD
  float* acc = q_s + G * HD;              // G * HD
  float* sc = acc + G * HD;               // G * ps scores, then weights
  float* m_s = sc + G * ps;               // G
  float* l_s = m_s + G;                   // G
  float* a_s = l_s + G;                   // G

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int len = lengths[b];
  T* ob = out + ((size_t)b * Hq + (size_t)hk * G) * HD;

  if (len <= 0) {                         // dead slot
    for (int i = tid; i < G * HD; i += blockDim.x) ob[i] = rt::from_float<T>(0.f);
    return;
  }
  const T* qb = q + ((size_t)b * Hq + (size_t)hk * G) * HD;
  for (int i = tid; i < G * HD; i += blockDim.x) {
    q_s[i] = rt::to_float(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = -1e30f;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int last = len - 1;               // the last valid token
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int j0 = lo / ps;
  const int j1 = min(last / ps, nb - 1);
  const size_t tok_stride = (size_t)Hkv * HD;
  const T* kn = HAS_NEW ? k_new + ((size_t)b * Hkv + hk) * HD : nullptr;
  const T* vn = HAS_NEW ? v_new + ((size_t)b * Hkv + hk) * HD : nullptr;

  for (int j = j0; j <= j1; ++j) {
    const size_t page = (size_t)block_tables[(size_t)b * nb + j];
    const T* kp = k_pages + page * ps * tok_stride + (size_t)hk * HD;
    const T* vp = v_pages + page * ps * tok_stride + (size_t)hk * HD;

    for (int t = warp; t < ps; t += nw) {
      const int tok = j * ps + t;
      if (tok >= lo && tok <= last) {
        const T* kr = HAS_NEW && tok == last ? kn
                                             : kp + (size_t)t * tok_stride;
        float kv[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int d = lane + 32 * i;
          kv[i] = d < HD ? rt::to_float(kr[d]) : 0.f;
        }
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < CPL; ++i) {
            const int d = lane + 32 * i;
            if (d < HD) part += q_s[g * HD + d] * kv[i];
          }
          part = rt::warp_sum(part);
          if (lane == 0) sc[g * ps + t] = part * scale;
        }
      } else if (lane == 0) {
        for (int g = 0; g < G; ++g) sc[g * ps + t] = -INFINITY;
      }
    }
    __syncthreads();

    for (int g = tid; g < G; g += blockDim.x) {
      float mx = m_s[g];
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[g * ps + t]);
      const float alpha = expf(m_s[g] - mx);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sc[g * ps + t] - mx);   // masked: exactly 0
        sc[g * ps + t] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = mx;
      a_s[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += blockDim.x) {
      const int g = i / HD, d = i % HD;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < ps; ++t) {
        const int tok = j * ps + t;
        if (tok < lo || tok > last) continue;        // never load masked rows
        const T* vr = HAS_NEW && tok == last ? vn
                                             : vp + (size_t)t * tok_stride;
        a += sc[g * ps + t] * rt::to_float(vr[d]);
      }
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * HD; i += blockDim.x)
    ob[i] = rt::from_float<T>(acc[i] / fmaxf(l_s[i / HD], 1e-30f));
}

template <typename T, bool HAS_NEW>
int launch(const void* q, const void* kn, const void* vn, const void* kp,
           const void* vp, const int* lens, const int* bt, void* out, int B,
           int Hq, int Hkv, int hd, int ps, int nb, int window, float scale,
           cudaStream_t st) {
  const int G = Hq / Hkv;
  // G * hd = 2560 (recurrentgemma, 10/1 at hd 256) needs ~21 KB
  const size_t smem = sizeof(float) * ((size_t)2 * G * hd + (size_t)G * ps +
                                       3 * (size_t)G);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
#define RT_FD_CASE(HD_)                                                     \
  case HD_:                                                                 \
    fused_paged_decode_kernel<T, HD_, HAS_NEW><<<grid, NT, smem, st>>>(     \
        static_cast<const T*>(q), static_cast<const T*>(kn),                \
        static_cast<const T*>(vn), static_cast<const T*>(kp),               \
        static_cast<const T*>(vp), lens, bt, static_cast<T*>(out), Hq, Hkv, \
        ps, nb, window, scale);                                             \
    break;
  switch (hd) {
    RT_FD_CASE(16)
    RT_FD_CASE(32)
    RT_FD_CASE(64)
    RT_FD_CASE(128)
    RT_FD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_FD_CASE
  return (int)cudaGetLastError();
}

template <bool HAS_NEW>
int dispatch(const void* q, const void* k_new, const void* v_new,
             const void* k_pages, const void* v_pages, const void* lengths,
             const void* block_tables, void* out, int dtype, int B, int Hq,
             int Hkv, int hd, int ps, int nb, int window, float scale,
             void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int* bt = static_cast<const int*>(block_tables);
  if (dtype == rt::kFloat32)
    return launch<float, HAS_NEW>(q, k_new, v_new, k_pages, v_pages, lens,
                                  bt, out, B, Hq, Hkv, hd, ps, nb, window,
                                  scale, st);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16, HAS_NEW>(q, k_new, v_new, k_pages, v_pages,
                                          lens, bt, out, B, Hq, Hkv, hd, ps,
                                          nb, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused_paged_decode_attention(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* lengths, const void* block_tables,
    void* out, int dtype, int B, int Hq, int Hkv, int hd, int ps, int nb,
    int window, float scale, void* stream) {
  return dispatch<true>(q, k_new, v_new, k_pages, v_pages, lengths,
                        block_tables, out, dtype, B, Hq, Hkv, hd, ps, nb,
                        window, scale, stream);
}

// lengths count the valid tokens, all of them in the pool
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* block_tables, void* out, int dtype,
    int B, int Hq, int Hkv, int hd, int ps, int nb, int window, float scale,
    void* stream) {
  return dispatch<false>(q, nullptr, nullptr, k_pages, v_pages, lengths,
                         block_tables, out, dtype, B, Hq, Hkv, hd, ps, nb,
                         window, scale, stream);
}
