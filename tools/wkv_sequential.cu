// The sequential form of the RWKV-6 WKV, as the port ran it before the
// chunked kernel of src/repro_torch/kernels/csrc/rwkv6_wkv.cu: kept only
// so that tools/wkv_variants.py can time the two in one call. Built with
// -I src/repro_torch/kernels/csrc; no path of the port calls it.
//
// Replaces the TPU kernel repro/kernels/rwkv6_wkv/rwkv6_wkv.py
// ::rwkv6_wkv: per (batch, head), with state S (K x K, fp32) from s0,
//   o_tj = sum_i r_ti (S_ij + u_i k_ti v_tj)
//   S_ij <- exp(logw_ti) S_ij + k_ti v_tj
// and s_final = S after the last token. The TPU kernel runs the chunked
// form (three MXU dots per chunk, pairwise decays in log space); this is
// the sequential form of the same function. logw <= 0 makes every decay
// lie in [0, 1]: a fast decay underflows to exactly 0 and never gives
// NaN or inf, the property the chunked form gets from its log space.
//
// What bounds it on an H100: bytes. Per token it reads r, k, v, logw
// (4 K floats) and writes o (K floats) and does ~4 K^2 FLOP per
// (batch, head); at K=64 that is 12.8 FLOP per byte, under the card's
// fp32 balance point (~20), so the least time is the bytes at 3.35 TB/s.
// The recurrence is serial in S and this form has only B*H CTAs of K
// threads, so in practice it is bound by the per-token latency of a
// K-long dependent sum per thread.
//
// Design: one CTA per (batch, head), K threads; thread j owns column j
// of S in K registers. Per token, thread j loads r_j, k_j, logw_j, v_j
// one token ahead into registers (coalesced across the CTA), stages
// (r_i, k_i, exp(logw_i), u_i k_i) as one float4 per i in shared memory
// (double-buffered: one barrier per token), then walks i: o_j collects
// r_i S_ij, the bonus collects r_i u_i k_i, and S_ij decays and takes
// k_i v_j. s_final is written once at the end (row i of the CTA's
// threads is one coalesced store). The chunked form on tensor cores is
// later work.
#include "common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(K) rwkv6_wkv_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ s_fin, int H, int S) {
  __shared__ float4 stage[2][K];
  const int bh = blockIdx.x;            // b * H + h
  const int h = bh % H;
  const int j = threadIdx.x;
  const size_t seq = (size_t)bh * S * K;
  const float* sb = s0 + (size_t)bh * K * K;

  float st[K];                          // column j of S
#pragma unroll
  for (int i = 0; i < K; ++i) st[i] = sb[(size_t)i * K + j];
  const float uj = u[(size_t)h * K + j];

  float rn = r[seq + j], kn = k[seq + j], wn = logw[seq + j],
        vn = v[seq + j];
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    stage[buf][j] = make_float4(rn, kn, expf(wn), uj * kn);
    const float vj = vn;
    __syncthreads();
    if (t + 1 < S) {                    // next token's inputs, ahead
      const size_t off = seq + (size_t)(t + 1) * K + j;
      rn = r[off];
      kn = k[off];
      wn = logw[off];
      vn = v[off];
    }
    float acc = 0.f, bonus = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float4 q = stage[buf][i];   // (r_i, k_i, w_i, u_i k_i)
      acc = fmaf(q.x, st[i], acc);
      bonus = fmaf(q.x, q.w, bonus);
      st[i] = fmaf(q.z, st[i], q.y * vj);
    }
    o[seq + (size_t)t * K + j] = fmaf(bonus, vj, acc);
  }
  float* sf = s_fin + (size_t)bh * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) sf[(size_t)i * K + j] = st[i];
}

}  // namespace

extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s0,
                         void* o, void* s_fin, int B, int H, int S, int K,
                         void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)B * (unsigned)H;
#define RT_WKV_CASE(K_)                                                      \
  case K_:                                                                   \
    rwkv6_wkv_kernel<K_><<<grid, K_, 0, st>>>(                               \
        static_cast<const float*>(r), static_cast<const float*>(k),          \
        static_cast<const float*>(v), static_cast<const float*>(logw),       \
        static_cast<const float*>(u), static_cast<const float*>(s0),         \
        static_cast<float*>(o), static_cast<float*>(s_fin), H, S);           \
    break;
  switch (K) {
    RT_WKV_CASE(32)
    RT_WKV_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_WKV_CASE
  return (int)cudaGetLastError();
}
