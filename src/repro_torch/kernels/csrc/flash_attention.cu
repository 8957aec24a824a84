// Causal / sliding-window GQA flash attention, forward only.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// ::flash_attention (_fa_kernel): same maths (online softmax in fp32,
// scores scaled by 1/sqrt(hd), -inf-safe masking, KV head = q_head / G
// with no repeated K/V), model layout (B, S, H, hd) read in place.
//
// What bounds it on an H100: at the serving path's prefill shapes
// (B=1, 16 heads, hd=64, S of a prompt, i.e. tens to a few hundred
// tokens) the work is a few MFLOP and the bytes are a few hundred KB, so
// the kernel is bound by latency and occupancy, not by either roofline;
// at long S it is bound by operations (S^2 * hd per head).
//
// Design: one CTA per (q tile, q head, batch row) of 256 threads; TPR
// threads per q row (4, or 8 at hd=256), each owning hd/TPR interleaved
// dims of the q row and of the fp32 accumulator in registers, partial
// dot products combined with xor-shuffles. K/V tiles of BN keys (32, or
// 16 at hd=256 so the two fp32 tiles stay at 32 KB, under the 48 KB of
// static shared memory) are staged in shared memory as fp32 and read by
// every row of the tile (broadcast, conflict-free since the threads of a
// row read consecutive words). At hd=256 a CTA holds 32 q rows. Tiles wholly above the
// causal diagonal or wholly outside the window are never visited (the
// TPU grid visits and masks them); the ragged Sq/Sk edge is masked in
// the kernel instead of padded. Scalar FMAs, no tensor cores: wgmma/TMA
// is later work.
#include "common.cuh"

namespace {

constexpr int NT = 256;         // threads per CTA

// tile shape per head dim: threads per q row, q rows and keys per tile
template <int HD> struct Tile {
  static constexpr int TPR = HD >= 256 ? 8 : 4;
  static constexpr int BM = NT / TPR;
  static constexpr int BN = HD >= 256 ? 16 : 32;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int Hq,
    int Hkv, int causal, int window, float scale) {
  constexpr int TPR = Tile<HD>::TPR;
  constexpr int BM = Tile<HD>::BM;
  constexpr int BN = Tile<HD>::BN;
  constexpr int DPT = HD / TPR;
  __shared__ float ks[BN][HD];
  __shared__ float vs[BN][HD];

  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int qi = m0 + r;
  const bool row_ok = qi < Sq;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = sub + TPR * i;
    qr[i] = row_ok ? rt::to_float(q[((size_t)(b * Sq + qi) * Hq + h) * HD + d])
                   : 0.f;
    acc[i] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  // visit only tiles that hold a key some row of this q tile may see
  const int n_end = causal ? min(Sk, m0 + BM) : Sk;
  const int n_begin = window > 0 ? max(0, m0 - window + 1) / BN * BN : 0;

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    __syncthreads();
    for (int idx = tid; idx < BN * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      const int key = n0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        const size_t off = ((size_t)(b * Sk + key) * Hkv + hk) * HD + d;
        kv = rt::to_float(k[off]);
        vv = rt::to_float(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[BN];
    float tile_max = -1e30f;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[j][sub + TPR * i];
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int key = n0 + j;
      const bool ok = key < Sk && (!causal || key <= qi) &&
                      (window <= 0 || qi - key < window);
      s[j] = ok ? part * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      s[j] = expf(s[j] - m_new);          // masked keys: exp(-inf) = 0
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += s[j] * vs[j][sub + TPR * i];
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + TPR * i;
      o[((size_t)(b * Sq + qi) * Hq + h) * HD + d] =
          rt::from_float<T>(acc[i] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int Hq, int Hkv, int hd, int causal, int window,
           float scale, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
#define RT_FA_CASE(HD_)                                                     \
  case HD_: {                                                               \
    const dim3 grid((Sq + Tile<HD_>::BM - 1) / Tile<HD_>::BM, Hq, B);       \
    flash_fwd_kernel<T, HD_><<<grid, NT, 0, st>>>(qq, kk, vv, oo, Sq, Sk,   \
                                                  Hq, Hkv, causal, window,  \
                                                  scale);                   \
    break;                                                                  \
  }
  switch (hd) {
    RT_FA_CASE(16)
    RT_FA_CASE(32)
    RT_FA_CASE(64)
    RT_FA_CASE(128)
    RT_FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_FA_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Sq, int Sk, int Hq, int Hkv, int hd,
                                   int causal, int window, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window,
                         scale, st);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal,
                                 window, scale, st);
  return (int)cudaErrorInvalidValue;
}
