// RWKV-6 WKV: matrix-state linear recurrence with per-channel,
// data-dependent decays and a bonus for the current token (rwkv6-7b).
//
// Replaces the TPU kernel repro/kernels/rwkv6_wkv/rwkv6_wkv.py
// ::rwkv6_wkv: per (batch, head), with state S (K x K, fp32) from s0,
//   o_tj = sum_i r_ti (S_ij + u_i k_ti v_tj)
//   S_ij <- exp(logw_ti) S_ij + k_ti v_tj
// and s_final = S after the last token. Like the TPU kernel, this is the
// chunked form: per chunk of C tokens, with L the inclusive cumulative
// log decay inside the chunk (Lp = L - logw, the exclusive one),
//   o     = (r e^Lp) S  +  A v,    A_ts = sum_i r_ti k_si e^(Lp_ti - L_si)
//           (s < t), A_tt = sum_i r_ti u_i k_ti (the bonus);
//   S_new = e^L_last S  +  (k e^(L_last - L))^T v.
//
// What bounds it on an H100: per token it reads r, k, v, logw (4 K
// floats) and writes o (K floats) and does ~4 K^2 FLOP per (batch,
// head): 12.8 FLOP a byte at K=64, under the card's fp32 balance point
// (~20), so the least time is the bytes. A sequential form spends a
// K-long dependent sum and a barrier on every token on B*H CTAs of K
// threads; this form takes a chunk of tokens a step, its products in
// parallel over the chunk's tokens and the state's rows and columns.
// At B=1 the chunks are still serial, and each costs a chain of phases
// and barriers; at B=4 the two state products (4) and (5) take most of
// the time (PERF.md, the WKV row).
//
// Numerics: logw has no lower bound, so e^-L overflows once a chunk's
// decay passes ~88 (two tokens at logw = -50); the naive factorisation
// (r e^Lp)(k e^-L)^T is not used. Every exponent here is <= 0:
// - the inter-chunk term r e^Lp and the state update k e^(L_last - L);
// - the chunk splits into sub-blocks of SB = 8 tokens. For query block I
//   after key block J, with m_I = I*SB - 1 (the row before I) and e_J the
//   last row of J, A_ts = sum_i qh_ti d_IJi kh_si where
//   qh = r e^(Lp - L_mI), kh = k e^(L_eJ - L), d_IJ = e^(L_mI - L_eJ):
//   three factors in [0, 1] times r and k, so a decay underflows to an
//   exact 0 and nothing overflows;
// - inside a diagonal block, pair by pair in log space, as the TPU kernel
//   does for its whole chunk.
// A fast decay gives exact zeros and never a NaN or an inf.
//
// Design: one CTA of NT = 256 threads per (V slice, head, batch): the
// wrapper splits the state's K columns into nv slices of vs = K/nv (the
// column j of S and o depends on v_j alone) so that B = 1 still fills
// the card; each slice recomputes the chunk's scores. Per chunk, between
// barriers: (1) L by a scan, a few lanes a channel; (2) the decay-scaled
// operands; (3a) the scores outside the diagonal blocks, a few lanes a
// query row, so the kind of each key block is uniform across a warp;
// (3b) the diagonal blocks' pairs, four lanes a pair; then the next
// chunk's r, k, logw and v slice are put in flight by 16-byte cp.async
// (v into the other half of a double buffer; the ragged last chunk is
// zero-filled past S: logw = 0 keeps L_last, r = k = v = 0 add nothing,
// and its rows past S are not stored) while (4) o and (5) the state
// slice are computed in 2 x 4 and 4 x 4 register tiles. State, operands
// and scores stay in shared memory (rows padded by 4 floats to spread
// the banks); s_final is written once. SIMT fp32: (4) and (5) on the
// tensor cores (mma.sync in 3xTF32, as one TF32 rounding would cost the
// 2e-3 tolerance about three digits) run slower; the likely bound of
// both is shared memory's bandwidth, at 6 and 2 16-byte loads for 32 and
// 16 FMAs. One launch a call, no host sync. A chunk is C = 16 tokens at
// every K: K = 128 has no shared memory for 32. tools/wkv_variants.py
// builds and times the tensor-core form, chunks of 32 and the sequential
// form beside this kernel.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;                   // threads a CTA
constexpr int CHUNK = 16;                 // tokens a chunk
constexpr int SB = 8;                     // tokens a sub-block
constexpr int DL = 4;                     // lanes a diagonal-block pair
constexpr float LOG2E = 1.4426950408889634f;

// lanes a channel in the scan: the most (a power of two) that fit NT
// threads and divide the chunk
__host__ __device__ constexpr int scan_lanes(int K, int C) {
  int l = 1;
  while (K * l * 2 <= NT && C % (l * 2) == 0 && l * 2 <= 32) l *= 2;
  return l;
}

template <int K>
struct Lay {                              // shared memory, in floats
  static constexpr int C = CHUNK;
  static constexpr int NB = C / SB;       // sub-blocks a chunk
  static constexpr int KP = K + 4;        // padded row of a [C][K] tile
  static constexpr int AP = C + 4;        // padded row of the scores
  static constexpr int LPR = NT / C;      // lanes a query row, (3a)
  static constexpr int LPC = scan_lanes(K, C);   // lanes a channel, (1)
  static_assert(C % SB == 0 && NT % C == 0 && C % LPR == 0 &&
                    K % 16 == 0 && K <= 128 && (K * LPC) % 32 == 0,
                "unsupported chunk or K");
  // r, k, logw (then L); v slices (two: the next chunk's lands while
  // this one's is read); qi, qh, kh, kd; d; A; the state; u; L_last
  __host__ __device__ static constexpr int floats(int vs) {
    return 3 * C * KP + 2 * C * (vs + 4) + 4 * C * KP + NB * NB * K +
           C * AP + K * (vs + 4) + 2 * K;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 2^x; x <= 0 here, and a result below 2^-126 flushes to an exact 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// two CTAs an SM: up to 128 registers a thread
template <int K>
__global__ void __launch_bounds__(NT, 2) wkv_chunk_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ s_fin, int H, int S,
    int vs) {
  using Y = Lay<K>;
  constexpr int C = Y::C, NB = Y::NB, KP = Y::KP, AP = Y::AP,
                LPR = Y::LPR, LPC = Y::LPC;
  extern __shared__ __align__(16) float sm[];
  const int vp = vs + 4;
  float* rs = sm;                         // r                 [C][KP]
  float* ks = rs + C * KP;                // k                 [C][KP]
  float* Ls = ks + C * KP;                // logw, then L      [C][KP]
  float* vbuf = Ls + C * KP;              // v slices       [2][C][vp]
  float* qi = vbuf + 2 * C * vp;          // r e^Lp            [C][KP]
  float* qh = qi + C * KP;                // r e^(Lp - L_mI)   [C][KP]
  float* kh = qh + C * KP;                // k e^(L_eJ - L)    [C][KP]
  float* kd = kh + C * KP;                // k e^(L_last - L)  [C][KP]
  float* dd = kd + C * KP;                // e^(L_mI - L_eJ)   [NB][NB][K]
  float* A = dd + NB * NB * K;            // scores            [C][AP]
  float* st = A + C * AP;                 // state slice       [K][vp]
  float* us = st + K * vp;                // u                 [K]
  float* ll = us + K;                     // L_last            [K]

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * vs, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* rb = r + bh * S * K;
  const float* kb = k + bh * S * K;
  const float* wb = logw + bh * S * K;
  const float* vb = v + bh * S * K + j0;
  float* ob = o + bh * S * K + j0;
  const int nj = vs / 4;

  for (int x = tid; x < K * nj; x += NT) {
    const int i = x / nj, j = (x % nj) * 4;
    *reinterpret_cast<float4*>(st + i * vp + j) =
        ld4(s0 + (bh * K + i) * K + j0 + j);
  }
  for (int x = tid; x < K; x += NT) us[x] = u[(size_t)h * K + x];

  const int nchunks = (S + C - 1) / C;
  // chunk c's r, k, logw and v slice (into v half c % 2), zero past S
  auto fetch = [&](int c) {
    if (c < nchunks) {
      const int t0 = c * C, n = min(C, S - t0);
      constexpr int VR = K / 4;           // vectors a row
      for (int x = tid; x < 3 * C * VR; x += NT) {
        const int a = x / (C * VR), y = x % (C * VR);
        const int t = y / VR, c4 = (y % VR) * 4;
        const float* src = a == 0 ? rb : a == 1 ? kb : wb;
        cp_async16(rs + (a * C + t) * KP + c4,
                   t < n ? src + (size_t)(t0 + t) * K + c4 : src, t < n);
      }
      float* vd = vbuf + (c & 1) * C * vp;
      for (int x = tid; x < C * nj; x += NT) {
        const int t = x / nj, c4 = (x % nj) * 4;
        cp_async16(vd + t * vp + c4,
                   t < n ? vb + (size_t)(t0 + t) * K + c4 : vb, t < n);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  fetch(0);
  for (int c = 0; c < nchunks; ++c) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                      // chunk c landed
    const float* vsh = vbuf + (c & 1) * C * vp;
    const int t0 = c * C, n = min(C, S - t0);

    // (1) L: inclusive cumulative log2 decay per channel; LPC lanes a
    // channel each scan C / LPC tokens, then add the lanes before them
    if (tid < K * LPC) {
      constexpr int SEG = C / LPC;
      const int i = tid / LPC, g = tid % LPC;
      float x[SEG], acc = 0.f;
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        acc = fmaf(Ls[(g * SEG + j) * KP + i], LOG2E, acc);
        x[j] = acc;
      }
      float incl = acc;
#pragma unroll
      for (int off = 1; off < LPC; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off, LPC);
        if (g >= off) incl += y;
      }
      const float pre = incl - acc;
#pragma unroll
      for (int j = 0; j < SEG; ++j) Ls[(g * SEG + j) * KP + i] = x[j] + pre;
      if (g == LPC - 1) ll[i] = incl;
    }
    __syncthreads();

    // (2) the decay-scaled operands; every exponent <= 0
    for (int x = tid; x < C * K; x += NT) {
      const int t = x / K, i = x % K, I = t / SB;
      const float L = Ls[t * KP + i];
      const float Lp = t > 0 ? Ls[(t - 1) * KP + i] : 0.f;
      const float rv = rs[t * KP + i], kv = ks[t * KP + i];
      qi[t * KP + i] = rv * ex2(Lp);
      qh[t * KP + i] = I > 0 ? rv * ex2(Lp - Ls[(I * SB - 1) * KP + i])
                             : 0.f;
      kh[t * KP + i] = kv * ex2(Ls[(I * SB + SB - 1) * KP + i] - L);
      kd[t * KP + i] = kv * ex2(ll[i] - L);
    }
    for (int x = tid; x < NB * NB * K; x += NT) {
      const int I = x / (NB * K), J = (x / K) % NB, i = x % K;
      dd[x] = J < I ? ex2(Ls[(I * SB - 1) * KP + i] -
                          Ls[(J * SB + SB - 1) * KP + i])
                    : 0.f;
    }
    __syncthreads();

    // (3a) the scores outside the diagonal blocks: LPR lanes a query
    // row, a warp's rows inside one sub-block; zero above the diagonal
    for (int p = tid; p < C * LPR; p += NT) {
      const int t = p / LPR, q = p % LPR, I = t / SB;
#pragma unroll
      for (int it = 0; it < C / LPR; ++it) {
        const int s = q + LPR * it, J = s / SB;
        float a = 0.f;
        if (J < I) {
          const float* qr = qh + t * KP;
          const float* kr = kh + s * KP;
          const float* dr = dd + (I * NB + J) * K;
#pragma unroll
          for (int i = 0; i < K; i += 4) {
            const float4 x = ld4(qr + i), y = ld4(kr + i), z = ld4(dr + i);
            a = fmaf(x.x * z.x, y.x, a);
            a = fmaf(x.y * z.y, y.y, a);
            a = fmaf(x.z * z.z, y.z, a);
            a = fmaf(x.w * z.w, y.w, a);
          }
        }
        if (J != I || s > t) A[t * AP + s] = a;
      }
    }
    // (3b) the diagonal blocks' pairs s <= t in log space (s == t: the
    // bonus), DL lanes a pair over interleaved 4-channel groups
    {
      constexpr int NPAIR = SB * (SB + 1) / 2;
      constexpr int TASKS = NB * NPAIR * DL;
      for (int p0 = 0; p0 < TASKS; p0 += NT) {
        const int p = p0 + tid, l = p % DL, pair = p / DL;
        int tl = 0, sl = pair % NPAIR;
        while (sl > tl) sl -= ++tl;       // (tl, sl), sl <= tl
        const int t = (pair / NPAIR) * SB + tl, s = (pair / NPAIR) * SB + sl;
        float a = 0.f;
        if (p < TASKS) {
          const float* rr = rs + t * KP;
          const float* kr = ks + s * KP;
          if (s < t) {
            const float* lp = Ls + (t - 1) * KP;
            const float* ls = Ls + s * KP;
#pragma unroll
            for (int i = 4 * l; i < K; i += 4 * DL) {
              const float4 x = ld4(rr + i), y = ld4(kr + i);
              const float4 e = ld4(lp + i), f = ld4(ls + i);
              a = fmaf(x.x * y.x, ex2(e.x - f.x), a);
              a = fmaf(x.y * y.y, ex2(e.y - f.y), a);
              a = fmaf(x.z * y.z, ex2(e.z - f.z), a);
              a = fmaf(x.w * y.w, ex2(e.w - f.w), a);
            }
          } else {
#pragma unroll
            for (int i = 4 * l; i < K; i += 4 * DL) {
              const float4 x = ld4(rr + i), y = ld4(kr + i), w = ld4(us + i);
              a = fmaf(x.x * w.x, y.x, a);
              a = fmaf(x.y * w.y, y.y, a);
              a = fmaf(x.z * w.z, y.z, a);
              a = fmaf(x.w * w.w, y.w, a);
            }
          }
        }
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (p < TASKS && l == 0) A[t * AP + s] = a;
      }
    }
    __syncthreads();                      // A ready; r, k, logw free
    fetch(c + 1);                         // lands during (4) and (5)

    // (4) o = (r e^Lp) S + A v, two rows by four columns a thread;
    // neighbouring lanes hold neighbouring columns, so a warp's loads of
    // r e^Lp and of A are broadcasts and those of S and v whole rows
    for (int x = tid; x < (C / 2) * nj; x += NT) {
      const int t = (x / nj) * 2, jq = (x % nj) * 4;
      float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int i = 0; i < K; i += 4) {
        const float4 a0 = ld4(qi + t * KP + i);
        const float4 a1 = ld4(qi + (t + 1) * KP + i);
        const float4 s0v = ld4(st + i * vp + jq);
        const float4 s1v = ld4(st + (i + 1) * vp + jq);
        const float4 s2v = ld4(st + (i + 2) * vp + jq);
        const float4 s3v = ld4(st + (i + 3) * vp + jq);
        fma4(o0, a0.x, s0v); fma4(o0, a0.y, s1v);
        fma4(o0, a0.z, s2v); fma4(o0, a0.w, s3v);
        fma4(o1, a1.x, s0v); fma4(o1, a1.y, s1v);
        fma4(o1, a1.z, s2v); fma4(o1, a1.w, s3v);
      }
      for (int s = 0; s <= t + 1; ++s) {     // A: zero above the diagonal
        const float4 vv = ld4(vsh + s * vp + jq);
        fma4(o0, A[t * AP + s], vv);
        fma4(o1, A[(t + 1) * AP + s], vv);
      }
      float* orow = ob + (size_t)(t0 + t) * K + jq;
      if (t < n)
        *reinterpret_cast<float4*>(orow) =
            make_float4(o0[0], o0[1], o0[2], o0[3]);
      if (t + 1 < n)
        *reinterpret_cast<float4*>(orow + K) =
            make_float4(o1[0], o1[1], o1[2], o1[3]);
    }
    __syncthreads();                      // every read of S is done

    // (5) S = e^L_last S + (k e^(L_last - L))^T v, 4 x 4 a thread
    for (int x = tid; x < (K / 4) * nj; x += NT) {
      const int i = (x / nj) * 4, jq = (x % nj) * 4;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float dec = ex2(ll[i + a]);
        const float4 sv = ld4(st + (i + a) * vp + jq);
        acc[a][0] = dec * sv.x;
        acc[a][1] = dec * sv.y;
        acc[a][2] = dec * sv.z;
        acc[a][3] = dec * sv.w;
      }
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        const float4 kk = ld4(kd + s * KP + i);
        const float4 vv = ld4(vsh + s * vp + jq);
        fma4(acc[0], kk.x, vv);
        fma4(acc[1], kk.y, vv);
        fma4(acc[2], kk.z, vv);
        fma4(acc[3], kk.w, vv);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(st + (i + a) * vp + jq) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
  __syncthreads();                        // the last chunk's state
  for (int x = tid; x < K * nj; x += NT) {
    const int i = x / nj, j = (x % nj) * 4;
    *reinterpret_cast<float4*>(s_fin + (bh * K + i) * K + j0 + j) =
        ld4(st + i * vp + j);
  }
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* o, float* sf, int B,
           int H, int S, int nv, cudaStream_t st) {
  static int allowed[16] = {};
  const int vs = K / nv;
  const size_t smem = sizeof(float) * (size_t)Lay<K>::floats(vs);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  if ((int)smem > allowed[dev]) {
    err = cudaFuncSetAttribute(wkv_chunk_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = (int)smem;
  }
  wkv_chunk_kernel<K><<<dim3(nv, H, B), NT, smem, st>>>(
      r, k, v, w, u, s0, o, sf, H, S, vs);
  return (int)cudaGetLastError();
}

}  // namespace

// nv: slices of the state's columns a head (1, 2 or 4; K / nv a
// multiple of 4); every pointer 16-byte aligned
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s0,
                         void* o, void* s_fin, int B, int H, int S, int K,
                         int nv, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (nv != 1 && nv != 2 && nv != 4) ||
      K % (4 * nv) != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(logw) |
       reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(s_fin)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_WKV_CASE(K_)                                                      \
  case K_:                                                                   \
    return launch<K_>(                                                       \
        static_cast<const float*>(r), static_cast<const float*>(k),          \
        static_cast<const float*>(v), static_cast<const float*>(logw),       \
        static_cast<const float*>(u), static_cast<const float*>(s0),         \
        static_cast<float*>(o), static_cast<float*>(s_fin), B, H, S, nv, st);
  switch (K) {
    RT_WKV_CASE(16)
    RT_WKV_CASE(32)
    RT_WKV_CASE(48)
    RT_WKV_CASE(64)
    RT_WKV_CASE(80)
    RT_WKV_CASE(96)
    RT_WKV_CASE(112)
    RT_WKV_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_WKV_CASE
}
