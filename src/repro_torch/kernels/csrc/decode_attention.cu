// One-token GQA decode attention over contiguous ring caches.
//
// Replaces the TPU kernel repro/kernels/decode_attention/
// decode_attention.py::decode_attention (_kernel): q (B,1,Hq,hd) against
// per-slot ring caches k/v (B,C,Hkv,hd) sharing one scalar position pos.
// A slot is valid if slot <= pos or the ring is full (pos >= C); with a
// window, only slots whose ring age (pos%C - slot) mod C is < window.
// Softmax is an fp32 online softmax from a finite -1e30 start; the output
// is written in the input dtype.
//
// The valid slots are always the last n = min(pos+1, C[, window]) slots
// in ring order, ending at pos % C: at most two contiguous runs. The
// kernel walks exactly those and never loads any other slot, so a NaN in
// an unwritten slot cannot reach p * v (the TPU kernel multiplies p = 0
// into every slot it visits).
//
// pos is read from a device int32 when one is given, so a decode step
// needs no host sync; otherwise it is the value passed by the host.
//
// What bounds it on an H100: bytes. Each (slot, kv head) reads its n live
// K and V rows once (2 * n * hd * sizeof(T)) and does 4 * G * hd FLOP per
// row: ~1 FLOP per byte, far below the card's balance point.
//
// Design: one CTA per (kv head, slot b), so the G query heads of a group
// share every K/V row load. Each row is read as 16-byte vectors by a
// group of LPT = hd / (16 / sizeof(T)) lanes, so one warp streams 32 / LPT
// rows at once; each lane group keeps its own online-softmax state (m, l
// and its share of the fp32 accumulator) in registers, with no barrier in
// the walk. Lane groups merge by shuffles, warps through shared memory.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;

template <typename T, int DPL>
__device__ __forceinline__ void load_row(const T* p, float (&dst)[DPL]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < DPL; ++i) dst[i] = rt::to_float(e[i]);
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(NT) ring_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    const int* __restrict__ pos_ptr, int pos_val, int C, int Hq, int Hkv,
    int window, float scale) {
  constexpr int DPL = 16 / sizeof(T);     // dims per lane (one 16 B load)
  constexpr int LPT = HD / DPL;           // lanes per row
  constexpr int TPW = 32 / LPT;           // rows per warp step
  constexpr int NGR = NW * TPW;           // rows in flight per CTA
  static_assert(LPT >= 1 && LPT <= 32 && 32 % LPT == 0, "bad head dim");
  __shared__ float red_m[NW][G], red_l[NW][G];
  __shared__ float red_acc[NW][G][HD];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPT, li = lane % LPT;
  const int pos = pos_ptr != nullptr ? *pos_ptr : pos_val;
  int n = pos >= C ? C : pos + 1;
  if (window > 0 && window < n) n = window;
  T* ob = out + ((size_t)b * Hq + (size_t)hk * G) * HD;
  if (n <= 0) {
    for (int i = threadIdx.x; i < G * HD; i += NT) ob[i] = rt::from_float<T>(0.f);
    return;
  }
  int start = pos % C - n + 1;            // first valid slot in ring order
  if (start < 0) start += C;

  float qr[G][DPL], acc[G][DPL], m[G], l[G];
  const T* qb = q + ((size_t)b * Hq + (size_t)hk * G) * HD + li * DPL;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<T, DPL>(qb + g * HD, qr[g]);
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const size_t row = (size_t)Hkv * HD;
  const T* kb = k + ((size_t)b * C * Hkv + hk) * HD + li * DPL;
  const T* vb = v + ((size_t)b * C * Hkv + hk) * HD + li * DPL;
  // every lane runs every iteration (the shuffles need the whole warp);
  // a lane group past the end loads nothing and updates nothing
  for (int j0 = warp * TPW; j0 < n; j0 += NGR) {
    const int j = j0 + sub;
    const bool ok = j < n;
    float kv[DPL], vv[DPL];
    if (ok) {
      int slot = start + j;
      if (slot >= C) slot -= C;
      load_row<T, DPL>(kb + (size_t)slot * row, kv);
      load_row<T, DPL>(vb + (size_t)slot * row, vv);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) kv[i] = vv[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part += qr[g][i] * kv[i];
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (ok) {
        const float s = part * scale;
        const float mn = fmaxf(m[g], s);
        const float alpha = expf(m[g] - mn);
        const float p = expf(s - mn);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * alpha + p * vv[i];
        m[g] = mn;
      }
    }
  }

  // merge the lane groups of the warp (xor over whole rows of lanes)
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), ao = expf(mo - mn);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const float x = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + x * ao;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) red_acc[warp][g][li * DPL + i] = acc[g][i];
      if (li == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps
  for (int i = threadIdx.x; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red_m[w][g]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(red_m[w][g] - mx);
      sum += red_l[w][g] * e;
      a += red_acc[w][g][d] * e;
    }
    ob[i] = rt::from_float<T>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              const int* pos_ptr, int pos_val, int B, int C, int Hq, int Hkv,
              int window, float scale, cudaStream_t st) {
  const dim3 grid(Hkv, B);
#define RT_RD_CASE(G_)                                                    \
  case G_:                                                                \
    ring_decode_kernel<T, HD, G_><<<grid, NT, 0, st>>>(                   \
        static_cast<const T*>(q), static_cast<const T*>(k),               \
        static_cast<const T*>(v), static_cast<T*>(out), pos_ptr, pos_val, \
        C, Hq, Hkv, window, scale);                                       \
    break;
  switch (Hq / Hkv) {
    RT_RD_CASE(1)
    RT_RD_CASE(2)
    RT_RD_CASE(4)
    RT_RD_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_RD_CASE
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* pos_ptr, int pos_val, int B, int C, int Hq, int Hkv,
           int hd, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, out, pos_ptr, pos_val, B, C, Hq, Hkv,
                              window, scale, st);
    case 32:
      return launch_hd<T, 32>(q, k, v, out, pos_ptr, pos_val, B, C, Hq, Hkv,
                              window, scale, st);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, pos_ptr, pos_val, B, C, Hq, Hkv,
                              window, scale, st);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, pos_ptr, pos_val, B, C, Hq, Hkv,
                               window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, const void* pos_ptr, int pos_val,
                                int dtype, int B, int C, int Hq, int Hkv,
                                int hd, int window, float scale,
                                void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(pos_ptr);
  if (dtype == rt::kFloat32)
    return launch<float>(q, k, v, out, pp, pos_val, B, C, Hq, Hkv, hd, window,
                         scale, st);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, pp, pos_val, B, C, Hq, Hkv, hd,
                                 window, scale, st);
  return (int)cudaErrorInvalidValue;
}
