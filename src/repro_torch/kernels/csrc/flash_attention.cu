// Causal / sliding-window GQA flash attention, forward only.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// ::flash_attention (_fa_kernel): same maths (online softmax in fp32,
// scores scaled by 1/sqrt(hd), masked scores weigh exactly 0 and never
// make a NaN, KV head = q_head / G with no repeated K/V), model layout
// (B, S, H, hd) read in place. Tiles wholly above the causal diagonal or
// wholly outside the window are never visited (the TPU grid visits and
// masks them); the ragged Sq/Sk edge is masked in the kernel instead of
// padded. Two instances, chosen by dtype alone.
//
// What bounds it on an H100, at the shapes timed: at the serving path's
// prefill (B=1, S=130: 16/16 at hd 64, or 10/1 at hd 256) a few MFLOP
// and about 1 MB, so latency and occupancy; at the VMM's prefill program
// (B=4, S=4096, 16/16, hd 64, causal: 137.5 GFLOP, 134 MB) and at
// recurrentgemma's S=2500 (hd 256, 10/1, window 2048: 31.0 GFLOP)
// operations, 0.139 ms and 0.031 ms at the 989 TFLOP/s bf16 peak.
//
// bf16 — tensor cores through wgmma. One CTA is one warpgroup (128
// threads) over 64 q rows of one head: the m64 of wgmma, 16 rows a warp.
// The Q tile and double-buffered K/V tiles of 64 keys (32 at hd 256) are
// staged by 16-byte cp.async, zero-filled past Sq/Sk and past hd, in the
// 128-byte-swizzled layout wgmma reads: 64-column blocks of rows x 128 B
// (hd 16 and 32 are padded to one block with zero columns, hd 96 and 112
// to two: Q Kᵀ stays exact, P V's extra columns are never stored). S = Q
// Kᵀ is wgmma.mma_async m64nBNk16 with both operands in shared memory
// (K-major). The row max and row sum reduce over each quad with xor
// shuffles; P never leaves registers: the accumulator layout of S is the
// register-A layout of wgmma, and O += P V is wgmma m64n(hd)k16 with A
// from registers and V read N-major (the transpose bit, legal for
// 16-bit types). A fence.proxy.async hands the cp.async writes to the
// async proxy that wgmma reads through. The reference rounds p to bf16
// before P·V; here p goes in as a pair of bf16 (hi = bf16(p), lo =
// bf16(p - hi)), two products into the same fp32 accumulator, so the
// output stays within two bf16 ulps of the fp32-softmax plain version at
// long spans: one rounding of p alone put 5% of the elements at B=4,
// S=4096 outside that rule (errors ~2^-10 of the typical |o|, above its
// 1e-5 floor where o is near 0). Element masks are applied only on the
// edge tiles of the diagonal, the window and Sk; q tiles run heaviest
// first (causal). An mma.sync (m16n8k16) design of the same tiling took
// 1.25x as long at B=4, S=4096. Each CTA waits on its own wgmma groups,
// so the tensor cores overlap one CTA's softmax with another's products
// (4 CTAs an SM at hd 64); FA3's in-CTA ping-pong and TMA loads are the
// next steps.
//
// fp32 — SIMT, as before: it serves only the fp32 card-vs-CPU reference,
// and tensor cores (TF32) would break its 2e-5 tolerance. One CTA of 256
// threads per (q tile, q head, batch row); TPR threads per q row (4, or
// 8 at hd 256) each own hd/TPR interleaved dims of the q row and of the
// accumulator; K/V tiles of BN keys (32, or 16 at hd 256) in static
// shared memory as fp32; partial dot products combined with xor shuffles.
#include <stdint.h>

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

int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
               int window, float scale, cudaStream_t st) {
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
#define RT_FA_CASE(HD_)                                                     \
  case HD_: {                                                               \
    const dim3 grid((Sq + Tile<HD_>::BM - 1) / Tile<HD_>::BM, Hq, B);       \
    flash_fwd_kernel<float, HD_><<<grid, NT, 0, st>>>(                      \
        qq, kk, vv, oo, Sq, Sk, Hq, Hkv, causal, window, scale);            \
    break;                                                                  \
  }
  switch (hd) {
    RT_FA_CASE(16)
    RT_FA_CASE(32)
    RT_FA_CASE(64)
    RT_FA_CASE(96)
    RT_FA_CASE(112)
    RT_FA_CASE(128)
    RT_FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_FA_CASE
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr float NEG = -1e30f;    // the reference's mask value

template <int HD> struct WgTile {
  // head dim padded with zero columns to whole 64-column blocks (the
  // 128-byte swizzle's unit): hd 16, 32 → 64; 96, 112 → 128
  static constexpr int HP = (HD + 63) / 64 * 64;
  static constexpr int BN = HD >= 256 ? 32 : 64;   // keys per K/V tile
  static constexpr int Q_BYTES = 64 * HP * 2;
  static constexpr int KV_BYTES = BN * HP * 2;
  // Q, two K and two V tiles, and room to align them to 1024 B
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; bytes past src_bytes are zeroed
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// byte offset of 16-byte chunk c of row r in a tile of `rows` rows kept
// as 64-column blocks of rows x 128 B with the 128-byte swizzle
__device__ __forceinline__ uint32_t sw_off(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N fp32) += A (64 x 16) * B (16 x N): _ss with A and B in shared
// memory, both K-major; _rs with A in registers and B N-major
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db);
  else wgmma_ss_n64(d, da, db);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_wg_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk, int Hq,
    int Hkv, int causal, int window, float scale_log2) {
  constexpr int HP = WgTile<HD>::HP;
  constexpr int BN = WgTile<HD>::BN;
  constexpr int CH = HD / 8, CHP = HP / 8;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t q_s = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + WgTile<HD>::Q_BYTES;       // [2] tiles
  const uint32_t v_s = k_s + 2 * WgTile<HD>::KV_BYTES;  // [2] tiles

  const int m0 = (gridDim.x - 1 - blockIdx.x) * 64;     // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  const bf16* qb = q + ((size_t)b * Sq * Hq + h) * HD;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * HD;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * HD;

  for (int c = tid; c < 64 * CHP; c += 128) {
    const int r = c / CHP, ch = c % CHP;
    const bool ok = m0 + r < Sq && ch < CH;
    cp_async16(q_s + sw_off(64, r, ch),
                 ok ? qb + (m0 + r) * q_stride + ch * 8 : qb, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  auto load_kv = [&](int buf, int n0) {
    const uint32_t kd = k_s + buf * WgTile<HD>::KV_BYTES;
    const uint32_t vd = v_s + buf * WgTile<HD>::KV_BYTES;
    for (int c = tid; c < BN * CHP; c += 128) {
      const int r = c / CHP, ch = c % CHP;
      const bool ok = n0 + r < Sk && ch < CH;
      const size_t off = (size_t)(n0 + r) * kv_stride + ch * 8;
      cp_async16(kd + sw_off(BN, r, ch), ok ? kb + off : kb, ok ? 16 : 0);
      cp_async16(vd + sw_off(BN, r, ch), ok ? vb + off : vb, ok ? 16 : 0);
    }
  };

  const int n_end = causal ? min(Sk, m0 + 64) : Sk;
  const int n_begin = window > 0 ? max(0, m0 - window + 1) / BN * BN : 0;

  // accumulator layouts of m64nNk16: warp w holds rows 16 w + g (elements
  // 4 j + 0, 1) and 16 w + g + 8 (4 j + 2, 3), columns 8 j + 2 tig + {0, 1}
  float acc[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) acc[i] = 0.f;
  const int row0 = m0 + warp * 16 + g;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};

  if (n_begin < n_end) load_kv(0, n_begin);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  int buf = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    if (n0 + BN < n_end) load_kv(buf ^ 1, n0 + BN);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    // the tiles were written through the generic proxy; wgmma reads them
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q Kᵀ: both K-major; a k16 step is 32 B along a swizzled row,
    // every 4 steps the next 64-column block
    const uint32_t kt = k_s + buf * WgTile<HD>::KV_BYTES;
    const uint32_t vt = v_s + buf * WgTile<HD>::KV_BYTES;
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk) {
      const uint64_t da =
          sw128_desc(q_s + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024);
      const uint64_t db =
          sw128_desc(kt + (kk >> 2) * BN * 128 + (kk & 3) * 32, 16, 1024);
      wgmma_ss<BN>(s, da, db);
    }
    wgmma_commit_wait();

    const bool edge = n0 + BN > Sk || (causal && n0 + BN - 1 > m0) ||
                      (window > 0 && m0 + 63 - n0 >= window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int key = n0 + 8 * j + 2 * tig + (e & 1);
          const int qi = row0 + 8 * (e >> 1);
          const bool ok = key < Sk && (!causal || key <= qi) &&
                          (window <= 0 || qi - key < window);
          if (!ok) x = NEG;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - mx[e >> 1]);
        s[4 * j + e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V: P (registers, the accumulator layout of S is the A layout
    // of k slice kk) as bf16 hi + lo; V N-major (transpose bit), a k16
    // step is 16 rows, 64-column blocks BN rows apart
    uint32_t hi[BN / 16][4], lo[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * (2 * kk + (u >> 1)) + 2 * (u & 1);
        const float h0 = __bfloat162float(__float2bfloat16_rn(s[i]));
        const float h1 = __bfloat162float(__float2bfloat16_rn(s[i + 1]));
        hi[kk][u] = pack_bf16(h0, h1);
        lo[kk][u] = pack_bf16(s[i] - h0, s[i + 1] - h1);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t db = sw128_desc(vt + kk * 16 * 128, BN * 128, 1024);
      wgmma_rs<HP>(acc, hi[kk], db);
      wgmma_rs<HP>(acc, lo[kk], db);
    }
    wgmma_commit_wait();
    __syncthreads();                    // this buffer is refilled next
    buf ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    l = fmaxf(l, 1e-30f);
    bf16* orow = o + ((size_t)(b * Sq + qi) * Hq + h) * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / l,
                                acc[4 * j + 2 * r + 1] / l);
  }
}

template <int HD>
int launch_wg(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
              int Sq, int Sk, int Hq, int Hkv, int causal, int window,
              float scale, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wg_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WgTile<HD>::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((Sq + 63) / 64, Hq, B);
  flash_fwd_wg_kernel<HD><<<grid, 128, WgTile<HD>::SMEM, st>>>(
      q, k, v, o, Sq, Sk, Hq, Hkv, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                int window, float scale, cudaStream_t st) {
  // 16-byte cp.async: every base must be 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
#define RT_WG_CASE(HD_)                                                     \
  case HD_:                                                                 \
    return launch_wg<HD_>(qq, kk, vv, oo, B, Sq, Sk, Hq, Hkv, causal,       \
                          window, scale, st);
  switch (hd) {
    RT_WG_CASE(16)
    RT_WG_CASE(32)
    RT_WG_CASE(64)
    RT_WG_CASE(96)
    RT_WG_CASE(112)
    RT_WG_CASE(128)
    RT_WG_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_WG_CASE
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
    return launch_f32(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window,
                      scale, st);
  if (dtype == rt::kBFloat16)
    return launch_bf16(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window,
                       scale, st);
  return (int)cudaErrorInvalidValue;
}
