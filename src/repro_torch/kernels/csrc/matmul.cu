// Tiled GEMM (M,K) @ (K,N) with an fp32 accumulator, the paper's
// benchmark app 1.
//
// Replaces the TPU kernel repro/kernels/matmul/matmul.py::matmul: a
// blocked product whose fp32 accumulator stays on chip across the K
// reduction and whose output is written once, in the input dtype.
//
// What bounds it on an H100: operations at the shapes the apps use.
// 4096^3 is 137.4 GFLOP against 101 MB (bf16) or 201 MB (fp32) of
// operands: 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak, 2.051 ms
// at the 67 TFLOP/s fp32 FMA peak. Two instances, chosen by dtype alone:
//
// bf16 — tensor cores, fed by TMA. One CTA of three warpgroups per
// 128 x 256 output tile (BM x BN), K in steps of BK = 64 (a 128-byte bf16
// row). A ring of 4 stages in dynamic shared memory holds the A tile
// (128 x 64, K-major) and the B tile (64 x 256, N-major, as four 64-wide
// boxes), all with the 128-byte swizzle. Warpgroup 0 is the producer:
// one thread issues cp.async.bulk.tensor loads and tracks each stage with
// a full and an empty mbarrier; setmaxnreg gives its registers to the
// consumers (40 / 232). Warpgroups 1 and 2 each own 64 rows of the tile
// and issue wgmma.mma_async m64n256k16 with both operands read from
// shared memory (B through the descriptor's transpose bit, legal for
// 16-bit types), keeping one wgmma group in flight while the next stage
// lands. The grid is not persistent: 16 x 32 CTAs at 4096^3, 3.9 waves
// of 132. The accumulator (128 fp32 a thread) is rounded to bf16 and
// stored with bounds. Ragged M, N and K edges come from TMA's zero fill
// on load. TMA needs 16-byte row strides (K % 8 == 0 and N % 8 == 0 for
// bf16) and 16-byte-aligned bases: the wrapper (kernels/matmul/ops.py,
// pad_operands) copies operands that break this into zeroed scratch with
// padded strides; lda / ldb carry those strides. The tensor maps are
// encoded on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__.
//
// fp32 — true fp32 FMAs (the 1e-5·√k tolerance rules out TF32, and wgmma
// takes tf32 only K-major). One CTA of 256 threads per 128 x 128 tile, K
// in steps of 32, a 3-stage cp.async ring of A (row-major, K contiguous)
// and B tiles in dynamic shared memory. Each thread owns an 8 x 8
// accumulator laid out as 2 x 2 blocks of 4 x 4 (rows 4ty + i and 64 +
// 4ty + i, columns 4tx + j and 64 + 4tx + j), so the B reads are 16-byte
// LDS.128 of consecutive vectors and the A reads 8-byte pairs along k
// that a half warp shares (broadcast): no bank conflicts, 128 FMAs per 12
// shared loads, and, with the k loop fully unrolled, no spills at the
// 128 registers that keep 2 CTAs on an SM (4-wide A reads spilled). Rows
// that are not 16-byte aligned (K % 4 != 0 or N % 4 != 0, or a
// misaligned base) take 4-byte cp.async copies instead.
#include <stdint.h>

#include <cuda.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int STAGES = 4;
constexpr int NT = 384;                       // producer + 2 consumer WGs
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BOX_BYTES = 64 * BK * 2;      // one 64-column box, 8 KB
constexpr int B_BYTES = BN * BK * 2;          // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// spin until the phase of parity `parity` has completed; a barrier that
// never completes (a fault in the pipeline) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, tries = 0;
  do {
    if (++tries == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}


// D (64 x 256 fp32, 128 a thread) += A (64 x 16, K-major) * B (16 x 256,
// N-major: the last immediate is the transpose bit of B)
__device__ __forceinline__ void wgmma_m64n256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(NT, 1) gemm_bf16_kernel(
    const __grid_constant__ CUtensorMap tma_a,
    const __grid_constant__ CUtensorMap tma_b, __nv_bfloat16* __restrict__ out,
    int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;   // STAGES mbarriers
  const uint32_t empty = full + STAGES * 8;            // STAGES mbarriers
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);           // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);          // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps STAGES tile loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t a_dst = ring + s * STAGE_BYTES;
        const uint32_t b_dst = a_dst + A_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load(a_dst, &tma_a, full + 8 * s, kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(b_dst + j * B_BOX_BYTES, &tma_b, full + 8 * s,
                   n0 + 64 * j, kt * BK);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 or 2 owns rows 64 (wg - 1) ... of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  const uint32_t a_off = (wg - 1) * 64 * (BK * 2);
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(full + 8 * s, phase);
    const uint32_t a_base = ring + s * STAGE_BYTES + a_off;
    const uint32_t b_base = ring + s * STAGE_BYTES + A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: K-major rows of 128 B, 8-row groups 1024 B apart; a k16 step
      // is 32 B along the swizzled row.
      // B: N-major rows of 128 B (64 columns), 8-row (k) groups 1024 B
      // apart, 64-column boxes B_BOX_BYTES apart; a k16 step is 16 rows.
      const uint64_t da = sw128_desc(a_base + kk * 32, 16, 1024);
      const uint64_t db = sw128_desc(b_base + kk * 16 * 128, B_BOX_BYTES,
                                     1024);
      wgmma_m64n256(d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // keep this stage's group in flight; the previous one is done, so
    // its stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0 && (tid & 31) == 0) mbar_arrive(empty + 8 * prev);
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // accumulator layout of m64nNk16: warp w of the group holds rows
  // 16 w + lane/4 (+ 8); register 4 j + {0,1} (+{2,3}) is column
  // 8 j + 2 (lane % 4) + {0, 1}
  const int t = tid - 128 * wg;
  const int row = m0 + (wg - 1) * 64 + (t / 32) * 16 + (t & 31) / 4;
  const int col0 = n0 + 2 * (t & 3);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= M) continue;
    __nv_bfloat16* orow = out + (size_t)r * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = col0 + 8 * j;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && c + 1 < N) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < N) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < N) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a row-major bf16 matrix of rows x cols (row stride ld elements), cut
// into boxes of box_rows x 64 columns with the 128-byte swizzle; reads
// past rows or cols return zeros
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
              int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* a, const void* b, void* out, int M, int K, int N,
                int lda, int ldb, cudaStream_t st) {
  // TMA: 16-byte row strides and bases
  if (lda % 8 || ldb % 8 || lda < K || ldb < N ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, M, K, lda, BM) ||
      !make_map(&map_b, b, K, N, ldb, BK))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, NT, SMEM_BYTES, st>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: SIMT FMAs over a cp.async ring
// ---------------------------------------------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 32;
constexpr int FNT = 256;
constexpr int FSTAGES = 3;
constexpr int F_SMEM_BYTES = FSTAGES * (FBM * FBK + FBK * FBN) * 4;

// cp.async of VEC floats (16 or 4 bytes); bytes past src_bytes are zeroed
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const uint32_t d = smem_addr(dst);
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

// VEC = 4: rows of A, B and out are 16-byte aligned (K % 4 == 0,
// N % 4 == 0, aligned bases); VEC = 1 otherwise
template <int VEC>
__global__ void __launch_bounds__(FNT, 2) gemm_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int M, int K, int N) {
  extern __shared__ float4 fsmem4[];
  float* fsmem = reinterpret_cast<float*>(fsmem4);
  float* As = fsmem;                              // [FSTAGES][FBM][FBK]
  float* Bs = fsmem + FSTAGES * FBM * FBK;        // [FSTAGES][FBK][FBN]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int KT = (K + FBK - 1) / FBK;

  // each thread copies one column of chunks: A rows ra + RA i at k
  // offset ka, B rows rb + RB i at column nb
  constexpr int CA = FBK / VEC, RA = FNT / CA;
  constexpr int CB = FBN / VEC, RB = FNT / CB;
  const int ra = tid / CA, ka = (tid % CA) * VEC;
  const int rb = tid / CB, nb = (tid % CB) * VEC;
  const float* a_row = a + (size_t)(m0 + ra) * K + ka;
  const float* b_col = b + (size_t)rb * N + n0 + nb;
  auto load = [&](int stage, int kt) {
    const int k0 = kt * FBK;
    float* as = As + stage * FBM * FBK + ra * FBK + ka;
    float* bs = Bs + stage * FBK * FBN + rb * FBN + nb;
    const bool ka_ok = k0 + ka < K;
#pragma unroll
    for (int i = 0; i < FBM / RA; ++i) {
      const bool ok = ka_ok && m0 + ra + RA * i < M;
      cp_async<VEC>(as + i * RA * FBK,
                    ok ? a_row + (size_t)i * RA * K + k0 : a,
                    ok ? 4 * VEC : 0);
    }
    const bool nb_ok = n0 + nb < N;
#pragma unroll
    for (int i = 0; i < FBK / RB; ++i) {
      const bool ok = nb_ok && k0 + rb + RB * i < K;
      cp_async<VEC>(bs + i * RB * FBN,
                    ok ? b_col + (size_t)(k0 + RB * i) * N : b,
                    ok ? 4 * VEC : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < KT) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FSTAGES - 2) : "memory");
    __syncthreads();              // tile kt landed; tile kt-1 is consumed
    const int next = kt + FSTAGES - 1;
    if (next < KT) load(next % FSTAGES, next);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const float* as = As + (kt % FSTAGES) * FBM * FBK;
    const float* bs = Bs + (kt % FSTAGES) * FBK * FBN;
#pragma unroll
    for (int kk = 0; kk < FBK; kk += 2) {
      float2 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
        av[i] = *reinterpret_cast<const float2*>(as + r * FBK + kk);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bs + (kk + c) * FBN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(
            bs + (kk + c) * FBN + 64 + 4 * tx);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = c == 0 ? av[i].x : av[i].y;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + 64 * h + 4 * tx;
      float* o = out + (size_t)gm * N + gn;
      if (VEC == 4 && gn + 3 < N) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) o[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <int VEC>
int launch_f32_vec(const float* a, const float* b, float* out, int M, int K,
                   int N, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_f32_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  gemm_f32_kernel<VEC><<<grid, FNT, F_SMEM_BYTES, st>>>(a, b, out, M, K, N);
  return (int)cudaGetLastError();
}

int launch_f32(const void* a, const void* b, void* out, int M, int K, int N,
               cudaStream_t st) {
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fo = static_cast<float*>(out);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? launch_f32_vec<4>(fa, fb, fo, M, K, N, st)
             : launch_f32_vec<1>(fa, fb, fo, M, K, N, st);
}

}  // namespace

// lda / ldb: row strides of a and b in elements (bf16 may be padded to a
// multiple of 8 by the wrapper; fp32 takes lda == K, ldb == N)
extern "C" int matmul(const void* a, const void* b, void* out, int M, int K,
                      int N, int lda, int ldb, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) {
    if (lda != K || ldb != N) return (int)cudaErrorInvalidValue;
    return launch_f32(a, b, out, M, K, N, st);
  }
  if (dtype == rt::kBFloat16)
    return launch_bf16(a, b, out, M, K, N, lda, ldb, st);
  return (int)cudaErrorInvalidValue;
}
