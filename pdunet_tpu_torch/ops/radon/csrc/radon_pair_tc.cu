// Mirror-pair parallel-beam projector kernels on Hopper's tensor cores
// (sm_90a, bf16 operands): the route that project_pair_group /
// backproject_pair_group take for cdt = bfloat16 on a CUDA tensor. The
// float32 route stays on the CUDA-core kernels of radon_pair.cu.
//
// Replaces the bf16 instantiation of the Pallas TPU kernels in
// pdunet_tpu/ops/radon/pallas_kernels.py:
//   radon_pair_tc_project     <- project_pair_group_pallas     (body _fwd_pair_kernel)
//   radon_pair_tc_backproject <- backproject_pair_group_pallas (body _adj_pair_kernel)
//   radon_pair_tc_tables      <- the trig both bodies make per grid step (_pair_tensors)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/cuda_kernels.py
// (_project_pair_group / _backproject_pair_group; _pair_tables for the
// tables, _pair_forward_tc / _pair_adjoint_tc for this file's tiling).
//
// The function (notation of radon_pair.cu): per pair p of one group,
//   ĝ[r, k]  = Σ_c F[r, c] T̂_p[c, k]                       (stage 1)
//   Ŝ_m[k]   = Σ_r ĝ_m[r, k] φ_m[p, r, k], ĝ_b = (gr, sgn·gi) (stage 2)
//   out[2p+m, s] = Σ_k Re Ŝ_m Wc[k, s] − Im Ŝ_m Ws[k, s]      (stage 3)
// and its exact transpose. Rounding points are the plain version's: F (or
// p), T̂, φ, W and Ŝ (or h) are rounded to bf16, every sum is f32. That is
// the contract of wgmma with f32 accumulators, so the products run there.
//
// What bounds the CUDA-core kernels of radon_pair.cu on an H100 in bf16, and
// what this design does about it:
//  * FP32 CUDA-core products (16-25 TFLOP/s). Stage 1 and stage 1ᵀ are
//    wgmma.m64nNk16 bf16 products with f32 accumulators, both operands in
//    128-byte-swizzled shared memory, staged by cp.async rings.
//  * Trig regenerated per tile and image (≈16x the distinct values). The
//    trig comes from per-plan tables built once on the card by pair_tables,
//    in the layout the products read: (3, P, Np, 2Kp) bf16 — T̂, φ_a, φ_b —
//    with (re, im) interleaved along the frequency axis, so that the
//    accumulator's adjacent-column pair in one thread holds (re, im) of one
//    k; rows padded to Np = 128·⌈N/128⌉ and 2K to 2Kp = 128·⌈2K/128⌉ with
//    zeros (2K = 360 -> 384 at the serving shapes).
//  * A 64-block adjoint grid at batch 4. The adjoint's output tiles are
//    (128 image rows) x (256 image columns), and its depth — the pairs'
//    64-deep chunks of (k, re/im), in order — is split into G slices
//    chosen by the wrapper (pair_adjoint_splits) so that at least one block
//    per SM is in flight, each slice writing a partial image that
//    pair_tc_reduce sums in a fixed order (no atomics: deterministic).
//  * Stage 3ᵀ reading W with a stride of S. Stage 3ᵀ runs one warp per k
//    with lanes across S (coalesced); stage 3 reads W coalesced, each load
//    shared by 8 rows.
// What bounds this file's kernels: the L2-to-SM traffic of the table tiles.
// Every 64-deep adjoint chunk of a 128 x 256 tile reads 64 KB (T̂ and both
// φ) for 4.2 MFLOP, every forward block 192 KB (F, T̂, φ) for 8.4 MFLOP;
// at batch 256 both run at ≈3.5-4.1 TB/s of such reads on an H100, far below
// the tensor cores' rate.
// At batch 4 the adjoint's partial images also compete for L2, and the
// small stage-3 kernels are latency-bound. Sharing φ between the images
// of a tile is the next step.
//
// Forward (stages 1+2 fused): pair_tc_prep writes F in bf16, zero-padded to
// (B, Np, Np) and transposed for the y group, so that the A operand is
// always K-major. Each block of pair_tc_fwd owns (128 rows of one image) x
// (128 interleaved frequency columns) x (one pair); two warpgroups each run
// m64n128k16 over depth N in 64-deep chunks through a three-stage ring,
// with T̂_p as an MN-major B operand. During the last chunk the block copies
// its φ_a, φ_b tiles into the two free stages. The epilogue applies both
// members' phases to the f32 accumulators (ĝ is never rounded, as in the
// plain version), reduces over the tile's rows with warp shuffles and
// shared memory, and writes one partial Ŝ per row tile;
// pair_tc_fwd_stage3 sums the partials in row-tile order, rounds Ŝ and
// multiplies by W.
//
// Adjoint: pair_tc_adj_stage3t gives Ŝ_m = Wᵀ p_m (member b masked by msk)
// rounded to bf16, in the layout (B, P, Kp, [re_a, im_a, re_b, im_b]).
// pair_tc_adj then runs one GEMM over its slice of depth: a three-stage
// ring of raw chunks (T̂ as the K-major B operand, φ_a and φ_b rows) runs
// two chunks ahead, and while the tensor cores work on chunk i all threads
// build chunk i+1's A operand h = Σ_m Ŝ_m conj(φ_m) (sgn on member b's Im,
// Ŝ prefetched into registers), rounded to bf16, straight into swizzled
// shared memory: h never reaches device memory. The y group's output is
// stored transposed; the accumulator fragment's 8-row x 2-column quads make
// every 32-byte sector of either orientation complete, so the store needs
// no staging.
//
// Unpaired rows (msk = 0) contribute zero: their p rows are zeroed before
// stage 3ᵀ. Padded rows, columns and frequencies are zero in the tables.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TC_BM = 128;       // GEMM tile rows: two warpgroups of 64
constexpr int TC_BK = 64;        // depth per stage: one 128-byte swizzle row of bf16
constexpr int TC_THREADS = 256;
constexpr int FW_BN = 128;       // forward tile columns: 64 frequencies x (re, im)
constexpr int AD_BN = 256;       // adjoint tile columns: image columns
constexpr uint32_t FW_A_BYTES = TC_BM * TC_BK * 2;
constexpr uint32_t FW_B_BYTES = FW_BN * TC_BK * 2;
constexpr uint32_t FW_STAGE = FW_A_BYTES + FW_B_BYTES;
constexpr int FW_STAGES = 3;     // forward ring: two chunks in flight
// adjoint: a ring of three raw stages (T̂ chunk, φ_a and φ_b rows), loaded
// two chunks ahead, and two stages of the h operand built from them
constexpr uint32_t AD_T_BYTES = AD_BN * TC_BK * 2;
constexpr uint32_t AD_PHI_BYTES = TC_BM * TC_BK * 2;
constexpr uint32_t AD_RAW = AD_T_BYTES + 2 * AD_PHI_BYTES;
constexpr uint32_t AD_H_BYTES = TC_BM * TC_BK * 2;
constexpr int AD_RAW_STAGES = 3, AD_H_STAGES = 2;
// stages, plus slack to align them to the 1024-byte swizzle atom
constexpr size_t FW_SMEM = FW_STAGES * FW_STAGE + 1024;
constexpr size_t AD_SMEM = AD_RAW_STAGES * AD_RAW + AD_H_STAGES * AD_H_BYTES + 1024;

constexpr int ST_ROWS = 8;       // rows per stage-3 / 3ᵀ block
constexpr int ST_THREADS = 256;
constexpr int ST3T_TK = 32;      // frequencies per stage-3ᵀ block (4 per warp)
constexpr int ST3_COLS = 64;     // output columns per stage-3 block, two per thread
constexpr int ST3_SPLIT = ST_THREADS / (ST3_COLS / 2);  // ways its k loop is split

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk j of row `row` in a 128-byte-swizzled tile
// whose rows are 128 bytes apart (the layout TMA's SWIZZLE_128B writes).
__device__ __forceinline__ uint32_t swz(int row, int j) {
  return (uint32_t)(row * 128 + ((j ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major operand:
// rows 128 bytes apart, sbo = 1024 (8-row groups), lbo unused (16). MN-major
// operand: 64-element MN blocks lbo apart, 8-row K groups sbo apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFFu) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// D (64 x 128, f32) += A (64 x 16, bf16, K-major) * B (16 x 128, bf16, MN-major), both from shared memory.
__device__ __forceinline__ void wgmma_n128_mn(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// D (64 x 256, f32) += A (64 x 16, bf16, K-major) * B (16 x 256, bf16, K-major), both from shared memory.
__device__ __forceinline__ void wgmma_n256_k(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t f2_to_bf2(float re, float im) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(re, im);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// ---------------------------------------------------------------------------
// Per-plan trig tables: tab (3, P, Np, Kp) of bf16 (re, im) pairs:
//   t = 0: T̂   = (spec·cos, −spec·sin)(pos[p, c]·kf)
//   t = 1: φ_a = (cos, sin)(sha[p, r]·kf),  t = 2: φ_b from shb
// with kf = (float)k·kscale and the angle formed as the plain version forms
// it (both products rounded, no FMA contraction), precise sincosf; zero for
// rows ≥ N and k ≥ K.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
pair_tables(const float* __restrict__ pos, const float* __restrict__ sha,
            const float* __restrict__ shb, const float* __restrict__ spec,
            uint32_t* __restrict__ tab, int P, int N, int Np, int K, int Kp,
            float kscale) {
  const size_t n = (size_t)3 * P * Np * Kp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i % Kp);
    const int row = (int)((i / Kp) % Np);
    const int p = (int)((i / ((size_t)Kp * Np)) % P);
    const int t = (int)(i / ((size_t)Kp * Np * P));
    float re = 0.f, im = 0.f;
    if (row < N && k < K) {
      const float* src = t == 0 ? pos : (t == 1 ? sha : shb);
      const float kf = __fmul_rn((float)k, kscale);
      float s, c;
      sincosf(__fmul_rn(src[(size_t)p * N + row], kf), &s, &c);
      if (t == 0) {
        const float sp = spec[k];
        re = sp * c;
        im = -sp * s;
      } else {
        re = c;
        im = s;
      }
    }
    tab[i] = f2_to_bf2(re, im);
  }
}

// F in bf16, zero-padded to (B, Np, Np): fb[b, r, c] = F(r, c), where
// F(r, c) = f[b, r, c] (x group) or f[b, c, r] (y group, transpose = 1).
// 32x32 tiles through shared memory keep both sides coalesced.
__global__ void __launch_bounds__(256)
pair_tc_prep(const float* __restrict__ f, __nv_bfloat16* __restrict__ fb, int N, int Np,
             int transpose) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, y0 = blockIdx.y * 32, x0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* src = f + (size_t)b * N * N;
  for (int yy = ty; yy < 32; yy += 8) {
    const int y = y0 + yy, x = x0 + tx;
    tile[yy][tx] = (y < N && x < N) ? src[(size_t)y * N + x] : 0.f;
  }
  __syncthreads();
  __nv_bfloat16* dst = fb + (size_t)b * Np * Np;
  for (int yy = ty; yy < 32; yy += 8) {
    if (transpose)
      dst[(size_t)(x0 + yy) * Np + y0 + tx] = __float2bfloat16_rn(tile[tx][yy]);
    else
      dst[(size_t)(y0 + yy) * Np + x0 + tx] = __float2bfloat16_rn(tile[yy][tx]);
  }
}

// ---------------------------------------------------------------------------
// Forward stages 1+2. grid ((2Kp/FW_BN)·P, B·Np/TC_BM); block = 2 warpgroups.
// part layout (R, B, P, 2, K, 2): one partial Ŝ per row tile rt < R = Np/128.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(TC_THREADS, 2)
pair_tc_fwd(const __nv_bfloat16* __restrict__ fb, const __nv_bfloat16* __restrict__ tab,
            const float* __restrict__ sgn, float* __restrict__ part,
            int B, int Np, int P, int K, int K2p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sgen = smem_raw + (base - raw);

  const int n_ct = K2p / FW_BN;
  const int ct = blockIdx.x % n_ct, p = blockIdx.x / n_ct;
  const int R = Np / TC_BM;
  const int b = blockIdx.y / R, rt = blockIdx.y % R;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = ct * FW_BN;
  const size_t tsz = (size_t)P * Np * K2p;  // elements per table
  const __nv_bfloat16* T = tab + (size_t)p * Np * K2p;
  const __nv_bfloat16* F = fb + ((size_t)b * Np + (size_t)rt * TC_BM) * Np;

  // stage: A = F rows [128][64 c] K-major; B = T̂ [2 column blocks][64 c][64 (k, re/im)]
  auto load = [&](int kc, uint32_t stage) {
    const int c0 = kc * TC_BK;
    for (int e = tid; e < TC_BM * 8; e += TC_THREADS) {
      const int m = e >> 3, j = e & 7;
      cp_async16(stage + swz(m, j), F + (size_t)m * Np + c0 + j * 8, 16);
    }
    const uint32_t sb = stage + FW_A_BYTES;
    for (int e = tid; e < TC_BK * (FW_BN / 8); e += TC_THREADS) {
      const int j = e & 7, nb = (e >> 3) % (FW_BN / 64), kk = e / (FW_BN / 8);
      cp_async16(sb + nb * (TC_BK * 128) + swz(kk, j),
                 T + (size_t)(c0 + kk) * K2p + n0 + nb * 64 + j * 8, 16);
    }
    cp_async_commit();
  };

  // The epilogue's φ_a, φ_b tiles [128 rows][64 (cos, sin)], 16-byte chunks
  // XOR-swizzled by row, go to the two stages the last chunk does not use
  // while its products run.
  const int nk = Np / TC_BK;
  const int last = (nk - 1) % FW_STAGES;
  const int phi_slot[2] = {(last + 1) % FW_STAGES, (last + 2) % FW_STAGES};
  auto load_phi = [&]() {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const __nv_bfloat16* src =
          tab + (t + 1) * tsz + ((size_t)p * Np + (size_t)rt * TC_BM) * K2p + n0;
      const uint32_t dst = base + phi_slot[t] * FW_STAGE;
      for (int e = tid; e < TC_BM * (FW_BN / 8); e += TC_THREADS) {
        const int row = e / (FW_BN / 8), c = e % (FW_BN / 8);
        cp_async16(dst + row * (FW_BN * 2) + ((c ^ (row & 7)) << 4),
                   src + (size_t)row * K2p + c * 8, 16);
      }
    }
    cp_async_commit();
  };

  float acc[FW_BN / 2];
#pragma unroll
  for (int i = 0; i < FW_BN / 2; ++i) acc[i] = 0.f;
  // one commit group per chunk (empty past the end), so that waiting for
  // all but the newest FW_STAGES - 2 groups means chunk kc has landed
  for (int st = 0; st < FW_STAGES - 1; ++st) {
    if (st < nk) load(st, base + st * FW_STAGE);
    else cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    const uint32_t stage = base + (kc % FW_STAGES) * FW_STAGE;
    cp_async_wait<FW_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // chunk kc in shared memory; chunk kc-1's products done
    const int next = kc + FW_STAGES - 1;  // into the stage chunk kc-1 used
    if (next < nk) load(next, base + (next % FW_STAGES) * FW_STAGE);
    else cp_async_commit();
    if (kc == nk - 1) load_phi();
    const uint32_t sa = stage + wg * (64 * 128), sb = stage + FW_A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks)
      wgmma_n128_mn(acc, desc_sw128(sa + ks * 32, 16, 1024),
                    desc_sw128(sb + ks * 2048, TC_BK * 128, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
  }
  cp_async_wait_all();
  __syncthreads();  // φ tiles landed; both warpgroups done with the last stage

  // stage 2 on the f32 accumulators: thread holds (gr, gi) of frequency
  // n0/2 + 4j + lane%4 for tile rows ra and ra + 8
  const float sg = sgn[p];
  const uint8_t* pha = sgen + phi_slot[0] * FW_STAGE;
  const uint8_t* phb = sgen + phi_slot[1] * FW_STAGE;
  float* red = reinterpret_cast<float*>(sgen + last * FW_STAGE);
  const int ra = wg * 64 + warp * 16 + (lane >> 2), rb = ra + 8;
  float* myred = red + (wg * 4 + warp) * (FW_BN / 2) * 4;  // [64 k][a re, a im, b re, b im]
  auto phi = [&](const uint8_t* t, int r, int j) {
    return bf2_to_f2(*reinterpret_cast<const uint32_t*>(
        t + r * (FW_BN * 2) + ((j ^ (r & 7)) << 4) + (lane & 3) * 4));
  };
#pragma unroll
  for (int j = 0; j < FW_BN / 8; ++j) {
    const int kl = j * 4 + (lane & 3);
    const float2 a1 = phi(pha, ra, j), a2 = phi(pha, rb, j);
    const float2 b1 = phi(phb, ra, j), b2 = phi(phb, rb, j);
    const float gr1 = acc[4 * j], gi1 = acc[4 * j + 1];
    const float gr2 = acc[4 * j + 2], gi2 = acc[4 * j + 3];
    const float gib1 = gi1 * sg, gib2 = gi2 * sg;
    float v[4];
    v[0] = (gr1 * a1.x - gi1 * a1.y) + (gr2 * a2.x - gi2 * a2.y);
    v[1] = (gr1 * a1.y + gi1 * a1.x) + (gr2 * a2.y + gi2 * a2.x);
    v[2] = (gr1 * b1.x - gib1 * b1.y) + (gr2 * b2.x - gib2 * b2.y);
    v[3] = (gr1 * b1.y + gib1 * b1.x) + (gr2 * b2.y + gib2 * b2.x);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 4);
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 8);
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 16);
    }
    if (lane < 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) myred[kl * 4 + q] = v[q];
    }
  }
  __syncthreads();
  for (int e = tid; e < (FW_BN / 2) * 4; e += TC_THREADS) {
    const int kl = e >> 2, q = e & 3;
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[(w * (FW_BN / 2) + kl) * 4 + q];
    const int k = n0 / 2 + kl;
    if (k < K)
      part[(((((size_t)rt * B + b) * P + p) * 2 + (q >> 1)) * K + k) * 2 + (q & 1)] = s;
  }
}

// Forward stage 3: Ŝ = Σ_rt part[rt] (row-tile order), rounded; then
// out[row, s] = Σ_k Re Ŝ Wc[k, s] − Im Ŝ Ws[k, s] for ST_ROWS rows
// (row = b·2P + 2p + m) and ST3_COLS columns per block. Ŝ sits in shared
// memory as [k][row][re, im], so one 16-byte read serves two rows; each
// thread owns two columns, and the k loop is split ST3_SPLIT ways across the
// block (partial sums added in a fixed order).
// grid (ceil(rows/ST_ROWS), ceil(S/ST3_COLS)).
__global__ void __launch_bounds__(ST_THREADS)
pair_tc_fwd_stage3(const float* __restrict__ part, const float* __restrict__ Wc,
                   const float* __restrict__ Ws, float* __restrict__ out,
                   int rows, int K, int S, int R) {
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [K][ST_ROWS][2]
  float* red = s_s + ST_ROWS * 2 * K;            // [ST3_SPLIT][ST_ROWS][ST3_COLS]
  const int row0 = blockIdx.x * ST_ROWS;
  const int nr = min(ST_ROWS, rows - row0);
  const size_t plane = (size_t)rows * K * 2;
  const float* src = part + (size_t)row0 * K * 2;
#pragma unroll 4
  for (int e = threadIdx.x; e < ST_ROWS * 2 * K; e += ST_THREADS) {
    const int r = e / (2 * K), kk = e % (2 * K);
    float v = 0.f;
    if (r < nr)
      for (int t = 0; t < R; ++t) v += src[t * plane + e];
    s_s[((kk >> 1) * ST_ROWS + r) * 2 + (kk & 1)] = rnd(v);
  }
  __syncthreads();
  const int q = threadIdx.x / (ST3_COLS / 2), c2 = threadIdx.x % (ST3_COLS / 2);
  const int s = blockIdx.y * ST3_COLS + 2 * c2;
  const int kq = ceil_div(K, ST3_SPLIT);
  const int k_hi = min(K, (q + 1) * kq);
  float acc[ST_ROWS][2] = {};
  if (s < S) {
    const bool two = s + 1 < S;
#pragma unroll 4
    for (int k = q * kq; k < k_hi; ++k) {
      const float* wc = Wc + (size_t)k * S + s;
      const float* ws = Ws + (size_t)k * S + s;
      const float wc0 = rnd(wc[0]), ws0 = rnd(ws[0]);
      const float wc1 = two ? rnd(wc[1]) : 0.f, ws1 = two ? rnd(ws[1]) : 0.f;
      const float4* sk = reinterpret_cast<const float4*>(s_s + k * ST_ROWS * 2);
#pragma unroll
      for (int h = 0; h < ST_ROWS / 2; ++h) {
        const float4 v = sk[h];  // (re, im) of rows 2h and 2h + 1
        acc[2 * h][0] += v.x * wc0 - v.y * ws0;
        acc[2 * h][1] += v.x * wc1 - v.y * ws1;
        acc[2 * h + 1][0] += v.z * wc0 - v.w * ws0;
        acc[2 * h + 1][1] += v.z * wc1 - v.w * ws1;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ST_ROWS; ++r)
    *reinterpret_cast<float2*>(&red[(q * ST_ROWS + r) * ST3_COLS + 2 * c2]) =
        make_float2(acc[r][0], acc[r][1]);
  __syncthreads();
  for (int e = threadIdx.x; e < ST_ROWS * ST3_COLS; e += ST_THREADS) {
    const int r = e / ST3_COLS, col = e % ST3_COLS;
    const int sc = blockIdx.y * ST3_COLS + col;
    if (r >= nr || sc >= S) continue;
    float v = 0.f;
    for (int t = 0; t < ST3_SPLIT; ++t) v += red[(t * ST_ROWS + r) * ST3_COLS + col];
    out[(size_t)(row0 + r) * S + sc] = v;
  }
}

// Adjoint stage 3ᵀ: Ŝ_m[k] = (Σ_s p_m[s] Wc[k, s], −Σ_s p_m[s] Ws[k, s]),
// p rounded to bf16 then member b masked by msk, Ŝ rounded to bf16. One warp
// per k, lanes over s (coalesced W). Rows row = (b·P + p)·2 + m of p
// (B, 2P, S); shat4 (B, P, Kp, 4) = [re_a, im_a, re_b, im_b], zero for k ≥ K.
// grid (ceil(rows/ST_ROWS), ceil(Kp/ST3T_TK)).
__global__ void __launch_bounds__(ST_THREADS)
pair_tc_adj_stage3t(const float* __restrict__ p, const float* __restrict__ msk,
                    const float* __restrict__ Wc, const float* __restrict__ Ws,
                    float* __restrict__ shat4, int rows, int P, int K, int Kp, int S) {
  extern __shared__ float4 smem4[];
  float* p_s = reinterpret_cast<float*>(smem4);  // [ST_ROWS][S]
  const int row0 = blockIdx.x * ST_ROWS;
  const int nr = min(ST_ROWS, rows - row0);
#pragma unroll 4
  for (int e = threadIdx.x; e < ST_ROWS * S; e += ST_THREADS) {
    const int r = e / S, row = row0 + r;
    float v = 0.f;
    if (r < nr) {
      v = rnd(p[(size_t)row * S + e % S]);
      if (row & 1) v *= msk[(row >> 1) % P];
    }
    p_s[e] = v;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kk = warp; kk < ST3T_TK; kk += ST_THREADS / 32) {
    const int k = blockIdx.y * ST3T_TK + kk;
    if (k >= Kp) break;
    float re[ST_ROWS] = {}, im[ST_ROWS] = {};
    if (k < K) {
      const float* w_c = Wc + (size_t)k * S;
      const float* w_s = Ws + (size_t)k * S;
#pragma unroll 4
      for (int s = lane; s < S; s += 32) {
        const float wc = rnd(w_c[s]), ws = rnd(w_s[s]);
#pragma unroll
        for (int r = 0; r < ST_ROWS; ++r) {
          re[r] += p_s[r * S + s] * wc;
          im[r] += p_s[r * S + s] * ws;
        }
      }
#pragma unroll
      for (int r = 0; r < ST_ROWS; ++r) {
        for (int off = 16; off > 0; off >>= 1) {
          re[r] += __shfl_xor_sync(0xffffffffu, re[r], off);
          im[r] += __shfl_xor_sync(0xffffffffu, im[r], off);
        }
      }
    }
    if (lane < nr) {
      float vr = 0.f, vi = 0.f;
#pragma unroll
      for (int r = 0; r < ST_ROWS; ++r)
        if (r == lane) { vr = re[r]; vi = im[r]; }
      const int row = row0 + lane;
      float* dst = shat4 + ((size_t)(row >> 1) * Kp + k) * 4 + 2 * (row & 1);
      dst[0] = rnd(vr);
      dst[1] = rnd(-vi);
    }
  }
}

// ---------------------------------------------------------------------------
// Adjoint stages 2ᵀ + 1ᵀ: out[(b, r), c] = Σ_{(p, k, re/im) in slice g} h · T̂.
// grid (B·Np/TC_BM row tiles, ceil(N/AD_BN) column tiles, G slices); with
// G = 1 the tile goes to out, else to part[g] (summed by pair_tc_reduce).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(TC_THREADS, 1)
pair_tc_adj(const float* __restrict__ shat4, const __nv_bfloat16* __restrict__ tab,
            const float* __restrict__ sgn, float* __restrict__ dst,
            int B, int N, int Np, int P, int K2p, int G, int transpose) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sgen = smem_raw + (base - raw);

  const int R = Np / TC_BM;
  const int b = blockIdx.x / R, rt = blockIdx.x % R;
  const int c0 = blockIdx.y * AD_BN;
  const int g = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int Kp = K2p / 2;
  const int nkc = K2p / TC_BK;  // chunks per pair
  // slice g: chunks [i_lo, i_hi) of the group's P·nkc, in (pair, k) order
  const int i_lo = (int)((long long)P * nkc * g / G);
  const int n = (int)((long long)P * nkc * (g + 1) / G) - i_lo;
  const size_t tsz = (size_t)P * Np * K2p;

  // Chunk i = (pair (i_lo + i) / nkc, 64-deep slice of (k, re/im)). Raw stage:
  // T̂ [256 columns c][64] K-major, swizzled (the B operand), then φ_a and
  // φ_b [128 rows][64]. Each thread copies, and later reads, the φ chunks of
  // its own four h units: rows m0 + 32u, 16-byte column chunk j (4
  // frequencies, so one set of Ŝ, prefetched into registers).
  constexpr int UNITS = TC_BM * 8 / TC_THREADS;
  const int j = tid & 7, m0 = tid >> 3;
  auto load_raw = [&](int i) {
    if (i < n) {
      const int p = (i_lo + i) / nkc, kri0 = (i_lo + i) % nkc * TC_BK;
      const uint32_t rs = base + (i % AD_RAW_STAGES) * AD_RAW;
      const __nv_bfloat16* T = tab + (size_t)p * Np * K2p + kri0;
      for (int e = tid; e < AD_BN * 8; e += TC_THREADS) {
        const int nn = e >> 3, jj = e & 7, c = c0 + nn;
        const bool ok = c < Np;  // columns past the table are zero-filled
        cp_async16(rs + swz(nn, jj), T + (size_t)(ok ? c : 0) * K2p + jj * 8, ok ? 16 : 0);
      }
      const __nv_bfloat16* PA = tab + tsz + ((size_t)p * Np + (size_t)rt * TC_BM) * K2p + kri0;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int m = m0 + u * (TC_THREADS / 8);
        cp_async16(rs + AD_T_BYTES + m * 128 + j * 16, PA + (size_t)m * K2p + j * 8, 16);
        cp_async16(rs + AD_T_BYTES + AD_PHI_BYTES + m * 128 + j * 16,
                   PA + tsz + (size_t)m * K2p + j * 8, 16);
      }
    }
    cp_async_commit();  // one group per chunk, empty past the end
  };
  auto load_shat = [&](int i, float4 (&sv)[4], float& sg) {
    if (i < n) {
      const int p = (i_lo + i) / nkc, k0 = (i_lo + i) % nkc * (TC_BK / 2);
      const float4* SV = reinterpret_cast<const float4*>(shat4) +
                         ((size_t)b * P + p) * Kp + k0 + j * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = __ldg(SV + q);  // (re_a, im_a, re_b, im_b)
      sg = __ldg(sgn + p);
    }
  };
  auto build_h = [&](int i, const float4 (&sv)[4], float sg) {
    const uint8_t* rs = sgen + (i % AD_RAW_STAGES) * AD_RAW + AD_T_BYTES;
    uint8_t* hs = sgen + AD_RAW_STAGES * AD_RAW + (i % AD_H_STAGES) * AD_H_BYTES;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int m = m0 + u * (TC_THREADS / 8);
      const uint4 ua = *reinterpret_cast<const uint4*>(rs + m * 128 + j * 16);
      const uint4 ub = *reinterpret_cast<const uint4*>(rs + AD_PHI_BYTES + m * 128 + j * 16);
      const uint32_t wa[4] = {ua.x, ua.y, ua.z, ua.w};
      const uint32_t wb[4] = {ub.x, ub.y, ub.z, ub.w};
      uint32_t hv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 fa = bf2_to_f2(wa[q]), fbb = bf2_to_f2(wb[q]);
        const float hr = (sv[q].x * fa.x + sv[q].y * fa.y) + (sv[q].z * fbb.x + sv[q].w * fbb.y);
        const float hi = (-(sv[q].x * fa.y) + sv[q].y * fa.x) +
                         sg * (-(sv[q].z * fbb.y) + sv[q].w * fbb.x);
        hv[q] = f2_to_bf2(hr, hi);
      }
      *reinterpret_cast<uint4*>(hs + swz(m, j)) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
    }
  };

  float acc[AD_BN / 2];
#pragma unroll
  for (int i = 0; i < AD_BN / 2; ++i) acc[i] = 0.f;
  float4 sv_c[4], sv_n[4];
  float sg_c = 0.f, sg_n = 0.f;
  load_raw(0);
  load_raw(1);
  load_shat(0, sv_c, sg_c);
  load_shat(1, sv_n, sg_n);
  if (n > 0) {
    cp_async_wait<1>();  // chunk 0's raw stage (this thread's copies)
    build_h(0, sv_c, sg_c);
  }
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) sv_c[q] = sv_n[q];
    sg_c = sg_n;
    fence_proxy_async();
    __syncthreads();  // h and T̂ of chunk i in shared memory; chunk i-1's products done
    load_raw(i + 2);  // into the raw stage chunk i-1 used
    load_shat(i + 2, sv_n, sg_n);
    const uint32_t sa = base + AD_RAW_STAGES * AD_RAW + (i % AD_H_STAGES) * AD_H_BYTES +
                        wg * (64 * 128);
    const uint32_t sb = base + (i % AD_RAW_STAGES) * AD_RAW;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks)
      wgmma_n256_k(acc, desc_sw128(sa + ks * 32, 16, 1024), desc_sw128(sb + ks * 32, 16, 1024));
    wgmma_commit();
    if (i + 1 < n) {  // overlaps the products of chunk i
      cp_async_wait<1>();
      build_h(i + 1, sv_c, sg_c);
    }
    wgmma_wait0();
    fence_acc(acc);
  }

  float* ob = dst + ((size_t)g * B + b) * N * N;
  const int r1 = rt * TC_BM + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < AD_BN / 8; ++j) {
    const int c = c0 + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r1 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c + e;
        if (r < N && cc < N)
          ob[transpose ? (size_t)cc * N + r : (size_t)r * N + cc] = acc[4 * j + 2 * h + e];
      }
    }
  }
}

// out[i] = Σ_g part[g][i], g in order. n = B·N·N.
__global__ void __launch_bounds__(ST_THREADS)
pair_tc_reduce(const float* __restrict__ part, float* __restrict__ out, size_t n, int G) {
  for (size_t i = (size_t)blockIdx.x * ST_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * ST_THREADS) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += part[(size_t)g * n + i];
    out[i] = acc;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int grid_for(size_t n) {
  const size_t want = (n + 255) / 256;
  return (int)(want < 8192 ? (want > 0 ? want : 1) : 8192);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers to
// contiguous arrays: float32, except tab (bf16, 16-byte aligned) and fb
// (bf16 scratch). The stream is a cudaStream_t. Each returns the
// cudaError_t of its launches (0 on success); nothing here synchronises or
// allocates. Np = 128·⌈N/128⌉, Kp with 2Kp = 128·⌈2K/128⌉.

// tab (3, P, Np, 2Kp) bf16, from the group's pos / sha / shb rows (P, N).
extern "C" int radon_pair_tc_tables(const float* pos, const float* sha, const float* shb,
                                    const float* spec, void* tab, int P, int N, int Np,
                                    int K, int Kp, float kscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pair_tables<<<grid_for((size_t)3 * P * Np * Kp), 256, 0, st>>>(
      pos, sha, shb, spec, static_cast<uint32_t*>(tab), P, N, Np, K, Kp, kscale);
  return static_cast<int>(cudaGetLastError());
}

// f (B, N, N) -> out (B, 2P, S). Scratch: fb (B, Np, Np) bf16, part
// (Np/128, B, 2P, K, 2) float32.
extern "C" int radon_pair_tc_project(const float* f, const void* tab, const float* sgn,
                                     const float* Wc, const float* Ws, void* fb, float* part,
                                     float* out, int B, int N, int Np, int P, int K, int Kp,
                                     int S, int contract_x, void* stream) {
  const int K2p = 2 * Kp;
  if (Np % TC_BM || Np < N || K2p % FW_BN || Kp < K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* fbh = static_cast<__nv_bfloat16*>(fb);
  const __nv_bfloat16* tb = static_cast<const __nv_bfloat16*>(tab);
  pair_tc_prep<<<dim3(Np / 32, Np / 32, B), dim3(32, 8), 0, st>>>(f, fbh, N, Np, !contract_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)pair_tc_fwd, FW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_tc_fwd<<<dim3((K2p / FW_BN) * P, B * (Np / TC_BM)), TC_THREADS, FW_SMEM, st>>>(
      fbh, tb, sgn, part, B, Np, P, K, K2p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * 2 * P;
  const size_t smem3 = (size_t)ST_ROWS * (2 * K + ST3_SPLIT * ST3_COLS) * sizeof(float);
  err = set_smem((const void*)pair_tc_fwd_stage3, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_tc_fwd_stage3<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(S, ST3_COLS)), ST_THREADS,
                       smem3, st>>>(part, Wc, Ws, out, rows, K, S, Np / TC_BM);
  return static_cast<int>(cudaGetLastError());
}

// p (B, 2P, S) -> out (B, N, N). Scratch: shat4 (B, P, Kp, 4) float32 and,
// when G > 1, part (G, B, N, N) float32.
extern "C" int radon_pair_tc_backproject(const float* p, const void* tab, const float* sgn,
                                         const float* msk, const float* Wc, const float* Ws,
                                         float* shat4, float* part, float* out, int B, int N,
                                         int Np, int P, int K, int Kp, int S, int G,
                                         int contract_x, void* stream) {
  const int K2p = 2 * Kp;
  if (Np % TC_BM || Np < N || K2p % TC_BK || Kp < K || G < 1 || G > P * (K2p / TC_BK) ||
      (G > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * 2 * P;
  const size_t smem3 = (size_t)ST_ROWS * S * sizeof(float);
  cudaError_t err = set_smem((const void*)pair_tc_adj_stage3t, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_tc_adj_stage3t<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(Kp, ST3T_TK)), ST_THREADS,
                        smem3, st>>>(p, msk, Wc, Ws, shat4, rows, P, K, Kp, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)pair_tc_adj, AD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_tc_adj<<<dim3(B * (Np / TC_BM), ceil_div(N, AD_BN), G), TC_THREADS, AD_SMEM, st>>>(
      shat4, static_cast<const __nv_bfloat16*>(tab), sgn, G > 1 ? part : out, B, N, Np, P,
      K2p, G, !contract_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * N * N;
  pair_tc_reduce<<<grid_for(n), ST_THREADS, 0, st>>>(part, out, n, G);
  return static_cast<int>(cudaGetLastError());
}
