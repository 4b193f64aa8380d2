// Tensor-core (sm_90a, bf16 operands) projector machinery shared by
// radon_pair_tc.cu (mirror pairs, M = 2 members per stage-1 row group) and
// radon_group_tc.cu (per angle, M = 1), and by their float32 split-bf16
// twins radon_pair_split.cu (M = 2) and radon_group_split.cu (M = 1). Each
// including file names its own kernels (thin __global__ wrappers around the
// bodies below) and its C entry points; the notes on what each replaces and
// what bounds it are there.
//
// The function: per row group g
// (a pair, or an angle) of one angle group, with members m < M,
//   ĝ[r, k]     = Σ_c F[r, c] T̂_g[c, k]                        (stage 1)
//   Ŝ_m[k]      = Σ_r ĝ_m[r, k] φ_m[g, r, k], ĝ_1 = (gr, sgn·gi) (stage 2)
//   out[M·g+m, s] = Σ_k Re Ŝ_m Wc[k, s] − Im Ŝ_m Ws[k, s]        (stage 3)
// and its exact transpose. Rounding points are the plain versions': F (or
// p), T̂, φ, W and Ŝ (or h) are rounded to bf16, every sum is f32: the
// contract of wgmma with f32 accumulators, so stage 1 and 1ᵀ run there.
//
// The per-angle route's stages 3 and 3ᵀ are bf16 GEMMs on the tensor cores
// too (tc_gemm over the same mma_tile_128, from operands that
// tc_sum_round_pad and tc_w_prep round and pad).
//
// Trig comes from per-plan tables built on the card by tc_tables, in the
// layout the products read: (1 + M, G, Np, 2Kp) bf16 — T̂, then each
// member's φ — with (re, im) interleaved along the frequency axis, so that
// the accumulator's adjacent-column pair in one thread holds (re, im) of
// one k; rows padded to Np = 128·⌈N/128⌉ and 2K to 2Kp = 128·⌈2K/128⌉ with
// zeros.
//
// Forward (stages 1+2 fused): tc_prep writes F in bf16, zero-padded to
// (B, Np, Np) and transposed for the y group, so that the A operand is
// always K-major. Each block of tc_fwd owns (128 rows of one image) x
// (128 interleaved frequency columns) x (one row group); two warpgroups each
// run m64n128k16 over depth N in 64-deep chunks through a three-stage ring
// (mma_tile_128), with T̂_g as an MN-major B operand. During the last chunk
// the block copies its M φ tiles into the free stages. The epilogue applies
// the members' phases to the f32 accumulators (ĝ is never rounded, as in the
// plain version), reduces over the tile's rows with warp shuffles and shared
// memory, and writes one partial Ŝ per row tile. Each including file's
// stage 3 sums the partials in row-tile order, rounds Ŝ and multiplies by W.
//
// Adjoint: each including file's stage 3ᵀ gives Ŝ_m = Wᵀ p_m (for M = 2
// member b masked by msk) rounded to bf16, in the layout (B, G, Kp,
// M·[re, im]). tc_adj then runs one GEMM over its slice of depth, the row groups' 64-deep chunks of
// (k, re/im) in order: a three-stage ring of raw chunks (T̂ as the K-major B
// operand, the M φ rows) runs two chunks ahead, and while the tensor cores
// work on chunk i all threads build chunk i+1's A operand
// h = Σ_m Ŝ_m conj(φ_m) (sgn on member 1's Im, Ŝ prefetched into
// registers), rounded to bf16, straight into swizzled shared memory: h never
// reaches device memory. The y group's output is stored transposed; the
// accumulator fragment's 8-row x 2-column quads make every 32-byte sector of
// either orientation complete, so the store needs no staging. The depth is
// split into slices chosen by the wrapper so that the card fills; each slice
// writes a partial image that tc_reduce sums in a fixed order (no atomics:
// deterministic).
//
// Padded rows, columns and frequencies are zero in the tables.
//
// Split-bf16 route (float32 operands, SPLIT = true; radon_pair_split.cu,
// radon_group_split.cu).
// One bf16 product keeps ~3 significant digits, far from the f32 contract
// (1e-5 relative). Each stage-1 / 1ᵀ operand x is carried as hi = bf16(x)
// and lo = bf16(x − hi) (x − hi is exact in f32), and every 16-deep step
// issues three wgmmas into the same f32 accumulators, hi·hi, hi·lo, lo·hi
// (lo·lo, ~2⁻¹⁸ relative, is dropped). The tables hold T̂ as hi and lo
// bf16 planes and φ in f32 (tc_split_tables): φ feeds stage 2 / 2ᵀ on the
// CUDA cores, where a split φ would only add error. Stages 2, 3 and their
// transposes stay f32 on the CUDA cores; Ŝ and h are never rounded (h is
// split into hi and lo as it is written to shared memory). The forward is
// tc_fwd with doubled ring stages (F and T̂ each hi + lo: 64 KB); the
// adjoint is tc_adj_split, whose hi + lo T̂ and h and f32 φ need a
// 128-column output tile and a one-deep φ stage to fit in shared memory.

#pragma once

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
// adjoint: a ring of three raw stages (T̂ chunk and the M φ rows), loaded
// two chunks ahead, and two stages of the h operand built from them
constexpr uint32_t AD_T_BYTES = AD_BN * TC_BK * 2;
constexpr uint32_t AD_PHI_BYTES = TC_BM * TC_BK * 2;
constexpr uint32_t AD_H_BYTES = TC_BM * TC_BK * 2;
constexpr int AD_RAW_STAGES = 3, AD_H_STAGES = 2;
__host__ __device__ constexpr uint32_t ad_raw(int M) { return AD_T_BYTES + M * AD_PHI_BYTES; }
// stages, plus slack to align them to the 1024-byte swizzle atom
constexpr size_t FW_SMEM = FW_STAGES * FW_STAGE + 1024;
__host__ __device__ constexpr size_t ad_smem(int M) {
  return AD_RAW_STAGES * ad_raw(M) + AD_H_STAGES * AD_H_BYTES + 1024;
}
// forward ring stage of the split route: F and T̂ tiles, each hi then lo; an
// f32 φ tile [128 rows][128 interleaved columns] is exactly one such stage
constexpr uint32_t FW_SPLIT_STAGE = 2 * FW_STAGE;
constexpr size_t FW_SPLIT_SMEM = FW_STAGES * FW_SPLIT_STAGE + 1024;
// split adjoint: output tiles of 128 image columns; a ring of three T̂
// stages (hi, lo: [128 columns][64] K-major each), two h stages (hi, lo:
// [128 rows][64]) and one stage of the M f32 φ chunks [128 rows][64]
constexpr int AS_BN = 128;
constexpr uint32_t AS_T_BYTES = 2 * AS_BN * TC_BK * 2;
constexpr uint32_t AS_H_BYTES = 2 * TC_BM * TC_BK * 2;
constexpr uint32_t AS_PHI_BYTES = TC_BM * TC_BK * 4;
constexpr int AS_T_STAGES = 3, AS_H_STAGES = 2;
__host__ __device__ constexpr size_t as_smem(int M) {
  return AS_T_STAGES * AS_T_BYTES + AS_H_STAGES * AS_H_BYTES + M * AS_PHI_BYTES + 1024;
}

constexpr int ST_THREADS = 256;  // threads of the grid-stride kernels

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

// D (64 x 128, f32) += A (64 x 16, bf16, K-major) * B (16 x 128, bf16), both
// from shared memory; B MN-major (TRANS_B = 1) or K-major (TRANS_B = 0).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B)
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

// (re, im) as bf16 hi and lo pairs: hi = bf16(x), lo = bf16(x − hi)
__device__ __forceinline__ void f2_split(float re, float im, uint32_t& hi, uint32_t& lo) {
  hi = f2_to_bf2(re, im);
  const float2 h = bf2_to_f2(hi);
  lo = f2_to_bf2(re - h.x, im - h.y);
}

// ---------------------------------------------------------------------------
// Per-plan trig tables: tab (1 + M, G, Np, Kp) of bf16 (re, im) pairs:
//   t = 0: T̂   = (spec·cos, −spec·sin)(pos[g, c]·kf)
//   t = 1: φ_0 = (cos, sin)(sh0[g, r]·kf),  t = 2: φ_1 from sh1 (M = 2)
// with kf = (float)k·kscale and the angle formed as the plain version forms
// it (both products rounded, no FMA contraction), precise sincosf; zero for
// rows ≥ N and k ≥ K. Grid-stride over the table; 256 threads.
// ---------------------------------------------------------------------------
// (re, im) of table t at element i of one (P, Np, Kp) plane
__device__ __forceinline__ float2 tc_trig(const float* __restrict__ pos,
                                          const float* __restrict__ sh0,
                                          const float* __restrict__ sh1,
                                          const float* __restrict__ spec, int t, size_t i,
                                          int P, int N, int Np, int K, int Kp, float kscale) {
  const int k = (int)(i % Kp);
  const int row = (int)((i / Kp) % Np);
  const int p = (int)(i / ((size_t)Kp * Np));
  if (row >= N || k >= K) return make_float2(0.f, 0.f);
  const float* src = t == 0 ? pos : (t == 1 ? sh0 : sh1);
  const float kf = __fmul_rn((float)k, kscale);
  float s, c;
  sincosf(__fmul_rn(src[(size_t)p * N + row], kf), &s, &c);
  if (t == 0) {
    const float sp = spec[k];
    return make_float2(sp * c, -sp * s);
  }
  return make_float2(c, s);
}

template <int M>
__device__ __forceinline__ void tc_tables(const float* __restrict__ pos,
                                          const float* __restrict__ sh0,
                                          const float* __restrict__ sh1,
                                          const float* __restrict__ spec,
                                          uint32_t* __restrict__ tab, int P, int N, int Np,
                                          int K, int Kp, float kscale) {
  const size_t plane = (size_t)P * Np * Kp, n = (1 + M) * plane;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float2 v = tc_trig(pos, sh0, sh1, spec, (int)(i / plane), i % plane, P, N, Np, K,
                             Kp, kscale);
    tab[i] = f2_to_bf2(v.x, v.y);
  }
}

// The split route's tables, the same values: T (2, G, Np, Kp) bf16 (re, im)
// pairs, T̂'s hi plane then its lo plane; phi (M, G, Np, Kp) f32 (re, im)
// pairs, each member's φ unrounded. Grid-stride; 256 threads.
template <int M>
__device__ __forceinline__ void tc_split_tables(const float* __restrict__ pos,
                                                const float* __restrict__ sh0,
                                                const float* __restrict__ sh1,
                                                const float* __restrict__ spec,
                                                uint32_t* __restrict__ T,
                                                float2* __restrict__ phi, int P, int N, int Np,
                                                int K, int Kp, float kscale) {
  const size_t plane = (size_t)P * Np * Kp, n = (1 + M) * plane;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int t = (int)(i / plane);
    const size_t e = i % plane;
    const float2 v = tc_trig(pos, sh0, sh1, spec, t, e, P, N, Np, K, Kp, kscale);
    if (t == 0) {
      uint32_t hi, lo;
      f2_split(v.x, v.y, hi, lo);
      T[e] = hi;
      T[plane + e] = lo;
    } else {
      phi[(t - 1) * plane + e] = v;
    }
  }
}

// F in bf16, zero-padded to (B, Np, Np): fb[b, r, c] = F(r, c), where
// F(r, c) = f[b, r, c] (x group) or f[b, c, r] (y group, transpose = 1).
// 32x32 tiles through shared memory keep both sides coalesced. With fb_lo
// (the split route) fb gets hi = bf16(F) and fb_lo the same layout of
// lo = bf16(F − hi).
// grid (Np/32, Np/32, B), block (32, 8).
__device__ __forceinline__ void tc_prep(const float* __restrict__ f,
                                        __nv_bfloat16* __restrict__ fb, int N, int Np,
                                        int transpose,
                                        __nv_bfloat16* __restrict__ fb_lo = nullptr) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, y0 = blockIdx.y * 32, x0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* src = f + (size_t)b * N * N;
  for (int yy = ty; yy < 32; yy += 8) {
    const int y = y0 + yy, x = x0 + tx;
    tile[yy][tx] = (y < N && x < N) ? src[(size_t)y * N + x] : 0.f;
  }
  __syncthreads();
  const size_t off = (size_t)b * Np * Np;
  for (int yy = ty; yy < 32; yy += 8) {
    const float v = transpose ? tile[tx][yy] : tile[yy][tx];
    const size_t at = off + (transpose ? (size_t)(x0 + yy) * Np + y0 + tx
                                       : (size_t)(y0 + yy) * Np + x0 + tx);
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    fb[at] = hi;
    if (fb_lo != nullptr) fb_lo[at] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
}

// One 128 x 128 f32 tile (two warpgroups of m64n128k16) of A · B over depth
// 64·nk, through a FW_STAGES-deep cp.async ring of FW_STAGE-byte stages at
// `base` (1024-byte aligned): A [128 rows][depth] K-major, rows lda
// elements apart; B MN-major (depth rows ldb apart, the tile's columns
// n0.. contiguous) or, for KMAJOR_B, K-major (rows n0.. of [N][depth], ldb
// apart). `on_last()` runs while the last chunk's products do; it may
// start and commit cp.async copies into the stages that chunk does not use
// (stage (nk − 1) % FW_STAGES), which have landed when this returns.
// SPLIT (the split-bf16 route): A and B each have a lo plane a_lo / b_lo
// elements past the hi one; a stage holds [A hi][A lo][B hi][B lo]
// (FW_SPLIT_STAGE bytes), and each 16-deep step runs A_hi·B_hi, A_hi·B_lo,
// A_lo·B_hi into the same accumulators.
template <bool KMAJOR_B, bool SPLIT = false, class OnLast>
__device__ __forceinline__ void mma_tile_128(float (&acc)[FW_BN / 2],
                                             const __nv_bfloat16* __restrict__ A, size_t lda,
                                             const __nv_bfloat16* __restrict__ Bm, size_t ldb,
                                             int n0, int nk, uint32_t base, OnLast on_last,
                                             size_t a_lo = 0, size_t b_lo = 0) {
  constexpr int PARTS = SPLIT ? 2 : 1;
  constexpr uint32_t STAGE = SPLIT ? FW_SPLIT_STAGE : FW_STAGE;
  const int tid = threadIdx.x, wg = tid >> 7;
  // stage: A rows [128][64] K-major; B MN-major [2 column blocks][64 depth][64]
  // or K-major [128 columns][64 depth], 128-byte swizzled
  auto load = [&](int kc, uint32_t stage) {
    const int c0 = kc * TC_BK;
#pragma unroll
    for (int h = 0; h < PARTS; ++h) {
      const __nv_bfloat16* Ah = A + h * a_lo;
      const uint32_t sa = stage + h * FW_A_BYTES;
      for (int e = tid; e < TC_BM * 8; e += TC_THREADS) {
        const int m = e >> 3, j = e & 7;
        cp_async16(sa + swz(m, j), Ah + (size_t)m * lda + c0 + j * 8, 16);
      }
      const __nv_bfloat16* Bh = Bm + h * b_lo;
      const uint32_t sb = stage + PARTS * FW_A_BYTES + h * FW_B_BYTES;
      if (KMAJOR_B) {
        for (int e = tid; e < FW_BN * 8; e += TC_THREADS) {
          const int nn = e >> 3, j = e & 7;
          cp_async16(sb + swz(nn, j), Bh + (size_t)(n0 + nn) * ldb + c0 + j * 8, 16);
        }
      } else {
        for (int e = tid; e < TC_BK * (FW_BN / 8); e += TC_THREADS) {
          const int j = e & 7, nb = (e >> 3) % (FW_BN / 64), kk = e / (FW_BN / 8);
          cp_async16(sb + nb * (TC_BK * 128) + swz(kk, j),
                     Bh + (size_t)(c0 + kk) * ldb + n0 + nb * 64 + j * 8, 16);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < FW_BN / 2; ++i) acc[i] = 0.f;
  // one commit group per chunk (empty past the end), so that waiting for
  // all but the newest FW_STAGES - 2 groups means chunk kc has landed
  for (int st = 0; st < FW_STAGES - 1; ++st) {
    if (st < nk) load(st, base + st * STAGE);
    else cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    const uint32_t stage = base + (kc % FW_STAGES) * STAGE;
    cp_async_wait<FW_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // chunk kc in shared memory; chunk kc-1's products done
    const int next = kc + FW_STAGES - 1;  // into the stage chunk kc-1 used
    if (next < nk) load(next, base + (next % FW_STAGES) * STAGE);
    else cp_async_commit();
    if (kc == nk - 1) on_last();
    const uint32_t sa = stage + wg * (64 * 128), sb = stage + PARTS * FW_A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      auto da = [&](uint32_t a) { return desc_sw128(a + ks * 32, 16, 1024); };
      auto db = [&](uint32_t b) {
        return KMAJOR_B ? desc_sw128(b + ks * 32, 16, 1024)
                        : desc_sw128(b + ks * 2048, TC_BK * 128, 1024);
      };
      wgmma_n128<KMAJOR_B ? 0 : 1>(acc, da(sa), db(sb));
      if constexpr (SPLIT) {  // hi·lo, then lo·hi
        wgmma_n128<KMAJOR_B ? 0 : 1>(acc, da(sa), db(sb + FW_B_BYTES));
        wgmma_n128<KMAJOR_B ? 0 : 1>(acc, da(sa + FW_A_BYTES), db(sb));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
  }
  cp_async_wait_all();
  __syncthreads();  // on_last's copies landed; both warpgroups done with the last stage
}

// ---------------------------------------------------------------------------
// Forward stages 1+2. grid ((2Kp/FW_BN)·P, B·Np/TC_BM); block = 2 warpgroups;
// FW_SMEM bytes of dynamic shared memory. part layout (R, B, P, M, K, 2):
// one partial Ŝ per row tile rt < R = Np/128. sgn (P) is read for M = 2 only.
// SPLIT: fb holds F's hi plane then its lo plane (2, B, Np, Np), tab T̂'s
// (2, P, Np, 2Kp) hi and lo planes, and phi the M f32 φ tables (M, P, Np,
// 2Kp); FW_SPLIT_SMEM bytes of dynamic shared memory.
// ---------------------------------------------------------------------------
template <int M, bool SPLIT = false>
__device__ __forceinline__ void tc_fwd(const __nv_bfloat16* __restrict__ fb,
                                       const __nv_bfloat16* __restrict__ tab,
                                       const float* __restrict__ sgn, float* __restrict__ part,
                                       int B, int Np, int P, int K, int K2p,
                                       const float* __restrict__ phi_tab = nullptr) {
  static_assert(M == 1 || M == 2, "one or two members per row group");
  constexpr uint32_t STAGE = SPLIT ? FW_SPLIT_STAGE : FW_STAGE;
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

  // The epilogue's M φ tiles [128 rows][64 (cos, sin)], 16-byte chunks
  // XOR-swizzled by row, go to the stages the last chunk does not use while
  // its products run.
  const int nk = Np / TC_BK;
  const int last = (nk - 1) % FW_STAGES;
  int phi_slot[M];
#pragma unroll
  for (int t = 0; t < M; ++t) phi_slot[t] = (last + 1 + t) % FW_STAGES;
  // (SPLIT: f32 rows of 512 bytes, 16-byte chunk c stored at c ^ 2·(row % 8),
  // which spreads a warp's eight rows over the banks)
  auto load_phi = [&]() {
#pragma unroll
    for (int t = 0; t < M; ++t) {
      const size_t at = ((size_t)p * Np + (size_t)rt * TC_BM) * K2p + n0;
      const uint32_t dst = base + phi_slot[t] * STAGE;
      if constexpr (SPLIT) {
        const float* src = phi_tab + t * tsz + at;
        for (int e = tid; e < TC_BM * (FW_BN / 4); e += TC_THREADS) {
          const int row = e / (FW_BN / 4), c = e % (FW_BN / 4);
          cp_async16(dst + row * (FW_BN * 4) + ((c ^ ((row & 7) << 1)) << 4),
                     src + (size_t)row * K2p + c * 4, 16);
        }
      } else {
        const __nv_bfloat16* src = tab + (t + 1) * tsz + at;
        for (int e = tid; e < TC_BM * (FW_BN / 8); e += TC_THREADS) {
          const int row = e / (FW_BN / 8), c = e % (FW_BN / 8);
          cp_async16(dst + row * (FW_BN * 2) + ((c ^ (row & 7)) << 4),
                     src + (size_t)row * K2p + c * 8, 16);
        }
      }
    }
    cp_async_commit();
  };

  // stage 1: ĝ of F rows [rt·128, +128) against T̂_p columns [n0, +128)
  float acc[FW_BN / 2];
  mma_tile_128<false, SPLIT>(acc, fb + ((size_t)b * Np + (size_t)rt * TC_BM) * Np, Np,
                             tab + (size_t)p * Np * K2p, K2p, n0, nk, base, load_phi,
                             (size_t)B * Np * Np, tsz);

  // stage 2 on the f32 accumulators: thread holds (gr, gi) of frequency
  // n0/2 + 4j + lane%4 for tile rows ra and ra + 8
  const float sg = M == 2 ? sgn[p] : 1.f;
  float* red = reinterpret_cast<float*>(sgen + last * STAGE);
  const int ra = wg * 64 + warp * 16 + (lane >> 2), rb = ra + 8;
  // [64 k][M · (re, im)] per warp
  float* myred = red + (wg * 4 + warp) * (FW_BN / 2) * (2 * M);
  auto phi = [&](int t, int r, int j) {
    const uint8_t* tile = sgen + phi_slot[t] * STAGE;
    if constexpr (SPLIT) {
      const int c = 2 * j + ((lane & 3) >> 1);
      return *reinterpret_cast<const float2*>(
          tile + r * (FW_BN * 4) + ((c ^ ((r & 7) << 1)) << 4) + (lane & 1) * 8);
    } else {
      return bf2_to_f2(*reinterpret_cast<const uint32_t*>(
          tile + r * (FW_BN * 2) + ((j ^ (r & 7)) << 4) + (lane & 3) * 4));
    }
  };
#pragma unroll
  for (int j = 0; j < FW_BN / 8; ++j) {
    const int kl = j * 4 + (lane & 3);
    const float gr1 = acc[4 * j], gi1 = acc[4 * j + 1];
    const float gr2 = acc[4 * j + 2], gi2 = acc[4 * j + 3];
    float v[2 * M];
#pragma unroll
    for (int t = 0; t < M; ++t) {
      const float2 c1 = phi(t, ra, j), c2 = phi(t, rb, j);
      const float g1 = t ? gi1 * sg : gi1, g2 = t ? gi2 * sg : gi2;
      v[2 * t] = (gr1 * c1.x - g1 * c1.y) + (gr2 * c2.x - g2 * c2.y);
      v[2 * t + 1] = (gr1 * c1.y + g1 * c1.x) + (gr2 * c2.y + g2 * c2.x);
    }
#pragma unroll
    for (int q = 0; q < 2 * M; ++q) {
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 4);
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 8);
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 16);
    }
    if (lane < 4) {
#pragma unroll
      for (int q = 0; q < 2 * M; ++q) myred[kl * (2 * M) + q] = v[q];
    }
  }
  __syncthreads();
  for (int e = tid; e < (FW_BN / 2) * (2 * M); e += TC_THREADS) {
    const int kl = e / (2 * M), q = e % (2 * M);
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[(w * (FW_BN / 2) + kl) * (2 * M) + q];
    const int k = n0 / 2 + kl;
    if (k < K)
      part[(((((size_t)rt * B + b) * P + p) * M + (q >> 1)) * K + k) * 2 + (q & 1)] = s;
  }
}

// ---------------------------------------------------------------------------
// Adjoint stages 2ᵀ + 1ᵀ: out[(b, r), c] = Σ_{(g, k, re/im) in slice} h · T̂.
// grid (B·Np/TC_BM row tiles, ceil(N/AD_BN) column tiles, G slices);
// TC_THREADS threads, ad_smem(M) bytes of dynamic shared memory. With G = 1
// the tile goes to out, else to part[slice] (summed by tc_reduce). sgn (P)
// is read for M = 2 only.
// ---------------------------------------------------------------------------
template <int M>
__device__ __forceinline__ void tc_adj(const float* __restrict__ shat,
                                       const __nv_bfloat16* __restrict__ tab,
                                       const float* __restrict__ sgn, float* __restrict__ dst,
                                       int B, int N, int Np, int P, int K2p, int G,
                                       int transpose) {
  static_assert(M == 1 || M == 2, "one or two members per row group");
  constexpr uint32_t AD_RAW = ad_raw(M);
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
  const int nkc = K2p / TC_BK;  // chunks per row group
  // slice g: chunks [i_lo, i_hi) of the group's P·nkc, in (row group, k) order
  const int i_lo = (int)((long long)P * nkc * g / G);
  const int n = (int)((long long)P * nkc * (g + 1) / G) - i_lo;
  const size_t tsz = (size_t)P * Np * K2p;

  // Chunk i = (row group (i_lo + i) / nkc, 64-deep slice of (k, re/im)). Raw
  // stage: T̂ [256 columns c][64] K-major, swizzled (the B operand), then the
  // M φ chunks [128 rows][64]. Each thread copies, and later reads, the φ
  // chunks of its own four h units: rows m0 + 32u, 16-byte column chunk j (4
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
      const __nv_bfloat16* PH = tab + tsz + ((size_t)p * Np + (size_t)rt * TC_BM) * K2p + kri0;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int m = m0 + u * (TC_THREADS / 8);
#pragma unroll
        for (int t = 0; t < M; ++t)
          cp_async16(rs + AD_T_BYTES + t * AD_PHI_BYTES + m * 128 + j * 16,
                     PH + t * tsz + (size_t)m * K2p + j * 8, 16);
      }
    }
    cp_async_commit();  // one group per chunk, empty past the end
  };
  // Ŝ of this thread's four frequencies: [4 k][M · (re, im)]
  auto load_shat = [&](int i, float (&sv)[8 * M], float& sg) {
    if (i < n) {
      const int p = (i_lo + i) / nkc, k0 = (i_lo + i) % nkc * (TC_BK / 2);
      const float4* SV = reinterpret_cast<const float4*>(
          shat + (((size_t)b * P + p) * Kp + k0 + j * 4) * (2 * M));
#pragma unroll
      for (int q = 0; q < 2 * M; ++q) {
        const float4 v = __ldg(SV + q);
        sv[4 * q] = v.x;
        sv[4 * q + 1] = v.y;
        sv[4 * q + 2] = v.z;
        sv[4 * q + 3] = v.w;
      }
      sg = M == 2 ? __ldg(sgn + p) : 1.f;
    }
  };
  auto build_h = [&](int i, const float (&sv)[8 * M], float sg) {
    const uint8_t* rs = sgen + (i % AD_RAW_STAGES) * AD_RAW + AD_T_BYTES;
    uint8_t* hs = sgen + AD_RAW_STAGES * AD_RAW + (i % AD_H_STAGES) * AD_H_BYTES;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int m = m0 + u * (TC_THREADS / 8);
      uint32_t w[M][4];
#pragma unroll
      for (int t = 0; t < M; ++t) {
        const uint4 ut = *reinterpret_cast<const uint4*>(rs + t * AD_PHI_BYTES + m * 128 + j * 16);
        w[t][0] = ut.x;
        w[t][1] = ut.y;
        w[t][2] = ut.z;
        w[t][3] = ut.w;
      }
      uint32_t hv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* s = sv + q * (2 * M);
        const float2 fa = bf2_to_f2(w[0][q]);
        float hr = s[0] * fa.x + s[1] * fa.y;
        float hi = -(s[0] * fa.y) + s[1] * fa.x;
        if (M == 2) {
          const float2 fbb = bf2_to_f2(w[M - 1][q]);
          hr = hr + (s[2 * M - 2] * fbb.x + s[2 * M - 1] * fbb.y);
          hi = hi + sg * (-(s[2 * M - 2] * fbb.y) + s[2 * M - 1] * fbb.x);
        }
        hv[q] = f2_to_bf2(hr, hi);
      }
      *reinterpret_cast<uint4*>(hs + swz(m, j)) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
    }
  };

  float acc[AD_BN / 2];
#pragma unroll
  for (int i = 0; i < AD_BN / 2; ++i) acc[i] = 0.f;
  float sv_c[8 * M], sv_n[8 * M];
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
    for (int q = 0; q < 8 * M; ++q) sv_c[q] = sv_n[q];
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

// ---------------------------------------------------------------------------
// Split adjoint stages 2ᵀ + 1ᵀ (float32 operands): as tc_adj, with h built
// in f32 from f32 Ŝ and f32 φ and written to shared memory as hi and lo
// bf16 planes, T̂ read as its hi and lo planes, and three wgmmas per 16-deep
// step (h_hi·T̂_hi, h_hi·T̂_lo, h_lo·T̂_hi). shat (B, G, Kp, 2M) f32
// unrounded; tab (2, G, Np, 2Kp) bf16 [hi, lo]; phi (M, G, Np, 2Kp) f32.
// grid (B·Np/TC_BM row tiles, ⌈N/AS_BN⌉ column tiles, G slices); TC_THREADS
// threads, as_smem(M) bytes of dynamic shared memory. Each thread copies,
// and alone reads, the φ of its own four h units, so one φ stage suffices:
// chunk i+2's φ is loaded right after chunk i+1's h is built.
// Each chunk's products go to a fresh accumulator that is then added to the
// running sum on the CUDA cores: the tensor cores' f32 accumulation is not
// round-to-nearest, and its error grows with the chain (measured on an
// H100: 2.9e-5 relative over a 138-chunk slice, against 3.5e-6 over 17).
// ---------------------------------------------------------------------------
template <int M>
__device__ __forceinline__ void tc_adj_split(const float* __restrict__ shat,
                                             const __nv_bfloat16* __restrict__ tab,
                                             const float* __restrict__ phi,
                                             const float* __restrict__ sgn,
                                             float* __restrict__ dst, int B, int N, int Np,
                                             int P, int K2p, int G, int transpose) {
  static_assert(M == 1 || M == 2, "one or two members per row group");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sgen = smem_raw + (base - raw);
  const uint32_t h_base = base + AS_T_STAGES * AS_T_BYTES;
  const uint32_t phi_off = AS_T_STAGES * AS_T_BYTES + AS_H_STAGES * AS_H_BYTES;

  const int R = Np / TC_BM;
  const int b = blockIdx.x / R, rt = blockIdx.x % R;
  const int c0 = blockIdx.y * AS_BN;
  const int g = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int Kp = K2p / 2;
  const int nkc = K2p / TC_BK;
  const int i_lo = (int)((long long)P * nkc * g / G);
  const int n = (int)((long long)P * nkc * (g + 1) / G) - i_lo;
  const size_t tsz = (size_t)P * Np * K2p;

  constexpr int UNITS = TC_BM * 8 / TC_THREADS;
  const int j = tid & 7, m0 = tid >> 3;
  // T̂ chunk i: [128 columns c][64] K-major, swizzled, hi then lo
  auto load_t = [&](int i) {
    if (i < n) {
      const int p = (i_lo + i) / nkc, kri0 = (i_lo + i) % nkc * TC_BK;
      const uint32_t ts = base + (i % AS_T_STAGES) * AS_T_BYTES;
      const __nv_bfloat16* T = tab + ((size_t)p * Np + c0) * K2p + kri0;
      for (int e = tid; e < 2 * AS_BN * 8; e += TC_THREADS) {
        const int h = e / (AS_BN * 8), nn = (e >> 3) % AS_BN, jj = e & 7;
        cp_async16(ts + h * (AS_T_BYTES / 2) + swz(nn, jj),
                   T + h * tsz + (size_t)nn * K2p + jj * 8, 16);
      }
    }
    cp_async_commit();  // one group per chunk, empty past the end
  };
  // this thread's φ of chunk i: rows m0 + 32u, frequencies 4j .. 4j+3 of the
  // chunk ((re, im) f32, 32 bytes per member and row)
  auto load_phi = [&](int i) {
    if (i < n) {
      const int p = (i_lo + i) / nkc, kri0 = (i_lo + i) % nkc * TC_BK;
      const float* PH = phi + ((size_t)p * Np + (size_t)rt * TC_BM) * K2p + kri0 + j * 8;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int m = m0 + u * (TC_THREADS / 8);
#pragma unroll
        for (int t = 0; t < M; ++t) {
          const uint32_t d = base + phi_off + t * AS_PHI_BYTES + m * (TC_BK * 4) + j * 32;
          const float* s = PH + t * tsz + (size_t)m * K2p;
          cp_async16(d, s, 16);
          cp_async16(d + 16, s + 4, 16);
        }
      }
    }
    cp_async_commit();
  };
  auto load_shat = [&](int i, float (&sv)[8 * M], float& sg) {
    if (i < n) {
      const int p = (i_lo + i) / nkc, k0 = (i_lo + i) % nkc * (TC_BK / 2);
      const float4* SV = reinterpret_cast<const float4*>(
          shat + (((size_t)b * P + p) * Kp + k0 + j * 4) * (2 * M));
#pragma unroll
      for (int q = 0; q < 2 * M; ++q) {
        const float4 v = __ldg(SV + q);
        sv[4 * q] = v.x;
        sv[4 * q + 1] = v.y;
        sv[4 * q + 2] = v.z;
        sv[4 * q + 3] = v.w;
      }
      sg = M == 2 ? __ldg(sgn + p) : 1.f;
    }
  };
  auto build_h = [&](int i, const float (&sv)[8 * M], float sg) {
    uint8_t* hs = sgen + (h_base - base) + (i % AS_H_STAGES) * AS_H_BYTES;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int m = m0 + u * (TC_THREADS / 8);
      float w[M][8];
#pragma unroll
      for (int t = 0; t < M; ++t) {
        const float4* ps =
            reinterpret_cast<const float4*>(sgen + phi_off + t * AS_PHI_BYTES + m * (TC_BK * 4) + j * 32);
        const float4 a = ps[0], c = ps[1];
        w[t][0] = a.x; w[t][1] = a.y; w[t][2] = a.z; w[t][3] = a.w;
        w[t][4] = c.x; w[t][5] = c.y; w[t][6] = c.z; w[t][7] = c.w;
      }
      uint32_t hv[4], lv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* s = sv + q * (2 * M);
        const float ca = w[0][2 * q], sa = w[0][2 * q + 1];
        float hr = s[0] * ca + s[1] * sa;
        float hi = -(s[0] * sa) + s[1] * ca;
        if (M == 2) {
          const float cb = w[M - 1][2 * q], sb = w[M - 1][2 * q + 1];
          hr = hr + (s[2 * M - 2] * cb + s[2 * M - 1] * sb);
          hi = hi + sg * (-(s[2 * M - 2] * sb) + s[2 * M - 1] * cb);
        }
        f2_split(hr, hi, hv[q], lv[q]);
      }
      *reinterpret_cast<uint4*>(hs + swz(m, j)) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(hs + AS_H_BYTES / 2 + swz(m, j)) =
          make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
  };

  float acc[AS_BN / 2], tot[AS_BN / 2];
#pragma unroll
  for (int i = 0; i < AS_BN / 2; ++i) acc[i] = tot[i] = 0.f;
  float sv_c[8 * M], sv_n[8 * M];
  float sg_c = 0.f, sg_n = 0.f;
  // commit groups, in order: T̂ 0, T̂ 1, φ 0, φ 1, then per iteration i
  // T̂ i+2 and φ i+2
  load_t(0);
  load_t(1);
  load_phi(0);
  load_shat(0, sv_c, sg_c);
  load_shat(1, sv_n, sg_n);
  cp_async_wait_all();
  if (n > 0) build_h(0, sv_c, sg_c);
  load_phi(1);
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int q = 0; q < 8 * M; ++q) sv_c[q] = sv_n[q];
    sg_c = sg_n;
    cp_async_wait<2>();  // all but T̂ i+1 and φ i+1: T̂ i has landed
    fence_proxy_async();
    __syncthreads();  // h and T̂ of chunk i in shared memory; chunk i-1's products done
    load_t(i + 2);    // into the stage chunk i-1 used
    load_shat(i + 2, sv_n, sg_n);
    const uint32_t sa = h_base + (i % AS_H_STAGES) * AS_H_BYTES + wg * (64 * 128);
    const uint32_t sb = base + (i % AS_T_STAGES) * AS_T_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      const uint64_t ah = desc_sw128(sa + ks * 32, 16, 1024);
      const uint64_t al = desc_sw128(sa + AS_H_BYTES / 2 + ks * 32, 16, 1024);
      const uint64_t bh = desc_sw128(sb + ks * 32, 16, 1024);
      const uint64_t bl = desc_sw128(sb + AS_T_BYTES / 2 + ks * 32, 16, 1024);
      wgmma_n128<0>(acc, ah, bh);
      wgmma_n128<0>(acc, ah, bl);
      wgmma_n128<0>(acc, al, bh);
    }
    wgmma_commit();
    if (i + 1 < n) {  // overlaps the products of chunk i
      cp_async_wait<1>();  // all but T̂ i+2: this thread's φ i+1 has landed
      build_h(i + 1, sv_c, sg_c);
    }
    load_phi(i + 2);  // this thread's reads of φ i+1 are done
    wgmma_wait0();
    fence_acc(acc);
#pragma unroll
    for (int q = 0; q < AS_BN / 2; ++q) {
      tot[q] += acc[q];
      acc[q] = 0.f;
    }
  }

  float* ob = dst + ((size_t)g * B + b) * N * N;
  const int r1 = rt * TC_BM + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int jj = 0; jj < AS_BN / 8; ++jj) {
    const int c = c0 + jj * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r1 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c + e;
        if (r < N && cc < N)
          ob[transpose ? (size_t)cc * N + r : (size_t)r * N + cc] = tot[4 * jj + 2 * h + e];
      }
    }
  }
}

// C[r, c] = Σ_d A[r, d] B(d, c), one 128 x 128 tile per block: A (Mp x
// 64·nk) bf16 row-major, Mp = 128·⌈M/128⌉ rows, zero-padded; B MN-major
// (64·nk rows of ldb ≥ 128·⌈N/128⌉ columns) or, for KMAJOR_B, K-major
// (≥ 128·⌈N/128⌉ rows of ldb ≥ 64·nk); C (M x N) f32, rows ldc apart,
// rounded to bf16 values when round_out. grid (⌈N/128⌉, Mp/128);
// TC_THREADS threads; FW_SMEM bytes of dynamic shared memory.
template <bool KMAJOR_B>
__device__ __forceinline__ void tc_gemm(const __nv_bfloat16* __restrict__ A, int lda,
                                        const __nv_bfloat16* __restrict__ Bm, int ldb,
                                        float* __restrict__ C, int ldc, int M, int N, int nk,
                                        int round_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int n0 = blockIdx.x * FW_BN, m0 = blockIdx.y * TC_BM;
  float acc[FW_BN / 2];
  mma_tile_128<KMAJOR_B>(acc, A + (size_t)m0 * lda, lda, Bm, ldb, n0, nk, base, [] {});
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r1 = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < FW_BN / 8; ++j) {
    const int c = n0 + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r1 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = acc[4 * j + 2 * h + e];
        if (r < M && c + e < N) C[(size_t)r * ldc + c + e] = round_out ? rnd(v) : v;
      }
    }
  }
}

// dst (Mp x cols_p) bf16 = Σ_t src[t] (t < R, in order) rounded, from src
// (R, rows, cols) f32; zero for rows ≥ rows or columns ≥ cols. Grid-stride.
__device__ __forceinline__ void tc_sum_round_pad(const float* __restrict__ src, int R,
                                                 int rows, int cols,
                                                 __nv_bfloat16* __restrict__ dst, int Mp,
                                                 int cols_p) {
  const size_t n = (size_t)Mp * cols_p, plane = (size_t)rows * cols;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / cols_p), c = (int)(i % cols_p);
    float v = 0.f;
    if (r < rows && c < cols) {
      const float* s = src + (size_t)r * cols + c;
      for (int t = 0; t < R; ++t) v += s[t * plane];
    }
    dst[i] = __float2bfloat16_rn(v);
  }
}

// wb (K2p x Sp) bf16: row 2k = Wc[k], row 2k + 1 = −Ws[k] for k < K and
// columns s < S, zero elsewhere: stage 3's two real products as one over the
// interleaved (k, re/im) depth of Ŝ. Grid-stride.
__device__ __forceinline__ void tc_w_prep(const float* __restrict__ Wc,
                                          const float* __restrict__ Ws,
                                          __nv_bfloat16* __restrict__ wb, int K, int S, int K2p,
                                          int Sp) {
  const size_t n = (size_t)K2p * Sp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(i / Sp), s = (int)(i % Sp), k = row >> 1;
    float v = 0.f;
    if (k < K && s < S) v = (row & 1) ? -Ws[(size_t)k * S + s] : Wc[(size_t)k * S + s];
    wb[i] = __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------------------
// Stages 3 and 3ᵀ on the CUDA cores, for both pair routes (M = 2) and the
// per-angle split route (M = 1): ROUND rounds Ŝ, W and p to bf16 where the
// plain version does (the pair bf16 route); without it everything stays
// f32 (the split routes).
// ---------------------------------------------------------------------------
constexpr int ST_ROWS = 8;       // rows per stage-3 / 3ᵀ block
constexpr int ST3T_TK = 32;      // frequencies per stage-3ᵀ block (4 per warp)
constexpr int ST3_COLS = 64;     // output columns per stage-3 block, two per thread
constexpr int ST3_SPLIT = ST_THREADS / (ST3_COLS / 2);  // ways its k loop is split

template <bool ROUND>
__device__ __forceinline__ float rnd_if(float x) {
  return ROUND ? rnd(x) : x;
}

// Forward stage 3: Ŝ = Σ_rt part[rt] (row-tile order), rounded for ROUND;
// then out[row, s] = Σ_k Re Ŝ Wc[k, s] − Im Ŝ Ws[k, s] for ST_ROWS rows
// and ST3_COLS columns per block. tc_fwd's part (R, B, P, M, K, 2) is read
// as (R, rows, K, 2) with row = (b·P + p)·M + m, the output row, so one
// body serves any M. Ŝ sits in shared memory as [k][row][re, im], so one
// 16-byte read serves two rows; each thread owns two columns, and the k loop
// is split ST3_SPLIT ways across the block (partial sums added in a fixed
// order).
// grid (ceil(rows/ST_ROWS), ceil(S/ST3_COLS)); ST_THREADS threads;
// ST_ROWS·(2K + ST3_SPLIT·ST3_COLS) floats of dynamic shared memory.
template <bool ROUND>
__device__ __forceinline__ void pair_stage3(const float* __restrict__ part,
                                            const float* __restrict__ Wc,
                                            const float* __restrict__ Ws,
                                            float* __restrict__ out, int rows, int K, int S,
                                            int R) {
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
    s_s[((kk >> 1) * ST_ROWS + r) * 2 + (kk & 1)] = rnd_if<ROUND>(v);
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
      const float wc0 = rnd_if<ROUND>(wc[0]), ws0 = rnd_if<ROUND>(ws[0]);
      const float wc1 = two ? rnd_if<ROUND>(wc[1]) : 0.f;
      const float ws1 = two ? rnd_if<ROUND>(ws[1]) : 0.f;
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
// p (rounded for ROUND) with member b masked by msk (M = 2; msk is not read
// for M = 1), Ŝ rounded for ROUND. One warp per k, lanes over s (coalesced
// W). Rows row = (b·P + p)·M + m of p (B, M·P, S); shat (B, P, Kp, 2M) =
// M·[re, im] (M = 2: [re_a, im_a, re_b, im_b]), zero for k ≥ K; the layout
// tc_adj_split<M> reads. grid (ceil(rows/ST_ROWS), ceil(Kp/ST3T_TK));
// ST_THREADS threads; ST_ROWS·S floats of dynamic shared memory.
template <int M, bool ROUND>
__device__ __forceinline__ void pair_stage3t(const float* __restrict__ p,
                                             const float* __restrict__ msk,
                                             const float* __restrict__ Wc,
                                             const float* __restrict__ Ws,
                                             float* __restrict__ shat, int rows, int P, int K,
                                             int Kp, int S) {
  static_assert(M == 1 || M == 2, "one or two members per row group");
  extern __shared__ float4 smem4[];
  float* p_s = reinterpret_cast<float*>(smem4);  // [ST_ROWS][S]
  const int row0 = blockIdx.x * ST_ROWS;
  const int nr = min(ST_ROWS, rows - row0);
#pragma unroll 4
  for (int e = threadIdx.x; e < ST_ROWS * S; e += ST_THREADS) {
    const int r = e / S, row = row0 + r;
    float v = 0.f;
    if (r < nr) {
      v = rnd_if<ROUND>(p[(size_t)row * S + e % S]);
      if (M == 2 && (row & 1)) v *= msk[(row >> 1) % P];
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
        const float wc = rnd_if<ROUND>(w_c[s]), ws = rnd_if<ROUND>(w_s[s]);
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
      // (row >> (M − 1), row & (M − 1)): (row group, member)
      float* dst = shat + ((size_t)(row >> (M - 1)) * Kp + k) * (2 * M) + 2 * (row & (M - 1));
      dst[0] = rnd_if<ROUND>(vr);
      dst[1] = rnd_if<ROUND>(-vi);
    }
  }
}

// out[i] = Σ_g part[g][i], g in order. n = B·N·N. ST_THREADS threads.
__device__ __forceinline__ void tc_reduce(const float* __restrict__ part,
                                          float* __restrict__ out, size_t n, int G) {
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
