// Mirror-pair parallel-beam projector kernels on Hopper's tensor cores
// (sm_90a, bf16 operands): the route that project_pair_group /
// backproject_pair_group take for cdt = bfloat16 on a CUDA tensor. The
// float32 route runs the split-bf16 kernels of radon_pair_split.cu.
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
// The function: per pair p of one group,
//   ĝ[r, k]  = Σ_c F[r, c] T̂_p[c, k]                       (stage 1)
//   Ŝ_m[k]   = Σ_r ĝ_m[r, k] φ_m[p, r, k], ĝ_b = (gr, sgn·gi) (stage 2)
//   out[2p+m, s] = Σ_k Re Ŝ_m Wc[k, s] − Im Ŝ_m Ws[k, s]      (stage 3)
// and its exact transpose. Rounding points are the plain version's: F (or
// p), T̂, φ, W and Ŝ (or h) are rounded to bf16, every sum is f32. That is
// the contract of wgmma with f32 accumulators, so the products run there.
//
// What bounds a mirror-pair kernel on an H100's CUDA cores in bf16, and
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
//    chosen by the wrapper (pair_adjoint_splits) so that one wave of one
//    block per SM is in flight, each slice writing a partial image that
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
// The forward and adjoint designs (stage 2 in the forward's f32 epilogue,
// h built in swizzled shared memory while the adjoint's products run, the
// G-slice depth split) are those of radon_tc.cuh, instantiated here with
// M = 2 members per pair: member b reuses ĝ with Im scaled by sgn, and
// unpaired rows (msk = 0) contribute zero: their p rows are zeroed before
// stage 3ᵀ. Padded rows, columns and frequencies are zero in the tables.

#include "radon_tc.cuh"

namespace {

__global__ void __launch_bounds__(256)
pair_tables(const float* __restrict__ pos, const float* __restrict__ sha,
            const float* __restrict__ shb, const float* __restrict__ spec,
            uint32_t* __restrict__ tab, int P, int N, int Np, int K, int Kp,
            float kscale) {
  tc_tables<2>(pos, sha, shb, spec, tab, P, N, Np, K, Kp, kscale);
}

__global__ void __launch_bounds__(256)
pair_tc_prep(const float* __restrict__ f, __nv_bfloat16* __restrict__ fb, int N, int Np,
             int transpose) {
  tc_prep(f, fb, N, Np, transpose);
}

__global__ void __launch_bounds__(TC_THREADS, 2)
pair_tc_fwd(const __nv_bfloat16* __restrict__ fb, const __nv_bfloat16* __restrict__ tab,
            const float* __restrict__ sgn, float* __restrict__ part,
            int B, int Np, int P, int K, int K2p) {
  tc_fwd<2>(fb, tab, sgn, part, B, Np, P, K, K2p);
}

// Forward stage 3 and adjoint stage 3ᵀ with bf16 rounding (radon_tc.cuh).
__global__ void __launch_bounds__(ST_THREADS)
pair_tc_fwd_stage3(const float* __restrict__ part, const float* __restrict__ Wc,
                   const float* __restrict__ Ws, float* __restrict__ out,
                   int rows, int K, int S, int R) {
  pair_stage3<true>(part, Wc, Ws, out, rows, K, S, R);
}

__global__ void __launch_bounds__(ST_THREADS)
pair_tc_adj_stage3t(const float* __restrict__ p, const float* __restrict__ msk,
                    const float* __restrict__ Wc, const float* __restrict__ Ws,
                    float* __restrict__ shat4, int rows, int P, int K, int Kp, int S) {
  pair_stage3t<2, true>(p, msk, Wc, Ws, shat4, rows, P, K, Kp, S);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
pair_tc_adj(const float* __restrict__ shat4, const __nv_bfloat16* __restrict__ tab,
            const float* __restrict__ sgn, float* __restrict__ dst,
            int B, int N, int Np, int P, int K2p, int G, int transpose) {
  tc_adj<2>(shat4, tab, sgn, dst, B, N, Np, P, K2p, G, transpose);
}

__global__ void __launch_bounds__(ST_THREADS)
pair_tc_reduce(const float* __restrict__ part, float* __restrict__ out, size_t n, int G) {
  tc_reduce(part, out, n, G);
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
  err = set_smem((const void*)pair_tc_adj, ad_smem(2));
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_tc_adj<<<dim3(B * (Np / TC_BM), ceil_div(N, AD_BN), G), TC_THREADS, ad_smem(2), st>>>(
      shat4, static_cast<const __nv_bfloat16*>(tab), sgn, G > 1 ? part : out, B, N, Np, P,
      K2p, G, !contract_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * N * N;
  pair_tc_reduce<<<grid_for(n), ST_THREADS, 0, st>>>(part, out, n, G);
  return static_cast<int>(cudaGetLastError());
}
