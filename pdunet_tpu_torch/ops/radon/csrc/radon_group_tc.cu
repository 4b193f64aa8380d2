// Per-angle parallel-beam projector kernels on Hopper's tensor cores
// (sm_90a, bf16 operands): the route that project_group / backproject_group
// take for cdt = bfloat16 on a CUDA tensor. The float32 route runs the
// split-bf16 kernels of radon_group_split.cu.
//
// Replaces the bf16 instantiation of the Pallas TPU kernels in
// pdunet_tpu/ops/radon/pallas_kernels.py:
//   radon_group_tc_project     <- project_group_pallas     (body _fwd_kernel)
//   radon_group_tc_backproject <- backproject_group_pallas (body _adj_kernel)
//   radon_group_tc_tables      <- the trig both bodies make per grid step (_angle_tensors)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/cuda_kernels.py
// (_project_group / _backproject_group; _group_tables for the tables,
// _group_forward_tc / _group_adjoint_tc for this file's tiling).
//
// The function (per angle a: ĝ = F·T̂_a, Ŝ = Σ_r ĝ·φ_a,
// out = Re Ŝ·Wc − Im Ŝ·Ws, and its exact transpose) is the mirror-pair
// function of radon_pair_tc.cu with one member, no sgn and no msk. So the
// kernels are radon_tc.cuh's, instantiated with M = 1 member per row group
// (one angle), from per-plan tables (2, A, Np, 2Kp) bf16 — T̂, φ — with
// (re, im) interleaved along the frequency axis. K and S come from the
// caller (Wc's shape): the radial fourier-slice plan has K = L/2 and a ±1
// selection matrix for W, and stage 3 stays the dense product.
//
// What bounds a per-angle kernel on an H100's CUDA cores in bf16, and what
// this design does about it:
//  * FP32 CUDA-core products (≈ 25 TFLOP/s achieved, 0.82 of the radial
//    recon's device time). Stage 1 and stage 1ᵀ are wgmma bf16 products
//    with f32 accumulators (m64n128k16 forward, m64n256k16 adjoint), operands
//    in 128-byte-swizzled shared memory, staged by cp.async rings.
//  * Trig regenerated per tile and image. It comes from the tables, built
//    once per plan and group on the card by group_tc_tables with the plain
//    builder's argument rounding and precise sincosf.
//  * An angle loop of 64x64 output tiles in the adjoint. Its output tiles
//    are (128 image rows) x (256 image columns); its depth, the angles'
//    64-deep chunks of (k, re/im), is split into G slices
//    (group_adjoint_splits) so that one full wave of one block per SM runs
//    (a second, part-empty wave cost 1.55x at B' = 8); group_tc_reduce sums
//    the slices' partial images in a fixed order.
//  * Stages 3 and 3ᵀ, 1.6% of the FLOPs: on the CUDA cores, once stage 1
//    ran on wgmma, they took 27% / 21% of a call at B' = 8, reading the
//    dense W (256 x 1024 at the radial shape, a ±1 selection there) once per
//    8-row block. Here both are bf16 GEMMs on the tensor cores over the
//    interleaved (k, re/im) depth: out = Ŝ' · W' and Ŝ' = rnd(p) · W'ᵀ, with
//    W' (2Kp x Sp) = rows [Wc[k]; −Ws[k]] built per call by group_tc_w_prep
//    and Ŝ' (the row-tile partials summed in order, then rounded) or rnd(p)
//    padded by group_tc_round: the plain version's rounding points, f32 sums.
// What bounds this file's kernels: the L2-to-SM traffic of the table tiles,
// as in radon_pair_tc.cu. At the pdunet_radial shape (B' = 8, N = 256,
// A = 64, K = 256, S = 1024) a forward block reads 160 KB (F 64 KB, T̂
// 64 KB, φ 32 KB) for 8.4 MFLOP, 4,096 blocks per call; an adjoint chunk
// reads 48 KB (T̂ 32 KB, φ 16 KB) for 4.2 MFLOP, 16 tiles x 512 chunks per
// call.

#include "radon_tc.cuh"

namespace {

__global__ void __launch_bounds__(256)
group_tc_tables(const float* __restrict__ pos, const float* __restrict__ shift,
                const float* __restrict__ spec, uint32_t* __restrict__ tab, int A, int N,
                int Np, int K, int Kp, float kscale) {
  tc_tables<1>(pos, shift, nullptr, spec, tab, A, N, Np, K, Kp, kscale);
}

__global__ void __launch_bounds__(256)
group_tc_prep(const float* __restrict__ f, __nv_bfloat16* __restrict__ fb, int N, int Np,
              int transpose) {
  tc_prep(f, fb, N, Np, transpose);
}

__global__ void __launch_bounds__(TC_THREADS, 2)
group_tc_fwd(const __nv_bfloat16* __restrict__ fb, const __nv_bfloat16* __restrict__ tab,
             float* __restrict__ part, int B, int Np, int A, int K, int K2p) {
  tc_fwd<1>(fb, tab, nullptr, part, B, Np, A, K, K2p);
}

__global__ void __launch_bounds__(ST_THREADS)
group_tc_w_prep(const float* __restrict__ Wc, const float* __restrict__ Ws,
                __nv_bfloat16* __restrict__ wb, int K, int S, int K2p, int Sp) {
  tc_w_prep(Wc, Ws, wb, K, S, K2p, Sp);
}

__global__ void __launch_bounds__(ST_THREADS)
group_tc_round(const float* __restrict__ src, int R, int rows, int cols,
               __nv_bfloat16* __restrict__ dst, int Mp, int cols_p) {
  tc_sum_round_pad(src, R, rows, cols, dst, Mp, cols_p);
}

// forward stage 3: out (rows x S) = Ŝ' (Mp x 2Kp) · W' (2Kp x Sp, MN-major B)
__global__ void __launch_bounds__(TC_THREADS, 2)
group_tc_fwd_stage3(const __nv_bfloat16* __restrict__ sb, const __nv_bfloat16* __restrict__ wb,
                    float* __restrict__ out, int rows, int S, int K2p, int Sp) {
  tc_gemm<false>(sb, K2p, wb, Sp, out, S, rows, S, K2p / TC_BK, 0);
}

// adjoint stage 3ᵀ: Ŝ (rows x 2Kp) = rnd(rnd(p) (Mp x Sp) · W'ᵀ) (W' as a
// K-major B)
__global__ void __launch_bounds__(TC_THREADS, 2)
group_tc_adj_stage3t(const __nv_bfloat16* __restrict__ pb, const __nv_bfloat16* __restrict__ wb,
                     float* __restrict__ shat2, int rows, int K2p, int Sp) {
  tc_gemm<true>(pb, Sp, wb, Sp, shat2, K2p, rows, K2p, Sp / TC_BK, 1);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
group_tc_adj(const float* __restrict__ shat2, const __nv_bfloat16* __restrict__ tab,
             float* __restrict__ dst, int B, int N, int Np, int A, int K2p, int G,
             int transpose) {
  tc_adj<1>(shat2, tab, nullptr, dst, B, N, Np, A, K2p, G, transpose);
}

__global__ void __launch_bounds__(ST_THREADS)
group_tc_reduce(const float* __restrict__ part, float* __restrict__ out, size_t n, int G) {
  tc_reduce(part, out, n, G);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers to
// contiguous arrays: float32, except tab (bf16, 16-byte aligned) and fb
// (bf16 scratch). The stream is a cudaStream_t. Each returns the
// cudaError_t of its launches (0 on success); nothing here synchronises or
// allocates. Np = 128·⌈N/128⌉, Kp with 2Kp = 128·⌈2K/128⌉.

// tab (2, A, Np, 2Kp) bf16, from the group's pos / shift rows (A, N).
extern "C" int radon_group_tc_tables(const float* pos, const float* shift, const float* spec,
                                     void* tab, int A, int N, int Np, int K, int Kp,
                                     float kscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  group_tc_tables<<<grid_for((size_t)2 * A * Np * Kp), 256, 0, st>>>(
      pos, shift, spec, static_cast<uint32_t*>(tab), A, N, Np, K, Kp, kscale);
  return static_cast<int>(cudaGetLastError());
}

// f (B, N, N) -> out (B, A, S). Scratch: fb (B, Np, Np) bf16, part
// (Np/128, B, A, K, 2) float32, sb (Mp, 2Kp) and wb (2Kp, Sp) bf16, with
// Mp = 128·⌈B·A/128⌉ and Sp = 128·⌈S/128⌉.
extern "C" int radon_group_tc_project(const float* f, const void* tab, const float* Wc,
                                      const float* Ws, void* fb, float* part, void* sb,
                                      void* wb, float* out, int B, int N, int Np, int A, int K,
                                      int Kp, int S, int Sp, int contract_x, void* stream) {
  const int K2p = 2 * Kp, rows = B * A, Mp = TC_BM * ceil_div(rows, TC_BM);
  if (Np % TC_BM || Np < N || K2p % FW_BN || Kp < K || Sp % FW_BN || Sp < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* fbh = static_cast<__nv_bfloat16*>(fb);
  __nv_bfloat16* sbh = static_cast<__nv_bfloat16*>(sb);
  __nv_bfloat16* wbh = static_cast<__nv_bfloat16*>(wb);
  group_tc_prep<<<dim3(Np / 32, Np / 32, B), dim3(32, 8), 0, st>>>(f, fbh, N, Np, !contract_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)group_tc_fwd, FW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_tc_fwd<<<dim3((K2p / FW_BN) * A, B * (Np / TC_BM)), TC_THREADS, FW_SMEM, st>>>(
      fbh, static_cast<const __nv_bfloat16*>(tab), part, B, Np, A, K, K2p);
  group_tc_w_prep<<<grid_for((size_t)K2p * Sp), ST_THREADS, 0, st>>>(Wc, Ws, wbh, K, S, K2p, Sp);
  group_tc_round<<<grid_for((size_t)Mp * K2p), ST_THREADS, 0, st>>>(part, Np / TC_BM, rows,
                                                                   2 * K, sbh, Mp, K2p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)group_tc_fwd_stage3, FW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_tc_fwd_stage3<<<dim3(Sp / FW_BN, Mp / TC_BM), TC_THREADS, FW_SMEM, st>>>(
      sbh, wbh, out, rows, S, K2p, Sp);
  return static_cast<int>(cudaGetLastError());
}

// p (B, A, S) -> out (B, N, N), the y group (contract_x = 0) transposed.
// Scratch: pb (Mp, Sp) and wb (2Kp, Sp) bf16, shat2 (B, A, Kp, 2) float32
// and, when G > 1, part (G, B, N, N) float32.
extern "C" int radon_group_tc_backproject(const float* p, const void* tab, const float* Wc,
                                          const float* Ws, void* pb, void* wb, float* shat2,
                                          float* part, float* out, int B, int N, int Np, int A,
                                          int K, int Kp, int S, int Sp, int G, int contract_x,
                                          void* stream) {
  const int K2p = 2 * Kp, rows = B * A, Mp = TC_BM * ceil_div(rows, TC_BM);
  if (Np % TC_BM || Np < N || K2p % FW_BN || Kp < K || Sp % FW_BN || Sp < S || G < 1 ||
      G > A * (K2p / TC_BK) || (G > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* pbh = static_cast<__nv_bfloat16*>(pb);
  __nv_bfloat16* wbh = static_cast<__nv_bfloat16*>(wb);
  group_tc_w_prep<<<grid_for((size_t)K2p * Sp), ST_THREADS, 0, st>>>(Wc, Ws, wbh, K, S, K2p, Sp);
  group_tc_round<<<grid_for((size_t)Mp * Sp), ST_THREADS, 0, st>>>(p, 1, rows, S, pbh, Mp, Sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)group_tc_adj_stage3t, FW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_tc_adj_stage3t<<<dim3(K2p / FW_BN, Mp / TC_BM), TC_THREADS, FW_SMEM, st>>>(
      pbh, wbh, shat2, rows, K2p, Sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)group_tc_adj, ad_smem(1));
  if (err != cudaSuccess) return static_cast<int>(err);
  group_tc_adj<<<dim3(B * (Np / TC_BM), ceil_div(N, AD_BN), G), TC_THREADS, ad_smem(1), st>>>(
      shat2, static_cast<const __nv_bfloat16*>(tab), G > 1 ? part : out, B, N, Np, A, K2p, G,
      !contract_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * N * N;
  group_tc_reduce<<<grid_for(n), ST_THREADS, 0, st>>>(part, out, n, G);
  return static_cast<int>(cudaGetLastError());
}
