// Per-angle parallel-beam projector kernels for float32 operands on
// Hopper's tensor cores (sm_90a): the split-bf16 route that project_group /
// backproject_group take for cdt = float32 on a CUDA tensor (the radial
// path's synthesis A and DCF adjoint, and every f32 A and A† on a plan whose
// angles do not pair).
//
// Replaces the float32 instantiation of the Pallas TPU kernels in
// pdunet_tpu/ops/radon/pallas_kernels.py:
//   radon_group_split_project     <- project_group_pallas     (body _fwd_kernel)
//   radon_group_split_backproject <- backproject_group_pallas (body _adj_kernel)
//   radon_group_split_tables      <- the trig both bodies make per grid step (_angle_tensors)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/cuda_kernels.py
// (_project_group / _backproject_group; _group_split_tables for the tables,
// _group_forward_tc / _group_adjoint_tc with split tables for this file's
// arithmetic and order).
//
// The function is radon_group_tc.cu's (per angle a: ĝ = F·T̂_a,
// Ŝ = Σ_r ĝ·φ_a, out = Re Ŝ·Wc − Im Ŝ·Ws, and its exact transpose) to the
// f32 contract (1e-5 relative). It is radon_pair_split.cu's split machinery with one
// member per row group (M = 1: no sgn, no msk), as radon_group_tc.cu is the
// one-member instantiation of the bf16 route: stage 1 and 1ᵀ as three bf16
// wgmma products per 16-deep step (hi·hi, hi·lo, lo·hi of operands split as
// hi = bf16(x), lo = bf16(x − hi)) into f32 accumulators; φ, Ŝ, h and stages
// 2-3 in f32. K and S come from the caller (Wc's shape): the radial
// fourier-slice plan has K = L/2 and a ±1 selection for W, and stage 3
// stays the dense product.
//
// What bounds a per-angle kernel on an H100's CUDA cores in f32, and what
// this design does about it:
//  * FP32 CUDA-core products (≈ 20-25 TFLOP/s, under a third of the FP32
//    peak: the forward's 4x2 register tile is paced by shared-memory loads).
//    Stage 1 and 1ᵀ run on the tensor cores as the split products above.
//  * Trig regenerated per tile and image (the adjoint remakes h and T̂ with
//    precise sincosf for every 32-wide K chunk). It comes from per-plan
//    tables built once on the card by group_split_tables with the plain
//    builder's argument rounding and precise sincosf: T̂ as hi and lo bf16
//    planes, φ in f32 (it feeds stages 2 and 2ᵀ on the CUDA cores).
//  * The adjoint's angle loop over 64x64 output tiles. Its output tiles are
//    128 x 128 (the hi + lo T̂ and h and the f32 φ fill shared memory at 128
//    columns), and its depth, the angles' 64-deep chunks of (k, re/im), is
//    split into G slices (group_adjoint_splits with 128-column tiles) so
//    that one full wave of one block per SM runs; group_split_reduce sums
//    the slices' partial images in a fixed order. Each chunk's products go
//    to a fresh accumulator, added to an f32 sum on the CUDA cores (the
//    tensor cores' accumulation is not round-to-nearest; radon_tc.cuh).
// What bounds this file's kernels: L2-to-SM reads of table and image tiles,
// as in radon_group_tc.cu and twice its bytes per product (hi and lo, f32
// φ). At the pdunet_radial shape (B' = 8, N = 256, A = 64, K = 256,
// S = 1024) a forward block reads 320 KB (F hi + lo 128 KB, T̂ hi + lo
// 128 KB, f32 φ 64 KB) for 25 MFLOP of wgmma, 4,096 blocks per call; an
// adjoint chunk of a 128 x 128 tile 64 KB (T̂ hi + lo, f32 φ) for 6.3 MFLOP,
// 32 tiles x 512 chunks per call.
// Stages 3 and 3ᵀ stay f32 on the CUDA cores (radon_tc.cuh pair_stage3 /
// pair_stage3t<1> without rounding; ≈ 0.54 GFLOP per call at B' = 8, 1.5%
// of the FLOPs).

#include "radon_tc.cuh"

namespace {

__global__ void __launch_bounds__(256)
group_split_tables(const float* __restrict__ pos, const float* __restrict__ shift,
                   const float* __restrict__ spec, uint32_t* __restrict__ T,
                   float2* __restrict__ phi, int A, int N, int Np, int K, int Kp, float kscale) {
  tc_split_tables<1>(pos, shift, nullptr, spec, T, phi, A, N, Np, K, Kp, kscale);
}

__global__ void __launch_bounds__(256)
group_split_prep(const float* __restrict__ f, __nv_bfloat16* __restrict__ fb,
                 __nv_bfloat16* __restrict__ fb_lo, int N, int Np, int transpose) {
  tc_prep(f, fb, N, Np, transpose, fb_lo);
}

// FW_SPLIT_SMEM (193 KB) of shared memory: one block per SM
__global__ void __launch_bounds__(TC_THREADS, 1)
group_split_fwd(const __nv_bfloat16* __restrict__ fb, const __nv_bfloat16* __restrict__ T,
                const float* __restrict__ phi, float* __restrict__ part, int B, int Np, int A,
                int K, int K2p) {
  tc_fwd<1, true>(fb, T, nullptr, part, B, Np, A, K, K2p, phi);
}

// part (R, B, A, 1, K, 2) is (R, rows, K, 2) with rows = B·A: the pair body
// as it is
__global__ void __launch_bounds__(ST_THREADS)
group_split_fwd_stage3(const float* __restrict__ part, const float* __restrict__ Wc,
                       const float* __restrict__ Ws, float* __restrict__ out, int rows, int K,
                       int S, int R) {
  pair_stage3<false>(part, Wc, Ws, out, rows, K, S, R);
}

__global__ void __launch_bounds__(ST_THREADS)
group_split_adj_stage3t(const float* __restrict__ p, const float* __restrict__ Wc,
                        const float* __restrict__ Ws, float* __restrict__ shat, int rows, int A,
                        int K, int Kp, int S) {
  pair_stage3t<1, false>(p, nullptr, Wc, Ws, shat, rows, A, K, Kp, S);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
group_split_adj(const float* __restrict__ shat, const __nv_bfloat16* __restrict__ T,
                const float* __restrict__ phi, float* __restrict__ dst, int B, int N, int Np,
                int A, int K2p, int G, int transpose) {
  tc_adj_split<1>(shat, T, phi, nullptr, dst, B, N, Np, A, K2p, G, transpose);
}

__global__ void __launch_bounds__(ST_THREADS)
group_split_reduce(const float* __restrict__ part, float* __restrict__ out, size_t n, int G) {
  tc_reduce(part, out, n, G);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers to
// contiguous arrays: float32, except T (bf16, 16-byte aligned) and fb (bf16
// scratch); phi is float32 and 16-byte aligned. The stream is a
// cudaStream_t. Each returns the cudaError_t of its launches (0 on
// success); nothing here synchronises or allocates. Np = 128·⌈N/128⌉, Kp
// with 2Kp = 128·⌈2K/128⌉.

// T (2, A, Np, 2Kp) bf16 [T̂ hi, T̂ lo] and phi (1, A, Np, 2Kp) f32 from the
// group's pos / shift rows (A, N).
extern "C" int radon_group_split_tables(const float* pos, const float* shift, const float* spec,
                                        void* T, float* phi, int A, int N, int Np, int K,
                                        int Kp, float kscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  group_split_tables<<<grid_for((size_t)2 * A * Np * Kp), 256, 0, st>>>(
      pos, shift, spec, static_cast<uint32_t*>(T), reinterpret_cast<float2*>(phi), A, N, Np, K,
      Kp, kscale);
  return static_cast<int>(cudaGetLastError());
}

// f (B, N, N) -> out (B, A, S). Scratch: fb (2, B, Np, Np) bf16 (F hi, F
// lo), part (Np/128, B, A, K, 2) float32.
extern "C" int radon_group_split_project(const float* f, const void* T, const float* phi,
                                         const float* Wc, const float* Ws, void* fb,
                                         float* part, float* out, int B, int N, int Np, int A,
                                         int K, int Kp, int S, int contract_x, void* stream) {
  const int K2p = 2 * Kp;
  if (Np % TC_BM || Np < N || K2p % FW_BN || Kp < K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* fbh = static_cast<__nv_bfloat16*>(fb);
  group_split_prep<<<dim3(Np / 32, Np / 32, B), dim3(32, 8), 0, st>>>(
      f, fbh, fbh + (size_t)B * Np * Np, N, Np, !contract_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)group_split_fwd, FW_SPLIT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_split_fwd<<<dim3((K2p / FW_BN) * A, B * (Np / TC_BM)), TC_THREADS, FW_SPLIT_SMEM, st>>>(
      fbh, static_cast<const __nv_bfloat16*>(T), phi, part, B, Np, A, K, K2p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * A;
  const size_t smem3 = (size_t)ST_ROWS * (2 * K + ST3_SPLIT * ST3_COLS) * sizeof(float);
  err = set_smem((const void*)group_split_fwd_stage3, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_split_fwd_stage3<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(S, ST3_COLS)), ST_THREADS,
                           smem3, st>>>(part, Wc, Ws, out, rows, K, S, Np / TC_BM);
  return static_cast<int>(cudaGetLastError());
}

// p (B, A, S) -> out (B, N, N), the y group (contract_x = 0) transposed.
// Scratch: shat (B, A, Kp, 2) float32 and, when G > 1, part (G, B, N, N)
// float32.
extern "C" int radon_group_split_backproject(const float* p, const void* T, const float* phi,
                                             const float* Wc, const float* Ws, float* shat,
                                             float* part, float* out, int B, int N, int Np,
                                             int A, int K, int Kp, int S, int G,
                                             int contract_x, void* stream) {
  const int K2p = 2 * Kp;
  if (Np % TC_BM || Np < N || K2p % TC_BK || Kp < K || G < 1 || G > A * (K2p / TC_BK) ||
      (G > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * A;
  const size_t smem3 = (size_t)ST_ROWS * S * sizeof(float);
  cudaError_t err = set_smem((const void*)group_split_adj_stage3t, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_split_adj_stage3t<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(Kp, ST3T_TK)), ST_THREADS,
                            smem3, st>>>(p, Wc, Ws, shat, rows, A, K, Kp, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)group_split_adj, as_smem(1));
  if (err != cudaSuccess) return static_cast<int>(err);
  group_split_adj<<<dim3(B * (Np / TC_BM), ceil_div(N, AS_BN), G), TC_THREADS, as_smem(1),
                    st>>>(shat, static_cast<const __nv_bfloat16*>(T), phi,
                          G > 1 ? part : out, B, N, Np, A, K2p, G, !contract_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * N * N;
  group_split_reduce<<<grid_for(n), ST_THREADS, 0, st>>>(part, out, n, G);
  return static_cast<int>(cudaGetLastError());
}
