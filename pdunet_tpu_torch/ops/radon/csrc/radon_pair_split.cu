// Mirror-pair parallel-beam projector kernels for float32 operands on
// Hopper's tensor cores (sm_90a): the split-bf16 route that
// project_pair_group / backproject_pair_group take for cdt = float32 on a
// CUDA tensor (the synthesis A and the FBP's A† of the serving path).
//
// Replaces the float32 instantiation of the Pallas TPU kernels in
// pdunet_tpu/ops/radon/pallas_kernels.py:
//   radon_pair_split_project     <- project_pair_group_pallas     (body _fwd_pair_kernel)
//   radon_pair_split_backproject <- backproject_pair_group_pallas (body _adj_pair_kernel)
//   radon_pair_split_tables      <- the trig both bodies make per grid step (_pair_tensors)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/cuda_kernels.py
// (_project_pair_group / _backproject_pair_group; _pair_split_tables for the
// tables, _pair_forward_tc / _pair_adjoint_tc with split tables for this
// file's arithmetic and order).
//
// The function is radon_pair_tc.cu's with f32 operands and no rounding:
// stage 1 ĝ = F·T̂, stage 2 Ŝ_m = Σ_r ĝ·φ_m, stage 3 p = Ŝ_re·Wc − Ŝ_im·Ws,
// and its exact transpose, to the f32 contract (1e-5 relative).
//
// What bounds a mirror-pair kernel on an H100's CUDA cores in f32, and
// what this design does about it:
//  * FP32 CUDA-core products: the forward's 4x2 register tile is paced by
//    shared-memory loads (≈ 16 TFLOP/s, 24% of the FP32 peak). One bf16 or
//    TF32 product keeps too few digits for 1e-5, so stage 1 and 1ᵀ run as
//    three bf16 wgmma products per 16-deep step (hi·hi, hi·lo, lo·hi of
//    operands split as hi = bf16(x), lo = bf16(x − hi)) into f32
//    accumulators: ≈ 2⁻¹⁷ relative per term, 330 TFLOP/s of effective rate.
//  * The adjoint's 64-block grid at batch 4 and its three precise sincosf
//    per staged element. Trig comes from per-plan tables built once on the
//    card (T̂ as hi and lo bf16 planes, φ_a and φ_b in f32: φ feeds stages 2
//    and 2ᵀ on the CUDA cores, so it is never split); the adjoint's depth is
//    split into slices that fill one wave (pair_adjoint_splits with 128-column
//    tiles), summed in a fixed order by pair_split_reduce.
// What bounds this file's kernels: L2-to-SM reads of table and image tiles,
// twice the bf16 route's per product (hi and lo, f32 φ): a forward block
// reads 384 KB (F, T̂ hi + lo; two f32 φ tiles) for 25 MFLOP of wgmma, an
// adjoint chunk of a 128 x 128 tile 96 KB (T̂ hi + lo, f32 φ) for 6.3 MFLOP.
// Stages 3 and 3ᵀ stay f32 on the CUDA cores (radon_tc.cuh pair_stage3 /
// pair_stage3t without rounding; ≈ 34 MFLOP per call at batch 4).
//
// The bodies (tc_fwd<2, true>, tc_adj_split<2>, tc_split_tables<2>) are in
// radon_tc.cuh; member b reuses ĝ with Im scaled by sgn, and unpaired rows
// (msk = 0) contribute zero. Padded rows, columns and frequencies are zero.

#include "radon_tc.cuh"

namespace {

__global__ void __launch_bounds__(256)
pair_split_tables(const float* __restrict__ pos, const float* __restrict__ sha,
                  const float* __restrict__ shb, const float* __restrict__ spec,
                  uint32_t* __restrict__ T, float2* __restrict__ phi, int P, int N, int Np,
                  int K, int Kp, float kscale) {
  tc_split_tables<2>(pos, sha, shb, spec, T, phi, P, N, Np, K, Kp, kscale);
}

__global__ void __launch_bounds__(256)
pair_split_prep(const float* __restrict__ f, __nv_bfloat16* __restrict__ fb,
                __nv_bfloat16* __restrict__ fb_lo, int N, int Np, int transpose) {
  tc_prep(f, fb, N, Np, transpose, fb_lo);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
pair_split_fwd(const __nv_bfloat16* __restrict__ fb, const __nv_bfloat16* __restrict__ T,
               const float* __restrict__ phi, const float* __restrict__ sgn,
               float* __restrict__ part, int B, int Np, int P, int K, int K2p) {
  tc_fwd<2, true>(fb, T, sgn, part, B, Np, P, K, K2p, phi);
}

__global__ void __launch_bounds__(ST_THREADS)
pair_split_fwd_stage3(const float* __restrict__ part, const float* __restrict__ Wc,
                      const float* __restrict__ Ws, float* __restrict__ out,
                      int rows, int K, int S, int R) {
  pair_stage3<false>(part, Wc, Ws, out, rows, K, S, R);
}

__global__ void __launch_bounds__(ST_THREADS)
pair_split_adj_stage3t(const float* __restrict__ p, const float* __restrict__ msk,
                       const float* __restrict__ Wc, const float* __restrict__ Ws,
                       float* __restrict__ shat4, int rows, int P, int K, int Kp, int S) {
  pair_stage3t<2, false>(p, msk, Wc, Ws, shat4, rows, P, K, Kp, S);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
pair_split_adj(const float* __restrict__ shat4, const __nv_bfloat16* __restrict__ T,
               const float* __restrict__ phi, const float* __restrict__ sgn,
               float* __restrict__ dst, int B, int N, int Np, int P, int K2p, int G,
               int transpose) {
  tc_adj_split<2>(shat4, T, phi, sgn, dst, B, N, Np, P, K2p, G, transpose);
}

__global__ void __launch_bounds__(ST_THREADS)
pair_split_reduce(const float* __restrict__ part, float* __restrict__ out, size_t n, int G) {
  tc_reduce(part, out, n, G);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers to
// contiguous arrays: float32, except T (bf16, 16-byte aligned) and fb (bf16
// scratch); phi is float32 and 16-byte aligned. The stream is a
// cudaStream_t. Each returns the cudaError_t of its launches (0 on
// success); nothing here synchronises or allocates. Np = 128·⌈N/128⌉, Kp
// with 2Kp = 128·⌈2K/128⌉.

// T (2, P, Np, 2Kp) bf16 [T̂ hi, T̂ lo] and phi (2, P, Np, 2Kp) f32 [φ_a, φ_b]
// from the group's pos / sha / shb rows (P, N).
extern "C" int radon_pair_split_tables(const float* pos, const float* sha, const float* shb,
                                       const float* spec, void* T, float* phi, int P, int N,
                                       int Np, int K, int Kp, float kscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pair_split_tables<<<grid_for((size_t)3 * P * Np * Kp), 256, 0, st>>>(
      pos, sha, shb, spec, static_cast<uint32_t*>(T), reinterpret_cast<float2*>(phi), P, N,
      Np, K, Kp, kscale);
  return static_cast<int>(cudaGetLastError());
}

// f (B, N, N) -> out (B, 2P, S). Scratch: fb (2, B, Np, Np) bf16 (F hi, F
// lo), part (Np/128, B, 2P, K, 2) float32.
extern "C" int radon_pair_split_project(const float* f, const void* T, const float* phi,
                                        const float* sgn, const float* Wc, const float* Ws,
                                        void* fb, float* part, float* out, int B, int N, int Np,
                                        int P, int K, int Kp, int S, int contract_x,
                                        void* stream) {
  const int K2p = 2 * Kp;
  if (Np % TC_BM || Np < N || K2p % FW_BN || Kp < K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* fbh = static_cast<__nv_bfloat16*>(fb);
  pair_split_prep<<<dim3(Np / 32, Np / 32, B), dim3(32, 8), 0, st>>>(
      f, fbh, fbh + (size_t)B * Np * Np, N, Np, !contract_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)pair_split_fwd, FW_SPLIT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_split_fwd<<<dim3((K2p / FW_BN) * P, B * (Np / TC_BM)), TC_THREADS, FW_SPLIT_SMEM, st>>>(
      fbh, static_cast<const __nv_bfloat16*>(T), phi, sgn, part, B, Np, P, K, K2p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * 2 * P;
  const size_t smem3 = (size_t)ST_ROWS * (2 * K + ST3_SPLIT * ST3_COLS) * sizeof(float);
  err = set_smem((const void*)pair_split_fwd_stage3, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_split_fwd_stage3<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(S, ST3_COLS)), ST_THREADS,
                          smem3, st>>>(part, Wc, Ws, out, rows, K, S, Np / TC_BM);
  return static_cast<int>(cudaGetLastError());
}

// p (B, 2P, S) -> out (B, N, N). Scratch: shat4 (B, P, Kp, 4) float32 and,
// when G > 1, part (G, B, N, N) float32.
extern "C" int radon_pair_split_backproject(const float* p, const void* T, const float* phi,
                                            const float* sgn, const float* msk, const float* Wc,
                                            const float* Ws, float* shat4, float* part,
                                            float* out, int B, int N, int Np, int P, int K,
                                            int Kp, int S, int G, int contract_x,
                                            void* stream) {
  const int K2p = 2 * Kp;
  if (Np % TC_BM || Np < N || K2p % TC_BK || Kp < K || G < 1 || G > P * (K2p / TC_BK) ||
      (G > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * 2 * P;
  const size_t smem3 = (size_t)ST_ROWS * S * sizeof(float);
  cudaError_t err = set_smem((const void*)pair_split_adj_stage3t, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_split_adj_stage3t<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(Kp, ST3T_TK)), ST_THREADS,
                           smem3, st>>>(p, msk, Wc, Ws, shat4, rows, P, K, Kp, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)pair_split_adj, as_smem(2));
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_split_adj<<<dim3(B * (Np / TC_BM), ceil_div(N, AS_BN), G), TC_THREADS, as_smem(2),
                   st>>>(shat4, static_cast<const __nv_bfloat16*>(T), phi, sgn,
                         G > 1 ? part : out, B, N, Np, P, K2p, G, !contract_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * N * N;
  pair_split_reduce<<<grid_for(n), ST_THREADS, 0, st>>>(part, out, n, G);
  return static_cast<int>(cudaGetLastError());
}
