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
// The forward and adjoint designs (stage 2 in the forward's f32 epilogue,
// h built in swizzled shared memory while the adjoint's products run, the
// G-slice depth split) are those of radon_tc.cuh, instantiated here with
// M = 2 members per pair: member b reuses ĝ with Im scaled by sgn, and
// unpaired rows (msk = 0) contribute zero: their p rows are zeroed before
// stage 3ᵀ. Padded rows, columns and frequencies are zero in the tables.

#include "radon_tc.cuh"

namespace {

constexpr int ST_ROWS = 8;       // rows per stage-3 / 3ᵀ block
constexpr int ST3T_TK = 32;      // frequencies per stage-3ᵀ block (4 per warp)
constexpr int ST3_COLS = 64;     // output columns per stage-3 block, two per thread
constexpr int ST3_SPLIT = ST_THREADS / (ST3_COLS / 2);  // ways its k loop is split

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
