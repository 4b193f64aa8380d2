// Mirror-pair parallel-beam projector kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in pdunet_tpu/ops/radon/pallas_kernels.py:
//   radon_pair_project     <- project_pair_group_pallas     (body _fwd_pair_kernel)
//   radon_pair_backproject <- backproject_pair_group_pallas (body _adj_pair_kernel)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/cuda_kernels.py
// (_project_pair_group / _backproject_pair_group).
//
// Per angle pair p of one group (contract_x picks which image axis is
// contracted; F[r, c] is the image with rows r kept and columns c contracted):
//   T̂[c, k]  = spec[k] * e^{-i k kf pos[p, c]}          (shared by the pair)
//   φ_m[r, k] = e^{+i k kf sh_m[p, r]},  m = a (sha), b (shb)
//   ĝ[r, k]  = Σ_c F[r, c] T̂[c, k]                      (stage 1, ~95% of FLOPs)
//   Ŝ_m[k]   = Σ_r ĝ_m[r, k] φ_m[r, k], ĝ_b = (gr, sgn·gi) (stage 2)
//   out[2p+m, s] = Σ_k Re Ŝ_m[k] Wc[k, s] − Im Ŝ_m[k] Ws[k, s] (stage 3)
// The adjoint is the exact transpose: Ŝ_m = W^T p_m (member b masked by msk),
// h = Σ_m Ŝ_m φ_m^* (sgn on Im of member b), f̃[r, c] += Σ_k Re(h T̂)[r, c].
//
// What bounds it on an H100: arithmetic. At the serving shape (B=4, N=256,
// P=23, K=180, S=256) stage 1 is ≈ 4.3 GFLOP
// per group (B·P·N²·K complex-by-real multiply-adds, 4 real FLOPs each)
// against ~1.7 MB of device-memory traffic, far above the card's
// ~20 FLOP/byte balance point for FP32. The fusion keeps the (B, P, N, K)
// stage-1 product ĝ (17 MB per tensor at that shape) out of device memory:
// the forward reduces ĝ·φ on chip and writes only Ŝ (B, 2P, K) complex;
// the adjoint builds h in shared memory chunk by chunk.
//
// Design (simple and correct first; CUDA cores, no tensor cores yet):
//   forward  : one block per (K-tile of 32, pair, image). T̂ for its K-tile
//              lives in shared memory; the block streams 64-row tiles of F
//              through a register-tiled product (4 rows x 2 k per thread),
//              applies both members' phases in registers and reduces Ŝ
//              across threads in shared memory. A second small kernel does
//              stage 3 (a (2P x K) by (K x S) product per image).
//   adjoint  : a small kernel does stage 3^T; the main kernel gives each
//              block one 64x64 output tile of one image and loops over pairs
//              and 32-wide K chunks, generating h and T̂ for the chunk in
//              shared memory (4x4 outputs per thread). Every pixel is written
//              once, with no atomics: the result is deterministic.
// The trig is generated on chip with precise sincosf (no fast math: the
// arguments reach ~10³ rad), from the argument the plain version forms:
// kf = (float)k * (float)(2π/L), then ang = pos * kf in f32, both products
// by __fmul_rn so that no FMA contraction changes their rounding. Tiles recompute
// T̂ and φ per image and per output tile; that redundancy, and the FP32
// CUDA-core product instead of bf16 wgmma, are what a later version removes.
//
// bf16 mode rounds each operand to bf16 where the plain version does
// (T̂, φ, F or p, W, Ŝ before stage 3, h before stage 1^T); every sum stays f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FW_TK = 32;        // frequencies per forward block
constexpr int FW_TR = 64;        // image rows per forward row tile
constexpr int FW_TC = 32;        // contraction chunk (image columns)
constexpr int FW_LD = FW_TR + 4; // padded row stride of the F chunk (bank spread)
constexpr int FW_THREADS = 256;  // 16 (k pairs) x 16 (row quads)

constexpr int AD_T = 64;         // adjoint output tile (rows and columns)
constexpr int AD_TK = 32;        // adjoint frequency chunk
constexpr int AD_THREADS = 256;  // 16 x 16 threads, 4x4 outputs each

constexpr int ST_THREADS = 256;  // stage-3 kernels

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Forward stages 1+2: Ŝ for both members of one pair, one K-tile, one image.
// shat layout: (B, 2P, K, 2) = (re, im).
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(FW_THREADS)
pair_fwd_stage12(const float* __restrict__ f, const float* __restrict__ pos,
                 const float* __restrict__ sha, const float* __restrict__ shb,
                 const float* __restrict__ sgn, const float* __restrict__ spec,
                 float* __restrict__ shat, int N, int P, int K, float kscale,
                 int sr, int sc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Npad = ceil_div(N, FW_TC) * FW_TC;
  float* t_re = smem;                    // [Npad][FW_TK]
  float* t_im = t_re + Npad * FW_TK;     // [Npad][FW_TK]
  float* f_s = t_im + Npad * FW_TK;      // [FW_TC][FW_LD], F chunk transposed

  const int k0 = blockIdx.x * FW_TK;
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // frequencies k0 + 2 tx, +1
  const int ty = tid >> 4;   // rows r0 + 4 ty .. +3

  const float* pos_p = pos + (size_t)p * N;
  for (int e = tid; e < Npad * FW_TK; e += FW_THREADS) {
    const int c = e / FW_TK, k = k0 + e % FW_TK;
    float tr = 0.f, ti = 0.f;
    if (c < N && k < K) {
      const float kf = __fmul_rn((float)k, kscale);
      const float ang = __fmul_rn(pos_p[c], kf);
      float s, co;
      sincosf(ang, &s, &co);
      const float sp = spec[k];
      tr = rnd<BF16>(sp * co);
      ti = rnd<BF16>(-sp * s);
    }
    t_re[e] = tr;
    t_im[e] = ti;
  }

  float kf[2];
  bool kvalid[2];
  for (int j = 0; j < 2; ++j) {
    const int k = k0 + 2 * tx + j;
    kvalid[j] = k < K;
    kf[j] = __fmul_rn((float)k, kscale);
  }
  const float sg = sgn[p];
  const float* sha_p = sha + (size_t)p * N;
  const float* shb_p = shb + (size_t)p * N;
  const float* fb = f + (size_t)b * N * N;
  float sa_re[2] = {0.f, 0.f}, sa_im[2] = {0.f, 0.f};
  float sb_re[2] = {0.f, 0.f}, sb_im[2] = {0.f, 0.f};

  for (int r0 = 0; r0 < N; r0 += FW_TR) {
    float gr[4][2] = {}, gi[4][2] = {};
    for (int c0 = 0; c0 < N; c0 += FW_TC) {
      __syncthreads();  // T̂ written (first pass) / previous chunk consumed
      for (int e = tid; e < FW_TR * FW_TC; e += FW_THREADS) {
        int r, c;
        if (sc == 1) { c = e % FW_TC; r = e / FW_TC; }  // coalesced along c
        else         { r = e % FW_TR; c = e / FW_TR; }  // coalesced along r
        const int rr = r0 + r, cc = c0 + c;
        const float v = (rr < N && cc < N) ? fb[(size_t)rr * sr + (size_t)cc * sc] : 0.f;
        f_s[c * FW_LD + r] = rnd<BF16>(v);
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < FW_TC; ++c) {
        const float4 fv = *reinterpret_cast<const float4*>(&f_s[c * FW_LD + 4 * ty]);
        const float2 tr = *reinterpret_cast<const float2*>(&t_re[(c0 + c) * FW_TK + 2 * tx]);
        const float2 ti = *reinterpret_cast<const float2*>(&t_im[(c0 + c) * FW_TK + 2 * tx]);
        const float fr[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gr[i][0] += fr[i] * tr.x;
          gr[i][1] += fr[i] * tr.y;
          gi[i][0] += fr[i] * ti.x;
          gi[i][1] += fr[i] * ti.y;
        }
      }
    }
    // stage 2 on this row tile: both members' shear phases, in registers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      if (r >= N) continue;
      const float sa = sha_p[r], sb = shb_p[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!kvalid[j]) continue;
        float s, c;
        sincosf(__fmul_rn(sa, kf[j]), &s, &c);
        const float pca = rnd<BF16>(c), psa = rnd<BF16>(s);
        sincosf(__fmul_rn(sb, kf[j]), &s, &c);
        const float pcb = rnd<BF16>(c), psb = rnd<BF16>(s);
        const float g_r = gr[i][j], g_i = gi[i][j], g_ib = gi[i][j] * sg;
        sa_re[j] += g_r * pca - g_i * psa;
        sa_im[j] += g_r * psa + g_i * pca;
        sb_re[j] += g_r * pcb - g_ib * psb;
        sb_im[j] += g_r * psb + g_ib * pcb;
      }
    }
  }

  // reduce over the 16 row groups: red[ty][tx][8]
  __syncthreads();
  float* red = f_s;  // FW_TC * FW_LD >= 2048 floats = 16 * 16 * 8
  float* mine = red + (ty * 16 + tx) * 8;
  mine[0] = sa_re[0]; mine[1] = sa_re[1]; mine[2] = sa_im[0]; mine[3] = sa_im[1];
  mine[4] = sb_re[0]; mine[5] = sb_re[1]; mine[6] = sb_im[0]; mine[7] = sb_im[1];
  __syncthreads();
  if (tid < 16 * 8) {
    const int ox = tid >> 3, v = tid & 7;
    float acc = 0.f;
    for (int y = 0; y < 16; ++y) acc += red[(y * 16 + ox) * 8 + v];
    const int member = v >> 2;          // 0: a, 1: b
    const int part = (v >> 1) & 1;      // 0: re, 1: im
    const int k = k0 + 2 * ox + (v & 1);
    if (k < K) {
      const int P2 = 2 * P;
      shat[(((size_t)b * P2 + 2 * p + member) * K + k) * 2 + part] = acc;
    }
  }
}

// Forward stage 3: out[b, row, s] = Σ_k Re Ŝ Wc − Im Ŝ Ws. grid (2P, B).
template <bool BF16>
__global__ void __launch_bounds__(ST_THREADS)
pair_fwd_stage3(const float* __restrict__ shat, const float* __restrict__ Wc,
                const float* __restrict__ Ws, float* __restrict__ out,
                int rows, int K, int S) {
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [K][2]
  const int row = blockIdx.x, b = blockIdx.y;
  const float* src = shat + ((size_t)b * rows + row) * K * 2;
  for (int e = threadIdx.x; e < 2 * K; e += ST_THREADS) s_s[e] = rnd<BF16>(src[e]);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += ST_THREADS) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc += s_s[2 * k] * rnd<BF16>(Wc[(size_t)k * S + s])
           - s_s[2 * k + 1] * rnd<BF16>(Ws[(size_t)k * S + s]);
    out[((size_t)b * rows + row) * S + s] = acc;
  }
}

// Adjoint stage 3^T: shat[b, p, m, k] = (Σ_s p_m[s] Wc[k, s], −Σ_s p_m[s] Ws[k, s]),
// p_b masked by msk. grid (P, B). shat layout (B, P, 2, K, 2).
template <bool BF16>
__global__ void __launch_bounds__(ST_THREADS)
pair_adj_stage3t(const float* __restrict__ p, const float* __restrict__ msk,
                 const float* __restrict__ Wc, const float* __restrict__ Ws,
                 float* __restrict__ shat, int P, int K, int S) {
  extern __shared__ float4 smem4[];
  float* pm = reinterpret_cast<float*>(smem4);  // [2][S]
  const int pr = blockIdx.x, b = blockIdx.y;
  const float* src = p + ((size_t)b * 2 * P + 2 * pr) * S;
  const float mb = msk[pr];
  for (int e = threadIdx.x; e < 2 * S; e += ST_THREADS) {
    const float v = rnd<BF16>(src[e]);
    pm[e] = e < S ? v : v * mb;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * K; e += ST_THREADS) {
    const int m = e / K, k = e % K;
    const float* w_c = Wc + (size_t)k * S;
    const float* w_s = Ws + (size_t)k * S;
    const float* pv = pm + m * S;
    float re = 0.f, im = 0.f;
    for (int s = 0; s < S; ++s) {
      re += pv[s] * rnd<BF16>(w_c[s]);
      im += pv[s] * rnd<BF16>(w_s[s]);
    }
    float* dst = shat + ((((size_t)b * P + pr) * 2 + m) * K + k) * 2;
    dst[0] = rnd<BF16>(re);
    dst[1] = rnd<BF16>(-im);
  }
}

// Adjoint stages 2^T + 1^T: one 64x64 output tile of one image, all pairs.
// grid (ceil(N/64) column tiles, ceil(N/64) row tiles, B).
template <bool BF16>
__global__ void __launch_bounds__(AD_THREADS)
pair_adj_stage21(const float* __restrict__ shat, const float* __restrict__ pos,
                 const float* __restrict__ sha, const float* __restrict__ shb,
                 const float* __restrict__ sgn, const float* __restrict__ spec,
                 float* __restrict__ out, int N, int P, int K, float kscale,
                 int sr, int sc) {
  __shared__ __align__(16) float h_re[AD_TK][AD_T];
  __shared__ __align__(16) float h_im[AD_TK][AD_T];
  __shared__ __align__(16) float t_re[AD_TK][AD_T];
  __shared__ __align__(16) float t_im[AD_TK][AD_T];
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [2][K][2] for the current pair

  const int c0 = blockIdx.x * AD_T;
  const int r0 = blockIdx.y * AD_T;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns c0 + 4 tx .. +3
  const int ty = tid >> 4;  // rows r0 + 4 ty .. +3

  float acc[4][4] = {};
  for (int p = 0; p < P; ++p) {
    __syncthreads();  // previous pair's s_s consumed
    const float* src = shat + ((size_t)b * P + p) * 2 * K * 2;
    for (int e = tid; e < 4 * K; e += AD_THREADS) s_s[e] = src[e];
    const float sg = sgn[p];
    const float* pos_p = pos + (size_t)p * N;
    const float* sha_p = sha + (size_t)p * N;
    const float* shb_p = shb + (size_t)p * N;
    for (int k0 = 0; k0 < K; k0 += AD_TK) {
      __syncthreads();  // s_s loaded / previous chunk consumed
      for (int e = tid; e < AD_TK * AD_T; e += AD_THREADS) {
        const int kk = e / AD_T, x = e % AD_T;
        const int k = k0 + kk;
        const float kf = __fmul_rn((float)k, kscale);
        float hr = 0.f, hi = 0.f, tr = 0.f, ti = 0.f;
        const int r = r0 + x;
        if (k < K && r < N) {
          const float sre_a = s_s[2 * k], sim_a = s_s[2 * k + 1];
          const float sre_b = s_s[2 * K + 2 * k], sim_b = s_s[2 * K + 2 * k + 1];
          float s, c;
          sincosf(__fmul_rn(sha_p[r], kf), &s, &c);
          const float pca = rnd<BF16>(c), psa = rnd<BF16>(s);
          sincosf(__fmul_rn(shb_p[r], kf), &s, &c);
          const float pcb = rnd<BF16>(c), psb = rnd<BF16>(s);
          const float hra = sre_a * pca + sim_a * psa;
          const float hia = -(sre_a * psa) + sim_a * pca;
          const float hrb = sre_b * pcb + sim_b * psb;
          const float hib = -(sre_b * psb) + sim_b * pcb;
          hr = rnd<BF16>(hra + hrb);
          hi = rnd<BF16>(hia + sg * hib);
        }
        const int cc = c0 + x;
        if (k < K && cc < N) {
          float s, c;
          sincosf(__fmul_rn(pos_p[cc], kf), &s, &c);
          const float sp = spec[k];
          tr = rnd<BF16>(sp * c);
          ti = rnd<BF16>(-sp * s);
        }
        h_re[kk][x] = hr;
        h_im[kk][x] = hi;
        t_re[kk][x] = tr;
        t_im[kk][x] = ti;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < AD_TK; ++kk) {
        const float4 a_r = *reinterpret_cast<const float4*>(&h_re[kk][4 * ty]);
        const float4 a_i = *reinterpret_cast<const float4*>(&h_im[kk][4 * ty]);
        const float4 b_r = *reinterpret_cast<const float4*>(&t_re[kk][4 * tx]);
        const float4 b_i = *reinterpret_cast<const float4*>(&t_im[kk][4 * tx]);
        const float ar[4] = {a_r.x, a_r.y, a_r.z, a_r.w};
        const float ai[4] = {a_i.x, a_i.y, a_i.z, a_i.w};
        const float br[4] = {b_r.x, b_r.y, b_r.z, b_r.w};
        const float bi[4] = {b_i.x, b_i.y, b_i.z, b_i.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] += ar[i] * br[j];
            acc[i][j] += ai[i] * bi[j];
          }
      }
    }
  }
  float* ob = out + (size_t)b * N * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < N) ob[(size_t)r * sr + (size_t)c * sc] = acc[i][j];
    }
  }
}

template <bool BF16>
cudaError_t launch_project(const float* f, const float* pos, const float* sha,
                           const float* shb, const float* sgn, const float* spec,
                           const float* Wc, const float* Ws, float* shat, float* out,
                           int B, int N, int P, int K, int S, float kscale,
                           int sr, int sc, cudaStream_t stream) {
  const int Npad = ceil_div(N, FW_TC) * FW_TC;
  const size_t smem12 = (size_t)(2 * Npad * FW_TK + FW_TC * FW_LD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pair_fwd_stage12<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem12);
  if (err != cudaSuccess) return err;
  pair_fwd_stage12<BF16><<<dim3(ceil_div(K, FW_TK), P, B), FW_THREADS, smem12, stream>>>(
      f, pos, sha, shb, sgn, spec, shat, N, P, K, kscale, sr, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem3 = (size_t)2 * K * sizeof(float);
  err = cudaFuncSetAttribute(pair_fwd_stage3<BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  pair_fwd_stage3<BF16><<<dim3(2 * P, B), ST_THREADS, smem3, stream>>>(
      shat, Wc, Ws, out, 2 * P, K, S);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_backproject(const float* p, const float* pos, const float* sha,
                               const float* shb, const float* sgn, const float* msk,
                               const float* spec, const float* Wc, const float* Ws,
                               float* shat, float* out, int B, int N, int P, int K,
                               int S, float kscale, int sr, int sc,
                               cudaStream_t stream) {
  const size_t smem3 = (size_t)2 * S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pair_adj_stage3t<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem3);
  if (err != cudaSuccess) return err;
  pair_adj_stage3t<BF16><<<dim3(P, B), ST_THREADS, smem3, stream>>>(
      p, msk, Wc, Ws, shat, P, K, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem21 = (size_t)4 * K * sizeof(float);
  err = cudaFuncSetAttribute(pair_adj_stage21<BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem21);
  if (err != cudaSuccess) return err;
  const int tiles = ceil_div(N, AD_T);
  pair_adj_stage21<BF16><<<dim3(tiles, tiles, B), AD_THREADS, smem21, stream>>>(
      shat, pos, sha, shb, sgn, spec, out, N, P, K, kscale, sr, sc);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device pointer
// to contiguous float32; the stream is a cudaStream_t. Returns the
// cudaError_t of the launches (0 on success). Nothing here synchronises.
extern "C" int radon_pair_project(const float* f, const float* pos, const float* sha,
                                  const float* shb, const float* sgn, const float* spec,
                                  const float* Wc, const float* Ws, float* shat,
                                  float* out, int B, int N, int P, int K, int S,
                                  float kscale, int contract_x, int bf16,
                                  void* stream) {
  const int sr = contract_x ? N : 1, sc = contract_x ? 1 : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16
      ? launch_project<true>(f, pos, sha, shb, sgn, spec, Wc, Ws, shat, out, B, N, P,
                             K, S, kscale, sr, sc, st)
      : launch_project<false>(f, pos, sha, shb, sgn, spec, Wc, Ws, shat, out, B, N, P,
                              K, S, kscale, sr, sc, st);
  return static_cast<int>(err);
}

extern "C" int radon_pair_backproject(const float* p, const float* pos, const float* sha,
                                      const float* shb, const float* sgn,
                                      const float* msk, const float* spec,
                                      const float* Wc, const float* Ws, float* shat,
                                      float* out, int B, int N, int P, int K, int S,
                                      float kscale, int contract_x, int bf16,
                                      void* stream) {
  const int sr = contract_x ? N : 1, sc = contract_x ? 1 : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16
      ? launch_backproject<true>(p, pos, sha, shb, sgn, msk, spec, Wc, Ws, shat, out,
                                 B, N, P, K, S, kscale, sr, sc, st)
      : launch_backproject<false>(p, pos, sha, shb, sgn, msk, spec, Wc, Ws, shat, out,
                                  B, N, P, K, S, kscale, sr, sc, st);
  return static_cast<int>(err);
}
