// Per-angle parallel-beam projector kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in pdunet_tpu/ops/radon/pallas_kernels.py:
//   radon_group_project     <- project_group_pallas     (body _fwd_kernel)
//   radon_group_backproject <- backproject_group_pallas (body _adj_kernel)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/cuda_kernels.py
// (_project_group / _backproject_group).
//
// They carry every plan whose angles do not pair: golden-angle spokes, and
// so the radial fourier-slice NUFFT, whose backing plan has K = L/2
// frequencies and a ±1 selection matrix as its "inverse DFT" (Wc, Ws). The
// kernels take K and S from the caller and assume no relation to L; stage 3
// is the dense product the TPU computes, so they stay right for any W.
//
// Per angle a of one group (contract_x picks which image axis is
// contracted; F[r, c] is the image with rows r kept and columns c contracted):
//   T̂[c, k] = spec[k] * e^{-i k kf pos[a, c]}
//   φ[r, k]  = e^{+i k kf shift[a, r]}
//   ĝ[r, k]  = Σ_c F[r, c] T̂[c, k]                      (stage 1, ~97% of FLOPs)
//   Ŝ[k]     = Σ_r ĝ[r, k] φ[r, k]                      (stage 2)
//   out[a, s] = Σ_k Re Ŝ[k] Wc[k, s] − Im Ŝ[k] Ws[k, s] (stage 3)
// The adjoint is the exact transpose: Ŝ = (W_c^T p, −W_s^T p),
// h = Ŝ φ^*, f̃[r, c] = Σ_a Σ_k Re(h T̂)[r, c].
//
// What bounds it on an H100: arithmetic. At the pdunet_radial shapes
// (B' = 8 real images, N = 256, A_g ≈ 64, K = 256, S = 1024) stage 1 is
// ≈ 34 GFLOP per group call against ≈ 6 MB of device-memory traffic. The
// fusion keeps ĝ (B', A_g, N, K), 1 GB per tensor at that shape, out of
// device memory: the forward reduces ĝ·φ on chip and writes only Ŝ; the
// adjoint builds h in shared memory chunk by chunk.
//
// Design (simple and correct first; CUDA cores, no tensor cores yet):
//   forward  : stage 1+2 kernel, one block per (K-tile of 32, angle, image):
//              T̂ of its K-tile in shared memory, 64-row tiles of F streamed
//              through a register-tiled product (4 rows x 2 k per thread),
//              φ applied in registers, Ŝ reduced across threads in shared
//              memory. A stage-3 kernel then multiplies 8 (image, angle)
//              rows of Ŝ at a time by W, each thread one output column, so W
//              is read coalesced and shared by the 8 rows.
//   adjoint  : a stage-3ᵀ kernel (one warp per frequency k: lanes stride
//              the S columns of W coalesced, 8 rows of p from shared memory,
//              warp-shuffle sums), then the main kernel: each block owns one
//              64x64 output tile of one image and a slice of the group's
//              angles, and loops over them and 32-wide K chunks, generating
//              h and T̂ for the chunk in shared memory (4x4 outputs per
//              thread). The angle loop is split into G slices (chosen by the
//              wrapper) so that enough blocks fill the 132 SMs; each slice
//              writes a partial image and a last kernel sums the G partials
//              in a fixed order. No atomics: the result is deterministic.
// The trig is generated on chip with precise sincosf (no fast math: the
// arguments reach |pos|·π ≈ 400 rad at N = 256), from the argument the
// plain version forms: kf = (float)k * (float)(2π/L), then ang = pos * kf in
// f32, both products by __fmul_rn so that no FMA contraction changes their
// rounding. The TPU kernels' block-doubling rotor trig is not carried over.
//
// bf16 mode rounds each operand to bf16 where the plain version does
// (T̂, φ, F or p, W, Ŝ before stage 3, h before stage 1ᵀ); every sum stays f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int GF_TK = 32;        // frequencies per forward block
constexpr int GF_TR = 64;        // image rows per forward row tile
constexpr int GF_TC = 32;        // contraction chunk (image columns)
constexpr int GF_LD = GF_TR + 4; // padded row stride of the F chunk (bank spread)
constexpr int GF_THREADS = 256;  // 16 (k pairs) x 16 (row quads)

constexpr int GR_AD_T = 64;      // adjoint output tile (rows and columns)
constexpr int GR_AD_TK = 32;     // adjoint frequency chunk
constexpr int GR_AD_THREADS = 256;

constexpr int ST_ROWS = 8;       // (image, angle) rows per stage-3 / 3ᵀ block
constexpr int ST_THREADS = 256;
constexpr int ST3T_TK = 32;      // frequencies per stage-3ᵀ block (4 per warp)

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Forward stages 1+2: Ŝ of one angle, one K-tile, one image.
// shat layout: (B, A, K, 2) = (re, im).
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(GF_THREADS)
group_fwd_stage12(const float* __restrict__ f, const float* __restrict__ pos,
                  const float* __restrict__ shift, const float* __restrict__ spec,
                  float* __restrict__ shat, int N, int A, int K, float kscale,
                  int sr, int sc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Npad = ceil_div(N, GF_TC) * GF_TC;
  float* t_re = smem;                    // [Npad][GF_TK]
  float* t_im = t_re + Npad * GF_TK;     // [Npad][GF_TK]
  float* f_s = t_im + Npad * GF_TK;      // [GF_TC][GF_LD], F chunk transposed

  const int k0 = blockIdx.x * GF_TK;
  const int a = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // frequencies k0 + 2 tx, +1
  const int ty = tid >> 4;   // rows r0 + 4 ty .. +3

  const float* pos_a = pos + (size_t)a * N;
  for (int e = tid; e < Npad * GF_TK; e += GF_THREADS) {
    const int c = e / GF_TK, k = k0 + e % GF_TK;
    float tr = 0.f, ti = 0.f;
    if (c < N && k < K) {
      const float kf = __fmul_rn((float)k, kscale);
      const float ang = __fmul_rn(pos_a[c], kf);
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
  const float* shift_a = shift + (size_t)a * N;
  const float* fb = f + (size_t)b * N * N;
  float s_re[2] = {0.f, 0.f}, s_im[2] = {0.f, 0.f};

  for (int r0 = 0; r0 < N; r0 += GF_TR) {
    float gr[4][2] = {}, gi[4][2] = {};
    for (int c0 = 0; c0 < N; c0 += GF_TC) {
      __syncthreads();  // T̂ written (first pass) / previous chunk consumed
      for (int e = tid; e < GF_TR * GF_TC; e += GF_THREADS) {
        int r, c;
        if (sc == 1) { c = e % GF_TC; r = e / GF_TC; }  // coalesced along c
        else         { r = e % GF_TR; c = e / GF_TR; }  // coalesced along r
        const int rr = r0 + r, cc = c0 + c;
        const float v = (rr < N && cc < N) ? fb[(size_t)rr * sr + (size_t)cc * sc] : 0.f;
        f_s[c * GF_LD + r] = rnd<BF16>(v);
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < GF_TC; ++c) {
        const float4 fv = *reinterpret_cast<const float4*>(&f_s[c * GF_LD + 4 * ty]);
        const float2 tr = *reinterpret_cast<const float2*>(&t_re[(c0 + c) * GF_TK + 2 * tx]);
        const float2 ti = *reinterpret_cast<const float2*>(&t_im[(c0 + c) * GF_TK + 2 * tx]);
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
    // stage 2 on this row tile: the shear phases, in registers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      if (r >= N) continue;
      const float sh = shift_a[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!kvalid[j]) continue;
        float s, c;
        sincosf(__fmul_rn(sh, kf[j]), &s, &c);
        const float pc = rnd<BF16>(c), ps = rnd<BF16>(s);
        s_re[j] += gr[i][j] * pc - gi[i][j] * ps;
        s_im[j] += gr[i][j] * ps + gi[i][j] * pc;
      }
    }
  }

  // reduce over the 16 row groups: red[ty][tx][4]
  __syncthreads();
  float* red = f_s;  // GF_TC * GF_LD >= 1024 floats = 16 * 16 * 4
  float* mine = red + (ty * 16 + tx) * 4;
  mine[0] = s_re[0]; mine[1] = s_re[1]; mine[2] = s_im[0]; mine[3] = s_im[1];
  __syncthreads();
  if (tid < 16 * 4) {
    const int ox = tid >> 2, v = tid & 3;
    float acc = 0.f;
    for (int y = 0; y < 16; ++y) acc += red[(y * 16 + ox) * 4 + v];
    const int part = v >> 1;  // 0: re, 1: im
    const int k = k0 + 2 * ox + (v & 1);
    if (k < K) shat[(((size_t)b * A + a) * K + k) * 2 + part] = acc;
  }
}

// Forward stage 3: out[row, s] = Σ_k Re Ŝ[row, k] Wc[k, s] − Im Ŝ Ws[k, s] for
// ST_ROWS rows (row = b·A + a) per block. grid (ceil(rows/ST_ROWS), ceil(S/ST_THREADS)).
template <bool BF16>
__global__ void __launch_bounds__(ST_THREADS)
group_fwd_stage3(const float* __restrict__ shat, const float* __restrict__ Wc,
                 const float* __restrict__ Ws, float* __restrict__ out,
                 int rows, int K, int S) {
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [ST_ROWS][K][2]
  const int row0 = blockIdx.x * ST_ROWS;
  const int nr = min(ST_ROWS, rows - row0);
  const float* src = shat + (size_t)row0 * K * 2;
  for (int e = threadIdx.x; e < ST_ROWS * 2 * K; e += ST_THREADS)
    s_s[e] = e < nr * 2 * K ? rnd<BF16>(src[e]) : 0.f;
  __syncthreads();
  const int s = blockIdx.y * ST_THREADS + threadIdx.x;
  if (s >= S) return;
  float acc[ST_ROWS] = {};
  for (int k = 0; k < K; ++k) {
    const float wc = rnd<BF16>(Wc[(size_t)k * S + s]);
    const float ws = rnd<BF16>(Ws[(size_t)k * S + s]);
#pragma unroll
    for (int r = 0; r < ST_ROWS; ++r)
      acc[r] += s_s[(r * K + k) * 2] * wc - s_s[(r * K + k) * 2 + 1] * ws;
  }
  for (int r = 0; r < nr; ++r) out[(size_t)(row0 + r) * S + s] = acc[r];
}

// Adjoint stage 3ᵀ: shat[row, k] = (Σ_s p[row, s] Wc[k, s], −Σ_s p[row, s] Ws[k, s]),
// rounded as the plain version rounds. One warp per k, lanes over s.
// grid (ceil(rows/ST_ROWS), ceil(K/ST3T_TK)).
template <bool BF16>
__global__ void __launch_bounds__(ST_THREADS)
group_adj_stage3t(const float* __restrict__ p, const float* __restrict__ Wc,
                  const float* __restrict__ Ws, float* __restrict__ shat,
                  int rows, int K, int S) {
  extern __shared__ float4 smem4[];
  float* p_s = reinterpret_cast<float*>(smem4);  // [ST_ROWS][S]
  const int row0 = blockIdx.x * ST_ROWS;
  const int nr = min(ST_ROWS, rows - row0);
  const float* src = p + (size_t)row0 * S;
  for (int e = threadIdx.x; e < ST_ROWS * S; e += ST_THREADS)
    p_s[e] = e < nr * S ? rnd<BF16>(src[e]) : 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kk = warp; kk < ST3T_TK; kk += ST_THREADS / 32) {
    const int k = blockIdx.y * ST3T_TK + kk;
    if (k >= K) break;
    const float* w_c = Wc + (size_t)k * S;
    const float* w_s = Ws + (size_t)k * S;
    float re[ST_ROWS] = {}, im[ST_ROWS] = {};
    for (int s = lane; s < S; s += 32) {
      const float wc = rnd<BF16>(w_c[s]), ws = rnd<BF16>(w_s[s]);
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
    if (lane < nr) {
      float vr = 0.f, vi = 0.f;
#pragma unroll
      for (int r = 0; r < ST_ROWS; ++r)
        if (r == lane) { vr = re[r]; vi = im[r]; }
      float* dst = shat + ((size_t)(row0 + lane) * K + k) * 2;
      dst[0] = rnd<BF16>(vr);
      dst[1] = rnd<BF16>(-vi);
    }
  }
}

// Adjoint stages 2ᵀ + 1ᵀ: one 64x64 output tile of one image over the angle
// slice [A·g/G, A·(g+1)/G). grid (ceil(N/64) column tiles, ceil(N/64) row
// tiles, B·G). With G = 1 the tile goes straight to out, else to part[g].
template <bool BF16>
__global__ void __launch_bounds__(GR_AD_THREADS)
group_adj_stage21(const float* __restrict__ shat, const float* __restrict__ pos,
                  const float* __restrict__ shift, const float* __restrict__ spec,
                  float* __restrict__ dst, int B, int N, int A, int K, int G,
                  float kscale, int sr, int sc) {
  __shared__ __align__(16) float h_re[GR_AD_TK][GR_AD_T];
  __shared__ __align__(16) float h_im[GR_AD_TK][GR_AD_T];
  __shared__ __align__(16) float t_re[GR_AD_TK][GR_AD_T];
  __shared__ __align__(16) float t_im[GR_AD_TK][GR_AD_T];
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [K][2] of the current angle

  const int c0 = blockIdx.x * GR_AD_T;
  const int r0 = blockIdx.y * GR_AD_T;
  const int b = blockIdx.z % B;
  const int g = blockIdx.z / B;
  const int a_lo = (int)(((long long)A * g) / G);
  const int a_hi = (int)(((long long)A * (g + 1)) / G);
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns c0 + 4 tx .. +3
  const int ty = tid >> 4;  // rows r0 + 4 ty .. +3

  float acc[4][4] = {};
  for (int a = a_lo; a < a_hi; ++a) {
    __syncthreads();  // previous angle's s_s consumed
    const float* src = shat + ((size_t)b * A + a) * K * 2;
    for (int e = tid; e < 2 * K; e += GR_AD_THREADS) s_s[e] = src[e];
    const float* pos_a = pos + (size_t)a * N;
    const float* shift_a = shift + (size_t)a * N;
    for (int k0 = 0; k0 < K; k0 += GR_AD_TK) {
      __syncthreads();  // s_s loaded / previous chunk consumed
      for (int e = tid; e < GR_AD_TK * GR_AD_T; e += GR_AD_THREADS) {
        const int kk = e / GR_AD_T, x = e % GR_AD_T;
        const int k = k0 + kk;
        const float kf = __fmul_rn((float)k, kscale);
        float hr = 0.f, hi = 0.f, tr = 0.f, ti = 0.f;
        const int r = r0 + x;
        if (k < K && r < N) {
          const float sre = s_s[2 * k], sim = s_s[2 * k + 1];
          float s, c;
          sincosf(__fmul_rn(shift_a[r], kf), &s, &c);
          const float pc = rnd<BF16>(c), ps = rnd<BF16>(s);
          hr = rnd<BF16>(sre * pc + sim * ps);
          hi = rnd<BF16>(-(sre * ps) + sim * pc);
        }
        const int cc = c0 + x;
        if (k < K && cc < N) {
          float s, c;
          sincosf(__fmul_rn(pos_a[cc], kf), &s, &c);
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
      for (int kk = 0; kk < GR_AD_TK; ++kk) {
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
  float* ob = dst + ((size_t)g * B + b) * N * N;
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

// out[i] = Σ_g part[g][i], g in order. n = B·N·N.
__global__ void __launch_bounds__(ST_THREADS)
group_adj_reduce(const float* __restrict__ part, float* __restrict__ out,
                 size_t n, int G) {
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

template <bool BF16>
cudaError_t launch_project(const float* f, const float* pos, const float* shift,
                           const float* spec, const float* Wc, const float* Ws,
                           float* shat, float* out, int B, int N, int A, int K, int S,
                           float kscale, int sr, int sc, cudaStream_t stream) {
  const int Npad = ceil_div(N, GF_TC) * GF_TC;
  const size_t smem12 = (size_t)(2 * Npad * GF_TK + GF_TC * GF_LD) * sizeof(float);
  cudaError_t err = set_smem((const void*)group_fwd_stage12<BF16>, smem12);
  if (err != cudaSuccess) return err;
  group_fwd_stage12<BF16><<<dim3(ceil_div(K, GF_TK), A, B), GF_THREADS, smem12, stream>>>(
      f, pos, shift, spec, shat, N, A, K, kscale, sr, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * A;
  const size_t smem3 = (size_t)ST_ROWS * 2 * K * sizeof(float);
  err = set_smem((const void*)group_fwd_stage3<BF16>, smem3);
  if (err != cudaSuccess) return err;
  group_fwd_stage3<BF16><<<dim3(ceil_div(rows, ST_ROWS), ceil_div(S, ST_THREADS)),
                           ST_THREADS, smem3, stream>>>(shat, Wc, Ws, out, rows, K, S);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_backproject(const float* p, const float* pos, const float* shift,
                               const float* spec, const float* Wc, const float* Ws,
                               float* shat, float* part, float* out, int B, int N,
                               int A, int K, int S, int G, float kscale, int sr,
                               int sc, cudaStream_t stream) {
  const int rows = B * A;
  const size_t smem3 = (size_t)ST_ROWS * S * sizeof(float);
  cudaError_t err = set_smem((const void*)group_adj_stage3t<BF16>, smem3);
  if (err != cudaSuccess) return err;
  group_adj_stage3t<BF16><<<dim3(ceil_div(rows, ST_ROWS), ceil_div(K, ST3T_TK)),
                            ST_THREADS, smem3, stream>>>(p, Wc, Ws, shat, rows, K, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem21 = (size_t)2 * K * sizeof(float);
  err = set_smem((const void*)group_adj_stage21<BF16>, smem21);
  if (err != cudaSuccess) return err;
  const int tiles = ceil_div(N, GR_AD_T);
  group_adj_stage21<BF16><<<dim3(tiles, tiles, B * G), GR_AD_THREADS, smem21, stream>>>(
      shat, pos, shift, spec, G > 1 ? part : out, B, N, A, K, G, kscale, sr, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return err;
  const size_t n = (size_t)B * N * N;
  const size_t want = (n + ST_THREADS - 1) / ST_THREADS;
  group_adj_reduce<<<(int)(want < 4096 ? want : 4096), ST_THREADS, 0, stream>>>(
      part, out, n, G);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device pointer
// to contiguous float32 (part may be null when G = 1); the stream is a
// cudaStream_t. Returns the cudaError_t of the launches (0 on success).
// Nothing here synchronises or allocates: shat (B, A, K, 2) and part
// (G, B, N, N) are scratch from the caller.
extern "C" int radon_group_project(const float* f, const float* pos, const float* shift,
                                   const float* spec, const float* Wc, const float* Ws,
                                   float* shat, float* out, int B, int N, int A, int K,
                                   int S, float kscale, int contract_x, int bf16,
                                   void* stream) {
  const int sr = contract_x ? N : 1, sc = contract_x ? 1 : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16
      ? launch_project<true>(f, pos, shift, spec, Wc, Ws, shat, out, B, N, A, K, S,
                             kscale, sr, sc, st)
      : launch_project<false>(f, pos, shift, spec, Wc, Ws, shat, out, B, N, A, K, S,
                              kscale, sr, sc, st);
  return static_cast<int>(err);
}

extern "C" int radon_group_backproject(const float* p, const float* pos,
                                       const float* shift, const float* spec,
                                       const float* Wc, const float* Ws, float* shat,
                                       float* part, float* out, int B, int N, int A,
                                       int K, int S, int G, float kscale,
                                       int contract_x, int bf16, void* stream) {
  if (G < 1 || (G > 1 && part == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int sr = contract_x ? N : 1, sc = contract_x ? 1 : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16
      ? launch_backproject<true>(p, pos, shift, spec, Wc, Ws, shat, part, out, B, N, A,
                                 K, S, G, kscale, sr, sc, st)
      : launch_backproject<false>(p, pos, shift, spec, Wc, Ws, shat, part, out, B, N, A,
                                  K, S, G, kscale, sr, sc, st);
  return static_cast<int>(err);
}
