// Kernel probes for Hopper (sm_90a): variants of the shipped projector
// kernels that each change one thing, so an A/B on the card isolates it.
//
// Replaces the Pallas TPU kernels of the JAX package's probe scripts:
//   radon_proto_pairdoubling      <- scripts/trig_proto.py::call_pair_fwd
//                                    (body _fwd_pair_kernel_doubling)
//   radon_proto_pairnotrig        <- same call (body _fwd_pair_kernel_notrig)
//   radon_proto_packedproject     <- scripts/pack_proto.py::call_fwd
//                                    (body _fwd_kernel_packed)
//   radon_proto_packedbackproject <- scripts/pack_proto.py::call_adj
//                                    (body _adj_kernel_packed)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/proto_kernels.py.
//
// The pair variants keep the structure of radon_pair.cu's forward (one block
// per K-tile of 32, pair and image; T̂ of the tile in shared memory; 64-row
// tiles of F through a 4 rows x 2 k register tile; both members' shear
// phases in registers; Ŝ reduced in shared memory; a stage-3 kernel) and
// change only how the six trig tensors are made:
//   doubling: block-doubling rotor trig from host seeds (th0, dth) per pair
//             and family [pos | sha | shb]. Row j of e^{iθ} is the seed
//             rotated by the rotors R_{2^b} = e^{i·2^b·dth} of j's set bits,
//             lowest bit first: the same products in the same order as the
//             concatenating doubling loop of the plain version (rows
//             [n, 2n) = rows [0, n)·R_n). The rotors come by repeated squaring
//             ((c² − s²), 2cs) once per block for its K tile, into shared
//             memory. At most log2 N complex multiplies per element, against
//             one precise sincosf in the shipped kernel.
//   notrig  : the trig tensors replaced by spec ± pos·kf and sh·kf ± 1: the
//             shipped kernel's cost without its trig (wrong numbers).
// The packed variants keep radon_group.cu's structure and pack re/im:
//   forward : a block owns 64 columns of the packed (N, 2K) operand
//             [T̂c | T̂s] (4 rows x 4 columns per thread), folds stage 2 into
//             the two 2K-wide rows [Σ g·φc | −Σ g·φs] and [Σ g·φs | Σ g·φc],
//             and a stage-3 kernel runs one 4K-deep product against
//             [Wc; Wc; −Ws; −Ws] (each half of the rows rounded on its own).
//   adjoint : Ŝ = (p·Wcᵀ, −p·Wsᵀ) unrounded, then per 64x64 output tile and
//             angle slice one 2K-deep contraction of h = [h_re | h_im] with
//             [T̂c | T̂s] in 32-column chunks; the angle split and the fixed-
//             order sum of the partials are radon_group.cu's.
//   A column of the packed operand is the cos or the sin half of one k, so a
//   packed block generates each T̂ and φ element once per half: twice the
//   shipped kernel's trig for the same products. Trig: exact precise sincosf,
//   or block doubling from float32 seeds th0 = row[0]·kf,
//   dth = (row[1] − row[0])·kf formed on chip (the Pallas _row_trig rule).
//
// What bounds them on an H100: arithmetic, as the shipped kernels (the same
// products on FP32 CUDA cores; the probes change only the trig work).
// Every operation whose rounding the plain version fixes is written with
// __fmul_rn / __fadd_rn / __fsub_rn so that no FMA contraction moves it;
// the seeds' cos/sin are precise sincosf (no fast math).
//
// bf16 mode rounds each operand to bf16 where the plain version does; every
// sum stays f32. The stage-3, stage-3ᵀ and partial-sum kernels repeat those of
// radon_pair.cu / radon_group.cu (the packed ones with a 4K-deep W and an
// unrounded Ŝ), so that the shipped sources stay as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TK = 32;           // pair forward: frequencies per block
constexpr int TR = 64;           // image rows per row tile
constexpr int TC = 32;           // contraction chunk (image columns)
constexpr int LD = TR + 4;       // padded row stride of the F chunk
constexpr int THREADS = 256;

constexpr int PK_TM = 64;        // packed forward: packed columns per block
constexpr int AD_T = 64;         // packed adjoint output tile
constexpr int AD_TM = 32;        // packed adjoint chunk of packed columns

constexpr int ST_ROWS = 8;       // rows per stage-3 / 3ᵀ block
constexpr int ST3T_TK = 32;      // frequencies per stage-3ᵀ block

enum { DOUBLING = 0, NOTRIG = 1 };

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

int levels(int N) {  // rotors the doubling needs: rows up to N−1
  int nb = 0;
  while ((1 << nb) < N) ++nb;
  return nb;
}

// Rotor table of one family and column t, in shared memory: level 0 holds the
// seed (cos th0, sin th0), level b+1 the rotor R_{2^b}. Layout
// tab[(lvl * W + t)] for a table of width W (one table per family and part).
__device__ __forceinline__ void build_rotors(float th0, float dth, int nb, int W, int t,
                                             float* tc, float* ts) {
  float s, c;
  sincosf(th0, &s, &c);
  tc[t] = c;
  ts[t] = s;
  float rs, rc;
  sincosf(dth, &rs, &rc);
  for (int b = 0; b < nb; ++b) {
    tc[(b + 1) * W + t] = rc;
    ts[(b + 1) * W + t] = rs;
    const float rc2 = __fsub_rn(__fmul_rn(rc, rc), __fmul_rn(rs, rs));
    rs = __fmul_rn(__fmul_rn(2.f, rc), rs);
    rc = rc2;
  }
}

// (cos, sin) of row j from column t's table: the seed rotated by the rotors
// of j's set bits, lowest first.
__device__ __forceinline__ void dbl_row(const float* tc, const float* ts, int W, int t,
                                        int j, float& c, float& s) {
  c = tc[t];
  s = ts[t];
  for (int b = 1; j; ++b, j >>= 1) {
    if (j & 1) {
      const float rc = tc[b * W + t], rs = ts[b * W + t];
      const float c2 = __fsub_rn(__fmul_rn(c, rc), __fmul_rn(s, rs));
      s = __fadd_rn(__fmul_rn(c, rs), __fmul_rn(s, rc));
      c = c2;
    }
  }
}

// ---------------------------------------------------------------------------
// Pair forward stages 1+2 (doubling or no-trig). shat layout (B, 2P, K, 2).
// ---------------------------------------------------------------------------
template <bool BF16, int MODE>
__global__ void __launch_bounds__(THREADS)
pair_proto_stage12(const float* __restrict__ f, const float* __restrict__ pos,
                   const float* __restrict__ sha, const float* __restrict__ shb,
                   const float* __restrict__ seeds0, const float* __restrict__ steps,
                   const float* __restrict__ sgn, const float* __restrict__ spec,
                   float* __restrict__ shat, int N, int P, int K, int nb, float kscale,
                   int sr, int sc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Npad = ceil_div(N, TC) * TC;
  float* t_re = smem;                    // [Npad][TK]
  float* t_im = t_re + Npad * TK;        // [Npad][TK]
  float* f_s = t_im + Npad * TK;         // [TC][LD], F chunk transposed
  float* tab_c = f_s + TC * LD;          // doubling: [3 families][nb+1][TK]
  float* tab_s = tab_c + 3 * (nb + 1) * TK;
  const int fam = (nb + 1) * TK;         // stride between families

  const int k0 = blockIdx.x * TK;
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // frequencies k0 + 2 tx, +1
  const int ty = tid >> 4;   // rows r0 + 4 ty .. +3

  if (MODE == DOUBLING) {
    for (int e = tid; e < 3 * TK; e += THREADS) {
      const int fm = e / TK, t = e % TK, k = min(k0 + t, K - 1);
      const size_t at = (size_t)p * 3 * K + (size_t)fm * K + k;
      build_rotors(seeds0[at], steps[at], nb, TK, t, tab_c + fm * fam, tab_s + fm * fam);
    }
    __syncthreads();
  }

  const float* pos_p = pos + (size_t)p * N;
  for (int e = tid; e < Npad * TK; e += THREADS) {
    const int c = e / TK, t = e % TK, k = k0 + t;
    float tr = 0.f, ti = 0.f;
    if (c < N && k < K) {
      const float sp = spec[k];
      if (MODE == DOUBLING) {
        float co, s;
        dbl_row(tab_c, tab_s, TK, t, c, co, s);
        tr = rnd<BF16>(__fmul_rn(sp, co));
        ti = rnd<BF16>(__fmul_rn(-sp, s));
      } else {
        const float v = __fmul_rn(pos_p[c], __fmul_rn((float)k, kscale));
        tr = rnd<BF16>(__fadd_rn(sp, v));
        ti = rnd<BF16>(__fsub_rn(sp, v));
      }
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

  for (int r0 = 0; r0 < N; r0 += TR) {
    float gr[4][2] = {}, gi[4][2] = {};
    for (int c0 = 0; c0 < N; c0 += TC) {
      __syncthreads();  // T̂ written (first pass) / previous chunk consumed
      for (int e = tid; e < TR * TC; e += THREADS) {
        int r, c;
        if (sc == 1) { c = e % TC; r = e / TC; }  // coalesced along c
        else         { r = e % TR; c = e / TR; }  // coalesced along r
        const int rr = r0 + r, cc = c0 + c;
        const float v = (rr < N && cc < N) ? fb[(size_t)rr * sr + (size_t)cc * sc] : 0.f;
        f_s[c * LD + r] = rnd<BF16>(v);
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < TC; ++c) {
        const float4 fv = *reinterpret_cast<const float4*>(&f_s[c * LD + 4 * ty]);
        const float2 tr = *reinterpret_cast<const float2*>(&t_re[(c0 + c) * TK + 2 * tx]);
        const float2 ti = *reinterpret_cast<const float2*>(&t_im[(c0 + c) * TK + 2 * tx]);
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
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!kvalid[j]) continue;
        float pca, psa, pcb, psb;
        if (MODE == DOUBLING) {
          const int t = 2 * tx + j;
          float c, s;
          dbl_row(tab_c + fam, tab_s + fam, TK, t, r, c, s);
          pca = rnd<BF16>(c); psa = rnd<BF16>(s);
          dbl_row(tab_c + 2 * fam, tab_s + 2 * fam, TK, t, r, c, s);
          pcb = rnd<BF16>(c); psb = rnd<BF16>(s);
        } else {
          const float va = __fmul_rn(sha_p[r], kf[j]), vb = __fmul_rn(shb_p[r], kf[j]);
          pca = rnd<BF16>(__fadd_rn(va, 1.f)); psa = rnd<BF16>(__fsub_rn(va, 1.f));
          pcb = rnd<BF16>(__fadd_rn(vb, 1.f)); psb = rnd<BF16>(__fsub_rn(vb, 1.f));
        }
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
  float* red = f_s;  // TC * LD >= 2048 floats = 16 * 16 * 8
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
    if (k < K) shat[(((size_t)b * 2 * P + 2 * p + member) * K + k) * 2 + part] = acc;
  }
}

// Pair forward stage 3: out[b, row, s] = Σ_k Re Ŝ Wc − Im Ŝ Ws. grid (2P, B).
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
pair_proto_stage3(const float* __restrict__ shat, const float* __restrict__ Wc,
                  const float* __restrict__ Ws, float* __restrict__ out, int rows, int K,
                  int S) {
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [K][2]
  const int row = blockIdx.x, b = blockIdx.y;
  const float* src = shat + ((size_t)b * rows + row) * K * 2;
  for (int e = threadIdx.x; e < 2 * K; e += THREADS) s_s[e] = rnd<BF16>(src[e]);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += THREADS) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc += s_s[2 * k] * rnd<BF16>(Wc[(size_t)k * S + s])
           - s_s[2 * k + 1] * rnd<BF16>(Ws[(size_t)k * S + s]);
    out[((size_t)b * rows + row) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// Packed forward stages 1+2: 64 packed columns m of [T̂c | T̂s], one angle, one
// image. rows layout (B, A, 4K) = [row1 (2K) | row2 (2K)].
// ---------------------------------------------------------------------------
template <bool BF16, bool DBL>
__global__ void __launch_bounds__(THREADS)
packed_fwd_stage12(const float* __restrict__ f, const float* __restrict__ pos,
                   const float* __restrict__ shift, const float* __restrict__ spec,
                   float* __restrict__ rows, int N, int A, int K, int nb, float kscale,
                   int sr, int sc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Npad = ceil_div(N, TC) * TC;
  float* t2 = smem;                      // [Npad][PK_TM]
  float* f_s = t2 + Npad * PK_TM;        // [TC][LD]
  float* tab_c = f_s + TC * LD;          // doubling: [2 families][nb+1][PK_TM]
  float* tab_s = tab_c + 2 * (nb + 1) * PK_TM;
  const int fam = (nb + 1) * PK_TM;

  const int K2 = 2 * K;
  const int m0 = blockIdx.x * PK_TM;
  const int a = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // packed columns m0 + 4 tx .. +3
  const int ty = tid >> 4;   // rows r0 + 4 ty .. +3
  const float* pos_a = pos + (size_t)a * N;
  const float* shift_a = shift + (size_t)a * N;

  if (DBL) {
    for (int e = tid; e < 2 * PK_TM; e += THREADS) {
      const int fm = e / PK_TM, t = e % PK_TM;
      const int m = min(m0 + t, K2 - 1), k = m < K ? m : m - K;
      const float* row = fm == 0 ? pos_a : shift_a;
      const float kf = __fmul_rn((float)k, kscale);
      const float r1 = N > 1 ? row[1] : row[0];
      build_rotors(__fmul_rn(row[0], kf), __fmul_rn(__fsub_rn(r1, row[0]), kf), nb, PK_TM,
                   t, tab_c + fm * fam, tab_s + fm * fam);
    }
    __syncthreads();
  }

  for (int e = tid; e < Npad * PK_TM; e += THREADS) {
    const int c = e / PK_TM, t = e % PK_TM, m = m0 + t;
    float v = 0.f;
    if (c < N && m < K2) {
      const int k = m < K ? m : m - K;
      float co, s;
      if (DBL) dbl_row(tab_c, tab_s, PK_TM, t, c, co, s);
      else sincosf(__fmul_rn(pos_a[c], __fmul_rn((float)k, kscale)), &s, &co);
      const float sp = spec[k];
      v = m < K ? rnd<BF16>(sp * co) : rnd<BF16>(-sp * s);
    }
    t2[e] = v;
  }

  float kf[4];
  bool im[4], valid[4];
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + 4 * tx + j;
    valid[j] = m < K2;
    im[j] = m >= K;
    kf[j] = __fmul_rn((float)(im[j] ? m - K : m), kscale);
  }
  const float* fb = f + (size_t)b * N * N;
  float r1[4] = {0.f, 0.f, 0.f, 0.f}, r2[4] = {0.f, 0.f, 0.f, 0.f};

  for (int r0 = 0; r0 < N; r0 += TR) {
    float g[4][4] = {};
    for (int c0 = 0; c0 < N; c0 += TC) {
      __syncthreads();
      for (int e = tid; e < TR * TC; e += THREADS) {
        int r, c;
        if (sc == 1) { c = e % TC; r = e / TC; }
        else         { r = e % TR; c = e / TR; }
        const int rr = r0 + r, cc = c0 + c;
        const float v = (rr < N && cc < N) ? fb[(size_t)rr * sr + (size_t)cc * sc] : 0.f;
        f_s[c * LD + r] = rnd<BF16>(v);
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < TC; ++c) {
        const float4 fv = *reinterpret_cast<const float4*>(&f_s[c * LD + 4 * ty]);
        const float4 tv = *reinterpret_cast<const float4*>(&t2[(c0 + c) * PK_TM + 4 * tx]);
        const float fr[4] = {fv.x, fv.y, fv.z, fv.w};
        const float tt[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] += fr[i] * tt[j];
      }
    }
    // stage 2 folded into the two packed rows: [pc | −ps] and [ps | pc]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      if (r >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!valid[j]) continue;
        float c, s;
        if (DBL) dbl_row(tab_c + fam, tab_s + fam, PK_TM, 4 * tx + j, r, c, s);
        else sincosf(__fmul_rn(shift_a[r], kf[j]), &s, &c);
        const float pc = rnd<BF16>(c), ps = rnd<BF16>(s);
        r1[j] += g[i][j] * (im[j] ? -ps : pc);
        r2[j] += g[i][j] * (im[j] ? pc : ps);
      }
    }
  }

  __syncthreads();
  float* red = f_s;  // TC * LD >= 2048 floats = 16 * 16 * 8
  float* mine = red + (ty * 16 + tx) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) { mine[j] = r1[j]; mine[4 + j] = r2[j]; }
  __syncthreads();
  if (tid < 16 * 8) {
    const int ox = tid >> 3, v = tid & 7;
    float acc = 0.f;
    for (int y = 0; y < 16; ++y) acc += red[(y * 16 + ox) * 8 + v];
    const int m = m0 + 4 * ox + (v & 3);
    if (m < K2) rows[((size_t)b * A + a) * 2 * K2 + (v >> 2) * K2 + m] = acc;
  }
}

// Packed forward stage 3: out[row, s] = Σ_q rows[row, q] W4[q, s], W4 =
// [Wc; Wc; −Ws; −Ws], for ST_ROWS rows per block. grid (ceil(rows/ST_ROWS),
// ceil(S/THREADS)).
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
packed_fwd_stage3(const float* __restrict__ rows4, const float* __restrict__ Wc,
                  const float* __restrict__ Ws, float* __restrict__ out, int rows, int K,
                  int S) {
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [ST_ROWS][4K]
  const int K4 = 4 * K;
  const int row0 = blockIdx.x * ST_ROWS;
  const int nr = min(ST_ROWS, rows - row0);
  const float* src = rows4 + (size_t)row0 * K4;
  for (int e = threadIdx.x; e < ST_ROWS * K4; e += THREADS)
    s_s[e] = e < nr * K4 ? rnd<BF16>(src[e]) : 0.f;
  __syncthreads();
  const int s = blockIdx.y * THREADS + threadIdx.x;
  if (s >= S) return;
  float acc[ST_ROWS] = {};
  for (int q = 0; q < K4; ++q) {
    const int k = q % K;
    const float w = q < 2 * K ? rnd<BF16>(Wc[(size_t)k * S + s])
                              : -rnd<BF16>(Ws[(size_t)k * S + s]);
#pragma unroll
    for (int r = 0; r < ST_ROWS; ++r) acc[r] += s_s[r * K4 + q] * w;
  }
  for (int r = 0; r < nr; ++r) out[(size_t)(row0 + r) * S + s] = acc[r];
}

// Packed adjoint stage 3ᵀ: shat[row, k] = (Σ_s p Wc[k, s], −Σ_s p Ws[k, s]),
// unrounded (the packed body keeps Ŝ in f32). One warp per k, lanes over s.
// grid (ceil(rows/ST_ROWS), ceil(K/ST3T_TK)).
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
packed_adj_stage3t(const float* __restrict__ p, const float* __restrict__ Wc,
                   const float* __restrict__ Ws, float* __restrict__ shat, int rows,
                   int K, int S) {
  extern __shared__ float4 smem4[];
  float* p_s = reinterpret_cast<float*>(smem4);  // [ST_ROWS][S]
  const int row0 = blockIdx.x * ST_ROWS;
  const int nr = min(ST_ROWS, rows - row0);
  const float* src = p + (size_t)row0 * S;
  for (int e = threadIdx.x; e < ST_ROWS * S; e += THREADS)
    p_s[e] = e < nr * S ? rnd<BF16>(src[e]) : 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kk = warp; kk < ST3T_TK; kk += THREADS / 32) {
    const int k = blockIdx.y * ST3T_TK + kk;
    if (k >= K) break;
    const float* w_c = Wc + (size_t)k * S;
    const float* w_s = Ws + (size_t)k * S;
    float re[ST_ROWS] = {}, imv[ST_ROWS] = {};
    for (int s = lane; s < S; s += 32) {
      const float wc = rnd<BF16>(w_c[s]), ws = rnd<BF16>(w_s[s]);
#pragma unroll
      for (int r = 0; r < ST_ROWS; ++r) {
        re[r] += p_s[r * S + s] * wc;
        imv[r] += p_s[r * S + s] * ws;
      }
    }
#pragma unroll
    for (int r = 0; r < ST_ROWS; ++r) {
      for (int off = 16; off > 0; off >>= 1) {
        re[r] += __shfl_xor_sync(0xffffffffu, re[r], off);
        imv[r] += __shfl_xor_sync(0xffffffffu, imv[r], off);
      }
    }
    if (lane < nr) {
      float vr = 0.f, vi = 0.f;
#pragma unroll
      for (int r = 0; r < ST_ROWS; ++r)
        if (r == lane) { vr = re[r]; vi = imv[r]; }
      float* dst = shat + ((size_t)(row0 + lane) * K + k) * 2;
      dst[0] = vr;
      dst[1] = -vi;
    }
  }
}

// Packed adjoint stages 2ᵀ + 1ᵀ: one 64x64 output tile of one image over the
// angle slice [A·g/G, A·(g+1)/G), contracting the packed 2K in chunks of 32.
// grid (ceil(N/64), ceil(N/64), B·G). With G = 1 the tile goes to out, else
// to part[g].
template <bool BF16, bool DBL>
__global__ void __launch_bounds__(THREADS)
packed_adj_stage21(const float* __restrict__ shat, const float* __restrict__ pos,
                   const float* __restrict__ shift, const float* __restrict__ spec,
                   float* __restrict__ dst, int B, int N, int A, int K, int G, int nb,
                   float kscale, int sr, int sc) {
  __shared__ __align__(16) float h_s[AD_TM][AD_T];
  __shared__ __align__(16) float t_s[AD_TM][AD_T];
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [K][2] of the current angle
  float* tab_c = s_s + 2 * K;                    // doubling: [2][nb+1][AD_TM]
  float* tab_s = tab_c + 2 * (nb + 1) * AD_TM;
  const int fam = (nb + 1) * AD_TM;

  const int K2 = 2 * K;
  const int c0 = blockIdx.x * AD_T;
  const int r0 = blockIdx.y * AD_T;
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
    for (int e = tid; e < 2 * K; e += THREADS) s_s[e] = src[e];
    const float* pos_a = pos + (size_t)a * N;
    const float* shift_a = shift + (size_t)a * N;
    for (int m0 = 0; m0 < K2; m0 += AD_TM) {
      __syncthreads();  // s_s loaded / previous chunk consumed
      if (DBL) {
        for (int e = tid; e < 2 * AD_TM; e += THREADS) {
          const int fm = e / AD_TM, t = e % AD_TM;
          const int m = min(m0 + t, K2 - 1), k = m < K ? m : m - K;
          const float* row = fm == 0 ? pos_a : shift_a;
          const float kf = __fmul_rn((float)k, kscale);
          const float r1 = N > 1 ? row[1] : row[0];
          build_rotors(__fmul_rn(row[0], kf), __fmul_rn(__fsub_rn(r1, row[0]), kf), nb,
                       AD_TM, t, tab_c + fm * fam, tab_s + fm * fam);
        }
        __syncthreads();
      }
      for (int e = tid; e < AD_TM * AD_T; e += THREADS) {
        const int mm = e / AD_T, x = e % AD_T;
        const int m = m0 + mm;
        float hv = 0.f, tv = 0.f;
        if (m < K2) {
          const int k = m < K ? m : m - K;
          const float kf = __fmul_rn((float)k, kscale);
          const int r = r0 + x;
          if (r < N) {
            float s, c;
            if (DBL) dbl_row(tab_c + fam, tab_s + fam, AD_TM, mm, r, c, s);
            else sincosf(__fmul_rn(shift_a[r], kf), &s, &c);
            const float pc = rnd<BF16>(c), ps = rnd<BF16>(s);
            const float sre = s_s[2 * k], sim = s_s[2 * k + 1];
            hv = m < K ? rnd<BF16>(sre * pc + sim * ps) : rnd<BF16>(-(sre * ps) + sim * pc);
          }
          const int cc = c0 + x;
          if (cc < N) {
            float s, c;
            if (DBL) dbl_row(tab_c, tab_s, AD_TM, mm, cc, c, s);
            else sincosf(__fmul_rn(pos_a[cc], kf), &s, &c);
            const float sp = spec[k];
            tv = m < K ? rnd<BF16>(sp * c) : rnd<BF16>(-sp * s);
          }
        }
        h_s[mm][x] = hv;
        t_s[mm][x] = tv;
      }
      __syncthreads();
#pragma unroll 4
      for (int mm = 0; mm < AD_TM; ++mm) {
        const float4 hh = *reinterpret_cast<const float4*>(&h_s[mm][4 * ty]);
        const float4 tt = *reinterpret_cast<const float4*>(&t_s[mm][4 * tx]);
        const float hr[4] = {hh.x, hh.y, hh.z, hh.w};
        const float tr[4] = {tt.x, tt.y, tt.z, tt.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += hr[i] * tr[j];
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
__global__ void __launch_bounds__(THREADS)
packed_adj_reduce(const float* __restrict__ part, float* __restrict__ out, size_t n, int G) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += part[(size_t)g * n + i];
    out[i] = acc;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool BF16, int MODE>
cudaError_t launch_pair(const float* f, const float* pos, const float* sha,
                        const float* shb, const float* seeds0, const float* steps,
                        const float* sgn, const float* spec, const float* Wc,
                        const float* Ws, float* shat, float* out, int B, int N, int P,
                        int K, int S, float kscale, int sr, int sc, cudaStream_t stream) {
  const int Npad = ceil_div(N, TC) * TC;
  const int nb = MODE == DOUBLING ? levels(N) : 0;
  const size_t tab = MODE == DOUBLING ? (size_t)2 * 3 * (nb + 1) * TK : 0;
  const size_t smem12 = (2 * (size_t)Npad * TK + TC * LD + tab) * sizeof(float);
  cudaError_t err = set_smem((const void*)pair_proto_stage12<BF16, MODE>, smem12);
  if (err != cudaSuccess) return err;
  pair_proto_stage12<BF16, MODE><<<dim3(ceil_div(K, TK), P, B), THREADS, smem12, stream>>>(
      f, pos, sha, shb, seeds0, steps, sgn, spec, shat, N, P, K, nb, kscale, sr, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem3 = (size_t)2 * K * sizeof(float);
  err = set_smem((const void*)pair_proto_stage3<BF16>, smem3);
  if (err != cudaSuccess) return err;
  pair_proto_stage3<BF16><<<dim3(2 * P, B), THREADS, smem3, stream>>>(shat, Wc, Ws, out,
                                                                      2 * P, K, S);
  return cudaGetLastError();
}

template <bool BF16, bool DBL>
cudaError_t launch_packed_project(const float* f, const float* pos, const float* shift,
                                  const float* spec, const float* Wc, const float* Ws,
                                  float* rows4, float* out, int B, int N, int A, int K,
                                  int S, float kscale, int sr, int sc,
                                  cudaStream_t stream) {
  const int Npad = ceil_div(N, TC) * TC;
  const int nb = DBL ? levels(N) : 0;
  const size_t tab = DBL ? (size_t)2 * 2 * (nb + 1) * PK_TM : 0;
  const size_t smem12 = ((size_t)Npad * PK_TM + TC * LD + tab) * sizeof(float);
  cudaError_t err = set_smem((const void*)packed_fwd_stage12<BF16, DBL>, smem12);
  if (err != cudaSuccess) return err;
  packed_fwd_stage12<BF16, DBL><<<dim3(ceil_div(2 * K, PK_TM), A, B), THREADS, smem12,
                                  stream>>>(f, pos, shift, spec, rows4, N, A, K, nb,
                                            kscale, sr, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * A;
  const size_t smem3 = (size_t)ST_ROWS * 4 * K * sizeof(float);
  err = set_smem((const void*)packed_fwd_stage3<BF16>, smem3);
  if (err != cudaSuccess) return err;
  packed_fwd_stage3<BF16><<<dim3(ceil_div(rows, ST_ROWS), ceil_div(S, THREADS)), THREADS,
                            smem3, stream>>>(rows4, Wc, Ws, out, rows, K, S);
  return cudaGetLastError();
}

template <bool BF16, bool DBL>
cudaError_t launch_packed_backproject(const float* p, const float* pos, const float* shift,
                                      const float* spec, const float* Wc, const float* Ws,
                                      float* shat, float* part, float* out, int B, int N,
                                      int A, int K, int S, int G, float kscale, int sr,
                                      int sc, cudaStream_t stream) {
  const int rows = B * A;
  const size_t smem3 = (size_t)ST_ROWS * S * sizeof(float);
  cudaError_t err = set_smem((const void*)packed_adj_stage3t<BF16>, smem3);
  if (err != cudaSuccess) return err;
  packed_adj_stage3t<BF16><<<dim3(ceil_div(rows, ST_ROWS), ceil_div(K, ST3T_TK)), THREADS,
                             smem3, stream>>>(p, Wc, Ws, shat, rows, K, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nb = DBL ? levels(N) : 0;
  const size_t tab = DBL ? (size_t)2 * 2 * (nb + 1) * AD_TM : 0;
  const size_t smem21 = ((size_t)2 * K + tab) * sizeof(float);
  err = set_smem((const void*)packed_adj_stage21<BF16, DBL>, smem21);
  if (err != cudaSuccess) return err;
  const int tiles = ceil_div(N, AD_T);
  packed_adj_stage21<BF16, DBL><<<dim3(tiles, tiles, B * G), THREADS, smem21, stream>>>(
      shat, pos, shift, spec, G > 1 ? part : out, B, N, A, K, G, nb, kscale, sr, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return err;
  const size_t n = (size_t)B * N * N;
  const size_t want = (n + THREADS - 1) / THREADS;
  packed_adj_reduce<<<(int)(want < 4096 ? want : 4096), THREADS, 0, stream>>>(part, out,
                                                                             n, G);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device pointer to
// contiguous float32 (part may be null when G = 1); the stream is a
// cudaStream_t. Returns the cudaError_t of the launches (0 on success).
// Nothing here synchronises or allocates: shat, rows and part are scratch
// from the caller. seeds0 / steps are (P, 3K): [pos | sha | shb] families.
extern "C" int radon_proto_pairdoubling(const float* f, const float* seeds0,
                                        const float* steps, const float* sgn,
                                        const float* spec, const float* Wc,
                                        const float* Ws, float* shat, float* out, int B,
                                        int N, int P, int K, int S, int contract_x,
                                        int bf16, void* stream) {
  const int sr = contract_x ? N : 1, sc = contract_x ? 1 : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the doubling kernel reads no plan rows: its seeds replace them
  cudaError_t err = bf16
      ? launch_pair<true, DOUBLING>(f, nullptr, nullptr, nullptr, seeds0, steps, sgn, spec,
                                    Wc, Ws, shat, out, B, N, P, K, S, 0.f, sr, sc, st)
      : launch_pair<false, DOUBLING>(f, nullptr, nullptr, nullptr, seeds0, steps, sgn,
                                     spec, Wc, Ws, shat, out, B, N, P, K, S, 0.f, sr, sc,
                                     st);
  return static_cast<int>(err);
}

extern "C" int radon_proto_pairnotrig(const float* f, const float* pos, const float* sha,
                                      const float* shb, const float* sgn,
                                      const float* spec, const float* Wc, const float* Ws,
                                      float* shat, float* out, int B, int N, int P, int K,
                                      int S, float kscale, int contract_x, int bf16,
                                      void* stream) {
  const int sr = contract_x ? N : 1, sc = contract_x ? 1 : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16
      ? launch_pair<true, NOTRIG>(f, pos, sha, shb, nullptr, nullptr, sgn, spec, Wc, Ws,
                                  shat, out, B, N, P, K, S, kscale, sr, sc, st)
      : launch_pair<false, NOTRIG>(f, pos, sha, shb, nullptr, nullptr, sgn, spec, Wc, Ws,
                                   shat, out, B, N, P, K, S, kscale, sr, sc, st);
  return static_cast<int>(err);
}

extern "C" int radon_proto_packedproject(const float* f, const float* pos,
                                         const float* shift, const float* spec,
                                         const float* Wc, const float* Ws, float* rows4,
                                         float* out, int B, int N, int A, int K, int S,
                                         float kscale, int contract_x, int bf16,
                                         int doubling, void* stream) {
  const int sr = contract_x ? N : 1, sc = contract_x ? 1 : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 && doubling)
    err = launch_packed_project<true, true>(f, pos, shift, spec, Wc, Ws, rows4, out, B, N,
                                            A, K, S, kscale, sr, sc, st);
  else if (bf16)
    err = launch_packed_project<true, false>(f, pos, shift, spec, Wc, Ws, rows4, out, B,
                                             N, A, K, S, kscale, sr, sc, st);
  else if (doubling)
    err = launch_packed_project<false, true>(f, pos, shift, spec, Wc, Ws, rows4, out, B,
                                             N, A, K, S, kscale, sr, sc, st);
  else
    err = launch_packed_project<false, false>(f, pos, shift, spec, Wc, Ws, rows4, out, B,
                                              N, A, K, S, kscale, sr, sc, st);
  return static_cast<int>(err);
}

extern "C" int radon_proto_packedbackproject(const float* p, const float* pos,
                                             const float* shift, const float* spec,
                                             const float* Wc, const float* Ws, float* shat,
                                             float* part, float* out, int B, int N, int A,
                                             int K, int S, int G, float kscale,
                                             int contract_x, int bf16, int doubling,
                                             void* stream) {
  if (G < 1 || (G > 1 && part == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int sr = contract_x ? N : 1, sc = contract_x ? 1 : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 && doubling)
    err = launch_packed_backproject<true, true>(p, pos, shift, spec, Wc, Ws, shat, part,
                                                out, B, N, A, K, S, G, kscale, sr, sc, st);
  else if (bf16)
    err = launch_packed_backproject<true, false>(p, pos, shift, spec, Wc, Ws, shat, part,
                                                 out, B, N, A, K, S, G, kscale, sr, sc, st);
  else if (doubling)
    err = launch_packed_backproject<false, true>(p, pos, shift, spec, Wc, Ws, shat, part,
                                                 out, B, N, A, K, S, G, kscale, sr, sc, st);
  else
    err = launch_packed_backproject<false, false>(p, pos, shift, spec, Wc, Ws, shat, part,
                                                  out, B, N, A, K, S, G, kscale, sr, sc,
                                                  st);
  return static_cast<int>(err);
}
