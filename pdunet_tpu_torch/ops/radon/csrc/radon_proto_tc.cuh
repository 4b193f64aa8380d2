// Machinery shared by the probe kernels that make their trig on chip on
// Hopper's tensor cores: radon_proto_tc.cu (the packed per-angle probe, row
// 6) and radon_pair_proto_tc.cu (the mirror-pair trig probe, row 5). Both
// include this file; the notes on what each replaces and what bounds it
// are there. Nothing in radon_tc.cuh's shipped kernels calls it.
//
// Block doubling: the rows j of e^{iθ(j, k)}, θ = th0(k) + j·dth(k), are
// the seed e^{i·th0} rotated by the rotors R_{2^b} = e^{i·2^b·dth} of j's
// set bits, lowest first; the rotors come by repeated squaring of
// e^{i·dth}. These are doubling_trig_rows' products in its order (rows
// [n, 2n) = rows [0, n)·R_n), every product __fmul_rn / __fadd_rn /
// __fsub_rn so that no FMA contraction moves a rounding; the seed and the
// first rotor are precise sincosf (no fast math).

#pragma once

#include "radon_tc.cuh"

namespace {

constexpr int PT_DW_MAX = 256;            // forward: T̂ rows a block holds
constexpr uint32_t PT_PLANE = 16384;      // a 64-deep x 128 bf16 plane, or a 128 x 64 A tile
constexpr int PT_FW_K = FW_BN / 2;        // frequencies per forward column tile

int levels(int N) {  // rotor levels the doubling needs for rows up to N − 1
  int nb = 0;
  while ((1 << nb) < N) ++nb;
  return nb;
}

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }
__host__ __device__ constexpr int pt_parts(bool split) { return split ? 2 : 1; }

// Doubling rotors of one frequency column t of a table W wide: level 0 the
// seed (cos, sin)(th0), level b + 1 the rotor R_{2^b}.
__device__ __forceinline__ void pt_rotors(float th0, float dth, int nb, int W, int t,
                                          float2* __restrict__ tab) {
  float s, c;
  sincosf(th0, &s, &c);
  tab[t] = make_float2(c, s);
  float rs, rc;
  sincosf(dth, &rs, &rc);
  for (int b = 0; b < nb; ++b) {
    tab[(b + 1) * W + t] = make_float2(rc, rs);
    const float rc2 = __fsub_rn(__fmul_rn(rc, rc), __fmul_rn(rs, rs));
    rs = __fmul_rn(__fmul_rn(2.f, rc), rs);
    rc = rc2;
  }
}

__device__ __forceinline__ float2 pt_cmul(float2 v, float2 r) {
  return make_float2(__fsub_rn(__fmul_rn(v.x, r.x), __fmul_rn(v.y, r.y)),
                     __fadd_rn(__fmul_rn(v.x, r.y), __fmul_rn(v.y, r.x)));
}

// (cos, sin) of the U rows hi + lo + 2^LO_BITS·u (u < U, a power of two;
// lo < 2^LO_BITS; hi a multiple of 2^LO_BITS·U) of frequency column t of a
// rotor table W wide: the seed rotated by the rotors of each row's set
// bits, lowest first — lo's, then u's, then hi's. The rows share lo's
// chain, and row 2^l + u is row u times one rotor (rows [n, 2n) = rows
// [0, n)·R_n), so U rows cost LO_BITS + U − 1 + U·(hi's set bits) complex
// products, in a fixed order with no data-dependent loop (the products of
// a thread's columns interleave). Levels past nb (rows ≥ 2^nb ≥ N, never
// used) are skipped.
template <int LO_BITS, int U>
__device__ __forceinline__ void pt_dbl_rows(const float2* __restrict__ tab, int W, int t,
                                            int lo, int hi, int nb, float2 (&rows)[U]) {
  float2 v = tab[t];
#pragma unroll
  for (int b = 0; b < LO_BITS; ++b) {
    if (b < nb) {
      const float2 r = tab[(b + 1) * W + t];
      const float2 w = pt_cmul(v, r);
      v = (lo >> b) & 1 ? w : v;
    }
  }
  rows[0] = v;
#pragma unroll
  for (int l = 0; (1 << l) < U; ++l) {
    if (LO_BITS + l < nb) {
      const float2 r = tab[(LO_BITS + l + 1) * W + t];
#pragma unroll
      for (int u = 0; u < (1 << l); ++u) rows[(1 << l) + u] = pt_cmul(rows[u], r);
    } else {
#pragma unroll
      for (int u = 0; u < (1 << l); ++u) rows[(1 << l) + u] = rows[u];
    }
  }
  for (int b = LO_BITS + ilog2(U); b < nb; ++b) {
    if ((hi >> b) & 1) {
      const float2 r = tab[(b + 1) * W + t];
#pragma unroll
      for (int u = 0; u < U; ++u) rows[u] = pt_cmul(rows[u], r);
    }
  }
}

// (re, im) as one bf16 pair, or (SPLIT) as hi and lo pairs
template <bool SPLIT>
__device__ __forceinline__ void pt_pack(float re, float im, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    f2_split(re, im, hi, lo);
  } else {
    hi = f2_to_bf2(re, im);
    lo = 0u;
  }
}

cudaError_t sm_count(int& n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace
