// The packed per-angle probe kernels on Hopper's tensor cores (sm_90a),
// with T̂ and φ made on chip: the route that project_group_packed /
// backproject_group_packed take on a CUDA tensor.
//
// Replaces the Pallas TPU kernels of the JAX package's probe script:
//   proto_tc_fwd{,_dbl}, proto_split_fwd <- scripts/pack_proto.py::call_fwd
//                                          (body _fwd_kernel_packed)
//   proto_tc_adj{,_dbl}, proto_split_adj <- scripts/pack_proto.py::call_adj
//                                          (body _adj_kernel_packed)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/proto_kernels.py
// (_project_group_packed / _backproject_group_packed).
//
// The function (per angle a of one group, K frequencies, S bins):
//   stage 1   ĝ = F·[T̂c | T̂s], one product 2K wide;
//   stage 2   per k the four sums Σ_r gr·φc, −Σ_r gi·φs, Σ_r gr·φs,
//             Σ_r gi·φc, each rounded on its own (the packed rows
//             [row1 | row2]);
//   stage 3   one 4K-deep product against [Wc; Wc; −Ws; −Ws];
// and its transpose: Ŝ = (p·Wcᵀ, −p·Wsᵀ) unrounded, h = [h_re | h_im]
// rounded, one 2K-deep contraction against [T̂c | T̂s].
//
// Trig. No table is read: the kernels take the plan's pos / shift rows
// (A, N) and spec (K). The float32 route makes exact trig only (doubling's
// ~N·eps_f32 drift is above its contract), the bf16 route either. Exact
// trig is precise sincosf of
// __fmul_rn(row[j], __fmul_rn(k, kscale)), as tc_trig forms it, so T̂ and
// φ equal the per-plan tables bit for bit. Block doubling (the rule of the
// bf16 operands, `doubling`) rotates the seed e^{i·row[0]·kf} by the
// rotors R_{2^b} of j's set bits, lowest first: rotors by repeated
// squaring of e^{i·(row[1] − row[0])·kf}, every product __fmul_rn /
// __fadd_rn / __fsub_rn. A thread makes the rows of one frequency column
// as a tree (pt_dbl_rows): its rows share the chain of their low bits, and
// each further row is an earlier one times one rotor. These are
// doubling_trig_rows' products in its order (rows [n, 2n) = rows [0,
// n)·R_n), at about one complex product per element, in a fixed order
// whose chains of a thread's four frequencies interleave. A CPU
// transcription of the tree equals doubling_trig_rows bit for bit
// (tests/test_torch_proto_tc.py); the kernel's seeds and rotor steps come
// from sincosf where the plain version calls torch.cos / torch.sin, and on
// the card the kernel is held against the plain version through its
// output only.
//
// Forward (stages 1+2). The work is a list of items (angle a, 128-column
// tile ct of interleaved (k, re/im), depth window w, row tile rt, image
// b), ordered with (a, ct, w) outermost and rt before b. A persistent grid
// of as many blocks as the SMs hold at once (256 threads, two warpgroups
// each) gives each block a contiguous run of items. Whenever the run enters a new (a, ct, w) the block computes T̂
// for the window's Dw rows and 128 columns into shared memory, in the
// MN-major 128-byte-swizzled layout wgmma reads (swz), and keeps it for
// every image and row tile that follow: each T̂ element is computed once
// per block whose run touches its (a, ct, w), at most ⌈B·R / items per
// block⌉ + 1 times per call, and once when a block's run holds the whole
// group. φ is computed in registers, for the accumulator rows of the
// thread (two per warp row) and its 16 frequencies, whenever rt changes;
// the accumulator's adjacent pair is (re, im) of one k for one row, so the
// epilogue applies φ there, reduces over the tile's rows (shuffles, then
// shared memory) and writes one partial of the four sums per (w, rt). F
// (zero-padded to Np and transposed for the y group by tc_prep) streams
// through a two-stage cp.async ring of 64-deep A tiles; the ring runs
// across items, so the next item's first tile lands during this item's
// epilogue, whose reduction buffer is the stage the item's last tile used.
// Shared memory (N = 256, Dw = Np = 256; rotors only with doubling,
// nb = ⌈log2 N⌉ = 8):
//   bf16 : T̂ 256 x 128 bf16 64 KB + 2 F stages x 16 KB + rotors 2 x 9 x 64
//          x 8 B 9 KB + 1 KB alignment = 106 KB: two blocks per SM (128
//          registers a thread), so one block's epilogue and T̂ / φ work
//          overlap the other's products;
//   split: T̂ hi + lo 128 KB + 2 F stages (hi + lo) x 32 KB + 1 KB = 193
//          KB, one block per SM. A third F stage (32 KB) beside the
//          whole-depth T̂ and the rotors would not fit in 227 KB.
// Depth windows: Dw is the largest multiple of 128 that divides Np and is
// at most 256, so N > 256 runs in Np/Dw windows whose partials are summed
// with the row tiles' in a fixed order.
//
// Adjoint (stages 2ᵀ + 1ᵀ). As tc_adj / tc_adj_split: one block per
// (128 image rows, BN image columns, depth slice) with BN = 256 (bf16) or
// 128 (split), the slices chosen by the wrapper (group_adjoint_splits) so
// that one wave of one block per SM runs, partial images summed by
// tc_reduce in slice order (no atomics). The depth is the angles' 64-deep
// chunks of (k, re/im) in order. For chunk i+1 all threads compute the T̂
// chunk (the K-major B operand, [BN columns][64]) and h (the A operand,
// [128 rows][64], φ computed in registers on the way) straight into the
// other of two shared-memory stages while the tensor cores run chunk i.
// A block cannot keep T̂ across images: each T̂ element is computed once per
// (image, row tile, column tile) block, B·⌈N/128⌉ times per call, and each
// φ element ⌈N/BN⌉·B times.
// Shared memory: bf16 2 x (T̂ 32 KB + h 16 KB) = 96 KB; split 2 x (T̂ hi +
// lo 32 KB + h hi + lo 32 KB) = 128 KB; plus rotors (doubling) 2 x 2 x 9 x
// 32 x 8 B = 9 KB and 1 KB alignment.
//
// Stage 3 and 3ᵀ: bf16, tensor-core GEMMs (tc_gemm) over the rounded four
// sums (tc_sum_round_pad of the partials) against W4 (4Kp x Sp, row 4k + t
// = Wc[k], Wc[k], −Ws[k], −Ws[k]; proto_tc_w4_prep), and rnd(p) against
// tc_w_prep's interleaved W' without rounding Ŝ. Split (f32): on the CUDA
// cores, pair_stage3 / pair_stage3t<1> without rounding, as
// radon_group_split.cu (the four sums are kept as the two (re, im) sums;
// nothing is rounded in f32).
//
// bf16 operands: wgmma bf16 with f32 accumulators. f32 operands: split
// bf16 (hi·hi + hi·lo + lo·hi, radon_tc.cuh), every generated value split
// into hi and lo as it is written; the adjoint adds each chunk's products
// to an f32 sum on the CUDA cores, as tc_adj_split does.
//
// What bounds them on an H100: the forward reads no table, only F tiles
// (L2) and the plan rows; its trig is paid once per (angle, tile) group.
// The adjoint's trig is paid per block (above), about one precise
// sincosf, or one complex product (doubling), per T̂ and φ element of every
// chunk, which paces it. The measured times against the routes that read
// the tables are in PERF.md §6.
//
// Test-only build flag PROTO_TC_TABLE_PROBE: compiles three variants of a
// copy of tc_adj_split<1>'s body (the shipped split adjoint's stages 2ᵀ +
// 1ᵀ). proto_split_adj_copy reads the real per-chunk tables, as the
// shipped kernel does: it is an adjoint, and times the copy's own code
// beside the original. The other two give numbers that are not an
// adjoint: proto_split_adj_onetile reads its T̂ hi/lo and φ cp.asyncs from
// one fixed chunk of the tables (angle 0, k-chunk 0) for every chunk, so
// the table bytes still cross from L2 to the SMs but stay resident there;
// proto_split_adj_notable issues none of them, so no table byte moves. No
// wrapper or path calls them.

#include "radon_proto_tc.cuh"

namespace {

// forward F ring: two stages, each chunk's products awaited before the
// barrier; the epilogue's reduction buffer is the stage the item's last
// chunk used. bf16 then fits two blocks per SM; split one (its whole-depth
// T̂ hi + lo leaves no room for more stages)
constexpr int PT_STAGES = 2;
constexpr int PT_AD_K = TC_BK / 2;        // frequencies per adjoint chunk

// forward partial sums per k: the four packed halves (bf16), (re, im) (split)
__host__ __device__ constexpr int pt_sums(bool split) { return split ? 2 : 4; }

size_t pt_fwd_smem(bool split, bool dbl, int Dw, int nb) {
  return (size_t)(Dw / TC_BK + PT_STAGES) * pt_parts(split) * PT_PLANE +
         (dbl ? (size_t)2 * (nb + 1) * PT_FW_K * sizeof(float2) : 0) + 1024;
}

size_t pt_adj_smem(bool split, bool dbl, int nb) {
  const int bn = split ? AS_BN : AD_BN;
  return (size_t)2 * pt_parts(split) * (bn * 128 + TC_BM * 128) +
         (dbl ? (size_t)2 * 2 * (nb + 1) * PT_AD_K * sizeof(float2) : 0) + 1024;
}

__device__ __forceinline__ float2 pt_exact(float x, float kf) {
  float s, c;
  sincosf(__fmul_rn(x, kf), &s, &c);
  return make_float2(c, s);
}

// the rotors of frequency k of one plan row (A, N)
__device__ __forceinline__ void pt_row_rotors(const float* __restrict__ row, int N, int k,
                                              float kscale, int nb, int W, int t,
                                              float2* __restrict__ tab) {
  const float kf = __fmul_rn((float)k, kscale);
  const float r0 = row[0], r1 = N > 1 ? row[1] : row[0];
  pt_rotors(__fmul_rn(r0, kf), __fmul_rn(__fsub_rn(r1, r0), kf), nb, W, t, tab);
}

// ---------------------------------------------------------------------------
// Forward stages 1+2 (header note). fb (PARTS, B, Np, Np) bf16; part (Np/Dw
// · R, B, A, NS·K) f32, NS = pt_sums; grid ≤ items, TC_THREADS threads,
// pt_fwd_smem bytes of dynamic shared memory.
// ---------------------------------------------------------------------------
template <bool SPLIT, bool DBL>
__device__ __forceinline__ void pt_fwd(const __nv_bfloat16* __restrict__ fb,
                                       const float* __restrict__ pos,
                                       const float* __restrict__ shift,
                                       const float* __restrict__ spec, float* __restrict__ part,
                                       int B, int N, int Np, int A, int K, int K2p, int Dw,
                                       int nb, float kscale) {
  constexpr int PARTS = pt_parts(SPLIT);
  constexpr int STAGES = PT_STAGES;
  constexpr int NS = pt_sums(SPLIT);
  constexpr uint32_t CH = PARTS * PT_PLANE;  // a T̂ chunk or a ring stage, hi (and lo)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sgen = smem_raw + (base - raw);
  const int nkw = Dw / TC_BK;
  const uint32_t ring = base + nkw * CH;
  float2* rot = reinterpret_cast<float2*>(sgen + (nkw + STAGES) * CH);  // [pos, shift][nb+1][64]
  const int rot_fam = (nb + 1) * PT_FW_K;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n_ct = K2p / FW_BN, R = Np / TC_BM, nw = Np / Dw;
  const long long T = (long long)R * B;  // items per (angle, column tile, window)
  const long long U = (long long)A * n_ct * nw * T;
  const long long u_lo = U * blockIdx.x / gridDim.x;
  const long long u_hi = U * (blockIdx.x + 1) / gridDim.x;
  const long long q_end = (u_hi - u_lo) * nkw;
  const size_t plane = (size_t)B * Np * Np;

  // F chunk q of the run (item u_lo + q / nkw, 64-deep chunk q % nkw) into
  // its ring stage; one commit group per chunk, empty past the end
  auto load = [&](long long q) {
    if (q < q_end) {
      const long long u = u_lo + q / nkw;
      const int kc = (int)(q % nkw);
      const int tile = (int)(u % T), w = (int)((u / T) % nw);
      const int rt = tile / B, b = tile % B;
      const __nv_bfloat16* Ap =
          fb + ((size_t)b * Np + (size_t)rt * TC_BM) * Np + (size_t)w * Dw + kc * TC_BK;
      const uint32_t st = ring + (uint32_t)(q % STAGES) * CH;
#pragma unroll
      for (int h = 0; h < PARTS; ++h)
        for (int e = tid; e < TC_BM * 8; e += TC_THREADS) {
          const int m = e >> 3, j = e & 7;
          cp_async16(st + h * PT_PLANE + swz(m, j), Ap + h * plane + (size_t)m * Np + j * 8, 16);
        }
    }
    cp_async_commit();
  };

  // T̂ of angle a, frequencies [k0, k0 + 64), rows [r0, r0 + Dw): chunk
  // c / 64 at base, each plane [2 blocks of 64 columns][64 rows][128 B].
  // A thread makes column unit n8 = tid % 16 (frequencies k0 + 4·n8 + q)
  // of rows r0 + 128h + tid/16 + 16u (u < 8), one (re, im) pair at a time.
  auto build_t = [&](int a, int k0, int r0) {
    const float* prow = pos + (size_t)a * N;
    const int n8 = tid & 15, lo = tid >> 4;
    for (int h = 0; h < Dw / TC_BM; ++h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kl = n8 * 4 + q, k = k0 + kl;
        const float kf = __fmul_rn((float)k, kscale);
        const float sp = k < K ? __ldg(spec + k) : 0.f;
        float2 cs[8];
        if constexpr (DBL) pt_dbl_rows<4, 8>(rot, PT_FW_K, kl, lo, r0 + TC_BM * h, nb, cs);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int cl = TC_BM * h + lo + 16 * u, c = r0 + cl;
          float re = 0.f, im = 0.f;
          if (c < N && k < K) {
            const float2 v = DBL ? cs[u] : pt_exact(prow[c], kf);
            re = sp * v.x;
            im = -sp * v.y;
          }
          uint32_t hv, lv;
          pt_pack<SPLIT>(re, im, hv, lv);
          const uint32_t off =
              (cl >> 6) * CH + (n8 >> 3) * (TC_BK * 128) + swz(cl & 63, n8 & 7) + 4 * q;
          *reinterpret_cast<uint32_t*>(sgen + off) = hv;
          if (SPLIT) *reinterpret_cast<uint32_t*>(sgen + off + PT_PLANE) = lv;
        }
      }
    }
  };

  // φ of this thread's accumulator rows (ra, ra + 8 of tile rt) and its 16
  // frequencies k0 + 4j + lane % 4: bf16 pairs (rounded), or f32 (split)
  float2 phf[SPLIT ? 2 : 1][SPLIT ? 16 : 1];
  uint32_t phb[SPLIT ? 1 : 2][SPLIT ? 1 : 16];
  auto build_phi = [&](int a, int k0, int rt) {
    const float* srow = shift + (size_t)a * N;
    const int hi = rt * TC_BM + wg * 64 + warp * 16, lo = lane >> 2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int kl = j * 4 + (lane & 3), k = k0 + kl;
      float2 cs[2];
      if constexpr (DBL) pt_dbl_rows<3, 2>(rot + rot_fam, PT_FW_K, kl, lo, hi, nb, cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = hi + lo + 8 * h;
        float2 v = make_float2(0.f, 0.f);
        if (r < N && k < K) v = DBL ? cs[h] : pt_exact(srow[r], __fmul_rn((float)k, kscale));
        if constexpr (SPLIT) phf[h][j] = v;
        else phb[h][j] = f2_to_bf2(v.x, v.y);
      }
    }
  };

  float acc[FW_BN / 2];
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  long long q = 0, prev_grp = -1;
  int prev_rt = -1;
  for (long long u = u_lo; u < u_hi; ++u) {
    const int tile = (int)(u % T);
    const long long grp = u / T;
    const int w = (int)(grp % nw), pair = (int)(grp / nw);
    const int a = pair / n_ct, k0 = (pair % n_ct) * PT_FW_K;
    const int rt = tile / B, b = tile % B;
    if (grp != prev_grp) {
      __syncthreads();  // every warpgroup is done with the old T̂ and rotors
      if (DBL) {
        if (tid < 2 * PT_FW_K) {
          const int fam = tid / PT_FW_K, t = tid % PT_FW_K;
          pt_row_rotors((fam ? shift : pos) + (size_t)a * N, N, k0 + t, kscale, nb, PT_FW_K, t,
                        rot + fam * rot_fam);
        }
        __syncthreads();
      }
      build_t(a, k0, w * Dw);  // visible to wgmma after the chunk loop's fence and barrier
      prev_grp = grp;
      prev_rt = -1;
    }
    if (rt != prev_rt) {
      build_phi(a, k0, rt);
      prev_rt = rt;
    }
#pragma unroll
    for (int i = 0; i < FW_BN / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < nkw; ++kc, ++q) {
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();
      __syncthreads();  // chunk q landed, T̂ written; chunk q−1's products done
      load(q + STAGES - 1);  // into the stage chunk q−1 used
      const uint32_t sa = ring + (uint32_t)(q % STAGES) * CH + wg * (64 * 128);
      const uint32_t sb = base + kc * CH;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TC_BK / 16; ++ks) {
        const uint64_t da = desc_sw128(sa + ks * 32, 16, 1024);
        const uint64_t db = desc_sw128(sb + ks * 2048, TC_BK * 128, 1024);
        wgmma_n128<1>(acc, da, db);
        if constexpr (SPLIT) {  // hi·lo, then lo·hi
          wgmma_n128<1>(acc, da, desc_sw128(sb + PT_PLANE + ks * 2048, TC_BK * 128, 1024));
          wgmma_n128<1>(acc, desc_sw128(sa + PT_PLANE + ks * 32, 16, 1024), db);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
    }

    // stage 2: this thread holds (gr, gi) of frequency k0 + 4j + lane % 4
    // for its rows ra (acc[4j], acc[4j+1]) and ra + 8 (acc[4j+2], acc[4j+3])
    // The reduction buffer, [64 k][NS] per warp, lies in the stage chunk
    // q − 1 used, each warp's within its own warpgroup's A rows (8 KB),
    // whose products that warpgroup has awaited; the next load into the
    // stage follows the next chunk's barrier.
    float* stage_f =
        reinterpret_cast<float*>(sgen + (ring - base) + (uint32_t)((q - 1) % STAGES) * CH);
    auto red_of = [&](int w8) { return stage_f + (w8 >> 2) * (64 * 128 / 4) + (w8 & 3) * PT_FW_K * NS; };
    float* myred = red_of(wg * 4 + warp);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float gr1 = acc[4 * j], gi1 = acc[4 * j + 1];
      const float gr2 = acc[4 * j + 2], gi2 = acc[4 * j + 3];
      float2 p1, p2;
      if constexpr (SPLIT) {
        p1 = phf[0][j];
        p2 = phf[1][j];
      } else {
        p1 = bf2_to_f2(phb[0][j]);
        p2 = bf2_to_f2(phb[1][j]);
      }
      float v[NS];
      if constexpr (SPLIT) {
        v[0] = (gr1 * p1.x - gi1 * p1.y) + (gr2 * p2.x - gi2 * p2.y);
        v[1] = (gr1 * p1.y + gi1 * p1.x) + (gr2 * p2.y + gi2 * p2.x);
      } else {
        v[0] = gr1 * p1.x + gr2 * p2.x;
        v[1] = gi1 * p1.y + gi2 * p2.y;  // negated when written
        v[2] = gr1 * p1.y + gr2 * p2.y;
        v[3] = gi1 * p1.x + gi2 * p2.x;
      }
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        v[t] += __shfl_xor_sync(0xffffffffu, v[t], 4);
        v[t] += __shfl_xor_sync(0xffffffffu, v[t], 8);
        v[t] += __shfl_xor_sync(0xffffffffu, v[t], 16);
      }
      if (lane < 4) {
#pragma unroll
        for (int t = 0; t < NS; ++t) myred[(j * 4 + lane) * NS + t] = v[t];
      }
    }
    __syncthreads();
    float* dstp = part + (((size_t)(w * R + rt) * B + b) * A + a) * ((size_t)NS * K);
    for (int e = tid; e < PT_FW_K * NS; e += TC_THREADS) {
      const int kl = e / NS, t = e % NS, k = k0 + kl;
      float s = 0.f;
      for (int wp = 0; wp < 8; ++wp) s += red_of(wp)[kl * NS + t];
      if (k < K) dstp[k * NS + t] = (!SPLIT && t == 1) ? -s : s;
    }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// Adjoint stages 2ᵀ + 1ᵀ (header note). shat (B, A, Kp, 2) f32 unrounded;
// grid (B·Np/TC_BM, ⌈N/BN⌉, G); TC_THREADS threads; pt_adj_smem bytes of
// dynamic shared memory. With G = 1 the tile goes to dst = out, else to
// dst = part[slice] (summed by tc_reduce).
// ---------------------------------------------------------------------------
template <bool SPLIT, bool DBL>
__device__ __forceinline__ void pt_adj(const float* __restrict__ shat,
                                       const float* __restrict__ pos,
                                       const float* __restrict__ shift,
                                       const float* __restrict__ spec, float* __restrict__ dst,
                                       int B, int N, int Np, int A, int K, int K2p, int G,
                                       int transpose, int nb, float kscale) {
  constexpr int BN = SPLIT ? AS_BN : AD_BN;
  constexpr int PARTS = pt_parts(SPLIT);
  constexpr uint32_t TB = BN * 128;      // a T̂ plane [BN columns][64], K-major
  constexpr uint32_t HB = TC_BM * 128;   // an h plane [128 rows][64]
  constexpr uint32_t STAGE = PARTS * (TB + HB);
  constexpr int UT = BN * 8 / TC_THREADS, UH = TC_BM * 8 / TC_THREADS;  // units per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sgen = smem_raw + (base - raw);
  float2* rot = reinterpret_cast<float2*>(sgen + 2 * STAGE);  // [2 bufs][pos, shift][nb+1][32]
  const int rot_fam = (nb + 1) * PT_AD_K;

  const int R = Np / TC_BM;
  const int b = blockIdx.x / R, rt = blockIdx.x % R;
  const int c0 = blockIdx.y * BN;
  const int g = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int Kp = K2p / 2, nkc = K2p / TC_BK;
  const int i_lo = (int)((long long)A * nkc * g / G);
  const int n = (int)((long long)A * nkc * (g + 1) / G) - i_lo;
  // this thread's units: 16-byte column chunk j (frequencies 4j .. 4j+3 of
  // the chunk), T̂ columns and h rows m0 + 32u
  const int j = tid & 7, m0 = tid >> 3;

  auto build_rot = [&](int i) {
    if (DBL && i < n && tid < 2 * PT_AD_K) {
      const int p = (i_lo + i) / nkc, k0 = (i_lo + i) % nkc * PT_AD_K;
      const int fam = tid / PT_AD_K, t = tid % PT_AD_K;
      pt_row_rotors((fam ? shift : pos) + (size_t)p * N, N, k0 + t, kscale, nb, PT_AD_K, t,
                    rot + ((i & 1) * 2 + fam) * rot_fam);
    }
  };
  auto load_shat = [&](int i, float (&sv)[8]) {
    if (i < n) {
      const int p = (i_lo + i) / nkc, k0 = (i_lo + i) % nkc * PT_AD_K;
      const float4* SV =
          reinterpret_cast<const float4*>(shat + (((size_t)b * A + p) * Kp + k0 + j * 4) * 2);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = __ldg(SV + q);
        sv[4 * q] = v.x;
        sv[4 * q + 1] = v.y;
        sv[4 * q + 2] = v.z;
        sv[4 * q + 3] = v.w;
      }
    }
  };
  // chunk i's T̂ and h into stage i % 2: this thread's T̂ rows c0 + m0 + 32u
  // (u < UT) and h rows rt·128 + m0 + 32u (u < UH), frequencies k0 + 4j + q
  auto build = [&](int i, const float (&sv)[8]) {
    const int p = (i_lo + i) / nkc, k0 = (i_lo + i) % nkc * PT_AD_K;
    uint8_t* st = sgen + (i & 1) * STAGE;
    const float2* rp = rot + ((i & 1) * 2) * rot_fam;
    const float* prow = pos + (size_t)p * N;
    const float* srow = shift + (size_t)p * N;
    uint32_t th[UT][4], tl[UT][4], hh[UH][4], hl[UH][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = 4 * j + q, k = k0 + t;
      const bool kv = k < K;
      const float kf = __fmul_rn((float)k, kscale);
      const float sp = kv ? __ldg(spec + k) : 0.f;
      float2 cs[UT];
      if constexpr (DBL) pt_dbl_rows<5, UT>(rp, PT_AD_K, t, m0, c0, nb, cs);
#pragma unroll
      for (int u = 0; u < UT; ++u) {
        const int c = c0 + m0 + 32 * u;
        float re = 0.f, im = 0.f;
        if (c < N && kv) {
          const float2 v = DBL ? cs[u] : pt_exact(prow[c], kf);
          re = sp * v.x;
          im = -sp * v.y;
        }
        pt_pack<SPLIT>(re, im, th[u][q], tl[u][q]);
      }
      float2 ph[UH];
      if constexpr (DBL) pt_dbl_rows<5, UH>(rp + rot_fam, PT_AD_K, t, m0, rt * TC_BM, nb, ph);
      const float s0 = sv[2 * q], s1 = sv[2 * q + 1];
#pragma unroll
      for (int u = 0; u < UH; ++u) {
        const int r = rt * TC_BM + m0 + 32 * u;
        float2 v = make_float2(0.f, 0.f);
        if (r < N && kv) v = DBL ? ph[u] : pt_exact(srow[r], kf);
        if (!SPLIT) v = make_float2(rnd(v.x), rnd(v.y));
        pt_pack<SPLIT>(s0 * v.x + s1 * v.y, -(s0 * v.y) + s1 * v.x, hh[u][q], hl[u][q]);
      }
    }
    uint8_t* hs = st + PARTS * TB;
#pragma unroll
    for (int u = 0; u < UT; ++u) {
      const uint32_t at = swz(m0 + 32 * u, j);
      *reinterpret_cast<uint4*>(st + at) = make_uint4(th[u][0], th[u][1], th[u][2], th[u][3]);
      if (SPLIT)
        *reinterpret_cast<uint4*>(st + TB + at) = make_uint4(tl[u][0], tl[u][1], tl[u][2], tl[u][3]);
    }
#pragma unroll
    for (int u = 0; u < UH; ++u) {
      const uint32_t at = swz(m0 + 32 * u, j);
      *reinterpret_cast<uint4*>(hs + at) = make_uint4(hh[u][0], hh[u][1], hh[u][2], hh[u][3]);
      if (SPLIT)
        *reinterpret_cast<uint4*>(hs + HB + at) = make_uint4(hl[u][0], hl[u][1], hl[u][2], hl[u][3]);
    }
  };

  float acc[BN / 2], tot[BN / 2];  // tot: the split route's running sum
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = tot[i] = 0.f;
  float sv_c[8] = {}, sv_n[8] = {};
  build_rot(0);
  build_rot(1);
  if (DBL) __syncthreads();
  load_shat(0, sv_c);
  load_shat(1, sv_n);
  if (n > 0) build(0, sv_c);
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) sv_c[q] = sv_n[q];
    fence_proxy_async();
    __syncthreads();  // chunk i built, rotors of i+1 made; chunk i−1's products done
    load_shat(i + 2, sv_n);
    const uint32_t sb = base + (i & 1) * STAGE;
    const uint32_t sa = sb + PARTS * TB + wg * (64 * 128);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      const uint64_t da = desc_sw128(sa + ks * 32, 16, 1024);
      const uint64_t db = desc_sw128(sb + ks * 32, 16, 1024);
      if constexpr (SPLIT) {
        wgmma_n128<0>(acc, da, db);
        wgmma_n128<0>(acc, da, desc_sw128(sb + TB + ks * 32, 16, 1024));
        wgmma_n128<0>(acc, desc_sw128(sa + HB + ks * 32, 16, 1024), db);
      } else {
        wgmma_n256_k(acc, da, db);
      }
    }
    wgmma_commit();
    if (i + 1 < n) build(i + 1, sv_c);  // overlaps the products of chunk i
    build_rot(i + 2);                   // into the buffer chunk i's build read
    wgmma_wait0();
    fence_acc(acc);
    if constexpr (SPLIT) {
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) {
        tot[q] += acc[q];
        acc[q] = 0.f;
      }
    }
  }

  float* ob = dst + ((size_t)g * B + b) * N * N;
  const int r1 = rt * TC_BM + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int c = c0 + jj * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r1 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c + e;
        const float v = SPLIT ? tot[4 * jj + 2 * h + e] : acc[4 * jj + 2 * h + e];
        if (r < N && cc < N) ob[transpose ? (size_t)cc * N + r : (size_t)r * N + cc] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------
#define PT_FWD(NAME, SPLIT, DBL)                                                              \
  __global__ void __launch_bounds__(TC_THREADS, SPLIT ? 1 : 2)                                \
  NAME(const __nv_bfloat16* __restrict__ fb, const float* __restrict__ pos,                  \
       const float* __restrict__ shift, const float* __restrict__ spec,                      \
       float* __restrict__ part, int B, int N, int Np, int A, int K, int K2p, int Dw, int nb, \
       float kscale) {                                                                        \
    pt_fwd<SPLIT, DBL>(fb, pos, shift, spec, part, B, N, Np, A, K, K2p, Dw, nb, kscale);     \
  }
PT_FWD(proto_tc_fwd, false, false)
PT_FWD(proto_tc_fwd_dbl, false, true)
PT_FWD(proto_split_fwd, true, false)
#undef PT_FWD

#define PT_ADJ(NAME, SPLIT, DBL)                                                              \
  __global__ void __launch_bounds__(TC_THREADS, 1)                                            \
  NAME(const float* __restrict__ shat, const float* __restrict__ pos,                        \
       const float* __restrict__ shift, const float* __restrict__ spec,                      \
       float* __restrict__ dst, int B, int N, int Np, int A, int K, int K2p, int G,           \
       int transpose, int nb, float kscale) {                                                 \
    pt_adj<SPLIT, DBL>(shat, pos, shift, spec, dst, B, N, Np, A, K, K2p, G, transpose, nb,   \
                       kscale);                                                               \
  }
PT_ADJ(proto_tc_adj, false, false)
PT_ADJ(proto_tc_adj_dbl, false, true)
PT_ADJ(proto_split_adj, true, false)
#undef PT_ADJ

using FwdKernel = void (*)(const __nv_bfloat16*, const float*, const float*, const float*,
                           float*, int, int, int, int, int, int, int, int, float);
using AdjKernel = void (*)(const float*, const float*, const float*, const float*, float*, int,
                           int, int, int, int, int, int, int, int, float);

__global__ void __launch_bounds__(256)
proto_tc_prep(const float* __restrict__ f, __nv_bfloat16* __restrict__ fb,
              __nv_bfloat16* __restrict__ fb_lo, int N, int Np, int transpose) {
  tc_prep(f, fb, N, Np, transpose, fb_lo);
}

__global__ void __launch_bounds__(ST_THREADS)
proto_tc_round(const float* __restrict__ src, int R, int rows, int cols,
               __nv_bfloat16* __restrict__ dst, int Mp, int cols_p) {
  tc_sum_round_pad(src, R, rows, cols, dst, Mp, cols_p);
}

// w4 (4Kp x Sp) bf16: row 4k + t = Wc[k] (t < 2) or −Ws[k] (t ≥ 2) for
// k < K and s < S, zero elsewhere: [Wc; Wc; −Ws; −Ws] in the order of the
// forward's four sums per k. Grid-stride.
__global__ void __launch_bounds__(ST_THREADS)
proto_tc_w4_prep(const float* __restrict__ Wc, const float* __restrict__ Ws,
                 __nv_bfloat16* __restrict__ w4, int K, int S, int K4p, int Sp) {
  const size_t n = (size_t)K4p * Sp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(i / Sp), s = (int)(i % Sp), k = row >> 2;
    float v = 0.f;
    if (k < K && s < S) v = (row & 2) ? -Ws[(size_t)k * S + s] : Wc[(size_t)k * S + s];
    w4[i] = __float2bfloat16_rn(v);
  }
}

__global__ void __launch_bounds__(ST_THREADS)
proto_tc_w_prep(const float* __restrict__ Wc, const float* __restrict__ Ws,
                __nv_bfloat16* __restrict__ wb, int K, int S, int K2p, int Sp) {
  tc_w_prep(Wc, Ws, wb, K, S, K2p, Sp);
}

// forward stage 3: out (rows x S) = rnd(sums) (Mp x 4Kp) · W4 (4Kp x Sp, MN-major B)
__global__ void __launch_bounds__(TC_THREADS, 2)
proto_tc_fwd_stage3(const __nv_bfloat16* __restrict__ sb, const __nv_bfloat16* __restrict__ w4,
                    float* __restrict__ out, int rows, int S, int K4p, int Sp) {
  tc_gemm<false>(sb, K4p, w4, Sp, out, S, rows, S, K4p / TC_BK, 0);
}

// adjoint stage 3ᵀ: Ŝ (rows x 2Kp) = rnd(p) (Mp x Sp) · W'ᵀ, not rounded
__global__ void __launch_bounds__(TC_THREADS, 2)
proto_tc_adj_stage3t(const __nv_bfloat16* __restrict__ pb, const __nv_bfloat16* __restrict__ wb,
                     float* __restrict__ shat2, int rows, int K2p, int Sp) {
  tc_gemm<true>(pb, Sp, wb, Sp, shat2, K2p, rows, K2p, Sp / TC_BK, 0);
}

__global__ void __launch_bounds__(ST_THREADS)
proto_split_fwd_stage3(const float* __restrict__ part, const float* __restrict__ Wc,
                       const float* __restrict__ Ws, float* __restrict__ out, int rows, int K,
                       int S, int R) {
  pair_stage3<false>(part, Wc, Ws, out, rows, K, S, R);
}

__global__ void __launch_bounds__(ST_THREADS)
proto_split_adj_stage3t(const float* __restrict__ p, const float* __restrict__ Wc,
                        const float* __restrict__ Ws, float* __restrict__ shat, int rows, int A,
                        int K, int Kp, int S) {
  pair_stage3t<1, false>(p, nullptr, Wc, Ws, shat, rows, A, K, Kp, S);
}

__global__ void __launch_bounds__(ST_THREADS)
proto_tc_reduce(const float* __restrict__ part, float* __restrict__ out, size_t n, int G) {
  tc_reduce(part, out, n, G);
}

#ifdef PROTO_TC_TABLE_PROBE
// A copy of tc_adj_split<1>'s body whose T̂ hi/lo and φ cp.asyncs read each
// chunk's own tables (PT_COPY), angle 0's first chunk for every chunk
// (PT_ONETILE) or are not issued at all (PT_NOTABLE); header note.
enum { PT_COPY = 0, PT_ONETILE = 1, PT_NOTABLE = 2 };
template <int MODE>
__device__ __forceinline__ void pt_table_probe(const float* __restrict__ shat,
                                               const __nv_bfloat16* __restrict__ tab,
                                               const float* __restrict__ phi,
                                               float* __restrict__ dst, int B, int N, int Np,
                                               int A, int K2p, int G, int transpose) {
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
  const int Kp = K2p / 2, nkc = K2p / TC_BK;
  const int i_lo = (int)((long long)A * nkc * g / G);
  const int n = (int)((long long)A * nkc * (g + 1) / G) - i_lo;
  const size_t tsz = (size_t)A * Np * K2p;
  constexpr int UNITS = TC_BM * 8 / TC_THREADS;
  const int j = tid & 7, m0 = tid >> 3;
  // the table offsets of chunk i (PT_COPY) or of chunk 0 of angle 0
  auto chunk = [&](int i, int& p, int& kri0) {
    p = MODE == PT_COPY ? (i_lo + i) / nkc : 0;
    kri0 = MODE == PT_COPY ? (i_lo + i) % nkc * TC_BK : 0;
  };
  auto load_t = [&](int i) {
    if (MODE != PT_NOTABLE && i < n) {
      int p, kri0;
      chunk(i, p, kri0);
      const uint32_t ts = base + (i % AS_T_STAGES) * AS_T_BYTES;
      const __nv_bfloat16* T = tab + ((size_t)p * Np + c0) * K2p + kri0;
      for (int e = tid; e < 2 * AS_BN * 8; e += TC_THREADS) {
        const int h = e / (AS_BN * 8), nn = (e >> 3) % AS_BN, jj = e & 7;
        cp_async16(ts + h * (AS_T_BYTES / 2) + swz(nn, jj),
                   T + h * tsz + (size_t)nn * K2p + jj * 8, 16);
      }
    }
    cp_async_commit();
  };
  auto load_phi = [&](int i) {
    if (MODE != PT_NOTABLE && i < n) {
      int p, kri0;
      chunk(i, p, kri0);
      const float* PH = phi + ((size_t)p * Np + (size_t)rt * TC_BM) * K2p + kri0 + j * 8;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int m = m0 + u * (TC_THREADS / 8);
        const uint32_t d = base + phi_off + m * (TC_BK * 4) + j * 32;
        const float* s = PH + (size_t)m * K2p;
        cp_async16(d, s, 16);
        cp_async16(d + 16, s + 4, 16);
      }
    }
    cp_async_commit();
  };
  auto load_shat = [&](int i, float (&sv)[8]) {
    if (i < n) {
      const int p = (i_lo + i) / nkc, k0 = (i_lo + i) % nkc * (TC_BK / 2);
      const float4* SV =
          reinterpret_cast<const float4*>(shat + (((size_t)b * A + p) * Kp + k0 + j * 4) * 2);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = __ldg(SV + q);
        sv[4 * q] = v.x;
        sv[4 * q + 1] = v.y;
        sv[4 * q + 2] = v.z;
        sv[4 * q + 3] = v.w;
      }
    }
  };
  auto build_h = [&](int i, const float (&sv)[8]) {
    uint8_t* hs = sgen + (h_base - base) + (i % AS_H_STAGES) * AS_H_BYTES;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int m = m0 + u * (TC_THREADS / 8);
      const float4* ps = reinterpret_cast<const float4*>(sgen + phi_off + m * (TC_BK * 4) + j * 32);
      const float4 x = ps[0], y = ps[1];
      const float w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      uint32_t hv[4], lv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float s0 = sv[2 * q], s1 = sv[2 * q + 1], ca = w[2 * q], sa = w[2 * q + 1];
        f2_split(s0 * ca + s1 * sa, -(s0 * sa) + s1 * ca, hv[q], lv[q]);
      }
      *reinterpret_cast<uint4*>(hs + swz(m, j)) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(hs + AS_H_BYTES / 2 + swz(m, j)) =
          make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
  };
  float acc[AS_BN / 2], tot[AS_BN / 2];
#pragma unroll
  for (int i = 0; i < AS_BN / 2; ++i) acc[i] = tot[i] = 0.f;
  float sv_c[8] = {}, sv_n[8] = {};
  load_t(0);
  load_t(1);
  load_phi(0);
  load_shat(0, sv_c);
  load_shat(1, sv_n);
  cp_async_wait_all();
  if (n > 0) build_h(0, sv_c);
  load_phi(1);
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) sv_c[q] = sv_n[q];
    cp_async_wait<2>();
    fence_proxy_async();
    __syncthreads();
    load_t(i + 2);
    load_shat(i + 2, sv_n);
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
    if (i + 1 < n) {
      cp_async_wait<1>();
      build_h(i + 1, sv_c);
    }
    load_phi(i + 2);
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

#define PT_PROBE(NAME, MODE)                                                                  \
  __global__ void __launch_bounds__(TC_THREADS, 1)                                            \
  NAME(const float* __restrict__ shat, const __nv_bfloat16* __restrict__ tab,                \
       const float* __restrict__ phi, float* __restrict__ dst, int B, int N, int Np, int A,   \
       int K2p, int G, int transpose) {                                                       \
    pt_table_probe<MODE>(shat, tab, phi, dst, B, N, Np, A, K2p, G, transpose);               \
  }
PT_PROBE(proto_split_adj_copy, PT_COPY)
PT_PROBE(proto_split_adj_onetile, PT_ONETILE)
PT_PROBE(proto_split_adj_notable, PT_NOTABLE)
#undef PT_PROBE
#endif

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers to
// contiguous arrays: float32, except the bf16 scratch fb, sb, w4, pb and wb.
// The stream is a cudaStream_t. Each returns the cudaError_t of its
// launches (0 on success); nothing here synchronises or allocates. Np =
// 128·⌈N/128⌉, Kp with 2Kp = 128·⌈2K/128⌉, Sp = 128·⌈S/128⌉. No trig table
// is taken: pos / shift are the group's plan rows (A, N), spec (K).

// f (B, N, N) -> out (B, A, S). Dw: the forward's depth window (a multiple
// of 128 that divides Np, at most 256). Scratch: fb (1 + !bf16, B, Np, Np)
// bf16; part (Np/Dw · Np/128, B, A, NS·K) float32 with NS = 4 (bf16) or 2;
// bf16 only: sb (Mp, 4Kp) and w4 (4Kp, Sp), Mp = 128·⌈B·A/128⌉.
extern "C" int radon_proto_tc_project(const float* f, const float* pos, const float* shift,
                                      const float* spec, const float* Wc, const float* Ws,
                                      void* fb, float* part, void* sb, void* w4, float* out,
                                      int B, int N, int Np, int A, int K, int Kp, int S, int Sp,
                                      int Dw, float kscale, int contract_x, int bf16,
                                      int doubling, void* stream) {
  const int K2p = 2 * Kp, rows = B * A, Mp = TC_BM * ceil_div(rows, TC_BM);
  if (Np % TC_BM || Np < N || K2p % FW_BN || Kp < K || Dw % TC_BM || Dw > PT_DW_MAX ||
      Np % Dw || (bf16 && (Sp % FW_BN || Sp < S)) || (doubling && !bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = !bf16, dbl = doubling != 0;
  const int nb = levels(N);
  __nv_bfloat16* fbh = static_cast<__nv_bfloat16*>(fb);
  proto_tc_prep<<<dim3(Np / 32, Np / 32, B), dim3(32, 8), 0, st>>>(
      f, fbh, split ? fbh + (size_t)B * Np * Np : nullptr, N, Np, !contract_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdKernel kern = split ? proto_split_fwd : (dbl ? proto_tc_fwd_dbl : proto_tc_fwd);
  const size_t smem = pt_fwd_smem(split, dbl, Dw, nb);
  err = set_smem((const void*)kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TC_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)A * (K2p / FW_BN) * (Np / Dw) * (Np / TC_BM) * B;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(items < slots ? items : slots);
  kern<<<grid, TC_THREADS, smem, st>>>(fbh, pos, shift, spec, part, B, N, Np, A, K, K2p, Dw, nb,
                                       kscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = (Np / Dw) * (Np / TC_BM);
  if (split) {
    const size_t smem3 = (size_t)ST_ROWS * (2 * K + ST3_SPLIT * ST3_COLS) * sizeof(float);
    err = set_smem((const void*)proto_split_fwd_stage3, smem3);
    if (err != cudaSuccess) return static_cast<int>(err);
    proto_split_fwd_stage3<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(S, ST3_COLS)), ST_THREADS,
                             smem3, st>>>(part, Wc, Ws, out, rows, K, S, R);
    return static_cast<int>(cudaGetLastError());
  }
  const int K4p = 2 * K2p;
  __nv_bfloat16* sbh = static_cast<__nv_bfloat16*>(sb);
  __nv_bfloat16* w4h = static_cast<__nv_bfloat16*>(w4);
  proto_tc_w4_prep<<<grid_for((size_t)K4p * Sp), ST_THREADS, 0, st>>>(Wc, Ws, w4h, K, S, K4p, Sp);
  proto_tc_round<<<grid_for((size_t)Mp * K4p), ST_THREADS, 0, st>>>(part, R, rows, 4 * K, sbh,
                                                                   Mp, K4p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem((const void*)proto_tc_fwd_stage3, FW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  proto_tc_fwd_stage3<<<dim3(Sp / FW_BN, Mp / TC_BM), TC_THREADS, FW_SMEM, st>>>(
      sbh, w4h, out, rows, S, K4p, Sp);
  return static_cast<int>(cudaGetLastError());
}

// p (B, A, S) -> out (B, N, N), the y group (contract_x = 0) transposed.
// Scratch: shat (B, A, Kp, 2) float32; when G > 1 part (G, B, N, N)
// float32; bf16 only: pb (Mp, Sp) and wb (2Kp, Sp) bf16.
extern "C" int radon_proto_tc_backproject(const float* p, const float* pos, const float* shift,
                                          const float* spec, const float* Wc, const float* Ws,
                                          void* pb, void* wb, float* shat, float* part,
                                          float* out, int B, int N, int Np, int A, int K, int Kp,
                                          int S, int Sp, int G, float kscale, int contract_x,
                                          int bf16, int doubling, void* stream) {
  const int K2p = 2 * Kp, rows = B * A, Mp = TC_BM * ceil_div(rows, TC_BM);
  if (Np % TC_BM || Np < N || K2p % FW_BN || Kp < K || G < 1 || G > A * (K2p / TC_BK) ||
      (G > 1 && part == nullptr) || (bf16 && (Sp % FW_BN || Sp < S)) || (doubling && !bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = !bf16, dbl = doubling != 0;
  const int nb = levels(N);
  cudaError_t err;
  if (split) {
    const size_t smem3 = (size_t)ST_ROWS * S * sizeof(float);
    err = set_smem((const void*)proto_split_adj_stage3t, smem3);
    if (err != cudaSuccess) return static_cast<int>(err);
    proto_split_adj_stage3t<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(Kp, ST3T_TK)), ST_THREADS,
                              smem3, st>>>(p, Wc, Ws, shat, rows, A, K, Kp, S);
  } else {
    __nv_bfloat16* pbh = static_cast<__nv_bfloat16*>(pb);
    __nv_bfloat16* wbh = static_cast<__nv_bfloat16*>(wb);
    proto_tc_w_prep<<<grid_for((size_t)K2p * Sp), ST_THREADS, 0, st>>>(Wc, Ws, wbh, K, S, K2p,
                                                                      Sp);
    proto_tc_round<<<grid_for((size_t)Mp * Sp), ST_THREADS, 0, st>>>(p, 1, rows, S, pbh, Mp, Sp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = set_smem((const void*)proto_tc_adj_stage3t, FW_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    proto_tc_adj_stage3t<<<dim3(K2p / FW_BN, Mp / TC_BM), TC_THREADS, FW_SMEM, st>>>(
        pbh, wbh, shat, rows, K2p, Sp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const AdjKernel kern = split ? proto_split_adj : (dbl ? proto_tc_adj_dbl : proto_tc_adj);
  const size_t smem = pt_adj_smem(split, dbl, nb);
  err = set_smem((const void*)kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bn = split ? AS_BN : AD_BN;
  kern<<<dim3(B * (Np / TC_BM), ceil_div(N, bn), G), TC_THREADS, smem, st>>>(
      shat, pos, shift, spec, G > 1 ? part : out, B, N, Np, A, K, K2p, G, !contract_x, nb,
      kscale);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * N * N;
  proto_tc_reduce<<<grid_for(n), ST_THREADS, 0, st>>>(part, out, n, G);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PROTO_TC_TABLE_PROBE
// The shipped split adjoint (radon_group_split.cu's stages) with the copy
// of its stage 2ᵀ + 1ᵀ body reading its own tables (mode = 0), every
// chunk's table reads pointed at one chunk (mode = 1) or left out
// (mode = 2): shat from proto_split_adj_stage3t, then the probe body and
// the slice sum. T / phi: the split tables.
extern "C" int radon_proto_tc_tableprobe_backproject(const float* p, const void* T,
                                                     const float* phi, const float* Wc,
                                                     const float* Ws, float* shat, float* part,
                                                     float* out, int B, int N, int Np, int A,
                                                     int K, int Kp, int S, int G, int contract_x,
                                                     int mode, void* stream) {
  const int K2p = 2 * Kp, rows = B * A;
  if (Np % TC_BM || Np < N || K2p % TC_BK || Kp < K || G < 1 || G > A * (K2p / TC_BK) ||
      (G > 1 && part == nullptr) || mode < PT_COPY || mode > PT_NOTABLE)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem3 = (size_t)ST_ROWS * S * sizeof(float);
  cudaError_t err = set_smem((const void*)proto_split_adj_stage3t, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  proto_split_adj_stage3t<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(Kp, ST3T_TK)), ST_THREADS,
                            smem3, st>>>(p, Wc, Ws, shat, rows, A, K, Kp, S);
  const auto kern = mode == PT_COPY      ? proto_split_adj_copy
                    : mode == PT_ONETILE ? proto_split_adj_onetile
                                         : proto_split_adj_notable;
  err = set_smem((const void*)kern, as_smem(1));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(B * (Np / TC_BM), ceil_div(N, AS_BN), G), TC_THREADS, as_smem(1), st>>>(
      shat, static_cast<const __nv_bfloat16*>(T), phi, G > 1 ? part : out, B, N, Np, A, K2p, G,
      !contract_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * N * N;
  proto_tc_reduce<<<grid_for(n), ST_THREADS, 0, st>>>(part, out, n, G);
  return static_cast<int>(cudaGetLastError());
}
#endif
