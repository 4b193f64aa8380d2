// The mirror-pair trig probe kernels on Hopper's tensor cores (sm_90a), with
// T̂ and both members' φ made on chip: the route that
// project_pair_group_doubling / project_pair_group_notrig take on a CUDA
// tensor.
//
// Replaces the Pallas TPU kernel of the JAX package's probe script:
//   pair_proto_{tc,split}_fwd_dbl    <- scripts/trig_proto.py::call_pair_fwd
//                                       (body _fwd_pair_kernel_doubling)
//   pair_proto_{tc,split}_fwd_notrig <- the same call (body _fwd_pair_kernel_notrig)
// Plain PyTorch versions: pdunet_tpu_torch/ops/radon/proto_kernels.py
// (_project_pair_group_doubling / _project_pair_group_notrig, both through
// cuda_kernels._pair_forward).
//
// The function is the mirror-pair forward f (B, N, N) -> (B, 2P, S) of
// radon_pair_tc.cu (rows interleaved [pair0-a, pair0-b, ...]):
//   stage 1   ĝ[r, k] = Σ_c F[r, c] T̂_p[c, k];
//   stage 2   Ŝ_m[k] = Σ_r ĝ_m[r, k] φ_m[p, r, k], ĝ_b = (gr, sgn·gi);
//   stage 3   out[2p + m, s] = Σ_k Re Ŝ_m Wc[k, s] − Im Ŝ_m Ws[k, s];
// with its six (N, K) trig tensors made one of two ways:
//   doubling: T̂ = (spec·c, −spec·s) and φ_a, φ_b = (c, s) by block
//             doubling (radon_proto_tc.cuh) from the host's (P, 3K) seeds
//             and steps of phase_seeds, the families [pos | sha | shb];
//   no-trig : T̂ = (spec + pos·kf, spec − pos·kf), φ_m = (sh_m·kf + 1,
//             sh_m·kf − 1) with kf = (float)k·kscale: the shipped kernel's
//             products without its trig (wrong numbers).
// Rounding points are the plain versions': T̂ formed in f32 and rounded to
// bf16 (or split into hi and lo), φ rounded to the operand type, ĝ f32,
// member b's Im scaled by sgn, Ŝ rounded before stage 3 (bf16). A thread
// makes its doubled rows as pt_dbl_rows' trees (4 low bits x 8 rows for
// T̂, 3 low bits x 2 rows for φ: the trees radon_proto_tc.cu makes, which a
// CPU transcription holds to doubling_trig_rows bit for bit); the seeds'
// cos / sin are sincosf where the plain version calls torch.cos / sin.
//
// Forward (stages 1+2). The work is a list of items (pair p, 128-column
// tile ct of interleaved (k, re/im), depth window w, row tile rt, image b),
// ordered with (p, ct, w) outermost and rt before b. A persistent grid of
// one block per SM (256 threads, two warpgroups) gives each block a
// contiguous run of I = ⌈items / blocks⌉ items. Whenever the run enters a
// new (p, ct, w) the block makes the three rotor families of the tile's 64
// frequencies (doubling), then T̂ for the window's Dw rows and 128 columns
// into shared memory, in the MN-major 128-byte-swizzled layout wgmma reads
// (swz), and keeps it for every row tile and image that follow. Whenever rt
// changes the threads make both members' φ in registers, for their two
// accumulator rows and 16 frequencies: the accumulator's adjacent pair is
// (re, im) of one k for one row, so the epilogue applies φ_a and φ_b there,
// reduces over the tile's rows (shuffles, then shared memory) and writes
// one partial (Ŝ_a, Ŝ_b) per (w, rt). So per call each T̂ element is
// computed once per block whose run touches its (p, ct, w), at most
// ⌈R·B / I⌉ + 1 times (R = Np/128), and each φ element once per block
// whose run touches its (p, ct, w, rt), at most ⌈B / I⌉ + 1 times: at the
// flagship shape (P = 23, 2Kp = 384, Np = 256, B = 32; 4,416 items on 132
// blocks, I = 34) T̂ 2-3 times and φ 1-2 times, against once per block of
// radon_pair_tc.cu's grid for its tables' reads (4,416 blocks). F (zero-
// padded to Np and transposed for the y group by tc_prep) streams through a
// cp.async ring of 64-deep A tiles that runs across items, so the next
// item's first tiles land during this item's epilogue, whose reduction
// buffer is the stage the item's last tile used.
// Shared memory (N = 256, Dw = Np = 256; rotors with doubling only, three
// families x (nb + 1) levels x 64 frequencies, nb = ⌈log2 N⌉ = 8):
//   bf16 : T̂ 256 x 128 bf16 64 KB + 3 F stages x 16 KB + rotors 3 x 9 x 64
//          x 8 B 13.5 KB + 1 KB alignment = 126.5 KB;
//   split: T̂ hi + lo 128 KB + 2 F stages (hi + lo) x 32 KB + 13.5 KB + 1 KB
//          = 206.5 KB (a third stage would not fit in 227 KB).
// Registers set one block per SM on both routes: the 64 f32 accumulators
// and both members' φ (64 bf16 pairs, or 64 f32 pairs split) live through
// the products, above the 128 registers two blocks a SM would leave.
// Depth windows: Dw is the largest multiple of 128 that divides Np and is
// at most 256 (the wrapper's _packed_window), so N > 256 runs in Np/Dw
// windows whose partials stage 3 sums with the row tiles' in a fixed order.
//
// Stage 3: pair_stage3 (radon_tc.cuh) over the (Np/Dw · R) partials of
// layout (R', B, P, M = 2, K, 2), <true> (Ŝ and W rounded) for bf16 and
// <false> for split, as radon_pair_tc.cu / radon_pair_split.cu call it.
//
// bf16 operands: wgmma bf16 with f32 accumulators. f32 operands: split
// products (hi·hi + hi·lo + lo·hi, radon_tc.cuh), F split by the prep
// kernel and every generated T̂ value split into hi and lo as it is
// written; φ stays f32. The doubling body splits into bf16 parts, as the
// shipped split route does. The no-trig body splits into fp16 parts: its
// numbers cancel about 190x in stage 2 (Ŝ_im = Σ a·(gr + gi) − (gr − gi)
// with a = sh·kf, where both terms are large), so the 2⁻¹⁷ of two bf16
// parts (three products) reach 2e-5 of its f32 plain version at 512², and
// the 2⁻²² of two fp16 parts stay near 5e-7, at the same products, rate
// and bytes. fp16 bounds the no-trig f32 inputs to |f| < 65504 (past it
// the output is not finite).
//
// What bounds them on an H100: the products (stage 1, 4·B·P·N²·K flops)
// over the tensor cores' rate, against F's bytes. The shipped forward
// (radon_pair_tc.cu) reads F, T̂ and both φ tiles per block, two thirds of
// its bytes from the trig tables; these kernels read F only (≈ 290 MB of
// L2-to-SM reads per bf16 call at the flagship shape, ≈ 580 MB split) and
// pay their trig on the CUDA cores once per (pair, tile, window) and row
// tile per block. The no-trig body bounds what reading no table could buy
// the pair forward; the doubling body is what trig made on chip gives.
// The measured times against the shipped routes are in PERF.md §6.

#include <cuda_fp16.h>

#include "radon_proto_tc.cuh"

namespace {

enum { PP_DOUBLING = 0, PP_NOTRIG = 1 };
constexpr int PP_M = 2;            // members per pair
constexpr int PP_NS = 2 * PP_M;    // partial sums per k: each member's (re, im)
constexpr int PP_FAMS = 3;         // rotor families: pos, sha, shb

// forward F ring stages: three in bf16; two split (whole-depth T̂ hi + lo)
__host__ __device__ constexpr int pp_stages(bool split) { return split ? 2 : 3; }

size_t pp_fwd_smem(bool split, bool dbl, int Dw, int nb) {
  return (size_t)(Dw / TC_BK + pp_stages(split)) * pt_parts(split) * PT_PLANE +
         (dbl ? (size_t)PP_FAMS * (nb + 1) * PT_FW_K * sizeof(float2) : 0) + 1024;
}

// D (64 x 128, f32) += A (64 x 16, fp16, K-major) * B (16 x 128, fp16,
// MN-major), both from shared memory: radon_tc.cuh's wgmma_n128<1> on fp16
// operands (the no-trig body's split route)
__device__ __forceinline__ void wgmma_n128_f16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// the split route's product of one 16-deep step: bf16 or (F16) fp16 parts
template <bool F16>
__device__ __forceinline__ void pp_mma(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (F16) wgmma_n128_f16(d, da, db);
  else wgmma_n128<1>(d, da, db);
}

// (re, im) as fp16 hi and lo pairs: hi = fp16(x), lo = fp16(x − hi)
__device__ __forceinline__ void f2_split_half(float re, float im, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(re, im);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(re - hf.x, im - hf.y);
  memcpy(&hi, &h, 4);
  memcpy(&lo, &l, 4);
}

// F as fp16 hi and lo planes, zero-padded to (B, Np, Np) and transposed for
// the y group: tc_prep's layout and tiling with fp16 parts.
// grid (Np/32, Np/32, B), block (32, 8).
__global__ void __launch_bounds__(256)
pair_proto_prep_f16(const float* __restrict__ f, __half* __restrict__ fh,
                    __half* __restrict__ fl, int N, int Np, int transpose) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, y0 = blockIdx.y * 32, x0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* src = f + (size_t)b * N * N;
  for (int yy = ty; yy < 32; yy += 8) {
    const int y = y0 + yy, x = x0 + tx;
    tile[yy][tx] = (y < N && x < N) ? src[(size_t)y * N + x] : 0.f;
  }
  __syncthreads();
  const size_t off = (size_t)b * Np * Np;
  for (int yy = ty; yy < 32; yy += 8) {
    const float v = transpose ? tile[tx][yy] : tile[yy][tx];
    const size_t at = off + (transpose ? (size_t)(x0 + yy) * Np + y0 + tx
                                       : (size_t)(y0 + yy) * Np + x0 + tx);
    const __half hi = __float2half_rn(v);
    fh[at] = hi;
    fl[at] = __float2half_rn(v - __half2float(hi));
  }
}

// ---------------------------------------------------------------------------
// Forward stages 1+2 (header note). fb (PARTS, B, Np, Np) 16-bit (bf16;
// fp16 for the no-trig split route); doubling
// reads seeds0 / steps (P, 3K), no-trig pos / sha / shb (P, N); part
// (Np/Dw · Np/128, B, P, 2, K, 2) f32; grid ≤ items, TC_THREADS threads,
// pp_fwd_smem bytes of dynamic shared memory.
// ---------------------------------------------------------------------------
template <bool SPLIT, int MODE>
__device__ __forceinline__ void pp_fwd(const uint16_t* __restrict__ fb,
                                       const float* __restrict__ seeds0,
                                       const float* __restrict__ steps,
                                       const float* __restrict__ pos,
                                       const float* __restrict__ sha,
                                       const float* __restrict__ shb,
                                       const float* __restrict__ sgn,
                                       const float* __restrict__ spec, float* __restrict__ part,
                                       int B, int N, int Np, int P, int K, int K2p, int Dw,
                                       int nb, float kscale) {
  constexpr bool DBL = MODE == PP_DOUBLING;
  constexpr bool F16 = SPLIT && !DBL;  // the no-trig split route's fp16 parts
  constexpr int PARTS = pt_parts(SPLIT);
  constexpr int STAGES = pp_stages(SPLIT);
  constexpr uint32_t CH = PARTS * PT_PLANE;  // a T̂ chunk or a ring stage, hi (and lo)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sgen = smem_raw + (base - raw);
  const int nkw = Dw / TC_BK;
  const uint32_t ring = base + nkw * CH;
  float2* rot = reinterpret_cast<float2*>(sgen + (nkw + STAGES) * CH);  // [pos, sha, shb][nb+1][64]
  const int rot_fam = (nb + 1) * PT_FW_K;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n_ct = K2p / FW_BN, R = Np / TC_BM, nw = Np / Dw;
  const long long T = (long long)R * B;  // items per (pair, column tile, window)
  const long long U = (long long)P * n_ct * nw * T;
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
      const uint16_t* Ap =
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

  // T̂ of pair p, frequencies [k0, k0 + 64), rows [r0, r0 + Dw): chunk c / 64
  // at base, each plane [2 blocks of 64 columns][64 rows][128 B]. A thread
  // makes column unit n8 = tid % 16 (frequencies k0 + 4·n8 + q) of rows
  // r0 + 128h + tid/16 + 16u (u < 8), one (re, im) pair at a time.
  auto build_t = [&](int p, int k0, int r0) {
    const int n8 = tid & 15, lo = tid >> 4;
    for (int h = 0; h < Dw / TC_BM; ++h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kl = n8 * 4 + q, k = k0 + kl;
        const float sp = k < K ? __ldg(spec + k) : 0.f;
        float2 cs[8];
        if constexpr (DBL) pt_dbl_rows<4, 8>(rot, PT_FW_K, kl, lo, r0 + TC_BM * h, nb, cs);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int cl = TC_BM * h + lo + 16 * u, c = r0 + cl;
          float re = 0.f, im = 0.f;
          if (c < N && k < K) {
            if constexpr (DBL) {
              re = sp * cs[u].x;
              im = -sp * cs[u].y;
            } else {
              const float v =
                  __fmul_rn(__ldg(pos + (size_t)p * N + c), __fmul_rn((float)k, kscale));
              re = __fadd_rn(sp, v);
              im = __fsub_rn(sp, v);
            }
          }
          uint32_t hv, lv;
          if constexpr (F16) f2_split_half(re, im, hv, lv);
          else pt_pack<SPLIT>(re, im, hv, lv);
          const uint32_t off =
              (cl >> 6) * CH + (n8 >> 3) * (TC_BK * 128) + swz(cl & 63, n8 & 7) + 4 * q;
          *reinterpret_cast<uint32_t*>(sgen + off) = hv;
          if (SPLIT) *reinterpret_cast<uint32_t*>(sgen + off + PT_PLANE) = lv;
        }
      }
    }
  };

  // φ of both members for this thread's accumulator rows (ra, ra + 8 of tile
  // rt) and its 16 frequencies k0 + 4j + lane % 4: bf16 pairs (rounded), or
  // f32 (split); [member][row][j]
  float2 phf[SPLIT ? PP_M : 1][2][SPLIT ? 16 : 1];
  uint32_t phb[SPLIT ? 1 : PP_M][2][SPLIT ? 1 : 16];
  auto build_phi = [&](int p, int k0, int rt) {
    const int hi = rt * TC_BM + wg * 64 + warp * 16, lo = lane >> 2;
#pragma unroll
    for (int m = 0; m < PP_M; ++m) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kl = j * 4 + (lane & 3), k = k0 + kl;
        float2 cs[2];
        if constexpr (DBL) pt_dbl_rows<3, 2>(rot + (1 + m) * rot_fam, PT_FW_K, kl, lo, hi, nb, cs);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = hi + lo + 8 * h;
          float2 v = make_float2(0.f, 0.f);
          if (r < N && k < K) {
            if constexpr (DBL) {
              v = cs[h];
            } else {
              const float a = __fmul_rn(__ldg((m ? shb : sha) + (size_t)p * N + r),
                                        __fmul_rn((float)k, kscale));
              v = make_float2(__fadd_rn(a, 1.f), __fsub_rn(a, 1.f));
            }
          }
          if constexpr (SPLIT) phf[m][h][j] = v;
          else phb[m][h][j] = f2_to_bf2(v.x, v.y);
        }
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
    const int w = (int)(grp % nw), pc = (int)(grp / nw);
    const int p = pc / n_ct, k0 = (pc % n_ct) * PT_FW_K;
    const int rt = tile / B, b = tile % B;
    if (grp != prev_grp) {
      __syncthreads();  // every warpgroup is done with the old T̂ and rotors
      if constexpr (DBL) {
        if (tid < PP_FAMS * PT_FW_K) {
          const int fam = tid / PT_FW_K, t = tid % PT_FW_K;
          const size_t at = ((size_t)p * PP_FAMS + fam) * K + min(k0 + t, K - 1);
          pt_rotors(__ldg(seeds0 + at), __ldg(steps + at), nb, PT_FW_K, t, rot + fam * rot_fam);
        }
        __syncthreads();
      }
      build_t(p, k0, w * Dw);  // visible to wgmma after the chunk loop's fence and barrier
      build_phi(p, k0, rt);
      prev_grp = grp;
      prev_rt = rt;
    } else if (rt != prev_rt) {
      build_phi(p, k0, rt);
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
        pp_mma<F16>(acc, da, db);
        if constexpr (SPLIT) {  // hi·lo, then lo·hi
          pp_mma<F16>(acc, da, desc_sw128(sb + PT_PLANE + ks * 2048, TC_BK * 128, 1024));
          pp_mma<F16>(acc, desc_sw128(sa + PT_PLANE + ks * 32, 16, 1024), db);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
    }

    // stage 2: this thread holds (gr, gi) of frequency k0 + 4j + lane % 4
    // for its rows ra (acc[4j], acc[4j+1]) and ra + 8 (acc[4j+2], acc[4j+3]).
    // The reduction buffer, [64 k][PP_NS] per warp, lies in the stage chunk
    // q − 1 used, each warp's within its own warpgroup's A rows (8 KB),
    // whose products that warpgroup has awaited; the next load into the
    // stage follows the next chunk's barrier.
    float* stage_f =
        reinterpret_cast<float*>(sgen + (ring - base) + (uint32_t)((q - 1) % STAGES) * CH);
    auto red_of = [&](int w8) {
      return stage_f + (w8 >> 2) * (64 * 128 / 4) + (w8 & 3) * PT_FW_K * PP_NS;
    };
    float* myred = red_of(wg * 4 + warp);
    const float sg = __ldg(sgn + p);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float gr1 = acc[4 * j], gi1 = acc[4 * j + 1];
      const float gr2 = acc[4 * j + 2], gi2 = acc[4 * j + 3];
      float v[PP_NS];
#pragma unroll
      for (int m = 0; m < PP_M; ++m) {
        float2 c1, c2;
        if constexpr (SPLIT) {
          c1 = phf[m][0][j];
          c2 = phf[m][1][j];
        } else {
          c1 = bf2_to_f2(phb[m][0][j]);
          c2 = bf2_to_f2(phb[m][1][j]);
        }
        const float g1 = m ? gi1 * sg : gi1, g2 = m ? gi2 * sg : gi2;
        v[2 * m] = (gr1 * c1.x - g1 * c1.y) + (gr2 * c2.x - g2 * c2.y);
        v[2 * m + 1] = (gr1 * c1.y + g1 * c1.x) + (gr2 * c2.y + g2 * c2.x);
      }
#pragma unroll
      for (int t = 0; t < PP_NS; ++t) {
        v[t] += __shfl_xor_sync(0xffffffffu, v[t], 4);
        v[t] += __shfl_xor_sync(0xffffffffu, v[t], 8);
        v[t] += __shfl_xor_sync(0xffffffffu, v[t], 16);
      }
      if (lane < 4) {
#pragma unroll
        for (int t = 0; t < PP_NS; ++t) myred[(j * 4 + lane) * PP_NS + t] = v[t];
      }
    }
    __syncthreads();
    float* dstp = part + (((size_t)(w * R + rt) * B + b) * P + p) * ((size_t)PP_M * K * 2);
    for (int e = tid; e < PT_FW_K * PP_NS; e += TC_THREADS) {
      const int kl = e / PP_NS, t = e % PP_NS, k = k0 + kl;
      float s = 0.f;
      for (int wp = 0; wp < 8; ++wp) s += red_of(wp)[kl * PP_NS + t];
      if (k < K) dstp[((size_t)(t >> 1) * K + k) * 2 + (t & 1)] = s;
    }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------
#define PP_FWD(NAME, SPLIT, MODE)                                                             \
  __global__ void __launch_bounds__(TC_THREADS, 1)                                            \
  NAME(const uint16_t* __restrict__ fb, const float* __restrict__ seeds0,                    \
       const float* __restrict__ steps, const float* __restrict__ pos,                       \
       const float* __restrict__ sha, const float* __restrict__ shb,                         \
       const float* __restrict__ sgn, const float* __restrict__ spec,                        \
       float* __restrict__ part, int B, int N, int Np, int P, int K, int K2p, int Dw, int nb, \
       float kscale) {                                                                        \
    pp_fwd<SPLIT, MODE>(fb, seeds0, steps, pos, sha, shb, sgn, spec, part, B, N, Np, P, K,   \
                        K2p, Dw, nb, kscale);                                                 \
  }
PP_FWD(pair_proto_tc_fwd_dbl, false, PP_DOUBLING)
PP_FWD(pair_proto_tc_fwd_notrig, false, PP_NOTRIG)
PP_FWD(pair_proto_split_fwd_dbl, true, PP_DOUBLING)
PP_FWD(pair_proto_split_fwd_notrig, true, PP_NOTRIG)
#undef PP_FWD

using FwdKernel = void (*)(const uint16_t*, const float*, const float*, const float*,
                           const float*, const float*, const float*, const float*, float*, int,
                           int, int, int, int, int, int, int, float);

__global__ void __launch_bounds__(256)
pair_proto_prep(const float* __restrict__ f, __nv_bfloat16* __restrict__ fb,
                __nv_bfloat16* __restrict__ fb_lo, int N, int Np, int transpose) {
  tc_prep(f, fb, N, Np, transpose, fb_lo);
}

// stage 3 over the R partials: bf16 (Ŝ and W rounded) and split (f32)
__global__ void __launch_bounds__(ST_THREADS)
pair_proto_tc_stage3(const float* __restrict__ part, const float* __restrict__ Wc,
                     const float* __restrict__ Ws, float* __restrict__ out, int rows, int K,
                     int S, int R) {
  pair_stage3<true>(part, Wc, Ws, out, rows, K, S, R);
}

__global__ void __launch_bounds__(ST_THREADS)
pair_proto_split_stage3(const float* __restrict__ part, const float* __restrict__ Wc,
                        const float* __restrict__ Ws, float* __restrict__ out, int rows, int K,
                        int S, int R) {
  pair_stage3<false>(part, Wc, Ws, out, rows, K, S, R);
}

// f -> out through prep, the forward body of MODE and stage 3; the rows of
// the mode the body does not read may be null
int pp_project(int mode, const float* f, const float* seeds0, const float* steps,
               const float* pos, const float* sha, const float* shb, const float* sgn,
               const float* spec, const float* Wc, const float* Ws, void* fb, float* part,
               float* out, int B, int N, int Np, int P, int K, int Kp, int S, int Dw,
               float kscale, int contract_x, int bf16, void* stream) {
  const int K2p = 2 * Kp, rows = B * 2 * P;
  if (B < 1 || N < 1 || P < 1 || K < 1 || S < 1 || Np % TC_BM || Np < N || K2p % FW_BN ||
      Kp < K || Dw % TC_BM || Dw > PT_DW_MAX || Np % Dw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = !bf16, dbl = mode == PP_DOUBLING;
  const int nb = levels(N);
  const dim3 pgrid(Np / 32, Np / 32, B), pblock(32, 8);
  const size_t plane = (size_t)B * Np * Np;
  if (split && !dbl) {
    __half* fh = static_cast<__half*>(fb);
    pair_proto_prep_f16<<<pgrid, pblock, 0, st>>>(f, fh, fh + plane, N, Np, !contract_x);
  } else {
    __nv_bfloat16* fbh = static_cast<__nv_bfloat16*>(fb);
    pair_proto_prep<<<pgrid, pblock, 0, st>>>(f, fbh, split ? fbh + plane : nullptr, N, Np,
                                              !contract_x);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdKernel kern = split ? (dbl ? pair_proto_split_fwd_dbl : pair_proto_split_fwd_notrig)
                               : (dbl ? pair_proto_tc_fwd_dbl : pair_proto_tc_fwd_notrig);
  const size_t smem = pp_fwd_smem(split, dbl, Dw, nb);
  err = set_smem((const void*)kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TC_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)P * (K2p / FW_BN) * (Np / Dw) * (Np / TC_BM) * B;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(items < slots ? items : slots);
  kern<<<grid, TC_THREADS, smem, st>>>(static_cast<const uint16_t*>(fb), seeds0, steps, pos, sha,
                                       shb, sgn, spec, part, B, N, Np, P, K, K2p, Dw, nb, kscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = (Np / Dw) * (Np / TC_BM);
  const size_t smem3 = (size_t)ST_ROWS * (2 * K + ST3_SPLIT * ST3_COLS) * sizeof(float);
  const auto stage3 = split ? pair_proto_split_stage3 : pair_proto_tc_stage3;
  err = set_smem((const void*)stage3, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  stage3<<<dim3(ceil_div(rows, ST_ROWS), ceil_div(S, ST3_COLS)), ST_THREADS, smem3, st>>>(
      part, Wc, Ws, out, rows, K, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers to
// contiguous float32 arrays, except the bf16 scratch fb. The stream is a
// cudaStream_t. Each returns the cudaError_t of its launches (0 on
// success); nothing here synchronises or allocates. Np = 128·⌈N/128⌉, Kp
// with 2Kp = 128·⌈2K/128⌉, Dw the forward's depth window (a multiple of 128
// that divides Np, at most 256). No trig table is taken. f (B, N, N) ->
// out (B, 2P, S). Scratch: fb (1 + !bf16, B, Np, Np) 16-bit (F in bf16, or
// its hi and lo planes: bf16, fp16 for the no-trig body); part (Np/Dw ·
// Np/128, B, 2P, K, 2) float32.

// seeds0 / steps: the (P, 3K) phase seeds of phase_seeds, [pos | sha | shb].
extern "C" int radon_pair_proto_tc_doubling(const float* f, const float* seeds0,
                                            const float* steps, const float* sgn,
                                            const float* spec, const float* Wc, const float* Ws,
                                            void* fb, float* part, float* out, int B, int N,
                                            int Np, int P, int K, int Kp, int S, int Dw,
                                            int contract_x, int bf16, void* stream) {
  return pp_project(PP_DOUBLING, f, seeds0, steps, nullptr, nullptr, nullptr, sgn, spec, Wc, Ws,
                    fb, part, out, B, N, Np, P, K, Kp, S, Dw, 0.f, contract_x, bf16, stream);
}

// pos / sha / shb: the group's plan rows (P, N); kscale = 2π/L.
extern "C" int radon_pair_proto_tc_notrig(const float* f, const float* pos, const float* sha,
                                          const float* shb, const float* sgn, const float* spec,
                                          const float* Wc, const float* Ws, void* fb,
                                          float* part, float* out, int B, int N, int Np, int P,
                                          int K, int Kp, int S, int Dw, float kscale,
                                          int contract_x, int bf16, void* stream) {
  return pp_project(PP_NOTRIG, f, nullptr, nullptr, pos, sha, shb, sgn, spec, Wc, Ws, fb, part,
                    out, B, N, Np, P, K, Kp, S, Dw, kscale, contract_x, bf16, stream);
}
