"""Projector kernels: wrappers and their plain PyTorch versions.

Two families replace the Pallas kernels of
``pdunet_tpu/ops/radon/pallas_kernels.py``:

* mirror-pair, ``project_pair_group`` / ``backproject_pair_group``
  (``project_pair_group_pallas`` / ``backproject_pair_group_pallas``), for
  plans whose angles pair, with two tensor-core (wgmma) routes: bf16
  operands run the kernels of ``csrc/radon_pair_tc.cu``, which read the
  plan's trig from tables that :func:`build_pair_tables` makes once per
  plan and group; float32 operands run the split-bf16 kernels of
  ``csrc/radon_pair_split.cu`` (three bf16 products of hi and lo parts per
  step, f32 sums), which read :func:`build_pair_split_tables`' tables (the
  caller, ``parallel.py``, owns and passes both);
* per-angle, ``project_group`` / ``backproject_group``
  (``project_group_pallas`` / ``backproject_group_pallas``), for plans whose
  angles do not pair (golden-angle spokes, the radial fourier-slice NUFFT),
  with the same two routes, one member per angle of the pair machinery in
  ``csrc/radon_tc.cuh``: bf16 operands run the tensor-core kernels of
  ``csrc/radon_group_tc.cu``, which read the tables of
  :func:`build_group_tables`; float32 operands the split-bf16 kernels of
  ``csrc/radon_group_split.cu``, which read :func:`build_group_split_tables`'
  tables.

For a CUDA tensor each wrapper launches its hand-written kernel (and raises
if it cannot); for a CPU tensor it runs the plain version below, which is
the port of the JAX twin of the same name (``_project_pair_group``,
``_project_group``, ... in ``pdunet_tpu/ops/radon/parallel.py``).

Precision contract (same as the twins): the trig arguments are f32 (or
f64 for a float64 input on the CPU, which ``gradcheck`` uses); with
``cdt=torch.bfloat16`` the operands T̂, φ, f or p, W and Ŝ (or h) are
rounded to bf16 where the twin casts them, and every sum accumulates in f32.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, its
bf16 tensor-core launches in ``.launches_tc`` and its split-bf16 launches
in ``.launches_split``, and the table builders their builds. A CPU call
does not count. These counters are registered with ``utils/trace.py``,
whose root spans keep their change.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pdunet_tpu_torch.utils import trace

__all__ = ["project_pair_group", "backproject_pair_group", "build_pair_tables",
           "build_pair_split_tables", "pair_adjoint_splits", "project_group", "backproject_group",
           "build_group_tables", "build_group_split_tables", "group_adjoint_splits",
           "reset_launch_counts"]


def _q(x: torch.Tensor, cdt) -> torch.Tensor:
    """Round ``x`` to ``cdt`` and keep its working dtype (bf16 operand with
    an f32 product is exact, so f32 einsums then emulate bf16 matmuls with
    f32 accumulation)."""
    return x if cdt != torch.bfloat16 else x.to(cdt).to(x.dtype)


def _kfreq(K: int, L: int, dtype, device) -> torch.Tensor:
    """k·2π/L with the scalar rounded to ``dtype`` first, as the twin does."""
    step = torch.tensor(2.0 * math.pi / L, dtype=dtype, device=device)
    return torch.arange(K, dtype=dtype, device=device) * step


def _pair_spectral_tensors(pos, sha, shb, spec, L, cdt=torch.float32):
    """One shared splat T̂ per pair plus both members' shear phases, each
    (P, N, K): T̂ = spec·e^{−2πik·pos/L}, φ_m = e^{+2πik·sh_m/L}."""
    K = spec.shape[0]
    k = _kfreq(K, L, pos.dtype, pos.device)
    ang_t = pos[:, :, None] * k[None, None, :]
    Tc = _q(spec * torch.cos(ang_t), cdt)
    Ts = _q(-spec * torch.sin(ang_t), cdt)
    ang_a = sha[:, :, None] * k[None, None, :]
    ang_b = shb[:, :, None] * k[None, None, :]
    return (Tc, Ts,
            _q(torch.cos(ang_a), cdt), _q(torch.sin(ang_a), cdt),
            _q(torch.cos(ang_b), cdt), _q(torch.sin(ang_b), cdt))


def _project_pair_group(f, pos, sha, shb, sgn, spec, Wc, Ws, L,
                        contract_x: bool, cdt=torch.float32):
    """Plain mirror-pair forward: f (B,N,N) → (B, 2P, S), rows interleaved
    [pair0-a, pair0-b, pair1-a, ...]. Stage 1 runs once per pair; member b
    reuses ĝ with Im scaled by ``sgn`` and applies its own shear phases."""
    return _pair_forward(f, *_pair_spectral_tensors(pos, sha, shb, spec, L, cdt), sgn,
                         Wc, Ws, contract_x, cdt)


def _pair_forward(f, Tc, Ts, PcA, PsA, PcB, PsB, sgn, Wc, Ws, contract_x: bool,
                  cdt=torch.float32):
    """Stages 1-3 of the mirror-pair forward from its six (P, N, K) trig
    tensors, already rounded to ``cdt``."""
    f = _q(f, cdt)
    Wc, Ws = _q(Wc, cdt), _q(Ws, cdt)
    sub1 = "bji,pik->bpjk" if contract_x else "bji,pjk->bpik"
    gr = torch.einsum(sub1, f, Tc)
    gi = torch.einsum(sub1, f, Ts)
    sub2 = "bpjk,pjk->bpk" if contract_x else "bpik,pik->bpk"

    def member(Pc, Ps, gi_m):
        s_re = torch.einsum(sub2, gr, Pc) - torch.einsum(sub2, gi_m, Ps)
        s_im = torch.einsum(sub2, gr, Ps) + torch.einsum(sub2, gi_m, Pc)
        return (torch.einsum("bpk,ks->bps", _q(s_re, cdt), Wc)
                - torch.einsum("bpk,ks->bps", _q(s_im, cdt), Ws))

    out_a = member(PcA, PsA, gi)
    out_b = member(PcB, PsB, gi * sgn[None, :, None, None])
    out = torch.stack([out_a, out_b], dim=2)          # (B, P, 2, S)
    return out.reshape(out.shape[0], -1, out.shape[-1])


def _backproject_pair_group(p, pos, sha, shb, sgn, msk, spec, Wc, Ws, L,
                            contract_x: bool, cdt=torch.float32):
    """Plain exact transpose of :func:`_project_pair_group`:
    p (B, 2P, S) interleaved → (B, N, N). Unpaired member-b rows are zeroed
    by ``msk``; both members fold into one spectral h per pair."""
    Tc, Ts, PcA, PsA, PcB, PsB = _pair_spectral_tensors(pos, sha, shb, spec, L, cdt)
    p = _q(p, cdt)
    Wc, Ws = _q(Wc, cdt), _q(Ws, cdt)
    B, twoP, S = p.shape
    pp = p.reshape(B, twoP // 2, 2, S)
    pa = pp[:, :, 0]
    pb = pp[:, :, 1] * msk[None, :, None]
    sub2t = "bpk,pjk->bpjk" if contract_x else "bpk,pik->bpik"

    def member(pm, Pc, Ps):
        s_re = _q(torch.einsum("bps,ks->bpk", pm, Wc), cdt)
        s_im = _q(-torch.einsum("bps,ks->bpk", pm, Ws), cdt)
        h_re = torch.einsum(sub2t, s_re, Pc) + torch.einsum(sub2t, s_im, Ps)
        h_im = -torch.einsum(sub2t, s_re, Ps) + torch.einsum(sub2t, s_im, Pc)
        return h_re, h_im

    h_re_a, h_im_a = member(pa, PcA, PsA)
    h_re_b, h_im_b = member(pb, PcB, PsB)
    h_re = h_re_a + h_re_b
    h_im = h_im_a + sgn[None, :, None, None] * h_im_b
    sub1t = "bpjk,pik->bji" if contract_x else "bpik,pjk->bji"
    return (torch.einsum(sub1t, _q(h_re, cdt), Tc)
            + torch.einsum(sub1t, _q(h_im, cdt), Ts))


#: rows (image rows, table rows) of one tensor-core GEMM tile, its depth
#: chunk, and the padding of the interleaved frequency axis
#: (csrc/radon_pair_tc.cu TC_BM, TC_BK, FW_BN); the adjoint's output tile
#: is _TC_ROWS x _TC_ADJ_COLS
_TC_ROWS = 128
_TC_DEPTH = 64
_TC_FREQ_PAD = 128
_TC_ADJ_COLS = 256


def _tc_dims(N: int, K: int) -> tuple:
    """(Np, 2Kp): the tables' padded row count and interleaved width."""
    return (_TC_ROWS * math.ceil(N / _TC_ROWS),
            _TC_FREQ_PAD * math.ceil(2 * K / _TC_FREQ_PAD))


def _tc_pad(n: int) -> int:
    """n rounded up to a whole 128-row (or 128-column) tensor-core tile."""
    return _TC_ROWS * math.ceil(n / _TC_ROWS)


def _interleave(trig, cdt):
    """(re, im) pairs of (P, N, K) trig tensors as one (len(trig)/2, P, Np,
    2Kp) table with (re, im) interleaved along the frequency axis and zeros
    in the padding; bf16 for ``cdt=torch.bfloat16``, else the working dtype."""
    P, N, K = trig[0].shape
    Np, K2p = _tc_dims(N, K)
    tab = trig[0].new_zeros(len(trig) // 2, P, Np, K2p)
    for t in range(len(trig) // 2):
        tab[t, :, :N, 0:2 * K:2] = trig[2 * t]
        tab[t, :, :N, 1:2 * K:2] = trig[2 * t + 1]
    return tab.to(torch.bfloat16) if cdt == torch.bfloat16 else tab


def _pair_tables(pos, sha, shb, spec, L, cdt=torch.bfloat16):
    """Plain version of :func:`build_pair_tables`: the six (P, N, K) trig
    tensors of :func:`_pair_spectral_tensors` as one (3, P, Np, 2Kp) table,
    [T̂, φ_a, φ_b] (layout of :func:`_interleave`)."""
    return _interleave(_pair_spectral_tensors(pos, sha, shb, spec, L, cdt), cdt)


def _split(x: torch.Tensor):
    """(hi, lo) of the split-bf16 route in ``x``'s dtype: hi = bf16(x),
    lo = bf16(x − hi) (x − hi is exact)."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def _split_tables(trig):
    """The split route's (T, phi) from (re, im) pairs of f32 trig tensors,
    T̂ first: T̂ as (2, P, Np, 2Kp) bf16 [hi, lo] and the φ tables as (M, P,
    Np, 2Kp) in the working dtype, unrounded (layout of :func:`_interleave`)."""
    tab = _interleave(trig, torch.float32)
    return torch.stack(_split(tab[0])).to(torch.bfloat16), tab[1:].contiguous()


def _pair_split_tables(pos, sha, shb, spec, L):
    """Plain version of :func:`build_pair_split_tables`: T̂ hi/lo and
    [φ_a, φ_b] (:func:`_split_tables`)."""
    return _split_tables(_pair_spectral_tensors(pos, sha, shb, spec, L))


def _tab_parts(tab, dtype):
    """(T̂ planes, φ tables) of either table kind in ``dtype``: [T̂] and the
    φs of a (1 + M, P, Np, 2Kp) table; [T̂ hi, T̂ lo] and φ of split tables
    (T, phi)."""
    if isinstance(tab, tuple):
        return tab[0].to(dtype), tab[1].to(dtype)
    t = tab.to(dtype)
    return t[:1], t[1:]


def _stage1(sub, a, T):
    """einsum(sub, a, T̂) from one T̂ plane, or the split route's three
    products hi·hi + hi·lo + lo·hi (a split as :func:`_split`) from two."""
    if T.shape[0] == 1:
        return torch.einsum(sub, a, T[0])
    ah, al = _split(a)
    return (torch.einsum(sub, ah, T[0]) + torch.einsum(sub, ah, T[1])) + torch.einsum(sub, al, T[0])


def _padded_image(f, Np: int, contract_x: bool, cdt):
    """F rounded to ``cdt`` and zero-padded to (B, Np, Np): f for the x
    group, its transpose for the y group (the forward's A operand)."""
    B, N, _ = f.shape
    Fp = f.new_zeros(B, Np, Np)
    Fp[:, :N, :N] = _q(f if contract_x else f.transpose(1, 2), cdt)
    return Fp


def _tile_sum(part):
    """Σ over dim 0 in index order (the kernels' fixed reduction order)."""
    out = part[0]
    for t in range(1, part.shape[0]):
        out = out + part[t]
    return out


def _depth_gemm(h, T, N: int, G: int, contract_x: bool, cdt):
    """Stage 1ᵀ of the tensor-core adjoints: h (B, P, Np, 2Kp) rounded to
    ``cdt`` against the T̂ planes (1 or 2, P, Np, 2Kp; two: the split
    route's hi and lo, with h split too, :func:`_stage1`), depth (row group,
    k, re/im) flattened; slice g takes 64-deep chunks [n·g/G, n·(g+1)/G) of
    the n = P·2Kp/64, and the G partial images are summed in slice order.
    The y group's image comes back transposed."""
    B, P, Np, K2p = h.shape
    hd = _q(h, cdt).permute(0, 2, 1, 3).reshape(B, Np, P * K2p)
    td = T.permute(0, 1, 3, 2).reshape(T.shape[0], P * K2p, Np)
    n = P * K2p // _TC_DEPTH
    out = None
    for g in range(G):
        lo, hi = n * g // G * _TC_DEPTH, n * (g + 1) // G * _TC_DEPTH
        part = _stage1("brd,dc->brc", hd[:, :, lo:hi], td[:, lo:hi])
        out = part if out is None else out + part
    out = out[:, :N, :N]
    return (out if contract_x else out.transpose(1, 2)).contiguous()


def _pair_forward_tc(f, tab, sgn, Wc, Ws, contract_x: bool, cdt=torch.bfloat16):
    """The tensor-core forward's arithmetic in its order, from the tables
    (:func:`_pair_tables`, or the split route's :func:`_pair_split_tables`
    with ``cdt=torch.float32``: F and T̂ split into hi and lo, three
    products): F rounded and zero-padded to (B, Np, Np), ĝ over the padded
    depth, one partial Ŝ per 128-row tile, the partials summed in row-tile
    order, then stage 3. Equals :func:`_project_pair_group` up to f32
    summation order (and, split, the dropped lo·lo term)."""
    B, N, _ = f.shape
    T, phi = _tab_parts(tab, f.dtype)
    _, P, Np, K2p = T.shape
    K = Wc.shape[0]
    R = Np // _TC_ROWS
    Fp = _padded_image(f, Np, contract_x, cdt)
    g = _stage1("brc,pcn->bprn", Fp, T)                        # (B, P, Np, 2Kp)
    gr = g[..., 0::2].reshape(B, P, R, _TC_ROWS, -1)
    gi = g[..., 1::2].reshape(B, P, R, _TC_ROWS, -1)
    gib = gi * sgn[None, :, None, None, None]
    ca, sa, cb, sb = (phi[m][..., ri::2].reshape(P, R, _TC_ROWS, -1)
                      for m in (0, 1) for ri in (0, 1))
    part = torch.stack([(gr * ca - gi * sa).sum(3), (gr * sa + gi * ca).sum(3),
                        (gr * cb - gib * sb).sum(3), (gr * sb + gib * cb).sum(3)])
    shat = _q(_tile_sum(part.movedim(3, 0))[..., :K], cdt)  # (4, B, P, K)
    Wc, Ws = _q(Wc, cdt), _q(Ws, cdt)
    out = torch.stack([shat[2 * m] @ Wc - shat[2 * m + 1] @ Ws for m in (0, 1)], dim=2)
    return out.reshape(B, 2 * P, -1)


def _pair_adjoint_tc(p, tab, sgn, msk, Wc, Ws, contract_x: bool, N: int, G: int,
                     cdt=torch.bfloat16):
    """The tensor-core adjoint's arithmetic in its order, from the tables
    (as :func:`_pair_forward_tc`; split, h and T̂ go into the products as hi
    and lo): Ŝ = Wᵀ p rounded, h built per (pair, k) and rounded, one GEMM
    over (pair, k, re/im) per slice of :func:`pair_adjoint_splits` (slices
    of 64-deep chunks), the G partial images summed in slice order. Equals
    :func:`_backproject_pair_group` up to f32 summation order."""
    B, twoP, S = p.shape
    P = twoP // 2
    T, phi = _tab_parts(tab, p.dtype)
    _, _, Np, K2p = T.shape
    K = Wc.shape[0]
    pp = _q(p, cdt).reshape(B, P, 2, S)
    pm = torch.stack([pp[:, :, 0], pp[:, :, 1] * msk[None, :, None]], dim=2)
    shat = p.new_zeros(B, P, 2, K2p // 2, 2)
    shat[..., :K, 0] = _q(pm @ _q(Wc, cdt).T, cdt)
    shat[..., :K, 1] = _q(-(pm @ _q(Ws, cdt).T), cdt)
    sra, sia = shat[:, :, 0, None, :, 0], shat[:, :, 0, None, :, 1]   # (B, P, 1, Kp)
    srb, sib = shat[:, :, 1, None, :, 0], shat[:, :, 1, None, :, 1]
    ca, sa, cb, sb = (phi[m][None, ..., ri::2] for m in (0, 1) for ri in (0, 1))
    sg = sgn[None, :, None, None]
    h = torch.empty(B, P, Np, K2p, dtype=p.dtype, device=p.device)
    h[..., 0::2] = (sra * ca + sia * sa) + (srb * cb + sib * sb)
    h[..., 1::2] = (-(sra * sa) + sia * ca) + sg * (-(srb * sb) + sib * cb)
    return _depth_gemm(h, T, N, G, contract_x, cdt)


def _spectral_tensors(pos, shift, spec, L, cdt=torch.float32):
    """Per-angle splat T̂ and shear phase φ, each (A_g, N, K):
    T̂ = spec·e^{−2πik·pos/L}, φ = e^{+2πik·shift/L}."""
    K = spec.shape[0]
    k = _kfreq(K, L, pos.dtype, pos.device)
    ang_t = pos[:, :, None] * k[None, None, :]
    Tc = _q(spec * torch.cos(ang_t), cdt)
    Ts = _q(-spec * torch.sin(ang_t), cdt)
    ang_p = shift[:, :, None] * k[None, None, :]
    return Tc, Ts, _q(torch.cos(ang_p), cdt), _q(torch.sin(ang_p), cdt)


def _group_tables(pos, shift, spec, L, cdt=torch.bfloat16):
    """Plain version of :func:`build_group_tables`: the four (A, N, K) trig
    tensors of :func:`_spectral_tensors` as one (2, A, Np, 2Kp) table,
    [T̂, φ] (layout of :func:`_interleave`)."""
    return _interleave(_spectral_tensors(pos, shift, spec, L, cdt), cdt)


def _group_split_tables(pos, shift, spec, L):
    """Plain version of :func:`build_group_split_tables`: T̂ hi/lo and φ
    (:func:`_split_tables`)."""
    return _split_tables(_spectral_tensors(pos, shift, spec, L))


def _group_forward_tc(f, tab, Wc, Ws, contract_x: bool, cdt=torch.bfloat16):
    """The per-angle tensor-core forward's arithmetic in its order, from the
    tables (:func:`_pair_forward_tc` with one member per angle; split tables
    with ``cdt=torch.float32``). Equals :func:`_project_group` up to f32
    summation order (and, split, the dropped lo·lo term)."""
    B, N, _ = f.shape
    T, phi = _tab_parts(tab, f.dtype)
    _, A, Np, K2p = T.shape
    K = Wc.shape[0]
    R = Np // _TC_ROWS
    g = _stage1("brc,acn->barn", _padded_image(f, Np, contract_x, cdt), T)
    gr = g[..., 0::2].reshape(B, A, R, _TC_ROWS, -1)
    gi = g[..., 1::2].reshape(B, A, R, _TC_ROWS, -1)
    c, s = (phi[0][..., ri::2].reshape(A, R, _TC_ROWS, -1) for ri in (0, 1))
    part = torch.stack([(gr * c - gi * s).sum(3), (gr * s + gi * c).sum(3)])
    shat = _q(_tile_sum(part.movedim(3, 0))[..., :K], cdt)  # (2, B, A, K)
    return shat[0] @ _q(Wc, cdt) - shat[1] @ _q(Ws, cdt)


def _group_adjoint_tc(p, tab, Wc, Ws, contract_x: bool, N: int, G: int,
                      cdt=torch.bfloat16):
    """The per-angle tensor-core adjoint's arithmetic in its order, from the
    tables (as :func:`_group_forward_tc`; split, h and T̂ go into the
    products as hi and lo): Ŝ = Wᵀ p rounded, h = Ŝ·conj(φ) built per
    (angle, k) and rounded, one GEMM over (angle, k, re/im) per slice of
    :func:`group_adjoint_splits`, the G partial images summed in slice
    order. Equals :func:`_backproject_group` up to f32 summation order."""
    B, A, S = p.shape
    T, phi = _tab_parts(tab, p.dtype)
    _, _, Np, K2p = T.shape
    K = Wc.shape[0]
    pq = _q(p, cdt)
    shat = p.new_zeros(B, A, 1, K2p // 2, 2)
    shat[:, :, 0, :K, 0] = _q(pq @ _q(Wc, cdt).T, cdt)
    shat[:, :, 0, :K, 1] = _q(-(pq @ _q(Ws, cdt).T), cdt)
    sr, si = shat[..., 0], shat[..., 1]                       # (B, A, 1, Kp)
    c, s = phi[0][None, ..., 0::2], phi[0][None, ..., 1::2]   # (1, A, Np, Kp)
    h = torch.empty(B, A, Np, K2p, dtype=p.dtype, device=p.device)
    h[..., 0::2] = sr * c + si * s
    h[..., 1::2] = -(sr * s) + si * c
    return _depth_gemm(h, T, N, G, contract_x, cdt)


def _project_group(f, pos, shift, spec, Wc, Ws, L, contract_x: bool,
                   cdt=torch.float32):
    """Plain per-angle forward of one angle group: f (B,N,N) → (B, A_g, S).
    ĝ = f·T̂ (stage 1), Ŝ = Σ_rows ĝ·φ (stage 2), p = Re Ŝ·Wc − Im Ŝ·Ws
    (stage 3); ``contract_x`` contracts the image x-axis (else y)."""
    Tc, Ts, Pc, Ps = _spectral_tensors(pos, shift, spec, L, cdt)
    f = _q(f, cdt)
    Wc, Ws = _q(Wc, cdt), _q(Ws, cdt)
    sub1 = "bji,aik->bajk" if contract_x else "bji,ajk->baik"
    gr = torch.einsum(sub1, f, Tc)
    gi = torch.einsum(sub1, f, Ts)
    sub2 = "bajk,ajk->bak" if contract_x else "baik,aik->bak"
    s_re = torch.einsum(sub2, gr, Pc) - torch.einsum(sub2, gi, Ps)
    s_im = torch.einsum(sub2, gr, Ps) + torch.einsum(sub2, gi, Pc)
    return (torch.einsum("bak,ks->bas", _q(s_re, cdt), Wc)
            - torch.einsum("bak,ks->bas", _q(s_im, cdt), Ws))


def _backproject_group(p, pos, shift, spec, Wc, Ws, L, contract_x: bool,
                       cdt=torch.float32):
    """Plain exact transpose of :func:`_project_group`:
    p (B, A_g, S) → (B, N, N), summed over the group's angles."""
    Tc, Ts, Pc, Ps = _spectral_tensors(pos, shift, spec, L, cdt)
    p = _q(p, cdt)
    Wc, Ws = _q(Wc, cdt), _q(Ws, cdt)
    s_re = _q(torch.einsum("bas,ks->bak", p, Wc), cdt)
    s_im = _q(-torch.einsum("bas,ks->bak", p, Ws), cdt)
    sub2t = "bak,ajk->bajk" if contract_x else "bak,aik->baik"
    h_re = torch.einsum(sub2t, s_re, Pc) + torch.einsum(sub2t, s_im, Ps)
    h_im = -torch.einsum(sub2t, s_re, Ps) + torch.einsum(sub2t, s_im, Pc)
    sub1t = "bajk,aik->bji" if contract_x else "baik,ajk->bji"
    return (torch.einsum(sub1t, _q(h_re, cdt), Tc)
            + torch.einsum(sub1t, _q(h_im, cdt), Ts))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


_F = ctypes.c_float

# C entry point → argument types; "radon_<family>_<op>" lives in
# csrc/radon_<family>.cu
_ARGTYPES = {
    "radon_pair_tc_tables": [_P] * 5 + [_I] * 5 + [_F, _P],
    "radon_pair_tc_project": [_P] * 8 + [_I] * 8 + [_P],
    "radon_pair_tc_backproject": [_P] * 9 + [_I] * 9 + [_P],
    "radon_pair_split_tables": [_P] * 6 + [_I] * 5 + [_F, _P],
    "radon_pair_split_project": [_P] * 9 + [_I] * 8 + [_P],
    "radon_pair_split_backproject": [_P] * 10 + [_I] * 9 + [_P],
    "radon_group_tc_tables": [_P] * 4 + [_I] * 5 + [_F, _P],
    "radon_group_tc_project": [_P] * 9 + [_I] * 9 + [_P],
    "radon_group_tc_backproject": [_P] * 9 + [_I] * 10 + [_P],
    "radon_group_split_tables": [_P] * 5 + [_I] * 5 + [_F, _P],
    "radon_group_split_project": [_P] * 8 + [_I] * 8 + [_P],
    "radon_group_split_backproject": [_P] * 8 + [_I] * 9 + [_P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    """Build (at first use) the library holding ``name`` and bind it."""
    from pdunet_tpu_torch.ops.radon._build import load_library

    fn = getattr(load_library(name.rsplit("_", 1)[0]), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _compute_flag(cdt) -> int:
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cdt must be torch.float32 or torch.bfloat16, got {cdt}")
    return int(cdt == torch.bfloat16)


def _check_device(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}; use a CPU or CUDA tensor")


def _check_dispatch(x: torch.Tensor, L: int, K: int):
    _check_device(x)
    if K != L // 2 + 1:
        raise ValueError(f"spec has K={K} frequencies, expected L//2+1={L // 2 + 1}")


def _check_pair_plan(pos, sha, shb, sgn, msk, spec, Wc, Ws, P, N, K, S, dev):
    for name, t in (("pos", pos), ("sha", sha), ("shb", shb)):
        _check(name, t, (P, N), dev)
    _check("sgn", sgn, (P,), dev)
    if msk is not None:
        _check("msk", msk, (P,), dev)
    _check("spec", spec, (K,), dev)
    _check("Wc", Wc, (K, S), dev)
    _check("Ws", Ws, (K, S), dev)


def _check_tables(tables, n_tab, P, N, K, dev):
    """The tensor-core route's tables: (n_tab, P, Np, 2Kp) bf16 on ``dev``
    (3 for pairs, :func:`build_pair_tables`; 2 per angle,
    :func:`build_group_tables`)."""
    if tables is None:
        builder = "build_pair_tables" if n_tab == 3 else "build_group_tables"
        raise ValueError(f"a CUDA bf16 projector call needs the plan's trig tables "
                         f"({builder} of the same plan rows)")
    Np, K2p = _tc_dims(N, K)
    if tables.device != dev:
        raise ValueError(f"tables are on {tables.device}, expected {dev}")
    if tables.dtype != torch.bfloat16:
        raise TypeError(f"tables must be bfloat16, got {tables.dtype}")
    if tuple(tables.shape) != (n_tab, P, Np, K2p):
        raise ValueError(f"tables have shape {tuple(tables.shape)}, "
                         f"expected {(n_tab, P, Np, K2p)}")
    if not tables.is_contiguous() or tables.data_ptr() % 16:
        raise ValueError("tables must be contiguous and 16-byte aligned")


def _check_split_tables(tables, n_phi, P, N, K, dev):
    """The split route's tables: T̂ as (2, P, Np, 2Kp) bf16 and φ as (n_phi,
    P, Np, 2Kp) float32 on ``dev`` (2 φ tables for pairs,
    :func:`build_pair_split_tables`; 1 per angle,
    :func:`build_group_split_tables`)."""
    if not isinstance(tables, tuple) or len(tables) != 2:
        builder = "build_pair_split_tables" if n_phi == 2 else "build_group_split_tables"
        raise ValueError(f"a CUDA float32 projector call needs the plan's split trig "
                         f"tables ({builder} of the same plan rows)")
    Np, K2p = _tc_dims(N, K)
    for name, t, dt, n in zip(("T", "phi"), tables, (torch.bfloat16, torch.float32),
                              (2, n_phi)):
        if t.device != dev:
            raise ValueError(f"split table {name} is on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"split table {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != (n, P, Np, K2p):
            raise ValueError(f"split table {name} has shape {tuple(t.shape)}, "
                             f"expected {(n, P, Np, K2p)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"split table {name} must be contiguous and 16-byte aligned")


def _table_ptrs(tables):
    """Device pointers of a route's tables: the bf16 table, or the split
    route's (T̂ hi/lo, φ) pair."""
    return [t.data_ptr() for t in tables] if isinstance(tables, tuple) else [tables.data_ptr()]


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _launch(name, *args):
    """Call the C entry point ``name`` on the current stream; a launch
    error raises."""
    _raise_on(_fn(name)(*args, torch.cuda.current_stream().cuda_stream), name)


def build_pair_tables(pos, sha, shb, spec, L):
    """The tensor-core route's trig tables of one pair group: (3, P, Np, 2Kp)
    bf16, [T̂, φ_a, φ_b] with (re, im) interleaved along the frequency axis,
    Np = 128·⌈N/128⌉, 2Kp = 128·⌈2K/128⌉, zero-padded (layout of
    :func:`_pair_tables`). CPU tensors run :func:`_pair_tables`; CUDA
    tensors launch the kernel of ``csrc/radon_pair_tc.cu``, which forms each
    value as the plain builder does (its argument rounding, precise
    sincosf)."""
    if pos.device.type == "cpu":
        return _pair_tables(pos, sha, shb, spec, L)
    _check_device(pos)
    P, N = pos.shape
    K = spec.shape[0]
    dev = pos.device
    for name, t in (("pos", pos), ("sha", sha), ("shb", shb)):
        _check(name, t, (P, N), dev)
    _check("spec", spec, (K,), dev)
    Np, K2p = _tc_dims(N, K)
    tab = torch.empty((3, P, Np, K2p), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _launch("radon_pair_tc_tables", pos.data_ptr(), sha.data_ptr(), shb.data_ptr(),
                spec.data_ptr(), tab.data_ptr(), P, N, Np, K, K2p // 2, 2.0 * math.pi / L)
    build_pair_tables.launches += 1
    return tab


def build_pair_split_tables(pos, sha, shb, spec, L):
    """The split-bf16 route's trig tables of one pair group: (T, phi), T̂ as
    (2, P, Np, 2Kp) bf16 [hi, lo] and [φ_a, φ_b] as (2, P, Np, 2Kp) float32,
    (re, im) interleaved along the frequency axis and zero-padded as in
    :func:`build_pair_tables` (layout of :func:`_pair_split_tables`). CPU
    tensors run :func:`_pair_split_tables`; CUDA tensors launch the kernel of
    ``csrc/radon_pair_split.cu``, which forms each value as the plain
    builder does."""
    if pos.device.type == "cpu":
        return _pair_split_tables(pos, sha, shb, spec, L)
    _check_device(pos)
    P, N = pos.shape
    K = spec.shape[0]
    dev = pos.device
    for name, t in (("pos", pos), ("sha", sha), ("shb", shb)):
        _check(name, t, (P, N), dev)
    _check("spec", spec, (K,), dev)
    Np, K2p = _tc_dims(N, K)
    T = torch.empty((2, P, Np, K2p), dtype=torch.bfloat16, device=dev)
    phi = torch.empty((2, P, Np, K2p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("radon_pair_split_tables", pos.data_ptr(), sha.data_ptr(), shb.data_ptr(),
                spec.data_ptr(), T.data_ptr(), phi.data_ptr(), P, N, Np, K, K2p // 2,
                2.0 * math.pi / L)
    build_pair_split_tables.launches += 1
    return T, phi


#: output tile columns of the split route's adjoint (csrc/radon_tc.cuh AS_BN)
_SPLIT_ADJ_COLS = 128


def pair_adjoint_splits(B: int, N: int, P: int, n_sms: int, cols: int = _TC_ADJ_COLS) -> int:
    """How many slices a tensor-core pair adjoint splits its depth (the
    pairs' 64-deep chunks of (k, re/im), in order) into: as many as its
    (128-row x ``cols``-column) output tiles times the slices fit in one
    wave of one block per SM, so that no second, part-empty wave runs; never
    more slices than pairs. Each slice writes a partial image, summed in
    slice order. ``cols`` is 256 for the bf16 route, 128 for the split one."""
    tiles = B * math.ceil(N / _TC_ROWS) * math.ceil(N / cols)
    return max(1, min(P, n_sms // tiles))


def project_pair_group(f, pos, sha, shb, sgn, spec, Wc, Ws, L,
                       contract_x: bool, cdt=torch.float32, tables=None):
    """Fused mirror-pair forward for one angle group:
    f (B,N,N) → (B, 2P, S) float32, rows interleaved [pair0-a, pair0-b, ...].

    CPU tensors run :func:`_project_pair_group`. CUDA tensors launch, with
    bf16 operands, the tensor-core kernels of ``csrc/radon_pair_tc.cu``,
    which read ``tables`` (:func:`build_pair_tables` of the same rows); with
    float32 operands the split-bf16 kernels of ``csrc/radon_pair_split.cu``,
    which read ``tables`` from :func:`build_pair_split_tables`. Either
    raises without its tables."""
    if f.device.type == "cpu":
        return _project_pair_group(f, pos, sha, shb, sgn, spec, Wc, Ws, L,
                                   contract_x, cdt)
    K, S = Wc.shape
    _check_dispatch(f, L, K)
    split = not _compute_flag(cdt)
    B, N, _ = f.shape
    P = pos.shape[0]
    dev = f.device
    if split:
        _check_split_tables(tables, 2, P, N, K, dev)
    else:
        _check_tables(tables, 3, P, N, K, dev)
    _check("f", f, (B, N, N), dev)
    _check_pair_plan(pos, sha, shb, sgn, None, spec, Wc, Ws, P, N, K, S, dev)
    Np, K2p = _tc_dims(N, K)
    out = torch.empty((B, 2 * P, S), dtype=torch.float32, device=dev)
    # F in bf16; split: its hi and lo planes
    fb = torch.empty((1 + split, B, Np, Np), dtype=torch.bfloat16, device=dev)
    part = torch.empty((Np // _TC_ROWS, B, 2 * P, K, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("radon_pair_split_project" if split else "radon_pair_tc_project",
                f.data_ptr(), *_table_ptrs(tables), sgn.data_ptr(), Wc.data_ptr(),
                Ws.data_ptr(), fb.data_ptr(), part.data_ptr(), out.data_ptr(),
                B, N, Np, P, K, K2p // 2, S, int(contract_x))
    project_pair_group.launches += 1
    if split:
        project_pair_group.launches_split += 1
    else:
        project_pair_group.launches_tc += 1
    return out


def backproject_pair_group(p, pos, sha, shb, sgn, msk, spec, Wc, Ws, L,
                           contract_x: bool, N: int, cdt=torch.float32, tables=None):
    """Fused mirror-pair adjoint for one angle group:
    p (B, 2P, S) interleaved → (B, N, N) float32.

    CPU tensors run :func:`_backproject_pair_group`; CUDA tensors take the
    routes of :func:`project_pair_group`."""
    if p.device.type == "cpu":
        return _backproject_pair_group(p, pos, sha, shb, sgn, msk, spec, Wc,
                                       Ws, L, contract_x, cdt)
    K, S = Wc.shape
    _check_dispatch(p, L, K)
    split = not _compute_flag(cdt)
    B = p.shape[0]
    P = pos.shape[0]
    dev = p.device
    if split:
        _check_split_tables(tables, 2, P, N, K, dev)
    else:
        _check_tables(tables, 3, P, N, K, dev)
    _check("p", p, (B, 2 * P, S), dev)
    _check_pair_plan(pos, sha, shb, sgn, msk, spec, Wc, Ws, P, N, K, S, dev)
    Np, K2p = _tc_dims(N, K)
    G = pair_adjoint_splits(B, N, P, torch.cuda.get_device_properties(dev).multi_processor_count,
                            _SPLIT_ADJ_COLS if split else _TC_ADJ_COLS)
    out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    shat = torch.empty((B, P, K2p // 2, 4), dtype=torch.float32, device=dev)
    part = (torch.empty((G, B, N, N), dtype=torch.float32, device=dev)
            if G > 1 else None)
    with torch.cuda.device(dev):
        _launch("radon_pair_split_backproject" if split else "radon_pair_tc_backproject",
                p.data_ptr(), *_table_ptrs(tables), sgn.data_ptr(), msk.data_ptr(),
                Wc.data_ptr(), Ws.data_ptr(), shat.data_ptr(),
                None if part is None else part.data_ptr(), out.data_ptr(),
                B, N, Np, P, K, K2p // 2, S, G, int(contract_x))
    backproject_pair_group.launches += 1
    if split:
        backproject_pair_group.launches_split += 1
    else:
        backproject_pair_group.launches_tc += 1
    return out


def _check_group_plan(pos, shift, spec, Wc, Ws, A, N, K, S, dev):
    for name, t in (("pos", pos), ("shift", shift)):
        _check(name, t, (A, N), dev)
    _check("spec", spec, (K,), dev)
    _check("Wc", Wc, (K, S), dev)
    _check("Ws", Ws, (K, S), dev)


def build_group_tables(pos, shift, spec, L):
    """The per-angle tensor-core route's trig tables of one angle group:
    (2, A, Np, 2Kp) bf16, [T̂, φ] with (re, im) interleaved along the
    frequency axis, Np = 128·⌈N/128⌉, 2Kp = 128·⌈2K/128⌉, zero-padded (layout
    of :func:`_group_tables`). K is read off ``spec``. CPU tensors run
    :func:`_group_tables`; CUDA tensors launch the kernel of
    ``csrc/radon_group_tc.cu``, which forms each value as the plain builder
    does."""
    if pos.device.type == "cpu":
        return _group_tables(pos, shift, spec, L)
    _check_device(pos)
    A, N = pos.shape
    K = spec.shape[0]
    dev = pos.device
    for name, t in (("pos", pos), ("shift", shift)):
        _check(name, t, (A, N), dev)
    _check("spec", spec, (K,), dev)
    Np, K2p = _tc_dims(N, K)
    tab = torch.empty((2, A, Np, K2p), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _launch("radon_group_tc_tables", pos.data_ptr(), shift.data_ptr(), spec.data_ptr(),
                tab.data_ptr(), A, N, Np, K, K2p // 2, 2.0 * math.pi / L)
    build_group_tables.launches += 1
    return tab


def build_group_split_tables(pos, shift, spec, L):
    """The per-angle split-bf16 route's trig tables of one angle group:
    (T, phi), T̂ as (2, A, Np, 2Kp) bf16 [hi, lo] and φ as (1, A, Np, 2Kp)
    float32, (re, im) interleaved along the frequency axis and zero-padded
    as in :func:`build_group_tables` (layout of :func:`_group_split_tables`).
    K is read off ``spec``. CPU tensors run :func:`_group_split_tables`;
    CUDA tensors launch the kernel of ``csrc/radon_group_split.cu``, which
    forms each value as the plain builder does."""
    if pos.device.type == "cpu":
        return _group_split_tables(pos, shift, spec, L)
    _check_device(pos)
    A, N = pos.shape
    K = spec.shape[0]
    dev = pos.device
    for name, t in (("pos", pos), ("shift", shift)):
        _check(name, t, (A, N), dev)
    _check("spec", spec, (K,), dev)
    Np, K2p = _tc_dims(N, K)
    T = torch.empty((2, A, Np, K2p), dtype=torch.bfloat16, device=dev)
    phi = torch.empty((1, A, Np, K2p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("radon_group_split_tables", pos.data_ptr(), shift.data_ptr(), spec.data_ptr(),
                T.data_ptr(), phi.data_ptr(), A, N, Np, K, K2p // 2, 2.0 * math.pi / L)
    build_group_split_tables.launches += 1
    return T, phi


def group_adjoint_splits(B: int, N: int, A: int, n_sms: int, cols: int = _TC_ADJ_COLS) -> int:
    """How many slices a per-angle tensor-core adjoint splits its depth (the
    angles' 64-deep chunks of (k, re/im), in order) into: as many as its
    (128-row x ``cols``-column) output tiles times the slices fit in one
    wave of one block per SM, so that no second, part-empty wave runs; never
    more slices than angles. Each slice writes a partial image, summed in
    slice order. ``cols`` is 256 for the bf16 route, 128 for the split one."""
    tiles = B * math.ceil(N / _TC_ROWS) * math.ceil(N / cols)
    return max(1, min(A, n_sms // tiles))


def project_group(f, pos, shift, spec, Wc, Ws, L, contract_x: bool,
                  cdt=torch.float32, tables=None):
    """Fused per-angle forward for one angle group:
    f (B,N,N) → (B, A_g, S) float32. K and S are read off ``Wc``; no
    relation between K and L is assumed.

    CPU tensors run :func:`_project_group`. CUDA tensors launch, with bf16
    operands, the tensor-core kernels of ``csrc/radon_group_tc.cu``, which
    read ``tables`` (:func:`build_group_tables` of the same rows); with
    float32 operands the split-bf16 kernels of ``csrc/radon_group_split.cu``,
    which read ``tables`` from :func:`build_group_split_tables`. Either
    raises without its tables."""
    if f.device.type == "cpu":
        return _project_group(f, pos, shift, spec, Wc, Ws, L, contract_x, cdt)
    _check_device(f)
    split = not _compute_flag(cdt)
    K, S = Wc.shape
    B, N, _ = f.shape
    A = pos.shape[0]
    dev = f.device
    if split:
        _check_split_tables(tables, 1, A, N, K, dev)
    else:
        _check_tables(tables, 2, A, N, K, dev)
    _check("f", f, (B, N, N), dev)
    _check_group_plan(pos, shift, spec, Wc, Ws, A, N, K, S, dev)
    Np, K2p = _tc_dims(N, K)
    bf16 = torch.bfloat16
    out = torch.empty((B, A, S), dtype=torch.float32, device=dev)
    # F in bf16; split: its hi and lo planes
    fb = torch.empty((1 + split, B, Np, Np), dtype=bf16, device=dev)
    part = torch.empty((Np // _TC_ROWS, B, A, K, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if split:
            _launch("radon_group_split_project",
                    f.data_ptr(), *_table_ptrs(tables), Wc.data_ptr(), Ws.data_ptr(),
                    fb.data_ptr(), part.data_ptr(), out.data_ptr(),
                    B, N, Np, A, K, K2p // 2, S, int(contract_x))
        else:
            Sp = _tc_pad(S)
            sb = torch.empty((_tc_pad(B * A), K2p), dtype=bf16, device=dev)
            wb = torch.empty((K2p, Sp), dtype=bf16, device=dev)
            _launch("radon_group_tc_project",
                    f.data_ptr(), tables.data_ptr(), Wc.data_ptr(), Ws.data_ptr(),
                    fb.data_ptr(), part.data_ptr(), sb.data_ptr(), wb.data_ptr(),
                    out.data_ptr(), B, N, Np, A, K, K2p // 2, S, Sp, int(contract_x))
    project_group.launches += 1
    if split:
        project_group.launches_split += 1
    else:
        project_group.launches_tc += 1
    return out


def backproject_group(p, pos, shift, spec, Wc, Ws, L, contract_x: bool, N: int,
                      cdt=torch.float32, tables=None):
    """Fused per-angle adjoint for one angle group:
    p (B, A_g, S) → (B, N, N) float32, the y group already transposed.

    CPU tensors run :func:`_backproject_group`; CUDA tensors take the routes
    of :func:`project_group`."""
    if p.device.type == "cpu":
        return _backproject_group(p, pos, shift, spec, Wc, Ws, L, contract_x, cdt)
    _check_device(p)
    split = not _compute_flag(cdt)
    K, S = Wc.shape
    B, A, _ = p.shape
    dev = p.device
    if split:
        _check_split_tables(tables, 1, A, N, K, dev)
    else:
        _check_tables(tables, 2, A, N, K, dev)
    _check("p", p, (B, A, S), dev)
    _check_group_plan(pos, shift, spec, Wc, Ws, A, N, K, S, dev)
    Np, K2p = _tc_dims(N, K)
    G = group_adjoint_splits(B, N, A, torch.cuda.get_device_properties(dev).multi_processor_count,
                             _SPLIT_ADJ_COLS if split else _TC_ADJ_COLS)
    out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    shat = torch.empty((B, A, K2p // 2, 2), dtype=torch.float32, device=dev)
    part = (torch.empty((G, B, N, N), dtype=torch.float32, device=dev)
            if G > 1 else None)
    with torch.cuda.device(dev):
        if split:
            _launch("radon_group_split_backproject",
                    p.data_ptr(), *_table_ptrs(tables), Wc.data_ptr(), Ws.data_ptr(),
                    shat.data_ptr(), None if part is None else part.data_ptr(),
                    out.data_ptr(), B, N, Np, A, K, K2p // 2, S, G, int(contract_x))
        else:
            Sp = _tc_pad(S)
            pb = torch.empty((_tc_pad(B * A), Sp), dtype=torch.bfloat16, device=dev)
            wb = torch.empty((K2p, Sp), dtype=torch.bfloat16, device=dev)
            _launch("radon_group_tc_backproject",
                    p.data_ptr(), tables.data_ptr(), Wc.data_ptr(), Ws.data_ptr(),
                    pb.data_ptr(), wb.data_ptr(), shat.data_ptr(),
                    None if part is None else part.data_ptr(), out.data_ptr(),
                    B, N, Np, A, K, K2p // 2, S, Sp, G, int(contract_x))
    backproject_group.launches += 1
    if split:
        backproject_group.launches_split += 1
    else:
        backproject_group.launches_tc += 1
    return out


def reset_launch_counts():
    for fn in (project_pair_group, backproject_pair_group, build_pair_tables,
               build_pair_split_tables, project_group, backproject_group, build_group_tables,
               build_group_split_tables):
        fn.launches = 0
    for fn in (project_pair_group, backproject_pair_group, project_group, backproject_group):
        fn.launches_tc = 0
        fn.launches_split = 0


def _register_counters():
    """Register the wrappers' and table builders' counters with ``utils/trace.py``."""
    for fn in (project_pair_group, backproject_pair_group, build_pair_tables,
               build_pair_split_tables, project_group, backproject_group, build_group_tables,
               build_group_split_tables):
        for attr in ("launches", "launches_tc", "launches_split"):
            if hasattr(fn, attr):
                trace.counter(f"{fn.__name__}.{attr}", functools.partial(getattr, fn, attr))


reset_launch_counts()
_register_counters()
