"""Projector kernels: wrappers and their plain PyTorch versions.

Two families replace the Pallas kernels of
``pdunet_tpu/ops/radon/pallas_kernels.py``:

* mirror-pair, ``project_pair_group`` / ``backproject_pair_group``
  (``project_pair_group_pallas`` / ``backproject_pair_group_pallas``),
  kernels in ``csrc/radon_pair.cu``, for plans whose angles pair;
* per-angle, ``project_group`` / ``backproject_group``
  (``project_group_pallas`` / ``backproject_group_pallas``), kernels in
  ``csrc/radon_group.cu``, for plans whose angles do not pair (golden-angle
  spokes, the radial fourier-slice NUFFT).

For a CUDA tensor each wrapper launches its hand-written kernel (and raises
if it cannot); for a CPU tensor it runs the plain version below, which is
the port of the JAX twin of the same name (``_project_pair_group``,
``_project_group``, ... in ``pdunet_tpu/ops/radon/parallel.py``).

Precision contract (same as the twins): the trig arguments are f32 (or
f64 for a float64 input on the CPU, which ``gradcheck`` uses); with
``cdt=torch.bfloat16`` the operands T̂, φ, f or p, W and Ŝ (or h) are
rounded to bf16 where the twin casts them, and every sum accumulates in f32.

Each wrapper counts its kernel launches in ``<wrapper>.launches``; a CPU
call does not count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["project_pair_group", "backproject_pair_group", "project_group",
           "backproject_group", "reset_launch_counts"]


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
    "radon_pair_project": [_P] * 10 + [_I] * 5 + [_F, _I, _I, _P],
    "radon_pair_backproject": [_P] * 11 + [_I] * 5 + [_F, _I, _I, _P],
    "radon_group_project": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
    "radon_group_backproject": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P],
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


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def project_pair_group(f, pos, sha, shb, sgn, spec, Wc, Ws, L,
                       contract_x: bool, cdt=torch.float32):
    """Fused mirror-pair forward for one angle group:
    f (B,N,N) → (B, 2P, S) float32, rows interleaved [pair0-a, pair0-b, ...].

    CPU tensors run :func:`_project_pair_group`; CUDA tensors launch the
    kernel of ``csrc/radon_pair.cu``."""
    if f.device.type == "cpu":
        return _project_pair_group(f, pos, sha, shb, sgn, spec, Wc, Ws, L,
                                   contract_x, cdt)
    K, S = Wc.shape
    _check_dispatch(f, L, K)
    bf16 = _compute_flag(cdt)
    B, N, _ = f.shape
    P = pos.shape[0]
    dev = f.device
    _check("f", f, (B, N, N), dev)
    for name, t in (("pos", pos), ("sha", sha), ("shb", shb)):
        _check(name, t, (P, N), dev)
    _check("sgn", sgn, (P,), dev)
    _check("spec", spec, (K,), dev)
    _check("Wc", Wc, (K, S), dev)
    _check("Ws", Ws, (K, S), dev)
    out = torch.empty((B, 2 * P, S), dtype=torch.float32, device=dev)
    shat = torch.empty((B, 2 * P, K, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn("radon_pair_project")(
            f.data_ptr(), pos.data_ptr(), sha.data_ptr(), shb.data_ptr(),
            sgn.data_ptr(), spec.data_ptr(), Wc.data_ptr(), Ws.data_ptr(),
            shat.data_ptr(), out.data_ptr(), B, N, P, K, S, 2.0 * math.pi / L,
            int(contract_x), bf16, stream)
    project_pair_group.launches += 1
    _raise_on(rc, "project_pair_group")
    return out


def backproject_pair_group(p, pos, sha, shb, sgn, msk, spec, Wc, Ws, L,
                           contract_x: bool, N: int, cdt=torch.float32):
    """Fused mirror-pair adjoint for one angle group:
    p (B, 2P, S) interleaved → (B, N, N) float32.

    CPU tensors run :func:`_backproject_pair_group`; CUDA tensors launch the
    kernel of ``csrc/radon_pair.cu``."""
    if p.device.type == "cpu":
        return _backproject_pair_group(p, pos, sha, shb, sgn, msk, spec, Wc,
                                       Ws, L, contract_x, cdt)
    K, S = Wc.shape
    _check_dispatch(p, L, K)
    bf16 = _compute_flag(cdt)
    B, twoP, _ = p.shape
    P = pos.shape[0]
    dev = p.device
    _check("p", p, (B, 2 * P, S), dev)
    for name, t in (("pos", pos), ("sha", sha), ("shb", shb)):
        _check(name, t, (P, N), dev)
    _check("sgn", sgn, (P,), dev)
    _check("msk", msk, (P,), dev)
    _check("spec", spec, (K,), dev)
    _check("Wc", Wc, (K, S), dev)
    _check("Ws", Ws, (K, S), dev)
    out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    shat = torch.empty((B, P, 2, K, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn("radon_pair_backproject")(
            p.data_ptr(), pos.data_ptr(), sha.data_ptr(), shb.data_ptr(),
            sgn.data_ptr(), msk.data_ptr(), spec.data_ptr(), Wc.data_ptr(),
            Ws.data_ptr(), shat.data_ptr(), out.data_ptr(), B, N, P, K, S,
            2.0 * math.pi / L, int(contract_x), bf16, stream)
    backproject_pair_group.launches += 1
    _raise_on(rc, "backproject_pair_group")
    return out


def _check_group_plan(pos, shift, spec, Wc, Ws, A, N, K, S, dev):
    for name, t in (("pos", pos), ("shift", shift)):
        _check(name, t, (A, N), dev)
    _check("spec", spec, (K,), dev)
    _check("Wc", Wc, (K, S), dev)
    _check("Ws", Ws, (K, S), dev)


def project_group(f, pos, shift, spec, Wc, Ws, L, contract_x: bool,
                  cdt=torch.float32):
    """Fused per-angle forward for one angle group:
    f (B,N,N) → (B, A_g, S) float32. K and S are read off ``Wc``; no
    relation between K and L is assumed.

    CPU tensors run :func:`_project_group`; CUDA tensors launch the kernel
    of ``csrc/radon_group.cu``."""
    if f.device.type == "cpu":
        return _project_group(f, pos, shift, spec, Wc, Ws, L, contract_x, cdt)
    _check_device(f)
    bf16 = _compute_flag(cdt)
    K, S = Wc.shape
    B, N, _ = f.shape
    A = pos.shape[0]
    dev = f.device
    _check("f", f, (B, N, N), dev)
    _check_group_plan(pos, shift, spec, Wc, Ws, A, N, K, S, dev)
    out = torch.empty((B, A, S), dtype=torch.float32, device=dev)
    shat = torch.empty((B, A, K, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn("radon_group_project")(
            f.data_ptr(), pos.data_ptr(), shift.data_ptr(), spec.data_ptr(),
            Wc.data_ptr(), Ws.data_ptr(), shat.data_ptr(), out.data_ptr(),
            B, N, A, K, S, 2.0 * math.pi / L, int(contract_x), bf16, stream)
    project_group.launches += 1
    _raise_on(rc, "project_group")
    return out


#: adjoint output tile edge of csrc/radon_group.cu (GR_AD_T)
_GROUP_ADJ_TILE = 64


def adjoint_splits(B: int, N: int, A: int, n_sms: int) -> int:
    """How many angle slices the per-angle adjoint splits its angle loop
    into, so that about four blocks per SM are in flight; each slice writes
    a partial image and a second pass sums them in a fixed order."""
    blocks = B * math.ceil(N / _GROUP_ADJ_TILE) ** 2
    return max(1, min(A, math.ceil(4 * n_sms / blocks)))


def backproject_group(p, pos, shift, spec, Wc, Ws, L, contract_x: bool, N: int,
                      cdt=torch.float32):
    """Fused per-angle adjoint for one angle group:
    p (B, A_g, S) → (B, N, N) float32, the y group already transposed.

    CPU tensors run :func:`_backproject_group`; CUDA tensors launch the
    kernel of ``csrc/radon_group.cu``."""
    if p.device.type == "cpu":
        return _backproject_group(p, pos, shift, spec, Wc, Ws, L, contract_x, cdt)
    _check_device(p)
    bf16 = _compute_flag(cdt)
    K, S = Wc.shape
    B, A, _ = p.shape
    dev = p.device
    _check("p", p, (B, A, S), dev)
    _check_group_plan(pos, shift, spec, Wc, Ws, A, N, K, S, dev)
    G = adjoint_splits(B, N, A, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    shat = torch.empty((B, A, K, 2), dtype=torch.float32, device=dev)
    part = (torch.empty((G, B, N, N), dtype=torch.float32, device=dev)
            if G > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn("radon_group_backproject")(
            p.data_ptr(), pos.data_ptr(), shift.data_ptr(), spec.data_ptr(),
            Wc.data_ptr(), Ws.data_ptr(), shat.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            B, N, A, K, S, G, 2.0 * math.pi / L, int(contract_x), bf16, stream)
    backproject_group.launches += 1
    _raise_on(rc, "backproject_group")
    return out


project_pair_group.launches = 0
backproject_pair_group.launches = 0
project_group.launches = 0
backproject_group.launches = 0


def reset_launch_counts():
    for fn in (project_pair_group, backproject_pair_group, project_group,
               backproject_group):
        fn.launches = 0
