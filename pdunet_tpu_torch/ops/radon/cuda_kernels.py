"""Mirror-pair projector kernels: wrappers and their plain PyTorch versions.

``project_pair_group`` and ``backproject_pair_group`` replace the Pallas
kernels ``project_pair_group_pallas`` / ``backproject_pair_group_pallas``
(``pdunet_tpu/ops/radon/pallas_kernels.py``). For a CUDA tensor each
wrapper launches the hand-written kernel in ``csrc/radon_pair.cu`` (and
raises if it cannot); for a CPU tensor it runs the plain version below,
which is the port of the JAX twins ``_project_pair_group`` /
``_backproject_pair_group`` (``pdunet_tpu/ops/radon/parallel.py``).

Precision contract (same as the twins): the trig arguments are f32 (or
f64 for a float64 input on the CPU, which ``gradcheck`` uses); with
``cdt=torch.bfloat16`` the operands T̂, φ, f or p, W and Ŝ are rounded to
bf16 where the twin casts them, and every sum accumulates in f32.

Each wrapper counts its kernel launches in ``<wrapper>.launches``; a CPU
call does not count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["project_pair_group", "backproject_pair_group", "reset_launch_counts"]


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
    Tc, Ts, PcA, PsA, PcB, PsB = _pair_spectral_tensors(pos, sha, shb, spec, L, cdt)
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


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (at first use) and bind the kernels' shared library."""
    from pdunet_tpu_torch.ops.radon._build import load_library

    lib = load_library("radon_pair")
    for fn in (lib.radon_pair_project, lib.radon_pair_backproject):
        fn.restype = ctypes.c_int
    lib.radon_pair_project.argtypes = (
        [_P] * 10 + [_I] * 5 + [ctypes.c_float, _I, _I, _P])
    lib.radon_pair_backproject.argtypes = (
        [_P] * 11 + [_I] * 5 + [ctypes.c_float, _I, _I, _P])
    return lib


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


def _check_dispatch(x: torch.Tensor, L: int, K: int):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}; use a CPU or CUDA tensor")
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
        rc = _lib().radon_pair_project(
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
        rc = _lib().radon_pair_backproject(
            p.data_ptr(), pos.data_ptr(), sha.data_ptr(), shb.data_ptr(),
            sgn.data_ptr(), msk.data_ptr(), spec.data_ptr(), Wc.data_ptr(),
            Ws.data_ptr(), shat.data_ptr(), out.data_ptr(), B, N, P, K, S,
            2.0 * math.pi / L, int(contract_x), bf16, stream)
    backproject_pair_group.launches += 1
    _raise_on(rc, "backproject_pair_group")
    return out


project_pair_group.launches = 0
backproject_pair_group.launches = 0


def reset_launch_counts():
    project_pair_group.launches = 0
    backproject_pair_group.launches = 0
