"""The two kernel probes: wrappers and their plain PyTorch versions.

They replace the Pallas kernels of the JAX package's probe scripts, which
vary one thing of a shipped projector kernel each:

* ``scripts/trig_proto.py::call_pair_fwd`` — the mirror-pair forward with
  its six (N, K) trig tensors either built by block doubling from host
  seeds (``project_pair_group_doubling``, body ``_fwd_pair_kernel_doubling``)
  or replaced by mul-adds of the same shape (``project_pair_group_notrig``,
  body ``_fwd_pair_kernel_notrig``: wrong numbers, right cost, the
  free-trig probe);
* ``scripts/pack_proto.py::call_fwd`` / ``call_adj`` — the per-angle forward
  and adjoint with re/im packed into one (N, 2K) operand [T̂c | T̂s]
  (``project_group_packed`` / ``backproject_group_packed``, bodies
  ``_fwd_kernel_packed`` / ``_adj_kernel_packed``).

Both probes run on the tensor cores (``wgmma``; bf16 operands, float32 as
split-bf16 products) with their trig made on chip, no trig table read: the
pair probe in ``csrc/radon_pair_proto_tc.cu`` (T̂ and both members' φ from
the host seeds, or the no-trig mul-adds from the plan rows), the packed
probe in ``csrc/radon_proto_tc.cu`` (T̂ and φ from the plan rows). For a
CUDA tensor each wrapper launches its kernel (and raises if it cannot); for
a CPU tensor it runs the plain version below, which computes what the
Pallas body computes, with bf16 rounding where the body casts. ``doubling_trig_rows`` is the port of
``pdunet_tpu/ops/radon/pallas_kernels.py::_doubling_trig_rows`` and
``phase_seeds`` of ``scripts/trig_proto.py::_phase_seeds``.

Trig of the packed pair (as in the Pallas bodies' ``_angle_tensors``):
exact in float32, block doubling from in-kernel float32 seeds with bf16
operands; ``doubling=`` overrides the rule (the probe times packed with
exact trig against the shipped per-angle kernel, which uses exact trig).
The kernels make the doubled rows with :func:`doubling_trig_rows`'
products in its order, so their trig equals the plain version's.

Each wrapper counts its kernel launches in ``<wrapper>.launches``; a CPU
call does not count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from pdunet_tpu_torch.ops.radon.cuda_kernels import (
    _check,
    _check_device,
    _check_group_plan,
    _compute_flag,
    _kfreq,
    _pair_forward,
    _q,
    _raise_on,
    _spectral_tensors,
    _tc_dims,
    _tc_pad,
    group_adjoint_splits,
)

__all__ = ["doubling_trig_rows", "phase_seeds", "project_pair_group_doubling",
           "project_pair_group_notrig", "project_group_packed",
           "backproject_group_packed", "reset_launch_counts"]


def doubling_trig_rows(th0: torch.Tensor, dth: torch.Tensor, N: int):
    """(cos, sin) of θ(j, k) = th0(k) + j·dth(k), j = 0..N−1, each
    (..., N, K), from the seed rows th0, dth (..., K) by block doubling:
    rows [n, 2n) are rows [0, n) rotated by the block rotor e^{i·n·dth},
    which is then squared. The same operations in the same order as the
    JAX function; its phase drift is ~N·eps_f32."""
    c, s = torch.cos(th0)[..., None, :], torch.sin(th0)[..., None, :]
    rc, rs = torch.cos(dth)[..., None, :], torch.sin(dth)[..., None, :]
    n = 1
    while n < N:
        c2 = c * rc - s * rs
        s2 = c * rs + s * rc
        c = torch.cat([c, c2], dim=-2)
        s = torch.cat([s, s2], dim=-2)
        rc, rs = rc * rc - rs * rs, 2.0 * rc * rs
        n *= 2
    return c[..., :N, :], s[..., :N, :]


def phase_seeds(pos, sha, shb, K: int, L: int):
    """Host-side seeds of the doubling pair forward: (seeds0, steps), each a
    (P, 3K) float32 array packing the [pos | sha | shb] families' phase at
    row 0 and per-row increment, formed in float64 from the float32 plan
    rows (tensors, (P, N)) and rounded once (the rows are exactly affine in j)."""
    k = np.arange(K) * (2.0 * np.pi / L)

    def fam(rows):
        rows = rows.cpu().numpy()
        return rows[:, 0:1] * k[None, :], (rows[:, 1:2] - rows[:, 0:1]) * k[None, :]

    r0s, sts = zip(fam(pos), fam(sha), fam(shb))
    return (np.concatenate(r0s, axis=1).astype(np.float32),
            np.concatenate(sts, axis=1).astype(np.float32))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _doubling_pair_trig(seeds0, steps, spec, N: int):
    """The doubling pair forward's six (P, N, K) trig tensors in float32,
    unrounded: T̂ (spec·c, −spec·s) and both members' φ (c, s), each family
    built by :func:`doubling_trig_rows` from the (P, 3K) seeds of
    :func:`phase_seeds`."""
    K = spec.shape[0]
    fams = [doubling_trig_rows(seeds0[:, i * K:(i + 1) * K],
                               steps[:, i * K:(i + 1) * K], N) for i in range(3)]
    (tc, ts), (ca, sa), (cb, sb) = fams
    return spec * tc, -spec * ts, ca, sa, cb, sb


def _notrig_pair_trig(pos, sha, shb, spec, L):
    """The no-trig pair forward's six (P, N, K) tensors in float32,
    unrounded: T̂ (spec + pos·kf, spec − pos·kf) and φ_m (sh_m·kf + 1,
    sh_m·kf − 1)."""
    k = _kfreq(spec.shape[0], L, pos.dtype, pos.device)
    tk = pos[:, :, None] * k
    ak = sha[:, :, None] * k
    bk = shb[:, :, None] * k
    return spec + tk, spec - tk, ak + 1.0, ak - 1.0, bk + 1.0, bk - 1.0


def _project_pair_group_doubling(f, seeds0, steps, sgn, spec, Wc, Ws,
                                 contract_x: bool, cdt=torch.float32):
    """Plain doubling pair forward: the mirror-pair forward with all six
    (P, N, K) trig tensors built in float32 by :func:`_doubling_pair_trig`,
    then rounded to ``cdt``."""
    trig = _doubling_pair_trig(seeds0, steps, spec, f.shape[-1])
    return _pair_forward(f, *(_q(t, cdt) for t in trig), sgn, Wc, Ws, contract_x, cdt)


def _project_pair_group_notrig(f, pos, sha, shb, sgn, spec, Wc, Ws, L,
                               contract_x: bool, cdt=torch.float32):
    """Plain no-trig pair forward: the six trig tensors replaced by
    spec ± pos·kf and sh·kf ± 1 (:func:`_notrig_pair_trig`; wrong numbers,
    the shipped kernel's cost without its trig)."""
    trig = _notrig_pair_trig(pos, sha, shb, spec, L)
    return _pair_forward(f, *(_q(t, cdt) for t in trig), sgn, Wc, Ws, contract_x, cdt)


def _use_doubling(cdt, doubling):
    return cdt == torch.bfloat16 if doubling is None else bool(doubling)


def _packed_angle_tensors(pos, shift, spec, L, cdt, doubling):
    """Per-angle T̂ (cos, sin) and φ (cos, sin), each (A, N, K) rounded to
    ``cdt``: exact trig, or block doubling from float32 seeds formed as the
    Pallas ``_row_trig`` forms them (row[0]·kf and (row[1] − row[0])·kf)."""
    N = pos.shape[1]
    if not (doubling and N > 1):
        return _spectral_tensors(pos, shift, spec, L, cdt)
    k = _kfreq(spec.shape[0], L, pos.dtype, pos.device)

    def trig(row):
        return doubling_trig_rows(row[:, 0:1] * k, (row[:, 1:2] - row[:, 0:1]) * k, N)

    ct, st = trig(pos)
    pc, ps = trig(shift)
    return _q(spec * ct, cdt), _q(-spec * st, cdt), _q(pc, cdt), _q(ps, cdt)


def _project_group_packed(f, pos, shift, spec, Wc, Ws, L, contract_x: bool,
                          cdt=torch.float32, doubling=None):
    """Plain packed per-angle forward, f (B,N,N) → (B, A, S): stage 1 is one
    product against [T̂c | T̂s] (A, N, 2K); stage 2 folds into the two
    2K-wide rows [Σ gr·φc | −Σ gi·φs] and [Σ gr·φs | Σ gi·φc], each half
    rounded to ``cdt`` on its own; stage 3 is one (4K)-deep product against
    [Wc; Wc; −Ws; −Ws]. In float32 this is the shipped per-angle operator."""
    Tc, Ts, Pc, Ps = _packed_angle_tensors(pos, shift, spec, L, cdt,
                                           _use_doubling(cdt, doubling))
    f = _q(f, cdt)
    sub1 = "bji,aim->bajm" if contract_x else "bji,ajm->baim"
    g = torch.einsum(sub1, f, torch.cat([Tc, Ts], dim=-1))        # (B, A, N, 2K)
    row1 = _q(torch.einsum("barm,arm->bam", g, torch.cat([Pc, -Ps], dim=-1)), cdt)
    row2 = _q(torch.einsum("barm,arm->bam", g, torch.cat([Ps, Pc], dim=-1)), cdt)
    W4 = _q(torch.cat([Wc, Wc, -Ws, -Ws], dim=0), cdt)             # (4K, S)
    return torch.einsum("baq,qs->bas", torch.cat([row1, row2], dim=-1), W4)


def _backproject_group_packed(p, pos, shift, spec, Wc, Ws, L, contract_x: bool,
                              cdt=torch.float32, doubling=None):
    """Plain packed per-angle adjoint, p (B, A, S) → (B, N, N), the y group
    transposed as :func:`cuda_kernels.backproject_group` returns it: Ŝ =
    (p·Wcᵀ, −p·Wsᵀ) unrounded, h = [h_re | h_im] (B, A, N, 2K) rounded to
    ``cdt``, then one 2K-deep contraction against [T̂c | T̂s]."""
    Tc, Ts, Pc, Ps = _packed_angle_tensors(pos, shift, spec, L, cdt,
                                           _use_doubling(cdt, doubling))
    p = _q(p, cdt)
    s_re = torch.einsum("bas,ks->bak", p, _q(Wc, cdt))[:, :, None, :]
    s_im = -torch.einsum("bas,ks->bak", p, _q(Ws, cdt))[:, :, None, :]
    h = _q(torch.cat([s_re * Pc + s_im * Ps, -s_re * Ps + s_im * Pc], dim=-1), cdt)
    sub = "bajm,aim->bji" if contract_x else "baim,ajm->bji"
    return torch.einsum(sub, h, torch.cat([Tc, Ts], dim=-1))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry point → argument types; "radon_proto_tc_<op>" lives in
# csrc/radon_proto_tc.cu, "radon_pair_proto_tc_<op>" in
# csrc/radon_pair_proto_tc.cu
_ARGTYPES = {
    "radon_pair_proto_tc_doubling": [_P] * 10 + [_I] * 10 + [_P],
    "radon_pair_proto_tc_notrig": [_P] * 11 + [_I] * 8 + [_F, _I, _I, _P],
    "radon_proto_tc_project": [_P] * 11 + [_I] * 9 + [_F, _I, _I, _I, _P],
    "radon_proto_tc_backproject": [_P] * 11 + [_I] * 9 + [_F, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    """Build (at first use) the library holding ``name`` and bind it."""
    from pdunet_tpu_torch.ops.radon._build import load_library

    fn = getattr(load_library(name.rsplit("_", 1)[0]), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


def _launch(name, *args):
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]  # None: a null pointer
        return _fn(name)(*ptrs, stream)


def _check_pair(f, sgn, spec, Wc, Ws, P, K, S, dev):
    B, N, _ = f.shape
    _check("f", f, (B, N, N), dev)
    _check("sgn", sgn, (P,), dev)
    _check("spec", spec, (K,), dev)
    _check("Wc", Wc, (K, S), dev)
    _check("Ws", Ws, (K, S), dev)


def _doubling_args(f, seeds0, steps, sgn, spec, Wc, Ws, cdt):
    """Checks of a CUDA doubling pair call; returns (bf16 flag, B, N, P, K, S, dev)."""
    _check_device(f)
    bf16 = _compute_flag(cdt)
    K, S = Wc.shape
    B, N, _ = f.shape
    P = sgn.shape[0]
    dev = f.device
    _check_pair(f, sgn, spec, Wc, Ws, P, K, S, dev)
    _check("seeds0", seeds0, (P, 3 * K), dev)
    _check("steps", steps, (P, 3 * K), dev)
    return bf16, B, N, P, K, S, dev


def _notrig_args(f, pos, sha, shb, sgn, spec, Wc, Ws, L, cdt):
    """Checks of a CUDA no-trig pair call; returns (bf16 flag, B, N, P, K, S, dev)."""
    _check_device(f)
    bf16 = _compute_flag(cdt)
    K, S = Wc.shape
    if K != L // 2 + 1:
        raise ValueError(f"spec has K={K} frequencies, expected L//2+1={L // 2 + 1}")
    B, N, _ = f.shape
    P = pos.shape[0]
    dev = f.device
    _check_pair(f, sgn, spec, Wc, Ws, P, K, S, dev)
    for name, t in (("pos", pos), ("sha", sha), ("shb", shb)):
        _check(name, t, (P, N), dev)
    return bf16, B, N, P, K, S, dev


#: the largest K whose Ŝ rows fit the shared memory of the pair stage 3
#: (csrc/radon_tc.cuh pair_stage3: 8 rows x (2K + 512) floats ≤ 227 KB)
_PAIR_STAGE3_MAX_K = (232448 // (8 * 4) - 8 * 64) // 2


def _pair_tc_scratch(B, N, P, K, bf16, dev):
    """(Np, Kp, Dw, fb, part) of a tensor-core pair probe call: 16-bit
    scratch for F (bf16, or the split route's hi and lo planes, which the
    no-trig kernel fills with fp16 bits) and the partials of both members'
    Ŝ per depth window and row tile."""
    if K > _PAIR_STAGE3_MAX_K:
        raise ValueError(f"K={K} frequencies exceed the pair stage 3's shared memory "
                         f"(at most {_PAIR_STAGE3_MAX_K})")
    Np, K2p = _tc_dims(N, K)
    Dw = _packed_window(Np)
    fb = torch.empty((2 - bf16, B, Np, Np), dtype=torch.bfloat16, device=dev)
    part = torch.empty((Np // Dw * (Np // 128), B, 2 * P, K, 2), dtype=torch.float32,
                       device=dev)
    return Np, K2p // 2, Dw, fb, part


def project_pair_group_doubling(f, seeds0, steps, sgn, spec, Wc, Ws,
                                contract_x: bool, cdt=torch.float32):
    """Doubling-trig mirror-pair forward for one angle group:
    f (B,N,N) → (B, 2P, S) float32, rows interleaved [pair0-a, pair0-b, ...];
    ``seeds0``/``steps`` are the (P, 3K) arrays of :func:`phase_seeds`.

    CPU tensors run :func:`_project_pair_group_doubling`; CUDA tensors launch
    the tensor-core kernels of ``csrc/radon_pair_proto_tc.cu`` (bf16
    operands on ``wgmma``, float32 as split-bf16 products), which make T̂
    and both members' φ on chip from the seeds."""
    if f.device.type == "cpu":
        return _project_pair_group_doubling(f, seeds0, steps, sgn, spec, Wc, Ws,
                                            contract_x, cdt)
    bf16, B, N, P, K, S, dev = _doubling_args(f, seeds0, steps, sgn, spec, Wc, Ws, cdt)
    Np, Kp, Dw, fb, part = _pair_tc_scratch(B, N, P, K, bf16, dev)
    out = torch.empty((B, 2 * P, S), dtype=torch.float32, device=dev)
    rc = _launch("radon_pair_proto_tc_doubling", f, seeds0, steps, sgn, spec, Wc, Ws, fb, part,
                 out, B, N, Np, P, K, Kp, S, Dw, int(contract_x), bf16)
    project_pair_group_doubling.launches += 1
    _raise_on(rc, "project_pair_group_doubling")
    return out


def project_pair_group_notrig(f, pos, sha, shb, sgn, spec, Wc, Ws, L,
                              contract_x: bool, cdt=torch.float32):
    """No-trig mirror-pair forward (the free-trig cost probe; its numbers are
    not a projection): f (B,N,N) → (B, 2P, S) float32.

    CPU tensors run :func:`_project_pair_group_notrig`; CUDA tensors launch
    the tensor-core kernels of ``csrc/radon_pair_proto_tc.cu``, which form
    the mul-adds on chip from the plan rows (no table read). With float32
    operands the split products take fp16 hi and lo parts (its numbers
    cancel ~190x in stage 2, past what bf16 parts hold to 1e-5), so ``f``
    must stay within fp16's range (|f| < 65504), or the output is not
    finite."""
    if f.device.type == "cpu":
        return _project_pair_group_notrig(f, pos, sha, shb, sgn, spec, Wc, Ws, L,
                                          contract_x, cdt)
    bf16, B, N, P, K, S, dev = _notrig_args(f, pos, sha, shb, sgn, spec, Wc, Ws, L, cdt)
    Np, Kp, Dw, fb, part = _pair_tc_scratch(B, N, P, K, bf16, dev)
    out = torch.empty((B, 2 * P, S), dtype=torch.float32, device=dev)
    rc = _launch("radon_pair_proto_tc_notrig", f, pos, sha, shb, sgn, spec, Wc, Ws, fb, part,
                 out, B, N, Np, P, K, Kp, S, Dw, 2.0 * math.pi / L, int(contract_x), bf16)
    project_pair_group_notrig.launches += 1
    _raise_on(rc, "project_pair_group_notrig")
    return out


def _packed_window(Np: int) -> int:
    """Rows of T̂ one block of a tensor-core probe forward keeps in shared
    memory (csrc/radon_proto_tc.cu, radon_pair_proto_tc.cu; at most
    PT_DW_MAX = 256): the largest
    multiple of 128 that divides Np (a multiple of 128) and is at most 256,
    so the depth runs in Np/window windows, each a partial of the sums."""
    return 256 if Np % 256 == 0 else 128


def _packed_args(x, pos, shift, spec, Wc, Ws, N, cdt, doubling):
    """Checks of a CUDA packed call; returns (bf16 flag, doubling flag, K, S, A, dev)."""
    _check_device(x)
    bf16 = _compute_flag(cdt)
    K, S = Wc.shape
    A = pos.shape[0]
    _check_group_plan(pos, shift, spec, Wc, Ws, A, N, K, S, x.device)
    return bf16, int(_use_doubling(cdt, doubling)), K, S, A, x.device


def _exact_in_f32(cdt, doubling):
    """The float32 tensor-core kernels make exact trig only: block doubling
    drifts by ~N·eps_f32, above the float32 contract."""
    if cdt == torch.float32 and doubling:
        raise ValueError("the float32 tensor-core packed kernels make exact trig only; "
                         "doubling=True with float32 runs on the CPU only")


def project_group_packed(f, pos, shift, spec, Wc, Ws, L, contract_x: bool,
                         cdt=torch.float32, doubling=None):
    """Packed re/im per-angle forward for one angle group:
    f (B,N,N) → (B, A_g, S) float32. ``doubling`` picks the trig (default:
    block doubling with bf16 operands, exact in float32).

    CPU tensors run :func:`_project_group_packed`; CUDA tensors launch the
    tensor-core kernels of ``csrc/radon_proto_tc.cu`` (bf16 operands on
    ``wgmma``, float32 as split-bf16 products, exact trig only), which
    compute T̂ and φ on chip from the plan rows."""
    if f.device.type == "cpu":
        return _project_group_packed(f, pos, shift, spec, Wc, Ws, L, contract_x,
                                     cdt, doubling)
    B, N, _ = f.shape
    bf16, dbl, K, S, A, dev = _packed_args(f, pos, shift, spec, Wc, Ws, N, cdt, doubling)
    _exact_in_f32(cdt, doubling)
    _check("f", f, (B, N, N), dev)
    Np, K2p = _tc_dims(N, K)
    Dw = _packed_window(Np)
    bf = torch.bfloat16
    out = torch.empty((B, A, S), dtype=torch.float32, device=dev)
    fb = torch.empty((2 - bf16, B, Np, Np), dtype=bf, device=dev)
    # partials of the four packed sums per k (bf16) or of (re, im) (split)
    part = torch.empty((Np // Dw * (Np // 128), B, A, (4 if bf16 else 2) * K),
                       dtype=torch.float32, device=dev)
    Sp = _tc_pad(S)
    sb = torch.empty((_tc_pad(B * A), 2 * K2p), dtype=bf, device=dev) if bf16 else None
    w4 = torch.empty((2 * K2p, Sp), dtype=bf, device=dev) if bf16 else None
    rc = _launch("radon_proto_tc_project", f, pos, shift, spec, Wc, Ws, fb, part, sb, w4, out,
                 B, N, Np, A, K, K2p // 2, S, Sp, Dw, 2.0 * math.pi / L, int(contract_x),
                 bf16, dbl)
    project_group_packed.launches += 1
    _raise_on(rc, "project_group_packed")
    return out


def backproject_group_packed(p, pos, shift, spec, Wc, Ws, L, contract_x: bool, N: int,
                             cdt=torch.float32, doubling=None):
    """Packed re/im per-angle adjoint for one angle group:
    p (B, A_g, S) → (B, N, N) float32, the y group already transposed.

    CPU tensors run :func:`_backproject_group_packed`; CUDA tensors launch
    the tensor-core kernels of ``csrc/radon_proto_tc.cu``, the depth split
    into :func:`cuda_kernels.group_adjoint_splits` slices (128-column output
    tiles with float32 operands, 256 with bf16)."""
    if p.device.type == "cpu":
        return _backproject_group_packed(p, pos, shift, spec, Wc, Ws, L, contract_x,
                                         cdt, doubling)
    B, A, S = p.shape
    bf16, dbl, K, S, A, dev = _packed_args(p, pos, shift, spec, Wc, Ws, N, cdt, doubling)
    _exact_in_f32(cdt, doubling)
    _check("p", p, (B, A, S), dev)
    Np, K2p = _tc_dims(N, K)
    G = group_adjoint_splits(B, N, A, torch.cuda.get_device_properties(dev).multi_processor_count,
                             256 if bf16 else 128)
    bf = torch.bfloat16
    Sp = _tc_pad(S)
    out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    shat = torch.empty((B, A, K2p // 2, 2), dtype=torch.float32, device=dev)
    part = torch.empty((G, B, N, N), dtype=torch.float32, device=dev) if G > 1 else None
    pb = torch.empty((_tc_pad(B * A), Sp), dtype=bf, device=dev) if bf16 else None
    wb = torch.empty((K2p, Sp), dtype=bf, device=dev) if bf16 else None
    rc = _launch("radon_proto_tc_backproject", p, pos, shift, spec, Wc, Ws, pb, wb, shat, part,
                 out, B, N, Np, A, K, K2p // 2, S, Sp, G, 2.0 * math.pi / L, int(contract_x),
                 bf16, dbl)
    backproject_group_packed.launches += 1
    _raise_on(rc, "backproject_group_packed")
    return out


_LAUNCHERS = (project_pair_group_doubling, project_pair_group_notrig,
              project_group_packed, backproject_group_packed)


def reset_launch_counts():
    for fn in _LAUNCHERS:
        fn.launches = 0


reset_launch_counts()
