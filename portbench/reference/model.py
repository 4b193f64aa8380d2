"""Plain Primal-Dual UNet (arXiv:2112.13443) as functions of a parameter
dictionary, keyed as the program's ``state_dict``.

UNet: a space-to-depth stem of ``stem`` (channel (s_h·s + s_w)·C + c),
``depth`` levels of two 3×3 convolutions with ReLU and a 2×2 max pool,
features doubling per octave from ``base·stem`` (capped at 512), a
bottleneck block, decoders of a 2×2 stride-2 transposed convolution, the
skip concatenation and two 3×3 convolutions, a 1×1 head and the inverse
stem. Keys: ``blocks.{n}.convs.{0,1}.{weight,bias}`` (encoders, bottleneck,
decoders), ``ups.{n}.{weight,bias}`` (transposed convolutions, weight
(in, out, 2, 2)), ``head.{weight,bias}``.

Unroll, with real (B, 1, H, W) or complex (B, 2, H, W: Re, Im) channels:

    h ← h + Dual_i([h, A f, g]);   f ← f + Primal_i([f, A† h])

from h = 0 and f = f0, with ``iterations.{i}.dual`` / ``.primal`` UNets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import EXACT

__all__ = ["unet", "pdunet", "level_features", "unet_shapes"]


def level_features(base: int, stem: int, depth: int):
    return [min(base * stem * (1 << d), 512) for d in range(depth + 1)]


def unet_shapes(prefix: str, cin: int, cout: int, base: int, depth: int, stem: int) -> dict:
    """Parameter shapes of one UNet, keyed as above under ``prefix``."""
    feats = level_features(base, stem, depth)
    shapes, c = {}, cin * stem * stem

    def block(n, cin_, f):
        shapes[f"{prefix}blocks.{n}.convs.0.weight"] = (f, cin_, 3, 3)
        shapes[f"{prefix}blocks.{n}.convs.0.bias"] = (f,)
        shapes[f"{prefix}blocks.{n}.convs.1.weight"] = (f, f, 3, 3)
        shapes[f"{prefix}blocks.{n}.convs.1.bias"] = (f,)

    for d in range(depth):
        block(d, c, feats[d])
        c = feats[d]
    block(depth, c, feats[depth])
    c = feats[depth]
    for i, d in enumerate(reversed(range(depth))):
        shapes[f"{prefix}ups.{i}.weight"] = (c, feats[d], 2, 2)
        shapes[f"{prefix}ups.{i}.bias"] = (feats[d],)
        block(depth + 1 + i, 2 * feats[d], feats[d])
        c = feats[d]
    shapes[f"{prefix}head.weight"] = (cout * stem * stem, c, 1, 1)
    shapes[f"{prefix}head.bias"] = (cout * stem * stem,)
    return shapes


def _s2d(x, s):
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, s * s * c, h // s, w // s)


def _d2s(x, s):
    b, c, h, w = x.shape
    x = x.reshape(b, s, s, c // (s * s), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // (s * s), h * s, w * s)


def _conv(x, P, key, rnd):
    w = P[f"{key}.weight"]
    return F.conv2d(rnd(x), rnd(w), P[f"{key}.bias"], padding=w.shape[-1] // 2)


def _block(x, P, key, rnd):
    for m in range(2):
        x = F.relu(_conv(x, P, f"{key}.convs.{m}", rnd))
    return x


def unet(x, P: dict, prefix: str, depth: int, stem: int, rnd=EXACT.lo):
    """The UNet of ``P[prefix + ...]`` on NCHW ``x``; float32 out."""
    h, w = x.shape[-2:]
    mult = stem << depth
    x = F.pad(x.float(), (0, (-w) % mult, 0, (-h) % mult))
    if stem > 1:
        x = _s2d(x, stem)
    skips = []
    for d in range(depth):
        x = _block(x, P, f"{prefix}blocks.{d}", rnd)
        skips.append(x)
        x = F.max_pool2d(x, 2, 2)
    x = _block(x, P, f"{prefix}blocks.{depth}", rnd)
    for i, d in enumerate(reversed(range(depth))):
        key = f"{prefix}ups.{i}"
        x = F.conv_transpose2d(rnd(x), rnd(P[f"{key}.weight"]), P[f"{key}.bias"], stride=2)
        x = _block(torch.cat([x, skips[d]], dim=1), P, f"{prefix}blocks.{depth + 1 + i}", rnd)
    x = _conv(x, P, f"{prefix}head", rnd)
    if stem > 1:
        x = _d2s(x, stem)
    return x[..., :h, :w]


def pdunet(g, f0, P: dict, A, At, n_iters: int, depth: int, stem: int,
           complex_ops: bool = False, rnd=EXACT.lo):
    """The unroll on the measurement ``g`` (B, A, S) and the initial image
    ``f0`` (B, N, N), with the (already σ-scaled) operators ``A``, ``At``.
    Returns (B, N, N), complex with ``complex_ops``."""
    if complex_ops:
        pack = lambda z: torch.stack([z.real, z.imag], dim=1).float()
        unpack = lambda x: torch.complex(x[:, 0], x[:, 1])
    else:
        pack = lambda z: z[:, None].float()
        unpack = lambda x: x[:, 0]
    g_ch, f = pack(g), pack(f0)
    h = torch.zeros_like(g_ch)
    for i in range(n_iters):
        pre = f"iterations.{i}."
        h = h + unet(torch.cat([h, pack(A(unpack(f))), g_ch], dim=1), P, pre + "dual.",
                     depth, stem, rnd)
        f = f + unet(torch.cat([f, pack(At(unpack(h)))], dim=1), P, pre + "primal.",
                     depth, stem, rnd)
    return unpack(f)
