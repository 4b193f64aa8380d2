"""2D UNet (port of ``pdunet_tpu/models/unet.py``).

The UNet's layers compute in NHWC (``torch.channels_last``), the layout of
every convolution kernel cuDNN runs on the card, so cuDNN reads and writes
the activations as they lie and converts nothing around a convolution.
``UNet.forward`` still takes and returns NCHW float32: one copy at the
entry writes the padded, cast, space-to-depth'd input channels_last, one at
the exit the head's depth-to-space, cast to float32 and crop. ``Conv`` and
``ConvTranspose`` run in their input's memory format (on the CPU every
convolution computes in NCHW and hands its output back in its input's
layout); LPD's ``ConvNet`` gives ``_conv`` channels_last tensors of its own
(``models/primal_dual.py``). ``space_to_depth`` and
``depth_to_space`` keep the JAX package's NHWC signature, and the stem's
channel order is flax's: channel (s_h·s + s_w)·C + c, which differs from
``torch.nn.functional.pixel_unshuffle``.

Compute dtype follows flax's ``dtype=``: inputs, weights and biases are cast
to it for each layer while the parameters stay float32, and the output is
cast back to float32. Float32 convolutions run in full float32 on the card
(cuDNN's TF32 default is pinned off around them), as in the reference;
bf16 ones are left as cuDNN runs them. Initialisation is flax's:
lecun_normal (truncated normal, fan-in) weights and zero biases, drawn from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pdunet_tpu_torch.utils.precision import exact_f32_conv

__all__ = ["UNet", "UPSAMPLE", "space_to_depth", "depth_to_space", "lecun_normal_"]

# std of a unit normal truncated to [-2, 2]; flax divides by it so the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978

#: flax UNet's default ``features_cap`` (the only value any preset uses)
FEATURES_CAP = 512


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H/s, W/s, C·s²), flax channel order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // s, s, w // s, s, c).transpose(2, 3)  # (b, h/s, w/s, s_h, s_w, c)
    return x.reshape(b, h // s, w // s, s * s * c)


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, s, s, c // (s * s)).transpose(2, 3)  # (b, h, s_h, w, s_w, c')
    return x.reshape(b, h * s, w * s, c // (s * s))


def _d2s_channels_last(x: torch.Tensor, s: int) -> torch.Tensor:
    """:func:`depth_to_space` of a channels_last (B, C·s², H, W) tensor, to a
    channels_last (B, C, H·s, W·s) one: one copy."""
    return depth_to_space(x.permute(0, 2, 3, 1), s).permute(0, 3, 1, 2)


def _entry(x: torch.Tensor, s: int, hp: int, wp: int, dtype) -> torch.Tensor:
    """NCHW (B, C, H, W) → the UNet's input: zero-padded to (hp, wp), cast to
    ``dtype``, space-to-depth'd by ``s`` (flax order), channels_last. One
    copy, two when H or W needs padding."""
    b, c, h, w = x.shape
    if (h, w) != (hp, wp):
        x = F.pad(x, (0, wp - w, 0, hp - h))
    out = torch.empty((b, hp // s, wp // s, s, s, c), dtype=dtype, device=x.device)
    out.permute(0, 5, 1, 3, 2, 4).copy_(x.unflatten(3, (wp // s, s)).unflatten(2, (hp // s, s)))
    return out.flatten(3).permute(0, 3, 1, 2)


def _exit(x: torch.Tensor, s: int, h: int, w: int) -> torch.Tensor:
    """The head's channels_last (B, C·s², H/s, W/s) → NCHW (B, C, h, w)
    float32: depth-to-space by ``s``, the cast and the crop in one copy (a
    crop inside an s-block is a view of the copy)."""
    b = x.shape[0]
    src = x.permute(0, 2, 3, 1).unflatten(3, (s, s, -1))  # (b, H/s, W/s, s_h, s_w, c)
    hb, wb = -(-h // s), -(-w // s)  # the s-blocks that hold the crop
    out = torch.empty((b, src.shape[-1], hb * s, wb * s), dtype=torch.float32, device=x.device)
    out.unflatten(3, (wb, s)).unflatten(2, (hb, s)).copy_(
        src[:, :hb, :wb].permute(0, 5, 1, 3, 2, 4))
    return out[..., :h, :w]


def _conv(op, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype, **kw):
    """``op`` (``F.conv2d`` or ``F.conv_transpose2d``) of ``x`` in ``dtype`` and
    in ``x``'s memory format: channels_last where ``x`` is, else NCHW. The
    weights are cast and laid out in that format in one copy, so cuDNN runs
    its kernel for that layout and converts nothing around it. On the CPU
    the convolution computes in NCHW whatever the layout, and its output
    goes back to the input's: oneDNN's NHWC kernels sum the backward in
    another order than its NCHW ones, on which the port's float32 training
    is held to the JAX package's (``tests/test_torch_train.py``)."""
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    cpu = x.device.type == "cpu"
    w = weight.to(dtype, memory_format=torch.contiguous_format if cpu else fmt)
    x = x.to(dtype)
    with exact_f32_conv(dtype == torch.float32):
        if cpu:
            return op(x.contiguous(), w, bias.to(dtype), **kw).contiguous(memory_format=fmt)
        return op(x, w, bias.to(dtype), **kw)


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding (odd kernels), in its input's
    memory format (NCHW or channels_last).

    ``weight`` is (out, in, kh, kw), the torch layout."""

    def __init__(self, cin: int, cout: int, k: int, dtype=torch.float32,
                 generator=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        lecun_normal_(self.weight, cin * k * k, generator)

    def forward(self, x):
        return _conv(F.conv2d, x, self.weight, self.bias, self.dtype,
                     padding=self.weight.shape[-1] // 2)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel 2, stride 2, in its input's
    memory format.

    flax applies its (kh, kw, in, out) kernel unflipped; torch's
    ``conv_transpose2d`` flips it. ``weight`` is kept in torch's (in, out,
    kh, kw) layout with the flip already applied (``models/convert.py``
    does it when loading flax parameters)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32,
                 generator=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        lecun_normal_(self.weight, cin * 4, generator)

    def forward(self, x):
        return _conv(F.conv_transpose2d, x, self.weight, self.bias, self.dtype, stride=2)


class ConvBlock(nn.Module):
    """Two 3x3 convolutions, each followed by ReLU."""

    def __init__(self, cin: int, features: int, **kw):
        super().__init__()
        self.convs = nn.ModuleList(
            [Conv(cin, features, 3, **kw), Conv(features, features, 3, **kw)])

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        return x


#: decoder 2x upsampling ops (flax UNet's ``upsample``)
UPSAMPLE = ("convtranspose", "shuffle")


class UNet(nn.Module):
    """Encoder-decoder UNet with skip connections.

    ``upsample`` is the decoder's 2x upsampling: "convtranspose", a 2x2
    stride-2 transposed convolution, or "shuffle", a 1x1 convolution to 4x
    the features followed by ``depth_to_space(·, 2)`` in flax's channel
    order (the same linear family and parameter count; checkpoints do not
    carry across the two).

    ``forward`` takes and returns NCHW; the output is float32 and, unless
    the crop cuts an s-block of the stem, contiguous. Between the two the
    activations are channels_last, and the parameters are held
    channels_last (their values, shapes and ``state_dict`` keys are the
    NCHW ones), so each layer's cast makes its weights in its input's
    layout in one copy. Submodules are ordered as flax creates them:
    ``blocks`` = ConvBlock_0 … ConvBlock_2d (encoder, bottleneck, decoder),
    ``ups`` = ConvTranspose_0 … (shuffle: Conv_0 … Conv_{depth-1}),
    ``head`` = Conv_0 (shuffle: Conv_{depth}).
    """

    def __init__(self, in_channels: int, out_channels: int = 1,
                 base_features: int = 64, depth: int = 4, stem: int = 1,
                 dtype=torch.float32, upsample: str = "convtranspose",
                 generator: torch.Generator = None, device="cuda"):
        super().__init__()
        if upsample not in UPSAMPLE:
            raise ValueError(f"unknown upsample {upsample!r}; options: {', '.join(UPSAMPLE)}")
        self.depth, self.stem, self.dtype, self.upsample = depth, stem, dtype, upsample
        feats = self.level_features(base_features, stem, depth)
        kw = dict(dtype=dtype, generator=generator, device=device)
        cin = in_channels * stem * stem
        blocks = []
        for d in range(depth):
            blocks.append(ConvBlock(cin, feats[d], **kw))
            cin = feats[d]
        blocks.append(ConvBlock(cin, feats[depth], **kw))
        cin = feats[depth]
        ups = []
        for d in reversed(range(depth)):
            ups.append(ConvTranspose(cin, feats[d], **kw) if upsample == "convtranspose"
                       else Conv(cin, 4 * feats[d], 1, **kw))
            blocks.append(ConvBlock(2 * feats[d], feats[d], **kw))
            cin = feats[d]
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.head = Conv(cin, out_channels * stem * stem, 1, **kw)
        self.to(memory_format=torch.channels_last)

    @staticmethod
    def level_features(base: int, stem: int, depth: int) -> Sequence[int]:
        """Features per level, doubling per octave from full resolution
        (the stem level is log2(stem) octaves down), capped as in flax."""
        return [min(base * stem * (1 << d), FEATURES_CAP) for d in range(depth + 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2], x.shape[-1]
        mult = self.stem << self.depth
        x = _entry(x, self.stem, h + (-h) % mult, w + (-w) % mult, self.dtype)
        skips = []
        for d in range(self.depth):
            x = self.blocks[d](x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.blocks[self.depth](x)
        for i, d in enumerate(reversed(range(self.depth))):
            x = self.ups[i](x)
            if self.upsample == "shuffle":
                x = _d2s_channels_last(x, 2)
            x = torch.cat([x, skips[d]], dim=1)
            x = self.blocks[self.depth + 1 + i](x)
        return _exit(self.head(x), self.stem, h, w)
