"""2D UNet (port of ``pdunet_tpu/models/unet.py``).

The module computes in NCHW, PyTorch's layout. ``space_to_depth`` and
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


def _s2d_nchw(x: torch.Tensor, s: int) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // s, s, w // s, s)
    x = x.permute(0, 3, 5, 1, 2, 4)  # (b, s_h, s_w, c, h/s, w/s)
    return x.reshape(b, s * s * c, h // s, w // s)


def _d2s_nchw(x: torch.Tensor, s: int) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, s, s, c // (s * s), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)  # (b, c', h, s_h, w, s_w)
    return x.reshape(b, c // (s * s), h * s, w * s)


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H/s, W/s, C·s²), flax channel order."""
    return _s2d_nchw(x.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    return _d2s_nchw(x.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding (odd kernels), NCHW.

    ``weight`` is (out, in, kh, kw), the torch layout."""

    def __init__(self, cin: int, cout: int, k: int, dtype=torch.float32,
                 generator=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        lecun_normal_(self.weight, cin * k * k, generator)

    def forward(self, x):
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        with exact_f32_conv(self.dtype == torch.float32):
            return F.conv2d(x.to(self.dtype), w, b, padding=self.weight.shape[-1] // 2)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel 2, stride 2, NCHW.

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
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        with exact_f32_conv(self.dtype == torch.float32):
            return F.conv_transpose2d(x.to(self.dtype), w, b, stride=2)


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

    ``forward`` takes and returns NCHW; the output is float32. Submodules
    are ordered as flax creates them: ``blocks`` = ConvBlock_0 … ConvBlock_2d
    (encoder, bottleneck, decoder), ``ups`` = ConvTranspose_0 … (shuffle:
    Conv_0 … Conv_{depth-1}), ``head`` = Conv_0 (shuffle: Conv_{depth}).
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

    @staticmethod
    def level_features(base: int, stem: int, depth: int) -> Sequence[int]:
        """Features per level, doubling per octave from full resolution
        (the stem level is log2(stem) octaves down), capped as in flax."""
        return [min(base * stem * (1 << d), FEATURES_CAP) for d in range(depth + 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2], x.shape[-1]
        mult = self.stem << self.depth
        x = F.pad(x, (0, (-w) % mult, 0, (-h) % mult))
        x = x.to(self.dtype)
        if self.stem > 1:
            x = _s2d_nchw(x, self.stem)
        skips = []
        for d in range(self.depth):
            x = self.blocks[d](x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.blocks[self.depth](x)
        for i, d in enumerate(reversed(range(self.depth))):
            x = self.ups[i](x)
            if self.upsample == "shuffle":
                x = _d2s_nchw(x, 2)
            x = torch.cat([x, skips[d]], dim=1)
            x = self.blocks[self.depth + 1 + i](x)
        x = self.head(x)
        if self.stem > 1:
            x = _d2s_nchw(x, self.stem)
        return x.float()[..., :h, :w]
