"""Unrolled primal-dual networks (port of ``pdunet_tpu/models/primal_dual.py``):
Learned Primal-Dual (LPD: small 3-conv PReLU nets, 5-channel memories) and
the Primal-Dual UNet (UNets, one-channel memories), real or complex
operators.

Per iteration, with the operators coupled through memory channel 0:

    h ← h + DualNet([h, A f₀ᶜʰ, g])
    f ← f + PrimalNet([f, A† h₀ᶜʰ])

The primal memory ``f`` starts as ``f0`` tiled over ``primal_channels``,
the dual memory ``h`` as zeros with ``dual_channels``. With ``complex_ops``
(radial MRI) every quantity is a (Re, Im) channel pair on dim 1, the
memories tile as [Re, Im, Re, Im, …], the operators see the complex number
made from channels 0:2, and the model returns a complex tensor.

The JAX package scans one ``_PDIteration`` over the unroll; here the unroll
is a Python loop over ``iterations``, each holding its own dual and primal
net (flax's ``UNet_0`` / ``ConvNet_0`` and ``UNet_1`` / ``ConvNet_1``
inside ``Scan_PDIteration_0``), or, with shared weights, one iteration
applied ``n_iters`` times.

``remat`` recomputes each iteration's body in the backward instead of
keeping its activations (``torch.utils.checkpoint``; flax's ``nn.remat``):
memory for time, with the same results. It wraps the call, not the
modules, so parameter names (``state_dict`` keys) do not depend on it.

Each iteration's dual and primal nets run inside the spans ``pd.dual`` and
``pd.primal`` (``utils/trace.py``), with their concatenated input and
residual add; under remat the backward's recomputation opens them again.

LPD's ``ConvNet`` computes in NHWC (``torch.channels_last``), the layout of
every convolution kernel cuDNN runs on the card, from one entry copy (cast,
channels_last, zero channels) to one exit pass (float32 NCHW, the pad
channels dropped, the residual added). On the card each convolution's
input and output channels are padded with exact zeros to a multiple of 8
(16 bytes of bf16, what cuDNN's tensor-op NHWC kernels read: given 7, 6 or
5 channels, cuDNN pads them itself in a kernel of its own on every call,
and for 7 or 6 input channels picks a kernel twice as slow), the weights
and biases with zero slices per call; the parameters keep their shapes.
On the CPU nothing is padded, so the arithmetic and the counted operations
are the network's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pdunet_tpu_torch.models.unet import Conv, UNet, _conv
from pdunet_tpu_torch.utils import trace
from pdunet_tpu_torch.utils.trace import span

__all__ = ["PReLU", "ConvNet", "PDIteration", "UnrolledPrimalDual", "make_lpd", "make_pdunet"]


class PReLU(nn.Module):
    """flax ``nn.PReLU``: one scalar ``negative_slope`` (float32, starts at
    0.01), applied in the input's dtype: where(x ≥ 0, x, slope·x).
    ``torch.nn.PReLU`` differs in both: it starts at 0.25 and computes in
    its weight's dtype."""

    def __init__(self, device=None):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.full((), 0.01, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


def _channel_multiple(device: torch.device) -> int:
    """The multiple ``ConvNet`` pads its convolutions' channels to: 8 on the
    card, 1 (no padding) on the CPU."""
    return 8 if device.type == "cuda" else 1


def _round_up(n: int, m: int) -> int:
    return n + (-n) % m


def _convnet_entry(x: torch.Tensor, channels: int, dtype) -> torch.Tensor:
    """NCHW (B, C, H, W) → channels_last (B, ``channels``, H, W) in
    ``dtype``, channels C onward zero: one copy, and a fill of the pad
    channels."""
    b, c, h, w = x.shape
    out = torch.empty((b, h, w, channels), dtype=dtype, device=x.device).permute(0, 3, 1, 2)
    out[:, c:].zero_()
    out[:, :c].copy_(x)
    return out


class ConvNet(nn.Module):
    """The small LPD subnet (flax ``ConvNet``, its default 3 layers): two 3x3
    convolutions each followed by PReLU, then a linear 3x3 convolution. The
    input is cast to ``dtype``, the output to float32. Submodules:
    ``convs`` = Conv_0 … Conv_2, ``acts`` = PReLU_0, PReLU_1.

    ``forward`` takes and returns NCHW float32; ``residual`` (NCHW, the
    output's shape) is added to the output in its exit pass. Between the
    two the activations are channels_last in ``dtype``, their channels
    zero-padded on the card (module docstring)."""

    #: calls on the card (all channels_last) and their convolutions whose
    #: channels were padded; read per root span through ``utils/trace.py``
    channels_last_calls = 0
    padded_convs = 0

    def __init__(self, in_channels: int, out_channels: int, features: int = 32,
                 dtype=torch.float32, generator=None, device="cuda"):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator, device=device)
        widths = (in_channels, features, features, out_channels)
        self.convs = nn.ModuleList(
            [Conv(cin, cout, 3, **kw) for cin, cout in zip(widths, widths[1:])])
        self.acts = nn.ModuleList([PReLU(device=device) for _ in range(2)])

    def _padded_conv(self, conv: Conv, x: torch.Tensor, m: int) -> torch.Tensor:
        """``conv`` of the channels_last ``x``, whose channels may be padded,
        with its output channels padded to a multiple of ``m``: the weight
        and bias gain zero slices to match."""
        w, b = conv.weight, conv.bias
        cout, cin = w.shape[:2]
        pad_in, pad_out = x.shape[1] - cin, _round_up(cout, m) - cout
        if pad_in or pad_out:
            w = F.pad(w, (0, 0, 0, 0, 0, pad_in, 0, pad_out))
            b = F.pad(b, (0, pad_out))
            if x.is_cuda:
                ConvNet.padded_convs += 1
        return _conv(F.conv2d, x, w, b, self.dtype, padding=w.shape[-1] // 2)

    def forward(self, x, residual=None):
        m = _channel_multiple(x.device)
        if x.is_cuda:
            ConvNet.channels_last_calls += 1
        x = _convnet_entry(x, _round_up(x.shape[1], m), self.dtype)
        for conv, act in zip(self.convs, self.acts):
            x = act(self._padded_conv(conv, x, m))
        last = self.convs[-1]
        y = self._padded_conv(last, x, m)[:, :last.weight.shape[0]]
        if residual is None:
            return y.to(torch.float32, memory_format=torch.contiguous_format)
        return residual + y  # float32, in the residual's (NCHW) layout


trace.counter("convnet.channels_last", lambda: ConvNet.channels_last_calls)
trace.counter("convnet.padded_convs", lambda: ConvNet.padded_convs)


class PDIteration(nn.Module):
    def __init__(self, dual: nn.Module, primal: nn.Module):
        super().__init__()
        self.dual = dual
        self.primal = primal


def _update(net: nn.Module, r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The residual update r + net(x); a ``ConvNet`` adds ``r`` in its exit pass."""
    return net(x, residual=r) if isinstance(net, ConvNet) else r + net(x)


def _to_channels(z: torch.Tensor) -> torch.Tensor:
    """(B, H, W) complex → (B, 2, H, W) float32 (Re, Im)."""
    return torch.stack([z.real, z.imag], dim=1).float()


def _to_complex(x: torch.Tensor) -> torch.Tensor:
    """Channels 0:2 of (B, C, H, W) → (B, H, W) complex."""
    return torch.complex(x[:, 0], x[:, 1])


class UnrolledPrimalDual(nn.Module):
    """Call with the measurement ``g`` (B, A, S) and the initial image
    ``f0`` (B, N, N); returns the reconstruction (B, N, N), float32 or,
    with ``complex_ops``, complex.

    ``iterations`` holds one ``PDIteration`` per unroll step, or a single
    one that all ``n_iters`` steps share (flax's ``share_weights``). The
    memories have ``primal_channels`` / ``dual_channels`` (real or complex)
    channels."""

    def __init__(self, A: Callable, At: Callable, iterations, complex_ops: bool = False,
                 remat: bool = False, n_iters: int = None, primal_channels: int = 1,
                 dual_channels: int = 1):
        super().__init__()
        self.A, self.At = A, At
        self.complex_ops = complex_ops
        self.remat = remat
        self.iterations = nn.ModuleList(iterations)
        self.n_iters = len(self.iterations) if n_iters is None else n_iters
        if len(self.iterations) not in (1, self.n_iters):
            raise ValueError(f"{len(self.iterations)} iterations for an unroll of "
                             f"{self.n_iters}: give one per step, or one to share")
        self.primal_channels, self.dual_channels = primal_channels, dual_channels

    @property
    def share_weights(self) -> bool:
        return len(self.iterations) == 1 < self.n_iters

    def _pack(self, z: torch.Tensor) -> torch.Tensor:
        return _to_channels(z) if self.complex_ops else z[:, None].float()

    def _unpack(self, x: torch.Tensor) -> torch.Tensor:
        return _to_complex(x) if self.complex_ops else x[:, 0]

    def _iteration(self, it: PDIteration, f, h, g_ch):
        """One unroll step: the dual update, then the primal update."""
        Af = self._pack(self.A(self._unpack(f)))
        with span("pd.dual"):
            h = _update(it.dual, h, torch.cat([h, Af, g_ch], dim=1))
        Ath = self._pack(self.At(self._unpack(h)))
        with span("pd.primal"):
            f = _update(it.primal, f, torch.cat([f, Ath], dim=1))
        return f, h

    def forward(self, g: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        g_ch = self._pack(g)
        f = self._pack(f0)
        if self.primal_channels > 1:
            f = f.repeat(1, self.primal_channels, 1, 1)
        h = g_ch.new_zeros((g_ch.shape[0], g_ch.shape[1] * self.dual_channels)
                           + tuple(g_ch.shape[2:]))
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.n_iters):
            it = self.iterations[i % len(self.iterations)]
            if remat:
                # the body draws no random numbers: no RNG state to replay
                f, h = checkpoint(self._iteration, it, f, h, g_ch,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                f, h = self._iteration(it, f, h, g_ch)
        return self._unpack(f)


def make_pdunet(A: Callable, At: Callable, n_iters: int = 4,
                base_features: int = 32, depth: int = 3, stem: int = 1,
                complex_ops: bool = False, dtype=torch.float32,
                generator: torch.Generator = None,
                device="cuda", remat: bool = False,
                upsample: str = "convtranspose") -> UnrolledPrimalDual:
    """Primal-Dual UNet with its own weights in every iteration; ``remat``
    recomputes each iteration in the backward (same results and names)."""
    step = 2 if complex_ops else 1
    kw = dict(out_channels=step, base_features=base_features, depth=depth,
              stem=stem, dtype=dtype, upsample=upsample, generator=generator,
              device=device)
    return UnrolledPrimalDual(A, At, [
        PDIteration(UNet(in_channels=3 * step, **kw), UNet(in_channels=2 * step, **kw))
        for _ in range(n_iters)
    ], complex_ops=complex_ops, remat=remat)


def make_lpd(A: Callable, At: Callable, n_iters: int = 10, features: int = 32,
             primal_channels: int = 5, dual_channels: int = 5,
             complex_ops: bool = False, dtype=torch.float32,
             share_weights: bool = False, generator: torch.Generator = None,
             device="cuda", remat: bool = False) -> UnrolledPrimalDual:
    """Learned Primal-Dual with the Adler & Öktem defaults: the dual net
    maps [h, A f, g] (real: 5 + 1 + 1 = 7 channels) to 5, the primal net
    [f, A† h] (5 + 1 = 6) to 5; complex operators double every count."""
    step = 2 if complex_ops else 1
    kw = dict(features=features, dtype=dtype, generator=generator, device=device)

    def iteration():
        return PDIteration(
            ConvNet(step * (dual_channels + 2), step * dual_channels, **kw),
            ConvNet(step * (primal_channels + 1), step * primal_channels, **kw))

    return UnrolledPrimalDual(A, At, [iteration() for _ in range(1 if share_weights else n_iters)],
                              complex_ops=complex_ops, remat=remat, n_iters=n_iters,
                              primal_channels=primal_channels, dual_channels=dual_channels)
