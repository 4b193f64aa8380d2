"""Radial MRI operators (port of ``pdunet_tpu/ops/nufft``, the
``impl="fourier_slice"`` path of ``make_radial_ops``).

``A`` (type-2 NUFFT, image → k-space) and ``At`` (its conjugate transpose)
run the fourier-slice formulation (:mod:`.fourier_slice`) on the per-angle
projector kernels; ``fbp`` is the density-compensated adjoint
``At(k·dcf)/(2π)²``. The Kaiser-Bessel gridding implementation is not ported
yet (ROADMAP item 14).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pdunet_tpu_torch.geometry import RadialGeometry
from pdunet_tpu_torch.ops.nufft.dcf import (
    radial_dcf,
    radial_dcf_pipe_menon,
    resolve_dcf,
)
from pdunet_tpu_torch.ops.nufft.fourier_slice import (
    FsPlan,
    build_fs_plan,
    fs_nufft_adjoint,
    fs_nufft_forward,
)

__all__ = ["NufftOps", "make_radial_ops", "radial_dcf", "radial_dcf_pipe_menon"]


class _Forward(torch.autograd.Function):
    """A, C-linear. PyTorch's gradient of a C-linear map y = A x is
    A^H applied to the incoming gradient, with no conjugations (JAX's
    cotangent convention is the conjugate of PyTorch's, hence its
    conj(A†(conj(ḡ))))."""

    @staticmethod
    def forward(ctx, f, plan):
        ctx.plan, ctx.real_input = plan, not f.is_complex()
        return fs_nufft_forward(plan, f)

    @staticmethod
    def backward(ctx, g):
        grad = fs_nufft_adjoint(ctx.plan, g)
        return (grad.real if ctx.real_input else grad), None


class _Adjoint(torch.autograd.Function):
    """A† with gradient A."""

    @staticmethod
    def forward(ctx, k, plan):
        ctx.plan, ctx.real_input = plan, not k.is_complex()
        return fs_nufft_adjoint(plan, k)

    @staticmethod
    def backward(ctx, g):
        grad = fs_nufft_forward(ctx.plan, g)
        return (grad.real if ctx.real_input else grad), None


class NufftOps(NamedTuple):
    """Differentiable radial operator bundle (``fbp`` is the
    density-compensated adjoint, the direct-recon analogue)."""

    A: Callable[[torch.Tensor], torch.Tensor]
    At: Callable[[torch.Tensor], torch.Tensor]
    fbp: Callable[..., torch.Tensor]
    geom: RadialGeometry
    image_shape: tuple
    sino_shape: tuple
    dcf: torch.Tensor
    plan: FsPlan


def make_radial_ops(geom: RadialGeometry, impl: str = "fourier_slice",
                    dtype=torch.float32, dcf: str = "pipe_menon",
                    device="cuda") -> NufftOps:
    """Differentiable radial NUFFT bundle on ``device``.

    ``dtype`` is the projector's operand type (float32 or bfloat16).
    ``dcf``: density compensation for ``fbp``, "pipe_menon" (default) or
    "voronoi_ramp". Only ``impl="fourier_slice"`` with an even
    ``samples_per_spoke`` is ported; anything else raises rather than
    silently running another operator.
    """
    if impl == "gridding" or (impl == "fourier_slice" and geom.samples_per_spoke % 2):
        raise NotImplementedError(
            "the Kaiser-Bessel gridding NUFFT (impl='gridding', which the JAX "
            "package also uses for an odd samples_per_spoke) is not ported "
            f"yet (ROADMAP item 14); got impl={impl!r}, "
            f"samples_per_spoke={geom.samples_per_spoke}")
    if impl != "fourier_slice":
        raise ValueError(f"unknown NUFFT impl {impl!r}")
    plan = build_fs_plan(geom, dtype=dtype, device=device)
    dcf_w = torch.as_tensor(resolve_dcf(geom, dcf), device=device)

    def A(f):
        return _Forward.apply(f, plan)

    def At(k):
        return _Adjoint.apply(k, plan)

    def fbp(kdata, filter_name=None):
        del filter_name
        return At(kdata * dcf_w) / (2.0 * math.pi) ** 2

    return NufftOps(
        A=A,
        At=At,
        fbp=fbp,
        geom=geom,
        image_shape=(geom.image_size, geom.image_size),
        sino_shape=(geom.n_spokes, geom.samples_per_spoke),
        dcf=dcf_w,
        plan=plan,
    )
