"""Radial MRI operators (port of ``pdunet_tpu/ops/nufft``).

``A`` (type-2 NUFFT, image → k-space) and ``At`` (its conjugate transpose)
run one of two implementations: ``impl="fourier_slice"`` (the default), the
fourier-slice formulation (:mod:`.fourier_slice`) on the per-angle
projector kernels, or ``impl="gridding"``, the Kaiser-Bessel gridding
NUFFT (:mod:`.nufft`: FFTs, a gather and a segment sum, always complex64).
The fourier-slice path needs an even ``samples_per_spoke``; for an odd one
``make_radial_ops`` warns and falls back to gridding, as the JAX package
does. ``fbp`` is the density-compensated adjoint ``At(k·dcf)/(2π)²``.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Callable, NamedTuple, Union

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
from pdunet_tpu_torch.ops.nufft.nufft import (
    NufftPlan,
    build_nufft_plan,
    nufft_adjoint,
    nufft_forward,
)
from pdunet_tpu_torch.ops.radon.parallel import plan_projector

__all__ = ["NufftOps", "make_radial_ops", "radial_dcf", "radial_dcf_pipe_menon"]


class _Forward(torch.autograd.Function):
    """A = ``fwd``, C-linear, whose conjugate transpose is ``adj``. PyTorch's
    gradient of a C-linear map y = A x is A^H applied to the incoming
    gradient, with no conjugations (JAX's cotangent convention is the
    conjugate of PyTorch's, hence its conj(A†(conj(ḡ))))."""

    @staticmethod
    def forward(ctx, f, fwd, adj):
        ctx.adj, ctx.real_input = adj, not f.is_complex()
        return fwd(f)

    @staticmethod
    def backward(ctx, g):
        grad = ctx.adj(g)
        return (grad.real if ctx.real_input else grad), None, None


class _Adjoint(torch.autograd.Function):
    """A† = ``adj`` with gradient A = ``fwd``."""

    @staticmethod
    def forward(ctx, k, fwd, adj):
        ctx.fwd, ctx.real_input = fwd, not k.is_complex()
        return adj(k)

    @staticmethod
    def backward(ctx, g):
        grad = ctx.fwd(g)
        return (grad.real if ctx.real_input else grad), None, None


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
    #: the fourier-slice plan, or the gridding plan with ``impl="gridding"``
    plan: Union[FsPlan, NufftPlan]


def make_radial_ops(geom: RadialGeometry, impl: str = "fourier_slice",
                    dtype=torch.float32, dcf: str = "pipe_menon",
                    device="cuda", mesh=None) -> NufftOps:
    """Differentiable radial NUFFT bundle on ``device``.

    ``impl``: "fourier_slice" (default; ``dtype``, float32 or bfloat16, is
    its projector's operand type) or "gridding" (Kaiser-Bessel, 4 taps per
    axis on a grid oversampled twice; complex64 whatever ``dtype`` says).
    An odd ``samples_per_spoke`` has no fourier-slice grid: the default
    then warns and runs gridding. ``dcf``: density compensation for
    ``fbp``, "pipe_menon" (default) or "voronoi_ramp". ``mesh``: the
    fourier-slice path's spokes are angle-sharded over the mesh's angle
    axis (``plan_projector``); gridding with a mesh raises.
    """
    if impl == "fourier_slice" and geom.samples_per_spoke % 2:
        warnings.warn(
            "fourier_slice needs an even samples_per_spoke (got "
            f"{geom.samples_per_spoke}); falling back to impl='gridding'",
            stacklevel=2)
        impl = "gridding"
    if impl == "fourier_slice":
        plan = build_fs_plan(geom, dtype=dtype, device=device)
        dcf_w = torch.as_tensor(resolve_dcf(geom, dcf), device=device)
        project, backproject = plan_projector(plan.par_plan, mesh)
        fwd = functools.partial(fs_nufft_forward, plan, project=project)
        adj = functools.partial(fs_nufft_adjoint, plan, backproject=backproject)
    elif impl == "gridding":
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding applies to the fourier_slice fast path only; the "
                "gridding oracle is single-device by design")
        plan = build_nufft_plan(geom, dcf=dcf, device=device)
        dcf_w = plan.dcf
        fwd = functools.partial(nufft_forward, plan)
        adj = functools.partial(nufft_adjoint, plan)
    else:
        raise ValueError(f"unknown NUFFT impl {impl!r}")

    def A(f):
        return _Forward.apply(f, fwd, adj)

    def At(k):
        return _Adjoint.apply(k, fwd, adj)

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
