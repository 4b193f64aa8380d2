"""Task definition for the serving paths (port of the ``pdunet`` branches
of ``pdunet_tpu/training/tasks.py``: parallel-beam CT and radial MRI).

A Task bundles the model, batch synthesis on the device and the
reconstruction function:

    make_batch      phantoms → f32 A (synthesis) → f32 direct recon (f0):
                    ramp-filter FBP (parallel) or DCF adjoint (radial)
    recon_fn        PD-UNet unroll with A/σ and A†/σ in the preset's dtype
                    (radial: the magnitude of the complex output)
    loss_fn         ``train.loss`` of the prediction against the ground
                    truth (radial: of the complex prediction against
                    ``image_c``, not of its magnitude)

Measurement synthesis and f0 run in float32 even when the unroll runs in
bfloat16: the simulated measurement plays the role of physics, and
synthesising it in bf16 would bake ~1e-2 relative rounding into the data.
σ, the operator norm used to scale the unroll's operators, comes from the
unroll's own (bf16 when the preset says so) sparse operators, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from pdunet_tpu_torch.configs import ExperimentConfig, GeometryConfig
from pdunet_tpu_torch.data.synth import random_phantom_batch
from pdunet_tpu_torch.geometry import ParallelGeometry, RadialGeometry
from pdunet_tpu_torch.models.primal_dual import UnrolledPrimalDual, make_pdunet
from pdunet_tpu_torch.ops.losses import LOSSES
from pdunet_tpu_torch.ops.nufft import make_radial_ops
from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

__all__ = ["Task", "build_task", "build_geometries", "estimate_opnorm"]


class Task(NamedTuple):
    name: str
    model: UnrolledPrimalDual
    #: re-draw the model's weights from a generator (flax's initialisers)
    init_params: Callable[[torch.Generator], UnrolledPrimalDual]
    #: generator → {"image", "sino", "f0"} (radial adds "image_c")
    make_batch: Callable[[torch.Generator], dict]
    #: (model, batch) → (scalar loss, aux dict); aux is {} for both tasks
    loss_fn: Callable[[UnrolledPrimalDual, dict], tuple]
    #: (model, batch) → reconstruction (B, N, N), real
    recon_fn: Callable[[UnrolledPrimalDual, dict], torch.Tensor]
    config: ExperimentConfig
    image_size: int
    #: images (B, N, N) → the same batch dict, noiseless (radial: complex
    #: images or a (re, im) pair)
    batch_from_images: Callable[[torch.Tensor], dict]
    sigma: float


def build_geometries(gc: GeometryConfig):
    """Dense + sparse geometry pair for a config (parallel or radial)."""
    if gc.kind == "radial":
        dense = RadialGeometry(
            image_size=gc.image_size,
            n_spokes=gc.n_angles,
            samples_per_spoke=gc.samples_per_spoke,
            pixel_spacing=gc.pixel_spacing,
        )
        return dense, dense.subsample(gc.sparsity)
    if gc.kind != "parallel":
        raise NotImplementedError(
            f"geometry kind {gc.kind!r} is not ported yet (parallel and radial only)")
    coverage = gc.angular_coverage
    angles = tuple(coverage * math.pi * k / gc.n_angles for k in range(gc.n_angles))
    dense = ParallelGeometry(
        image_size=gc.image_size,
        det_count=gc.det_count,
        det_spacing=gc.det_spacing,
        pixel_spacing=gc.pixel_spacing,
        angles=angles,
    )
    return dense, dense.subsample(gc.sparsity)


@torch.no_grad()
def estimate_opnorm(A, At, image_shape, n_iters: int = 20, x0=None,
                    device="cuda", is_complex: bool = False) -> float:
    """Largest singular value of A by power iteration on A†A.

    ``x0`` is the start vector; by default a standard normal draw from a
    generator seeded with 0 (the JAX package starts from
    ``jax.random.normal(PRNGKey(0), image_shape)``, which a test may pass).
    ``is_complex``: the real start vector is cast to complex64, and
    σ² = Re⟨x, A†A x⟩ / ⟨x, x⟩."""
    if x0 is None:
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn(image_shape, generator=gen, device=device)
    else:
        x = torch.tensor(np.asarray(x0), dtype=torch.float32, device=device)
    if is_complex:
        x = x.to(torch.complex64)
    for _ in range(n_iters):
        y = At(A(x))
        x = y / torch.sqrt(torch.sum(y.abs() ** 2))
    sigma2 = torch.sum(torch.real(torch.conj(x) * At(A(x)))) / torch.sum(x.abs() ** 2)
    return float(torch.sqrt(sigma2))


def _phase_field(generator, B: int, N: int, device) -> torch.Tensor:
    """(B, N, N) smooth random phase: low-order spatial harmonics with
    coefficients uniform in [−π, π) (the JAX task's phase model)."""
    coeffs = -math.pi + 2.0 * math.pi * torch.rand((B, 4), generator=generator,
                                                    device=device)
    ax = torch.linspace(-1.0, 1.0, N, device=device)
    Y, X = torch.meshgrid(ax, ax, indexing="ij")
    c = coeffs[:, :, None, None]
    return c[:, 0] * X + c[:, 1] * Y + c[:, 2] * X * Y + c[:, 3] * (X ** 2 - Y ** 2)


def build_task(config: ExperimentConfig, device="cuda", opnorm_x0=None) -> Task:
    """Build the ``pdunet`` task (parallel-beam CT or radial MRI) on ``device``.

    The model's weights come from a CPU generator seeded with 0; use
    ``init_params`` or ``models.convert.flax_to_torch`` to replace them.
    ``opnorm_x0`` is the power iteration's start vector (see
    :func:`estimate_opnorm`)."""
    gc, mc, tc = config.geometry, config.model, config.train
    if mc.kind != "pdunet":
        raise NotImplementedError(f"model kind {mc.kind!r} is not ported yet")
    if tc.photons_per_ray > 0:
        raise NotImplementedError("low-dose noise (photons_per_ray > 0) is not ported yet")
    if tc.kspace_snr_db > 0:
        raise NotImplementedError("k-space noise (kspace_snr_db > 0) is not ported yet")
    if mc.upsample != "convtranspose":
        raise NotImplementedError(f"upsample={mc.upsample!r} is not ported yet")
    loss = LOSSES[tc.loss]
    device = torch.device(device)
    dense_geom, sparse_geom = build_geometries(gc)
    del dense_geom  # the pdunet tasks measure only the sparse scan
    is_complex = gc.kind == "radial"
    make_ops = make_radial_ops if is_complex else make_parallel_ops
    dtype = torch.bfloat16 if mc.use_bfloat16 else torch.float32
    ops_sparse = make_ops(sparse_geom, dtype=dtype, device=device)
    ops_synth = (ops_sparse if dtype == torch.float32
                 else make_ops(sparse_geom, dtype=torch.float32, device=device))
    N = gc.image_size
    B = tc.batch_size

    sigma = estimate_opnorm(ops_sparse.A, ops_sparse.At, (N, N), x0=opnorm_x0,
                            device=device, is_complex=is_complex)
    A_n = lambda f: ops_sparse.A(f) / sigma
    At_n = lambda p: ops_sparse.At(p) / sigma

    def new_model(generator):
        # drawn on the CPU, so a seed gives the same weights on every device
        return make_pdunet(A=A_n, At=At_n, n_iters=mc.n_iters,
                           base_features=mc.base_features, depth=mc.depth,
                           stem=mc.stem, complex_ops=is_complex, dtype=dtype,
                           generator=generator, device="cpu", remat=mc.remat).to(device)

    model = new_model(torch.Generator().manual_seed(0))

    def init_params(generator):
        """Re-draw the model's weights from a CPU ``generator``."""
        model.load_state_dict(new_model(generator).state_dict())
        return model

    if is_complex:
        # complex MRI data: a nonnegative magnitude phantom with a smooth
        # random phase field
        def batch_from_images(img):
            img_c = (torch.complex(img[0].float(), img[1].float())
                     if isinstance(img, (tuple, list)) else img.to(torch.complex64))
            g = ops_synth.A(img_c)
            return {"image": img_c.abs(), "image_c": img_c, "sino": g,
                    "f0": ops_synth.fbp(g)}

        def make_batch(generator):
            mag = random_phantom_batch(generator, B, N, n_ellipses=tc.n_ellipses,
                                       pixel_spacing=gc.pixel_spacing, nonneg=True,
                                       device=device)
            img_c = mag.to(torch.complex64) * torch.exp(
                1j * _phase_field(generator, B, N, device))
            return dict(batch_from_images(img_c), image=mag)

        def predict_c(model, batch):
            # measurements scaled like A_n so the dual net sees O(1) inputs
            return model(batch["sino"] / sigma, batch["f0"])

        def recon_fn(model, batch):
            return predict_c(model, batch).abs()

        def loss_fn(model, batch):
            return loss(predict_c(model, batch), batch["image_c"]), {}
    else:
        def batch_from_images(img):
            g = ops_synth.A(img)
            return {"image": img, "sino": g, "f0": ops_synth.fbp(g)}

        def make_batch(generator):
            img = random_phantom_batch(generator, B, N, n_ellipses=tc.n_ellipses,
                                       pixel_spacing=gc.pixel_spacing, device=device)
            return batch_from_images(img)

        def recon_fn(model, batch):
            return model(batch["sino"] / sigma, batch["f0"])

        def loss_fn(model, batch):
            return loss(recon_fn(model, batch), batch["image"]), {}

    return Task(config.name, model, init_params, make_batch, loss_fn, recon_fn, config,
                N, batch_from_images, sigma)
