"""Task definitions (port of ``pdunet_tpu/training/tasks.py``): the
``pdunet`` and ``lpd`` tasks on parallel-beam CT and radial MRI, and the
``fbp_unet`` and ``sino_unet`` tasks on parallel-beam CT.

A Task bundles the model, batch synthesis on the device, the loss and the
reconstruction function:

    pdunet, lpd   phantoms → f32 sparse A → f32 direct recon f0 (ramp FBP,
                  radial: DCF adjoint); recon_fn: the unroll with A/σ and
                  A†/σ in the preset's dtype (radial: the magnitude of the
                  complex output); loss of the prediction against the
                  ground truth (radial: the complex one, ``image_c``)
    fbp_unet      phantoms → f32 sparse A → f32 FBP; recon_fn: fbp +
                  UNet(fbp); loss on the image
    sino_unet     phantoms → f32 dense A → every k-th angle → linear
                  re-expansion (``sino_in``); the prediction sino_in +
                  UNet(sino_in) with the measured rows re-imposed (hard
                  data consistency); recon_fn: its f32 dense FBP; loss:
                  w_s·L(pred, sino_dense) + w_i·L(FBP(pred), image)

Measurement synthesis, direct recons and the sino task's output FBP run in
float32 even when the networks run in bfloat16: the simulated measurement
plays the role of physics, and synthesising it in bf16 would bake ~1e-2
relative rounding into the data. σ, the operator norm used to scale the
unrolls' operators, comes from the unroll's own (bf16 when the preset says
so) sparse operators, as in JAX; the UNet tasks have none.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from pdunet_tpu_torch.configs import ExperimentConfig, GeometryConfig
from pdunet_tpu_torch.data.pipeline import interp_upsample_angles, subsample_angles
from pdunet_tpu_torch.data.synth import random_phantom_batch
from pdunet_tpu_torch.geometry import ParallelGeometry, RadialGeometry
from pdunet_tpu_torch.models.primal_dual import UnrolledPrimalDual, make_lpd, make_pdunet
from pdunet_tpu_torch.models.unet import UNet
from pdunet_tpu_torch.ops.losses import LOSSES
from pdunet_tpu_torch.ops.nufft import make_radial_ops
from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

__all__ = ["Task", "build_task", "build_geometries", "estimate_opnorm"]


#: the model of a task: a PD-UNet or LPD unroll, or a bare UNet
#: (fbp_unet, sino_unet)
Model = Union[UnrolledPrimalDual, UNet]


class Task(NamedTuple):
    name: str
    model: Model
    #: re-draw the model's weights from a generator (flax's initialisers)
    init_params: Callable[[torch.Generator], Model]
    #: generator → batch dict: {"image", "sino", "f0"} (pdunet, lpd; radial
    #: adds "image_c"), {"image", "fbp"} (fbp_unet) or {"image",
    #: "sino_dense", "sino_in"} (sino_unet)
    make_batch: Callable[[torch.Generator], dict]
    #: (model, batch) → (scalar loss, aux dict); aux holds sino_unet's
    #: "sino_loss" / "img_loss" (each only for a nonzero weight), else {}
    loss_fn: Callable[[Model, dict], tuple]
    #: (model, batch) → reconstruction (B, N, N), real
    recon_fn: Callable[[Model, dict], torch.Tensor]
    config: ExperimentConfig
    image_size: int
    #: images (B, N, N) → the same batch dict, noiseless (radial: complex
    #: images or a (re, im) pair)
    batch_from_images: Callable[[torch.Tensor], dict]
    #: the unroll operators' norm (pdunet, lpd); None for the UNet tasks,
    #: which run no power iteration
    sigma: Optional[float]


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
            f"geometry kind {gc.kind!r} is not ported yet (parallel and radial only; "
            "fan beam: ROADMAP.md item 12)")
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
    """Build the task of ``config`` on ``device``: ``pdunet`` or ``lpd``
    (parallel-beam CT or radial MRI), ``fbp_unet`` or ``sino_unet``
    (parallel-beam CT).

    The model's weights come from a CPU generator seeded with 0; use
    ``init_params`` or ``models.convert.flax_to_torch`` to replace them.
    ``opnorm_x0`` is the power iteration's start vector (see
    :func:`estimate_opnorm`; the UNet tasks run none)."""
    gc, mc, tc = config.geometry, config.model, config.train
    if mc.kind not in ("pdunet", "lpd", "fbp_unet", "sino_unet"):
        raise NotImplementedError(f"model kind {mc.kind!r} is not ported yet")
    if mc.kind == "sino_unet" and gc.kind == "fan":
        # the angular re-expansion's wrap uses the parallel-beam symmetry
        # p(θ+π, s) = p(θ, −s), which fan sinograms do not have
        raise ValueError("sino_unet is not defined for fan geometry: the angular "
                         "upsampling wrap relies on parallel-beam detector-flip symmetry")
    if mc.kind == "sino_unet" and gc.kind == "radial":
        raise NotImplementedError("sino_unet on radial MRI (sino_unet_radial) is not ported "
                                  "yet (ROADMAP.md item 15)")
    if mc.kind == "fbp_unet" and gc.kind == "radial":
        raise NotImplementedError("fbp_unet is ported for parallel-beam CT only")
    if tc.photons_per_ray > 0:
        raise NotImplementedError("low-dose noise (photons_per_ray > 0) is not ported yet "
                                  "(ROADMAP.md item 12)")
    if tc.kspace_snr_db > 0:
        raise NotImplementedError("k-space noise (kspace_snr_db > 0) is not ported yet "
                                  "(ROADMAP.md item 15)")
    loss = LOSSES[tc.loss]
    device = torch.device(device)
    dense_geom, sparse_geom = build_geometries(gc)
    is_complex = gc.kind == "radial"
    make_ops = make_radial_ops if is_complex else make_parallel_ops
    dtype = torch.bfloat16 if mc.use_bfloat16 else torch.float32
    N = gc.image_size
    B = tc.batch_size

    def phantoms(generator):
        return random_phantom_batch(generator, B, N, n_ellipses=tc.n_ellipses,
                                    pixel_spacing=gc.pixel_spacing, device=device)

    def finish(new_model, make_batch, loss_fn, recon_fn, batch_from_images, sigma=None):
        # drawn on the CPU, so a seed gives the same weights on every device
        model = new_model(torch.Generator().manual_seed(0))

        def init_params(generator):
            """Re-draw the model's weights from a CPU ``generator``."""
            model.load_state_dict(new_model(generator).state_dict())
            return model

        return Task(config.name, model, init_params, make_batch, loss_fn, recon_fn, config,
                    N, batch_from_images, sigma)

    if mc.kind in ("fbp_unet", "sino_unet"):
        def new_unet(generator):
            return UNet(in_channels=1, out_channels=1, base_features=mc.base_features,
                        depth=mc.depth, stem=mc.stem, dtype=dtype, upsample=mc.upsample,
                        generator=generator, device="cpu").to(device)

    if mc.kind == "fbp_unet":
        # the f32 sparse operators only: synthesis and the FBP the UNet cleans
        ops = make_ops(sparse_geom, dtype=torch.float32, device=device)

        def batch_from_images(img):
            return {"image": img, "fbp": ops.fbp(ops.A(img))}

        def make_batch(generator):
            return batch_from_images(phantoms(generator))

        def recon_fn(model, batch):
            return batch["fbp"] + model(batch["fbp"][:, None])[:, 0]

        def loss_fn(model, batch):
            return loss(recon_fn(model, batch), batch["image"]), {}

        return finish(new_unet, make_batch, loss_fn, recon_fn, batch_from_images)

    if mc.kind == "sino_unet":
        # the f32 dense operators only: synthesis, and the FBP of the output
        ops = make_ops(dense_geom, dtype=torch.float32, device=device)
        k = gc.sparsity
        # hard data consistency: dense row i was measured iff i % k == 0
        # (subsample_angles keeps every k-th row and interp_upsample_angles
        # passes those rows through exactly), so the prediction re-imposes
        # them and the UNet only fills the interpolated rows
        measured_rows = (torch.arange(dense_geom.n_angles, device=device) % k == 0)[:, None]

        def batch_from_images(img):
            sino_dense = ops.A(img)
            sino_in = interp_upsample_angles(subsample_angles(sino_dense, k), k,
                                             gc.angular_coverage)
            return {"image": img, "sino_dense": sino_dense, "sino_in": sino_in}

        def make_batch(generator):
            return batch_from_images(phantoms(generator))

        def predict_sino(model, batch):
            x = batch["sino_in"]
            return torch.where(measured_rows, x, x + model(x[:, None])[:, 0])

        def recon_fn(model, batch):
            return ops.fbp(predict_sino(model, batch))

        def loss_fn(model, batch):
            pred = predict_sino(model, batch)
            total, aux = 0.0, {}
            if tc.sino_loss_weight:
                aux["sino_loss"] = loss(pred, batch["sino_dense"])
                total = total + tc.sino_loss_weight * aux["sino_loss"]
            if tc.img_loss_weight:
                aux["img_loss"] = loss(ops.fbp(pred), batch["image"])
                total = total + tc.img_loss_weight * aux["img_loss"]
            return total, aux

        return finish(new_unet, make_batch, loss_fn, recon_fn, batch_from_images)

    # pdunet and lpd: the unroll runs the sparse operators in the preset's
    # dtype, scaled to unit norm (σ) so the networks see O(1) inputs
    ops_sparse = make_ops(sparse_geom, dtype=dtype, device=device)
    ops_synth = (ops_sparse if dtype == torch.float32
                 else make_ops(sparse_geom, dtype=torch.float32, device=device))
    sigma = estimate_opnorm(ops_sparse.A, ops_sparse.At, (N, N), x0=opnorm_x0,
                            device=device, is_complex=is_complex)
    A_n = lambda f: ops_sparse.A(f) / sigma
    At_n = lambda p: ops_sparse.At(p) / sigma

    def new_model(generator):
        kw = dict(n_iters=mc.n_iters, complex_ops=is_complex, dtype=dtype,
                  generator=generator, device="cpu", remat=mc.remat)
        if mc.kind == "lpd":
            model = make_lpd(A_n, At_n, features=mc.lpd_features,
                             primal_channels=mc.primal_channels,
                             dual_channels=mc.dual_channels, **kw)
        else:
            model = make_pdunet(A_n, At_n, base_features=mc.base_features, depth=mc.depth,
                                stem=mc.stem, upsample=mc.upsample, **kw)
        return model.to(device)

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
            return batch_from_images(phantoms(generator))

        def recon_fn(model, batch):
            return model(batch["sino"] / sigma, batch["f0"])

        def loss_fn(model, batch):
            return loss(recon_fn(model, batch), batch["image"]), {}

    return finish(new_model, make_batch, loss_fn, recon_fn, batch_from_images, sigma)
