"""Task definitions (port of ``pdunet_tpu/training/tasks.py``): the
``pdunet`` and ``lpd`` tasks on parallel- and fan-beam CT and radial MRI,
the ``fbp_unet`` task on parallel- and fan-beam CT, and the ``sino_unet``
task on parallel-beam CT and radial MRI.

A Task bundles the model, batch synthesis on the device, the loss and the
reconstruction function:

    pdunet, lpd   phantoms → f32 sparse A (+ noise) → f32 direct recon f0
                  (ramp FBP, radial: DCF adjoint); recon_fn: the unroll with
                  A/σ and A†/σ in the preset's dtype (radial: the magnitude
                  of the complex output); loss of the prediction against the
                  ground truth (radial: the complex one, ``image_c``)
    fbp_unet      phantoms → f32 sparse A (+ noise) → f32 FBP; recon_fn:
                  fbp + UNet(fbp); loss on the image
    sino_unet     phantoms → f32 dense A → every k-th angle (+ noise) →
                  linear re-expansion (``sino_in``); the prediction sino_in +
                  UNet(sino_in) with the measured rows re-imposed (hard
                  data consistency); recon_fn: its f32 dense FBP; loss:
                  w_s·L(pred, sino_dense) + w_i·L(FBP(pred), image)
    sino_unet     radial: complex phantoms → f32 dense spokes; the measured
                  golden-angle prefix (+ k-space noise) → angular spoke
                  interpolation; both mapped to the net domain (spokes
                  sorted mod π, reversed where flipped, ortho IFFT per
                  spoke: a smooth complex sinogram); the prediction
                  k_in_w + UNet(Re, Im) with the measured rows re-imposed;
                  recon_fn: |DCF adjoint| of the dense spokes; loss:
                  w_s·mean|pred − k_dense_w| + w_i·L(|recon|, image)

Noise: ``photons_per_ray > 0`` adds low-dose Poisson noise to the CT
measurement (in attenuation units, ×``MU_WATER``), ``kspace_snr_db > 0``
complex Gaussian noise to the radial one. ``make_batch(generator)`` draws
the phantoms and then the noise from its generator;
``batch_from_images(images, generator=None)`` is noiseless unless given a
generator (the JAX package's ``key=None``).

Spans (``utils/trace.py``): every task's ``batch_from_images`` runs inside
``synthesis`` and its ``recon_fn`` inside ``recon``; ``build_task`` opens
``setup.plans`` around each operator's construction and ``setup.opnorm``
around σ's power iteration.

Measurement synthesis, direct recons and the sino tasks' output operators
run in float32 even when the networks run in bfloat16: the simulated
measurement plays the role of physics, and synthesising it in bf16 would
bake ~1e-2 relative rounding into the data. σ, the operator norm used to
scale the unrolls' operators, comes from the unroll's own (bf16 when the
preset says so) sparse operators, as in JAX; the UNet tasks have none.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from pdunet_tpu_torch.configs import ExperimentConfig, GeometryConfig
from pdunet_tpu_torch.data.pipeline import (
    MU_WATER,
    interp_upsample_angles,
    interp_upsample_spokes,
    kspace_gaussian_noise,
    lowdose_poisson_noise,
    reverse_spoke_samples,
    subsample_angles,
)
from pdunet_tpu_torch.data.synth import random_phantom_batch
from pdunet_tpu_torch.geometry import FanGeometry, ParallelGeometry, RadialGeometry
from pdunet_tpu_torch.models.primal_dual import UnrolledPrimalDual, make_lpd, make_pdunet
from pdunet_tpu_torch.models.unet import UNet
from pdunet_tpu_torch.ops.losses import LOSSES
from pdunet_tpu_torch.ops.nufft import make_radial_ops
from pdunet_tpu_torch.ops.radon.fan import make_fan_ops
from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops
from pdunet_tpu_torch.utils.trace import span, traced

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
    #: adds "image_c"), {"image", "fbp"} (fbp_unet), {"image",
    #: "sino_dense", "sino_in"} (sino_unet) or {"image", "image_c",
    #: "k_dense_w", "k_in_w"} (radial sino_unet); the noise of a noisy
    #: preset is drawn from the same generator
    make_batch: Callable[[torch.Generator], dict]
    #: (model, batch) → (scalar loss, aux dict); aux holds sino_unet's
    #: "sino_loss" / "img_loss" (each only for a nonzero weight), else {}
    loss_fn: Callable[[Model, dict], tuple]
    #: (model, batch) → reconstruction (B, N, N), real
    recon_fn: Callable[[Model, dict], torch.Tensor]
    config: ExperimentConfig
    image_size: int
    #: (images (B, N, N), generator=None) → the same batch dict (radial:
    #: complex images or a (re, im) pair); noiseless without a generator
    batch_from_images: Callable[..., dict]
    #: the unroll operators' norm (pdunet, lpd); None for the UNet tasks,
    #: which run no power iteration
    sigma: Optional[float]


def build_geometries(gc: GeometryConfig):
    """Dense + sparse geometry pair for a config (parallel, fan or radial).
    Parallel angles span coverage·π, fan views coverage·2π."""
    if gc.kind == "radial":
        dense = RadialGeometry(
            image_size=gc.image_size,
            n_spokes=gc.n_angles,
            samples_per_spoke=gc.samples_per_spoke,
            pixel_spacing=gc.pixel_spacing,
        )
        return dense, dense.subsample(gc.sparsity)
    if gc.kind not in ("parallel", "fan"):
        raise NotImplementedError(f"geometry kind {gc.kind!r} not built yet")
    coverage = gc.angular_coverage
    span = coverage * math.pi if gc.kind == "parallel" else coverage * 2.0 * math.pi
    angles = tuple(span * k / gc.n_angles for k in range(gc.n_angles))
    common = dict(image_size=gc.image_size, det_count=gc.det_count,
                  det_spacing=gc.det_spacing, pixel_spacing=gc.pixel_spacing, angles=angles)
    if gc.kind == "fan":
        dense = FanGeometry(source_distance=gc.source_distance,
                            det_distance=gc.det_distance, **common)
    else:
        dense = ParallelGeometry(**common)
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


def _complex_phantoms(generator, B: int, N: int, tc, pixel_spacing: float, device):
    """(magnitude, complex image) of a radial MRI batch: a nonnegative
    ellipse phantom with a smooth random phase field, both drawn from
    ``generator``."""
    mag = random_phantom_batch(generator, B, N, n_ellipses=tc.n_ellipses,
                               pixel_spacing=pixel_spacing, nonneg=True, device=device)
    return mag, mag.to(torch.complex64) * torch.exp(1j * _phase_field(generator, B, N, device))


def _as_complex(img) -> torch.Tensor:
    """Complex images from a complex (or real) tensor or a (re, im) pair."""
    if isinstance(img, (tuple, list)):
        return torch.complex(img[0].float(), img[1].float())
    return img.to(torch.complex64)


def _ct_noise(generator, sino: torch.Tensor, photons: float) -> torch.Tensor:
    """Low-dose noise on a CT sinogram when ``photons > 0`` and a generator
    is given: phantom densities are O(1) per pixel, so the transmission
    model sees the line integrals scaled to attenuation units."""
    if photons <= 0 or generator is None:
        return sino
    return lowdose_poisson_noise(generator, sino * MU_WATER, photons) / MU_WATER


def build_task(config: ExperimentConfig, device="cuda", opnorm_x0=None, mesh=None) -> Task:
    """Build the task of ``config`` on ``device``: ``pdunet`` or ``lpd``
    (parallel- or fan-beam CT, radial MRI), ``fbp_unet`` (parallel- or
    fan-beam CT) or ``sino_unet`` (parallel-beam CT, radial MRI).

    The model's weights come from a CPU generator seeded with 0; use
    ``init_params`` or ``models.convert.flax_to_torch`` to replace them.
    ``opnorm_x0`` is the power iteration's start vector (see
    :func:`estimate_opnorm`; the UNet tasks run none).

    ``mesh``: every operator of the task is angle-sharded over the mesh's
    angle axis (``parallel/angle_shard.py``; parallel and fan beam, and
    radial MRI's fourier-slice path); every rank of the axis then calls them
    on the same batch. σ comes from an unsharded twin of the sparse
    operator, the same on every rank (the seeded start vector)."""
    gc, mc, tc = config.geometry, config.model, config.train
    if mc.kind not in ("pdunet", "lpd", "fbp_unet", "sino_unet"):
        raise NotImplementedError(f"model kind {mc.kind!r} is not ported yet")
    if mc.kind == "sino_unet" and gc.kind == "fan":
        # the angular re-expansion's wrap uses the parallel-beam symmetry
        # p(θ+π, s) = p(θ, −s), which fan sinograms do not have
        raise ValueError("sino_unet is not defined for fan geometry: the angular "
                         "upsampling wrap relies on parallel-beam detector-flip symmetry")
    if mc.kind == "fbp_unet" and gc.kind == "radial":
        raise NotImplementedError("fbp_unet is defined for CT (parallel or fan beam) only")
    loss = LOSSES[tc.loss]
    device = torch.device(device)
    dense_geom, sparse_geom = build_geometries(gc)
    is_complex = gc.kind == "radial"
    make_local_ops = {"radial": make_radial_ops, "fan": make_fan_ops}.get(gc.kind,
                                                                          make_parallel_ops)

    def make_ops(geom, mesh=mesh, **kw):
        with span("setup.plans"):
            return make_local_ops(geom, mesh=mesh, **kw)

    dtype = torch.bfloat16 if mc.use_bfloat16 else torch.float32
    N = gc.image_size
    B = tc.batch_size
    photons = tc.photons_per_ray

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

        return Task(config.name, model, init_params, make_batch, loss_fn,
                    traced("recon", recon_fn), config, N,
                    traced("synthesis", batch_from_images), sigma)

    if mc.kind in ("fbp_unet", "sino_unet"):
        channels = 2 if is_complex else 1  # radial: (Re, Im) in and out

        def new_unet(generator):
            return UNet(in_channels=channels, out_channels=channels,
                        base_features=mc.base_features, depth=mc.depth, stem=mc.stem,
                        dtype=dtype, upsample=mc.upsample, generator=generator,
                        device="cpu").to(device)

    if mc.kind == "fbp_unet":
        # the f32 sparse operators only: synthesis and the FBP the UNet cleans
        ops = make_ops(sparse_geom, dtype=torch.float32, device=device)

        def batch_from_images(img, generator=None):
            return {"image": img, "fbp": ops.fbp(_ct_noise(generator, ops.A(img), photons))}

        def make_batch(generator):
            return batch_from_images(phantoms(generator), generator)

        def recon_fn(model, batch):
            return batch["fbp"] + model(batch["fbp"][:, None])[:, 0]

        def loss_fn(model, batch):
            return loss(recon_fn(model, batch), batch["image"]), {}

        return finish(new_unet, make_batch, loss_fn, recon_fn, batch_from_images)

    if mc.kind == "sino_unet" and is_complex:
        return finish(new_unet, *_radial_sino_unet(tc, dense_geom, sparse_geom, loss, device,
                                                   make_ops, B, N))

    if mc.kind == "sino_unet":
        # the f32 dense operators only: synthesis, and the FBP of the output
        ops = make_ops(dense_geom, dtype=torch.float32, device=device)
        k = gc.sparsity
        # hard data consistency: dense row i was measured iff i % k == 0
        # (subsample_angles keeps every k-th row and interp_upsample_angles
        # passes those rows through exactly), so the prediction re-imposes
        # them and the UNet only fills the interpolated rows
        measured_rows = (torch.arange(dense_geom.n_angles, device=device) % k == 0)[:, None]

        def batch_from_images(img, generator=None):
            sino_dense = ops.A(img)
            sino_sparse = _ct_noise(generator, subsample_angles(sino_dense, k), photons)
            sino_in = interp_upsample_angles(sino_sparse, k, gc.angular_coverage)
            return {"image": img, "sino_dense": sino_dense, "sino_in": sino_in}

        def make_batch(generator):
            return batch_from_images(phantoms(generator), generator)

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
    # the power iteration runs on one image: on the unsharded twin when sharded
    ops_sigma = ops_sparse if mesh is None else make_ops(sparse_geom, dtype=dtype,
                                                          device=device, mesh=None)
    with span("setup.opnorm"):
        sigma = estimate_opnorm(ops_sigma.A, ops_sigma.At, (N, N), x0=opnorm_x0,
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
        def batch_from_images(img, generator=None):
            img_c = _as_complex(img)
            g = ops_synth.A(img_c)
            if generator is not None and tc.kspace_snr_db > 0:
                g = kspace_gaussian_noise(generator, g, tc.kspace_snr_db)
            return {"image": img_c.abs(), "image_c": img_c, "sino": g,
                    "f0": ops_synth.fbp(g)}

        def make_batch(generator):
            mag, img_c = _complex_phantoms(generator, B, N, tc, gc.pixel_spacing, device)
            return dict(batch_from_images(img_c, generator), image=mag)

        def predict_c(model, batch):
            # measurements scaled like A_n so the dual net sees O(1) inputs
            return model(batch["sino"] / sigma, batch["f0"])

        def recon_fn(model, batch):
            return predict_c(model, batch).abs()

        def loss_fn(model, batch):
            return loss(predict_c(model, batch), batch["image_c"]), {}
    else:
        def batch_from_images(img, generator=None):
            g = _ct_noise(generator, ops_synth.A(img), photons)
            return {"image": img, "sino": g, "f0": ops_synth.fbp(g)}

        def make_batch(generator):
            return batch_from_images(phantoms(generator), generator)

        def recon_fn(model, batch):
            return model(batch["sino"] / sigma, batch["f0"])

        def loss_fn(model, batch):
            return loss(recon_fn(model, batch), batch["image"]), {}

    return finish(new_model, make_batch, loss_fn, recon_fn, batch_from_images, sigma)


def _radial_sino_unet(tc, dense_geom, sparse_geom, loss, device, make_ops, B, N):
    """(make_batch, loss_fn, recon_fn, batch_from_images) of the radial
    ``sino_unet`` task: spoke-domain upsampling of golden-angle k-space.

    The UNet does not see raw k-space: golden-angle spokes are ~111° apart
    in sequence order, and k-space phase oscillates too fast along the
    readout for convolutions. Each spoke goes through a per-row
    orthonormal inverse FFT to its projection-domain twin (the central
    slice theorem), with the rows canonicalised mod π (θ ≥ π spokes
    sample-reversed) and sorted by angle: a smooth complex sinogram. The
    map is a static permutation, flip and ortho FFT, inverted exactly on
    the way out."""
    ops = make_ops(dense_geom, dtype=torch.float32, device=device)
    dense_angles, sparse_angles = dense_geom.spoke_angles, sparse_geom.spoke_angles
    A_s = sparse_geom.n_spokes
    phi = np.asarray(dense_angles) % (2.0 * np.pi)
    perm = np.argsort(phi % np.pi, kind="stable")
    flip_sorted = torch.as_tensor((phi >= np.pi)[perm], device=device)[:, None]
    perm_t = torch.as_tensor(perm, device=device)
    inv_perm_t = torch.as_tensor(np.argsort(perm, kind="stable"), device=device)
    # projection values grow ~linearly with the image size, so this static
    # scale keeps the net-domain inputs O(1) (unscaled, the first steps'
    # gradients inflate Adam's second moment and stall training)
    scale = 0.25 * N
    # hard data consistency: sorted row j is a measured spoke iff its index
    # in the dense sequence is in the golden-angle prefix, and
    # interp_upsample_spokes passes those spokes through exactly
    measured_rows = torch.as_tensor(perm < A_s, device=device)[:, None]

    def to_net_domain(k):
        s = k.index_select(-2, perm_t)
        s = torch.where(flip_sorted, reverse_spoke_samples(s), s)
        p = torch.fft.ifft(torch.fft.ifftshift(s, dim=-1), dim=-1, norm="ortho")
        return torch.fft.fftshift(p, dim=-1) / scale

    def from_net_domain(p):
        s = torch.fft.fft(torch.fft.ifftshift(p * scale, dim=-1), dim=-1, norm="ortho")
        s = torch.fft.fftshift(s, dim=-1)
        s = torch.where(flip_sorted, reverse_spoke_samples(s), s)
        return s.index_select(-2, inv_perm_t)

    def batch_from_complex(img_c, generator=None):
        g_dense = ops.A(img_c)
        # the golden-angle subsample keeps the spoke sequence's prefix; noise
        # hits only what the scanner acquired (the dense target stays clean)
        g_meas = g_dense[..., :A_s, :]
        if generator is not None and tc.kspace_snr_db > 0:
            g_meas = kspace_gaussian_noise(generator, g_meas, tc.kspace_snr_db)
        g_in = interp_upsample_spokes(g_meas, sparse_angles, dense_angles)
        return {"image": img_c.abs(), "image_c": img_c,
                "k_dense_w": to_net_domain(g_dense), "k_in_w": to_net_domain(g_in)}

    def batch_from_images(img, generator=None):
        return batch_from_complex(_as_complex(img), generator)

    def make_batch(generator):
        _, img_c = _complex_phantoms(generator, B, N, tc, dense_geom.pixel_spacing, device)
        return batch_from_complex(img_c, generator)

    def predict_kw(model, batch):
        x = batch["k_in_w"]
        out = model(torch.stack([x.real, x.imag], dim=1))
        return torch.where(measured_rows, x, x + torch.complex(out[:, 0], out[:, 1]))

    def recon_fn(model, batch):
        return ops.fbp(from_net_domain(predict_kw(model, batch))).abs()

    def loss_fn(model, batch):
        pred = predict_kw(model, batch)
        total, aux = 0.0, {}
        if tc.sino_loss_weight:
            aux["sino_loss"] = (pred - batch["k_dense_w"]).abs().mean()
            total = total + tc.sino_loss_weight * aux["sino_loss"]
        if tc.img_loss_weight:
            aux["img_loss"] = loss(ops.fbp(from_net_domain(pred)).abs(), batch["image"])
            total = total + tc.img_loss_weight * aux["img_loss"]
        return total, aux

    return make_batch, loss_fn, recon_fn, batch_from_images
