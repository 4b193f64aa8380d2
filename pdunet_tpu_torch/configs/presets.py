"""The five shipped experiment presets, mirroring BASELINE.json:6-12.

1. sino_unet_parallel — sinogram-domain UNet upsampling, sparse-view
   parallel-beam CT, 256² slices.
2. fbp_unet_parallel  — image-domain UNet post-processing of sparse-view FBP.
3. pdunet_parallel    — Primal-Dual UNet, parallel-beam sparse-view CT.
4. pdunet_fan         — Primal-Dual UNet, fan-beam low-dose + limited-angle.
5. pdunet_radial      — Primal-Dual UNet, golden-angle radial MRI (complex).

Plus the Learned Primal-Dual baseline (SURVEY.md §2b C6, the Adler-Öktem
method PD-UNet extends) on the parallel sparse-view geometry:
``lpd_parallel``.

A copy of ``pdunet_tpu/configs/presets.py``, kept so the PyTorch port
imports nothing from the JAX package. The quality and throughput figures in
the comments below were measured on the JAX package on a TPU; they explain
why each preset is shaped as it is and say nothing about the port's speed.
"""

from __future__ import annotations

from pdunet_tpu_torch.configs.base import (
    ExperimentConfig,
    GeometryConfig,
    ModelConfig,
    TrainConfig,
)


def sino_unet_parallel() -> ExperimentConfig:
    return ExperimentConfig(
        name="sino_unet_parallel",
        geometry=GeometryConfig(kind="parallel", image_size=256, n_angles=360, sparsity=4),
        # stem=2 after a measured full-scale A/B: patchify does slow tiny-
        # scale convergence (tiny-overfit ratio 0.81 vs 0.57), but at the
        # shipped scale with hard data consistency the trained quality is
        # identical (41.88/0.9533 stem=2 at 16k steps vs 41.93/0.9542
        # stem=1 — both above the dense-sinogram FBP ceiling of 41.45 dB)
        # while the sinogram UNet runs at a quarter of the pixels:
        # 944 -> 1163 slices/s/chip.
        model=ModelConfig(kind="sino_unet", base_features=64, depth=4, stem=2,
                          use_bfloat16=True),
        train=TrainConfig(sino_loss_weight=1.0, img_loss_weight=1.0,
                          grad_clip=0.5),
    )


def fbp_unet_parallel() -> ExperimentConfig:
    return ExperimentConfig(
        name="fbp_unet_parallel",
        geometry=GeometryConfig(kind="parallel", image_size=256, n_angles=360, sparsity=4),
        model=ModelConfig(kind="fbp_unet", base_features=64, depth=3, stem=2,
                          use_bfloat16=True),
        train=TrainConfig(grad_clip=2.0),
    )


def pdunet_parallel() -> ExperimentConfig:
    return ExperimentConfig(
        name="pdunet_parallel",
        geometry=GeometryConfig(kind="parallel", image_size=256, n_angles=360, sparsity=4),
        model=ModelConfig(kind="pdunet", base_features=32, depth=2, stem=2,
                          n_iters=4, use_bfloat16=True),
        # grad_clip on every preset: long cosine schedules keep LR high for
        # thousands of steps, and a single unclipped gradient spike strands
        # Adam in a worse basin (observed twice on this preset: 53.4->50.4 dB
        # at 24k-step budget, 50.5->39.5 dB at 28k). 2.0 is ~4x the healthy
        # p99 grad norm (0.48) — inactive in normal training, caps spikes.
        train=TrainConfig(batch_size=4, grad_clip=2.0),
    )


def pdunet_fan() -> ExperimentConfig:
    return ExperimentConfig(
        name="pdunet_fan",
        geometry=GeometryConfig(
            kind="fan",
            image_size=256,
            n_angles=360,
            sparsity=4,
            angular_coverage=0.75,       # limited-angle variant
        ),
        model=ModelConfig(kind="pdunet", base_features=32, depth=2, stem=2,
                          n_iters=4, use_bfloat16=True),
        train=TrainConfig(batch_size=4, photons_per_ray=1e5,  # low-dose noise
                          grad_clip=2.0),
    )


def pdunet_radial() -> ExperimentConfig:
    return ExperimentConfig(
        name="pdunet_radial",
        geometry=GeometryConfig(kind="radial", image_size=256, n_angles=512, sparsity=4),
        model=ModelConfig(kind="pdunet", base_features=32, depth=2, stem=2,
                          n_iters=4, use_bfloat16=True),
        train=TrainConfig(batch_size=4, grad_clip=2.0),
    )


def sino_unet_radial() -> ExperimentConfig:
    return ExperimentConfig(
        name="sino_unet_radial",
        # spoke-domain upsampling (the paper's sinogram-upsampling method
        # applied to its radial-MRI modality): complex golden-angle spokes,
        # UNet on the (spoke x sample, Re/Im) grid. stem=2 after a measured
        # A/B: patch-mixing spokes was feared to hurt (see
        # sino_unet_parallel) but costs only 0.7 dB here (47.21/0.9696
        # stem=1 at 34k steps vs 46.54/0.9603 stem=2 at 20k, 64 test
        # slices) while the 512x512 UNet — 65% of recon time — runs at a
        # quarter of the pixels: 195 -> 258 slices/s/chip. Ceiling honesty:
        # against the *shipped* dense-spoke recon operator (Pipe-Menon DCF
        # adjoint, measured dense-data ceiling ~49.3 dB — README), stem-1
        # is 2.1 dB below and stem-2 2.8 dB below, i.e. NOT saturated;
        # only the older Voronoi-DCF ceiling (~46.1 dB) is exceeded.
        # stem-2 also had the shorter budget (20k vs 34k steps), so the
        # throughput-optimized shipped config trades known headroom for
        # speed.
        geometry=GeometryConfig(kind="radial", image_size=256, n_angles=512, sparsity=4),
        model=ModelConfig(kind="sino_unet", base_features=64, depth=4, stem=2,
                          use_bfloat16=True),
        # grad_clip: the 14k-step cosine keeps LR high long enough that a
        # single gradient spike can strand Adam (observed: val -1.4 dB at
        # ~step 4.5k, then frozen); 0.5 is ~5-10x the healthy grad norm
        train=TrainConfig(batch_size=4, sino_loss_weight=1.0,
                          img_loss_weight=1.0, grad_clip=0.5),
    )


def lpd_parallel() -> ExperimentConfig:
    return ExperimentConfig(
        name="lpd_parallel",
        geometry=GeometryConfig(kind="parallel", image_size=256, n_angles=360, sparsity=4),
        # Adler-Öktem 2018 defaults: 10 unrolled PDHG iterations, small
        # 32-filter primal/dual conv nets, 5-channel memory
        model=ModelConfig(kind="lpd", n_iters=10, lpd_features=32,
                          primal_channels=5, dual_channels=5,
                          use_bfloat16=True),
        # 4.0 ~ 4x this preset's healthy p99 grad norm (1.07 — the LPD
        # conv nets run hotter than the UNet presets)
        train=TrainConfig(batch_size=4, grad_clip=4.0),
    )


PRESETS = {
    "sino_unet_parallel": sino_unet_parallel,
    "fbp_unet_parallel": fbp_unet_parallel,
    "pdunet_parallel": pdunet_parallel,
    "pdunet_fan": pdunet_fan,
    "pdunet_radial": pdunet_radial,
    "sino_unet_radial": sino_unet_radial,
    "lpd_parallel": lpd_parallel,
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()
