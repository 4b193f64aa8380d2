"""Config dataclasses.

Frozen + hashable so configs can be dict keys. Serializable to/from JSON,
with dotted-key overrides (``override``) for the CLI's ``--set``.

A copy of ``pdunet_tpu/configs/base.py``, kept so the PyTorch port imports
nothing from the JAX package; the two must describe the same presets.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    kind: str = "parallel"          # parallel | fan | radial
    image_size: int = 256
    n_angles: int = 360             # dense angle count (spokes for radial)
    det_count: int = 0              # 0 → operator default
    sparsity: int = 4               # angular undersampling factor
    det_spacing: float = 1.0
    pixel_spacing: float = 1.0
    # fan-beam extras
    source_distance: float = 0.0
    det_distance: float = 0.0
    # limited-angle: fraction of the full angular range actually scanned
    angular_coverage: float = 1.0
    # radial extras
    samples_per_spoke: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    kind: str = "fbp_unet"          # sino_unet | fbp_unet | lpd | pdunet
    base_features: int = 64
    depth: int = 4
    stem: int = 1                   # UNet space-to-depth patch (TPU: use 2)
    n_iters: int = 4                # unroll length (lpd/pdunet)
    lpd_features: int = 32          # conv features of the small LPD nets
    primal_channels: int = 5        # LPD primal/dual memory
    dual_channels: int = 5
    use_bfloat16: bool = False
    # decoder 2x upsampling: "convtranspose" (classic) or "shuffle"
    # (1x1-conv + depth_to_space — same linear family / param count, lowers
    # to a plain MXU matmul instead of an input-dilated conv; see
    # models/unet.py). Checkpoints are not interchangeable across the two.
    upsample: str = "convtranspose"
    # rematerialize the unroll body in backward: ~30% slower train steps
    # but O(1)-in-n_iters activation memory. The shipped 256² presets fit
    # comfortably without it; enable for beyond-HBM geometries/batches.
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    learning_rate: float = 1e-3
    steps: int = 20000
    warmup_steps: int = 200
    seed: int = 0
    loss: str = "l1"
    # >0: clip gradients to this global norm before Adam. 0 keeps the plain
    # Adam tree (checkpoint-compatible with runs trained before this field).
    # Guards the long-cosine runs: a single spike mid-run (observed on
    # sino_unet_radial at ~step 4.5k/14k: val -1.4 dB, then frozen — the
    # spike inflates Adam's v and strands the params) permanently costs
    # quality; healthy grad norms here are ~0.05-0.1 so 0.5 never binds.
    grad_clip: float = 0.0
    sino_loss_weight: float = 1.0   # sinogram-domain L1 (sino_unet task)
    img_loss_weight: float = 1.0    # image-domain loss through FBP
    log_every: int = 100
    eval_every: int = 1000
    # held-out slices scored per validation pass (rounded up to whole
    # batches). Best-ckpt selection over a single 4-slice batch is noisy
    # relative to the ±1.5 dB per-slice spread; ≥32 stabilizes it.
    val_slices: int = 32
    ckpt_every: int = 1000
    max_checkpoints: int = 3
    ckpt_dir: str = ""              # "" → no checkpointing
    # data
    n_ellipses: int = 8
    photons_per_ray: float = 0.0    # >0 → low-dose Poisson noise on sinograms
    # >0 → complex Gaussian k-space measurement noise at this SNR (dB,
    # power ratio vs the measured spokes' RMS) for the radial MRI tasks —
    # the MRI analogue of photons_per_ray (SURVEY.md §2b C4)
    kspace_snr_db: float = 0.0
    # parallelism
    data_axis: str = "data"         # mesh axis for batch sharding


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "experiment"
    geometry: GeometryConfig = dataclasses.field(default_factory=GeometryConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        return cls(
            name=raw.get("name", "experiment"),
            geometry=GeometryConfig(**raw.get("geometry", {})),
            model=ModelConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
        )

    def override(self, dotted: dict) -> "ExperimentConfig":
        """Apply {'train.learning_rate': 3e-4, ...} style overrides."""
        cfg = self
        for key, value in dotted.items():
            parts = key.split(".")
            if len(parts) == 1:
                cfg = dataclasses.replace(cfg, **{parts[0]: value})
            elif len(parts) == 2:
                section = getattr(cfg, parts[0])
                fields = {f.name: f.type for f in dataclasses.fields(section)}
                if parts[1] not in fields:
                    raise KeyError(
                        f"unknown config field {key!r}; {parts[0]} has: "
                        f"{sorted(fields)}"
                    )
                field_type = fields[parts[1]]
                if isinstance(value, str):
                    if "int" in str(field_type):
                        value = int(value)
                    elif "float" in str(field_type):
                        value = float(value)
                    elif "bool" in str(field_type):
                        value = value.lower() in ("1", "true", "yes")
                cfg = dataclasses.replace(
                    cfg, **{parts[0]: dataclasses.replace(section, **{parts[1]: value})}
                )
            else:
                raise ValueError(f"bad override key {key!r}")
        return cfg
