"""Unified dataclass config tree (SURVEY.md §5.6).

The reference scattered geometry/model/training constants across per-branch
argparse scripts; here one config tree drives everything, with the five
shipped presets mirroring BASELINE.json:6-12.
"""

from pdunet_tpu_torch.configs.base import (
    ExperimentConfig,
    GeometryConfig,
    ModelConfig,
    TrainConfig,
)
from pdunet_tpu_torch.configs.presets import PRESETS, get_preset

__all__ = [
    "ExperimentConfig",
    "GeometryConfig",
    "ModelConfig",
    "TrainConfig",
    "PRESETS",
    "get_preset",
]
