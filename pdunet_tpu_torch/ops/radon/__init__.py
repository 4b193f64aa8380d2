from pdunet_tpu_torch.ops.radon.fan import (
    FanPlan,
    build_fan_plan,
    fan_backproject,
    fan_project,
    fan_rebin_to_parallel,
    make_fan_ops,
)
from pdunet_tpu_torch.ops.radon.filtering import filter_sinogram, ramp_kernel
from pdunet_tpu_torch.ops.radon.parallel import (
    RadonOps,
    make_parallel_ops,
    parallel_backproject,
    parallel_project,
)

__all__ = [
    "FanPlan",
    "RadonOps",
    "build_fan_plan",
    "fan_backproject",
    "fan_project",
    "fan_rebin_to_parallel",
    "make_fan_ops",
    "filter_sinogram",
    "make_parallel_ops",
    "parallel_backproject",
    "parallel_project",
    "ramp_kernel",
]
