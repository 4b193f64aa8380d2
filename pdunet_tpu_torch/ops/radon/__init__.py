from pdunet_tpu_torch.ops.radon.filtering import filter_sinogram, ramp_kernel
from pdunet_tpu_torch.ops.radon.parallel import (
    RadonOps,
    make_parallel_ops,
    parallel_backproject,
    parallel_project,
)

__all__ = [
    "RadonOps",
    "filter_sinogram",
    "make_parallel_ops",
    "parallel_backproject",
    "parallel_project",
    "ramp_kernel",
]
