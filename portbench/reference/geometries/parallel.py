"""The reference operators of a ``parallel`` geometry: the factored
parallel-beam projector over the configuration's sparse angles."""

from portbench.reference.radon import ParallelRef, sparse_angles


def build(g: dict, device) -> ParallelRef:
    return ParallelRef(g["image_size"],
                       sparse_angles(g["n_angles"], g["sparsity"], g["angular_coverage"]),
                       device, g["det_count"], g["det_spacing"], g["pixel_spacing"])
