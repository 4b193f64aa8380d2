"""The reference operators of a ``radial`` geometry: n_angles ÷ sparsity
golden-angle spokes (complex k-space), with the Pipe-Menon DCF adjoint as
the direct reconstruction."""

from portbench.reference.radial import RadialRef


def build(g: dict, device) -> RadialRef:
    return RadialRef(g["image_size"], g["n_angles"] // g["sparsity"],
                     g["samples_per_spoke"] or 2 * g["image_size"], device, g["pixel_spacing"])
