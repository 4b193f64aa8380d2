"""Sinogram and k-space transforms, noise models and HU windowing (port
of ``pdunet_tpu/data/pipeline.py``).

``subsample_angles`` keeps every k-th angle of a dense sinogram;
``interp_upsample_angles`` re-expands the sparse one linearly to the dense
angle grid, the network input of the sinogram-upsampling task;
``reverse_spoke_samples`` and ``interp_upsample_spokes`` are the radial-MRI
analogues on golden-angle k-space spokes. ``lowdose_poisson_noise`` (CT
photon counting) and ``kspace_gaussian_noise`` (MRI receiver noise) draw a
standard normal from a ``torch.Generator`` on the data's device; each is a
function of that draw, which a caller may pass as ``normal`` instead.
``mu_to_hu`` / ``hu_to_mu`` convert attenuation to Hounsfield units and back,
and ``normalize_ct_window`` clips a HU image into a display window. All are
plain tensor functions on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MU_WATER", "subsample_angles", "interp_upsample_angles", "reverse_spoke_samples",
           "interp_upsample_spokes", "lowdose_poisson_noise", "kspace_gaussian_noise",
           "mu_to_hu", "hu_to_mu", "normalize_ct_window"]

MU_WATER = 0.02  # 1/mm, the attenuation of water at about 70 keV


def subsample_angles(sino: torch.Tensor, factor: int) -> torch.Tensor:
    """Keep every ``factor``-th angle: (..., A, S) → (..., A//factor, S)."""
    return sino[..., ::factor, :]


def interp_upsample_angles(sparse: torch.Tensor, factor: int,
                           angular_coverage: float = 1.0) -> torch.Tensor:
    """Linear re-expansion of a sparse sinogram to the dense angle grid.

    Dense angle ``i`` sits at fractional sparse index ``i / factor`` and is
    interpolated between its two measured neighbours. For a full scan
    (``angular_coverage >= 1``) the last segment wraps to angle 0 with the
    detector axis flipped, p(θ+π, s) = p(θ, −s) (parallel-beam symmetry);
    for a limited-angle scan it clamps to the last measured angle instead.
    (..., A_sp, S) → (..., A_sp·factor, S)."""
    A_sp = sparse.shape[-2]
    dev = sparse.device
    pos = torch.arange(A_sp * factor, device=dev, dtype=torch.float32) / factor
    lo = torch.floor(pos).to(torch.int64)
    w = (pos - lo)[:, None]
    hi = lo + 1
    past_end = hi >= A_sp
    hi_c = torch.where(past_end, 0 if angular_coverage >= 1.0 else A_sp - 1, hi)
    lo_v = sparse.index_select(-2, lo)
    hi_v = sparse.index_select(-2, hi_c)
    if angular_coverage >= 1.0:
        hi_v = torch.where(past_end[:, None], hi_v.flip(-1), hi_v)
    return (1.0 - w) * lo_v + w * hi_v


def reverse_spoke_samples(spokes: torch.Tensor) -> torch.Tensor:
    """Map each spoke's samples r → −r on the half-open readout grid
    [−k_max, k_max): ``out[i] = in[(S − i) % S]``, the sample order of the
    same diameter traversed at θ + π (the lone −k_max sample maps to
    itself)."""
    return torch.roll(torch.flip(spokes, dims=(-1,)), 1, dims=-1)


def interp_upsample_spokes(sparse: torch.Tensor, sparse_angles: tuple,
                           dense_angles: tuple) -> torch.Tensor:
    """Angular interpolation of radial k-space spokes onto a denser spoke
    set, the radial analogue of :func:`interp_upsample_angles`.

    Golden-angle undersampling keeps a prefix of the spoke sequence, so the
    missing spokes interleave the kept ones in angle. Each target spoke is
    the angular-linear blend of its two bracketing source spokes, angles
    reduced mod π, where a spoke at θ + π is the sample-reversed spoke at θ;
    a neighbour reached across the π boundary adds one more reversal.
    Source spokes whose angle matches a target exactly (the shared prefix)
    pass through unchanged. Indices, weights and flips come from the angle
    tuples on the host. (..., A_s, S) complex → (..., A_d, S)."""
    phi_s = np.asarray(sparse_angles) % (2.0 * np.pi)
    phi_d = np.asarray(dense_angles) % (2.0 * np.pi)
    flip_s = phi_s >= np.pi
    flip_d = phi_d >= np.pi
    red_s = phi_s % np.pi
    red_d = phi_d % np.pi

    order = np.argsort(red_s, kind="stable")
    grid = red_s[order]
    n_s = len(grid)
    pos = np.searchsorted(grid, red_d)            # right neighbour position
    left = (pos - 1) % n_s
    right = pos % n_s
    phi_l = grid[left] - np.where(pos == 0, np.pi, 0.0)      # wrap below
    phi_r = grid[right] + np.where(pos == n_s, np.pi, 0.0)   # wrap above
    span = np.maximum(phi_r - phi_l, 1e-12)
    t = np.clip((red_d - phi_l) / span, 0.0, 1.0)
    exact_r = np.isclose(red_d, grid[right] % np.pi, atol=1e-9)
    t = np.where(exact_r, 1.0, t)
    idx_l = order[left]
    idx_r = order[right]
    need_flip_l = flip_s[idx_l] ^ flip_d ^ (pos == 0)
    need_flip_r = flip_s[idx_r] ^ flip_d ^ (pos == n_s)

    dev = sparse.device
    rev = reverse_spoke_samples(sparse)

    def pick(idx, flips):
        i = torch.as_tensor(idx, device=dev)
        return torch.where(torch.as_tensor(flips, device=dev)[:, None],
                           rev.index_select(-2, i), sparse.index_select(-2, i))

    w_r = torch.as_tensor(t, dtype=torch.float32, device=dev)[:, None]
    return (1.0 - w_r) * pick(idx_l, need_flip_l) + w_r * pick(idx_r, need_flip_r)


def lowdose_poisson_noise(generator, sino: torch.Tensor, photons_per_ray: float = 1e5,
                          normal: torch.Tensor = None) -> torch.Tensor:
    """Low-dose CT transmission noise: I = Poisson(I0·e^{−p}) in its Gaussian
    approximation (valid for counts ≳ 20), returned as −log(I/I0).
    ``normal``, a standard normal draw of ``sino``'s shape, defaults to one
    from ``generator``."""
    if normal is None:
        normal = torch.randn(sino.shape, generator=generator, device=sino.device,
                             dtype=sino.dtype)
    i_expected = photons_per_ray * torch.exp(-sino)
    i_noisy = torch.clamp(i_expected + normal * torch.sqrt(i_expected), min=1.0)
    return -torch.log(i_noisy / photons_per_ray)


def kspace_gaussian_noise(generator, kspace: torch.Tensor, snr_db: float,
                          normal: torch.Tensor = None) -> torch.Tensor:
    """Circularly symmetric complex Gaussian noise on k-space (..., A, S):
    E|n|² = RMS(|g|)²·10^(−snr_db/10) per slice, the power of the measured
    spokes over the noise's. ``snr_db <= 0`` leaves the data as it is.
    ``normal``, a complex standard normal draw (variance ½ per component,
    as ``torch.randn`` gives for complex64), defaults to one from
    ``generator``."""
    if snr_db <= 0:
        return kspace
    power = torch.mean(kspace.abs() ** 2, dim=(-2, -1), keepdim=True)
    sigma = torch.sqrt(power) * (10.0 ** (-snr_db / 20.0))
    if normal is None:
        normal = torch.randn(kspace.shape, generator=generator, device=kspace.device,
                             dtype=kspace.dtype)
    return kspace + sigma.to(kspace.dtype) * normal


def mu_to_hu(mu: torch.Tensor, mu_water: float = MU_WATER) -> torch.Tensor:
    """Attenuation (1/mm) → Hounsfield units: water 0, air −1000."""
    return 1000.0 * (mu - mu_water) / mu_water


def hu_to_mu(hu: torch.Tensor, mu_water: float = MU_WATER) -> torch.Tensor:
    """Hounsfield units → attenuation (1/mm), the inverse of :func:`mu_to_hu`."""
    return mu_water * (1.0 + hu / 1000.0)


def normalize_ct_window(img: torch.Tensor, center: float = 0.0,
                        width: float = 2000.0) -> torch.Tensor:
    """Window a HU image into [0, 1]: (img − (center − width/2)) / width, clipped."""
    lo = center - width / 2.0
    return torch.clamp((img - lo) / width, 0.0, 1.0)
