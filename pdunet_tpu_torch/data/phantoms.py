"""Analytic ellipse phantoms, their closed-form parallel-beam sinograms,
and the out-of-distribution phantom families (a copy of the numpy module
``pdunet_tpu/data/phantoms.py``, kept so the port imports nothing from the
JAX package; the two give the same arrays for the same generator).

For an ellipse with semi-axes (a, b), center (x0, y0), rotation φ, density ρ:

    p(θ, s) = 2ρab·sqrt(α² - t²)/α²   for |t| < α,  else 0,
    α²(θ) = a²cos²(θ-φ) + b²sin²(θ-φ),  t = s - x0·cosθ - y0·sinθ.

Coordinates: x to the right (array column i), y along array row j; all
lengths in the same units as geometry spacings.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SHEPP_LOGAN",
    "shepp_logan_ellipses",
    "random_ellipses",
    "rasterize_ellipses",
    "analytic_parallel_sinogram",
    "random_rectangles",
    "rasterize_rectangles",
    "smooth_background",
    "textured_phantom",
    "ood_phantom",
    "OOD_KINDS",
]

# (density ρ, a, b, x0, y0, φ[rad]) in a [-1, 1]² box — the standard
# "modified" (high-contrast) Shepp-Logan parameterization.
SHEPP_LOGAN = np.array(
    [
        [1.00, 0.6900, 0.9200, 0.00, 0.0000, 0.0],
        [-0.80, 0.6624, 0.8740, 0.00, -0.0184, 0.0],
        [-0.20, 0.1100, 0.3100, 0.22, 0.0000, -np.deg2rad(18.0)],
        [-0.20, 0.1600, 0.4100, -0.22, 0.0000, np.deg2rad(18.0)],
        [0.10, 0.2100, 0.2500, 0.00, 0.3500, 0.0],
        [0.10, 0.0460, 0.0460, 0.00, 0.1000, 0.0],
        [0.10, 0.0460, 0.0460, 0.00, -0.1000, 0.0],
        [0.10, 0.0460, 0.0230, -0.08, -0.6050, 0.0],
        [0.10, 0.0230, 0.0230, 0.00, -0.6060, 0.0],
        [0.10, 0.0230, 0.0460, 0.06, -0.6050, 0.0],
    ]
)


def shepp_logan_ellipses(radius: float) -> np.ndarray:
    """Shepp-Logan ellipse table scaled so the unit box maps to ``radius``."""
    e = SHEPP_LOGAN.copy()
    e[:, 1:5] *= radius
    return e


def random_ellipses(
    rng: np.random.Generator, n: int, radius: float, min_axis_frac: float = 0.05,
    nonneg: bool = False,
) -> np.ndarray:
    """Random ellipse phantom parameters inside a disk of ``radius``.

    ``nonneg=True``: intensities in [0.1, 1] (MRI magnitude regime; see
    data/synth.py sample_ellipse_params)."""
    rho = rng.uniform(0.1 if nonneg else -1.0, 1.0, n)
    a = rng.uniform(min_axis_frac, 0.5, n) * radius
    b = rng.uniform(min_axis_frac, 0.5, n) * radius
    r0 = rng.uniform(0.0, 0.6, n) * radius
    ang = rng.uniform(0.0, 2 * np.pi, n)
    x0, y0 = r0 * np.cos(ang), r0 * np.sin(ang)
    phi = rng.uniform(0.0, np.pi, n)
    return np.stack([rho, a, b, x0, y0, phi], axis=1)


def rasterize_ellipses(
    ellipses: np.ndarray,
    image_size: int,
    pixel_spacing: float = 1.0,
    supersample: int = 4,
) -> np.ndarray:
    """Rasterize a sum of ellipses to (N, N) float32, anti-aliased.

    ``supersample``× subpixel sampling keeps edge error ~O(1/ss²), small
    enough that the analytic-sinogram comparison tolerance is dominated by
    the projector's own footprint model.
    """
    N, ss = image_size, supersample
    coords = (np.arange(N * ss) + 0.5) / ss - 0.5  # fine-grid pixel coords
    c = (N - 1) / 2.0
    xy = (coords - c) * pixel_spacing
    X, Y = np.meshgrid(xy, xy)  # X: column → x, Y: row → y
    img = np.zeros_like(X)
    for rho, a, b, x0, y0, phi in ellipses:
        cp, sp = np.cos(phi), np.sin(phi)
        xr = (X - x0) * cp + (Y - y0) * sp
        yr = -(X - x0) * sp + (Y - y0) * cp
        img += rho * ((xr / a) ** 2 + (yr / b) ** 2 <= 1.0)
    img = img.reshape(N, ss, N, ss).mean(axis=(1, 3))
    return img.astype(np.float32)


def analytic_parallel_sinogram(
    ellipses: np.ndarray,
    angles: np.ndarray,
    det_count: int,
    det_spacing: float = 1.0,
) -> np.ndarray:
    """Closed-form parallel-beam sinogram (A, S) of a sum of ellipses."""
    angles = np.asarray(angles, np.float64)
    s = (np.arange(det_count) - (det_count - 1) / 2.0) * det_spacing
    sino = np.zeros((angles.size, det_count))
    for rho, a, b, x0, y0, phi in ellipses:
        th = angles[:, None] - phi
        alpha2 = (a * np.cos(th)) ** 2 + (b * np.sin(th)) ** 2
        t = s[None, :] - x0 * np.cos(angles[:, None]) - y0 * np.sin(angles[:, None])
        under = alpha2 - t**2
        sino += np.where(under > 0, 2.0 * rho * a * b * np.sqrt(np.maximum(under, 0)) / alpha2, 0.0)
    return sino.astype(np.float32)


# Out-of-distribution phantom families. Training data is sums of ≤ 8
# hard-edged ellipses; these hold what that distribution cannot produce:
# sharp corners (rectangles), smooth low-frequency backgrounds and
# band-limited texture, so scoring trained weights on them measures
# generalisation. All are host-side numpy, in the training images'
# intensity regime (CT: signed, peak ~1; MRI: nonnegative).


def random_rectangles(
    rng: np.random.Generator, n: int, radius: float, nonneg: bool = False
) -> np.ndarray:
    """Random rotated-rectangle params (n, 6): [rho, hw, hh, x0, y0, phi].

    Corners are the OOD feature: no sum of ellipses has one."""
    rho = rng.uniform(0.1 if nonneg else -1.0, 1.0, n)
    hw = rng.uniform(0.08, 0.45, n) * radius
    hh = rng.uniform(0.08, 0.45, n) * radius
    r0 = rng.uniform(0.0, 0.6, n) * radius
    ang = rng.uniform(0.0, 2 * np.pi, n)
    phi = rng.uniform(0.0, np.pi, n)
    return np.stack(
        [rho, hw, hh, r0 * np.cos(ang), r0 * np.sin(ang), phi], axis=1
    )


def rasterize_rectangles(
    rects: np.ndarray,
    image_size: int,
    pixel_spacing: float = 1.0,
    supersample: int = 4,
) -> np.ndarray:
    """Rasterize rotated rectangles, anti-aliased like rasterize_ellipses."""
    N, ss = image_size, supersample
    coords = (np.arange(N * ss) + 0.5) / ss - 0.5
    c = (N - 1) / 2.0
    xy = (coords - c) * pixel_spacing
    X, Y = np.meshgrid(xy, xy)
    img = np.zeros_like(X)
    for rho, hw, hh, x0, y0, phi in rects:
        cp, sp = np.cos(phi), np.sin(phi)
        xr = (X - x0) * cp + (Y - y0) * sp
        yr = -(X - x0) * sp + (Y - y0) * cp
        img += rho * ((np.abs(xr) <= hw) & (np.abs(yr) <= hh))
    img = img.reshape(N, ss, N, ss).mean(axis=(1, 3))
    return img.astype(np.float32)


def smooth_background(
    rng: np.random.Generator, image_size: int, n_modes: int = 6,
    nonneg: bool = False,
) -> np.ndarray:
    """Smooth low-frequency field inside the scan disk.

    Random low-order cosine modes — nothing piecewise-constant, no edges at
    all except the disk support boundary."""
    N = image_size
    ax = np.linspace(-1.0, 1.0, N)
    X, Y = np.meshgrid(ax, ax)
    img = np.zeros((N, N))
    for _ in range(n_modes):
        kx, ky = rng.uniform(-2.0, 2.0, 2) * np.pi
        phase = rng.uniform(0.0, 2 * np.pi)
        img += rng.uniform(-1.0, 1.0) * np.cos(kx * X + ky * Y + phase)
    img /= max(np.abs(img).max(), 1e-6)
    if nonneg:
        img = 0.1 + 0.45 * (img + 1.0)
    disk = (X**2 + Y**2) <= 0.81  # same 0.9-radius support as training
    return (img * disk).astype(np.float32)


def textured_phantom(
    rng: np.random.Generator, image_size: int, n_ellipses: int = 4,
    nonneg: bool = False, texture_amp: float = 0.3,
) -> np.ndarray:
    """Ellipse phantom with band-limited texture inside its support.

    Training tissue is perfectly flat inside each ellipse; real anatomy is
    not. Texture = white noise low-passed with a Gaussian spectral window
    (σ at ~1/8 Nyquist), modulated by the phantom support."""
    N = image_size
    base = rasterize_ellipses(
        random_ellipses(rng, n_ellipses, 0.45 * N, nonneg=nonneg), N
    )
    noise = rng.standard_normal((N, N))
    f = np.fft.fftfreq(N)
    FX, FY = np.meshgrid(f, f)
    lp = np.exp(-((FX**2 + FY**2) / (2 * (1.0 / 16) ** 2)))
    tex = np.real(np.fft.ifft2(np.fft.fft2(noise) * lp))
    tex /= max(np.abs(tex).max(), 1e-6)
    support = np.abs(base) > 1e-3
    img = base + texture_amp * tex * support
    if nonneg:
        # MRI magnitude convention: additive texture may undershoot a
        # low-density ellipse; magnitudes cannot be negative
        img = np.maximum(img, 0.0)
    return img.astype(np.float32)


OOD_KINDS = ("shepp_logan", "rectangles", "smooth", "textured")


def ood_phantom(
    kind: str, rng: np.random.Generator, image_size: int, nonneg: bool = False
) -> np.ndarray:
    """One (N, N) slice of the named OOD family."""
    if kind == "shepp_logan":
        img = rasterize_ellipses(
            shepp_logan_ellipses(0.45 * image_size), image_size
        )
        # per-slice random contrast/flip so a "dataset" of them isn't one
        # constant image (keeps PSNR statistics meaningful)
        img = img * rng.uniform(0.7, 1.0)
        if rng.uniform() < 0.5:
            img = img[:, ::-1].copy()
        return img.astype(np.float32)
    if kind == "rectangles":
        return rasterize_rectangles(
            random_rectangles(rng, 6, 0.45 * image_size, nonneg=nonneg),
            image_size,
        )
    if kind == "smooth":
        return smooth_background(rng, image_size, nonneg=nonneg)
    if kind == "textured":
        return textured_phantom(rng, image_size, nonneg=nonneg)
    raise ValueError(f"unknown OOD kind {kind!r}; options: {OOD_KINDS}")
