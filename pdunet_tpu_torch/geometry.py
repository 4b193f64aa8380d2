"""Parallel-beam geometry and the factored-projector plan (port of
``pdunet_tpu/geometry.py``; the derivation lives there).

The projector is factored at plan-build time into compact per-angle rows:

  stage 1 (splat):  ĝ[a, j, k] = Σ_i f[j, i] · T̂_a[i, k],
                    T̂_a[i, k] = spec[k] · e^{−2πik·pos_a[i]/L}
  stage 2 (shear):  Ŝ[a, k] = Σ_j ĝ[a, j, k] · e^{+2πik·shift_a[j]/L}
  stage 3 (iDFT):   p[a, s] = Σ_k Re(Ŝ[a, k]) Wc[k, s] − Im(Ŝ[a, k]) Ws[k, s]

All plan math runs in float64 numpy and is identical to the JAX package's
(the tests compare the arrays and ``meta`` exactly); only the final arrays
become float32 tensors on the requested device. The big (A, N, K) spectral
tensors are never stored: the kernels generate them from these rows.

Mirror pairs: two angles whose primary direction cosines satisfy
prim_b = ±prim_a share stage 1 (member b reuses ĝ conjugated when the sign
is −1, with the constant C = 2(M + c_s) folded into its shift row ``shb``).
A uniform [0, π) scan pairs θ with π − θ, so ``meta["use_pairs"]`` is true
and A/A† run through the mirror-pair kernels; an angle set that does not
pair (golden-angle spokes) runs through the per-angle kernels. A fan
scan's backing plan spans angles beyond [0, π) (negative ones too) and
pairs θ with −θ or 2π − θ as well (sign +1: member b reuses ĝ as it is).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["GOLDEN_ANGLE", "FanGeometry", "ParallelGeometry", "ParallelPlan",
           "RadialGeometry", "build_parallel_plan"]


def _uniform_angles(n_angles: int, angle_range: float, start: float) -> Tuple[float, ...]:
    return tuple(start + angle_range * k / n_angles for k in range(n_angles))


@dataclasses.dataclass(frozen=True)
class ParallelGeometry:
    """Parallel-beam CT geometry.

    A ray at angle ``theta`` and signed detector coordinate ``s`` is the set
    ``{(x, y) : x cosθ + y sinθ = s}``. Angles default to ``n_angles``
    uniformly spaced over [0, π); ``angles`` overrides for sparse-view or
    limited-angle subsets.
    """

    image_size: int
    n_angles: int = 0
    det_count: int = 0          # 0 → image_size
    det_spacing: float = 1.0
    pixel_spacing: float = 1.0
    angles: Tuple[float, ...] = ()

    def __post_init__(self):
        if not self.angles:
            if self.n_angles <= 0:
                raise ValueError("need n_angles > 0 or explicit angles")
            object.__setattr__(
                self, "angles", _uniform_angles(self.n_angles, math.pi, 0.0)
            )
        object.__setattr__(self, "n_angles", len(self.angles))
        if self.det_count <= 0:
            object.__setattr__(self, "det_count", self.image_size)

    def subsample(self, factor: int) -> "ParallelGeometry":
        """Sparse-view geometry keeping every ``factor``-th angle."""
        return dataclasses.replace(self, angles=self.angles[::factor], n_angles=0)


@dataclasses.dataclass(frozen=True)
class FanGeometry:
    """Fan-beam CT geometry with a flat detector.

    ``source_distance`` is source → isocentre, ``det_distance`` isocentre →
    detector. Angles default to ``n_angles`` uniformly spaced over [0, 2π);
    ``angles`` overrides for sparse-view or limited-angle scans. The fan
    operators (``ops/radon/fan.py``) rebin onto a parallel plan over an
    extended angle grid, so its backing angles may lie outside [0, π).
    """

    image_size: int
    n_angles: int = 0
    source_distance: float = 0.0   # 0 → 2 * image_size
    det_distance: float = 0.0      # 0 → source_distance
    det_count: int = 0             # 0 → 2 * image_size
    det_spacing: float = 0.0       # 0 → magnification × pixel_spacing
    pixel_spacing: float = 1.0
    angles: Tuple[float, ...] = ()

    def __post_init__(self):
        if not self.angles:
            if self.n_angles <= 0:
                raise ValueError("need n_angles > 0 or explicit angles")
            object.__setattr__(
                self, "angles", _uniform_angles(self.n_angles, 2.0 * math.pi, 0.0)
            )
        object.__setattr__(self, "n_angles", len(self.angles))
        if self.source_distance <= 0:
            object.__setattr__(self, "source_distance", 2.0 * self.image_size)
        if self.det_distance <= 0:
            object.__setattr__(self, "det_distance", self.source_distance)
        if self.det_count <= 0:
            object.__setattr__(self, "det_count", 2 * self.image_size)
        if self.det_spacing <= 0:
            mag = (self.source_distance + self.det_distance) / self.source_distance
            object.__setattr__(self, "det_spacing", mag * self.pixel_spacing)

    def subsample(self, factor: int) -> "FanGeometry":
        """Sparse-view geometry keeping every ``factor``-th view."""
        return dataclasses.replace(self, angles=self.angles[::factor], n_angles=0)


GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))  # ≈ 111.246° golden-angle increment


@dataclasses.dataclass(frozen=True)
class RadialGeometry:
    """Golden-angle radial MRI k-space trajectory.

    ``n_spokes`` diameter spokes through the k-space centre, spoke ``k`` at
    angle ``k * angle_increment`` (mod 2π); ``samples_per_spoke`` uniform
    radial samples over [-k_max, k_max) with k_max = π / pixel_spacing.
    """

    image_size: int
    n_spokes: int
    samples_per_spoke: int = 0     # 0 → 2 * image_size
    pixel_spacing: float = 1.0
    angle_increment: float = GOLDEN_ANGLE

    def __post_init__(self):
        if self.samples_per_spoke <= 0:
            object.__setattr__(self, "samples_per_spoke", 2 * self.image_size)

    @property
    def spoke_angles(self) -> Tuple[float, ...]:
        return tuple(
            (k * self.angle_increment) % (2.0 * math.pi) for k in range(self.n_spokes)
        )

    def subsample(self, factor: int) -> "RadialGeometry":
        """Golden-angle subsampling keeps the first spokes of the sequence."""
        return dataclasses.replace(self, n_spokes=self.n_spokes // factor)


class ParallelPlan:
    """Compact plan tensors (float32, on one device) plus static ``meta``."""

    ARRAY_FIELDS = (
        "pos_x", "shift_x",
        "pos_y", "shift_y",
        "spec", "Wc", "Ws",
        # mirror-pair factorization: per angle PAIR one shared stage-1 row,
        # both members' shift rows, member b's conjugation sign and its
        # validity mask. Empty (0, N) when the plan does not pair.
        "pair_pos_x", "pair_sha_x", "pair_shb_x", "pair_sgn_x", "pair_msk_x",
        "pair_pos_y", "pair_sha_y", "pair_shb_y", "pair_sgn_y", "pair_msk_y",
    )

    def __init__(self, geom, meta, *arrays):
        self.geom = geom
        self.meta = meta  # dict of static ints/tuples
        for name, arr in zip(self.ARRAY_FIELDS, arrays):
            setattr(self, name, arr)
        self._index = {}
        # the tensor-core kernels' trig tables by angle group, made at first
        # use (ops/radon/parallel.py): the pair kernels' and the per-angle
        # kernels', each for the bf16 and the split-bf16 (float32) route
        self.pair_tables = {}
        self.pair_split_tables = {}
        self.group_tables = {}
        self.group_split_tables = {}

    def index(self, name: str) -> torch.Tensor:
        """``meta[name]`` (a tuple of row indices) as a long tensor on the
        plan's device, made once."""
        if name not in self._index:
            self._index[name] = torch.tensor(
                self.meta[name], dtype=torch.long, device=self.spec.device)
        return self._index[name]


def _hat(t: np.ndarray, width: float) -> np.ndarray:
    """Triangular (linear-interpolation) footprint with unit mass at spacing=width."""
    return np.maximum(0.0, 1.0 - np.abs(t) / width)


#: half the minimum separation (detector bins) between the read window and
#: the circularly wrapped band-limit ringing of out-of-window mass.
RING_GUARD = 24

#: floor for that separation when K is snapped down to a multiple of 128
#: (kept from the JAX package so both packages build identical plans).
MIN_RING_GUARD = 16

_COMPUTE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def build_parallel_plan(geom: ParallelGeometry, dtype=torch.float32,
                        device="cuda") -> ParallelPlan:
    """Build the compact factored-projector plan for ``geom`` on ``device``,
    with the linear-interpolation (hat) footprint.

    ``dtype`` is the operand type of the projector's products
    (``meta["compute_dtype"]``); the plan tensors themselves stay float32,
    because the trig arguments span hundreds of radians.
    """
    if dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    N = geom.image_size
    S = geom.det_count
    dp, ds = geom.pixel_spacing, geom.det_spacing
    angles = np.asarray(geom.angles, dtype=np.float64)
    cos, sin = np.cos(angles), np.sin(angles)

    is_x = np.abs(cos) >= np.abs(sin)  # x-primary group
    idx_x = np.nonzero(is_x)[0]
    idx_y = np.nonzero(~is_x)[0]

    half_support = 1.0  # of the hat footprint, in bins

    half = (N - 1) / 2.0 * dp
    # Wrap-safety extension M (derivation in pdunet_tpu/geometry.py): the
    # composite detector positions span ±dh around the window centre; the
    # circular grid L = S + 2M keeps wrapped ringing 2M − ov bins away.
    m_ang = float(np.max(np.abs(cos) + np.abs(sin)))
    dh = half * m_ang / ds + half_support
    ov = max(0.0, dh - (S - 1) / 2.0)
    M_old = int(math.ceil(half * math.sqrt(0.5) / ds + half_support)) + 1
    M = min(int(math.ceil(ov / 2.0)) + RING_GUARD, M_old)
    # Snap K down to a multiple of 128 when the wrap separation allows.
    K_cur = (S + 2 * M) // 2 + 1
    K_tile = ((K_cur - 1) // 128) * 128
    if K_tile >= 128:
        L_t = 2 * K_tile - 1 if S % 2 else 2 * (K_tile - 1)
        M_t = (L_t - S) // 2
        if M_t < M and 2 * M_t - ov >= 2 * MIN_RING_GUARD:
            M = M_t
    S_ext = S + 2 * M

    centers = (np.arange(N) - (N - 1) / 2.0) * dp

    L = S_ext
    K = L // 2 + 1
    k_grid = np.arange(K)

    c_s = (S - 1) / 2.0

    def group_arrays(idx, primary_cos):
        """primary_cos=True → primary coefficient is cosθ (x-primary group)."""
        if idx.size == 0:
            z = np.zeros((0, N), np.float64)
            return z, z
        prim = cos[idx] if primary_cos else sin[idx]
        seco = sin[idx] if primary_cos else cos[idx]
        pos = prim[:, None] * centers[None, :] / ds + M + c_s   # (A_g, N)
        t = seco[:, None] * centers[None, :] / ds               # (A_g, N)
        return pos, M - t

    pos_x, shift_x = group_arrays(idx_x, primary_cos=True)
    pos_y, shift_y = group_arrays(idx_y, primary_cos=False)

    C_fold = 2.0 * (M + c_s)

    def pair_group(idx, primary_cos):
        if idx.size == 0:
            zN = np.zeros((0, N), np.float64)
            z1 = np.zeros((0,), np.float64)
            return dict(pos=zN, sha=zN, shb=zN, sgn=z1, msk=z1,
                        ia=np.zeros(0, np.int64), ib=np.zeros(0, np.int64))
        prim = cos[idx] if primary_cos else sin[idx]
        pos_g, shift_g = group_arrays(idx, primary_cos)
        A_g = idx.size
        matched = np.zeros(A_g, bool)
        ia, ib, sgn = [], [], []
        for i in range(A_g):
            if matched[i]:
                continue
            matched[i] = True
            partner, s = -1, 1.0
            for j in range(i + 1, A_g):
                if matched[j]:
                    continue
                if abs(prim[j] - prim[i]) < 1e-12:
                    partner, s = j, 1.0
                    break
                if abs(prim[j] + prim[i]) < 1e-12:
                    partner, s = j, -1.0
                    break
            if partner >= 0:
                matched[partner] = True
            ia.append(i)
            ib.append(partner)
            sgn.append(s)
        ia = np.asarray(ia, np.int64)
        ib = np.asarray(ib, np.int64)
        sgn = np.asarray(sgn, np.float64)
        msk = (ib >= 0).astype(np.float64)
        ib_safe = np.where(ib >= 0, ib, ia)
        shb = shift_g[ib_safe] - np.where(sgn < 0, C_fold, 0.0)[:, None]
        return dict(pos=pos_g[ia], sha=shift_g[ia], shb=shb,
                    sgn=sgn, msk=msk, ia=ia, ib=ib)

    pr_x = pair_group(idx_x, primary_cos=True)
    pr_y = pair_group(idx_y, primary_cos=False)
    P_x, P_y = len(pr_x["ia"]), len(pr_y["ia"])

    # Reassembly: the pair kernels emit rows [x-pair0 a, x-pair0 b, ...,
    # y-pair0 a, ...]; unpaired b rows are never selected. pair_take maps
    # each adjoint input row back to an angle (unpaired rows read member a
    # and are zeroed by the mask inside the adjoint).
    A = len(angles)
    pair_row_of_angle = np.full(A, -1, np.int64)
    take_rows = []
    off = 0
    for pr, idx_g in ((pr_x, idx_x), (pr_y, idx_y)):
        for p_i, (a_i, b_i) in enumerate(zip(pr["ia"], pr["ib"])):
            pair_row_of_angle[idx_g[a_i]] = off + 2 * p_i
            take_rows.append(int(idx_g[a_i]))
            if b_i >= 0:
                pair_row_of_angle[idx_g[b_i]] = off + 2 * p_i + 1
                take_rows.append(int(idx_g[b_i]))
            else:
                take_rows.append(int(idx_g[a_i]))
        off += 2 * len(pr["ia"])
    n_take_x = 2 * P_x
    use_pairs = (P_x + P_y) <= 0.9 * max(1, A)
    if not use_pairs:
        empty = dict(pos=np.zeros((0, N)), sha=np.zeros((0, N)),
                     shb=np.zeros((0, N)), sgn=np.zeros(0), msk=np.zeros(0))
        pr_x = pr_y = empty
        P_x = P_y = 0
        meta_pairs = dict(pair_inv_perm=(), pair_take_x=(), pair_take_y=())
    else:
        meta_pairs = dict(
            pair_inv_perm=tuple(int(i) for i in pair_row_of_angle),
            pair_take_x=tuple(take_rows[:n_take_x]),
            pair_take_y=tuple(take_rows[n_take_x:]),
        )

    # continuous footprint spectrum at ω_k = 2πk/(L·δs), scaled by δp²/δs²
    tq = np.linspace(-half_support * ds, half_support * ds, 4096)
    kq = _hat(tq, ds)
    omega = 2.0 * math.pi * k_grid / (L * ds)
    spec = (np.cos(np.outer(omega, tq)) @ kq) * (tq[1] - tq[0])
    spec = spec * (dp * dp / (ds * ds))

    # Hermitian-folded inverse DFT back to the S detector bins
    ck = np.full(K, 2.0)
    ck[0] = 1.0
    if L % 2 == 0:
        ck[-1] = 1.0
    ang_w = 2.0 * math.pi * np.outer(k_grid, np.arange(S)) / L
    Wc = (ck[:, None] / L) * np.cos(ang_w)
    Ws = (ck[:, None] / L) * np.sin(ang_w)

    order = np.concatenate([idx_x, idx_y])
    inv_perm = np.empty_like(order)
    inv_perm[order] = np.arange(order.size)

    meta = dict(
        N=N, S=S, M=M, S_ext=S_ext, K=K,
        A_x=int(idx_x.size), A_y=int(idx_y.size),
        inv_perm=tuple(int(i) for i in inv_perm),
        idx_x=tuple(int(i) for i in idx_x),
        idx_y=tuple(int(i) for i in idx_y),
        P_x=P_x, P_y=P_y, use_pairs=bool(use_pairs),
        **meta_pairs,
        compute_dtype=_COMPUTE_DTYPES[dtype],
    )

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ParallelPlan(
        geom,
        meta,
        dev(pos_x), dev(shift_x),
        dev(pos_y), dev(shift_y),
        dev(spec), dev(Wc), dev(Ws),
        dev(pr_x["pos"]), dev(pr_x["sha"]), dev(pr_x["shb"]),
        dev(pr_x["sgn"]), dev(pr_x["msk"]),
        dev(pr_y["pos"]), dev(pr_y["sha"]), dev(pr_y["shb"]),
        dev(pr_y["sgn"]), dev(pr_y["msk"]),
    )
