"""Operation and byte counts of a configuration, from the configuration alone.

The frozen results live in ``counts/<config>.json`` (``python
portbench/counting.py configs/<config>.json`` writes them; a test holds the
files to this code): a new configuration is its file and that one. A new
cell adds no count: it is its ``BENCHMARK.json`` entry,
``limits/<cell>.json`` and ``tests/cells/<cell>.json``.
Peaks: one H100 SXM's dense bf16 tensor-core rate, 989 TFLOP/s, and its HBM3
bandwidth, 3.35 TB/s (NVIDIA's data sheet). Every count divides by them,
whatever precision or splitting computes the work, so no implementation can
read above 100%.

Projector (one apply, A or A†, per image): the factored algorithm's three
stages for each angle group, stage 1 once per unit (a mirror pair where the
plan pairs, else an angle), stages 2-3 per emitted row:
2·(2·units·N²·K + 4·rows·N·K + 2·rows·K·S) FLOP. Bytes: the image read and
the group's rows written once per image, the plan rows and the inverse-DFT
matrices once per call.

The network: ``FlopCounterMode`` over the reference network of the
configuration's model kind (``reference/models/<kind>.py``: its ``shapes``
and its ``unroll``) on the meta device, the forward for a reconstruction,
forward and backward for a training step. The operators are shape stubs
that count their calls: applies per slice are the synthesis A and the
direct reconstruction, then each call of A or A† in the unroll and, in
training, each call's vector-Jacobian product (none where the operator's
input needs no gradient, as A f₀ in the first iteration). A new model
kind is that one file; nothing here names a model.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys

import numpy as np
import torch

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
HERE = pathlib.Path(__file__).resolve().parent

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "projector_groups", "network_counts", "counts"]


def _pair_units(prim: np.ndarray) -> int:
    """Units of stage 1 in a group: each angle pairs greedily with the next
    unmatched one whose primary cosine is equal or opposite."""
    matched = np.zeros(prim.size, bool)
    units = 0
    for i in range(prim.size):
        if matched[i]:
            continue
        matched[i] = True
        units += 1
        for j in range(i + 1, prim.size):
            if not matched[j] and (abs(prim[j] - prim[i]) < 1e-12 or abs(prim[j] + prim[i]) < 1e-12):
                matched[j] = True
                break
    return units


def projector_groups(cfg: dict) -> dict:
    """{"family", "N", "K", "S", "groups": [{"units", "rows"}, ...]} of the
    configuration's sparse operator."""
    from portbench.reference.radial import spoke_angles
    from portbench.reference.radon import plan_parallel, sparse_angles

    g = cfg["geometry"]
    N = g["image_size"]
    if g["kind"] == "parallel":
        angles = sparse_angles(g["n_angles"], g["sparsity"], g["angular_coverage"])
        plan = plan_parallel(N, angles, g["det_count"], g["det_spacing"], g["pixel_spacing"])
        K, S = plan["K"], plan["S"]
        cos, sin = np.cos(angles), np.sin(angles)
        xp = np.abs(cos) >= np.abs(sin)
        prims = [cos[xp], sin[~xp]]
        units = [_pair_units(p) for p in prims]
        if sum(units) <= 0.9 * len(angles):
            groups = [{"units": u, "rows": 2 * u} for u, p in zip(units, prims) if p.size]
            return {"family": "pair", "N": N, "K": K, "S": S, "groups": groups}
        groups = [{"units": p.size, "rows": p.size} for p in prims if p.size]
        return {"family": "angle", "N": N, "K": K, "S": S, "groups": groups}
    if g["kind"] == "radial":
        n_ro = g["samples_per_spoke"] or 2 * N
        theta = np.mod(spoke_angles(g["n_angles"] // g["sparsity"]), math.pi)
        xp = np.abs(np.cos(theta)) >= np.abs(np.sin(theta))
        groups = [{"units": int(c), "rows": int(c)} for c in (xp.sum(), (~xp).sum()) if c]
        return {"family": "angle", "N": N, "K": n_ro // 2, "S": 2 * n_ro, "groups": groups}
    raise NotImplementedError(g["kind"])


def _group_counts(pg: dict) -> list:
    N, K, S = pg["N"], pg["K"], pg["S"]
    rows_per_unit = 3 if pg["family"] == "pair" else 2
    out = []
    for grp in pg["groups"]:
        u, r = grp["units"], grp["rows"]
        out.append({"units": u, "rows": r,
                    "flops_per_image": 2 * (2 * u * N * N * K + 4 * r * N * K + 2 * r * K * S),
                    "bytes_per_image": 4 * (N * N + r * S),
                    "bytes_per_call": 4 * (rows_per_unit * u * N + K + 2 * K * S)})
    return out


def _sino_shape(cfg: dict) -> tuple:
    g = cfg["geometry"]
    N = g["image_size"]
    if g["kind"] == "radial":
        return g["n_angles"] // g["sparsity"], g["samples_per_spoke"] or 2 * N
    return len(range(0, g["n_angles"], g["sparsity"])), g["det_count"] or N


class _Stub(torch.autograd.Function):
    """An operator's shape stub: (B, …) → zeros (B, rows, cols), counting
    its forward calls and its backward calls in ``calls``."""

    @staticmethod
    def forward(ctx, x, rows, cols, calls):
        calls["forward"] += 1
        ctx.shape, ctx.dtype, ctx.calls = x.shape, x.dtype, calls
        return x.new_zeros((x.shape[0], rows, cols))

    @staticmethod
    def backward(ctx, grad):
        ctx.calls["backward"] += 1
        return grad.new_zeros(ctx.shape, dtype=ctx.dtype), None, None, None


def network_counts(cfg: dict, train: bool, root: pathlib.Path = HERE.parent) -> dict:
    """{"conv_flops", "forward", "backward"} of one slice through the
    unroll of ``cfg``'s model kind (and its backward): its FLOPs and the
    stubbed operators' forward and backward calls."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench import modules
    from portbench.reference.precision import EXACT

    g, m = cfg["geometry"], cfg["model"]
    model = modules.reference_model(m["kind"], root)
    N, cplx = g["image_size"], g["kind"] == "radial"
    A, S = _sino_shape(cfg)
    dt = torch.complex64 if cplx else torch.float32
    P = {k: torch.zeros(s, device="meta", requires_grad=train)
         for k, s in model.shapes(cfg).items()}
    calls = {"forward": 0, "backward": 0}
    g_in = torch.zeros((1, A, S), dtype=dt, device="meta")
    f0 = torch.zeros((1, N, N), dtype=dt, device="meta")
    with FlopCounterMode(display=False) as counter:
        out = model.unroll(m, P, g_in, f0, lambda f: _Stub.apply(f, A, S, calls),
                           lambda p: _Stub.apply(p, N, N, calls), cplx, EXACT.lo)
        if train:
            (out.abs().mean()).backward()
    return {"conv_flops": int(counter.get_total_flops()), **calls}


def counts(cfg: dict, root: pathlib.Path = HERE.parent) -> dict:
    """The counts of ``cfg``; ``root`` is the checkout whose reference
    models count the network."""
    pg = projector_groups(cfg)
    groups = _group_counts(pg)
    images = 2 if cfg["geometry"]["kind"] == "radial" else 1
    net = {k: network_counts(cfg, k == "train", root) for k in ("recon", "train")}
    # the synthesis A and the direct reconstruction, then the unroll's calls
    applies = {k: 2 + c["forward"] + c["backward"] for k, c in net.items()}
    apply_flops = sum(gr["flops_per_image"] for gr in groups) * images
    conv = {k: c["conv_flops"] for k, c in net.items()}
    return {
        "peak_flops": PEAK_FLOPS, "peak_bytes_per_s": PEAK_BYTES,
        "projector": {"family": pg["family"], "N": pg["N"], "K": pg["K"], "S": pg["S"],
                      "images_per_slice": images, "groups": groups},
        "applies_per_slice": applies,
        "conv_flops_per_slice": conv,
        "flops_per_slice": {k: conv[k] + applies[k] * apply_flops for k in conv},
    }


def main(argv=None):
    """Write ``counts/<config>.json`` for each configuration file named."""
    for path in argv or sys.argv[1:]:
        path = pathlib.Path(path)
        cfg = json.loads(path.read_text())
        (HERE / "counts" / path.name).write_text(json.dumps(counts(cfg), indent=1) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    main()
