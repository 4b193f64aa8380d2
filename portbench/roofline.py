"""Shares of a peak, for the metric readers: a kernel family's roofline
from the traced slice and the frozen counts, and a whole step's MFU."""

from __future__ import annotations

import re
from typing import Optional

__all__ = ["family_roofline", "mfu"]


def _name_re(family: str, parts: str) -> re.Pattern:
    return re.compile(rf"(?<![A-Za-z0-9_]){family}_(?:tc|split)_(?:{parts})(?![A-Za-z0-9_])")


def family_roofline(run, family: str, prefix: str) -> Optional[float]:
    """Σ bound time ÷ Σ device time of the projector kernels ``prefix``_tc_*
    and ``prefix``_split_* in the traced slice, in %.

    Each launch of the family's main kernel (``_fwd`` or ``_adj``) is one
    group call over the request's or step's whole batch; its bound is the
    larger of its counted FLOPs over the bf16 peak and its bytes over the
    HBM bandwidth, both routes counted alike (the operator's work, once).
    The calls alternate the plan's two angle groups, so each takes their
    mean bound. None where the slice ran no such kernel or the
    configuration's projector is of another family."""
    c = run.counts
    p = c["projector"]
    if run.trace is None or p["family"] != family:
        return None
    seconds, _ = run.trace.device_seconds(_name_re(prefix, r"\w+").search)
    _, calls = run.trace.device_seconds(_name_re(prefix, "fwd|adj").search)
    if calls == 0 or seconds <= 0:
        return None
    images = run.traffic["batch"] * p["images_per_slice"]
    bound = sum(max(g["flops_per_image"] * images / c["peak_flops"],
                    (g["bytes_per_image"] * images + g["bytes_per_call"]) / c["peak_bytes_per_s"])
                for g in p["groups"]) / len(p["groups"])
    return 100.0 * calls * bound / seconds


def mfu(run, work: str) -> Optional[float]:
    """Counted FLOPs per slice of ``work`` ("recon" or "train") times the
    traced run's slices per second outside its profiled slice, over the
    bf16 peak, in %."""
    if run.untraced_rate is None:
        return None
    c = run.counts
    return 100.0 * c["flops_per_slice"][work] * run.untraced_rate / c["peak_flops"]
