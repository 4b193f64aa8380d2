"""Traffic kind ``volume_scaled``: the ``volume`` loop (one client, a closed
loop of volumes, the same parameters), with the recon checked in units of
the reference's own bfloat16 rounding.

Where the unroll amplifies rounding, as a deep unroll on random weights
does, the recon's error against the float32 reference is set by the
weights the seed draws: from seed to seed it moves many times over, the
program's and the control's alike, and no one limit on it parts every
sound run from every control. Both errors move with the same gain, so
their ratio to a third does not: the reference rounded as the
configuration states (bfloat16 operands where the unroll reads them,
float32 sums, float32 synthesis and σ), on the same weights and images.

The check: the worst slice's relative L2 error of the measurement and the
direct recon (as ``volume``), and ``recon_err_scaled``, the L2 error of
the recon over every checked slice divided by that of the bf16-rounded
reference, both against the float32 reference.
"""

from __future__ import annotations

import pathlib

import torch

from portbench import modules
from portbench.reference.precision import CONTROL, Precision

__all__ = ["make_pool", "loop", "compare", "controls", "BF16"]

volume = modules.load(pathlib.Path(__file__).with_name("volume.py"), "traffic kind 'volume'")
make_pool, loop = volume.make_pool, volume.loop


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.complex(_round_bf16(x.real), _round_bf16(x.imag))
    return x.to(torch.bfloat16).float()


#: the precision the configuration states: float32 synthesis, bf16 unroll
BF16 = Precision("float32+bf16", lambda x: x, _round_bf16)


def _numbers(ref, kept: dict, weights: dict, prec=None) -> dict:
    """The numbers of the check over the checked requests; ``prec`` puts
    the reference in the program's place."""
    sigma = ref.sigma()
    worst = {"sino_err": 0.0, "f0_err": 0.0}
    err = base = 0.0
    for out in kept.values():
        want = ref.recon_volume(weights, out["images"], sigma)
        rounded = ref.recon_volume(weights, out["images"], sigma, BF16)
        got = out if prec is None else ref.recon_volume(weights, out["images"],
                                                        ref.sigma(prec.lo), prec)
        for key in ("sino", "f0"):
            worst[f"{key}_err"] = max(worst[f"{key}_err"], volume._rel(got[key], want[key]))
        err += float((got["recon"] - want["recon"]).abs().square().sum())
        base += float((rounded["recon"] - want["recon"]).abs().square().sum())
    return dict(worst, recon_err_scaled=(err / base) ** 0.5)


def compare(run, ref, prog: dict, weights: dict) -> dict:
    return _numbers(ref, prog, weights)


def controls(run, ref, prog: dict, weights: dict) -> dict:
    """The control's numbers: the reference in the program's place, one
    precision below the configuration's."""
    return {"control": _numbers(ref, prog, weights, CONTROL)}
