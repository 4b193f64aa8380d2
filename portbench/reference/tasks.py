"""The configuration's pipeline, worked out again: the sparse operators, their
norm σ, the float32 measurement synthesis and direct reconstruction, the
unrolled network, and the training step with its optimizer.

``cfg`` is a configuration file of ``portbench/configs/`` (its geometry,
model and train sections). The operators of a geometry are found by its
``kind`` in ``reference/geometries/<kind>.py`` (``build(g, device)``), the
network by the model's ``kind`` (``modules.reference_model``). A new
geometry is one file; a new model kind is one file,
``reference/models/<kind>.py``, with ``shapes(cfg)`` (the parameter shapes,
keyed as the program's ``state_dict``) and ``unroll(m, P, g, f0, A, At,
complex_ops, rnd)`` (the network); ``counting.py`` counts the network by
running the two on shape stubs. A new cell is its
``BENCHMARK.json`` entry, ``limits/<cell>.json`` and
``tests/cells/<cell>.json``. Volumes go through in blocks of rows, so the
reference fits beside what the program leaves allocated.
"""

from __future__ import annotations

import pathlib

import torch

from portbench import modules
from portbench.reference.optim import Adam
from portbench.reference.precision import EXACT, Precision, exact_float32

__all__ = ["RefTask"]

HERE = pathlib.Path(__file__).resolve().parent


class RefTask:
    def __init__(self, cfg: dict, device, root: pathlib.Path = HERE.parent.parent):
        g, self.m, self.tc = cfg["geometry"], cfg["model"], cfg["train"]
        parts = pathlib.Path(root) / "portbench" / "reference"
        self.ops_mod = modules.load(parts / "geometries" / f"{g['kind']}.py",
                                    f"reference geometry {g['kind']!r}")
        self.model_mod = modules.reference_model(self.m["kind"], root)
        self.N = g["image_size"]
        self.device = torch.device(device)
        self.ops = self.ops_mod.build(g, self.device)
        self.complex = bool(self.ops.complex)
        self._sigma = {}

    @torch.no_grad()
    def sigma(self, rnd=EXACT.lo, n_iters: int = 20) -> float:
        """Largest singular value of the sparse operator: power iteration on
        A†A from a standard normal image drawn with seed 0 on the device
        (worked out once per rounding)."""
        if rnd in self._sigma:
            return self._sigma[rnd]
        with exact_float32():
            gen = torch.Generator(device=self.device).manual_seed(0)
            x = torch.randn((self.N, self.N), generator=gen, device=self.device)
            if self.complex:
                x = x.to(torch.complex64)
            AtA = lambda z: self.ops.At_(self.ops.A_(z[None], rnd), rnd)[0]
            for _ in range(n_iters):
                y = AtA(x)
                x = y / torch.sqrt(torch.sum(y.abs() ** 2))
            s2 = torch.sum(torch.real(torch.conj(x) * AtA(x))) / torch.sum(x.abs() ** 2)
        self._sigma[rnd] = float(torch.sqrt(s2))
        return self._sigma[rnd]

    def synth(self, images, rnd=EXACT.hi):
        """(measurement, direct reconstruction) of ``images``, float32-stated."""
        sino = self.ops.A_(images, rnd)
        return sino, self.ops.fbp(sino, rnd)

    def unroll(self, P: dict, sino, f0, sigma: float, rnd=EXACT.lo):
        """The network's output: real, or complex for radial MRI."""
        return self.model_mod.unroll(self.m, P, sino / sigma, f0,
                                     lambda f: self.ops.A_(f, rnd) / sigma,
                                     lambda p: self.ops.At_(p, rnd) / sigma, self.complex, rnd)

    @torch.no_grad()
    def recon_volume(self, P: dict, images, sigma: float, prec: Precision = EXACT,
                     block: int = 32) -> dict:
        """{"sino", "f0", "recon"} of a volume, on the host; recon is the
        magnitude for radial MRI, as served."""
        out = {"sino": [], "f0": [], "recon": []}
        with exact_float32():
            for b0 in range(0, images.shape[0], block):
                sino, f0 = self.synth(images[b0:b0 + block], prec.hi)
                rec = self.unroll(P, sino, f0, sigma, prec.lo)
                for k, v in (("sino", sino), ("f0", f0), ("recon", rec.abs() if self.complex else rec)):
                    out[k].append(v.cpu())
        return {k: torch.cat(v) for k, v in out.items()}

    def train(self, P0: dict, step_images: list, sigma: float, prec: Precision = EXACT,
              block: int = 16, fault: str = "", adam=None) -> dict:
        """The configuration's training steps from the weights ``P0`` on one
        image batch per step: {"loss": [...], "grad1": clipped gradients of
        the first step, "params": the weights after the last}. ``adam``:
        the optimizer's (first moments, second moments, updates made) to go
        on from; a fresh optimizer without. ``fault`` ("half_batch") plants
        a fault for the readings of the limits."""
        params = {k: v.detach().clone().float().requires_grad_() for k, v in P0.items()}
        opt = Adam(params, self.tc["grad_clip"], self.tc["learning_rate"],
                   self.tc["warmup_steps"], self.tc["steps"], adam)
        out = {"loss": []}
        keys = list(params)
        with exact_float32():
            for i, images in enumerate(step_images):
                if fault == "half_batch":
                    images = images[: images.shape[0] // 2]
                B = images.shape[0]
                grads = {k: torch.zeros_like(v) for k, v in params.items()}
                total = 0.0
                for b0 in range(0, B, block):
                    img = images[b0:b0 + block]
                    with torch.no_grad():
                        sino, f0 = self.synth(img, prec.hi)
                    pred = self.unroll(params, sino, f0, sigma, prec.lo)
                    loss = (pred - img).abs().sum() / (B * img[0].numel())
                    for k, gr in zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])):
                        grads[k] += gr
                    total += float(loss.detach())
                out["loss"].append(total)
                clipped = opt.step(grads)
                if i == 0:
                    out["grad1"] = {k: v.detach().clone() for k, v in clipped.items()}
        out["params"] = {k: v.detach() for k, v in params.items()}
        return out
