"""Load flax parameters of the JAX package into the port's modules.

Input is the nested dict of numpy arrays that ``task.init_params`` (or a
restored checkpoint) gives, e.g. ``jax.tree_util.tree_map(np.asarray, params)``.

Layout mapping:
  flax Conv kernel (kh, kw, in, out) → torch conv weight (out, in, kh, kw)
  flax ConvTranspose kernel (kh, kw, in, out) → torch conv_transpose weight
      (in, out, kh, kw), spatially flipped: flax applies the kernel
      unflipped, torch's conv_transpose2d flips it.
A PD-UNet's ``Scan_PDIteration_0`` holds every leaf stacked on axis 0 over
iterations, with ``UNet_0`` the dual net and ``UNet_1`` the primal net. A
complex PD-UNet (``complex_ops``) has the same tree with (Re, Im) channel
pairs: dual 6 in / 2 out, primal 4 in / 2 out.
"""

from __future__ import annotations

import numpy as np
import torch

from pdunet_tpu_torch.models.primal_dual import UnrolledPrimalDual
from pdunet_tpu_torch.models.unet import Conv, ConvTranspose, UNet

__all__ = ["flax_to_torch", "load_flax_unet"]


def _copy(param: torch.nn.Parameter, value: np.ndarray):
    value = np.array(value, dtype=np.float32)  # a writable contiguous copy
    if tuple(param.shape) != value.shape:
        raise ValueError(f"shape mismatch: module {tuple(param.shape)} vs flax {value.shape}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


def _load_conv(mod: Conv, p: dict):
    _copy(mod.weight, np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    _copy(mod.bias, np.asarray(p["bias"]))


def _load_conv_transpose(mod: ConvTranspose, p: dict):
    k = np.asarray(p["kernel"])[::-1, ::-1]
    _copy(mod.weight, np.transpose(k, (2, 3, 0, 1)))
    _copy(mod.bias, np.asarray(p["bias"]))


def load_flax_unet(unet: UNet, p: dict) -> UNet:
    """Fill ``unet`` from the flax parameter dict of one ``UNet``."""
    expected = ({f"ConvBlock_{i}" for i in range(len(unet.blocks))}
                | {f"ConvTranspose_{i}" for i in range(len(unet.ups))} | {"Conv_0"})
    if set(p) != expected:
        raise ValueError(f"flax UNet params {sorted(p)} do not match {sorted(expected)}")
    for i, block in enumerate(unet.blocks):
        for j, conv in enumerate(block.convs):
            _load_conv(conv, p[f"ConvBlock_{i}"][f"Conv_{j}"])
    for i, up in enumerate(unet.ups):
        _load_conv_transpose(up, p[f"ConvTranspose_{i}"])
    _load_conv(unet.head, p["Conv_0"])
    return unet


def _take(tree, i: int):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def flax_to_torch(params_np: dict, model: UnrolledPrimalDual) -> UnrolledPrimalDual:
    """Fill a PD-UNet built by ``make_pdunet`` from flax PD-UNet params."""
    scan = params_np["Scan_PDIteration_0"]
    for i, it in enumerate(model.iterations):
        p_i = _take(scan, i)
        load_flax_unet(it.dual, p_i["UNet_0"])
        load_flax_unet(it.primal, p_i["UNet_1"])
    return model
