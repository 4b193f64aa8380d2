"""Load flax parameters of the JAX package into the port's modules.

Input is the nested dict of numpy arrays that ``task.init_params`` (or a
restored checkpoint) gives, e.g. ``jax.tree_util.tree_map(np.asarray, params)``.

Layout mapping:
  flax Conv kernel (kh, kw, in, out) → torch conv weight (out, in, kh, kw)
  flax ConvTranspose kernel (kh, kw, in, out) → torch conv_transpose weight
      (in, out, kh, kw), spatially flipped: flax applies the kernel
      unflipped, torch's conv_transpose2d flips it.
  flax PReLU negative_slope () → the port's PReLU negative_slope ()

Tree shapes:
  a bare UNet (the fbp_unet and sino_unet tasks): ConvBlock_0 …, then the
      up-convs ConvTranspose_0 … and the head Conv_0, or, with
      ``upsample="shuffle"``, the 1x1 up-convs Conv_0 … Conv_{depth-1} and
      the head Conv_{depth};
  an unrolled primal-dual model: ``Scan_PDIteration_0`` (with remat
      ``ScanCheckpoint_PDIteration_0``) holds the dual net (``UNet_0`` or
      LPD's ``ConvNet_0``) and the primal net (``UNet_1`` / ``ConvNet_1``),
      every leaf stacked on axis 0 over iterations, or not stacked when the
      iterations share their weights. A ConvNet holds Conv_0 … and
      PReLU_0 …. Complex operators change only the channel counts.
"""

from __future__ import annotations

import numpy as np
import torch

from pdunet_tpu_torch.models.primal_dual import ConvNet, UnrolledPrimalDual
from pdunet_tpu_torch.models.unet import Conv, ConvTranspose, UNet

__all__ = ["flax_to_torch", "load_flax_unet", "load_flax_convnet"]


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


def _check_keys(p: dict, expected: set, what: str):
    if set(p) != expected:
        raise ValueError(f"flax {what} params {sorted(p)} do not match {sorted(expected)}")


def load_flax_unet(unet: UNet, p: dict) -> UNet:
    """Fill ``unet`` from the flax parameter dict of one ``UNet``."""
    shuffle = unet.upsample == "shuffle"
    n_up = len(unet.ups)
    ups = [f"Conv_{i}" if shuffle else f"ConvTranspose_{i}" for i in range(n_up)]
    head = f"Conv_{n_up}" if shuffle else "Conv_0"
    _check_keys(p, {f"ConvBlock_{i}" for i in range(len(unet.blocks))} | set(ups) | {head},
                "UNet")
    for i, block in enumerate(unet.blocks):
        for j, conv in enumerate(block.convs):
            _load_conv(conv, p[f"ConvBlock_{i}"][f"Conv_{j}"])
    for up, name in zip(unet.ups, ups):
        (_load_conv if shuffle else _load_conv_transpose)(up, p[name])
    _load_conv(unet.head, p[head])
    return unet


def load_flax_convnet(net: ConvNet, p: dict) -> ConvNet:
    """Fill ``net`` from the flax parameter dict of one LPD ``ConvNet``."""
    _check_keys(p, {f"Conv_{i}" for i in range(len(net.convs))}
                | {f"PReLU_{i}" for i in range(len(net.acts))}, "ConvNet")
    for i, conv in enumerate(net.convs):
        _load_conv(conv, p[f"Conv_{i}"])
    for i, act in enumerate(net.acts):
        _copy(act.negative_slope, np.asarray(p[f"PReLU_{i}"]["negative_slope"]))
    return net


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _take(tree, i: int):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def flax_to_torch(params_np: dict, model):
    """Fill a port model from the flax params of its JAX twin: a bare
    ``UNet``, or an ``UnrolledPrimalDual`` (PD-UNet or LPD, per-iteration or
    shared weights)."""
    if isinstance(model, UNet):
        return load_flax_unet(model, params_np)
    scans = [k for k in params_np if k in ("Scan_PDIteration_0", "ScanCheckpoint_PDIteration_0")]
    if not isinstance(model, UnrolledPrimalDual) or len(params_np) != 1 or len(scans) != 1:
        raise ValueError(f"flax params {sorted(params_np)} do not match a "
                         f"{type(model).__name__}")
    scan = params_np[scans[0]]
    convnet = isinstance(model.iterations[0].dual, ConvNet)
    names = ("ConvNet_0", "ConvNet_1") if convnet else ("UNet_0", "UNet_1")
    _check_keys(scan, set(names), "unroll")
    load = load_flax_convnet if convnet else load_flax_unet
    if not model.share_weights:
        stacked = {np.shape(v)[:1] for v in _leaves(scan)}
        if stacked != {(model.n_iters,)}:
            raise ValueError(f"flax unroll leaves stacked as {sorted(stacked)}, expected "
                             f"{model.n_iters} iterations on axis 0")
    for i, it in enumerate(model.iterations):
        p_i = scan if model.share_weights else _take(scan, i)
        load(it.dual, p_i[names[0]])
        load(it.primal, p_i[names[1]])
    return model
