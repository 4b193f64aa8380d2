"""The port's networks (pdunet_tpu_torch/models) against flax, with the flax
parameters carried across by models/convert.py.

float32: 1e-4 relative (convolution algorithms may sum in other orders).
bfloat16: 5e-3 relative, about one bf16 ulp (2⁻⁸). The UNets themselves
agree bit for bit in bf16 on the CPU; the PD-UNet's remaining difference
(~7e-4 measured) comes from the projector, which rounds its bf16 operands in
the pair operator in the port and in the per-angle operator in JAX's CPU
path (the projector's own bf16 tolerance is 5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.models.primal_dual import make_pdunet as jax_make_pdunet
from pdunet_tpu.models.unet import UNet as JaxUNet
from pdunet_tpu.models.unet import depth_to_space as jax_d2s
from pdunet_tpu.models.unet import space_to_depth as jax_s2d
from pdunet_tpu.ops.radon.parallel import make_parallel_ops as jax_ops
from pdunet_tpu_torch.geometry import ParallelGeometry
from pdunet_tpu_torch.models.convert import flax_to_torch, load_flax_unet
from pdunet_tpu_torch.models.primal_dual import make_pdunet
from pdunet_tpu_torch.models.unet import UNet, depth_to_space, space_to_depth
from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

torch.set_num_threads(1)

_DT = [(False, 1e-4), (True, 5e-3)]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_space_to_depth_matches_flax_order():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    s2d = space_to_depth(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(jax_s2d(jnp.asarray(x), 2)))
    back = depth_to_space(s2d, 2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_d2s(jax_s2d(jnp.asarray(x), 2), 2)))


@pytest.mark.parametrize("stem,depth", [(1, 2), (2, 2), (2, 1)])
@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_unet_forward_matches_flax(stem, depth, bf16, tol):
    """Odd spatial sizes exercise the pad-to-multiple and the crop."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jm = JaxUNet(out_channels=2, base_features=8, depth=depth, stem=stem, dtype=jdt)
    x = np.random.default_rng(1).standard_normal((2, 22, 37, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = UNet(in_channels=3, out_channels=2, base_features=8, depth=depth,
              stem=stem, dtype=tdt, device="cpu")
    load_flax_unet(tm, _np_tree(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol


def test_unet_init_is_lecun_normal_with_zero_bias():
    gen = torch.Generator().manual_seed(0)
    m = UNet(in_channels=4, out_channels=1, base_features=32, depth=1, stem=1,
             generator=gen, device="cpu")
    w = m.blocks[1].convs[0].weight  # (64, 32, 3, 3): fan_in 288
    assert abs(w.std().item() * np.sqrt(288) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / np.sqrt(288) / 0.8796 + 1e-6
    assert all(float(b.detach().abs().max()) == 0.0 for n, b in m.named_parameters()
               if n.endswith("bias"))
    # a seed gives the same weights again
    m2 = UNet(in_channels=4, out_channels=1, base_features=32, depth=1, stem=1,
              generator=torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_convert_rejects_mismatched_trees():
    jm = JaxUNet(out_channels=1, base_features=8, depth=2, stem=1)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 2)))["params"]
    with pytest.raises(ValueError):
        load_flax_unet(UNet(in_channels=2, base_features=8, depth=1, device="cpu"),
                       _np_tree(params))
    with pytest.raises(ValueError, match="shape"):
        load_flax_unet(UNet(in_channels=3, base_features=8, depth=2, device="cpu"),
                       _np_tree(params))


@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_pdunet_forward_matches_flax(bf16, tol):
    """Full unroll (2 iterations, base 8, depth 2, stem 2) with both
    packages' own projectors at 32² / 24 angles and converted weights."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    kw = dict(image_size=32, n_angles=24, det_count=32)
    jo = jax_ops(JaxGeometry(**kw), dtype=jdt)
    to = make_parallel_ops(ParallelGeometry(**kw), dtype=tdt, device="cpu")
    sigma = 7.5
    jm = jax_make_pdunet(lambda f: jo.A(f) / sigma, lambda p: jo.At(p) / sigma,
                         n_iters=2, base_features=8, depth=2, stem=2, dtype=jdt)
    tm = make_pdunet(lambda f: to.A(f) / sigma, lambda p: to.At(p) / sigma,
                     n_iters=2, base_features=8, depth=2, stem=2, dtype=tdt,
                     device="cpu")
    rng = np.random.default_rng(2)
    g = rng.standard_normal((2, 24, 32)).astype(np.float32)
    f0 = rng.standard_normal((2, 32, 32)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(g), jnp.asarray(f0))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(g), jnp.asarray(f0)))
    flax_to_torch(_np_tree(params), tm)
    with torch.no_grad():
        out = tm(torch.from_numpy(g), torch.from_numpy(f0))
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert rel(out, ref) < tol


def test_pdunet_is_differentiable_through_the_operators():
    to = make_parallel_ops(ParallelGeometry(image_size=16, n_angles=12), device="cpu")
    tm = make_pdunet(to.A, to.At, n_iters=1, base_features=4, depth=1, stem=1,
                     generator=torch.Generator().manual_seed(3), device="cpu")
    f0 = torch.randn(1, 16, 16, requires_grad=True)
    g = torch.randn(1, 12, 16)
    tm(g, f0).square().sum().backward()
    assert f0.grad is not None and torch.isfinite(f0.grad).all()
    assert all(p.grad is not None for p in tm.parameters())
